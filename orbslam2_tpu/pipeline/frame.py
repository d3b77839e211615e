"""Frame construction: ORB extraction + undistortion + depth seeding.

The fixed-shape analogue of the `Frame` constructors (reference src/Frame.cc:62-241):
mono/stereo/RGB-D variants produce one fixed-shape FrameData. The stereo
path extracts left/right in one batched graph instead of the reference's
two transient threads (src/Frame.cc:82-85).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from orbslam2_tpu.config import SlamConfig
from orbslam2_tpu.geometry import camera as cam_geo
from orbslam2_tpu.ops import orb, pyramid, stereo


class FrameData(NamedTuple):
    """Fixed-shape per-frame record (reference include/Frame.h:147-177)."""

    frame_id: int
    timestamp: float
    xy: jnp.ndarray        # [S, 2] undistorted keypoint coords
    xy_raw: jnp.ndarray    # [S, 2] raw (distorted) coords
    ur: jnp.ndarray        # [S] virtual right x (<0 = mono feature)
    depth: jnp.ndarray     # [S] depth (<0 = unknown)
    octave: jnp.ndarray    # [S] int32
    angle: jnp.ndarray     # [S]
    desc: jnp.ndarray      # [S, 8] uint32
    valid: jnp.ndarray     # [S] bool


class FrameBuilder:
    """Builds FrameData from images; owns the static config + intrinsics."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.K = cam_geo.Intrinsics.from_config(cfg.camera)
        self.scale_factors = jnp.asarray(
            pyramid.level_scales(cfg.orb), jnp.float32
        )
        self._next_id = 0

    def _fresh_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    def monocular(self, image: jnp.ndarray, timestamp: float = 0.0) -> FrameData:
        feats = orb.extract(image, self.cfg.orb)
        und = self._undistort(feats.xy)
        S = feats.xy.shape[0]
        return FrameData(
            frame_id=self._fresh_id(),
            timestamp=timestamp,
            xy=und,
            xy_raw=feats.xy,
            ur=jnp.full((S,), -1.0, jnp.float32),
            depth=jnp.full((S,), -1.0, jnp.float32),
            octave=feats.octave,
            angle=feats.angle,
            desc=feats.desc,
            valid=feats.valid,
        )

    def rgbd(self, image: jnp.ndarray, depth_map: jnp.ndarray, timestamp: float = 0.0) -> FrameData:
        feats = orb.extract(image, self.cfg.orb)
        und = self._undistort(feats.xy)
        sm = stereo.compute_stereo_from_rgbd(
            feats.xy,
            und,
            feats.valid,
            depth_map,
            jnp.float32(1.0 / self.cfg.tracking.depth_map_factor),
            self.K.bf,
        )
        return FrameData(
            frame_id=self._fresh_id(),
            timestamp=timestamp,
            xy=und,
            xy_raw=feats.xy,
            ur=sm.u_right,
            depth=sm.depth,
            octave=feats.octave,
            angle=feats.angle,
            desc=feats.desc,
            valid=feats.valid,
        )

    def stereo(self, left: jnp.ndarray, right: jnp.ndarray, timestamp: float = 0.0) -> FrameData:
        fl = orb.extract(left, self.cfg.orb)
        fr = orb.extract(right, self.cfg.orb)
        lv_l = pyramid.build_pyramid(left, self.cfg.orb)
        lv_r = pyramid.build_pyramid(right, self.cfg.orb)
        sm = stereo.compute_stereo_matches(
            fl.xy, fl.octave, fl.desc, fl.valid,
            fr.xy, fr.octave, fr.desc, fr.valid,
            lv_l, lv_r, self.scale_factors, self.K.bf, self.K.fx,
        )
        und = self._undistort(fl.xy)
        return FrameData(
            frame_id=self._fresh_id(),
            timestamp=timestamp,
            xy=und,
            xy_raw=fl.xy,
            ur=sm.u_right,
            depth=sm.depth,
            octave=fl.octave,
            angle=fl.angle,
            desc=fl.desc,
            valid=fl.valid,
        )

    def _undistort(self, xy: jnp.ndarray) -> jnp.ndarray:
        if not self.cfg.camera.has_distortion():
            return xy
        return cam_geo.undistort_pixels(xy, self.K)
