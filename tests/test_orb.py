"""Unit + metamorphic tests for the ORB front end (FAST, IC angle, BRIEF,
selection, full extraction) — the test classes SURVEY.md §4 prescribes."""

import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.config import OrbConfig
from orbslam2_tpu.ops import fast, hamming, orb, patches, pyramid


def textured_image(rng, h=480, w=640, scale=60.0):
    """Smooth random texture with corner-rich structure."""
    img = rng.uniform(0, 1, size=(h // 8, w // 8))
    import scipy.ndimage as ndi

    img = ndi.zoom(img, 8, order=1)
    img = np.pad(img, ((0, max(0, h - img.shape[0])), (0, max(0, w - img.shape[1]))), mode="edge")[:h, :w]
    img = (img * scale + rng.uniform(0, 1, size=(h, w)) * 5.0) + 60.0
    # stamp some high-contrast squares for unambiguous corners
    if h > 160 and w > 160:
        for i in range(6):
            y, x = rng.integers(50, h - 80), rng.integers(50, w - 80)
            img[y : y + 30, x : x + 30] = 220.0 if i % 2 else 15.0
    return img.astype(np.float32)


class TestFast:
    def test_flat_image_no_corners(self):
        img = jnp.full((64, 64), 100.0)
        corner, _ = fast.fast_score_map(img, jnp.float32(20.0))
        assert not bool(jnp.any(corner))

    def test_square_corner_detected(self):
        img = np.full((64, 64), 50.0, np.float32)
        img[20:40, 20:40] = 200.0
        score, strong = fast.detect(jnp.asarray(img), 20, 7, border=8)
        found = np.asarray(score) > -np.inf
        # corners of the square should fire (within a couple px)
        for cy, cx in [(20, 20), (20, 39), (39, 20), (39, 39)]:
            assert found[cy - 3 : cy + 4, cx - 3 : cx + 4].any(), (cy, cx)
        # edge midpoints should NOT fire (FAST rejects edges)
        assert not found[28:32, 18:23].any()

    def test_arc_rule(self):
        # a single bright pixel ring segment < 9 long must not trigger
        bits_8 = jnp.int32(0b0000000011111111)  # run of 8
        bits_9 = jnp.int32(0b0000000111111111)  # run of 9
        wrap_9 = jnp.int32(0b1111000000011111)  # wrap-around run of 9
        assert not bool(fast._has_arc(bits_8[None, None])[0, 0])
        assert bool(fast._has_arc(bits_9[None, None])[0, 0])
        assert bool(fast._has_arc(wrap_9[None, None])[0, 0])

    def test_nms_keeps_single_max(self):
        score = np.zeros((16, 16), np.float32)
        score[8, 8] = 10.0
        score[8, 9] = 5.0
        keep = np.asarray(fast.nms_3x3(jnp.asarray(score)))
        assert keep[8, 8] and not keep[8, 9]


class TestICAngle:
    def test_matches_bruteforce(self, rng):
        pt = rng.uniform(0, 255, size=(4, 31, 31)).astype(np.float32)
        ang = np.asarray(patches.ic_angle(jnp.asarray(pt), 15))
        ys, xs = np.mgrid[-15:16, -15:16]
        mask = (ys**2 + xs**2) <= 225 + 1e-3
        for i in range(4):
            m10 = (pt[i] * xs * mask).sum()
            m01 = (pt[i] * ys * mask).sum()
            assert ang[i] == pytest.approx(np.arctan2(m01, m10), abs=1e-4)

    def test_rotation_90(self, rng):
        pt = rng.uniform(0, 255, size=(31, 31)).astype(np.float32)
        a0 = float(patches.ic_angle(jnp.asarray(pt)[None], 15)[0])
        # rot90(k=-1) rotates the image content by +90deg in (x right, y down)
        pt90 = np.rot90(pt, k=-1).copy()
        a90 = float(patches.ic_angle(jnp.asarray(pt90)[None], 15)[0])
        d = (a90 - a0 - np.pi / 2 + np.pi) % (2 * np.pi) - np.pi
        assert abs(d) < 0.05


class TestBrief:
    def test_descriptor_deterministic(self, rng):
        img = jnp.asarray(textured_image(rng, 128, 128))
        xy = jnp.asarray([[40.0, 40.0], [80.0, 70.0]])
        ang = jnp.asarray([0.3, -1.0])
        d1 = orb.brief_descriptors(img, xy, ang)
        d2 = orb.brief_descriptors(img, xy, ang)
        assert np.array_equal(np.asarray(d1), np.asarray(d2))
        assert d1.shape == (2, 8) and d1.dtype == jnp.uint32

    def test_rotation_invariance(self, rng):
        """Steered BRIEF: rotating image AND angle leaves descriptor ~stable."""
        img = textured_image(rng, 129, 129)
        center = 64
        xy = jnp.asarray([[float(center), float(center)]])
        blurred = pyramid.gaussian_blur(jnp.asarray(img))
        a0 = patches.ic_angle(patches.gather_patches(blurred, xy, 15), 15)
        d0 = orb.brief_descriptors(blurred, xy, a0)

        img90 = np.rot90(img, k=-1).copy()
        blurred90 = pyramid.gaussian_blur(jnp.asarray(img90))
        a90 = patches.ic_angle(patches.gather_patches(blurred90, xy, 15), 15)
        d90 = orb.brief_descriptors(blurred90, xy, a90)
        dist = int(hamming.distance(d0[0], d90[0]))
        assert dist < 60, dist  # well under the 50-64 matcher thresholds

    def test_distinct_points_far(self, rng):
        img = jnp.asarray(textured_image(rng, 256, 256))
        xy = jnp.asarray([[60.0, 60.0], [180.0, 150.0]])
        ang = jnp.zeros(2)
        d = orb.brief_descriptors(img, xy, ang)
        assert int(hamming.distance(d[0], d[1])) > 60


class TestHamming:
    def test_popcount(self):
        v = jnp.asarray([0, 1, 0xFFFFFFFF, 0x80000001], jnp.uint32)
        np.testing.assert_array_equal(np.asarray(hamming.popcount_u32(v)), [0, 1, 32, 2])

    def test_matrix_matches_bits(self, rng):
        a = jnp.asarray(rng.integers(0, 2**32, size=(16, 8), dtype=np.uint32))
        b = jnp.asarray(rng.integers(0, 2**32, size=(24, 8), dtype=np.uint32))
        D = np.asarray(hamming.distance_matrix(a, b))
        A = np.unpackbits(np.asarray(a).view(np.uint8), axis=1)
        B = np.unpackbits(np.asarray(b).view(np.uint8), axis=1)
        D2 = (A[:, None, :] != B[None, :, :]).sum(-1)
        np.testing.assert_array_equal(D, D2)

    @pytest.mark.parametrize("n,m", [(256, 256), (100, 300), (1024, 4096)])
    def test_matcher_distance_matches_bitcount(self, rng, n, m):
        """The distance the matchers use, exact against a numpy bit count."""
        a = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
        b = rng.integers(0, 2**32, size=(m, 8), dtype=np.uint32)
        want = np.unpackbits(
            np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8), axis=-1
        ).sum(-1)
        got = np.asarray(hamming.distance_matrix(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(got, want)


class TestSelection:
    def test_round_robin_cells(self):
        score = np.full((64, 64), -np.inf, np.float32)
        # cell (0,0): 3 corners; far cell: 1 corner
        score[5, 5], score[10, 10], score[15, 15] = 30.0, 20.0, 10.0
        score[40, 40] = 5.0
        strong = np.zeros((64, 64), bool)
        xy, resp, valid = orb.select_uniform(
            jnp.asarray(score), jnp.asarray(strong), 2, 16, 32
        )
        got = {tuple(map(int, p)) for p in np.asarray(xy)[np.asarray(valid)]}
        # best of each cell, not the two best overall
        assert got == {(5, 5), (40, 40)}

    def test_strong_preference(self):
        score = np.full((64, 64), -np.inf, np.float32)
        score[5, 5] = 100.0   # weak corner, higher response
        score[20, 20] = 10.0  # strong corner, same cell
        strong = np.zeros((64, 64), bool)
        strong[20, 20] = True
        xy, resp, valid = orb.select_uniform(
            jnp.asarray(score), jnp.asarray(strong), 1, 16, 32
        )
        assert tuple(map(int, np.asarray(xy)[0])) == (20, 20)
        # response must be de-biased (the 1e6 bonus removed)
        assert float(resp[0]) == pytest.approx(10.0)


class TestExtract:
    def test_full_extraction(self, rng):
        cfg = OrbConfig(num_features=500, feature_slots=512, candidates_per_level=1024)
        img = jnp.asarray(textured_image(rng))
        feats = orb.extract(img, cfg)
        S = cfg.feature_slots
        assert feats.xy.shape == (S, 2)
        assert feats.desc.shape == (S, 8)
        nv = int(jnp.sum(feats.valid))
        assert nv > 300, nv
        v = np.asarray(feats.valid)
        xy = np.asarray(feats.xy)[v]
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < 640).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < 480).all()
        oct_ = np.asarray(feats.octave)[v]
        assert oct_.min() >= 0 and oct_.max() < cfg.num_levels
        # spatial spread: keypoints should cover at least half the 8x8 blocks
        bx = (xy[:, 0] // 80).astype(int)
        by = (xy[:, 1] // 60).astype(int)
        assert len(set(zip(bx, by))) > 30

    def test_budgets_sum(self):
        cfg = OrbConfig(num_features=1000)
        b = pyramid.feature_budgets(cfg)
        assert sum(b) == 1000
        assert all(b[i] >= b[i + 1] for i in range(len(b) - 2))
