"""orbslam2_tpu — a visual SLAM engine (ORB-SLAM2-class) in JAX.

A from-scratch JAX reimplementation of the capabilities of ORB-SLAM2
(reference: Hello-Water/ORB-SLAM2-ChineseNotes): monocular, stereo and
RGB-D feature-based SLAM with ORB extraction, covisibility mapping, place
recognition, relocalization, loop closing and bundle adjustment — built
for an accelerator (it runs on an NVIDIA GPU) rather than translated:

* dense, batched, fixed-shape kernels instead of per-feature loops;
* a device-resident struct-of-arrays map pytree instead of a
  pointer-graph guarded by mutexes;
* one jit-compiled Gauss-Newton/LM core with Schur complement instead
  of g2o;
* dense matmul bag-of-words scoring instead of DBoW2's inverted files;
* `jax.sharding` mesh parallelism for global BA instead of threads.

Public session API mirrors the reference's `System` class
(reference include/System.h:65-136).
"""

from orbslam2_tpu.config import SlamConfig, Sensor

__version__ = "0.1.0"

__all__ = ["SlamConfig", "Sensor", "__version__"]
