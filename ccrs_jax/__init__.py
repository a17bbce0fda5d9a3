"""ccrs_jax — camera intrinsic calibration from AprilGrid boards in JAX.

A from-scratch rebuild of the capabilities of
``powei-lin/camera-intrinsic-calibration-rs`` (the ``ccrs`` CLI) as batched
accelerator programs:

- the six camera models (UCM/EUCM/EUCMT/KB4/OPENCV5/FTHETA) are pure-JAX
  ``project``/``unproject`` functions, vmapped over points and frames
  (``ccrs_jax.models``);
- the AprilGrid detector is a batched pipeline: an XLA image front-end,
  a small native C++ stage for the irregular quad extraction, and batched
  JAX decode + subpixel refinement (``ccrs_jax.detect``);
- the bundle-adjustment solver is an on-device Levenberg–Marquardt with a
  ``lax.while_loop`` damping schedule, Huber IRLS weights, box bounds, and a
  Schur-complement solve over the intrinsics/pose block structure
  (``ccrs_jax.solve``);
- RANSAC radial-distortion-homography initialization and SQPnP run fully
  batched under ``jit`` (``ccrs_jax.solve.homography``, ``ccrs_jax.solve.pnp``);
- multi-device scaling shards the frame batch over a ``jax.sharding.Mesh``
  with ``psum`` reductions of the normal equations (``ccrs_jax.parallel``).

Dataset layouts, board/model JSON schemas and output artifacts are kept
interchangeable with the Rust reference.
"""

import os as _os

import jax

# The calibration core targets <=1e-6 px agreement with the f64 reference
# solver; enable x64 globally and keep image-path dtypes explicitly f32.
jax.config.update("jax_enable_x64", True)

# On the GPU a float32 matmul/einsum runs in TF32 (10-bit mantissa) unless
# asked otherwise: a 500 px coordinate would keep only ~0.25 px, far above
# the sub-millipixel budget of the renderer and the tracking homography fits.
# Geometry matmuls here are tiny (3x3 poses, 8x8 normal equations), so
# force full f32 everywhere.  The two +-1 code-matching matmuls in
# detect/decode.py opt back into DEFAULT precision: their entries and
# sums of at most 64 terms are exact in TF32 too.
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; when it is set the package leaves the choice to it.  Otherwise the
# cache lives at a fixed path in the checkout (the path is part of the
# cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(__file__)), ".xla_cache"),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"
