"""Eager-op discipline: the product pipeline must not leak one-op graphs.

On an accelerator every eagerly-executed jnp primitive compiles and
launches its own single-op executable; ~110 such leaks accounted for a
large slice of the measured warmup before they were pinned to the local
CPU backend or folded into jits (utils/host.py).  This test runs a small end-to-end pipeline while
counting eager primitive dispatches that would land on the accelerator
(i.e. NOT under a ``cpu_scope()``/``default_device`` pin) and bounds
them, so a stray ``jnp.asarray(x, dtype)`` or un-jitted helper cannot
silently reintroduce tens of one-op compiles.

The bound is intentionally loose (real compute graphs plus a handful of
device-data stitches like the wave-output stack are expected); the guard
is against order-of-magnitude regressions, not exact counts.
"""

import collections
import logging

import numpy as np
import pytest


@pytest.mark.slow
def test_pipeline_eager_dispatch_budget(tmp_path):
    import jax

    import jax.random as jr
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.calib import validation
    from ccrs_jax.calib.frames import FrameBatch
    from ccrs_jax.calib.pipeline import calibrate_camera_with_retries
    from ccrs_jax.calib.prewarm import prewarm_calibration
    from ccrs_jax.detect import TagDetector, get_family
    from ccrs_jax.models import GenericModel, zeros_like_model
    from ccrs_jax.testdata import render_frames_device, smooth_sequence_poses
    from ccrs_jax.types import CalibParams

    unpinned = collections.Counter()

    class Handler(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "Compiling jit(" not in msg:
                return
            name = msg.split("Compiling jit(", 1)[1].split(")", 1)[0]
            try:
                pinned = jax._src.config.default_device.value is not None
            except Exception:  # pragma: no cover - config layout change
                pinned = False
            if not pinned:
                unpinned[name] += 1

    handler = Handler()
    loggers = [
        logging.getLogger(n)
        for n in (
            "jax",
            "jax._src.interpreters.pxla",
            "jax._src.pjit",
            "jax._src.dispatch",
        )
    ]
    old_levels = [lg.level for lg in loggers]
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.DEBUG)
    old_flag = jax.config.jax_log_compiles
    jax.config.update("jax_log_compiles", True)
    try:
        board = create_default_6x6_board()
        gt = GenericModel(
            "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
        )
        n = 24
        poses = smooth_sequence_poses(n, board, seed=3)
        detector = TagDetector("t36h11")
        prewarm_calibration(board, n, "eucm", CalibParams(), 512, 512)
        imgs = render_frames_device(
            gt, board, get_family("t36h11"), poses, noise=1.5, seed=3
        )
        imgs.block_until_ready()
        dets = detector.detect_batch(None, board=board, dev_images=imgs)
        batch = FrameBatch.from_detections(
            dets, list(range(n)), board, 512, 512
        )
        result = calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(), jr.PRNGKey(0)
        )
        assert result is not None
        model, rtvecs = result
        validation(board, batch, model, rtvecs)
    finally:
        jax.config.update("jax_log_compiles", old_flag)
        for lg, lv in zip(loggers, old_levels):
            lg.removeHandler(handler)
            lg.setLevel(lv)

    total = sum(unpinned.values())
    # measured 2026-08: ~32 on this path (real compute graphs + stitches);
    # was 174 before the eager-op cleanup.  60 = loose regression guard.
    assert total <= 60, (
        f"{total} unpinned eager/jit compiles (budget 60): "
        f"{dict(unpinned.most_common(20))}"
    )
