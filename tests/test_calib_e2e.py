"""End-to-end feature-level calibration: synthetic GT camera -> full
init+convert+BA pipeline recovers the ground truth (the acceptance pattern
of BASELINE.json: RMS ~ 0 on noise-free data)."""

import jax
import numpy as np
import pytest

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.calib import (
    calib_camera,
    convert_model,
    init_and_calibrate_one_camera,
    validation,
)
from ccrs_jax.models import GenericModel, zeros_like_model
from ccrs_jax.types import CalibParams

from synthetic import make_synthetic_batch, tumvi_like_eucm


def test_full_pipeline_eucm():
    board = create_default_6x6_board()
    gt = tumvi_like_eucm()
    batch, poses_gt = make_synthetic_batch(gt, board, n_frames=20, seed=1)

    target = zeros_like_model("eucm")
    result = init_and_calibrate_one_camera(
        board, batch, target, CalibParams(), jax.random.PRNGKey(0)
    )
    assert result is not None
    model, rtvecs = result
    np.testing.assert_allclose(model.params, gt.params, rtol=2e-6)
    avg99, median = validation(board, batch, model, rtvecs)
    assert median < 1e-6 and avg99 < 1e-6


def test_attempt_metadata_is_per_call():
    """Attempt metadata (init frames / gate info) lives in the caller's
    ``out`` dict, not function attributes — SpeculativeCalib runs this
    function on a daemon thread per camera, and shared attributes let
    cam1's speculative solve cross-contaminate cam0's retry ladder
    (round-5 review fix)."""
    board = create_default_6x6_board()
    gt = tumvi_like_eucm()
    batch, _ = make_synthetic_batch(gt, board, n_frames=12, seed=5)
    out = {}
    result = init_and_calibrate_one_camera(
        board, batch, zeros_like_model("eucm"), CalibParams(),
        jax.random.PRNGKey(0), out=out,
    )
    assert result is not None
    f0, f1 = out["init_frames"]
    assert 0 <= f0 < 12 and 0 <= f1 < 12 and f0 != f1
    # no shared mutable state on the function itself
    assert not hasattr(init_and_calibrate_one_camera, "last_gated")
    assert not hasattr(init_and_calibrate_one_camera, "last_init_frames")
    # the retry ladder republishes the RETURNED attempt's keyframes
    # (main-thread only) for the CLI's Rerun markers
    from ccrs_jax.calib.pipeline import calibrate_camera_with_retries

    calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(),
        jax.random.PRNGKey(0),
    )
    lf = calibrate_camera_with_retries.last_init_frames
    assert lf is not None and len(lf) == 2


def test_full_pipeline_kb4_via_grid_convert():
    """Covers the grid-fit convert_model path (UCM -> KB4) + KB4 BA."""
    board = create_default_6x6_board()
    gt = GenericModel(
        "kb4", [190.5, 190.3, 256.2, 255.1, 0.01, -0.006, 0.004, -0.001], 512, 512
    )
    batch, _ = make_synthetic_batch(gt, board, n_frames=16, seed=2)
    target = zeros_like_model("kb4")
    result = init_and_calibrate_one_camera(
        board, batch, target, CalibParams(), jax.random.PRNGKey(1)
    )
    assert result is not None
    model, rtvecs = result
    avg99, median = validation(board, batch, model, rtvecs)
    assert median < 1e-5, f"median {median}"
    np.testing.assert_allclose(model.params[:4], gt.params[:4], rtol=1e-4)


def test_convert_model_analytic_ucm_to_eucm():
    """UCM->EUCM copies params and sets beta=1 (tests/util_test.rs:77-110)."""
    ucm = GenericModel("ucm", [500.0, 500.0, 320.0, 240.0, 0.5], 640, 480)
    eucm = GenericModel("eucm", [400.0, 400.0, 320.0, 240.0, 1e-3, 1.0], 640, 480)
    convert_model(ucm, eucm, 0)
    assert abs(eucm.params[0] - 500.0) < 1e-6
    assert abs(eucm.params[4] - 0.5) < 1e-6
    assert abs(eucm.params[5] - 1.0) < 1e-6


def test_convert_model_grid_fit_roundtrip():
    """EUCM -> UCM grid fit (the convert_model example path,
    examples/convert_model.rs) reproduces projections closely."""
    from synthetic import tumvi_like_eucm

    src = tumvi_like_eucm()
    tgt = zeros_like_model("ucm", 512, 512)
    convert_model(src, tgt, 0)
    # compare projections over a probe grid
    rng = np.random.default_rng(0)
    rays = rng.normal(size=(300, 3)) * [0.4, 0.4, 0] + [0, 0, 1]
    p_src, v_src = src.project(rays)
    p_tgt, v_tgt = tgt.project(rays)
    ok = v_src & v_tgt
    err = np.linalg.norm(p_src[ok] - p_tgt[ok], axis=-1)
    assert np.median(err) < 0.5, f"median convert err {np.median(err)} px"


def test_calib_camera_fixed_focal():
    board = create_default_6x6_board()
    gt = tumvi_like_eucm()
    batch, _ = make_synthetic_batch(gt, board, n_frames=12, seed=3)
    target = zeros_like_model("eucm")
    result = init_and_calibrate_one_camera(
        board,
        batch,
        target,
        CalibParams(fixed_focal=190.9),
        jax.random.PRNGKey(2),
    )
    assert result is not None
    model, rtvecs = result
    assert model.params[0] == 190.9 and model.params[1] == 190.9
    avg99, median = validation(board, batch, model, rtvecs)
    assert median < 0.05  # fy_gt != fx_gt, so not exactly 0


def test_calib_camera_disabled_distortion():
    board = create_default_6x6_board()
    gt = tumvi_like_eucm()
    batch, _ = make_synthetic_batch(gt, board, n_frames=12, seed=4)
    model0 = GenericModel("eucm", [200, 200, 256, 256, 0.5, 1.0], 512, 512)
    out = calib_camera(
        board, batch, model0, xy_same_focal=False,
        disabled_distortions=1, fixed_focal=False,
    )
    assert out is not None
    model, _ = out
    assert model.params[5] == 0.0  # beta pinned to zero
