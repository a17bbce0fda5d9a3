"""Speculative-calibration correctness: the warm-started final solve must
land on the same optimum as the cold solve (calib/pipeline.SpeculativeCalib
overlaps the detector's audit rounds; the warm start may only change the
LM iteration count, never the result beyond solver tolerance)."""

import numpy as np
import jax.random as jr

import ccrs_jax.calib.pipeline as pipeline_mod
from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.calib.frames import FrameBatch
from ccrs_jax.calib.pipeline import (
    SpeculativeCalib,
    calibrate_camera_with_retries,
    fill_poses_lerp,
)
from ccrs_jax.calib.single import calib_camera
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel, zeros_like_model
from ccrs_jax.testdata import render_board_image, smooth_sequence_poses
from ccrs_jax.types import CalibParams

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]


def _render_seq(n):
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    gt = GenericModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(n, board, seed=3)
    imgs = np.stack(
        [
            render_board_image(gt, board, fam, p[:3], p[3:], noise=1.0, seed=f)
            for f, p in enumerate(poses)
        ]
    )
    return board, imgs


def test_warm_start_matches_cold_optimum():
    """calib_camera(warm_poses=cold solution) must reproduce the cold
    optimum (the warm blend with valid poses is the speculative final
    solve's exact code path)."""
    board, imgs = _render_seq(12)
    det = TagDetector("t36h11", track=False)
    dets = det.detect_batch(imgs, board=board)
    batch = FrameBatch.from_detections(
        dets, list(range(len(imgs))), board, 512, 512
    )
    model0 = GenericModel("eucm", [210.0, 210.0, 256.0, 256.0, 0.6, 1.0], 512, 512)
    cold = calib_camera(
        board, batch, model0, xy_same_focal=False,
        disabled_distortions=0, fixed_focal=False,
    )
    assert cold is not None
    model_c, rt_c = cold

    F = batch.p2d.shape[0]
    poses = np.zeros((F, 6))
    valid = np.zeros(F)
    for i, rt in rt_c.items():
        poses[i, :3], poses[i, 3:] = rt.rvec, rt.tvec
        # perturb: the speculative solution is NEAR the final optimum,
        # not exactly on it (audits correct a few frames)
        poses[i] += 1e-4 * np.sin(np.arange(6) + i)
        valid[i] = 1.0
    warm_model = model_c.copy()
    warm = calib_camera(
        board, batch, warm_model, xy_same_focal=False,
        disabled_distortions=0, fixed_focal=False,
        warm_poses=poses, warm_valid=valid,
    )
    assert warm is not None
    model_w, rt_w = warm
    np.testing.assert_allclose(model_w.params, model_c.params, atol=1e-6)
    for i in rt_c:
        np.testing.assert_allclose(
            rt_w[i].rvec, rt_c[i].rvec, atol=1e-6
        )


def test_skip_pose_init_matches_cold_optimum():
    """The no-PnP warm variant (skip_pose_init=True, full-coverage warm
    poses) must converge to the same optimum as the cold full-PnP solve —
    it replaces the f64 PnP on the device, and may only
    change the LM trajectory, never the result."""
    board, imgs = _render_seq(12)
    det = TagDetector("t36h11", track=False)
    dets = det.detect_batch(imgs, board=board)
    batch = FrameBatch.from_detections(
        dets, list(range(len(imgs))), board, 512, 512
    )
    model0 = GenericModel("eucm", [210.0, 210.0, 256.0, 256.0, 0.6, 1.0], 512, 512)
    cold = calib_camera(
        board, batch, model0, xy_same_focal=False,
        disabled_distortions=0, fixed_focal=False,
    )
    assert cold is not None
    model_c, rt_c = cold

    F = batch.p2d.shape[0]
    poses = np.zeros((F, 6))
    valid = np.zeros(F)
    for i, rt in rt_c.items():
        poses[i, :3], poses[i, 3:] = rt.rvec, rt.tvec
        poses[i] += 1e-3 * np.cos(np.arange(6) * 2 + i)  # near, not on
        valid[i] = 1.0
    assert fill_poses_lerp(poses, valid)  # fill any PnP-skipped frames
    warm = calib_camera(
        board, batch, model_c.copy(), xy_same_focal=False,
        disabled_distortions=0, fixed_focal=False,
        warm_poses=poses, warm_valid=np.ones(F),
        skip_pose_init=True,
    )
    assert warm is not None
    model_w, rt_w = warm
    np.testing.assert_allclose(model_w.params, model_c.params, atol=1e-6)
    from ccrs_jax.solve import se3

    probe = np.eye(3)
    for i in rt_c:
        # the lerp fill may re-branch an rvec to its equivalent opposite
        # axis-angle representative (r vs (1-2pi/|r|)r) — compare the
        # ROTATIONS, not the raw vectors
        np.testing.assert_allclose(
            np.asarray(se3.transform(rt_w[i].rvec, np.zeros(3), probe)),
            np.asarray(se3.transform(rt_c[i].rvec, np.zeros(3), probe)),
            atol=1e-6,
        )
        np.testing.assert_allclose(rt_w[i].tvec, rt_c[i].tvec, atol=1e-6)


def test_fill_poses_lerp_rvec_double_cover():
    """fill_poses_lerp must re-branch axis-angle representatives before
    lerping: r and (1 - 2*pi/|r|) r encode the SAME rotation, and naive
    componentwise lerp across such a flip produces a garbage rotation."""
    from ccrs_jax.solve import se3

    def rotmat(rvec):
        p = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
        return np.asarray(se3.transform(rvec, np.zeros(3), p))

    # a smooth rotation about a fixed axis, angle ~pi-0.2 .. ~pi+0.2 —
    # express the later samples on the OPPOSITE representative branch
    axis = np.array([0.3, -0.5, 0.8])
    axis /= np.linalg.norm(axis)
    F = 9
    angles = np.linspace(np.pi - 0.2, np.pi + 0.2, F)
    poses = np.zeros((F, 6))
    valid = np.zeros(F)
    for k in (0, 4, 8):
        r = axis * angles[k]
        if k == 8:  # flip to the equivalent negative representative
            r = r * (1.0 - 2.0 * np.pi / angles[k])
        poses[k, :3] = r
        poses[k, 3:] = [0.1 * k, -0.2 * k, 1.0]
        valid[k] = 1.0
    assert fill_poses_lerp(poses, valid)
    # every filled rotation must stay close to the true trajectory
    for f in range(F):
        want = rotmat(axis * angles[f])
        got = rotmat(poses[f, :3])
        # rotation angle between them, in radians
        cosang = (np.trace(want.T @ got) - 1.0) / 2.0
        assert np.arccos(np.clip(cosang, -1, 1)) < 0.06, f
    # translations lerp exactly at the valid anchors' midpoints
    np.testing.assert_allclose(poses[2, 3:], [0.2, -0.4, 1.0], atol=1e-12)


def test_speculative_subsampled_matches_cold(monkeypatch):
    """The spec solve's frame subsampling (SPEC_MAX_FRAMES) + lerp fill +
    skip_pose_init final solve must still land on the cold optimum."""
    board, imgs = _render_seq(24)
    times = list(range(len(imgs)))
    monkeypatch.setattr(pipeline_mod, "SPEC_MAX_FRAMES", 8)  # stride 3

    det = TagDetector("t36h11", track=True)
    spec = SpeculativeCalib(
        board, times, zeros_like_model("eucm"), CalibParams(),
        jr.PRNGKey(7), 512, 512,
    )
    det.on_provisional = spec.on_provisional
    dets = det.detect_batch(imgs, board=board)
    batch = FrameBatch.from_detections(dets, times, board, 512, 512)
    model_spec, _ = calibrate_camera_with_retries(
        board, batch, zeros_like_model("eucm"), CalibParams(),
        jr.PRNGKey(7), warm_provider=spec.take,
    )
    warm = spec.take()
    assert warm is not None and np.all(warm[2] > 0)  # full-coverage seed

    det2 = TagDetector("t36h11", track=True)
    dets2 = det2.detect_batch(imgs, board=board)
    batch2 = FrameBatch.from_detections(dets2, times, board, 512, 512)
    model_cold, _ = calibrate_camera_with_retries(
        board, batch2, zeros_like_model("eucm"), CalibParams(), jr.PRNGKey(7),
    )
    np.testing.assert_allclose(
        model_spec.params, model_cold.params, rtol=1e-6, atol=1e-5
    )


def test_speculative_long_gap_keeps_pnp():
    """A provisional batch with a LONG unsolved run (fast motion defeating
    the tracker mid-segment; the audits repair those frames only AFTER
    the speculation fires) must NOT be lerp-filled into a full-coverage
    seed: linear interpolation across many frames of handheld motion
    produces garbage poses, and with the PnP skipped the final solve was
    measured converging to a WRONG basin under the sanity gate (fx 196.6
    vs 191.1 on a 22-frame CLI dataset).  Long-gap frames must keep
    warm_valid=0 so the final solve PnP-inits them."""
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    gt = GenericModel("eucm", GT, 512, 512)
    poses = smooth_sequence_poses(22, board, seed=3)
    solved = [0, 1, 2, 19, 20, 21]
    imgs = np.stack(
        [
            render_board_image(
                gt, board, fam, poses[f][:3], poses[f][3:], noise=1.0, seed=f
            )
            for f in solved
        ]
    )
    dets = TagDetector("t36h11", track=False).detect_batch(imgs, board=board)
    results = [dict() for _ in range(22)]
    for f, d in zip(solved, dets):
        results[f] = d
    spec = SpeculativeCalib(
        board, list(range(22)), zeros_like_model("eucm"), CalibParams(),
        jr.PRNGKey(7), 512, 512,
    )
    spec.on_provisional(results)
    warm = spec.take()
    assert warm is not None, "spec solve should succeed on the 6 frames"
    _, _, valid, _ = warm
    assert not np.all(valid > 0), "17-frame gap must not claim full coverage"
    assert set(np.flatnonzero(valid)) <= set(solved)


def test_speculative_pipeline_end_to_end():
    """Tracked detect with the on_provisional hook + warm-start retries
    must produce the same calibration as the cold pipeline."""
    board, imgs = _render_seq(24)
    times = list(range(len(imgs)))

    def run(speculate: bool):
        det = TagDetector("t36h11", track=True)
        spec = SpeculativeCalib(
            board, times, zeros_like_model("eucm"), CalibParams(),
            jr.PRNGKey(7), 512, 512,
        )
        if speculate:
            det.on_provisional = spec.on_provisional
        dets = det.detect_batch(imgs, board=board)
        batch = FrameBatch.from_detections(dets, times, board, 512, 512)
        return calibrate_camera_with_retries(
            board, batch, zeros_like_model("eucm"), CalibParams(),
            jr.PRNGKey(7), warm_provider=spec.take if speculate else None,
        )

    model_cold, _ = run(False)
    model_spec, _ = run(True)
    # same optimum within solver tolerance (not bitwise: different LM
    # trajectories); focal agreement to ~1e-4 px-equivalents
    np.testing.assert_allclose(
        model_spec.params, model_cold.params, rtol=1e-6, atol=1e-5
    )
    # and the speculation must actually have produced a warm start on a
    # clean tracked sequence (otherwise the test silently degenerates)
    spec_probe = SpeculativeCalib(
        board, times, zeros_like_model("eucm"), CalibParams(),
        jr.PRNGKey(7), 512, 512,
    )
    det = TagDetector("t36h11", track=True)
    det.on_provisional = spec_probe.on_provisional
    det.detect_batch(imgs, board=board)
    assert spec_probe.take() is not None
