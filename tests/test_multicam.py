"""Multi-camera extrinsic init + joint BA tests (synthetic stereo rig)."""

import jax.numpy as jnp
import numpy as np

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.calib.frames import FrameBatch
from ccrs_jax.calib.multi import calib_all_camera_with_extrinsics, init_camera_extrinsic
from ccrs_jax.models import GenericModel
from ccrs_jax.models.projections import project_fn
from ccrs_jax.solve import se3
from ccrs_jax.types import RvecTvec

from synthetic import make_synthetic_batch, tumvi_like_eucm


def _stereo_case(seed=0, F=14):
    board = create_default_6x6_board()
    cam0 = tumvi_like_eucm()
    cam1 = GenericModel("eucm", [192.0, 191.5, 255.5, 254.5, 0.61, 1.05], 512, 512)
    batch0, poses_gt = make_synthetic_batch(cam0, board, n_frames=F, seed=seed)
    # true extrinsic cam1<-cam0: small stereo baseline
    r10 = np.array([0.02, -0.015, 0.005])
    t10 = np.array([-0.11, 0.002, 0.004])
    proj1 = project_fn("eucm")
    p2d1 = np.zeros_like(batch0.p2d)
    mask1 = np.zeros_like(batch0.mask)
    for f in range(F):
        rv, tv = se3.compose(
            jnp.asarray(r10), jnp.asarray(t10),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        pc = board.p3d @ np.asarray(se3.exp_so3(rv)).T + np.asarray(tv)
        p2d, valid = proj1(jnp.asarray(cam1.params), jnp.asarray(pc))
        p2d = np.asarray(p2d)
        inside = (
            np.asarray(valid)
            & (p2d[:, 0] >= 0) & (p2d[:, 0] < 512)
            & (p2d[:, 1] >= 0) & (p2d[:, 1] < 512)
        )
        p2d1[f] = np.where(inside[:, None], p2d, 0.0)
        mask1[f] = inside
    batch1 = FrameBatch(batch0.time_ns.copy(), p2d1, mask1, 512, 512)
    return board, (cam0, cam1), (batch0, batch1), poses_gt, (r10, t10)


def test_extrinsic_init_from_common_frames():
    board, cams, batches, poses_gt, (r10, t10) = _stereo_case()
    F = poses_gt.shape[0]
    rng = np.random.default_rng(1)
    rt0 = {f: RvecTvec(poses_gt[f, :3], poses_gt[f, 3:]) for f in range(F)}
    rt1 = {}
    for f in range(0, F, 1):
        rv, tv = se3.compose(
            jnp.asarray(r10), jnp.asarray(t10),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        # mild noise so the pose-graph solve has work to do
        rt1[f] = RvecTvec(
            np.asarray(rv) + rng.normal(size=3) * 1e-4,
            np.asarray(tv) + rng.normal(size=3) * 1e-4,
        )
    exts = init_camera_extrinsic([rt0, rt1])
    assert np.allclose(exts[0].rvec, 0) and np.allclose(exts[0].tvec, 0)
    np.testing.assert_allclose(exts[1].rvec, r10, atol=1e-4)
    np.testing.assert_allclose(exts[1].tvec, t10, atol=1e-4)


def test_joint_ba_recovers_stereo_rig():
    board, (cam0, cam1), (batch0, batch1), poses_gt, (r10, t10) = _stereo_case(seed=2)
    F = poses_gt.shape[0]
    rng = np.random.default_rng(3)
    # perturbed single-camera "results" as joint-BA input
    cam0_in = cam0.copy()
    cam0_in.set_params(cam0.params * (1 + rng.normal(size=6) * 0.01))
    cam1_in = cam1.copy()
    cam1_in.set_params(cam1.params * (1 + rng.normal(size=6) * 0.01))
    rt0 = {
        f: RvecTvec(
            poses_gt[f, :3] + rng.normal(size=3) * 2e-3,
            poses_gt[f, 3:] + rng.normal(size=3) * 2e-3,
        )
        for f in range(F)
    }
    rt1 = {}
    for f in range(F):
        rv, tv = se3.compose(
            jnp.asarray(r10), jnp.asarray(t10),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        rt1[f] = RvecTvec(
            np.asarray(rv) + rng.normal(size=3) * 2e-3,
            np.asarray(tv) + rng.normal(size=3) * 2e-3,
        )
    t_init = init_camera_extrinsic([rt0, rt1])
    out = calib_all_camera_with_extrinsics(
        board, [cam0_in, cam1_in], t_init, [rt0, rt1], [batch0, batch1],
        xy_same_focal=False, disabled_distortions=0, cam0_fixed_focal=False,
    )
    assert out is not None
    intrinsics, t_i_0, board_poses = out
    np.testing.assert_allclose(intrinsics[0].params, cam0.params, rtol=1e-6)
    np.testing.assert_allclose(intrinsics[1].params, cam1.params, rtol=1e-6)
    np.testing.assert_allclose(t_i_0[1].rvec, r10, atol=1e-7)
    np.testing.assert_allclose(t_i_0[1].tvec, t10, atol=1e-7)
    assert len(board_poses) == F
    for f in range(F):
        np.testing.assert_allclose(board_poses[f].rvec, poses_gt[f, :3], atol=1e-6)


def test_mixed_precision_joint_ba_matches_f64():
    """ba_solve_multi_mixed (f32 bulk + f64 polish) reproduces the pure-f64
    joint solution on a noisy stereo problem."""
    from ccrs_jax.models.projections import project_eucm
    from ccrs_jax.solve.lm import ba_solve_multi, ba_solve_multi_mixed

    board, (cam0, cam1), (batch0, batch1), poses_gt, (r10, t10) = _stereo_case(seed=5)
    F = poses_gt.shape[0]
    rng = np.random.default_rng(4)
    C = 2
    p2d = np.stack([batch0.p2d, batch1.p2d]) + rng.normal(
        size=(C, F, board.n_corners, 2)
    ) * 0.1
    w = np.stack([batch0.mask, batch1.mask]).astype(float)
    theta0 = jnp.asarray(
        np.stack([cam0.params, cam1.params]) * (1 + rng.normal(size=(C, 6)) * 0.01)
    )
    ext0 = jnp.asarray(
        np.stack([np.zeros(6), np.concatenate([r10, t10]) + 2e-3])
    )
    poses0 = jnp.asarray(poses_gt + rng.normal(size=poses_gt.shape) * 2e-3)
    lo = jnp.asarray(np.tile([0, 0, 0, 0, 1e-6, 1e-6], (C, 1)), jnp.float64)
    hi = jnp.asarray(np.tile([1e4, 1e4, 512, 512, 1, 10], (C, 1)), jnp.float64)
    free = jnp.ones((C, 6))
    cfv = jnp.asarray((w.sum(2) >= 24).astype(float))
    fv = jnp.ones(F)
    args = (
        project_eucm, theta0, ext0, poses0, jnp.asarray(board.p3d),
        jnp.asarray(p2d), jnp.asarray(w), lo, hi, free, cfv, fv,
    )
    ref = ba_solve_multi(*args)
    mix = ba_solve_multi_mixed(*args)
    # same optimum.  The polish stage stops at solve.lm.polish_rtol()
    # (1e-10 relative cost) instead of deep convergence, which leaves the
    # parameters within ~2e-7 relative of the fully-converged f64 fixed
    # point (~4e-5 px for cx/cy) — far inside the 1e-6 px interchange
    # gate that defines "same" for this framework (bench.py).
    np.testing.assert_allclose(np.asarray(mix.theta), np.asarray(ref.theta), rtol=5e-7)
    np.testing.assert_allclose(np.asarray(mix.ext), np.asarray(ref.ext), atol=5e-7)
    np.testing.assert_allclose(float(mix.cost), float(ref.cost), rtol=1e-9)


def test_joint_ba_stereo_ftheta():
    """BASELINE configs[3]: stereo joint intrinsic+extrinsic, FTHETA."""
    from ccrs_jax.models.projections import project_ftheta

    board = create_default_6x6_board()
    cam = GenericModel(
        "ftheta",
        [190.4, 190.1, 255.5, 255.9, 0.015, -0.006, 0.002, -0.0004, 0.0001],
        512, 512,
    )
    batch0, poses_gt = make_synthetic_batch(cam, board, n_frames=10, seed=9)
    F = poses_gt.shape[0]
    r10 = np.array([0.01, -0.02, 0.004])
    t10 = np.array([-0.1, 0.003, 0.002])
    p2d1 = np.zeros_like(batch0.p2d)
    mask1 = np.zeros_like(batch0.mask)
    for f in range(F):
        rv, tv = se3.compose(
            jnp.asarray(r10), jnp.asarray(t10),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        pc = board.p3d @ np.asarray(se3.exp_so3(rv)).T + np.asarray(tv)
        p2d, valid = project_ftheta(jnp.asarray(cam.params), jnp.asarray(pc))
        p2d = np.asarray(p2d)
        inside = (
            np.asarray(valid)
            & (p2d[:, 0] >= 0) & (p2d[:, 0] < 512)
            & (p2d[:, 1] >= 0) & (p2d[:, 1] < 512)
        )
        p2d1[f] = np.where(inside[:, None], p2d, 0.0)
        mask1[f] = inside
    batch1 = FrameBatch(batch0.time_ns.copy(), p2d1, mask1, 512, 512)

    rng = np.random.default_rng(10)
    rt0 = {
        f: RvecTvec(
            poses_gt[f, :3] + rng.normal(size=3) * 1e-3,
            poses_gt[f, 3:] + rng.normal(size=3) * 1e-3,
        )
        for f in range(F)
    }
    rt1 = {}
    for f in range(F):
        rv, tv = se3.compose(
            jnp.asarray(r10), jnp.asarray(t10),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        rt1[f] = RvecTvec(
            np.asarray(rv) + rng.normal(size=3) * 1e-3,
            np.asarray(tv) + rng.normal(size=3) * 1e-3,
        )
    cam_in0 = cam.copy()
    cam_in0.set_params(cam.params * (1 + rng.normal(size=9) * 2e-3))
    cam_in1 = cam.copy()
    cam_in1.set_params(cam.params * (1 + rng.normal(size=9) * 2e-3))
    t_init = init_camera_extrinsic([rt0, rt1])
    out = calib_all_camera_with_extrinsics(
        board, [cam_in0, cam_in1], t_init, [rt0, rt1], [batch0, batch1],
        xy_same_focal=False, disabled_distortions=0, cam0_fixed_focal=False,
    )
    assert out is not None
    intrinsics, t_i_0, _ = out
    np.testing.assert_allclose(intrinsics[0].params[:4], cam.params[:4], rtol=1e-5)
    np.testing.assert_allclose(intrinsics[1].params[:4], cam.params[:4], rtol=1e-5)
    np.testing.assert_allclose(t_i_0[1].rvec, r10, atol=1e-6)
    np.testing.assert_allclose(t_i_0[1].tvec, t10, atol=1e-6)
