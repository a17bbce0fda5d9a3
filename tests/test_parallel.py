"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccrs_jax.models.projections import project_eucm
from ccrs_jax.parallel.mesh import ba_step_sharded, make_mesh, pad_frames
from ccrs_jax.solve import se3
from ccrs_jax.solve.lm import ba_solve


def _case(F=16, N=36, seed=0):
    rng = np.random.default_rng(seed)
    p3d = np.zeros((N, 3))
    side = int(np.sqrt(N))
    g = np.stack(np.meshgrid(np.linspace(0, 0.5, side), np.linspace(0, -0.5, side)), -1)
    p3d[:, :2] = g.reshape(-1, 2)
    gt = np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
    poses, obs = [], []
    for _ in range(F):
        rv = rng.normal(size=3) * 0.2
        tv = np.array([-0.2, 0.25, 0.9]) + rng.normal(size=3) * 0.05
        pc = p3d @ np.asarray(se3.exp_so3(jnp.asarray(rv))).T + tv
        p2d, _ = project_eucm(jnp.asarray(gt), jnp.asarray(pc))
        poses.append(np.concatenate([rv, tv]))
        obs.append(np.asarray(p2d))
    return gt, p3d, np.stack(poses), np.stack(obs)


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_step_matches_single_device():
    gt, p3d, poses_gt, p2d = _case()
    mesh = make_mesh()
    theta0 = jnp.asarray(gt * 1.02)
    poses0 = jnp.asarray(poses_gt + 0.002)
    free = jnp.ones(6)
    lam = jnp.asarray(1e-6)
    (p2d_p, w_p, poses_p), F = pad_frames(
        [jnp.asarray(p2d), jnp.ones(p2d.shape[:2]), poses0], len(jax.devices())
    )
    th_sh, po_sh = ba_step_sharded(
        project_eucm, theta0, poses_p, jnp.asarray(p3d), p2d_p, w_p, free, lam, mesh
    )
    # single-device reference: one ba_solve iteration (max_iters=1 w/ same lam)
    res = ba_solve(
        project_eucm, theta0, poses0, jnp.asarray(p3d), jnp.asarray(p2d),
        jnp.ones(p2d.shape[:2]),
        jnp.asarray([-np.inf] * 6), jnp.asarray([np.inf] * 6), free,
        jnp.ones(p2d.shape[0]), max_iters=1, huber_delta=1.0,
    )
    np.testing.assert_allclose(np.asarray(th_sh), np.asarray(res.theta), rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(po_sh)[:F], np.asarray(res.poses), atol=1e-9
    )


def test_sharded_iterations_converge():
    gt, p3d, poses_gt, p2d = _case(F=24, seed=1)
    mesh = make_mesh()
    theta = jnp.asarray(gt * 1.03)
    free = jnp.ones(6)
    (p2d_p, w_p, poses), F = pad_frames(
        [jnp.asarray(p2d), jnp.ones(p2d.shape[:2]), jnp.asarray(poses_gt + 0.003)],
        len(jax.devices()),
    )
    p3d_j = jnp.asarray(p3d)
    for i in range(25):
        theta, poses = ba_step_sharded(
            project_eucm, theta, poses, p3d_j, p2d_p, w_p, free, jnp.asarray(1e-8), mesh
        )
    np.testing.assert_allclose(np.asarray(theta), gt, rtol=1e-8)


def test_sharded_multicam_solve_matches_single_device():
    """Frame-sharded joint multi-camera BA == single-device ba_solve_multi."""
    from ccrs_jax.parallel.mesh import make_multi_ba_solver, sharded_frame_sharding
    from ccrs_jax.solve.lm import ba_solve_multi

    gt, p3d, poses_gt, p2d0 = _case(F=16, seed=3)
    C, F, N = 2, p2d0.shape[0], p2d0.shape[1]
    ext_gt = np.array([[0, 0, 0, 0, 0, 0], [0.02, -0.015, 0.005, -0.11, 0.002, 0.004]])
    gt1 = gt * np.array([1.01, 1.005, 0.998, 1.002, 0.97, 1.02])
    p2d = np.zeros((C, F, N, 2))
    p2d[0] = p2d0
    for f in range(F):
        rv, tv = se3.compose(
            jnp.asarray(ext_gt[1, :3]), jnp.asarray(ext_gt[1, 3:]),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        pc = p3d @ np.asarray(se3.exp_so3(rv)).T + np.asarray(tv)
        p2d[1, f] = np.asarray(project_eucm(jnp.asarray(gt1), jnp.asarray(pc))[0])
    theta0 = jnp.asarray(np.stack([gt * 1.02, gt1 * 0.98]))
    ext0 = jnp.asarray(ext_gt + np.array([[0.0] * 6, [2e-3] * 6]))
    poses0 = jnp.asarray(poses_gt + 0.003)
    w = jnp.ones((C, F, N))
    lo = jnp.asarray(np.tile([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6], (C, 1)))
    hi = jnp.asarray(np.tile([1e4, 1e4, 512.0, 512.0, 1.0, 10.0], (C, 1)))
    free = jnp.ones((C, 6))
    cfv = jnp.ones((C, F))
    fv = jnp.ones(F)

    ref = ba_solve_multi(
        project_eucm, theta0, ext0, poses0, jnp.asarray(p3d), jnp.asarray(p2d),
        w, lo, hi, free, cfv, fv,
    )

    mesh = make_mesh()
    solve = make_multi_ba_solver(project_eucm, mesh)
    sh = sharded_frame_sharding(mesh)
    th, ex, po, cost, it = solve(
        theta0, ext0, jax.device_put(poses0, sh), jnp.asarray(p3d),
        jnp.asarray(p2d), w, lo, hi, free, cfv, jax.device_put(fv, sh),
    )
    np.testing.assert_allclose(np.asarray(th), np.asarray(ref.theta), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(ex), np.asarray(ref.ext), atol=1e-8)
    np.testing.assert_allclose(np.asarray(po), np.asarray(ref.poses), atol=1e-7)
    # and both recover the ground truth on this noiseless problem
    np.testing.assert_allclose(np.asarray(th[0]), gt, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(th[1]), gt1, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(ex[1]), ext_gt[1], atol=1e-7)


def test_full_sharded_solve_matches_single_device():
    from ccrs_jax.parallel.mesh import make_ba_solver, sharded_frame_sharding

    gt, p3d, poses_gt, p2d = _case(F=24, seed=2)
    mesh = make_mesh()
    solve = make_ba_solver(project_eucm, mesh)
    theta0 = jnp.asarray(gt * 1.03)
    lo = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6])
    hi = jnp.asarray([1e4, 1e4, 512.0, 512.0, 1.0, 10.0])
    free = jnp.ones(6)
    (p2d_p, w_p, poses0, fv), F = pad_frames(
        [
            jnp.asarray(p2d), jnp.ones(p2d.shape[:2]),
            jnp.asarray(poses_gt + 0.004), jnp.ones(p2d.shape[0]),
        ],
        len(jax.devices()),
    )
    sh = sharded_frame_sharding(mesh)
    th, po, cost, it = solve(
        theta0, jax.device_put(poses0, sh), jnp.asarray(p3d),
        jax.device_put(p2d_p, sh), jax.device_put(w_p, sh), lo, hi, free,
        jax.device_put(fv, sh),
    )
    ref = ba_solve(
        project_eucm, theta0, jnp.asarray(poses_gt + 0.004), jnp.asarray(p3d),
        jnp.asarray(p2d), jnp.ones(p2d.shape[:2]), lo, hi, free,
        jnp.ones(p2d.shape[0]),
    )
    # same solution (identical schedule => near-identical trajectories)
    np.testing.assert_allclose(np.asarray(th), np.asarray(ref.theta), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(po)[:F], np.asarray(ref.poses), atol=1e-8)
    np.testing.assert_allclose(np.asarray(th), gt, rtol=1e-8)


def test_sharded_mixed_matches_single_device_mixed():
    """multi_ba_sharded_mixed (the CLI's multi-device joint-BA route) ==
    ba_solve_multi_mixed, including the F-padding path (F=18 on 8 devs)."""
    from ccrs_jax.parallel.mesh import multi_ba_sharded_mixed
    from ccrs_jax.solve.lm import ba_solve_multi_mixed

    gt, p3d, poses_gt, p2d0 = _case(F=18, seed=5)
    C, F, N = 2, p2d0.shape[0], p2d0.shape[1]
    ext_gt = np.array([[0.0] * 6, [0.01, -0.02, 0.004, -0.1, 0.003, 0.001]])
    gt1 = gt * np.array([1.012, 1.003, 0.999, 1.001, 0.98, 1.01])
    p2d = np.zeros((C, F, N, 2))
    p2d[0] = p2d0
    for f in range(F):
        rv, tv = se3.compose(
            jnp.asarray(ext_gt[1, :3]), jnp.asarray(ext_gt[1, 3:]),
            jnp.asarray(poses_gt[f, :3]), jnp.asarray(poses_gt[f, 3:]),
        )
        pc = p3d @ np.asarray(se3.exp_so3(rv)).T + np.asarray(tv)
        p2d[1, f] = np.asarray(project_eucm(jnp.asarray(gt1), jnp.asarray(pc))[0])
    theta0 = jnp.asarray(np.stack([gt * 1.02, gt1 * 0.985]))
    ext0 = jnp.asarray(ext_gt + np.array([[0.0] * 6, [1e-3] * 6]))
    poses0 = jnp.asarray(poses_gt + 0.002)
    w = jnp.ones((C, F, N))
    lo = jnp.asarray(np.tile([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6], (C, 1)))
    hi = jnp.asarray(np.tile([1e4, 1e4, 512.0, 512.0, 1.0, 10.0], (C, 1)))
    free = jnp.ones((C, 6))
    cfv = jnp.ones((C, F))
    fv = jnp.ones(F)

    ref = ba_solve_multi_mixed(
        project_eucm, theta0, ext0, poses0, jnp.asarray(p3d), jnp.asarray(p2d),
        w, lo, hi, free, cfv, fv,
    )
    res = multi_ba_sharded_mixed(
        project_eucm, theta0, ext0, poses0, jnp.asarray(p3d), jnp.asarray(p2d),
        w, lo, hi, free, cfv, fv,
    )
    assert res.poses.shape == (F, 6)
    # both land on the same f64 optimum (noiseless problem: ground truth)
    np.testing.assert_allclose(np.asarray(res.theta), np.asarray(ref.theta), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.ext), np.asarray(ref.ext), atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.theta[0]), gt, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(res.theta[1]), gt1, rtol=1e-6)


def test_sharded_detect_matches_single_device():
    """detect_batch with the frame sharding (TagDetector(shard=True)) must
    produce EXACTLY the single-device detections — detection has no
    cross-frame reductions, so sharding may only change placement, never
    values (the CPU-mesh equality criterion)."""
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import TagDetector, get_family
    from ccrs_jax.models import GenericModel
    from ccrs_jax.testdata import render_board_image, smooth_sequence_poses

    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses = smooth_sequence_poses(16, board, seed=5)
    imgs = np.stack(
        [
            render_board_image(model, board, fam, p[:3], p[3:], noise=1.0, seed=f)
            for f, p in enumerate(poses)
        ]
    )
    # B=16 divides the 8-device mesh; run both the tracked and cold paths
    for track in (False, True):
        base = TagDetector("t36h11", track=track, shard=False).detect_batch(
            imgs, board=board
        )
        sh = TagDetector("t36h11", track=track, shard=True).detect_batch(
            imgs, board=board
        )
        assert len(base) == len(sh) == 16
        for f, (a, b) in enumerate(zip(base, sh)):
            assert set(a) == set(b), f"track={track} frame {f}"
            for tid in a:
                np.testing.assert_array_equal(
                    a[tid], b[tid], err_msg=f"track={track} frame {f} tag {tid}"
                )
