"""LM core tests: dense solver and Schur-structured BA on synthetic ground
truth (the forward-model -> residual ~= 0 pattern of the reference's tests,
SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np

from ccrs_jax.models.projections import project_eucm, project_ucm
from ccrs_jax.solve import se3
from ccrs_jax.solve.lm import LMOptions, ba_solve, lm_solve, reduce_params


def test_lm_dense_curve_fit_with_bounds_and_fixed():
    """Fit y = a*exp(-b t) + c with c fixed at truth and b bounded."""
    rng = np.random.default_rng(0)
    t = jnp.asarray(np.linspace(0, 2, 50))
    a_t, b_t, c_t = 2.0, 1.3, 0.5
    y = a_t * jnp.exp(-b_t * t) + c_t

    def resid(x):
        pred = x[0] * jnp.exp(-x[1] * t) + x[2]
        return (pred - y)[:, None], jnp.ones_like(t)

    x0 = jnp.asarray([1.0, 0.5, c_t])
    lo = jnp.asarray([-10.0, 0.0, -10.0])
    hi = jnp.asarray([10.0, 5.0, 10.0])
    free = jnp.asarray([1.0, 1.0, 0.0])
    x, cost, it = lm_solve(resid, x0, lo=lo, hi=hi, free=free)
    np.testing.assert_allclose(np.asarray(x), [a_t, b_t, c_t], atol=1e-8)
    assert float(cost) < 1e-16


def test_lm_dense_huber_outliers():
    rng = np.random.default_rng(1)
    t = np.linspace(0, 1, 80)
    y = 3.0 * t + 1.0
    y_noisy = y.copy()
    y_noisy[::7] += 50.0  # gross outliers

    tj, yj = jnp.asarray(t), jnp.asarray(y_noisy)

    def resid(x):
        return (x[0] * tj + x[1] - yj)[:, None], jnp.ones_like(tj)

    x, cost, it = lm_solve(
        resid, jnp.asarray([0.0, 0.0]), opts=LMOptions(huber_delta=0.5)
    )
    # Huber keeps the fit near the inlier line
    np.testing.assert_allclose(np.asarray(x), [3.0, 1.0], atol=0.15)


def _make_board(n_side=12):
    p3d = np.zeros((n_side * n_side, 3))
    g = np.stack(
        np.meshgrid(np.linspace(0, 0.5, n_side), np.linspace(0, -0.5, n_side)), -1
    )
    p3d[:, :2] = g.reshape(-1, 2)
    return p3d


def _make_ba_case(params_gt, project, F=8, seed=0, px_noise=0.0):
    rng = np.random.default_rng(seed)
    p3d = _make_board()
    N = p3d.shape[0]
    poses = []
    obs = []
    for f in range(F):
        rvec = rng.normal(size=3) * 0.25
        tvec = np.array([-0.2, 0.25, 0.9]) + rng.normal(size=3) * 0.1
        R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
        pc = p3d @ R.T + tvec
        p2d, valid = project(jnp.asarray(params_gt), jnp.asarray(pc))
        p2d = np.asarray(p2d) + rng.normal(size=(N, 2)) * px_noise
        poses.append(np.concatenate([rvec, tvec]))
        obs.append(p2d)
    return p3d, np.stack(poses), np.stack(obs)


def test_ba_recovers_eucm_groundtruth():
    params_gt = np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
    p3d, poses_gt, p2d = _make_ba_case(params_gt, project_eucm, F=8)
    F, N = p2d.shape[:2]
    rng = np.random.default_rng(2)
    theta0 = jnp.asarray(params_gt * (1 + rng.normal(size=6) * 0.03))
    poses0 = jnp.asarray(poses_gt + rng.normal(size=(F, 6)) * 0.01)
    lo = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6])
    hi = jnp.asarray([1e4, 1e4, 512.0, 512.0, 1.0, 10.0])
    free = jnp.ones(6)
    res = ba_solve(
        project_eucm,
        theta0,
        poses0,
        jnp.asarray(p3d),
        jnp.asarray(p2d),
        jnp.ones((F, N)),
        lo,
        hi,
        free,
        jnp.ones(F),
    )
    np.testing.assert_allclose(np.asarray(res.theta), params_gt, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(res.poses), poses_gt, atol=1e-6)
    assert float(res.cost) < 1e-12


def test_ba_one_focal_and_masks():
    params_gt = np.array([200.0, 200.0, 256.0, 255.0, 0.6])  # ucm, fx=fy
    p3d, poses_gt, p2d = _make_ba_case(params_gt, project_ucm, F=6, seed=3)
    F, N = p2d.shape[:2]
    # mask out 30% of observations + corrupt them
    rng = np.random.default_rng(4)
    w = (rng.uniform(size=(F, N)) > 0.3).astype(float)
    p2d = p2d + (1 - w[..., None]) * 1000.0
    # drop frame 0 entirely
    frame_valid = np.ones(F)
    frame_valid[0] = 0.0
    theta_gt = reduce_params(jnp.asarray(params_gt), True)  # (4,)
    theta0 = theta_gt * (1 + 0.02 * jnp.asarray(rng.normal(size=4)))
    poses0 = jnp.asarray(poses_gt + rng.normal(size=(F, 6)) * 0.005)
    lo = jnp.asarray([0.0, 0.0, 0.0, 1e-6])
    hi = jnp.asarray([1e4, 512.0, 512.0, 1.0])
    res = ba_solve(
        project_ucm,
        theta0,
        poses0,
        jnp.asarray(p3d),
        jnp.asarray(p2d),
        jnp.asarray(w),
        lo,
        hi,
        jnp.ones(4),
        jnp.asarray(frame_valid),
        one_focal=True,
    )
    np.testing.assert_allclose(np.asarray(res.theta), np.asarray(theta_gt), rtol=1e-7)
    # dropped frame pose untouched
    np.testing.assert_allclose(np.asarray(res.poses[0]), poses0[0], atol=1e-12)
    # other poses recovered
    np.testing.assert_allclose(np.asarray(res.poses[1:]), poses_gt[1:], atol=1e-6)


def test_ba_fixed_focal():
    """free-mask zero on fx keeps it exactly at init (fix_variable parity,
    src/util.rs:459-464)."""
    params_gt = np.array([200.0, 200.0, 256.0, 255.0, 0.6])
    p3d, poses_gt, p2d = _make_ba_case(params_gt, project_ucm, F=4, seed=5)
    F, N = p2d.shape[:2]
    theta_gt = reduce_params(jnp.asarray(params_gt), True)
    theta0 = theta_gt.at[1:].mul(1.01)  # fx at truth, rest perturbed
    res = ba_solve(
        project_ucm,
        theta0,
        jnp.asarray(poses_gt),
        jnp.asarray(p3d),
        jnp.asarray(p2d),
        jnp.ones((F, N)),
        jnp.asarray([0.0, 0.0, 0.0, 1e-6]),
        jnp.asarray([1e4, 512.0, 512.0, 1.0]),
        jnp.asarray([0.0, 1.0, 1.0, 1.0]),
        jnp.ones(F),
        one_focal=True,
    )
    assert float(res.theta[0]) == float(theta0[0])
    np.testing.assert_allclose(np.asarray(res.theta), np.asarray(theta_gt), rtol=1e-7)


def test_ba_f32_jacobian_polish_fixed_point():
    """jac_f32=True (f32 Jacobians, f64 residual/cost) must land on the
    same optimum as the full-f64 solve: params within ~1e-7 relative, RMS
    within 1e-9 px (second-order in the Jacobian error) — the property
    the mixed-precision polish default relies on.  Noisy observations so
    the optimum has a genuine nonzero residual (a noiseless problem would
    pass trivially with any J)."""
    params_gt = np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
    p3d, poses_gt, p2d = _make_ba_case(params_gt, project_eucm, F=8)
    rng = np.random.default_rng(5)
    p2d = p2d + rng.normal(size=p2d.shape) * 0.1  # 0.1 px noise floor
    F, N = p2d.shape[:2]
    theta0 = jnp.asarray(params_gt * (1 + rng.normal(size=6) * 0.03))
    poses0 = jnp.asarray(poses_gt + rng.normal(size=(F, 6)) * 0.01)
    lo = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6])
    hi = jnp.asarray([1e4, 1e4, 512.0, 512.0, 1.0, 10.0])
    args = (
        jnp.asarray(p3d), jnp.asarray(p2d), jnp.ones((F, N)),
        lo, hi, jnp.ones(6), jnp.ones(F),
    )
    r64 = ba_solve(project_eucm, theta0, poses0, *args)
    r32 = ba_solve(project_eucm, theta0, poses0, *args, jac_f32=True)
    np.testing.assert_allclose(
        np.asarray(r32.theta), np.asarray(r64.theta), rtol=5e-7
    )

    def rms(theta, poses):
        proj = jax.vmap(
            lambda po: project_eucm(
                theta, se3.transform(po[:3], po[3:], jnp.asarray(p3d))
            )[0]
        )(poses)
        d = np.linalg.norm(np.asarray(proj) - p2d, axis=-1)
        return float(np.sqrt(np.mean(d**2)))

    assert abs(rms(r64.theta, r64.poses) - rms(r32.theta, r32.poses)) < 1e-9
