"""Planar PnP tests, mirroring the reference's ``test_init_pose``
(tests/optimization_test.rs:83-154) plus randomized pose recovery."""

import jax.numpy as jnp
import numpy as np

from ccrs_jax.solve import se3
from ccrs_jax.solve.pnp import solve_pnp_planar, solve_pnp_planar_batch


def test_identity_pose_four_points():
    # world points on z=0 plane, camera at t=(0,0,5) looking down +z
    p3d = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], dtype=np.float64)
    z = 5.0
    obs = (p3d[:, :2] + 0) / (p3d[:, 2] + z)[:, None]
    rvec, tvec = solve_pnp_planar(jnp.asarray(p3d), jnp.asarray(obs))
    np.testing.assert_allclose(np.asarray(rvec), 0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(tvec), [0, 0, z], atol=1e-8)


def _random_case(rng, n=40, noise=0.0):
    p3d = np.zeros((n, 3))
    p3d[:, :2] = rng.uniform(0, 0.5, (n, 2))
    rvec = rng.normal(size=3) * 0.3
    tvec = np.array([0.1, -0.2, 0.8]) + rng.normal(size=3) * 0.05
    R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
    pc = p3d @ R.T + tvec
    obs = pc[:, :2] / pc[:, 2:3] + rng.normal(size=(n, 2)) * noise
    return p3d, obs, rvec, tvec


def test_random_pose_recovery():
    rng = np.random.default_rng(3)
    for _ in range(10):
        p3d, obs, rvec, tvec = _random_case(rng)
        r, t = solve_pnp_planar(jnp.asarray(p3d), jnp.asarray(obs))
        np.testing.assert_allclose(np.asarray(r), rvec, atol=1e-7)
        np.testing.assert_allclose(np.asarray(t), tvec, atol=1e-7)


def test_masked_points_ignored():
    rng = np.random.default_rng(4)
    p3d, obs, rvec, tvec = _random_case(rng, n=60)
    # corrupt 20 points but mask them out
    obs2 = obs.copy()
    obs2[40:] += 5.0
    w = np.ones(60)
    w[40:] = 0.0
    r, t = solve_pnp_planar(jnp.asarray(p3d), jnp.asarray(obs2), jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(r), rvec, atol=1e-7)
    np.testing.assert_allclose(np.asarray(t), tvec, atol=1e-7)


def test_batched_frames():
    rng = np.random.default_rng(5)
    cases = [_random_case(rng) for _ in range(6)]
    p3d = jnp.asarray(np.stack([c[0] for c in cases]))
    obs = jnp.asarray(np.stack([c[1] for c in cases]))
    w = jnp.ones(p3d.shape[:2])
    r, t = solve_pnp_planar_batch(p3d, obs, w)
    for i, (_, _, rvec, tvec) in enumerate(cases):
        np.testing.assert_allclose(np.asarray(r[i]), rvec, atol=1e-7)
        np.testing.assert_allclose(np.asarray(t[i]), tvec, atol=1e-7)


def test_smallest_eigvec_matches_eigh():
    """Cholesky inverse iteration == eigh's smallest eigenvector (up to
    sign) across random PSD spectra, including a near-null direction."""
    from ccrs_jax.solve.pnp import _smallest_eigvec

    rng = np.random.default_rng(11)
    for k in range(20):
        lam = np.sort(rng.uniform(0.1, 10.0, 9))
        lam[0] = rng.uniform(0, 1e-8)  # DLT-like near-null direction
        Q, _ = np.linalg.qr(rng.normal(size=(9, 9)))
        S = (Q * lam) @ Q.T
        v = np.asarray(_smallest_eigvec(jnp.asarray(S)))
        w, V = np.linalg.eigh(S)
        align = abs(float(v @ V[:, 0]))
        assert align > 1.0 - 1e-9, (k, align)


def test_project_so3_matches_svd():
    """Newton polar iteration == SVD projection onto SO(3) for
    near-rotation inputs (the Zhang-decomposition regime)."""
    from ccrs_jax.solve.pnp import _project_so3

    rng = np.random.default_rng(12)
    for k in range(20):
        a = rng.normal(size=3)
        th = np.linalg.norm(a)
        w = a / max(th, 1e-9)
        Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + np.sin(th) * Wx + (1 - np.cos(th)) * (Wx @ Wx)
        Q = R + rng.normal(size=(3, 3)) * 0.05  # perturbed near-rotation
        if np.linalg.det(Q) <= 0:
            continue
        got = np.asarray(_project_so3(jnp.asarray(Q)))
        U, _, Vt = np.linalg.svd(Q)
        D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
        want = U @ D @ Vt
        np.testing.assert_allclose(got, want, atol=1e-10)
        np.testing.assert_allclose(got.T @ got, np.eye(3), atol=1e-12)
