"""Radial-distortion homography + focal recovery tests (mirrors
tests/optimization_test.rs:12-33 and exercises the batched RANSAC)."""

import jax
import jax.numpy as jnp
import numpy as np

from ccrs_jax.solve import se3
from ccrs_jax.solve.homography import (
    homography_to_focal,
    radial_distortion_homography,
)


def test_homography_to_focal_rotation():
    """H = K R K^-1 must yield f (reference test: f=1000 within 10)."""
    f = 1000.0
    K = np.diag([f, f, 1.0])
    axis = np.array([1.0, 1.0, 0.5])
    axis = axis / np.linalg.norm(axis)
    R = np.asarray(se3.exp_so3(jnp.asarray(axis * 0.2)))
    H = K @ R @ np.linalg.inv(K)
    fhat, ok = homography_to_focal(jnp.asarray(H))
    assert bool(ok)
    assert abs(float(fhat) - f) < 10.0


def _distort_division(q, lam):
    """Apply division-model distortion: find p_d with p_u = p_d/(1+lam r_d^2)."""
    ru = np.linalg.norm(q, axis=-1)
    # solve lam*ru*rd^2 - rd + ru = 0 for rd (root -> ru as lam -> 0)
    disc = 1.0 - 4.0 * lam * ru * ru
    rd = np.where(
        np.abs(lam * ru) < 1e-12, ru, (1.0 - np.sqrt(np.maximum(disc, 0))) / (2.0 * lam * ru + 1e-300)
    )
    return q * (rd / np.maximum(ru, 1e-12))[..., None]


def _two_view_case(lam=-0.25, f_unit=0.9, seed=0):
    rng = np.random.default_rng(seed)
    n = 12 * 12
    p3d = np.zeros((n, 3))
    g = np.stack(np.meshgrid(np.linspace(0, 0.5, 12), np.linspace(0, 0.5, 12)), -1)
    p3d[:, :2] = g.reshape(-1, 2)

    views = []
    for rvec, tvec in [
        (np.array([0.15, -0.1, 0.05]), np.array([-0.25, -0.2, 0.7])),
        (np.array([-0.2, 0.25, -0.1]), np.array([-0.3, -0.25, 0.9])),
    ]:
        R = np.asarray(se3.exp_so3(jnp.asarray(rvec)))
        pc = p3d @ R.T + tvec
        q = f_unit * pc[:, :2] / pc[:, 2:3]  # undistorted normalized pixels
        views.append(_distort_division(q, lam))
    return p3d, views


def test_radial_ransac_recovers_lambda():
    lam_true = -0.25
    _, (p0, p1) = _two_view_case(lam=lam_true)
    mask = jnp.ones(p0.shape[0], dtype=bool)
    key = jax.random.PRNGKey(0)
    lam, H, score = radial_distortion_homography(
        key, jnp.asarray(p0), jnp.asarray(p1), mask, n_samples=200
    )
    assert float(score) < 1e-6, f"score {float(score)}"
    assert abs(float(lam) - lam_true) < 1e-3, f"lambda {float(lam)}"


def test_radial_ransac_with_outliers_and_mask():
    lam_true = -0.18
    _, (p0, p1) = _two_view_case(lam=lam_true, seed=1)
    p0 = p0.copy()
    p1 = p1.copy()
    # 15 gross outliers
    rng = np.random.default_rng(7)
    bad = rng.choice(p0.shape[0], 15, replace=False)
    p1[bad] += rng.normal(size=(15, 2)) * 0.5
    mask = np.ones(p0.shape[0], dtype=bool)
    # also mask out some pairs entirely (simulate partial board views)
    mask[:20] = False
    key = jax.random.PRNGKey(42)
    lam, H, score = radial_distortion_homography(
        key, jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask), n_samples=500
    )
    # outliers inflate the mean transfer score but lambda should be close
    assert abs(float(lam) - lam_true) < 0.05, f"lambda {float(lam)}"


def test_focal_from_rotation_pair_exact():
    """Two views sharing a camera center: H is rotation-induced, so
    homography_to_focal must recover f accurately."""
    f_unit = 0.9
    n = 12 * 12
    p3d = np.zeros((n, 3))
    g = np.stack(np.meshgrid(np.linspace(0, 0.5, 12), np.linspace(0, 0.5, 12)), -1)
    p3d[:, :2] = g.reshape(-1, 2)
    R0 = np.asarray(se3.exp_so3(jnp.asarray([0.1, -0.05, 0.02])))
    t0 = np.array([-0.25, -0.2, 0.7])
    Rrel = np.asarray(se3.exp_so3(jnp.asarray([0.15, 0.2, -0.1])))
    views = []
    for R, t in [(R0, t0), (Rrel @ R0, Rrel @ t0)]:
        pc = p3d @ R.T + t
        views.append(f_unit * pc[:, :2] / pc[:, 2:3])
    p0, p1 = views
    mask = jnp.ones(n, dtype=bool)
    lam, H, score = radial_distortion_homography(
        jax.random.PRNGKey(3), jnp.asarray(p0), jnp.asarray(p1), mask, n_samples=300
    )
    assert float(score) < 1e-6
    fhat, ok = homography_to_focal(H)
    assert bool(ok)
    assert abs(float(fhat) - f_unit) / f_unit < 0.05, f"f {float(fhat)}"


def test_focal_from_general_planar_homography_is_rough_init():
    """For a general (translating) two-view planar H the focal is only a
    rough init; the pipeline bounds it to [f/3, 3f] (src/util.rs:345), so
    assert it lands within that window."""
    f_unit = 0.9
    _, (p0, p1) = _two_view_case(lam=-1e-9, f_unit=f_unit, seed=2)
    mask = jnp.ones(p0.shape[0], dtype=bool)
    lam, H, score = radial_distortion_homography(
        jax.random.PRNGKey(3), jnp.asarray(p0), jnp.asarray(p1), mask, n_samples=300
    )
    fhat, ok = homography_to_focal(H)
    assert bool(ok)
    assert f_unit / 3 < float(fhat) < f_unit * 3, f"f {float(fhat)}"


def test_focal_traced_matches_host():
    """homography_to_focal_traced (used inside the fused init graph) must
    agree with the host closed form on random homographies, including the
    degenerate-selection branches."""
    from ccrs_jax.solve.homography import homography_to_focal_traced

    rng = np.random.default_rng(7)
    for k in range(200):
        if k % 3 == 0:
            # realistic K R K^-1 homographies
            f = rng.uniform(100, 2000)
            K = np.diag([f, f, 1.0])
            a = rng.normal(size=3) * 0.4
            th = np.linalg.norm(a)
            w = a / max(th, 1e-9)
            Wx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            R = np.eye(3) + np.sin(th) * Wx + (1 - np.cos(th)) * (Wx @ Wx)
            H = K @ R @ np.linalg.inv(K)
        else:
            H = rng.normal(size=(3, 3))
        f_host, ok_host = homography_to_focal(jnp.asarray(H))
        f_tr, ok_tr = homography_to_focal_traced(jnp.asarray(H))
        assert bool(ok_tr) == bool(ok_host), H
        if ok_host:
            np.testing.assert_allclose(float(f_tr), f_host, rtol=1e-10)
