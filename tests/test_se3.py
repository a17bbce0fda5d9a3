"""SE(3)/SO(3) primitive tests."""

import jax
import jax.numpy as jnp
import numpy as np

from ccrs_jax.solve import se3


def test_exp_log_roundtrip():
    rng = np.random.default_rng(1)
    r = rng.normal(size=(100, 3))
    r = r / np.linalg.norm(r, axis=-1, keepdims=True) * rng.uniform(1e-8, np.pi - 1e-4, (100, 1))
    R = se3.exp_so3(jnp.asarray(r))
    back = np.asarray(se3.log_so3(R))
    np.testing.assert_allclose(back, r, atol=1e-9)


def test_exp_log_near_pi():
    r = np.array([[np.pi - 1e-8, 0, 0], [0, np.pi - 1e-8, 0]])
    R = se3.exp_so3(jnp.asarray(r))
    back = np.asarray(se3.log_so3(R))
    np.testing.assert_allclose(back, r, atol=1e-6)


def test_exp_at_zero_grad_finite():
    J = jax.jacfwd(se3.exp_so3)(jnp.zeros(3))
    assert np.isfinite(np.asarray(J)).all()
    # d(exp)/dw at 0 is the generator: exp(w) ~ I + hat(w)
    Jh = jax.jacfwd(lambda w: se3.exp_so3(w))(jnp.zeros(3))
    np.testing.assert_allclose(
        np.asarray(Jh[..., 0]), np.asarray(se3.hat(jnp.asarray([1.0, 0, 0]))), atol=1e-12
    )


def test_compose_inverse_transform():
    ra, ta = jnp.asarray([0.2, -0.3, 0.1]), jnp.asarray([1.0, 2.0, 3.0])
    ri, ti = se3.inverse(ra, ta)
    rc, tc = se3.compose(ra, ta, ri, ti)
    np.testing.assert_allclose(np.asarray(rc), 0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(tc), 0, atol=1e-12)

    pts = jnp.asarray(np.random.default_rng(2).normal(size=(5, 3)))
    fwd = se3.transform(ra, ta, pts)
    back = se3.transform(ri, ti, fwd)
    np.testing.assert_allclose(np.asarray(back), np.asarray(pts), atol=1e-12)


def test_matches_host_rodrigues():
    from ccrs_jax.types import rodrigues

    r = np.array([0.4, -0.1, 0.25])
    np.testing.assert_allclose(
        np.asarray(se3.exp_so3(jnp.asarray(r))), rodrigues(r), atol=1e-14
    )
