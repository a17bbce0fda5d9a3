"""RvecTvec round-trip tests, mirroring ``tests/types_test.rs:5-20``."""

import numpy as np

from ccrs_jax.types import RvecTvec, rodrigues, rotation_to_rvec


def test_rvec_tvec_conversion():
    rt = RvecTvec([0.1, 0.2, 0.3], [1.0, 2.0, 3.0])
    T = rt.to_matrix()
    back = RvecTvec.from_matrix(T)
    assert np.linalg.norm(back.rvec - rt.rvec) < 1e-6
    assert np.linalg.norm(back.tvec - rt.tvec) < 1e-6


def test_rodrigues_roundtrip_random():
    rng = np.random.default_rng(0)
    for _ in range(50):
        r = rng.normal(size=3)
        r = r / np.linalg.norm(r) * rng.uniform(0, np.pi - 1e-3)
        R = rodrigues(r)
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert np.allclose(rotation_to_rvec(R), r, atol=1e-9)


def test_inverse_compose():
    rt = RvecTvec([0.3, -0.2, 0.5], [0.1, 0.4, -1.0])
    ident = rt.compose(rt.inverse())
    assert np.linalg.norm(ident.rvec) < 1e-10
    assert np.linalg.norm(ident.tvec) < 1e-10


def test_json_roundtrip():
    rt = RvecTvec([0.1, 0.2, 0.3], [1, 2, 3])
    rt2 = RvecTvec.from_json(rt.to_json())
    assert np.allclose(rt2.rvec, rt.rvec) and np.allclose(rt2.tvec, rt.tvec)
