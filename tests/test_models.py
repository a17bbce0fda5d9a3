"""Camera model tests: project/unproject round trips, golden EUCM values,
JSON round trips, gradient safety."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccrs_jax.models import (
    MODEL_NAMES,
    N_PARAMS,
    GenericModel,
    model_from_json,
    project,
    unproject,
)

# plausible calibrated parameters per model (512x512 fisheye-ish)
PARAMS = {
    "ucm": [190.0, 190.5, 256.0, 255.5, 0.63],
    "eucm": [190.9, 190.87, 254.94, 256.86, 0.628, 1.046],
    "eucmt": [190.9, 190.87, 254.94, 256.86, 0.628, 1.046, 0.001, -0.0005],
    "kb4": [190.0, 190.2, 256.0, 255.0, 0.01, -0.005, 0.002, -0.0003],
    "opencv5": [450.0, 451.0, 320.0, 240.0, -0.28, 0.07, 0.0002, -0.0001, -0.01],
    "ftheta": [190.0, 190.2, 256.0, 255.0, 0.01, -0.004, 0.001, -0.0002, 0.00005],
}
WH = {"opencv5": (640, 480)}


def _rays(n=200, fov_deg=100.0, seed=0):
    rng = np.random.default_rng(seed)
    # points inside a cone of half-angle fov/2 around +z
    half = np.deg2rad(fov_deg) / 2
    theta = rng.uniform(0, half, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    d = np.stack(
        [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1
    )
    return d * rng.uniform(0.5, 5.0, (n, 1))


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_project_unproject_roundtrip(name):
    params = jnp.asarray(PARAMS[name], dtype=jnp.float64)
    fov = 60.0 if name == "opencv5" else 120.0
    p3d = jnp.asarray(_rays(fov_deg=fov), dtype=jnp.float64)
    p2d, vproj = project(name, params, p3d)
    ray, vunp = unproject(name, params, p2d)
    valid = np.asarray(vproj & vunp)
    assert valid.mean() > 0.95
    # compare directions via x/z (the downstream convention, util.rs:418-430)
    got = np.asarray(ray[..., :2] / ray[..., 2:3])
    want = np.asarray(p3d[..., :2] / p3d[..., 2:3])
    err = np.abs(got - want)[valid]
    assert err.max() < 1e-8, f"{name}: max dir err {err.max()}"


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_reproject_pixel_roundtrip(name):
    """unproject(project(x)) then project again lands on the same pixel."""
    params = jnp.asarray(PARAMS[name], dtype=jnp.float64)
    fov = 60.0 if name == "opencv5" else 120.0
    p3d = jnp.asarray(_rays(fov_deg=fov, seed=1), dtype=jnp.float64)
    p2d, v1 = project(name, params, p3d)
    ray, v2 = unproject(name, params, p2d)
    p2d2, v3 = project(name, params, ray)
    valid = np.asarray(v1 & v2 & v3)
    err = np.abs(np.asarray(p2d2 - p2d))[valid]
    assert err.max() < 1e-7


def test_eucm_golden_json():
    """Golden values from the reference's data/eucm.json (TUM-VI 512x512)."""
    blob = {
        "EUCM": {
            "fx": 190.89618687183938,
            "fy": 190.87022285882367,
            "cx": 254.9375370481962,
            "cy": 256.86414483060787,
            "alpha": 0.6283550447635853,
            "beta": 1.0458678747533083,
            "width": 512,
            "height": 512,
        }
    }
    m = GenericModel.from_json(blob)
    assert m.name == "eucm" and m.width == 512
    # center pixel unprojects to ~+z axis
    ray, v = m.unproject(np.array([[m.params[2], m.params[3]]]))
    assert v[0]
    np.testing.assert_allclose(ray[0, :2] / ray[0, 2], [0, 0], atol=1e-12)
    # project a known ray and back
    p2d, v = m.project(np.array([[0.1, -0.05, 1.0]]))
    assert v[0]
    ray, _ = m.unproject(p2d)
    np.testing.assert_allclose(ray[0, :2] / ray[0, 2], [0.1, -0.05], atol=1e-10)
    # JSON round-trip preserves everything
    m2 = GenericModel.from_json(m.to_json())
    np.testing.assert_array_equal(m.params, m2.params)


@pytest.mark.parametrize("name", MODEL_NAMES)
def test_jacobians_finite(name):
    """jacfwd through project must be NaN-free for valid points (the LM core
    relies on this; guards use the double-where trick)."""
    params = jnp.asarray(PARAMS[name], dtype=jnp.float64)
    p3d = jnp.asarray([[0.1, 0.2, 1.0], [0.0, 0.0, 2.0], [-0.4, 0.3, 0.8]], dtype=jnp.float64)

    def f(p):
        p2d, _ = project(name, p, p3d)
        return p2d

    J = jax.jacfwd(f)(params)
    assert np.isfinite(np.asarray(J)).all()

    def g(x):
        p2d, _ = project(name, params, x)
        return p2d

    Jx = jax.jacfwd(g)(p3d)
    assert np.isfinite(np.asarray(Jx)).all()


def test_invalid_projection_masked():
    # point far behind the camera is invalid for eucm with alpha>0.5
    params = jnp.asarray(PARAMS["eucm"], dtype=jnp.float64)
    _, valid = project("eucm", params, jnp.asarray([[0.0, 0.0, -1.0]]))
    assert not bool(valid[0])
    _, v_opencv = project("opencv5", jnp.asarray(PARAMS["opencv5"]), jnp.asarray([[0.0, 0.0, -1.0]]))
    assert not bool(v_opencv[0])


def test_model_param_validation():
    with pytest.raises(ValueError):
        GenericModel("eucm", [1, 2, 3], 512, 512)
    with pytest.raises(ValueError):
        GenericModel("nope", [1, 2, 3, 4, 5], 512, 512)


def test_json_file_roundtrip(tmp_path):
    from ccrs_jax.models import model_to_json

    m = GenericModel("kb4", PARAMS["kb4"], 640, 512)
    p = tmp_path / "kb4.json"
    model_to_json(str(p), m)
    blob = json.loads(p.read_text())
    assert "KannalaBrandt4" in blob
    m2 = model_from_json(str(p))
    assert m2.name == "kb4"
    np.testing.assert_array_equal(m.params, m2.params)
