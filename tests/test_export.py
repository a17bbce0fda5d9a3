"""Kalibr camchain export tests (incl. the UCM->omni algebraic identity)."""

import numpy as np
import pytest
import yaml

from ccrs_jax.export import write_camchain
from ccrs_jax.models import GenericModel
from ccrs_jax.types import RvecTvec


def test_camchain_eucm_stereo(tmp_path):
    cams = [
        GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512),
        GenericModel("eucm", [191.2, 191.0, 255.0, 255.5, 0.63, 1.04], 512, 512),
    ]
    t10 = RvecTvec([0.01, -0.02, 0.0], [-0.11, 0.0, 0.0])
    p = tmp_path / "camchain.yaml"
    write_camchain(str(p), cams, [RvecTvec.identity(), t10])
    chain = yaml.safe_load(p.read_text())
    assert set(chain) == {"cam0", "cam1"}
    assert chain["cam0"]["camera_model"] == "eucm"
    assert chain["cam0"]["resolution"] == [512, 512]
    assert len(chain["cam0"]["intrinsics"]) == 6
    T = np.array(chain["cam1"]["T_cn_cnm1"])
    np.testing.assert_allclose(T, t10.to_matrix(), atol=1e-12)
    assert "T_cn_cnm1" not in chain["cam0"]


def test_camchain_ucm_omni_identity(tmp_path):
    """The omni(xi) mapping must reproduce UCM projections exactly."""
    ucm = GenericModel("ucm", [400.0, 401.0, 320.0, 240.0, 0.55], 640, 480)
    p = tmp_path / "c.yaml"
    write_camchain(str(p), [ucm])
    chain = yaml.safe_load(p.read_text())
    xi, fx, fy, cx, cy = chain["cam0"]["intrinsics"]
    # omni model: project((x,y,z)) = f * m / (z + xi*|X|) + c
    pts = np.random.default_rng(0).normal(size=(50, 3)) * [0.3, 0.3, 0] + [0, 0, 1.5]
    ours, valid = ucm.project(pts)
    d = np.linalg.norm(pts, axis=1)
    u = fx * pts[:, 0] / (pts[:, 2] + xi * d) + cx
    v = fy * pts[:, 1] / (pts[:, 2] + xi * d) + cy
    np.testing.assert_allclose(ours[valid], np.stack([u, v], 1)[valid], atol=1e-9)


def test_camchain_kb4_and_opencv5(tmp_path):
    kb4 = GenericModel("kb4", [300, 300, 320, 240, 0.01, -0.002, 0.0, 0.0], 640, 480)
    cv5 = GenericModel("opencv5", [300, 300, 320, 240, -0.2, 0.05, 0.001, -0.001, 0.0], 640, 480)
    p = tmp_path / "c.yaml"
    write_camchain(str(p), [kb4, cv5], [RvecTvec.identity(), RvecTvec.identity()])
    chain = yaml.safe_load(p.read_text())
    assert chain["cam0"]["distortion_model"] == "equidistant"
    assert chain["cam1"]["distortion_model"] == "radtan"
    assert len(chain["cam1"]["distortion_coeffs"]) == 4


def test_camchain_unsupported_model(tmp_path):
    ft = GenericModel("ftheta", [300, 300, 320, 240, 0, 0, 0, 0, 0], 640, 480)
    with pytest.raises(ValueError):
        write_camchain(str(tmp_path / "c.yaml"), [ft])
