"""Interchange-precision gate: the production solver path must agree with
a pure-f64 reference solve to better than 1e-6 px RMS reprojection
(BASELINE.json: "RMS reproj matching Rust within 1e-6 px").

The production path (calib/single._calib_camera_device) runs the
mixed-precision two-stage BA (f32 bulk descent + f64 polish); the
reference here is the same Schur LM run entirely in f64 with the tight
rtol.  Both start from the same init, so agreement checks that the f32
stage hands the f64 polish a state inside the same basin AND that the
polish converges to the same optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ccrs_jax.models.projections import project_eucm
from ccrs_jax.solve import se3
from ccrs_jax.solve.lm import ba_solve, ba_solve_mixed


def _problem(F=40, N=144, noise=0.2, seed=3):
    rng = np.random.default_rng(seed)
    side = int(np.sqrt(N))
    p3d = np.zeros((side * side, 3))
    g = np.stack(
        np.meshgrid(np.linspace(0, 0.5, side), np.linspace(0, -0.5, side)), -1
    )
    p3d[:, :2] = g.reshape(-1, 2)
    gt = np.array([190.9, 190.87, 254.94, 256.86, 0.628, 1.046])
    poses, obs = [], []
    for _ in range(F):
        rv = rng.normal(size=3) * 0.25
        tv = np.array([-0.2, 0.25, 0.8]) + rng.normal(size=3) * 0.1
        pc = p3d @ np.asarray(se3.exp_so3(jnp.asarray(rv))).T + tv
        p2d, _ = project_eucm(jnp.asarray(gt), jnp.asarray(pc))
        poses.append(np.concatenate([rv, tv]))
        obs.append(np.asarray(p2d) + rng.normal(size=(N, 2)) * noise)
    theta0 = jnp.asarray(gt * (1 + rng.normal(size=6) * 0.02))
    poses0 = jnp.asarray(np.stack(poses) + rng.normal(size=(F, 6)) * 0.01)
    return (
        theta0,
        poses0,
        jnp.asarray(p3d),
        jnp.asarray(np.stack(obs)),
        jnp.ones((F, N)),
        jnp.asarray(gt),
    )


def _rms(theta, poses, p3d, p2d):
    def frame(pose, p2d_f):
        pc = se3.transform(pose[:3], pose[3:], p3d)
        proj, _ = project_eucm(theta, pc)
        return proj - p2d_f

    r = np.asarray(jax.vmap(frame)(poses, p2d))
    return float(np.sqrt((r**2).sum(-1).mean()))


@pytest.mark.parametrize("noise", [0.0, 0.2])
def test_mixed_precision_matches_f64(noise):
    theta0, poses0, p3d, p2d, w, gt = _problem(noise=noise)
    F = poses0.shape[0]
    lo = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6])
    hi = jnp.asarray([1e4, 1e4, 512.0, 512.0, 1.0, 10.0])
    free = jnp.ones(6)
    fv = jnp.ones(F)

    ref = ba_solve(
        project_eucm, theta0, poses0, p3d, p2d, w, lo, hi, free, fv,
        max_iters=100,
    )
    mix = ba_solve_mixed(
        project_eucm, theta0, poses0, p3d, p2d, w, lo, hi, free, fv,
    )

    rms_ref = _rms(ref.theta, ref.poses, p3d, p2d)
    rms_mix = _rms(mix.theta, mix.poses, p3d, p2d)
    # BASELINE.json target: RMS agreement within 1e-6 px
    assert abs(rms_ref - rms_mix) < 1e-6, (rms_ref, rms_mix)
    # parameters agree far tighter than the detector noise floor
    np.testing.assert_allclose(
        np.asarray(mix.theta), np.asarray(ref.theta), rtol=0, atol=5e-5
    )


def test_zero_noise_recovers_ground_truth():
    theta0, poses0, p3d, p2d, w, gt = _problem(noise=0.0)
    F = poses0.shape[0]
    lo = jnp.asarray([0.0, 0.0, 0.0, 0.0, 1e-6, 1e-6])
    hi = jnp.asarray([1e4, 1e4, 512.0, 512.0, 1.0, 10.0])
    mix = ba_solve_mixed(
        project_eucm, theta0, poses0, p3d, p2d, w, lo, hi,
        jnp.ones(6), jnp.ones(F),
    )
    assert _rms(mix.theta, mix.poses, p3d, p2d) < 1e-6
    np.testing.assert_allclose(np.asarray(mix.theta), np.asarray(gt), atol=1e-6)
