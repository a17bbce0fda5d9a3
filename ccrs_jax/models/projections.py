"""Pure-JAX camera model projections.

Batched replacement for the reference's `camera-intrinsic-model` crate
(used surface cited in /root/repo/SURVEY.md §2.2: ``project``/``project_one``,
``unproject`` with per-point Option semantics, params packing/bounds).  The
six models:

===========  =========================================  ==========
name         params                                     n_params
===========  =========================================  ==========
ucm          fx fy cx cy alpha                          5
eucm         fx fy cx cy alpha beta                     6
eucmt        fx fy cx cy alpha beta t1 t2               8
kb4          fx fy cx cy k1 k2 k3 k4                    8
opencv5      fx fy cx cy k1 k2 p1 p2 k3                 9
ftheta       fx fy cx cy k1 k2 k3 k4 k5                 9
===========  =========================================  ==========

Conventions (matching the published UCM/EUCM formulations used by the
reference crate — Usenko et al., "The Double Sphere Camera Model", 3DV'18):

- ``project(params, p3d) -> (p2d, valid)``: p3d is ``(..., 3)`` in camera
  frame, p2d is ``(..., 2)`` pixels.  ``valid`` is the Option mask of the
  reference (``src/util.rs:418-430`` filters unprojectable points;
  ``src/optimization/factors.rs:64-72`` penalizes invalid projections).
- ``unproject(params, p2d) -> (p3d, valid)``: returns a 3D ray (arbitrary
  scale, z>0 normalized so downstream uses x/z like the reference does).
- All functions are dtype-polymorphic (f32 image paths / f64 solver paths)
  and gradient-safe: every division/sqrt is guarded with the double-where
  trick so ``jax.jacfwd`` never sees NaNs from the inactive branch.

Rotations/iterative inversions use fixed iteration counts (XLA-friendly;
unprojection feeds initialization only — reference ``src/util.rs:418`` — so
a few extra Newton steps cost nothing and keep shapes static).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "MODEL_NAMES",
    "N_PARAMS",
    "project",
    "unproject",
    "project_fn",
    "unproject_fn",
]

MODEL_NAMES = ("ucm", "eucm", "eucmt", "kb4", "opencv5", "ftheta")
N_PARAMS = {
    "ucm": 5,
    "eucm": 6,
    "eucmt": 8,
    "kb4": 8,
    "opencv5": 9,
    "ftheta": 9,
}

_EPS = 1e-12


def _safe_div(num, den, eps=_EPS):
    """num/den with gradient-safe guard; caller masks invalid outputs."""
    safe = jnp.where(jnp.abs(den) > eps, den, jnp.where(den >= 0, eps, -eps))
    return num / safe


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


# ---------------------------------------------------------------- UCM / EUCM


def _eucm_core(fx, fy, cx, cy, alpha, beta, p3d):
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    d = _safe_sqrt(beta * (x * x + y * y) + z * z)
    denom = alpha * d + (1.0 - alpha) * z
    # valid projection region: z > -w*d  (DS paper eq. (22)-(23))
    w = jnp.where(alpha <= 0.5, _safe_div(alpha, 1.0 - alpha), _safe_div(1.0 - alpha, alpha))
    valid = (z > -w * d) & (denom > _EPS)
    mx = _safe_div(x, denom)
    my = _safe_div(y, denom)
    u = fx * mx + cx
    v = fy * my + cy
    return jnp.stack([u, v], axis=-1), valid, (mx, my)


def project_ucm(params, p3d):
    fx, fy, cx, cy, alpha = (params[..., i] for i in range(5))
    p2d, valid, _ = _eucm_core(fx, fy, cx, cy, alpha, jnp.ones_like(alpha), p3d)
    return p2d, valid


def project_eucm(params, p3d):
    fx, fy, cx, cy, alpha, beta = (params[..., i] for i in range(6))
    p2d, valid, _ = _eucm_core(fx, fy, cx, cy, alpha, beta, p3d)
    return p2d, valid


def project_eucmt(params, p3d):
    fx, fy, cx, cy, alpha, beta, t1, t2 = (params[..., i] for i in range(8))
    _, valid, (mx, my) = _eucm_core(fx, fy, cx, cy, alpha, beta, p3d)
    r2 = mx * mx + my * my
    mxp = mx + 2.0 * t1 * mx * my + t2 * (r2 + 2.0 * mx * mx)
    myp = my + t1 * (r2 + 2.0 * my * my) + 2.0 * t2 * mx * my
    u = fx * mxp + cx
    v = fy * myp + cy
    return jnp.stack([u, v], axis=-1), valid


def _eucm_unproject_core(alpha, beta, mx, my):
    r2 = mx * mx + my * my
    gamma = 1.0 - alpha
    inner = 1.0 - (2.0 * alpha - 1.0) * beta * r2
    mz = _safe_div(1.0 - beta * alpha * alpha * r2, alpha * _safe_sqrt(inner) + gamma)
    valid = jnp.where(alpha > 0.5, inner >= 0.0, jnp.ones_like(inner, dtype=bool))
    return mz, valid


def unproject_ucm(params, p2d):
    fx, fy, cx, cy, alpha = (params[..., i] for i in range(5))
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    mz, valid = _eucm_unproject_core(alpha, jnp.ones_like(alpha), mx, my)
    return jnp.stack([mx, my, mz], axis=-1), valid & (mz > _EPS)


def unproject_eucm(params, p2d):
    fx, fy, cx, cy, alpha, beta = (params[..., i] for i in range(6))
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    mz, valid = _eucm_unproject_core(alpha, beta, mx, my)
    return jnp.stack([mx, my, mz], axis=-1), valid & (mz > _EPS)


def unproject_eucmt(params, p2d):
    fx, fy, cx, cy, alpha, beta, t1, t2 = (params[..., i] for i in range(8))
    mxd = _safe_div(p2d[..., 0] - cx, fx)
    myd = _safe_div(p2d[..., 1] - cy, fy)
    # invert the tangential warp by fixed-point iteration (contractive for
    # calibration-magnitude t1/t2)
    mx, my = mxd, myd
    for _ in range(8):
        r2 = mx * mx + my * my
        dx = 2.0 * t1 * mx * my + t2 * (r2 + 2.0 * mx * mx)
        dy = t1 * (r2 + 2.0 * my * my) + 2.0 * t2 * mx * my
        mx = mxd - dx
        my = myd - dy
    mz, valid = _eucm_unproject_core(alpha, beta, mx, my)
    return jnp.stack([mx, my, mz], axis=-1), valid & (mz > _EPS)


# ----------------------------------------------------------------------- KB4


def _theta_poly(theta, ks):
    """theta * (1 + k1 th^2 + k2 th^4 + ...) via Horner on theta^2."""
    th2 = theta * theta
    acc = jnp.zeros_like(theta)
    for k in ks[::-1]:
        acc = (acc + k) * th2
    return theta * (1.0 + acc)


def project_kb4(params, p3d):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    ks = [params[..., 4 + i] for i in range(4)]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r = _safe_sqrt(x * x + y * y)
    theta = jnp.arctan2(r, z)
    theta_d = _theta_poly(theta, ks)
    # scale = theta_d / r, with the r->0 limit theta_d/r -> 1/z
    near_axis = r < 1e-8
    scale = jnp.where(near_axis, _safe_div(1.0, z), _safe_div(theta_d, r))
    u = fx * scale * x + cx
    v = fy * scale * y + cy
    valid = ~(near_axis & (z <= 0.0))
    return jnp.stack([u, v], axis=-1), valid


def _invert_theta_poly(theta_d, ks, iters=10):
    """Newton-solve theta from theta_d = poly(theta); fixed iterations."""
    theta = theta_d
    for _ in range(iters):
        th2 = theta * theta
        acc = jnp.zeros_like(theta)
        dacc = jnp.zeros_like(theta)
        for i, k in list(enumerate(ks))[::-1]:
            acc = (acc + k) * th2
            dacc = (dacc + (2 * i + 3) * k) * th2
        f = theta * (1.0 + acc) - theta_d
        fp = 1.0 + dacc
        theta = theta - _safe_div(f, fp)
    return theta


def unproject_kb4(params, p2d):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    ks = [params[..., 4 + i] for i in range(4)]
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    rd = _safe_sqrt(mx * mx + my * my)
    theta = _invert_theta_poly(rd, ks)
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    near0 = rd < 1e-12
    dirx = jnp.where(near0, mx, s * _safe_div(mx, rd))
    diry = jnp.where(near0, my, s * _safe_div(my, rd))
    # report rays with z>0 as valid (FOV<=180 deg usable downstream as x/z)
    valid = c > _EPS
    return jnp.stack([dirx, diry, c], axis=-1), valid


# ------------------------------------------------------------------- OPENCV5


def project_opencv5(params, p3d):
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = (params[..., i] for i in range(9))
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    valid = z > _EPS
    xp = _safe_div(x, z)
    yp = _safe_div(y, z)
    r2 = xp * xp + yp * yp
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xpp = xp * radial + 2.0 * p1 * xp * yp + p2 * (r2 + 2.0 * xp * xp)
    ypp = yp * radial + p1 * (r2 + 2.0 * yp * yp) + 2.0 * p2 * xp * yp
    u = fx * xpp + cx
    v = fy * ypp + cy
    return jnp.stack([u, v], axis=-1), valid


def unproject_opencv5(params, p2d):
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = (params[..., i] for i in range(9))
    xd = _safe_div(p2d[..., 0] - cx, fx)
    yd = _safe_div(p2d[..., 1] - cy, fy)
    # OpenCV-style fixed-point undistort iteration
    x, y = xd, yd
    for _ in range(12):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = _safe_div(xd - dx, radial)
        y = _safe_div(yd - dy, radial)
    ones = jnp.ones_like(x)
    return jnp.stack([x, y, ones], axis=-1), jnp.ones_like(x, dtype=bool)


# -------------------------------------------------------------------- FTHETA


def project_ftheta(params, p3d):
    """NVidia-style f-theta fisheye: pixel radius is an odd polynomial of the
    incidence angle, r_d(theta) = theta * (1 + k1 th^2 + ... + k5 th^10).

    Semantic-parity caveat: the reference's FTHETA lives in the unvendored
    `camera-intrinsic-model` crate (README.md:82) and could not be diffed
    offline; NVidia's published spec also carries a backward polynomial and
    a linear extension region that this implementation does not.  See
    PARITY.md "FTHETA semantic-parity note" for the accepted risk.
    """
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    ks = [params[..., 4 + i] for i in range(5)]
    x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
    r = _safe_sqrt(x * x + y * y)
    theta = jnp.arctan2(r, z)
    theta_d = _theta_poly(theta, ks)
    near_axis = r < 1e-8
    scale = jnp.where(near_axis, _safe_div(1.0, z), _safe_div(theta_d, r))
    u = fx * scale * x + cx
    v = fy * scale * y + cy
    valid = ~(near_axis & (z <= 0.0))
    return jnp.stack([u, v], axis=-1), valid


def unproject_ftheta(params, p2d):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    ks = [params[..., 4 + i] for i in range(5)]
    mx = _safe_div(p2d[..., 0] - cx, fx)
    my = _safe_div(p2d[..., 1] - cy, fy)
    rd = _safe_sqrt(mx * mx + my * my)
    theta = _invert_theta_poly(rd, ks)
    s = jnp.sin(theta)
    c = jnp.cos(theta)
    near0 = rd < 1e-12
    dirx = jnp.where(near0, mx, s * _safe_div(mx, rd))
    diry = jnp.where(near0, my, s * _safe_div(my, rd))
    valid = c > _EPS
    return jnp.stack([dirx, diry, c], axis=-1), valid


# ------------------------------------------------------------------ dispatch

_PROJECT = {
    "ucm": project_ucm,
    "eucm": project_eucm,
    "eucmt": project_eucmt,
    "kb4": project_kb4,
    "opencv5": project_opencv5,
    "ftheta": project_ftheta,
}
_UNPROJECT = {
    "ucm": unproject_ucm,
    "eucm": unproject_eucm,
    "eucmt": unproject_eucmt,
    "kb4": unproject_kb4,
    "opencv5": unproject_opencv5,
    "ftheta": unproject_ftheta,
}


def project_fn(name: str):
    return _PROJECT[name]


def unproject_fn(name: str):
    return _UNPROJECT[name]


def project(name: str, params, p3d):
    """Dispatch by static model name (resolved at trace time)."""
    return _PROJECT[name](params, p3d)


def unproject(name: str, params, p2d):
    return _UNPROJECT[name](params, p2d)
