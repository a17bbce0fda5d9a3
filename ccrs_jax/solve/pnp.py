"""Pose-from-correspondences (PnP) for planar calibration boards, pure JAX.

Replaces the reference's ``sqpnp_simple::sqpnp_solve_glam`` (call sites
``src/optimization/linear.rs:20``, ``src/util.rs:436``).  Every call site in
the calibration pipeline passes AprilGrid board points, which are coplanar
(z=0), so the batched design uses the right tool for planar targets:

1. DLT homography board(x,y) -> normalized image plane (9x9 normal
   matrix; null vector via Cholesky inverse iteration, batched with vmap);
2. homography decomposition R = [h1' h2' h1'xh2'], t = h3/s, SO(3)
   projection via the Newton polar iteration (Zhang-style);
3. a fixed-iteration Gauss-Newton polish on the reprojection residual in
   the normalized plane (6x6 normal equations, Cholesky).

The whole pipeline is CHOLESKY-ONLY: small Cholesky solves fuse into
the batched graph, and with eigh/SVD factored out the PnP runs in either
dtype.

Supports per-point weights so padded/invalid points are masked, and is
``vmap``-able over frames (used by calib_camera's per-frame pose init,
``src/util.rs:418-439``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import se3


def _weighted_normalize(p, w):
    """Shift+scale points for DLT conditioning. p:(N,2/3[:2]), w:(N,)."""
    wsum = jnp.maximum(jnp.sum(w), 1e-12)
    mean = jnp.sum(p * w[:, None], axis=0) / wsum
    d = jnp.linalg.norm(p - mean, axis=-1)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / wsum, 1e-12)
    return mean, scale


def _smallest_eigvec(S, iters: int = 12):
    """Eigenvector of the smallest eigenvalue of a symmetric PSD (n, n)
    matrix via shifted INVERSE ITERATION with Cholesky solves.

    Replaces ``jnp.linalg.eigh`` on the DLT normal matrix with Cholesky
    solves, which batch and fuse in both dtypes.  The DLT spectrum has a well-separated near-null
    direction, so a fixed iteration count converges far below the
    detector noise floor; per-iteration renormalization keeps it stable.
    """
    n = S.shape[0]
    # shift: small relative to the spectrum scale but safely above the
    # dtype's rounding noise, so the shifted matrix stays positive
    # definite for Cholesky even when the smallest eigenvalue is ~0
    # (in f32 a 1e-9 relative shift underflows the factorization noise
    # and the solve returns garbage — dtype-aware scaling is required)
    eps = (jnp.trace(S) / n) * (100.0 * jnp.finfo(S.dtype).eps) + 1e-300
    L = jnp.linalg.cholesky(S + eps * jnp.eye(n, dtype=S.dtype))

    def body(v, _):
        v = jax.scipy.linalg.cho_solve((L, True), v)
        v = v / jnp.maximum(jnp.linalg.norm(v), 1e-300)
        return v, None

    # deterministic start with overlap on any direction: ones + e0
    v0 = jnp.ones(n, dtype=S.dtype).at[0].add(0.5)
    v0 = v0 / jnp.linalg.norm(v0)
    v, _ = jax.lax.scan(body, v0, None, length=iters)
    return v


def homography_dlt(p_src, p_dst, w):
    """Weighted DLT homography src->dst. p_src/p_dst: (N,2); w: (N,).

    Returns 3x3 H (h22 ~ 1 after denormalization).
    """
    ms, ss = _weighted_normalize(p_src, w)
    md, sd = _weighted_normalize(p_dst, w)
    s = (p_src - ms) * ss
    d = (p_dst - md) * sd
    x, y = s[:, 0], s[:, 1]
    u, v = d[:, 0], d[:, 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    r1 = jnp.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], -1)
    r2 = jnp.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], -1)
    A = jnp.concatenate([r1 * w[:, None], r2 * w[:, None]], axis=0)  # (2N,9)
    # null vector via inverse iteration on A^T A (9x9, Cholesky-only).
    # HIGHEST matmul precision: a reduced-precision f32 matmul (TF32 on
    # the GPU) drowns the normal matrix's near-null direction.
    AtA = jnp.matmul(A.T, A, precision=jax.lax.Precision.HIGHEST)
    h = _smallest_eigvec(AtA)
    Hn = h.reshape(3, 3)
    # denormalize: H = Td^-1 Hn Ts
    Ts = jnp.array(
        [[ss, 0.0, -ss * ms[0]], [0.0, ss, -ss * ms[1]], [0.0, 0.0, 1.0]],
        dtype=p_src.dtype,
    )
    Td_inv = jnp.array(
        [[1.0 / sd, 0.0, md[0]], [0.0, 1.0 / sd, md[1]], [0.0, 0.0, 1.0]],
        dtype=p_src.dtype,
    )
    H = jnp.matmul(
        jnp.matmul(Td_inv, Hn, precision=jax.lax.Precision.HIGHEST),
        Ts, precision=jax.lax.Precision.HIGHEST,
    )
    return H / jnp.where(jnp.abs(H[2, 2]) > 1e-12, H[2, 2], 1.0)


def _adjugate3(M):
    """Closed-form adjugate of a 3x3 (adj(M) = det(M) * M^-1)."""
    a, b, c = M[0, 0], M[0, 1], M[0, 2]
    d, e, f = M[1, 0], M[1, 1], M[1, 2]
    g, h, i = M[2, 0], M[2, 1], M[2, 2]
    return jnp.array(
        [
            [e * i - f * h, c * h - b * i, b * f - c * e],
            [f * g - d * i, a * i - c * g, c * d - a * f],
            [d * h - e * g, b * g - a * h, a * e - b * d],
        ],
        dtype=M.dtype,
    )


def _project_so3(Q, iters: int = 6):
    """Nearest rotation to Q via the Newton polar iteration
    ``Q <- (Q + Q^-T)/2`` (quadratic convergence; inverse via the
    closed-form 3x3 adjugate — no SVD, which this backend's compiler
    cannot lower in f32).  Caller guarantees det(Q) > 0 (the third
    column is the cross product of the first two)."""

    def body(Qk, _):
        det = jnp.linalg.det(Qk)
        inv_t = _adjugate3(Qk).T / jnp.where(jnp.abs(det) > 1e-30, det, 1e-30)
        return 0.5 * (Qk + inv_t), None

    R, _ = jax.lax.scan(body, Q, None, length=iters)
    return R


def _pose_from_homography(H):
    """Zhang decomposition of a normalized-plane homography (K = I)."""
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    s = jnp.sqrt(jnp.linalg.norm(h1) * jnp.linalg.norm(h2))
    s = jnp.where(s > 1e-12, s, 1.0)
    # sign: board must be in front of the camera (t_z > 0)
    sign = jnp.where(h3[2] >= 0, 1.0, -1.0)
    r1 = sign * h1 / s
    r2 = sign * h2 / s
    r3 = jnp.cross(r1, r2)
    Q = jnp.stack([r1, r2, r3], axis=-1)
    R = _project_so3(Q)
    t = sign * h3 / s
    return R, t


def _gn_polish(rvec, tvec, p3d, p2d, w, iters=8):
    """Gauss-Newton on e_i = (x/z, y/z) - m_i with analytic Jacobian.

    Parameterization: left-multiplied increment T <- exp(dw) * T for
    rotation, additive for translation.  The rotation is carried as a
    MATRIX through the iterations and converted to an axis-angle vector
    once at the end: a per-iteration ``log_so3(exp_so3(dw) @ R)``
    round-trip is ill-conditioned near theta = pi (arccos derivative
    blows up), and board poses in this pipeline routinely sit there (the
    front-view base rotation is rot_z(pi)) — in f32 the round-trip made
    the polish diverge outright (measured).
    """

    def step(carry, _):
        R, tvec = carry
        pc = jnp.matmul(p3d, R.T, precision=jax.lax.Precision.HIGHEST) + tvec
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        zsafe = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
        e = jnp.stack([x / zsafe, y / zsafe], -1) - p2d  # (N,2)
        iz = 1.0 / zsafe
        iz2 = iz * iz
        # d(proj)/d(pc): (N,2,3)
        zero = jnp.zeros_like(x)
        Jp = jnp.stack(
            [
                jnp.stack([iz, zero, -x * iz2], -1),
                jnp.stack([zero, iz, -y * iz2], -1),
            ],
            -2,
        )
        # d(pc)/d(dw) = -[pc]_x ; d(pc)/d(dt) = I
        Jw = -Jp @ se3.hat(pc)  # (N,2,3)
        Jt = Jp
        J = jnp.concatenate([Jw, Jt], axis=-1)  # (N,2,6)
        wv = w[:, None]
        hi = jax.lax.Precision.HIGHEST
        JtJ = jnp.einsum("nri,nrj->ij", J * wv[..., None], J, precision=hi)
        Jte = jnp.einsum("nri,nr->i", J * wv[..., None], e, precision=hi)
        JtJ = JtJ + 1e-12 * jnp.eye(6, dtype=J.dtype)
        L = jnp.linalg.cholesky(JtJ)
        dx = jax.scipy.linalg.cho_solve((L, True), -Jte)
        dw, dt = dx[:3], dx[3:]
        dR = se3.exp_so3(dw)
        new_R = jnp.matmul(dR, R, precision=jax.lax.Precision.HIGHEST)
        new_tvec = (dR @ tvec[:, None])[:, 0] + dt
        return (new_R, new_tvec), None

    (R, tvec), _ = jax.lax.scan(
        step, (se3.exp_so3(rvec), tvec), None, length=iters
    )
    return se3.log_so3(R), tvec


def solve_pnp_planar(p3d, p2d_norm, w=None):
    """Pose of a planar target from normalized-plane observations.

    Args:
      p3d: (N,3) board points, z == 0 (the AprilGrid plane).
      p2d_norm: (N,2) observations on the normalized image plane (x/z,y/z).
      w: optional (N,) weights; 0 masks a point (padding / invalid).

    Returns:
      (rvec (3,), tvec (3,)) mapping board -> camera.  vmap over leading
      axes for a whole frame batch.
    """
    if w is None:
        w = jnp.ones(p3d.shape[0], dtype=p3d.dtype)
    H = homography_dlt(p3d[:, :2], p2d_norm, w)
    R, t = _pose_from_homography(H)
    rvec = se3.log_so3(R)
    return _gn_polish(rvec, t, p3d, p2d_norm, w)


solve_pnp_planar_batch = jax.jit(jax.vmap(solve_pnp_planar, in_axes=(0, 0, 0)))
