"""Levenberg–Marquardt cores: dense small-problem LM and Schur-structured
bundle adjustment, fully on-device.

Batched replacement for the reference's ``tiny-solver`` + ``faer`` stack
(string-keyed factor graph with dual-number forward autodiff and sparse
normal equations — used surface in /root/repo/SURVEY.md §2.2).  The redesign:

- Parameters are fixed-shape arrays, not named blocks: intrinsics vector
  ``theta`` plus a ``(F, 6)`` pose batch.  Variable frame counts / corner
  counts are handled by weight masks, never by dynamic problem structure.
- Jacobians come from ``jax.jacfwd`` (forward mode — residual blocks are
  2-dim, parameter blocks tiny, exactly the dual-number regime the
  reference relies on), vmapped over frames.
- Robustness is Huber via IRLS row re-weighting (delta 1.0 / 0.5 as used at
  src/util.rs:313,413,539).
- Box bounds are enforced by step projection (clamping after the update),
  fixed variables by Jacobian column masking + unit diagonal
  (replaces ``set_variable_bounds`` / ``fix_variable``).
- The BA normal equations use the Schur complement over the pose blocks:
  poses are block-diagonal ``(F,6,6)``, so the reduced system is only
  ``k x k`` (k <= 9).  Everything solves with Cholesky (ROADMAP design
  item 5 asks whether that rule is still the simplest choice).
- The damping loop is a ``lax.while_loop`` with classic accept/reject.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from . import se3


def polish_rtol() -> float:
    """Relative-cost stop for the f64 polish stage of the mixed solvers.

    Measured on the real 534-frame bench problem (f32 stage-1 state, f32
    polish Jacobians, vs an 80-iter full-f64 reference): rtol=1e-14 runs
    7 polish iterations for an RMS drift of 6.6e-11 px; rtol=1e-10 exits
    after 3 iterations at 1.5e-9 px drift — still ~600x inside the 1e-6 px
    interchange gate (bench.py) — and each skipped iteration is an f64
    residual+Cholesky pass.  CCRS_POLISH_RTOL
    overrides (e.g. "1e-14" restores the deep-convergence stop).
    """
    import os

    return float(os.environ.get("CCRS_POLISH_RTOL", "1e-10"))


@dataclasses.dataclass(frozen=True)
class LMOptions:
    max_iters: int = 60
    lam0: float = 1e-6
    lam_up: float = 10.0
    lam_down: float = 0.1
    lam_min: float = 1e-12
    lam_max: float = 1e10
    rtol: float = 1e-14  # relative cost decrease
    huber_delta: Optional[float] = 1.0  # None = plain L2
    #: stall exit: the rtol test only fires on ACCEPTED steps, so once the
    #: solver reaches its (dtype) cost floor every proposal is rejected
    #: and the loop would burn the full max_iters recomputing Jacobians
    #: (measured: the f32 stage plateaued at iter 3 of 60).  Exit after
    #: this many CONSECUTIVE rejections once at least one step was
    #: accepted (3x as many before any accept: early rejects can be a
    #: legitimately-too-small lam0 warming up).
    max_rejects: int = 5
    #: the stall additionally requires lam to have climbed to at least this
    #: value: each rejection multiplies lam by lam_up, so a mid-descent step
    #: into a stiffer region gets the full lam range up to here before the
    #: solver may declare a stall (r02 advisor: a bare rejection count only
    #: explored ~1e5 of lambda dynamic range after an accept).  At the dtype
    #: cost floor this costs ~2-3 extra rejected iterations.
    stall_lam: float = 1e2


def cholesky_solve_batched_small(M, rhs):
    """Batched SPD solve for SMALL fixed n, unrolled over matrix indices.

    M (..., n, n), rhs (..., n) or (..., n, m) -> solution of M x = rhs.

    ``jax.vmap(jnp.linalg.cholesky)`` can lower to one tiny
    linear-algebra kernel per batch element (534 frames x 3 calls per LM
    iteration).  Unrolling the n<=9 Cholesky + substitutions into static
    Python loops yields a few hundred batch-vectorized elementwise ops
    instead.  Non-PD pivots poison their batch element with NaN,
    preserving jnp.linalg.cholesky's contract (LM rejects such steps via
    its isfinite guard).
    """
    n = M.shape[-1]
    vec = rhs.ndim == M.ndim - 1
    if vec:
        rhs = rhs[..., None]
    L = [[None] * n for _ in range(n)]
    bad = jnp.zeros(M.shape[:-2], bool)
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        bad = bad | (s <= 0.0)
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-300))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = rhs[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    out = jnp.stack(x, axis=-2)
    out = jnp.where(bad[..., None, None], jnp.nan, out)
    return out[..., 0] if vec else out


def huber_block_weight(r2, delta):
    """IRLS weight for a residual block with squared norm r2.

    Huber rho(s) = s (s<=d^2), 2 d sqrt(s) - d^2 otherwise; weight rho'(s).
    """
    if delta is None:
        return jnp.ones_like(r2)
    d2 = delta * delta
    return jnp.where(r2 <= d2, 1.0, delta / jnp.sqrt(jnp.maximum(r2, 1e-300)))


def huber_cost(r2, delta):
    if delta is None:
        return r2
    d2 = delta * delta
    return jnp.where(r2 <= d2, r2, 2.0 * delta * jnp.sqrt(jnp.maximum(r2, 1e-300)) - d2)


# --------------------------------------------------------------------------
# generic dense LM (convert_model, SE3 extrinsic init, ... small problems)
# --------------------------------------------------------------------------


def lm_solve(
    residual_fn: Callable,
    x0: jnp.ndarray,
    *,
    lo: Optional[jnp.ndarray] = None,
    hi: Optional[jnp.ndarray] = None,
    free: Optional[jnp.ndarray] = None,
    opts: LMOptions = LMOptions(),
):
    """Dense LM over a flat parameter vector.

    ``residual_fn(x) -> (blocks, w)``: residual blocks ``(B, d)`` and
    per-block weights ``(B,)`` (0 masks a block).  Huber is applied per
    block (matching tiny-solver's per-residual-block loss).

    Returns (x, final_cost, n_iters).
    """
    n = x0.shape[0]
    free_m = jnp.ones(n, dtype=x0.dtype) if free is None else free.astype(x0.dtype)

    def clamp(x):
        if lo is not None:
            x = jnp.maximum(x, lo)
        if hi is not None:
            x = jnp.minimum(x, hi)
        return x

    def cost_of(x):
        r, w = residual_fn(x)
        r2 = jnp.sum(r * r, axis=-1)
        return jnp.sum(w * huber_cost(r2, opts.huber_delta))

    def jac_res(x):
        def primal_with_aux(x):
            r, w = residual_fn(x)
            return r, (r, w)  # differentiate r; carry (r, w) out as aux

        J, (r, w) = jax.jacfwd(primal_with_aux, has_aux=True)(x)
        return r, w, J  # r (B,d), w (B,), J (B,d,n)

    def body(state):
        x, lam, cost, it, done, rej, acc_any = state
        r, w, J = jac_res(x)
        r2 = jnp.sum(r * r, axis=-1)
        wtot = w * huber_block_weight(r2, opts.huber_delta)
        Jm = J * free_m[None, None, :]
        H = jnp.einsum("bdi,bdj,b->ij", Jm, Jm, wtot)
        g = jnp.einsum("bdi,bd,b->i", Jm, r, wtot)
        H = H + jnp.diag(1.0 - free_m)  # unit diag for fixed -> step 0

        def try_lam(lam):
            D = jnp.diag(jnp.maximum(jnp.diagonal(H), 1e-12))
            L = jnp.linalg.cholesky(H + lam * D)
            dx = jax.scipy.linalg.cho_solve((L, True), -g)
            dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
            return clamp(x + dx * free_m)

        x_new = try_lam(lam)
        c_new = cost_of(x_new)
        accept = c_new < cost
        x = jnp.where(accept, x_new, x)
        lam = jnp.clip(
            jnp.where(accept, lam * opts.lam_down, lam * opts.lam_up),
            opts.lam_min,
            opts.lam_max,
        )
        converged = accept & (cost - c_new <= opts.rtol * jnp.maximum(cost, 1e-300))
        cost = jnp.where(accept, c_new, cost)
        rej = jnp.where(accept, 0, rej + 1)
        acc_any = acc_any | accept
        stall = (rej >= jnp.where(acc_any, opts.max_rejects, 3 * opts.max_rejects)) & (
            lam >= opts.stall_lam
        )
        return x, lam, cost, it + 1, done | converged | stall, rej, acc_any

    def cond(state):
        return (~state[4]) & (state[3] < opts.max_iters)

    x0 = clamp(x0)
    state = (
        x0, jnp.asarray(opts.lam0, x0.dtype), cost_of(x0), 0,
        jnp.asarray(False), jnp.asarray(0), jnp.asarray(False),
    )
    x, _, cost, it, _, _, _ = jax.lax.while_loop(cond, body, state)
    return x, cost, it


# --------------------------------------------------------------------------
# Schur-structured single-camera bundle adjustment
# --------------------------------------------------------------------------


class BAResult(NamedTuple):
    theta: jnp.ndarray  # (k,) reduced intrinsics
    poses: jnp.ndarray  # (F, 6) rvec|tvec
    cost: jnp.ndarray
    n_iters: jnp.ndarray
    # polish-stage share of n_iters (mixed solvers only; 0 for a plain
    # single-precision solve) — iteration-budget diagnostics
    n_polish: jnp.ndarray | int = 0


def expand_theta(theta, one_focal: bool):
    """Reduced intrinsics -> full model params (re-insert fy = fx row,
    mirroring src/optimization/factors.rs:155-158)."""
    if one_focal:
        return jnp.concatenate([theta[:1], theta[:1], theta[1:]])
    return theta


def reduce_params(params, one_focal: bool):
    if one_focal:
        return jnp.concatenate([params[:1], params[2:]])
    return params


@partial(
    jax.jit,
    static_argnames=(
        "project_fn", "one_focal", "max_iters", "huber_delta", "rtol",
        "jac_f32",
    ),
)
def ba_solve(
    project_fn,
    theta0,
    poses0,
    p3d,
    p2d,
    w,
    lo,
    hi,
    free,
    frame_valid,
    one_focal: bool = False,
    max_iters: int = 60,
    huber_delta: float = 1.0,
    rtol: float = 1e-14,
    jac_f32: bool = False,
):
    """Single-camera BA: intrinsics + per-frame board poses.

    Args:
      project_fn: static — model projection ``(params, p3d) -> (p2d, valid)``.
      theta0: (k,) reduced intrinsics (fy removed when one_focal).
      poses0: (F, 6) initial rvec|tvec per frame.
      p3d: (N, 3) board points (shared across frames).
      p2d: (F, N, 2) observations (padded).
      w: (F, N) observation weights (0 = padding / unobserved corner).
      lo, hi, free: (k,) bounds and free-mask on theta.
      frame_valid: (F,) 0/1 — frames excluded from the problem entirely
        (reference skips frames with <10 valid pose-init points,
        src/util.rs:431).
      one_focal / max_iters / huber_delta: static options.
      jac_f32: evaluate the JACOBIANS in f32 (residuals, costs and the
        accept/convergence logic stay in the caller's dtype).  Gauss-
        Newton with an approximate J converges to the fixed point of
        J~tWr = 0; a 1e-7-relative J error shifts the optimum by O(1e-7)
        in parameters and only SECOND order (~1e-14 px) in RMS — far
        inside the 1e-6 px interchange gate — while running jacfwd in
        f32 instead of f64.  Validated against the full
        f64 polish on the 534-frame bench problem (test_lm.py).

    Replaces the reference's calib_camera solve (src/util.rs:384-490): the
    factor graph with F*N ReprojectionFactors becomes one fixed-shape
    residual tensor; the sparse normal equations become a k x k Schur
    system plus F independent 6x6 Cholesky solves, all batched.
    """
    F, N, _ = p2d.shape
    k = theta0.shape[0]
    dtype = theta0.dtype
    w = w * frame_valid[:, None]
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)
    jac_f32 = jac_f32 and dtype != jnp.float32
    if jac_f32:
        f32 = jnp.float32
        p3d32 = p3d.astype(f32)
        p2d32 = p2d.astype(f32)

    def residual_with(pts):
        # ONE residual body parameterized on the board points' precision:
        # the f32-Jacobian path (jac_f32) differentiates the same math on
        # f32 points, so an edit here serves both precisions
        def f(theta, pose, p2d_f):
            params = expand_theta(theta, one_focal)
            pc = se3.transform(pose[:3], pose[3:], pts)
            proj, _ = project_fn(params, pc)
            return proj - p2d_f  # (N,2)

        return f

    frame_residual = residual_with(p3d)
    frame_residual32 = residual_with(p3d32) if jac_f32 else None

    def cost_of(theta, poses):
        r = jax.vmap(frame_residual, in_axes=(None, 0, 0))(theta, poses, p2d)
        r2 = jnp.sum(r * r, axis=-1)
        return jnp.sum(w * huber_cost(r2, huber_delta))

    def frame_jacobians(theta, pose, p2d_f, p2d_f32):
        def rfun(th, po):
            return frame_residual(th, po, p2d_f)

        if jac_f32:
            def rfun32(th, po):
                return frame_residual32(th, po, p2d_f32)

            Jt, Jp = jax.jacfwd(rfun32, argnums=(0, 1))(
                theta.astype(f32), pose.astype(f32)
            )
            Jt = Jt.astype(dtype)
            Jp = Jp.astype(dtype)
        else:
            Jt, Jp = jax.jacfwd(rfun, argnums=(0, 1))(theta, pose)
        r = rfun(theta, pose)
        return r, Jt, Jp  # (N,2), (N,2,k), (N,2,6)

    def body(state):
        theta, poses, lam, cost, it, done, rej, acc_any = state
        r, Jt, Jp = jax.vmap(frame_jacobians, in_axes=(None, 0, 0, 0))(
            theta, poses, p2d, p2d32 if jac_f32 else p2d
        )
        Jt = Jt * free[None, None, None, :]
        r2 = jnp.sum(r * r, axis=-1)
        wt = w * huber_block_weight(r2, huber_delta)  # (F,N)

        U = jnp.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)  # (k,k)
        A = jnp.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)  # (F,6,6)
        B = jnp.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)  # (F,k,6)
        g_t = jnp.einsum("fnri,fnr,fn->i", Jt, r, wt)  # (k,)
        g_p = jnp.einsum("fnri,fnr,fn->fi", Jp, r, wt)  # (F,6)
        U = U + jnp.diag(1.0 - free)

        def try_step(lam):
            Ud = U + lam * jnp.diag(jnp.maximum(jnp.diagonal(U), 1e-12))
            Ad = A + lam * jax.vmap(lambda a: jnp.diag(jnp.maximum(jnp.diagonal(a), 1e-12)))(A)
            # guard empty frames: make their block identity (step forced 0)
            eye6 = jnp.eye(6, dtype=dtype)
            Ad = jnp.where(frame_valid[:, None, None] > 0, Ad, eye6)
            # one unrolled 6x6 solve with k+1 stacked RHS columns
            rhs_all = jnp.concatenate(
                [jnp.swapaxes(B, 1, 2), g_p[..., None]], axis=2
            )  # (F,6,k+1)
            sol = cholesky_solve_batched_small(Ad, rhs_all)
            Ainv_Bt = sol[..., :-1]  # (F,6,k)
            Ainv_g = sol[..., -1]  # (F,6)
            S = Ud - jnp.einsum("fij,fjk->ik", B, Ainv_Bt)  # (k,k)
            rhs = -(g_t - jnp.einsum("fik,fi->k", Ainv_Bt, g_p))
            Ls = jnp.linalg.cholesky(S)
            dth = jax.scipy.linalg.cho_solve((Ls, True), rhs)
            dpo = -(Ainv_g + jnp.einsum("fik,k->fi", Ainv_Bt, dth))
            dth = jnp.where(jnp.isfinite(dth), dth, 0.0)
            dpo = jnp.where(jnp.isfinite(dpo), dpo, 0.0)
            th_new = jnp.clip(theta + dth * free, lo, hi)
            po_new = poses + dpo * frame_valid[:, None]
            return th_new, po_new

        th_new, po_new = try_step(lam)
        c_new = cost_of(th_new, po_new)
        accept = c_new < cost
        theta = jnp.where(accept, th_new, theta)
        poses = jnp.where(accept, po_new, poses)
        lam = jnp.clip(
            jnp.where(accept, lam * opts.lam_down, lam * opts.lam_up),
            opts.lam_min,
            opts.lam_max,
        )
        converged = accept & (cost - c_new <= opts.rtol * jnp.maximum(cost, 1e-300))
        cost = jnp.where(accept, c_new, cost)
        rej = jnp.where(accept, 0, rej + 1)
        acc_any = acc_any | accept
        stall = (rej >= jnp.where(acc_any, opts.max_rejects, 3 * opts.max_rejects)) & (
            lam >= opts.stall_lam
        )
        return theta, poses, lam, cost, it + 1, done | converged | stall, rej, acc_any

    def cond(state):
        return (~state[5]) & (state[4] < max_iters)

    theta0 = jnp.clip(theta0, lo, hi)
    state = (
        theta0,
        poses0,
        jnp.asarray(opts.lam0, dtype),
        cost_of(theta0, poses0),
        0,
        jnp.asarray(False),
        jnp.asarray(0),
        jnp.asarray(False),
    )
    theta, poses, _, cost, it, _, _, _ = jax.lax.while_loop(cond, body, state)
    return BAResult(theta, poses, cost, it)


def ba_solve_mixed(
    project_fn,
    theta0,
    poses0,
    p3d,
    p2d,
    w,
    lo,
    hi,
    free,
    frame_valid,
    one_focal: bool = False,
    max_iters: int = 60,
    huber_delta: float = 1.0,
    polish_iters: int = 12,
    polish_jac_f32: bool = True,
) -> BAResult:
    """Two-stage mixed-precision single-camera BA (same rationale as
    ba_solve_multi_mixed: LM only needs full precision near the
    optimum; whether f64 is slow enough on the GPU to earn this is ROADMAP
    speed item 6).  Stage 1 runs the bulk descent in native f32 (rtol=1e-6 —
    the f32 cost plateau); stage 2 polishes in the caller's dtype with
    f32 JACOBIANS by default (residual/cost/accept stay f64 — see
    ba_solve's jac_f32 note; CCRS_POLISH_JAC32=0 restores full-f64
    polish).  Traceable, so it inlines into the caller's jit graph."""
    import os

    if os.environ.get("CCRS_POLISH_JAC32", "") == "0":
        polish_jac_f32 = False
    f32 = jnp.float32
    a32 = [
        jnp.asarray(a, f32)
        for a in (theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid)
    ]
    s1 = ba_solve(
        project_fn, *a32, one_focal=one_focal, max_iters=max_iters,
        huber_delta=huber_delta, rtol=1e-6,
    )
    dt = theta0.dtype
    s2 = ba_solve(
        project_fn, jnp.asarray(s1.theta, dt), jnp.asarray(s1.poses, dt),
        p3d, p2d, w, lo, hi, free, frame_valid,
        one_focal=one_focal, max_iters=polish_iters, huber_delta=huber_delta,
        rtol=polish_rtol(), jac_f32=polish_jac_f32,
    )
    return BAResult(
        s2.theta, s2.poses, s2.cost, s1.n_iters + s2.n_iters, s2.n_iters
    )


# --------------------------------------------------------------------------
# multi-camera joint bundle adjustment
# --------------------------------------------------------------------------


class MultiBAResult(NamedTuple):
    theta: jnp.ndarray  # (C, k)
    ext: jnp.ndarray  # (C, 6) T_cam_i<-cam0 (row 0 pinned identity)
    poses: jnp.ndarray  # (F, 6) board->cam0
    cost: jnp.ndarray
    n_iters: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=(
        "project_fn", "one_focal", "max_iters", "huber_delta", "rtol",
        "jac_f32",
    ),
)
def ba_solve_multi(
    project_fn,
    theta0,
    ext0,
    poses0,
    p3d,
    p2d,
    w,
    lo,
    hi,
    free,
    cam_frame_valid,
    frame_valid,
    one_focal: bool = False,
    max_iters: int = 60,
    huber_delta: float = 1.0,
    rtol: float = 1e-14,
    jac_f32: bool = False,
):
    """Joint multi-camera BA: per-camera intrinsics + camera extrinsics
    (T_i_0) + shared board poses (T_0_b per frame).

    Replaces ``calib_all_camera_with_extrinsics`` (src/util.rs:567-715):
    cam0 observations constrain (theta_0, T_0_b); cam i>0 observations
    constrain (theta_i, T_i_0, T_0_b) through the chained transform
    T_i_0 * T_0_b (the OtherCamReprojectionFactor, factors.rs:204-228).
    Board poses are Schur-eliminated (F independent 6x6 blocks); the
    reduced system is (C*k + 6C) dense, solved by Cholesky.

    Args:
      theta0: (C, k) reduced intrinsics per camera.
      ext0: (C, 6) extrinsics rvec|tvec; row 0 must be zeros (pinned).
      poses0: (F, 6) board->cam0 poses.
      p2d/w: (C, F, N, 2) observations and (C, F, N) weights.
      lo/hi/free: (C, k) per-camera bounds/free masks on theta.
      cam_frame_valid: (C, F) camera c contributes frame f.
      frame_valid: (F,) frame participates at all.
    """
    C, F, N, _ = p2d.shape
    k = theta0.shape[1]
    dtype = theta0.dtype
    M = C * k + C * 6
    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)
    w = w * cam_frame_valid[:, :, None] * frame_valid[None, :, None]
    # f32 Jacobians (residual/cost stay in dtype) — see ba_solve's jac_f32
    jac_f32 = jac_f32 and dtype != jnp.float32
    if jac_f32:
        f32j = jnp.float32
        p3d32 = p3d.astype(f32j)
        p2d32 = p2d.astype(f32j)

    # e_0 is pinned to identity; its columns get unit diagonal below
    ext_free = jnp.concatenate(
        [jnp.zeros((1, 6), dtype), jnp.ones((C - 1, 6), dtype)], axis=0
    )

    def cam_residual_with(pts):
        # single residual body for both precisions (see residual_with in
        # ba_solve): the f32-Jacobian path differentiates this same math
        def f(c, theta_c, e_c, pose_f, p2d_cf):
            params = expand_theta(theta_c, one_focal)
            rv, tv = pose_f[:3], pose_f[3:]
            if c == 0:
                pc = se3.transform(rv, tv, pts)
            else:
                rvc, tvc = se3.compose(e_c[:3], e_c[3:], rv, tv)
                pc = se3.transform(rvc, tvc, pts)
            proj, _ = project_fn(params, pc)
            return proj - p2d_cf

        return f

    cam_residual = cam_residual_with(p3d)
    cam_residual32 = cam_residual_with(p3d32) if jac_f32 else None

    def cost_of(theta, ext, poses):
        total = jnp.zeros((), dtype)
        for c in range(C):
            r = jax.vmap(
                lambda pose_f, p2d_cf: cam_residual(c, theta[c], ext[c], pose_f, p2d_cf)
            )(poses, p2d[c])
            r2 = jnp.sum(r * r, axis=-1)
            total = total + jnp.sum(w[c] * huber_cost(r2, huber_delta))
        return total

    def body(state):
        theta, ext, poses, lam, cost, it, done, rej, acc_any = state
        U = jnp.zeros((M, M), dtype)
        g_x = jnp.zeros((M,), dtype)
        A = jnp.zeros((F, 6, 6), dtype)
        B = jnp.zeros((F, M, 6), dtype)
        g_p = jnp.zeros((F, 6), dtype)

        for c in range(C):
            def rfun(th, e, po, p2d_cf):
                return cam_residual(c, th, e, po, p2d_cf)

            if jac_f32:
                def rfun32(th, e, po, p2d_cf, c=c):
                    return cam_residual32(c, th, e, po, p2d_cf)

                def frame_jac(po, p2d_cf, p2d_cf32):
                    Jt, Je, Jp = jax.jacfwd(rfun32, argnums=(0, 1, 2))(
                        theta[c].astype(f32j), ext[c].astype(f32j),
                        po.astype(f32j), p2d_cf32,
                    )
                    r = rfun(theta[c], ext[c], po, p2d_cf)
                    return (
                        r, Jt.astype(dtype), Je.astype(dtype),
                        Jp.astype(dtype),
                    )

                r, Jt, Je, Jp = jax.vmap(frame_jac)(poses, p2d[c], p2d32[c])
            else:
                def frame_jac(po, p2d_cf):
                    Jt, Je, Jp = jax.jacfwd(rfun, argnums=(0, 1, 2))(
                        theta[c], ext[c], po, p2d_cf
                    )
                    r = rfun(theta[c], ext[c], po, p2d_cf)
                    return r, Jt, Je, Jp

                r, Jt, Je, Jp = jax.vmap(frame_jac)(poses, p2d[c])
            Jt = Jt * free[c][None, None, None, :]
            Je = Je * ext_free[c][None, None, None, :]
            r2 = jnp.sum(r * r, axis=-1)
            wt = w[c] * huber_block_weight(r2, huber_delta)  # (F,N)

            ti = c * k
            ei = C * k + c * 6
            Utt = jnp.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)
            Uee = jnp.einsum("fnri,fnrj,fn->ij", Je, Je, wt)
            Ute = jnp.einsum("fnri,fnrj,fn->ij", Jt, Je, wt)
            U = U.at[ti : ti + k, ti : ti + k].add(Utt)
            U = U.at[ei : ei + 6, ei : ei + 6].add(Uee)
            U = U.at[ti : ti + k, ei : ei + 6].add(Ute)
            U = U.at[ei : ei + 6, ti : ti + k].add(Ute.T)
            g_x = g_x.at[ti : ti + k].add(jnp.einsum("fnri,fnr,fn->i", Jt, r, wt))
            g_x = g_x.at[ei : ei + 6].add(jnp.einsum("fnri,fnr,fn->i", Je, r, wt))
            A = A + jnp.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)
            B = B.at[:, ti : ti + k, :].add(jnp.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt))
            B = B.at[:, ei : ei + 6, :].add(jnp.einsum("fnri,fnrj,fn->fij", Je, Jp, wt))
            g_p = g_p + jnp.einsum("fnri,fnr,fn->fi", Jp, r, wt)

        full_free = jnp.concatenate([free.reshape(-1), ext_free.reshape(-1)])
        U = U + jnp.diag(1.0 - full_free)

        def try_step(lam):
            Ud = U + lam * jnp.diag(jnp.maximum(jnp.diagonal(U), 1e-12))
            Ad = A + lam * jax.vmap(
                lambda a: jnp.diag(jnp.maximum(jnp.diagonal(a), 1e-12))
            )(A)
            eye6 = jnp.eye(6, dtype=dtype)
            Ad = jnp.where(frame_valid[:, None, None] > 0, Ad, eye6)
            rhs_all = jnp.concatenate(
                [jnp.swapaxes(B, 1, 2), g_p[..., None]], axis=2
            )
            sol = cholesky_solve_batched_small(Ad, rhs_all)
            Ainv_Bt = sol[..., :-1]  # (F,6,M)
            Ainv_g = sol[..., -1]
            S = Ud - jnp.einsum("fij,fjk->ik", B, Ainv_Bt)
            rhs = -(g_x - jnp.einsum("fik,fi->k", Ainv_Bt, g_p))
            # Jacobi-scale the reduced solve: parameter magnitudes span
            # ~1e5 (focal vs distortion vs extrinsic rotation), so the raw
            # system's condition number (~1e10) wastes half the mantissa;
            # D S D has unit diagonal and solves identically
            d = jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
            Sn = S / d[:, None] / d[None, :]
            Ls = jnp.linalg.cholesky(Sn)
            dx = jax.scipy.linalg.cho_solve((Ls, True), rhs / d) / d
            dpo = -(Ainv_g + jnp.einsum("fim,m->fi", Ainv_Bt, dx))
            dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
            dpo = jnp.where(jnp.isfinite(dpo), dpo, 0.0)
            dth = dx[: C * k].reshape(C, k) * free
            dex = dx[C * k :].reshape(C, 6) * ext_free
            th_new = jnp.clip(theta + dth, lo, hi)
            ex_new = ext + dex
            po_new = poses + dpo * frame_valid[:, None]
            return th_new, ex_new, po_new

        th_new, ex_new, po_new = try_step(lam)
        c_new = cost_of(th_new, ex_new, po_new)
        accept = c_new < cost
        theta = jnp.where(accept, th_new, theta)
        ext = jnp.where(accept, ex_new, ext)
        poses = jnp.where(accept, po_new, poses)
        lam = jnp.clip(
            jnp.where(accept, lam * opts.lam_down, lam * opts.lam_up),
            opts.lam_min,
            opts.lam_max,
        )
        # stop on tiny relative decrease OR a vanished gradient (the large
        # joint problems keep finding micro-improvements at the noise floor
        # and would otherwise burn max_iters)
        rel_small = cost - c_new <= opts.rtol * jnp.maximum(cost, 1e-300)
        gsmall = jnp.max(jnp.abs(g_x)) <= 1e-9 * jnp.maximum(cost, 1.0)
        converged = (accept & rel_small) | gsmall
        cost = jnp.where(accept, c_new, cost)
        rej = jnp.where(accept, 0, rej + 1)
        acc_any = acc_any | accept
        stall = (rej >= jnp.where(acc_any, opts.max_rejects, 3 * opts.max_rejects)) & (
            lam >= opts.stall_lam
        )
        return (
            theta, ext, poses, lam, cost, it + 1, done | converged | stall,
            rej, acc_any,
        )

    def cond(state):
        return (~state[6]) & (state[5] < max_iters)

    theta0 = jnp.clip(theta0, lo, hi)
    state = (
        theta0,
        ext0,
        poses0,
        jnp.asarray(opts.lam0, dtype),
        cost_of(theta0, ext0, poses0),
        0,
        jnp.asarray(False),
        jnp.asarray(0),
        jnp.asarray(False),
    )
    theta, ext, poses, _, cost, it, _, _, _ = jax.lax.while_loop(cond, body, state)
    return MultiBAResult(theta, ext, poses, cost, it)


def ba_solve_multi_mixed(
    project_fn,
    theta0,
    ext0,
    poses0,
    p3d,
    p2d,
    w,
    lo,
    hi,
    free,
    cam_frame_valid,
    frame_valid,
    one_focal: bool = False,
    max_iters: int = 60,
    huber_delta: float = 1.0,
    polish_iters: int = 10,
    polish_jac_f32: bool = False,
) -> MultiBAResult:
    """Two-stage mixed-precision joint BA.

    LM only needs full precision near the optimum: stage 1 runs the bulk
    of the descent in f32 (loose rtol=1e-6 stop — the f32 cost plateau),
    stage 2 polishes from the f32 state in f64.  Measured to reproduce the
    pure-f64 solution (identical final cost/params on the 8-cam rig
    problem) while replacing most f64 iterations with f32 ones.

    Unlike the single-camera ``ba_solve_mixed``, the polish keeps f64
    JACOBIANS by default: on the 8-camera/1000-frame rig the joint
    96-dim Schur system is ill-conditioned enough that f32 Jacobian
    error poisons the step (measured: polish stalls at the f32 state,
    max focal error 2.1% vs 1.25e-4 with f64 J; the single-camera 6-dim
    system shows 6.6e-11 px drift with f32 J).  CCRS_POLISH_JAC32=1
    forces it on for experiments, =0 forces off.
    """
    import os

    env = os.environ.get("CCRS_POLISH_JAC32", "")
    if env == "0":
        polish_jac_f32 = False
    elif env == "1":
        polish_jac_f32 = True
    f32 = jnp.float32
    a32 = [
        jnp.asarray(a, f32)
        for a in (
            theta0, ext0, poses0, p3d, p2d, w, lo, hi, free,
            cam_frame_valid, frame_valid,
        )
    ]
    s1 = ba_solve_multi(
        project_fn, *a32, one_focal=one_focal, max_iters=max_iters,
        huber_delta=huber_delta, rtol=1e-6,
    )
    dt = theta0.dtype
    s2 = ba_solve_multi(
        project_fn,
        jnp.asarray(s1.theta, dt), jnp.asarray(s1.ext, dt),
        jnp.asarray(s1.poses, dt),
        p3d, p2d, w, lo, hi, free, cam_frame_valid, frame_valid,
        one_focal=one_focal, max_iters=polish_iters, huber_delta=huber_delta,
        rtol=polish_rtol(), jac_f32=polish_jac_f32,
    )
    return MultiBAResult(s2.theta, s2.ext, s2.poses, s2.cost, s1.n_iters + s2.n_iters)
