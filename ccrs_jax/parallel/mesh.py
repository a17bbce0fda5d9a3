"""Multi-device scaling: frame-sharded bundle adjustment over a device mesh.

The calibration problem's only cross-frame coupling is the reduced
(intrinsics) normal-equation system — pose blocks are per-frame — so the
natural SPMD layout shards the frame batch across devices and ``psum``s the
k x k Schur system across devices (SURVEY.md §5 "Distributed
communication backend": the JtJ/Jtr accumulation is the only collective).  Detection is
embarrassingly frame-parallel and uses the same sharding.

All code paths work on any 1-D ``jax.sharding.Mesh``: the GPUs of one host
(NVLink joins every pair at the same rate, so the mesh follows the frame
axis alone) or the virtual ``--xla_force_host_platform_device_count`` CPU
mesh used in CI.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solve import se3
from ..solve.lm import (
    cholesky_solve_batched_small,
    expand_theta,
    huber_block_weight,
)

FRAME_AXIS = "frames"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) but only {len(devs)} device(s) visible "
                f"on platform {devs[0].platform!r}; set "
                "--xla_force_host_platform_device_count (CPU) or use more GPUs"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (FRAME_AXIS,))


def pad_frames(arrs, n_devices: int):
    """Pad leading (frame) axis to a multiple of the mesh size; returns
    (padded arrays, original F).  Padding rows carry zero weight."""
    F = arrs[0].shape[0]
    pad = (-F) % n_devices
    if pad == 0:
        return list(arrs), F
    out = []
    for a in arrs:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(jnp.pad(a, widths))
    return out, F


from functools import lru_cache


@lru_cache(maxsize=32)
def make_ba_step(
    project_fn, mesh: Mesh, one_focal: bool = False, huber_delta: float = 1.0, k: int = 6
):
    """Build (and cache) a JITTED frame-sharded LM step for a mesh.

    Per-device: local residuals/Jacobians, local pose-block solves, local
    partial Schur sums.  Cross-device: one ``psum`` of the (k,k) reduced
    system + rhs; the tiny solve is computed replicated and
    pose updates stay local.

    Returned step: ``step(theta, poses, p3d, p2d, w, free, lam) ->
    (theta_new, poses_new)``.
    """

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(FRAME_AXIS), P(), P(FRAME_AXIS), P(FRAME_AXIS), P(), P()),
        out_specs=(P(), P(FRAME_AXIS)),
    )
    def step(theta, poses, p3d, p2d, w, free, lam):
        def frame_residual(th, pose, p2d_f):
            params = expand_theta(th, one_focal)
            pc = se3.transform(pose[:3], pose[3:], p3d)
            proj, _ = project_fn(params, pc)
            return proj - p2d_f

        def frame_jac(pose, p2d_f):
            Jt, Jp = jax.jacfwd(frame_residual, argnums=(0, 1))(theta, pose, p2d_f)
            r = frame_residual(theta, pose, p2d_f)
            return r, Jt, Jp

        r, Jt, Jp = jax.vmap(frame_jac)(poses, p2d)
        Jt = Jt * free[None, None, None, :]
        r2 = jnp.sum(r * r, axis=-1)
        wt = w * huber_block_weight(r2, huber_delta)

        U = jnp.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)
        A = jnp.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)
        B = jnp.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)
        g_t = jnp.einsum("fnri,fnr,fn->i", Jt, r, wt)
        g_p = jnp.einsum("fnri,fnr,fn->fi", Jp, r, wt)

        damp = lam * jnp.maximum(jnp.diagonal(A, axis1=1, axis2=2), 1e-12)
        Ad = A + jax.vmap(jnp.diag)(damp)
        # empty/padding frames: identity block, zero update
        has_obs = jnp.sum(wt, axis=1) > 0
        Ad = jnp.where(has_obs[:, None, None], Ad, jnp.eye(6, dtype=theta.dtype))
        rhs_all = jnp.concatenate([jnp.swapaxes(B, 1, 2), g_p[..., None]], axis=2)
        sol = cholesky_solve_batched_small(Ad, rhs_all)
        Ainv_Bt = sol[..., :-1]
        Ainv_g = sol[..., -1]

        corr_local = jnp.einsum("fij,fjk->ik", B, Ainv_Bt)
        rhs_local = -(g_t - jnp.einsum("fik,fi->k", Ainv_Bt, g_p))
        # the one collective: reduce the k x k system over the frame axis
        # (U, Schur correction, rhs stacked into a single psum)
        packed = jnp.concatenate([U, corr_local, rhs_local[None, :]], axis=0)
        packed = jax.lax.psum(packed, FRAME_AXIS)
        U_tot, corr, rhs = packed[:k], packed[k : 2 * k], packed[2 * k]
        # damping placement identical to ba_solve: unit diag for fixed vars,
        # Marquardt scaling on U's diagonal, then subtract the correction
        U_tot = U_tot + jnp.diag(1.0 - free)
        Ud = U_tot + lam * jnp.diag(jnp.maximum(jnp.diagonal(U_tot), 1e-12))
        S = Ud - corr
        Ls = jnp.linalg.cholesky(S)
        dth = jax.scipy.linalg.cho_solve((Ls, True), rhs)
        dth = jnp.where(jnp.isfinite(dth), dth, 0.0)
        dpo = -(Ainv_g + jnp.einsum("fik,k->fi", Ainv_Bt, dth))
        dpo = jnp.where(jnp.isfinite(dpo) & has_obs[:, None], dpo, 0.0)
        return theta + dth * free, poses + dpo

    return step


@lru_cache(maxsize=32)
def make_multi_ba_solver(
    project_fn,
    mesh: Mesh,
    one_focal: bool = False,
    huber_delta: float = 1.0,
    max_iters: int = 60,
    rtol: float = 1e-14,
    jac_f32: bool = False,
):
    """Build (and cache) a jitted FULL frame-sharded multi-camera joint BA.

    Semantics match ``solve.lm.ba_solve_multi`` (per-camera intrinsics +
    extrinsics T_i_0 + shared board poses T_0_b; reference
    src/util.rs:567-715): board-pose blocks stay device-local and are
    Schur-eliminated per frame; each iteration reduces one packed
    (U | Schur correction | rhs | gradient) system of size
    (2M+2, M), M = C*k + 6C, with a single ``psum`` over the frame axis.

    Returned solve:
      ``solve(theta0 (C,k), ext0 (C,6), poses0 (F,6), p3d, p2d (C,F,N,2),
      w (C,F,N), lo, hi, free (C,k), cam_frame_valid (C,F),
      frame_valid (F,)) -> (theta, ext, poses, cost, iters)``
    with F-axis arrays sharded over the mesh (pad F to a mesh multiple;
    padding frames carry frame_valid = 0).
    """
    from ..solve.lm import (
        LMOptions,
        cholesky_solve_batched_small,
        expand_theta,
        huber_block_weight,
        huber_cost,
    )

    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(FRAME_AXIS), P(),
            P(None, FRAME_AXIS), P(None, FRAME_AXIS),
            P(), P(), P(), P(None, FRAME_AXIS), P(FRAME_AXIS),
        ),
        out_specs=(P(), P(), P(FRAME_AXIS), P(), P()),
    )
    def solve(
        theta0, ext0, poses0, p3d, p2d, w, lo, hi, free, cam_frame_valid,
        frame_valid,
    ):
        C, Floc, N, _ = p2d.shape
        k = theta0.shape[1]
        dtype = theta0.dtype
        M = C * k + C * 6
        w = w * cam_frame_valid[:, :, None] * frame_valid[None, :, None]
        ext_free = jnp.concatenate(
            [jnp.zeros((1, 6), dtype), jnp.ones((C - 1, 6), dtype)], axis=0
        )
        full_free = jnp.concatenate([free.reshape(-1), ext_free.reshape(-1)])
        # f32 Jacobians, dtype residual/cost (see solve.lm ba_solve jac_f32)
        use_j32 = jac_f32 and dtype != jnp.float32
        if use_j32:
            f32j = jnp.float32
            p3d32 = p3d.astype(f32j)
            p2d32 = p2d.astype(f32j)

        def cam_residual_with(pts):
            # single residual body for both precisions (the jac_f32 path
            # differentiates this same math on f32 points; see
            # solve.lm.ba_solve_multi)
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
        cam_residual32 = cam_residual_with(p3d32) if use_j32 else None

        def cost_of(theta, ext, poses):
            total = jnp.zeros((), dtype)
            for c in range(C):
                r = jax.vmap(
                    lambda pose_f, p2d_cf: cam_residual(
                        c, theta[c], ext[c], pose_f, p2d_cf
                    )
                )(poses, p2d[c])
                r2 = jnp.sum(r * r, axis=-1)
                total = total + jnp.sum(w[c] * huber_cost(r2, huber_delta))
            return jax.lax.psum(total, FRAME_AXIS)

        def body(state):
            theta, ext, poses, lam, cost, it, done, rej, acc_any = state
            # device-local partial sums over this shard's frames
            U = jnp.zeros((M, M), dtype)
            g_x = jnp.zeros((M,), dtype)
            A = jnp.zeros((Floc, 6, 6), dtype)
            B = jnp.zeros((Floc, M, 6), dtype)
            g_p = jnp.zeros((Floc, 6), dtype)

            for c in range(C):
                def rfun(th, e, po, p2d_cf):
                    return cam_residual(c, th, e, po, p2d_cf)

                if use_j32:
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

                    r, Jt, Je, Jp = jax.vmap(frame_jac)(
                        poses, p2d[c], p2d32[c]
                    )
                else:
                    def frame_jac(po, p2d_cf):
                        Jt, Je, Jp = jax.jacfwd(rfun, argnums=(0, 1, 2))(
                            theta[c], ext[c], po, p2d_cf
                        )
                        return rfun(theta[c], ext[c], po, p2d_cf), Jt, Je, Jp

                    r, Jt, Je, Jp = jax.vmap(frame_jac)(poses, p2d[c])
                Jt = Jt * free[c][None, None, None, :]
                Je = Je * ext_free[c][None, None, None, :]
                r2 = jnp.sum(r * r, axis=-1)
                wt = w[c] * huber_block_weight(r2, huber_delta)

                ti = c * k
                ei = C * k + c * 6
                Utt = jnp.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)
                Uee = jnp.einsum("fnri,fnrj,fn->ij", Je, Je, wt)
                Ute = jnp.einsum("fnri,fnrj,fn->ij", Jt, Je, wt)
                U = U.at[ti : ti + k, ti : ti + k].add(Utt)
                U = U.at[ei : ei + 6, ei : ei + 6].add(Uee)
                U = U.at[ti : ti + k, ei : ei + 6].add(Ute)
                U = U.at[ei : ei + 6, ti : ti + k].add(Ute.T)
                g_x = g_x.at[ti : ti + k].add(
                    jnp.einsum("fnri,fnr,fn->i", Jt, r, wt)
                )
                g_x = g_x.at[ei : ei + 6].add(
                    jnp.einsum("fnri,fnr,fn->i", Je, r, wt)
                )
                A = A + jnp.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)
                B = B.at[:, ti : ti + k, :].add(
                    jnp.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)
                )
                B = B.at[:, ei : ei + 6, :].add(
                    jnp.einsum("fnri,fnrj,fn->fij", Je, Jp, wt)
                )
                g_p = g_p + jnp.einsum("fnri,fnr,fn->fi", Jp, r, wt)

            def try_step(lam):
                Ad = A + lam * jax.vmap(
                    lambda a: jnp.diag(jnp.maximum(jnp.diagonal(a), 1e-12))
                )(A)
                eye6 = jnp.eye(6, dtype=dtype)
                Ad = jnp.where(frame_valid[:, None, None] > 0, Ad, eye6)
                rhs_all = jnp.concatenate(
                    [jnp.swapaxes(B, 1, 2), g_p[..., None]], axis=2
                )
                sol = cholesky_solve_batched_small(Ad, rhs_all)
                Ainv_Bt = sol[..., :-1]  # (Floc, 6, M)
                Ainv_g = sol[..., -1]
                corr_l = jnp.einsum("fij,fjk->ik", B, Ainv_Bt)
                rhs_l = -(g_x - jnp.einsum("fik,fi->k", Ainv_Bt, g_p))
                # the one collective per iteration: U | Schur corr | rhs | g
                packed = jnp.concatenate(
                    [U, corr_l, rhs_l[None, :], g_x[None, :]], axis=0
                )
                packed = jax.lax.psum(packed, FRAME_AXIS)
                U_tot = packed[:M] + jnp.diag(1.0 - full_free)
                corr, rhs, g_tot = packed[M : 2 * M], packed[2 * M], packed[2 * M + 1]
                Ud = U_tot + lam * jnp.diag(
                    jnp.maximum(jnp.diagonal(U_tot), 1e-12)
                )
                S = Ud - corr
                # Jacobi scaling: see solve.lm.ba_solve_multi (identical
                # math so the sharded/single-device solutions stay equal)
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
                return th_new, ex_new, po_new, jnp.max(jnp.abs(g_tot))

            th_new, ex_new, po_new, gmax = try_step(lam)
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
            rel_small = cost - c_new <= opts.rtol * jnp.maximum(cost, 1e-300)
            gsmall = gmax <= 1e-9 * jnp.maximum(cost, 1.0)
            converged = (accept & rel_small) | gsmall
            cost = jnp.where(accept, c_new, cost)
            rej = jnp.where(accept, 0, rej + 1)
            acc_any = acc_any | accept
            stall = rej >= jnp.where(
                acc_any, opts.max_rejects, 3 * opts.max_rejects
            )
            return (
                theta, ext, poses, lam, cost, it + 1,
                done | converged | stall, rej, acc_any,
            )

        def cond(state):
            return (~state[6]) & (state[5] < max_iters)

        theta0 = jnp.clip(theta0, lo, hi)
        state = (
            theta0, ext0, poses0, jnp.asarray(opts.lam0, dtype),
            cost_of(theta0, ext0, poses0), 0, jnp.asarray(False),
            jnp.asarray(0), jnp.asarray(False),
        )
        theta, ext, poses, _, cost, it, _, _, _ = jax.lax.while_loop(
            cond, body, state
        )
        return theta, ext, poses, cost, it

    return solve


def ba_step_sharded(
    project_fn,
    theta,
    poses,
    p3d,
    p2d,
    w,
    free,
    lam,
    mesh: Mesh,
    one_focal: bool = False,
    huber_delta: float = 1.0,
):
    """Convenience wrapper over the cached jitted step (see make_ba_step)."""
    step = make_ba_step(project_fn, mesh, one_focal, huber_delta, int(theta.shape[0]))
    return step(theta, poses, p3d, p2d, w, free, jnp.asarray(lam, theta.dtype))


def sharded_frame_sharding(mesh: Mesh):
    """NamedSharding for (F, ...) arrays sharded over the frame axis."""
    return NamedSharding(mesh, P(FRAME_AXIS))


@lru_cache(maxsize=32)
def make_ba_solver(
    project_fn,
    mesh: Mesh,
    one_focal: bool = False,
    huber_delta: float = 1.0,
    max_iters: int = 60,
    rtol: float = 1e-14,
):
    """Build (and cache) a jitted FULL frame-sharded LM solve.

    Semantics match ``solve.lm.ba_solve`` (same damping schedule,
    accept/reject, bounds, free-mask, Huber IRLS); the entire
    ``lax.while_loop`` runs inside one ``shard_map``: poses/observations
    stay device-local, each iteration reduces the packed
    (U | Schur correction | rhs) system plus the robust cost with psums
    over the frame axis, and the accept/reject scalars are replicated
    (identical on every device by construction).

    Returned solve: ``solve(theta0, poses0, p3d, p2d, w, lo, hi, free,
    frame_valid) -> (theta, poses, cost, iters)`` with (F, ...) arrays
    sharded over the mesh (pad F to a mesh multiple with pad_frames and
    zero weights).
    """
    from ..solve.lm import (
        LMOptions,
        cholesky_solve_batched_small,
        expand_theta,
        huber_block_weight,
        huber_cost,
    )

    opts = LMOptions(max_iters=max_iters, huber_delta=huber_delta, rtol=rtol)

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(FRAME_AXIS), P(), P(FRAME_AXIS), P(FRAME_AXIS),
            P(), P(), P(), P(FRAME_AXIS),
        ),
        out_specs=(P(), P(FRAME_AXIS), P(), P()),
    )
    def solve(theta0, poses0, p3d, p2d, w, lo, hi, free, frame_valid):
        k = theta0.shape[0]
        dtype = theta0.dtype
        w = w * frame_valid[:, None]

        def frame_residual(theta, pose, p2d_f):
            params = expand_theta(theta, one_focal)
            pc = se3.transform(pose[:3], pose[3:], p3d)
            proj, _ = project_fn(params, pc)
            return proj - p2d_f

        def cost_of(theta, poses):
            r = jax.vmap(frame_residual, in_axes=(None, 0, 0))(theta, poses, p2d)
            r2 = jnp.sum(r * r, axis=-1)
            local = jnp.sum(w * huber_cost(r2, huber_delta))
            return jax.lax.psum(local, FRAME_AXIS)

        def body(state):
            theta, poses, lam, cost, it, done, rej, acc_any = state

            def frame_jac(pose, p2d_f):
                Jt, Jp = jax.jacfwd(frame_residual, argnums=(0, 1))(
                    theta, pose, p2d_f
                )
                return frame_residual(theta, pose, p2d_f), Jt, Jp

            r, Jt, Jp = jax.vmap(frame_jac)(poses, p2d)
            Jt = Jt * free[None, None, None, :]
            r2 = jnp.sum(r * r, axis=-1)
            wt = w * huber_block_weight(r2, huber_delta)

            U = jnp.einsum("fnri,fnrj,fn->ij", Jt, Jt, wt)
            A = jnp.einsum("fnri,fnrj,fn->fij", Jp, Jp, wt)
            B = jnp.einsum("fnri,fnrj,fn->fij", Jt, Jp, wt)
            g_t = jnp.einsum("fnri,fnr,fn->i", Jt, r, wt)
            g_p = jnp.einsum("fnri,fnr,fn->fi", Jp, r, wt)

            def try_step(lam):
                Ad = A + lam * jax.vmap(
                    lambda a: jnp.diag(jnp.maximum(jnp.diagonal(a), 1e-12))
                )(A)
                eye6 = jnp.eye(6, dtype=dtype)
                Ad = jnp.where(frame_valid[:, None, None] > 0, Ad, eye6)
                rhs_all = jnp.concatenate(
                    [jnp.swapaxes(B, 1, 2), g_p[..., None]], axis=2
                )
                sol = cholesky_solve_batched_small(Ad, rhs_all)
                Ainv_Bt = sol[..., :-1]
                Ainv_g = sol[..., -1]
                corr = jnp.einsum("fij,fjk->ik", B, Ainv_Bt)
                rhs_l = -(g_t - jnp.einsum("fik,fi->k", Ainv_Bt, g_p))
                packed = jnp.concatenate([U, corr, rhs_l[None, :]], axis=0)
                packed = jax.lax.psum(packed, FRAME_AXIS)
                U_tot, corr_t, rhs = packed[:k], packed[k : 2 * k], packed[2 * k]
                U_tot = U_tot + jnp.diag(1.0 - free)
                Ud = U_tot + lam * jnp.diag(
                    jnp.maximum(jnp.diagonal(U_tot), 1e-12)
                )
                S = Ud - corr_t
                Ls = jnp.linalg.cholesky(S)
                dth = jax.scipy.linalg.cho_solve((Ls, True), rhs)
                dth = jnp.where(jnp.isfinite(dth), dth, 0.0)
                dpo = -(Ainv_g + jnp.einsum("fik,k->fi", Ainv_Bt, dth))
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
            converged = accept & (
                cost - c_new <= opts.rtol * jnp.maximum(cost, 1e-300)
            )
            cost = jnp.where(accept, c_new, cost)
            rej = jnp.where(accept, 0, rej + 1)
            acc_any = acc_any | accept
            stall = rej >= jnp.where(
                acc_any, opts.max_rejects, 3 * opts.max_rejects
            )
            return (
                theta, poses, lam, cost, it + 1, done | converged | stall,
                rej, acc_any,
            )

        def cond(state):
            return (~state[5]) & (state[4] < max_iters)

        theta0 = jnp.clip(theta0, lo, hi)
        state = (
            theta0, poses0, jnp.asarray(opts.lam0, dtype),
            cost_of(theta0, poses0), 0, jnp.asarray(False),
            jnp.asarray(0), jnp.asarray(False),
        )
        theta, poses, _, cost, it, _, _, _ = jax.lax.while_loop(
            cond, body, state
        )
        return theta, poses, cost, it

    return solve


# --------------------------------------------------------------------------
# product entry point: sharded mixed-precision joint BA
# --------------------------------------------------------------------------


def multi_ba_sharded_mixed(
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
    huber_delta: float = 1.0,
    max_iters: int = 60,
    polish_iters: int = 10,  # matches ba_solve_multi_mixed
    mesh: Mesh | None = None,
    polish_jac_f32: bool = False,  # f64 J default: see ba_solve_multi_mixed
):
    """Frame-sharded, mixed-precision joint multi-camera BA over ALL
    visible devices — the multi-chip twin of ``solve.lm
    .ba_solve_multi_mixed`` that the CLI joint BA and bench_multicam route
    through when ``len(jax.devices()) > 1`` (single-chip callers keep the
    unsharded solver; semantics identical, one psum per LM iteration).

    Accepts the exact argument layout of ``ba_solve_multi`` with the frame
    axis unpadded; pads F to a mesh multiple (padding frames carry zero
    frame_valid/weight) and places the frame-axis arrays with the mesh
    sharding so each device owns a contiguous frame shard.

    Returns a ``MultiBAResult`` with poses cropped back to F.
    """
    from ..solve.lm import MultiBAResult
    import os

    env = os.environ.get("CCRS_POLISH_JAC32", "")
    if env == "0":
        polish_jac_f32 = False
    elif env == "1":
        polish_jac_f32 = True
    if mesh is None:
        mesh = make_mesh()
    D = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    F = poses0.shape[0]
    pad = (-F) % D
    if pad:
        poses0 = jnp.pad(poses0, ((0, pad), (0, 0)))
        frame_valid = jnp.pad(frame_valid, (0, pad))
        p2d = jnp.pad(p2d, ((0, 0), (0, pad), (0, 0), (0, 0)))
        w = jnp.pad(w, ((0, 0), (0, pad), (0, 0)))
        cam_frame_valid = jnp.pad(cam_frame_valid, ((0, 0), (0, pad)))
    sh_f = sharded_frame_sharding(mesh)
    sh_cf = NamedSharding(mesh, P(None, FRAME_AXIS))

    f32 = jnp.float32
    s1 = make_multi_ba_solver(
        project_fn, mesh, one_focal, huber_delta, max_iters, rtol=1e-6
    )(
        jnp.asarray(theta0, f32),
        jnp.asarray(ext0, f32),
        jax.device_put(jnp.asarray(poses0, f32), sh_f),
        jnp.asarray(p3d, f32),
        jax.device_put(jnp.asarray(p2d, f32), sh_cf),
        jax.device_put(jnp.asarray(w, f32), sh_cf),
        jnp.asarray(lo, f32),
        jnp.asarray(hi, f32),
        jnp.asarray(free, f32),
        jax.device_put(jnp.asarray(cam_frame_valid, f32), sh_cf),
        jax.device_put(jnp.asarray(frame_valid, f32), sh_f),
    )
    th1, ex1, po1, _, it1 = s1
    dt = theta0.dtype
    from ..solve.lm import polish_rtol

    s2 = make_multi_ba_solver(
        project_fn, mesh, one_focal, huber_delta, polish_iters,
        rtol=polish_rtol(), jac_f32=polish_jac_f32,
    )(
        jnp.asarray(th1, dt),
        jnp.asarray(ex1, dt),
        jnp.asarray(po1, dt),
        jnp.asarray(p3d, dt),
        jax.device_put(jnp.asarray(p2d, dt), sh_cf),
        jax.device_put(jnp.asarray(w, dt), sh_cf),
        jnp.asarray(lo, dt),
        jnp.asarray(hi, dt),
        jnp.asarray(free, dt),
        jax.device_put(jnp.asarray(cam_frame_valid, dt), sh_cf),
        jax.device_put(jnp.asarray(frame_valid, dt), sh_f),
    )
    th, ex, po, cost, it2 = s2
    return MultiBAResult(th, ex, po[:F], cost, it1 + it2)
