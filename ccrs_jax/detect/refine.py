"""Batched subpixel corner refinement.

The final detector stage (the reference's subpixel corner refine,
SURVEY.md §2.2 "aprilgrid"): every detected tag corner in the frame batch
refines simultaneously with a fixed-iteration cornerSubPix-style scheme —
at the saddle/corner point q, for every window pixel p:
``gradI(p) . (p - q) = 0`` weighted least squares, i.e.
``(sum w G) q = sum w G p`` with ``G = gradI gradI^T``.  One 2x2 closed-form
solve per corner per iteration; gathers are bilinear samples off the
precomputed gradient images.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Half-window 3 (7x7): measured on 512^2 EUCM synthetic (small ~25 px
# tags, noise 1.5), re-refining ground-truth corners: win=4 drags corners
# toward foreign structure (neighboring data-cell edges inside the window)
# with p95 error 1.25 px and a drifting attractor under repeated
# refinement (p95 1.5, max 4.5 px after 6 re-refines — which the tracking
# fast path applies frame over frame); win=3 is unbiased AND
# iteration-stable (p95 0.23 px both single and re-refined).
WIN = 3
#: capture radius (total-shift clamp) stays at 4 px, decoupled from the
#: window: CCL quad corners start up to ~4 px off on the pyramid path
MAX_SHIFT = 4.0
# 10 iterations: the 1 px/iter step clamp needs ~4 to cross a CCL quad's
# corner bias, then fast linear polish — 6 left a measurable
# init-dependent residual (tracked-vs-cold corners differed by ~0.07 px).
# Each extra iteration is one 4-gather bilinear sample + a 2x2 solve.
ITERS = 10


def _grad(images):
    """Central-difference gradients, (B,H,W) -> (gx, gy)."""
    gx = jnp.zeros_like(images)
    gy = jnp.zeros_like(images)
    gx = gx.at[:, :, 1:-1].set((images[:, :, 2:] - images[:, :, :-2]) * 0.5)
    gy = gy.at[:, 1:-1, :].set((images[:, 2:, :] - images[:, :-2, :]) * 0.5)
    return gx, gy


def _bilinear(img, x, y):
    H, W = img.shape
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx, fy = x - x0, y - y0
    return (
        img[y0, x0] * (1 - fx) * (1 - fy)
        + img[y0, x0 + 1] * fx * (1 - fy)
        + img[y0 + 1, x0] * (1 - fx) * fy
        + img[y0 + 1, x0 + 1] * fx * fy
    )


def _sep_corr(maps, kx, ky):
    """Separable 'SAME' correlation over the last two dims of (N, P, P)
    with zero padding; kx/ky are 1-D taps of length 2*win+1."""
    win = (kx.shape[0] - 1) // 2
    P = maps.shape[-1]
    x = jnp.pad(maps, [(0, 0), (win, win), (win, win)])
    rows = sum(ky[k] * x[:, k : k + P, :] for k in range(2 * win + 1))
    return sum(kx[k] * rows[:, :, k : k + P] for k in range(2 * win + 1))


def refine_patches(
    patches, local, win: int = WIN, iters: int = ITERS,
    max_shift: float = MAX_SHIFT,
):
    """Patch-based subpixel refinement, fully on device.

    Same fixed point as ``refine_corners``'s cornerSubPix iteration —
    ``(sum w G) q = sum w G p`` over the Gaussian window — but formulated
    KLT-style for batched devices: the window sums are CONVOLUTIONS of the
    gradient-product maps (gx^2, gx*gy, gy^2) with the (separable)
    Gaussian kernel, computed ONCE per patch as dense shifted adds.  With
    p = q + o the right-hand side splits as

      bx(q) = qx*A(q) + qy*B(q) + [gx^2 (*) w*ox](q) + [gxgy (*) w*oy](q)
      by(q) = qx*B(q) + qy*D(q) + [gxgy (*) w*ox](q) + [gy^2 (*) w*oy](q)

    so each Newton iteration only bilinearly samples 7 precomputed maps at
    the current center (one tiny gather) and solves the 2x2 — no
    per-iteration 81-point window gathers.  (Smoothing the products before
    interpolation is the standard KLT/structure-tensor discretization; it
    agrees with the native kernel to well under the detector's noise
    floor — see tests/test_native_refine.py.)

    Traceable (no jit here) so it fuses into the caller's graph
    (decode.refine_decode_fused).

    Args:
      patches: (N, P, P) float32.
      local: (N, 2) float32 patch-local (x, y) estimates.

    Returns (N, 2) refined patch-local positions (per-iteration step
    clamped to 1 px, total shift clamped to the window radius).
    """
    N, P, _ = patches.shape
    gx = jnp.zeros_like(patches)
    gy = jnp.zeros_like(patches)
    gx = gx.at[:, :, 1:-1].set((patches[:, :, 2:] - patches[:, :, :-2]) * 0.5)
    gy = gy.at[:, 1:-1, :].set((patches[:, 2:, :] - patches[:, :-2, :]) * 0.5)

    offs = jnp.arange(-win, win + 1, dtype=patches.dtype)
    g = jnp.exp(-(offs * offs) / (2.0 * (win / 2.0) ** 2))
    go = g * offs  # first-moment taps

    gxx = gx * gx
    gxy = gx * gy
    gyy = gy * gy
    maps = jnp.stack(
        [
            _sep_corr(gxx, g, g),  # A
            _sep_corr(gxy, g, g),  # B
            _sep_corr(gyy, g, g),  # D
            _sep_corr(gxx, go, g),  # sum w*ox*gx^2
            _sep_corr(gxy, g, go),  # sum w*oy*gx*gy
            _sep_corr(gxy, go, g),  # sum w*ox*gx*gy
            _sep_corr(gyy, g, go),  # sum w*oy*gy^2
        ],
        axis=1,
    ).reshape(N, 7, P * P)

    def bsample7(x, y):
        x = jnp.clip(x, 0.0, P - 1.001)
        y = jnp.clip(y, 0.0, P - 1.001)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = (x - x0).astype(maps.dtype)[:, None]
        fy = (y - y0).astype(maps.dtype)[:, None]
        base = (y0 * P + x0)[:, None, None]
        idx = jnp.concatenate(
            [base, base + 1, base + P, base + P + 1], axis=2
        )  # (N, 1, 4)
        v = jnp.take_along_axis(maps, jnp.broadcast_to(idx, (N, 7, 4)), axis=2)
        w = jnp.stack(
            [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy], axis=2
        )  # (N, 1, 4)
        return jnp.sum(v * w, axis=2)  # (N, 7)

    def step(c, _):
        qx, qy = c[:, 0], c[:, 1]
        m = bsample7(qx, qy)
        a, b, d = m[:, 0], m[:, 1], m[:, 2]
        bx = qx * a + qy * b + m[:, 3] + m[:, 4]
        by = qx * b + qy * d + m[:, 5] + m[:, 6]
        det = a * d - b * b
        det = jnp.where(jnp.abs(det) > 1e-9, det, 1e-9)
        nx = (d * bx - b * by) / det
        ny = (a * by - b * bx) / det
        dx = jnp.clip(nx - qx, -1.0, 1.0)
        dy = jnp.clip(ny - qy, -1.0, 1.0)
        return jnp.stack([qx + dx, qy + dy], axis=1), None

    refined, _ = jax.lax.scan(step, local, None, length=iters)
    total = refined - local
    norm = jnp.linalg.norm(total, axis=1, keepdims=True)
    scale = jnp.minimum(1.0, max_shift / jnp.maximum(norm, 1e-9))
    return local + total * scale


def refine_patches_2stage(patches, local):
    """Capture-and-polish refinement used by the fused decode graphs.

    Measured (512^2 EUCM synthetic, small tags, noise 1.5): win=3 with
    extra iterations dominates win=4 at EVERY start offset (off 2.5 px:
    94% of corners land within 0.5 px, p95 0.62 vs win=4's 88%/1.55 —
    the 9x9 window's attractor is biased by neighboring cell edges), and
    an actual win=4 pre-stage made things worse (its wrong attractors
    strand corners outside the polish basin).  So: one unbiased stage,
    12 iterations, capture clamp 4.5 px.
    """
    return refine_patches(patches, local, win=3, iters=12, max_shift=4.5)


@partial(jax.jit, static_argnames=("win", "iters"))
def refine_corners(images, corners, win: int = WIN, iters: int = ITERS):
    """Refine corners to subpixel accuracy.

    Args:
      images: (B, H, W) float32 grayscale.
      corners: (B, M, 2) float32 initial (x, y) estimates.

    Returns (B, M, 2) refined positions (per-iteration shift clamped to
    1 px; total shift clamped to max(win, MAX_SHIFT) px so divergent
    corners stay near their initial estimate).
    """
    gx, gy = _grad(images)
    offs = jnp.arange(-win, win + 1, dtype=images.dtype)
    oy, ox = jnp.meshgrid(offs, offs, indexing="ij")
    ox = ox.reshape(-1)
    oy = oy.reshape(-1)
    # Gaussian window like cornerSubPix
    wgt = jnp.exp(-(ox * ox + oy * oy) / (2.0 * (win / 2.0) ** 2))

    def per_image(gx_i, gy_i, corners_i):
        def step(c, _):
            x = c[:, 0:1] + ox[None, :]
            y = c[:, 1:2] + oy[None, :]
            gxs = jax.vmap(lambda xv, yv: _bilinear(gx_i, xv, yv))(x, y)
            gys = jax.vmap(lambda xv, yv: _bilinear(gy_i, xv, yv))(x, y)
            w = wgt[None, :]
            a = jnp.sum(w * gxs * gxs, axis=1)
            b = jnp.sum(w * gxs * gys, axis=1)
            d = jnp.sum(w * gys * gys, axis=1)
            bx = jnp.sum(w * (gxs * gxs * x + gxs * gys * y), axis=1)
            by = jnp.sum(w * (gxs * gys * x + gys * gys * y), axis=1)
            det = a * d - b * b
            det = jnp.where(jnp.abs(det) > 1e-9, det, 1e-9)
            qx = (d * bx - b * by) / det
            qy = (a * by - b * bx) / det
            dx = jnp.clip(qx - c[:, 0], -1.0, 1.0)
            dy = jnp.clip(qy - c[:, 1], -1.0, 1.0)
            return jnp.stack([c[:, 0] + dx, c[:, 1] + dy], axis=1), None

        refined, _ = jax.lax.scan(step, corners_i, None, length=iters)
        total = refined - corners_i
        norm = jnp.linalg.norm(total, axis=1, keepdims=True)
        shift_cap = max(float(win), MAX_SHIFT)
        scale = jnp.minimum(1.0, shift_cap / jnp.maximum(norm, 1e-9))
        return corners_i + total * scale

    return jax.vmap(per_image)(gx, gy, corners)
