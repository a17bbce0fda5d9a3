"""Whole-image sampling kernels of the detector: tap-loop convolutions and
4-tap bilinear gathers in plain jnp, which XLA fuses.

- ``unsharp_batch``: the decode unsharp mask (separable 7-tap blur);
- ``build_klt_maps``: the 7 structure-tensor maps of the cornerSubPix-style
  refine, as separable windowed sums over the full image;
- ``refine_corners_maps``: the refine's Newton iteration, sampling those
  maps at each corner with 4-tap bilinear gathers;
- ``sample_bilinear``: per-image bilinear sampling (decode bit sampling).

On an H100 this formulation beat the former one (every gather recast as a
banded or hat-weight bf16 matmul) by 3.9x on the fused refine+decode at the
tracking-wave shape, 72 x 512 x 512 with 10,368 corners (PERF.md), and the
bf16 weights moved corners by up to 5.7e-3 px; so there is one formulation
on every backend.

Reference parity: these kernels compute the same cornerSubPix-style
refinement as the reference's aprilgrid crate dependency (subpixel corner
refine) and the same homography bit sampling as its tag decoder.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: refine window parameters — same fixed point as refine.refine_patches
#: (win=3 Gaussian, measured unbiased + iteration-stable; see refine.py)
WIN = 3
MAX_SHIFT = 4.5
ITERS = 12

_offs = np.arange(-WIN, WIN + 1, dtype=np.float32)
_G_TAPS = np.exp(-(_offs * _offs) / (2.0 * (WIN / 2.0) ** 2)).astype(np.float32)
_GO_TAPS = (_G_TAPS * _offs).astype(np.float32)

_r = np.arange(-3, 4, dtype=np.float32)
_BLUR_TAPS = np.exp(-(_r * _r) / (2.0 * 1.2 * 1.2)).astype(np.float32)
_BLUR_TAPS /= _BLUR_TAPS.sum()


def _tap_corr(x, taps: np.ndarray, axis: int, edge: bool):
    """out[u] = sum_t taps[t+R] x[u + t] along ``axis``, with replicate
    (edge=True) or zero (edge=False) boundary."""
    R = (len(taps) - 1) // 2
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (R, R)
    xp = jnp.pad(x, pad, mode="edge" if edge else "constant")
    out = None
    for i, w in enumerate(taps):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, i + n)
        term = float(w) * xp[tuple(sl)]
        out = term if out is None else out + term
    return out


def unsharp_batch(images, amount: float = 1.2):
    """decode.unsharp over a (B, H, W) batch (separable 7-tap blur with
    replicate boundary).  Traceable."""
    images = images.astype(jnp.float32)
    blur = _tap_corr(_tap_corr(images, _BLUR_TAPS, 1, True), _BLUR_TAPS, 2, True)
    return images + amount * (images - blur)


def build_klt_maps(images):
    """The 7 structure-tensor maps of refine.refine_patches, on the FULL
    image: A=w(*)gx^2, B=w(*)gxgy, D=w(*)gy^2, and the four first-moment
    maps (w*ox*gx^2, w*oy*gxgy, w*ox*gxgy, w*oy*gy^2).

    Returns (B, 7, H, W) float32.  Windowed sums use zero boundary
    handling, matching the patch version's zero-padded _sep_corr.
    """
    f = images.astype(jnp.float32)
    gx = jnp.zeros_like(f)
    gy = jnp.zeros_like(f)
    gx = gx.at[:, :, 1:-1].set((f[:, :, 2:] - f[:, :, :-2]) * 0.5)
    gy = gy.at[:, 1:-1, :].set((f[:, 2:, :] - f[:, :-2, :]) * 0.5)
    gxx = gx * gx
    gxy = gx * gy
    gyy = gy * gy

    def cy(x, taps):
        return _tap_corr(x, taps, 1, False)

    def cx(x, taps):
        return _tap_corr(x, taps, 2, False)

    # y (row) pass once per (source, ky) pair, then x (col) passes
    gxx_g = cy(gxx, _G_TAPS)
    gxy_g = cy(gxy, _G_TAPS)
    gyy_g = cy(gyy, _G_TAPS)
    gxy_go = cy(gxy, _GO_TAPS)
    gyy_go = cy(gyy, _GO_TAPS)
    return jnp.stack(
        [
            cx(gxx_g, _G_TAPS),    # A
            cx(gxy_g, _G_TAPS),    # B
            cx(gyy_g, _G_TAPS),    # D
            cx(gxx_g, _GO_TAPS),   # sum w*ox*gx^2
            cx(gxy_go, _G_TAPS),   # sum w*oy*gx*gy
            cx(gxy_g, _GO_TAPS),   # sum w*ox*gx*gy
            cx(gyy_go, _G_TAPS),   # sum w*oy*gy^2
        ],
        axis=1,
    )


def _floor_taps(x, y, H: int, W: int):
    """Bilinear-tap indices and fractions, positions clipped to the image."""
    x = jnp.clip(x, 0.0, W - 1.001)
    y = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    return x0, y0, x - x0, y - y0


def _sample_maps(maps, qx, qy):
    """Bilinear-gather the 7 maps at (B, M) points: (B, C, H, W) ->
    (B, M, C)."""
    B, C, H, W = maps.shape
    x0, y0, fx, fy = _floor_taps(qx, qy, H, W)

    def tap(dy, dx):
        return jax.vmap(lambda m, yy, xx: m[:, yy, xx])(
            maps, y0 + dy, x0 + dx
        )  # (B, C, M)

    v = (
        tap(0, 0) * ((1 - fy) * (1 - fx))[:, None, :]
        + tap(0, 1) * ((1 - fy) * fx)[:, None, :]
        + tap(1, 0) * (fy * (1 - fx))[:, None, :]
        + tap(1, 1) * (fy * fx)[:, None, :]
    )
    return jnp.swapaxes(v, 1, 2).astype(jnp.float32)


def refine_corners_maps(maps, corners, iters: int = ITERS,
                        max_shift: float = MAX_SHIFT):
    """Subpixel-refine corners against precomputed KLT maps.

    Same Newton iteration as refine.refine_patches (1 px/iter step clamp,
    total-shift clamp) but sampling the 7 full-image maps instead of
    per-corner patches.  Traceable.

    Args:
      maps: (B, 7, H, W) from build_klt_maps.
      corners: (B, M, 2) float32 (x, y) starts.

    Returns (B, M, 2) refined corners.
    """

    def step(c, _):
        qx, qy = c[..., 0], c[..., 1]
        m = _sample_maps(maps, qx, qy)
        a, b, d = m[..., 0], m[..., 1], m[..., 2]
        bxv = qx * a + qy * b + m[..., 3] + m[..., 4]
        byv = qx * b + qy * d + m[..., 5] + m[..., 6]
        det = a * d - b * b
        det = jnp.where(jnp.abs(det) > 1e-9, det, 1e-9)
        nx = (d * bxv - b * byv) / det
        ny = (a * byv - b * bxv) / det
        dx = jnp.clip(nx - qx, -1.0, 1.0)
        dy = jnp.clip(ny - qy, -1.0, 1.0)
        return jnp.stack([qx + dx, qy + dy], axis=-1), None

    refined, _ = jax.lax.scan(step, corners, None, length=iters)
    total = refined - corners
    norm = jnp.linalg.norm(total, axis=-1, keepdims=True)
    scale = jnp.minimum(1.0, max_shift / jnp.maximum(norm, 1e-9))
    return corners + total * scale


def sample_bilinear(images, sx, sy):
    """Bilinear-sample (B, H, W) images at per-image positions (B, K):
    out[b, k] = bilinear(images[b], sx[b, k], sy[b, k]), positions
    clipped to the image.  Traceable."""
    B, H, W = images.shape
    f = images.astype(jnp.float32)
    x0, y0, fx, fy = _floor_taps(sx, sy, H, W)

    def tap(dy, dx):
        return jax.vmap(lambda img, yy, xx: img[yy, xx])(f, y0 + dy, x0 + dx)

    return (
        tap(0, 0) * (1 - fy) * (1 - fx)
        + tap(0, 1) * (1 - fy) * fx
        + tap(1, 0) * fy * (1 - fx)
        + tap(1, 1) * fy * fx
    )
