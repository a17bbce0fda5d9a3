"""Batched tag decoding: quad -> homography -> bit sampling -> code match.

All candidate quads of a frame batch decode in ONE jitted computation:
closed-form unit-square homographies (Heckbert), bilinear bit sampling,
local black/white photometric calibration from the tag's own border and
surrounding ring, and code matching as a single (Q, nbits) x (nbits, 4*ncodes)
matmul — hamming distance via the +-1 dot-product identity
(score = nbits - 2*hamming).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .families import TagFamily

MIN_DECODE_CONTRAST = 20.0


@jax.jit
def unsharp(images, amount: float = 1.2, sigma: float = 1.2):
    """Unsharp-mask a (B, H, W) f32 batch (separable 7-tap Gaussian).

    Used for DECODE BIT SAMPLING only: optical blur makes the ~3 px data
    cells of small/far tags bleed into each other and flips bits;
    sharpening recovered +67% tags on far-view synthetic tests.  Corner
    refinement keeps using the original image (sharpening adds gradient
    ringing that would bias subpixel corners).
    """
    r = jnp.arange(-3, 4, dtype=jnp.float32)
    k = jnp.exp(-(r * r) / (2.0 * sigma * sigma))
    k = k / jnp.sum(k)
    pad = [(0, 0), (3, 3), (3, 3)]
    x = jnp.pad(images, pad, mode="edge")
    # separable blur via shifted sums (7 taps per axis)
    rows = sum(k[i + 3] * x[:, 3 + i : x.shape[1] - 3 + i, :] for i in range(-3, 4))
    blur = sum(
        k[i + 3] * rows[:, :, 3 + i : rows.shape[2] - 3 + i] for i in range(-3, 4)
    )
    return images + amount * (images - blur)


def _unit_square_homography(quad):
    """Heckbert projective map from the unit square to a quad.

    quad: (4,2) corners ordered (0,0),(1,0),(1,1),(0,1) in traversal order.
    Returns H (3,3) with x = H @ (u,v,1).
    """
    x0, y0 = quad[0, 0], quad[0, 1]
    x1, y1 = quad[1, 0], quad[1, 1]
    x2, y2 = quad[2, 0], quad[2, 1]
    x3, y3 = quad[3, 0], quad[3, 1]
    sx = x0 - x1 + x2 - x3
    sy = y0 - y1 + y2 - y3
    dx1, dy1 = x1 - x2, y1 - y2
    dx2, dy2 = x3 - x2, y3 - y2
    den = dx1 * dy2 - dx2 * dy1
    den = jnp.where(jnp.abs(den) > 1e-12, den, 1e-12)
    g = (sx * dy2 - sy * dx2) / den
    h = (dx1 * sy - dy1 * sx) / den
    a = x1 - x0 + g * x1
    b = x3 - x0 + h * x3
    d = y1 - y0 + g * y1
    e = y3 - y0 + h * y3
    return jnp.array([[a, b, x0], [d, e, y0], [g, h, 1.0]])


def _apply_h(H, uv):
    """(3,3) x (n,2) -> (n,2)."""
    p = jnp.concatenate([uv, jnp.ones_like(uv[:, :1])], axis=1) @ H.T
    z = jnp.where(jnp.abs(p[:, 2:3]) > 1e-12, p[:, 2:3], 1e-12)
    return p[:, :2] / z


def _bilinear(img, xy):
    """Sample (H,W) image at (n,2) float (x,y) positions."""
    H, W = img.shape
    x = jnp.clip(xy[:, 0], 0.0, W - 1.001)
    y = jnp.clip(xy[:, 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def _sample_grids(family: TagFamily):
    """Static (unit-square) sample positions: data cells (3x3 subsamples
    each), black refs (inner border ring), white refs (outside the quad)."""
    T = family.total_size
    s = family.size
    b = family.border
    # data cells sampled on a 3x3 sub-grid (averaged at decode time)
    jj, ii = np.meshgrid(np.arange(s), np.arange(s))
    centers = np.stack([(b + jj).ravel(), (b + ii).ravel()], -1).astype(np.float64)
    sub = np.array([0.3, 0.5, 0.7])
    su, sv = np.meshgrid(sub, sub)
    subs = np.stack([su.ravel(), sv.ravel()], -1)  # (9,2)
    data_uv = ((centers[:, None, :] + subs[None, :, :]) / T).reshape(-1, 2)
    # black refs: ring just inside the data area (layer b-1), falls back to
    # layer 0 for border-1 families
    layer = b - 1
    ring = []
    for i in range(T):
        for j in range(T):
            if min(i, j, T - 1 - i, T - 1 - j) == layer:
                ring.append([(j + 0.5) / T, (i + 0.5) / T])
    black_uv = np.asarray(ring)
    # white refs: 0.75 cells outside each edge at 3 positions
    off = 0.75 / T
    white_uv = []
    for t in (0.25, 0.5, 0.75):
        white_uv += [
            [t, -off], [t, 1 + off], [-off, t], [1 + off, t],
        ]
    white_uv = np.asarray(white_uv)
    return (
        jnp.asarray(data_uv, dtype=jnp.float32),
        jnp.asarray(black_uv, dtype=jnp.float32),
        jnp.asarray(white_uv, dtype=jnp.float32),
    )


def _decode_core(family: TagFamily, images, quads, qframe, qvalid):
    """Decode a compact quad list (traceable; see decode_quads_compact).

    ``images`` must already be decode-ready (sharpened, f32)."""
    data_uv, black_uv, white_uv = _sample_grids(family)
    codes = jnp.asarray(family.rotated_codes, dtype=jnp.float32)
    nbits = codes.shape[1]
    B, H, W = images.shape
    flat = images.reshape(-1)

    def sample(qf, xy):
        x = jnp.clip(xy[:, 0], 0.0, W - 1.001)
        y = jnp.clip(xy[:, 1], 0.0, H - 1.001)
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = x - x0
        fy = y - y0
        base = qf * (H * W) + y0 * W + x0
        v00 = flat[base]
        v01 = flat[base + 1]
        v10 = flat[base + W]
        v11 = flat[base + W + 1]
        return (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )

    def per_quad(quad, qf):
        Hm = _unit_square_homography(quad)
        dpix = sample(qf, _apply_h(Hm, data_uv)).reshape(-1, 9).mean(axis=1)
        black = jnp.mean(sample(qf, _apply_h(Hm, black_uv)))
        white = jnp.mean(sample(qf, _apply_h(Hm, white_uv)))
        thr = 0.5 * (black + white)
        bits = jnp.where(dpix > thr, 1.0, -1.0)
        return bits, (white - black) > MIN_DECODE_CONTRAST

    bits, contrast_ok = jax.vmap(per_quad)(quads, qframe)  # (Q,nbits)
    # +-1 entries and <=64-term sums are EXACT at DEFAULT precision (TF32 on
    # the GPU: 10-bit mantissa, f32 accumulation), so this matmul opts out
    # of the package's global 'highest' precision (tests/test_gpu.py pins
    # the equality on the card)
    scores = jnp.matmul(bits, codes.T, precision=jax.lax.Precision.DEFAULT)
    best = jnp.argmax(scores, axis=1)
    hamming = ((nbits - scores[jnp.arange(bits.shape[0]), best]) / 2).astype(jnp.int32)
    tag_id = best // 4
    rotation = best % 4
    valid = qvalid & contrast_ok & (hamming <= family.max_hamming)
    kalibr_perm = jnp.asarray([1, 0, 3, 2])
    idx = (kalibr_perm[None, :] - rotation[:, None]) % 4
    corners = jnp.take_along_axis(quads, idx[..., None], axis=1)
    return {
        "tag_id": tag_id,
        "rotation": rotation,
        "hamming": hamming,
        "valid": valid,
        # exposed separately so id-matching callers (assist, tracking) can
        # apply a relaxed hamming budget without losing the contrast gate
        "contrast_ok": contrast_ok,
        "corners": corners,
    }


def _decode_core_dense(family: TagFamily, sharp, quads, qvalid):
    """Per-image dense decode: quads (B, M, 4, 2), qvalid (B, M).

    Same math as _decode_core, with every quad's samples gathered from its
    own frame (sample.sample_bilinear).  ``sharp`` must be decode-ready
    (sharpened, f32).  Returns the _decode_core dict with (B, M, ...)
    shapes.
    """
    from .sample import sample_bilinear

    data_uv, black_uv, white_uv = _sample_grids(family)
    codes = jnp.asarray(family.rotated_codes, dtype=jnp.float32)
    nbits = codes.shape[1]
    B, M = quads.shape[:2]
    n_data, n_black, n_white = (
        data_uv.shape[0], black_uv.shape[0], white_uv.shape[0],
    )
    all_uv = jnp.concatenate([data_uv, black_uv, white_uv], axis=0)

    def quad_pos(quad):
        return _apply_h(_unit_square_homography(quad), all_uv)

    pos = jax.vmap(jax.vmap(quad_pos))(quads)          # (B, M, S, 2)
    S = all_uv.shape[0]
    vals = sample_bilinear(
        sharp, pos[..., 0].reshape(B, M * S), pos[..., 1].reshape(B, M * S)
    ).reshape(B, M, S)
    dpix = vals[:, :, :n_data].reshape(B, M, -1, 9).mean(axis=3)
    black = vals[:, :, n_data : n_data + n_black].mean(axis=2)
    white = vals[:, :, n_data + n_black :].mean(axis=2)
    thr = 0.5 * (black + white)
    bits = jnp.where(dpix > thr[..., None], 1.0, -1.0)
    contrast_ok = (white - black) > MIN_DECODE_CONTRAST
    # +-1 entries, <=64-term sums: exact at DEFAULT precision (see
    # _decode_core)
    scores = jnp.matmul(
        bits.reshape(B * M, nbits), codes.T,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(B, M, -1)
    best = jnp.argmax(scores, axis=2)
    hamming = (
        (nbits - jnp.take_along_axis(scores, best[..., None], axis=2)[..., 0])
        / 2
    ).astype(jnp.int32)
    tag_id = best // 4
    rotation = best % 4
    valid = qvalid & contrast_ok & (hamming <= family.max_hamming)
    kalibr_perm = jnp.asarray([1, 0, 3, 2])
    idx = (kalibr_perm[None, None, :] - rotation[..., None]) % 4
    corners = jnp.take_along_axis(quads, idx[..., None], axis=2)
    return {
        "tag_id": tag_id,
        "rotation": rotation,
        "hamming": hamming,
        "valid": valid,
        "contrast_ok": contrast_ok,
        "corners": corners,
    }


@partial(jax.jit, static_argnames=("family",))
def decode_quads_compact(family: TagFamily, images, quads, qframe, qvalid):
    """Decode a COMPACT quad list (padded to a static bucket size).

    A per-frame (B, K) layout would waste most of its rows on padding (K
    sized for the worst frame); compacting to (Q, 4, 2) + frame indices
    cuts the gather-bound bit sampling ~3x.

    Args:
      images: (B, H, W) f32, already sharpened for bit sampling (unsharp).
      quads: (Q, 4, 2) corners; rows past the real count are padding.
      qframe: (Q,) int32 frame index per quad.
      qvalid: (Q,) bool padding mask.

    Returns dict of (Q,) tag_id / rotation / hamming / valid and (Q, 4, 2)
    canonical corners (corner 0 = tag's canonical top-left, board corner
    id tag*4+0; see the KALIBR_PERM note in _decode_core).
    """
    return _decode_core(family, images, quads, qframe, qvalid)


@partial(jax.jit, static_argnames=("family", "do_refine"))
def refine_decode_fused_dense(
    family: TagFamily, images, quads, qvalid, do_refine: bool = True,
    sharp=None, maps=None,
):
    """Dense-layout fused refine+decode: quads (B, M, 4, 2), qvalid (B, M).

    The cold pipeline's successor to refine_decode_fused: per-frame dense
    quad buffers let all sampling run per image over whole-image maps
    (sample.py) instead of over per-corner patches.

    ``sharp`` / ``maps`` reuse the previous call's device-resident
    sharpened frames and KLT maps (the board-assist pass runs on the same
    chunk).  Returns the _decode_core_dense dict plus "sharp" and "maps".
    """
    from .sample import build_klt_maps, refine_corners_maps, unsharp_batch

    images = images.astype(jnp.float32)
    B, M = quads.shape[:2]
    if do_refine:
        if maps is None:
            maps = build_klt_maps(images)
        quads = refine_corners_maps(
            maps, quads.reshape(B, M * 4, 2)
        ).reshape(B, M, 4, 2)
    if sharp is None:
        sharp = unsharp_batch(images)
    out = _decode_core_dense(family, sharp, quads, qvalid)
    out["sharp"] = sharp
    out["maps"] = maps
    return out


@partial(jax.jit, static_argnames=("family", "do_refine"))
def refine_decode_fused(
    family: TagFamily, images, quads, qframe, qvalid, do_refine: bool = True,
    sharp=None,
):
    """ONE device graph for the whole post-threshold detect path:
    patch gather -> subpixel corner refine -> unsharp -> bit-sample decode.

    The detector's former sequence — download patches, host subpixel
    refine, upload refined quads, decode — cost 3+ synchronous host round
    trips per chunk.  Fusing everything into one jit leaves a single
    dispatch whose only downloads are the (Q,)-sized decode outputs.

    Args:
      images: (B, H, W) uint8/f32 ORIGINAL (un-sharpened) frames; corner
        refinement samples these directly.
      quads / qframe / qvalid: compact candidate list as in
        decode_quads_compact.
      sharp: optional pre-sharpened (B, H, W) f32 frames for the decode
        bit sampling — pass the previous call's ``out["sharp"]`` (a
        device-resident array) so a follow-up decode on the same chunk
        (the board-assist pass) skips recomputing the unsharp mask.

    Returns the decode dict plus "sharp": the sharpened frames (device
    array; not downloaded unless fetched).
    """
    from .patches import extract_patches
    from .refine import refine_patches_2stage

    images = images.astype(jnp.float32)
    if do_refine:
        corners = quads.reshape(-1, 2)
        cframe = jnp.repeat(qframe.astype(jnp.int32), 4)
        patches, local, offset = extract_patches(images, corners, cframe)
        refined = refine_patches_2stage(patches, local) + offset
        quads = refined.reshape(quads.shape)
    if sharp is None:
        sharp = unsharp(images)
    out = _decode_core(family, sharp, quads, qframe, qvalid)
    out["sharp"] = sharp
    return out
