"""On-device quad extraction: connected components + corner recovery in XLA.

An all-device alternative to the native C++ quad extraction stage
(``ccrs_jax/native/quadproc.cpp``; reference analogue: the `aprilgrid`
crate's quad detector, SURVEY.md §2.2): everything runs as dense,
static-shape array ops so the thresholded bitmaps never leave the device.

Algorithm (per binary image, batched over frames):

1. **Labeling** — every dark pixel starts with label = its row-major
   index; labels relax to the component MINIMUM by alternating
   row/column SEGMENTED min-scans (``lax.associative_scan`` with
   Blelloch start-flag resets, forward + backward per axis).  Each
   alternation is O(log W) depth and fully vectorized; solid blobs
   (AprilTag squares) converge in ~2 alternations and hollow shells
   (large low-contrast-cored tags) in ~3; the loop runs a fixed
   ``n_sweeps``.  Junk shapes that fail to converge yield split
   components whose fragments the decoder rejects — exactly the
   reference's "the decoder is the real junk filter" stance.
2. **Extreme points** — for D directions (every 180/D degrees) and both
   signs, each dark pixel's (projection, perpendicular) coordinates are
   packed into one int32 (13+13 bits at half-pixel resolution) and the
   same segmented-MAX sweeps propagate the per-component extreme.  After
   convergence every dark pixel knows its component's 2D convex-hull
   touchpoints, in angular order.
3. **Roots & compaction** — the pixel whose index equals its label is the
   component root; per-frame ``top_k`` over root scores (bbox-filtered:
   size/aspect/border, from the axis-aligned extremes) compacts
   candidates to a static K-slot table.
4. **Corners** — per candidate, the best 4 of the 2D touchpoints are
   chosen by maximum quadrilateral area over the static C(2D,4) index
   table (touchpoints are hull points in angular order, so the winner is
   convex); validity mirrors quadproc.cpp's checks (min area, area vs
   bbox, border).

Corner positions land within ~1 px of the C++ contour/line-fit corners;
the downstream structure-tensor subpixel refinement (detect/refine.py)
absorbs that before decode.  Extreme-point packing centers coordinates on
the image midpoint, so images with sqrt(W^2 + H^2) < 4096 are supported
(2048 px a side included; the packing asserts statically).

STATUS — experimental, not the default detect path: the host path
(packed-bitmap download + native C++ CCL) is the default.  Its speed on
the GPU is not measured yet (ROADMAP design item 3).  Equivalence with the
C++ extractor is pinned by tests/test_ccl.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_COORD_BITS = 13
_COORD_BIAS = 1 << (_COORD_BITS - 1)  # 4096
_PACK = jnp.int32(1 << _COORD_BITS)


def _seg_scan_axis(vals, black, axis, combine_max: bool):
    """Segmented fwd+bwd scan along ``axis``: within each contiguous run of
    dark pixels, every element receives the run's max (min) of ``vals``.

    Blelloch segmented scan: pairs (value, has_start); ``has_start`` marks
    spans containing a segment boundary, so left context stops there.
    White pixels are their own (neutral-valued) segments.
    """
    axis = axis % vals.ndim  # lax.rev (reverse=True) rejects negative axes
    info = jnp.iinfo(jnp.int32)
    neutral = info.min if combine_max else info.max
    v = jnp.where(black, vals, neutral)
    reduce_ = jnp.maximum if combine_max else jnp.minimum

    def op(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, reduce_(av, bv)), af | bf

    def shifted(arr, delta):
        # black[i - delta] with False out of range, along `axis`
        # (delta=+1 -> left neighbor, delta=-1 -> right neighbor)
        pad = [(0, 0)] * arr.ndim
        if delta == 1:
            pad[axis] = (1, 0)
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(0, arr.shape[axis])
            return jnp.pad(arr, pad)[tuple(sl)]
        pad[axis] = (0, 1)
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(1, arr.shape[axis] + 1)
        return jnp.pad(arr, pad)[tuple(sl)]

    # forward: a dark pixel starts a segment iff its left neighbor is white
    start_f = (~black) | (black & ~shifted(black, 1))
    fwd, _ = jax.lax.associative_scan(op, (v, start_f), axis=axis)
    # backward: starts iff right neighbor is white
    start_b = (~black) | (black & ~shifted(black, -1))
    bwd, _ = jax.lax.associative_scan(op, (v, start_b), axis=axis, reverse=True)
    out = reduce_(fwd, bwd)
    return jnp.where(black, out, vals)


def _sweep(vals, black, combine_max: bool, n_sweeps: int):
    """Alternate row/column segmented scans (fixed sweep count)."""

    def body(_, v):
        v = _seg_scan_axis(v, black, axis=-1, combine_max=combine_max)
        v = _seg_scan_axis(v, black, axis=-2, combine_max=combine_max)
        return v

    return jax.lax.fori_loop(0, n_sweeps, body, vals)


@partial(jax.jit, static_argnames=("n_sweeps",))
def label_components(binary, n_sweeps: int = 6):
    """4-connected labeling of dark pixels.

    Args:
      binary: (B, H, W) uint8/bool, nonzero = white background.

    Returns int32 (B, H, W): for dark pixels, the component's minimum
    row-major pixel index; for white pixels, H*W.
    """
    B, H, W = binary.shape
    black = binary == 0
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(1, H, W)
    idx = jnp.broadcast_to(idx, (B, H, W))
    labels = jnp.where(black, idx, H * W)
    labels = _sweep(labels, black, combine_max=False, n_sweeps=n_sweeps)
    return jnp.where(black, labels, H * W)


def _quad_index_table(n_pts: int):
    """Static C(n,4) index table (i<j<k<l) for max-area corner selection."""
    from itertools import combinations

    return np.asarray(list(combinations(range(n_pts), 4)), np.int32)


@partial(
    jax.jit,
    static_argnames=("max_quads", "n_dirs", "n_sweeps", "min_side", "min_area"),
)
def extract_quads_device(
    binary,
    max_quads: int = 64,
    n_dirs: int = 8,
    n_sweeps: int = 6,
    min_side: int = 4,
    min_area: int = 25,
):
    """Candidate dark quads from a batch of binary images, fully on device.

    Args:
      binary: (B, H, W) uint8 {0,1}, 1 = white (as adaptive_threshold
        emits).
      max_quads: static per-frame candidate capacity.

    Returns:
      quads: (B, max_quads, 4, 2) float32 corners, clockwise in image
        coordinates (y down), arbitrary starting corner.
      valid: (B, max_quads) bool.
    """
    B, H, W = binary.shape
    n_pix = H * W
    # packing budget: coordinates are CENTERED on the image midpoint before
    # projecting, so proj/perp at half-pixel resolution are bounded by
    # sqrt(W^2 + H^2), which must fit the signed 13-bit field (+-4096) —
    # i.e. true support up to ~2896 px a side (2048 included).  The +0.5
    # covers jnp.round: a projection in (4095.5, 4096) would round to
    # 4096 and carry into the neighboring packed field.
    assert (W * W + H * H) ** 0.5 + 0.5 < _COORD_BIAS, (
        "image too large for int32 extreme packing"
    )
    black = binary == 0
    idx = jnp.broadcast_to(
        jnp.arange(n_pix, dtype=jnp.int32).reshape(1, H, W), (B, H, W)
    )

    # ---- 1. labels -------------------------------------------------------
    labels = jnp.where(black, idx, n_pix)
    labels = _sweep(labels, black, combine_max=False, n_sweeps=n_sweeps)
    is_root = black & (labels == idx)

    # ---- 2. extreme points in 2*n_dirs directions ------------------------
    W2, H2 = W / 2.0, H / 2.0  # center to halve the packed range
    ys = (idx // W).astype(jnp.float32) - H2
    xs = (idx % W).astype(jnp.float32) - W2
    angles = np.pi * np.arange(n_dirs) / n_dirs
    packed = []
    for a in angles:
        c, s = float(np.cos(a)), float(np.sin(a))
        proj = jnp.round(2.0 * (xs * c + ys * s)).astype(jnp.int32)
        perp = jnp.round(2.0 * (-xs * s + ys * c)).astype(jnp.int32)
        perp_b = perp + _COORD_BIAS  # >= 0
        for sign in (1, -1):
            packed.append((sign * proj + _COORD_BIAS) * _PACK + perp_b)
    packed = jnp.stack(packed, axis=1)  # (B, 2D, H, W), angular pairs (+,-)
    blk = jnp.broadcast_to(black[:, None], packed.shape)
    ext = _sweep(packed, blk, combine_max=True, n_sweeps=n_sweeps)

    # unpack to (x, y) per direction channel
    perp_u = (ext % _PACK) - _COORD_BIAS
    proj_u = (ext // _PACK) - _COORD_BIAS
    ch = 0
    ex_list, ey_list, pmax = [], [], {}
    for d, a in enumerate(angles):
        c, s = float(np.cos(a)), float(np.sin(a))
        for sign in (1, -1):
            pr = (sign * proj_u[:, ch]).astype(jnp.float32) * 0.5
            pe = perp_u[:, ch].astype(jnp.float32) * 0.5
            ex_list.append(pr * c - pe * s + W2)  # un-center
            ey_list.append(pr * s + pe * c + H2)
            pmax[(d, sign)] = pr
            ch += 1
    exs = jnp.stack(ex_list, axis=1)  # (B, 2D, H, W)
    eys = jnp.stack(ey_list, axis=1)

    # ---- 3. roots + per-frame compaction ---------------------------------
    # bbox from the axis-aligned channels: dir 0 = x, dir D/2 = y
    # (pmax[(d, -1)] already holds the MIN projection: the -1 channel
    # propagates max(-proj) and pr multiplies the sign back)
    xmax, xmin = pmax[(0, 1)] + W2, pmax[(0, -1)] + W2  # back to image coords
    d_y = n_dirs // 2
    ymax, ymin = pmax[(d_y, 1)] + H2, pmax[(d_y, -1)] + H2
    bw = xmax - xmin + 1.0
    bh = ymax - ymin + 1.0
    aspect = jnp.maximum(bw / jnp.maximum(bh, 1e-6), bh / jnp.maximum(bw, 1e-6))
    ok_geom = (
        (bw >= min_side)
        & (bh >= min_side)
        & (aspect <= 12.0)
        & (xmin >= 1)
        & (ymin >= 1)
        & (xmax <= W - 2)
        & (ymax <= H - 2)
    )
    score = jnp.where(is_root & ok_geom, bw * bh, 0.0).reshape(B, n_pix)
    top_scores, top_idx = jax.lax.top_k(score, max_quads)  # (B, K)
    slot_valid = top_scores > 0.0

    # gather each candidate's 2D touchpoints, reordered to angular sequence
    # (+d0, +d1, ..., +d(D-1), -d0, -d1, ...)
    order = np.concatenate(
        [np.arange(0, 2 * n_dirs, 2), np.arange(1, 2 * n_dirs, 2)]
    )
    exf = exs.reshape(B, 2 * n_dirs, n_pix)[:, order]
    eyf = eys.reshape(B, 2 * n_dirs, n_pix)[:, order]
    cx = jnp.take_along_axis(exf, top_idx[:, None, :], axis=2)  # (B, 2D, K)
    cy = jnp.take_along_axis(eyf, top_idx[:, None, :], axis=2)
    pts = jnp.stack([cx, cy], axis=-1).transpose(0, 2, 1, 3)  # (B, K, 2D, 2)

    # ---- 4. max-area quadrilateral over the hull touchpoints -------------
    combos = jnp.asarray(_quad_index_table(2 * n_dirs))  # (M, 4)
    p_sel = pts[:, :, combos, :]  # (B, K, M, 4, 2)
    x = p_sel[..., 0]
    y = p_sel[..., 1]
    area2 = jnp.sum(
        x * jnp.roll(y, -1, axis=-1) - jnp.roll(x, -1, axis=-1) * y, axis=-1
    )
    best = jnp.argmax(jnp.abs(area2), axis=-1)  # (B, K)
    quad = jnp.take_along_axis(p_sel, best[:, :, None, None, None], axis=2)[
        :, :, 0
    ]  # (B, K, 4, 2)
    best_area2 = jnp.take_along_axis(area2, best[:, :, None], axis=2)[..., 0]

    # clockwise in image coords (positive shoelace with y down)
    quad = jnp.where((best_area2 < 0)[..., None, None], quad[:, :, ::-1], quad)

    bbox_area = jnp.take_along_axis((bw * bh).reshape(B, n_pix), top_idx, axis=1)
    qa = 0.5 * jnp.abs(best_area2)
    valid = slot_valid & (qa >= 0.3 * bbox_area) & (qa >= min_area)
    return quad, valid
