"""Steady-state tag tracking: the video fast path of the detector.

Calibration sequences are continuous video — frame-to-frame tag motion is
small — yet the cold pipeline pays the packed-bitmap download, the
single-core native CCL, and the host assist bookkeeping for EVERY frame
(the detect stage is the reference's own hot loop #1,
``/root/reference/src/data_loader.rs:114-127``).  Tracking replaces all of
that for the steady-state majority of frames with a few fused device
graphs ("waves"):

  anchors: cold-detect PAIRS of frames every ``cold_every`` frames (one
    batched cold pass; a pair gives each anchor an exact velocity);
  waves: advance every inter-anchor segment simultaneously — wave w
    processes frame ``leftpair+2+w`` of every segment (forward sweep) and
    ``rightpair-1-w`` (backward sweep) in ONE device graph:
      predict every board tag's quad from the sweep's last frames
        - decoded tags: quadratic (constant-acceleration) extrapolation
        - recently-lost tags: coast on their last position + velocity
        - missing tags: local homography fit from the 4 nearest decoded
          neighbors (board plane -> image) plus the mean scene velocity
      subpixel-refine the predicted corners on the current frame
      decode and accept only on tag-id match (a far stronger test than
        open-set matching, so a relaxed hamming budget is safe)
      carry the accepted corners to the segment's next frame.

An earlier design advanced ONE frame per ``lax.scan`` step — 36 quads per
step left the device idle (no faster than the whole cold pipeline).
Waves batch ~70 segment-sweeps x n_tags quads per step
and chain the carry device-side, so a 534-frame batch costs ~7 graph
dispatches and one final fetch.  Frames where tracking is suspect fall
back to the cold pipeline (see ``detector.TagDetector._detect_batch_tracked``
for the audit policy), so recall can never silently degrade below the
cold detector's.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .decode import _decode_core_dense
from .families import TagFamily
from .sample import build_klt_maps, refine_corners_maps, unsharp_batch

#: id-match acceptance allows a relaxed budget, like assist.ASSIST_EXTRA_HAMMING
TRACK_EXTRA_HAMMING = 2
#: below this many accepted tags a frame cannot seed the next prediction
MIN_TRACK_TAGS = 4
#: neighbors for the local-homography prediction of missing tags
N_NEIGHBORS = 4
#: degenerate/too-small predicted quads are not worth decoding (px^2)
MIN_QUAD_AREA = 49.0
#: predictions up to this many px outside the image still count as
#: "attempted": a tag entering the view may have a slightly-stale
#: prediction straddling the border — attempting (and failing) it makes it
#: auditable by the cold-fallback trigger instead of silently skipped
EDGE_MARGIN = 8.0
#: a failed decode counts as cold-equivalent (non-triggering) only when
#: refinement moved every corner less than this (well inside the 4 px
#: capture clamp — converged localization, so the failure is decode noise)
BENIGN_MAX_DISP = 3.0
#: a refine that traveled to its total-shift clamp (sample.MAX_SHIFT=4.5)
#: has NOT converged: the quad can sit many px from the true corner and
#: STILL decode (the id bits tolerate px-scale corner error — measured
#: 5.5 px accepted corners under zig-zag shake, tests/test_track_shake.py),
#: so acceptance requires the refine displacement to be below this.
#: Unconverged pass-1 accepts get ONE restart in the assist pass (a fresh
#: refine resets the clamp budget, capturing another 4.5 px); a quad still
#: unconverged after that hard-fails into the audit path, where cold wins.
CONVERGED_MAX_DISP = 4.0
#: frames a lost tag "coasts" on its last known position (advanced by the
#: global scene velocity) before prediction falls back to the local
#: homography.  Flickering marginal tags lose one frame at a time; their
#: own last position is far more accurate than homography EXTRAPOLATION,
#: which degrades at the fisheye rim exactly where those tags live.
MAX_COAST = 8


def _cholesky_solve8(M, rhs):
    """Batched 8x8 SPD solve, fully unrolled over the matrix indices.

    ``jnp.linalg.cholesky`` on (Q, 8, 8) batches can lower to Q tiny
    linear-algebra kernels.  Unrolling the 8x8 Cholesky + forward/back
    substitution into static Python loops turns it into a few hundred
    (Q,)-vectorized elementwise ops instead.

    Deliberate twin of ``solve.lm.cholesky_solve_batched_small`` (vector
    rhs, n pinned to 8): THIS copy runs in f32 image space, so its sqrt
    floor is 1e-20, while the lm helper serves the f64 solver cores with
    a 1e-300 floor — merging them would force a dtype-dependent floor
    into the solver hot path.  Keep fixes to the substitution/poisoning
    logic in sync between the two.
    """
    n = 8
    L = [[None] * n for _ in range(n)]
    bad = jnp.zeros(M.shape[:-2], bool)
    for j in range(n):
        s = M[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # preserve jnp.linalg.cholesky's contract: a non-PD pivot must
        # poison the result (callers mask predictions on isfinite; a
        # finite-but-wrong solve would instead feed garbage quads to the
        # tracker and trigger mass cold audits)
        bad = bad | (s <= 0.0)
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = M[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = rhs[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    out = jnp.stack(x, axis=1)
    return jnp.where(bad[:, None], jnp.nan, out)


def _fit_h_batch(src, dst):
    """Batched inhomogeneous DLT homography fit src -> dst.

    src/dst: (Q, n, 2).  Returns (Q, 3, 3) with H[2,2] == 1 fitted on
    mean/std-normalized coordinates (composed back), solved Cholesky-only
    (8x8 normal equations), which fuses into the wave graph.  Near-singular
    neighbor geometry yields non-finite H; callers mask on isfinite.
    """
    Q, n, _ = src.shape
    sm = src.mean(axis=1)
    ss = src.reshape(Q, -1).std(axis=1) + 1e-12
    dm = dst.mean(axis=1)
    ds = dst.reshape(Q, -1).std(axis=1) + 1e-12
    s = (src - sm[:, None]) / ss[:, None, None]
    d = (dst - dm[:, None]) / ds[:, None, None]
    A = jnp.zeros((Q, 2 * n, 8), dtype=src.dtype)
    A = A.at[:, 0::2, 0:2].set(s)
    A = A.at[:, 0::2, 2].set(1.0)
    A = A.at[:, 0::2, 6:8].set(-d[:, :, :1] * s)
    A = A.at[:, 1::2, 3:5].set(s)
    A = A.at[:, 1::2, 5].set(1.0)
    A = A.at[:, 1::2, 6:8].set(-d[:, :, 1:2] * s)
    b = d.reshape(Q, -1)  # rows interleave (x_i, y_i) matching A
    M = jnp.einsum("qij,qik->qjk", A, A) + 1e-6 * jnp.eye(8, dtype=src.dtype)
    rhs = jnp.einsum("qij,qi->qj", A, b)
    h = _cholesky_solve8(M, rhs)  # (Q, 8)
    Hn = jnp.concatenate(
        [h, jnp.ones((Q, 1), dtype=src.dtype)], axis=1
    ).reshape(Q, 3, 3)
    Ts = jnp.zeros((Q, 3, 3), dtype=src.dtype)
    Ts = Ts.at[:, 0, 0].set(1.0 / ss)
    Ts = Ts.at[:, 1, 1].set(1.0 / ss)
    Ts = Ts.at[:, 0, 2].set(-sm[:, 0] / ss)
    Ts = Ts.at[:, 1, 2].set(-sm[:, 1] / ss)
    Ts = Ts.at[:, 2, 2].set(1.0)
    Td = jnp.zeros((Q, 3, 3), dtype=src.dtype)
    Td = Td.at[:, 0, 0].set(ds)
    Td = Td.at[:, 1, 1].set(ds)
    Td = Td.at[:, 0, 2].set(dm[:, 0])
    Td = Td.at[:, 1, 2].set(dm[:, 1])
    Td = Td.at[:, 2, 2].set(1.0)
    return Td @ Hn @ Ts


def _apply_h_batch(H, pts):
    """(Q, 3, 3) x (Q, n, 2) -> (Q, n, 2)."""
    p = jnp.einsum("qij,qnj->qni", H[:, :, :2], pts) + H[:, None, :, 2]
    z = p[:, :, 2]
    z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    return p[:, :, :2] / z[:, :, None]


def neighbor_rank(board_xy) -> np.ndarray:
    """(n_tags, n_tags) int32: rank of tag j among tag i's neighbors, by
    board-plane center distance, ties broken by the lower tag index.

    A grid board is full of equal distances, and the 4-nearest-neighbor
    choice of the homography predictions lands on such ties all the time.
    ``lax.top_k`` over f32 distances computed on the device left the
    choice to the backend: the CPU and the H100 round those distances
    differently in the last bit (448 of the 6x6 board's 1,296 entries), so
    the two broke the same ties differently, fitted different neighbor
    homographies and tracked different corners on hard frames.  Ranks
    computed here on the host are distinct integers, so every backend
    picks the same neighbors.
    """
    c = np.asarray(board_xy, np.float64).mean(axis=1)
    d2 = ((c[:, None] - c[None]) ** 2).sum(-1)
    # in units of the nearest spacing, to 4 decimals: equal grid distances
    # compare equal despite the f32 rounding of the board coordinates
    d2 = np.round(d2 / max(d2[d2 > 0].min(initial=np.inf), 1e-300), 4)
    n = d2.shape[0]
    order = np.lexsort((np.broadcast_to(np.arange(n), d2.shape), d2), axis=1)
    rank = np.empty((n, n), np.int32)
    np.put_along_axis(rank, order, np.arange(n, dtype=np.int32)[None], axis=1)
    return rank


def _nearest_valid(nb_rank, valid):
    """Indices of the N_NEIGHBORS nearest tags with ``valid`` set, per tag,
    and whether there were that many; ties are already broken by
    ``nb_rank``, so the choice is the same on every backend."""
    n_tags = nb_rank.shape[0]
    key = nb_rank + jnp.where(valid, 0, n_tags)[None, :]
    negk, idx = jax.lax.top_k(-key, N_NEIGHBORS)
    return idx, (-negk < n_tags).all(axis=1)


def _predict_rows(board_xy, nb_rank, c3, v3, c2, v2, c1, v1,
                  coast_c, coast_v, coast_age, Hh, Ww):
    """Batched one-frame-ahead prediction of every board tag's quad.

    All args carry a leading row axis R (one row = one independent track
    state; the wave tracker advances a whole batch of segment sweeps in
    lockstep).  Same prediction policy as the sequential scan documented
    in the module docstring: quadratic extrapolation through the last
    three observations, per-tag coasting for recently-lost tags, local
    homography from the 4 nearest decoded neighbors otherwise.

    Returns (pred, pred_t, attempt, area-ordered pred for carry) with
    shapes (R, n_tags, 4, 2) / (R, n_tags).
    """
    def one(c3, v3, c2, v2, c1, v1, coast_c, coast_v, coast_age):
        n_tags = board_xy.shape[0]
        both = v1 & v2
        vel = jnp.where(both[:, None, None], c1 - c2, 0.0)
        nv = jnp.maximum(jnp.sum(both), 1)
        gvel = jnp.sum(vel * both[:, None, None], axis=(0, 1)) / (nv * 4)
        quad_ok = both & v3
        pred_quad = 3.0 * c1 - 3.0 * c2 + c3
        pred_id = jnp.where(quad_ok[:, None, None], pred_quad, c1 + vel)

        idx, nb_ok = _nearest_valid(nb_rank, v1)
        src = board_xy[idx].reshape(n_tags, -1, 2)
        dst = c1[idx].reshape(n_tags, -1, 2)
        Hs = _fit_h_batch(src, dst)
        ph = _apply_h_batch(Hs, board_xy) + gvel[None, None, :]
        h_ok = nb_ok & jnp.isfinite(ph).all(axis=(1, 2))
        ph = jnp.nan_to_num(ph)

        coast_p = coast_c + coast_v
        coasting = (~v1) & (coast_age <= MAX_COAST)
        pred = jnp.where(
            v1[:, None, None],
            pred_id,
            jnp.where(coasting[:, None, None], coast_p, ph),
        )
        pred_ok = v1 | coasting | h_ok
        x, y = pred[..., 0], pred[..., 1]
        area2 = jnp.sum(x * jnp.roll(y, -1, 1) - jnp.roll(x, -1, 1) * y, axis=1)
        pred_t = jnp.where((area2 < 0)[:, None, None], pred[:, ::-1], pred)
        inb = (
            (pred[..., 0].min(1) >= -EDGE_MARGIN)
            & (pred[..., 1].min(1) >= -EDGE_MARGIN)
            & (pred[..., 0].max(1) <= Ww - 1 + EDGE_MARGIN)
            & (pred[..., 1].max(1) <= Hh - 1 + EDGE_MARGIN)
            & (0.5 * jnp.abs(area2) >= MIN_QUAD_AREA)
        )
        return pred, pred_t, pred_ok & inb, pred_id, coast_p, gvel

    return jax.vmap(one)(c3, v3, c2, v2, c1, v1, coast_c, coast_v, coast_age)


@partial(jax.jit, static_argnames=("family",))
def wave_advance(family: TagFamily, images, board_xy, nb_rank, first_id,
                 carry, row_active):
    """Advance R independent track states by ONE frame each — batched.

    The wave tracker's device kernel: where the sequential scan processed
    one frame per ``lax.scan`` step (36 quads — far too small a batch to
    fill the device), a wave advances EVERY anchor
    segment's sweep simultaneously: R rows x n_tags quads through one
    fused predict -> subpixel-refine -> decode graph.  A 534-frame batch
    needs ~7 waves of ~70 rows instead of 534 sequential steps, and the
    carry chains on device (no host sync between waves).

    Args:
      images: (R, H, W) uint8/f32 — row r's current frame.
      board_xy: (n_tags, 4, 2) board-plane tag corners.
      nb_rank: (n_tags, n_tags) int32 ``neighbor_rank(board_xy)``.
      first_id: int32 scalar board tag id offset.
      carry: tuple (c3, v3, c2, v2, c1, v1, coast_c, coast_v, coast_age)
        of (R, n_tags, ...) arrays — per-row track state, time-ordered in
        the row's SWEEP direction (backward rows simply feed frames in
        reverse; the prediction math is direction-agnostic).
      row_active: (R,) bool — padding / exhausted rows decode nothing.

    Returns (new_carry, (corners, acc, att, benign)) with outputs shaped
    (R, n_tags, ...).
    """
    imgs = images.astype(jnp.float32)
    R, Hh, Ww = imgs.shape
    n_tags = board_xy.shape[0]
    c3, v3, c2, v2, c1, v1, coast_c, coast_v, coast_age = carry
    exp_id = jnp.arange(n_tags, dtype=jnp.int32) + first_id.astype(jnp.int32)

    pred, pred_t, attempt, pred_id, coast_p, gvel = _predict_rows(
        board_xy, nb_rank, c3, v3, c2, v2, c1, v1,
        coast_c, coast_v, coast_age, Hh, Ww,
    )
    attempt = attempt & row_active[:, None]

    # one fused refine+decode over all R x n_tags predicted quads — all
    # sampling over whole-image maps (sample.py): the KLT maps build once per
    # wave and serve both this pass and the in-wave assist below
    maps = build_klt_maps(imgs)
    quads = refine_corners_maps(
        maps, pred_t.reshape(R, n_tags * 4, 2)
    ).reshape(R, n_tags, 4, 2)
    sharp = unsharp_batch(imgs)
    dec = _decode_core_dense(family, sharp, quads, attempt)
    tag_id = dec["tag_id"]
    hamming = dec["hamming"]
    contrast_ok = dec["contrast_ok"]
    out_c = dec["corners"]

    id_match = tag_id == exp_id[None, :]
    disp = jnp.linalg.norm(quads - pred_t, axis=-1).max(axis=-1)
    acc = (
        attempt
        & contrast_ok
        & id_match
        & (hamming <= family.max_hamming + TRACK_EXTRA_HAMMING)
    )
    # localization gate: an id-match on a clamped (unconverged) refine is
    # NOT trustworthy — demote to a restart attempt below
    unconv = acc & (disp >= CONVERGED_MAX_DISP)
    acc = acc & ~unconv
    benign = (
        attempt & ~acc & id_match & contrast_ok & (disp < BENIGN_MAX_DISP)
    )

    # ---- in-wave assist: re-attempt everything not accepted from the
    # CURRENT frame's accepted tags (local board->image homography) — the
    # same recovery the cold pipeline's board-assist pass provides.  Rim
    # tags drift past the refine capture radius under EXTRAPOLATION (the
    # fisheye magnifies motion exactly there), but same-frame neighbor
    # geometry predicts them within a pixel; this pass also picks up tags
    # entering the view that no prior-frame carry could predict.
    def assist_one(vc, cc):
        idx, nb_ok = _nearest_valid(nb_rank, vc)
        src = board_xy[idx].reshape(n_tags, -1, 2)
        dst = cc[idx].reshape(n_tags, -1, 2)
        Hs = _fit_h_batch(src, dst)
        ph = _apply_h_batch(Hs, board_xy)
        ok = nb_ok & jnp.isfinite(ph).all(axis=(1, 2))
        return jnp.nan_to_num(ph), ok

    safe_c = jnp.where(acc[..., None, None], out_c, 0.0)
    ph2, h2_ok = jax.vmap(assist_one)(acc, safe_c)
    x2, y2 = ph2[..., 0], ph2[..., 1]
    area2b = jnp.sum(
        x2 * jnp.roll(y2, -1, 2) - jnp.roll(x2, -1, 2) * y2, axis=2
    )
    ph2_t = jnp.where((area2b < 0)[..., None, None], ph2[:, :, ::-1], ph2)
    inb2 = (
        (ph2[..., 0].min(2) >= -EDGE_MARGIN)
        & (ph2[..., 1].min(2) >= -EDGE_MARGIN)
        & (ph2[..., 0].max(2) <= Ww - 1 + EDGE_MARGIN)
        & (ph2[..., 1].max(2) <= Hh - 1 + EDGE_MARGIN)
        & (0.5 * jnp.abs(area2b) >= MIN_QUAD_AREA)
    )
    # unconverged pass-1 accepts restart from their OWN refined quad (a
    # fresh refine resets the total-shift clamp); everything else starts
    # from the same-frame neighbor-homography prediction
    start2 = jnp.where(unconv[..., None, None], quads, ph2_t)
    attempt2 = row_active[:, None] & (
        unconv | (~acc & h2_ok & inb2)
    )
    quads2 = refine_corners_maps(
        maps, start2.reshape(R, n_tags * 4, 2)
    ).reshape(R, n_tags, 4, 2)
    dec2 = _decode_core_dense(family, sharp, quads2, attempt2)
    id2 = dec2["tag_id"] == exp_id[None, :]
    ham2 = dec2["hamming"]
    out2_c = dec2["corners"]
    disp2 = jnp.linalg.norm(quads2 - start2, axis=-1).max(axis=-1)
    # same acceptance as the cold board-assist pass (assist.assist_merge):
    # id match + relaxed hamming, NO contrast gate — the id match is the
    # strong test, and oblique rim tags legitimately run low-contrast.
    # Anything stricter here makes tracking hard-fail tags the cold
    # pipeline recovers, and every such tag costs a cold audit.  The one
    # addition is the convergence gate (CONVERGED_MAX_DISP): a clamped
    # refine's corners are untrusted no matter how well they decode.
    acc2 = (
        attempt2
        & id2
        & (ham2 <= family.max_hamming + TRACK_EXTRA_HAMMING)
        & (disp2 < CONVERGED_MAX_DISP)
    )
    benign = (attempt2 & ~acc2 & id2 & (disp2 < BENIGN_MAX_DISP)) | benign
    out_c = jnp.where(acc2[..., None, None], out2_c, out_c)
    acc = acc | acc2
    attempt = attempt | attempt2

    new_c = jnp.where(acc[..., None, None], out_c, pred_id)
    new_coast = jnp.where(acc[..., None, None], out_c, coast_p)
    obs_v = jnp.where(
        (acc & v1)[..., None, None],
        out_c - c1,
        jnp.broadcast_to(gvel[:, None, None, :], coast_v.shape),
    )
    new_coast_v = jnp.where(acc[..., None, None], obs_v, coast_v)
    new_age = jnp.where(acc, 0, coast_age + 1)
    new_carry = (
        c2, v2, c1, v1, new_c, acc, new_coast, new_coast_v, new_age
    )
    return new_carry, (out_c, acc, attempt, benign)


def init_wave_carry(c1, v1, c2, v2, c3=None, v3=None):
    """Build the 9-tuple wave carry from the seed frames of each row.

    c1/v1: (R, n_tags, 4, 2)/(R, n_tags) — the row's NEAREST seed frame
    (the one adjacent to the first frame the row will process); c2/v2 the
    one behind it in sweep order, c3/v3 the one behind that.  Anchors are
    cold-detected in TRIPLES precisely so the quadratic
    (constant-acceleration) prediction engages from the first wave —
    constant-velocity seeding measurably overruns the refine capture
    radius at realistic handheld accelerations.
    """
    init_age = np.where(v1, 0, MAX_COAST + 1).astype(np.int32)
    if c3 is None:
        c3 = np.zeros_like(c1)
        v3 = np.zeros_like(v1)
    return (
        c3, v3, c2, v2, c1, v1,
        c1.copy(), np.zeros_like(c1), init_age,
    )


def detections_to_arrays(res, board) -> tuple:
    """{tag_id: (4,2)} -> ((n_tags, 4, 2) f32, (n_tags,) bool) carry arrays."""
    n_tags = board.n_tags
    first = board.config.first_id
    c = np.zeros((n_tags, 4, 2), np.float32)
    v = np.zeros(n_tags, bool)
    for t, cc in res.items():
        tl = int(t) - first
        if 0 <= tl < n_tags:
            c[tl] = cc
            v[tl] = True
    return c, v
