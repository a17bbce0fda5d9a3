"""Wave-tracking orchestration: the video fast path's driver.

Split out of detector.py (which keeps the public API + the cold
pipeline): this module lays out the anchor triples and sweep rows,
drives the wave kernel (track.wave_advance), and runs the audit/repair
loop whose decisions live in audit.AuditPolicy.  Reference anchor: this
replaces the reference's unconditional per-frame detect loop
(``/root/reference/src/data_loader.rs:114-127``) for steady-state video,
with the audit policy guaranteeing recall parity with the cold path.

Streaming architecture (round 5): ``TrackedSession.feed`` only enqueues
each chunk's (already-async) upload and buffers the device array;
``finalize`` concatenates the chunks and runs ONE whole-batch tracked
detection — the exact composition the bench measures.  A per-feed
detect variant (waves per chunk, audits merged at finalize) was built
and measured worse: each extra feed paid its own forced tail anchor +
anchor sweep.  What the session buys the streaming CLI: image decode
(host CPU) overlaps the uploads, the audit rounds run once per sequence
instead of once per 192-frame chunk, and the provisional hook fires
once with every frame — so speculative calibration works for chunked
callers exactly as for whole-batch ones.
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.profiling import stage
from .audit import AuditPolicy, RowLayout

log = logging.getLogger(__name__)


def _place_idx(off):
    # all indices pinned int32: x64 weak-int promotion makes the literal
    # 0s int64, and dynamic_update_slice requires one index dtype
    z = jnp.zeros((), jnp.int32)
    return (off.astype(jnp.int32), z, z)


@functools.partial(jax.jit, donate_argnums=0)
def _place_donated(buf, chunk, off):
    return jax.lax.dynamic_update_slice(buf, chunk, _place_idx(off))


@jax.jit
def _place(buf, chunk, off):
    # CPU backend: donation is unimplemented there and only warns
    return jax.lax.dynamic_update_slice(buf, chunk, _place_idx(off))


class TrackedSession:
    """Streaming wave-tracked detection over a chunked frame sequence.

    Usage (the dataloader's streaming path)::

        session = detector.begin_tracked(board, n_frames=len(paths))
        for chunk in chunks:                  # device arrays, in order
            session.feed(dev_chunk, n_valid)  # n_valid < B only on the tail
        results = session.finalize()          # audited, len == sum(n_valid)

    ``feed`` lands the chunk in a PREALLOCATED whole-sequence device
    buffer via a donated ``dynamic_update_slice`` (one in-place
    chunk-sized HBM copy) — the chunk's host->device transfer was
    already enqueued asynchronously by the caller's ``jnp.asarray``, so
    the caller keeps decoding images while earlier chunks upload.  Peak device memory is O(sequence + one chunk); the
    previous buffer-everything + ``jnp.concatenate`` composition peaked
    at 2x the sequence (e.g. ~24 GB for a 2895-frame 1024² f32 TUM-VI
    run).  Without an ``n_frames`` hint
    the session falls back to buffering + one concatenate.
    ``finalize`` runs the whole-batch tracked detection.

    ``n_frames``: expected caller-valid sequence length (capacity is
    rounded up to a multiple of the first chunk's batch size, matching
    the dataloader's pad-the-tail-chunk policy).
    """

    def __init__(self, det, board, n_frames: Optional[int] = None):
        self.det = det
        self.board = board
        self.n_hint = n_frames
        self.chunks: List = []
        self._buf = None   # preallocated (cap, H, W) sequence buffer
        self.n_valid = 0   # caller-valid frames
        self.n_padded = 0  # fed frames incl. tail padding
        self._finalized = False

    def feed(self, dev_chunk, n_valid: Optional[int] = None) -> None:
        """Buffer the next chunk of the sequence.

        ``dev_chunk``: (B, H, W) device-resident frames in sequence
        order; ``n_valid``: caller-valid frames (< B only when the tail
        was padded to a fixed batch shape — padding must be repeats of
        the last valid frame and only the LAST feed may be partial).
        """
        assert not self._finalized, "session already finalized"
        B = int(dev_chunk.shape[0])
        n_valid = B if n_valid is None else int(n_valid)
        assert self.n_valid == self.n_padded, (
            "only the last feed may carry tail padding"
        )
        if (
            self._buf is None and not self.chunks
            and self.n_hint is not None and self.n_hint > B
        ):
            cap = -(-self.n_hint // B) * B
            self._buf = jnp.zeros(
                (cap,) + tuple(dev_chunk.shape[1:]), dev_chunk.dtype
            )
        if self._buf is not None:
            assert (
                dev_chunk.dtype == self._buf.dtype
                and tuple(dev_chunk.shape[1:]) == tuple(self._buf.shape[1:])
            ), "chunks must be dtype/shape homogeneous"
            if self.n_padded + B > self._buf.shape[0]:
                # hint undershot (rare): grow by whole chunks
                grow = -(-(self.n_padded + B - self._buf.shape[0]) // B) * B
                self._buf = jnp.concatenate(
                    [self._buf,
                     jnp.zeros((grow,) + tuple(self._buf.shape[1:]),
                               self._buf.dtype)], axis=0,
                )
            place = (
                _place if jax.default_backend() == "cpu" else _place_donated
            )
            self._buf = place(self._buf, dev_chunk, np.int32(self.n_padded))
        else:
            self.chunks.append(dev_chunk)
        self.n_valid += n_valid
        self.n_padded += B

    def finalize(self) -> List[Dict[int, np.ndarray]]:
        """Run the whole-batch tracked detection over the buffered
        sequence; returns per-frame results (tail padding dropped)."""
        assert not self._finalized
        self._finalized = True
        if self._buf is not None:
            dev_full = (
                self._buf
                if self._buf.shape[0] == self.n_padded
                else self._buf[: self.n_padded]
            )
            self._buf = None
        elif not self.chunks:
            return []
        else:
            dev_full = (
                self.chunks[0]
                if len(self.chunks) == 1
                else jnp.concatenate(self.chunks, axis=0)
            )
            self.chunks = None  # the concat owns the data now
        # frame-shard once over the WHOLE sequence (multi-device runs)
        dev_full = self.det._shard_frames(dev_full)
        results = _detect_tracked(
            self.det, dev_full, self.board, n_valid=self.n_valid
        )
        return results[: self.n_valid]


def detect_batch_tracked(det, dev_all, board) -> List[Dict[int, np.ndarray]]:
    """Whole-batch wave tracking = a one-feed TrackedSession."""
    return _detect_tracked(det, dev_all, board, n_valid=dev_all.shape[0])


def _detect_tracked(det, dev_all, board, n_valid: int):
    """Wave-tracking over one device-resident batch (see track.wave_advance
    for the device kernel).

    Architecture: cold-detect anchor TRIPLES every ``cold_every`` frames
    (one small batched cold pass — a triple gives each anchor an exact
    velocity AND acceleration), then sweep every inter-anchor segment
    simultaneously: wave w advances all segments' forward sweeps (from
    the left triple) and backward sweeps (from the right triple) by one
    frame in ONE fused device graph.  A 534-frame batch takes ~19 waves
    of ~26 rows x n_tags quads instead of 534 sequential 36-quad
    steps — the device sees large batches, and the carry chains device-side
    with no host sync until the final fetch.

    Recall policy (audits keep the fast path anchored to the cold
    pipeline):

    * anchors ARE cold frames every ``cold_every`` — the cadence
      audit of the old sequential design is structural here, and the
      backward sweep recovers tags entering the view mid-segment
      from the right anchor (staleness bound K/2, not K);
    * a frame is SUSPECT when a tag with a valid in-bounds prediction
      hard-failed (not benign — see track.py BENIGN_MAX_DISP — and
      not known-bad) or too few tags were accepted; all suspects are
      cold-verified in one batched post-hoc sweep and cold wins;
    * known_bad = tags whose hard failure a cold audit confirmed
      (occlusion, rim clipping); their later failures don't
      re-trigger.  A novel failure stamps its tag immediately when
      the frame is queued for audit, so a persistent blind spot
      costs ONE audit, not one per frame; the tag still re-attempts
      every frame and recovers at the next anchor at the latest.

    ``n_valid``: frames the caller considers real — trailing padding
    frames (repeats of the last frame, added by streaming loaders to
    keep chunk shapes static) are detected normally but never audited
    and never reported to the provisional hook.

    The carry persists across calls (the last three frames' results
    seed the next call's first segment) so consecutive ``detect_batch``
    calls keep tracking; ``reset_tracking()`` between unrelated
    sequences.
    """
    from .detector import _anchor_starts, _async_fetch, _stack_outs
    from .track import (
        MIN_TRACK_TAGS,
        detections_to_arrays,
        init_wave_carry,
        neighbor_rank,
        wave_advance,
    )

    B, H, W = dev_all.shape
    K = max(det.cold_every, 4)
    n_tags = board.n_tags
    first = board.config.first_id

    st = det._tstate
    if st is None or st["wh"] != (W, H) or st["board"] is not board:
        st = det._tstate = {
            "wh": (W, H), "board": board,
            # (results[-3..-1]) of the previous call — the streaming
            # carry that seeds the next call's first segment
            "prev": None,
            # tag -> global frame of the last cold CONFIRMATION that
            # the tag is undetectable (see the docstring)
            "known_bad": {}, "frame_idx": 0,
        }
    det.stats = {"frames": B, "cold_frames": 0, "cold_groups": 0,
                 "trigger_frames": 0, "waves": 0}
    g0 = st["frame_idx"]

    def cold_sweep(frames: List[int], tag: str):
        """Cold-detect frame indices (batched, pipelined).

        Delegates frame selection to ``_detect_batch_cold``'s mixed
        64+8 chunk plan via ``idx`` — each chunk is one fixed-shape
        gather, so the pipeline only ever sees its two precompiled
        shapes, and a 102-frame anchor sweep pays 104 frames of work
        instead of 128 (padding frames cost the full transfer and
        host-CCL time)."""
        with stage(tag):
            res = det._detect_batch_cold(
                dev_all, board, idx=np.asarray(frames, np.int64)
            )
        det.stats["cold_frames"] += len(frames)
        det.stats["cold_groups"] += 1
        return dict(zip(frames, res))

    if B < 4:
        # too short to track: cold-only, but still feed the carry
        coldres = cold_sweep(list(range(B)), "detect/track-cold")
        results = [coldres[f] for f in range(B)]
        _advance_carry(st, results, n_valid)
        return results

    # ---- anchor triple layout (global cadence K) -------------------
    # Triples (not pairs): the quadratic prediction needs THREE seed
    # frames to engage at the first wave; constant-velocity seeding
    # overruns the 4.5 px refine capture at measured handheld
    # accelerations (3-4 px/frame^2 at the bench regime and far more
    # on fast sweeps).
    virtual = st["prev"] if (
        st["prev"] is not None
        and len(st["prev"][-1]) >= MIN_TRACK_TAGS
    ) else None
    gp = ((g0 + K - 1) // K) * K  # first grid anchor start >= g0
    p = gp - g0
    if virtual is None and p != 0:
        p = 0  # no carry: the batch head needs an anchor
    starts = _anchor_starts(B, K, p)

    anchor_frames = sorted(
        {f for q in starts for f in (q, q + 1, q + 2)}
    )
    coldres = cold_sweep(anchor_frames, "detect/track-cold")
    resmap: Dict[int, Dict[int, np.ndarray]] = dict(coldres)
    if virtual is not None:
        resmap[-3], resmap[-2], resmap[-1] = virtual

    all_starts = ([-3] if virtual is not None else []) + starts
    segs = list(zip(all_starts[:-1], all_starts[1:]))
    n_list = [pR - pL - 3 for pL, pR in segs]

    # Sparse-board segments go COLD-DIRECT: when the bracketing
    # anchors themselves see under ~sparse_frac of the board, the
    # board is partially out of view — homography extrapolation from
    # few tightly-packed rim neighbors collapses there, and the
    # audit triggers such a segment generates cost more than
    # detecting it in the big pipelined cold chunk up front (see
    # sparse_frac in __init__ for the measured threshold tradeoff).
    sparse_thr = max(
        MIN_TRACK_TAGS + 2, int(det.sparse_frac * n_tags)
    )
    cold_direct: set = set()
    for si, (pL, pR) in enumerate(segs):
        cl = max(len(resmap.get(pL + k, {})) for k in range(3))
        cr = max(len(resmap.get(pR + k, {})) for k in range(3))
        if min(cl, cr) < sparse_thr:
            cold_direct.add(si)
    direct_frames = sorted(
        f
        for si in cold_direct
        for f in range(max(segs[si][0] + 3, 0), segs[si][1])
        if f not in coldres
    )
    # Wave count over ALL segments (not just tracked ones): with it,
    # Wmax is a deterministic function of (B, K, carry) that
    # prewarm() can mirror — the per-wave-count _stack_outs graphs
    # and the wave loop itself then hit warmed executables.  A
    # cold-direct long segment can no longer shrink Wmax, but its
    # rows are act=False (device-cheap), and the all-cold-direct
    # case still skips the wave loop entirely.
    Wmax = (
        max(((n + 1) // 2 for n in n_list), default=0)
        if len(cold_direct) < len(segs)
        else 0
    )

    g_cor = np.zeros((B, n_tags, 4, 2), np.float32)
    g_acc = np.zeros((B, n_tags), bool)
    g_att = np.zeros((B, n_tags), bool)
    g_ben = np.zeros((B, n_tags), bool)

    board_xy_np = board.p3d.reshape(n_tags, 4, 3)[:, :, :2]
    board_xy = jnp.asarray(board_xy_np.astype(np.float32))
    nb_rank = jnp.asarray(neighbor_rank(board_xy_np))
    first_dev = jnp.asarray(np.asarray(first, np.int32))

    if Wmax > 0:
        S = len(segs)
        # sticky row bucket: shape flaps would recompile wave_advance
        R = max(-(-2 * S // 8) * 8, getattr(det, "_wave_rows", 0))
        det._wave_rows = R
        frame_of = np.zeros((Wmax, R), np.int32)
        act = np.zeros((Wmax, R), bool)
        for si, ((pL, pR), n) in enumerate(zip(segs, n_list)):
            if si in cold_direct:
                continue
            fc = (n + 1) // 2  # forward sweep takes the extra frame
            for w in range(fc):
                frame_of[w, 2 * si] = pL + 3 + w
                act[w, 2 * si] = True
            for w in range(n - fc):
                frame_of[w, 2 * si + 1] = pR - 1 - w
                act[w, 2 * si + 1] = True

        c1 = np.zeros((R, n_tags, 4, 2), np.float32)
        v1 = np.zeros((R, n_tags), bool)
        c2, v2 = c1.copy(), v1.copy()
        c3, v3 = c1.copy(), v1.copy()
        for si, (pL, pR) in enumerate(segs):
            if si in cold_direct:
                continue
            fr, bk = 2 * si, 2 * si + 1
            c1[fr], v1[fr] = detections_to_arrays(resmap[pL + 2], board)
            c2[fr], v2[fr] = detections_to_arrays(resmap[pL + 1], board)
            c3[fr], v3[fr] = detections_to_arrays(resmap[pL], board)
            c1[bk], v1[bk] = detections_to_arrays(resmap[pR], board)
            c2[bk], v2[bk] = detections_to_arrays(resmap[pR + 1], board)
            c3[bk], v3[bk] = detections_to_arrays(resmap[pR + 2], board)

        carry = tuple(
            jnp.asarray(a)
            for a in init_wave_carry(c1, v1, c2, v2, c3, v3)
        )
        outs = []
        with stage("detect/track"):
            for w in range(Wmax):
                imgs_w = jnp.take(
                    dev_all, jnp.asarray(frame_of[w]), axis=0
                )
                carry, out = wave_advance(
                    det.family, imgs_w, board_xy, nb_rank, first_dev,
                    carry, jnp.asarray(act[w]),
                )
                outs.append(out)
            det.stats["waves"] = Wmax
            # stack per-wave outputs ON DEVICE; fetched after the
            # cold-direct sweep below overlaps with the wave compute
            stacked = _stack_outs(tuple(tuple(o) for o in outs))
            _async_fetch(stacked)
        if direct_frames:
            coldres.update(
                cold_sweep(direct_frames, "detect/track-cold")
            )
        with stage("detect/track"):
            fetched = tuple(np.asarray(s) for s in stacked)
        oc, ac, at, bn = fetched
        for w in range(Wmax):
            rows = np.flatnonzero(act[w])
            f = frame_of[w, rows]
            g_cor[f] = oc[w, rows]
            g_acc[f] = ac[w, rows]
            g_att[f] = at[w, rows]
            g_ben[f] = bn[w, rows]
    elif direct_frames:
        coldres.update(
            cold_sweep(direct_frames, "detect/track-cold")
        )

    # row bookkeeping for the repair re-sweeps below
    layout = RowLayout.empty(B)
    row_frames, row_of, pos_of = (
        layout.row_frames, layout.row_of, layout.pos_of
    )
    if Wmax > 0:
        for r in range(R):
            fl = [int(frame_of[w, r]) for w in range(Wmax) if act[w, r]]
            if fl:
                row_frames[r] = fl
                for w, f in enumerate(fl):
                    row_of[f] = r
                    pos_of[f] = w

    # Per-segment EXPECTED tag count, from the bracketing cold
    # anchors: when the board is partially out of view (TUM-VI-style
    # sweeps), a frame with 8 visible tags is healthy even though
    # 8 << n_tags/2 — auditing every such frame cold-detected whole
    # stretches of the sequence for nothing (measured: 51 trigger
    # frames / 156 cold frames on the 534-frame bench).  min() of the
    # two anchor triples is the conservative bound on what a
    # mid-segment frame should still see; the per-tag novel-failure
    # audits (below) remain the recall guarantee for attempted tags.
    seg_expect: Dict[int, int] = {}
    for si, (pL, pR) in enumerate(segs):
        cl = max(len(resmap.get(pL + k, {})) for k in range(3))
        cr = max(len(resmap.get(pR + k, {})) for k in range(3))
        seg_expect[si] = min(cl, cr)

    # ---- results + post-hoc audit/repair loop ---------------------
    results: List[Dict[int, np.ndarray]] = [dict() for _ in range(B)]

    def write_result(f: int) -> None:
        tracked = {
            int(t) + first: g_cor[f, t].copy()
            for t in np.flatnonzero(g_acc[f])
        }
        if f in coldres:
            merged = dict(coldres[f])
            for t, cc in tracked.items():
                merged.setdefault(t, cc)
            results[f] = merged
        else:
            results[f] = tracked

    for f in range(B):
        write_result(f)

    # Provisional-results hook: detections are complete up to audit
    # corrections from here on, so a caller-registered callback (the
    # speculative calibration, calib/pipeline.SpeculativeCalib) can
    # overlap its solve with the audit sweeps below.  Fired
    # lazily from the audit loop ONLY when a round actually exists:
    # with zero audits there is nothing to overlap, and a speculation
    # the caller must join SERIALIZES in front of the final solve —
    # measured +0.08 s on the clean 128-frame 1024 bench regime (spec
    # init+BA 0.25 s on the critical path vs the cold init it replaces).
    def fire_provisional():
        if det.on_provisional is None:
            return
        try:
            det.on_provisional([dict(r) for r in results[:n_valid]])
        except Exception:  # pragma: no cover - hook must not break detect
            log.exception("on_provisional hook failed")

    def fails_at(f: int) -> set:
        return set(
            int(t)
            for t in np.flatnonzero(g_att[f] & ~g_acc[f] & ~g_ben[f])
        )

    # kb_ttl = 2*K: a cold-confirmed absence suppresses re-audits for
    # the audit-cadence bound of the sequential design (commit
    # 02a340e; see audit.AuditPolicy for the recall rationale).
    policy = AuditPolicy(
        n_tags=n_tags, g0=g0, known_bad=st["known_bad"], kb_ttl=2 * K,
        layout=layout, seg_expect=seg_expect,
    )

    def res_at(f: int) -> Dict[int, np.ndarray]:
        return results[f] if f >= 0 else resmap.get(f, {})

    def run_resweeps(jobs) -> None:
        """Re-run sweep rows from corrected seeds.

        jobs: list of (frames_in_sweep_order, seed frame indices
        (f1 nearest, f2, f3)).  Row/wave shapes are bucketed (sticky)
        so repair runs reuse a small compiled-graph set."""
        R2 = max(
            -(-len(jobs) // 8) * 8, getattr(det, "_wave_rows_small", 8)
        )
        det._wave_rows_small = R2
        # wave count bucketed to multiples of 4: it keys the wave
        # loop's stack graph, and the raw max row length is
        # data-dependent (padded waves carry act=False rows)
        W2 = -(-max(len(fl) for fl, _ in jobs) // 4) * 4
        f_of = np.zeros((W2, R2), np.int32)
        a2 = np.zeros((W2, R2), bool)
        c1 = np.zeros((R2, n_tags, 4, 2), np.float32)
        v1 = np.zeros((R2, n_tags), bool)
        c2, v2 = c1.copy(), v1.copy()
        c3, v3 = c1.copy(), v1.copy()
        for j, (fl, (f1, f2, f3)) in enumerate(jobs):
            for w, f in enumerate(fl):
                f_of[w, j] = f
                a2[w, j] = True
            c1[j], v1[j] = detections_to_arrays(res_at(f1), board)
            c2[j], v2[j] = detections_to_arrays(res_at(f2), board)
            c3[j], v3[j] = detections_to_arrays(res_at(f3), board)
        carry = tuple(
            jnp.asarray(a)
            for a in init_wave_carry(c1, v1, c2, v2, c3, v3)
        )
        outs = []
        with stage("detect/track"):
            for w in range(W2):
                imgs_w = jnp.take(dev_all, jnp.asarray(f_of[w]), axis=0)
                carry, out = wave_advance(
                    det.family, imgs_w, board_xy, nb_rank, first_dev,
                    carry, jnp.asarray(a2[w]),
                )
                outs.append(out)
            # jitted stack (one graph per W2 bucket; the eager
            # per-field jnp.stack compiled one-op graphs)
            stacked2 = _stack_outs(tuple(tuple(o) for o in outs))
            _async_fetch(stacked2)
            fetched = tuple(np.asarray(s) for s in stacked2)
        oc, ac, at, bn = fetched
        for w in range(W2):
            rows = np.flatnonzero(a2[w])
            f = f_of[w, rows]
            g_cor[f] = oc[w, rows]
            g_acc[f] = ac[w, rows]
            g_att[f] = at[w, rows]
            g_ben[f] = bn[w, rows]
            for ff in f:
                write_result(int(ff))

    # Audit/repair loop — decisions live in audit.AuditPolicy (see its
    # module docstring for the full policy + recall guarantee); this
    # driver computes per-frame observations from the wave outputs,
    # runs the batched cold sweeps/re-sweeps, and reports outcomes
    # back.  Rounds strictly grow the audited set, so the loop
    # terminates; on steady-state video it runs once over a handful
    # of frames.  Tail-padding frames (>= n_valid) are pre-marked cold
    # so they are never audited.
    in_cold_pad = set(range(n_valid, B))
    first_round = True
    while True:
        fails_sets = [fails_at(f) for f in range(B)]
        acc_counts = g_acc.sum(axis=1)
        plan = policy.plan_round(
            fails_sets, acc_counts, set(coldres) | in_cold_pad
        )
        if first_round:
            first_round = False
            if plan is not None:
                # audits will run: start the speculation now so its
                # solve overlaps the sweeps below
                fire_provisional()
        if plan is None:
            break
        lead = plan.lead
        det.stats["trigger_frames"] += len(lead)
        coldres.update(cold_sweep(lead, "detect/track-audit"))
        cold_tags = {
            f: {int(t) - first for t in coldres[f]} for f in lead
        }
        added = {
            f: any(t not in results[f] for t in coldres[f])
            for f in lead
        }
        improved = policy.record_outcome(
            plan, fails_sets, cold_tags, added
        )
        for f in lead:
            write_result(f)
        jobs = policy.resweep_jobs(improved, plan.no_resweep)
        if jobs:
            det.stats["resweeps"] = det.stats.get("resweeps", 0) + len(jobs)
            run_resweeps(jobs)
    if policy.trigger_log:
        det.stats["trigger_log"] = policy.trigger_log
    if os.environ.get("CCRS_TRACK_DEBUG"):
        # diagnostic stash (perf archaeology only — never read by the
        # pipeline): per-(frame, tag) wave outcomes + what cold saw
        det.debug = {
            "g_acc": g_acc, "g_att": g_att, "g_ben": g_ben,
            "g_cor": g_cor, "coldres": dict(coldres),
            "layout": layout, "segs": segs, "cold_direct": cold_direct,
            "known_bad": dict(st["known_bad"]),
        }

    _advance_carry(st, results, n_valid)
    return results


def _advance_carry(st, results, n_valid: int) -> None:
    """Advance the streaming carry past this batch using only the
    caller-VALID frames: tail padding (repeats of the last frame) must
    not seed the next call's triple (a zero-velocity triple mispredicts
    on moving video) nor shift the global frame counter that known_bad
    TTL windows are stamped against."""
    if n_valid >= 3:
        st["prev"] = (
            results[n_valid - 3], results[n_valid - 2], results[n_valid - 1]
        )
    else:
        st["prev"] = None  # too short to re-seed a triple
    st["frame_idx"] += n_valid
