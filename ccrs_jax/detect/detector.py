"""TagDetector: the public detection API.

Mirrors the reference's detector surface (``TagDetector::new(&family, None)``
+ ``detect(&image) -> {tag_id: [4 corners]}``, call sites
``src/bin/camera_calibration.rs:74`` / ``src/data_loader.rs:43``) but is
batch-first: ``detect_batch`` processes a whole frame sequence through the
three-stage pipeline

  device: adaptive threshold  ->  host/native: quad extraction (C++)
      ->  device: ONE fused graph (patch refine + unsharp + decode)

``detect`` on a single image is a convenience wrapper over the batch path.

Latency architecture: every synchronous device->host fetch stalls the
host until the device catches up, so the batch path is phased to keep at
most three syncs per chunk and to overlap host work with device work:

  phase 1 (per chunk): download the packed threshold bitmaps (device work
    for ALL chunks was enqueued up front), run the native C++ quad
    extraction, and ENQUEUE the fused refine+decode graph — its result is
    not fetched yet, so the device decodes chunk i while the host extracts
    quads of chunk i+1;
  phase 2 (per chunk): fetch decode outputs (already computed in the
    background), build per-frame results, and enqueue the board-assisted
    recovery decode the same way;
  phase 3 (per chunk): fetch + merge assist results.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

log = logging.getLogger(__name__)

from ..utils.profiling import stage
from .decode import refine_decode_fused_dense
from .families import TagFamily, get_family
from .quads import MAX_QUADS, extract_quads_batch
from .threshold import adaptive_threshold_packed, pad_to_tile, threshold_front


def _async_fetch(arrays) -> None:
    """Start device->host copies for arrays that will be np.asarray'd
    later.  A SYNCHRONOUS fetch waits for its copy serially; async copies
    enqueue behind the producing computation and overlap the transfer
    with later host work."""
    for a in arrays:
        try:
            a.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without support
            pass


import jax as _jax


@_jax.jit
def _stack_outs(outs):
    """Stack a sequence of per-wave output tuples on device in ONE
    graph — the eager per-field jnp.stack compiled its own broadcast +
    concatenate one-op graphs (a compile each)."""
    return tuple(jnp.stack(x) for x in zip(*outs))


def _quad_rung(need: int) -> int:
    """Smallest rung of the ~1.5x, 8-aligned quad-bucket ladder
    (8, 16, 24, 40, 64, 96, 144, 216, ...) that fits ``need`` quads."""
    m = 8
    while m < need:
        m = -(-m * 3 // 2 // 8) * 8
    return m


def _anchor_starts(B: int, K: int, p0: int) -> List[int]:
    """Anchor-triple start frames for a B-frame batch at cadence K,
    beginning at p0 (0 unless a streaming carry aligns to the global
    grid).  Shared by _detect_batch_tracked and prewarm(): the wave
    count and row bucket derived from this layout key compiled graph
    shapes, so the two MUST stay in lockstep."""
    starts: List[int] = []
    p = p0
    while p <= B - 3:
        starts.append(p)
        p += K
    if not starts or starts[-1] != B - 3:
        # force an anchor at the tail so every frame sits in a segment
        if starts and B - 3 - starts[-1] < 3:
            starts.pop()
        starts.append(B - 3)
    return starts


@_jax.jit
def _pool2(images):
    """2x2 mean pyramid level (device side); odd trailing rows/cols drop."""
    B, H, W = images.shape
    x = images[:, : H // 2 * 2, : W // 2 * 2].astype(jnp.float32)
    return x.reshape(B, H // 2, 2, W // 2, 2).mean(axis=(2, 4))


def _dilate_white_host(binary: np.ndarray) -> np.ndarray:
    """3x3 white dilation (= one more black erosion) of a (B, H, W) {0,1}
    uint8 batch on the host — exactly reduce_window(OR, 3x3, SAME) with
    False padding, but computed from the already-downloaded level-1 bitmap
    so the second erosion level is never downloaded."""
    out = binary.copy()
    out[:, 1:, :] |= binary[:, :-1, :]
    out[:, :-1, :] |= binary[:, 1:, :]
    col = out.copy()
    out[:, :, 1:] |= col[:, :, :-1]
    out[:, :, :-1] |= col[:, :, 1:]
    return out


def _to_gray_f32(img: np.ndarray) -> np.ndarray:
    """Any common image format -> float32 grayscale on a 0..255 scale."""
    img = np.asarray(img)
    u16 = img.dtype == np.uint16
    if img.ndim == 3:
        if img.shape[2] == 2:  # gray + alpha
            img = img[..., 0]
        else:  # RGB(A): ITU-R BT.601 luma
            img = img[..., :3] @ np.array([0.299, 0.587, 0.114], np.float32)
    img = img.astype(np.float32)
    if u16:
        return img / 257.0
    if img.size and img.max() <= 1.5:  # 0..1 floats
        img = img * 255.0
    return img


def _expand_quads(quads, px):
    """Push each corner of (B, K, 4, 2) quads away from its quad center
    by ``px`` (erosion-bias pre-compensation; see the scale-2 path)."""
    cen = quads.mean(axis=2, keepdims=True)
    d = quads - cen
    n = np.linalg.norm(d, axis=-1, keepdims=True)
    return quads + d / np.maximum(n, 1e-6) * px


def _chunk_plan(B: int, chunk: int, small: int, cpu: bool,
                forced: int | None = None) -> list:
    """Chunk-size cover of a B-frame batch (see _detect_batch_cold).

    ``cpu`` (natural sizes, see backend.pad_to_fixed_shapes): chunks of
    at most ``chunk``.  Otherwise ``forced`` repeats one size, or a mixed
    plan of ``chunk``-sized pieces plus ``small``-sized tail pieces — both
    shapes precompiled — bounds padding waste by ``small - 1`` frames
    instead of ``chunk - 1`` (padding frames pay the full transfer and
    host-CCL cost)."""
    if B <= 0:
        # an empty batch runs zero chunks; padding an empty slice cannot
        # manufacture the static shape a non-empty plan would promise
        return []
    if cpu:
        sizes = []
        base = forced if forced is not None else chunk
        rem = B
        while rem > 0:
            sizes.append(min(base, rem))
            rem -= sizes[-1]
        return sizes
    if forced is not None:
        return [forced] * ((B + forced - 1) // forced)
    small = min(small, chunk)
    sizes = [chunk] * (B // chunk)
    rem = B - chunk * len(sizes)
    sizes += [small] * ((rem + small - 1) // small)
    return sizes


def _dedup_levels(q1, c1, q2, c2, max_quads):
    """Merge the two erosion levels' quads, dropping level-2 quads whose
    center falls within 0.7x an existing level-1 quad's mean radius
    (duplicates of the same tag blob).  Fully vectorized over the batch —
    no per-frame/per-quad Python on the host."""
    C, half = q1.shape[0], q1.shape[1]
    k = np.arange(half)[None, :]
    m1 = k < c1[:, None]  # (C, half) level-1 validity
    m2 = k < c2[:, None]
    cen1 = q1.mean(axis=2)  # (C, half, 2)
    rad1 = np.linalg.norm(q1 - cen1[:, :, None, :], axis=-1).mean(axis=2)
    cen2 = q2.mean(axis=2)
    d = np.linalg.norm(
        cen1[:, None, :, :] - cen2[:, :, None, :], axis=-1
    )  # (C, half2, half1)
    dup = (d < 0.7 * rad1[:, None, :]) & m1[:, None, :]
    keep2 = m2 & ~dup.any(axis=2)
    # level-1 rows first, then surviving level-2 rows: a stable argsort on
    # ~valid compacts each frame's winners to the front in one shot
    quads_all = np.concatenate([q1, q2], axis=1)  # (C, 2*half, 4, 2)
    valid_all = np.concatenate([m1, keep2], axis=1)
    order = np.argsort(~valid_all, axis=1, kind="stable")
    quads_sorted = np.take_along_axis(quads_all, order[:, :, None, None], axis=1)
    counts = np.minimum(valid_all.sum(axis=1), max_quads).astype(np.int32)
    quads = np.zeros((C, max_quads, 4, 2), np.float32)
    m = min(max_quads, 2 * half)
    quads[:, :m] = quads_sorted[:, :m]
    return quads, counts


class TagDetector:
    """AprilGrid tag detector.

    Args:
      family: family name ("t36h11", "t16h5", ...) or a TagFamily.
      refine: run subpixel corner refinement (default True).
    """

    def __init__(
        self,
        family="t36h11",
        refine: bool = True,
        max_quads: int = MAX_QUADS,
        native_refine: bool = True,  # kept for API compat; refinement now
        # always runs inside the fused device graph
        track: bool | None = None,
        shard: bool | None = None,
    ):
        self.family: TagFamily = (
            family if isinstance(family, TagFamily) else get_family(family)
        )
        self.refine = refine
        self.max_quads = max_quads
        import os

        # pipeline chunk (see detect_batch); CCRS_DETECT_CHUNK overrides
        # for experiments — larger chunks mean fewer host syncs but less
        # host/device overlap and bigger compiled graphs
        self.chunk = int(os.environ.get("CCRS_DETECT_CHUNK", "64"))
        # images at least this wide/tall run candidate extraction on a
        # half-res pyramid level (see detect_batch); tags below ~35 px
        # full-res would degrade at half res, so the default only engages
        # where tags are large by construction
        self.pyramid_min_side = int(os.environ.get("CCRS_PYRAMID_MIN_SIDE", "768"))
        self._bucket = 256  # sticky decode bucket (grows in 256-quad steps,
        # never shrinks — a count hovering at a boundary must not flap the
        # compiled decode shape, and power-of-two doubling wasted up to
        # ~70% of the refine/decode compute as padding)
        # --- steady-state tracking (video fast path; see track.py) ---
        # on by default when a board is supplied; CCRS_TRACK=0 disables
        if track is None:
            track = os.environ.get("CCRS_TRACK", "1") != "0"
        self.track = track
        # anchor-triple cadence: force cold (full-pipeline) frames at least
        # this often, bounding the staleness of the tracking fallback
        # policy's occlusion memory.  Measured on the 534-frame bench
        # sequence (CPU twin, sparse_frac=0.30): K=40 beats K=32 — one
        # fewer serial cold group (3 vs 4), cold frames 116 -> 113, net
        # recall +150
        # (frame,tag) pairs (+238/-88; longer segments hold rim tags the
        # cold candidate stages drop), at +4 device-cheap waves.  K=48
        # backfires: +29 trigger frames, 3 repair resweeps, cold frames
        # 130 (prediction drift at long cadences costs more audits than
        # the anchors save).
        self.cold_every = int(os.environ.get("CCRS_TRACK_COLD_EVERY", "40"))
        # cold-fallback group size: a small dedicated graph shape so
        # correcting a few frames never pays a full-chunk threshold/CCL
        self.cold_chunk = int(os.environ.get("CCRS_TRACK_COLD_CHUNK", "8"))
        # sparse-board cold-direct threshold (fraction of the board the
        # bracketing anchors must see for a segment to be wave-tracked;
        # below it the segment cold-detects up front — see
        # _detect_batch_tracked).  Measured on the 534-frame bench (CPU
        # policy twin): 0.45 -> 0.30 cuts total cold frames 144 -> 116
        # (the +30 audit triggers ride existing sweep groups — group
        # count stays 4) and recall IMPROVES (+33 (frame,tag) pairs, -0):
        # the wave predictor holds rim tags on partially-visible boards
        # that the cold candidate stages drop.  0.45 was tuned when every
        # audit round cost its own serial cold group; the batched-sweep
        # audit consolidation changed the tradeoff.  Below 0.30 nothing
        # changes (the MIN_TRACK_TAGS+2 floor takes over).
        self.sparse_frac = float(
            os.environ.get("CCRS_TRACK_SPARSE_FRAC", "0.30")
        )
        # optional hook: called once per tracked batch with the
        # PROVISIONAL results list right before the audit rounds (see
        # _detect_batch_tracked; calib/pipeline.SpeculativeCalib)
        self.on_provisional = None
        self._tstate = None
        # frame-shard the device stages over the mesh (parallel/mesh.py)
        # when the process sees >1 accelerator device — detection is
        # embarrassingly frame-parallel, so the batch rides the SAME
        # NamedSharding the solvers use (SURVEY.md §5 stretch row).
        # None = auto: shard on a real multi-device accelerator; the
        # 8-virtual-device CPU mesh of the test harness stays opt-in
        # (CCRS_SHARD_DETECT=1 or shard=True) so single-chip behavior is
        # what CI measures by default.
        if shard is None:
            env = os.environ.get("CCRS_SHARD_DETECT")
            shard = env == "1" if env is not None else None
        self.shard = shard

    def _shard_frames(self, arr):
        """device_put a (B, ...) batch with the frame NamedSharding when
        multi-device sharding is on (see ``shard`` in __init__) and B
        divides the mesh; no-op otherwise."""
        import jax

        use = self.shard
        if use is None:
            devs = jax.devices()
            use = len(devs) > 1 and devs[0].platform != "cpu"
        if not use:
            return arr
        devs = jax.devices()
        B = arr.shape[0]
        if len(devs) <= 1:
            log.info("detect: %d frames on one device (1-device mesh)", B)
            return arr
        if B % len(devs) != 0:
            log.info(
                "detect: %d frames on one device, not the %d-device mesh "
                "(the batch does not divide it)", B, len(devs),
            )
            return arr
        from ..parallel.mesh import make_mesh, sharded_frame_sharding

        log.info("detect: %d frames sharded over a %d-device mesh", B, len(devs))
        return jax.device_put(arr, sharded_frame_sharding(make_mesh()))

    def reset_tracking(self) -> None:
        """Drop the frame-to-frame tracking carry (call between cameras /
        unrelated sequences; a stale carry only costs cold fallbacks, not
        correctness)."""
        self._tstate = None

    def begin_tracked(self, board, n_frames: int | None = None):
        """Open a streaming tracked-detection session (see
        tracked.TrackedSession): ``feed`` device chunks as they become
        available, ``finalize`` once for the whole sequence — chunked
        callers then pay the audit-round fixed costs once per sequence
        (not once per chunk) and the provisional hook fires with every
        frame.  ``n_frames``: expected sequence length — lets the
        session preallocate its whole-sequence device buffer so feeds
        land in place (peak HBM O(sequence + chunk), not 2x sequence).
        Returns None when the tracked fast path is unavailable
        (no board / tracking disabled / refine off); callers fall back
        to per-chunk ``detect_batch`` calls."""
        if board is None or not (self.track and self.refine):
            return None
        from .tracked import TrackedSession

        return TrackedSession(self, board, n_frames=n_frames)

    def prewarm(
        self, height: int, width: int, board=None, n_frames: int | None = None
    ) -> None:
        """Execute every device graph of the detect path on dummy inputs.

        Each graph pays its compile (or a persistent-cache load) on first
        execution; calling this on a background thread while the host
        renders/decodes images overlaps those compiles with useful work
        (the thread mostly waits in the compiler, releasing the GIL).
        ``n_frames`` sizes the wave-tracking row bucket for the upcoming
        batch so the real call reuses the warmed graph.  Safe to skip —
        first detection simply pays the compiles itself.
        """
        import jax.numpy as jnp

        scale = 2 if max(height, width) >= self.pyramid_min_side else 1
        # primary decode bucket: a board-driven dataset produces ~n_tags
        # (+ a little clutter) candidates per frame; seed the sticky
        # bucket so the first real chunk reuses the warmed graph, and
        # warm the NEXT rung too — cluttered frames (double-erosion
        # splits, background junk) grow the bucket one rung mid-run
        if board is not None:
            self._mq = max(getattr(self, "_mq", 8), _quad_rung(board.n_tags + 4))
        Mq = getattr(self, "_mq", 8)
        # board rung + two clutter rungs: partial-board frames with
        # double-erosion junk were measured ratcheting the sticky bucket
        # two rungs past the board size (36-tag board -> 96 quads)
        mq_rungs = [Mq, _quad_rung(Mq + 1), _quad_rung(_quad_rung(Mq + 1) + 1)]
        tracked = board is not None and self.track and self.refine
        sizes = [self.chunk, self.cold_chunk]
        primed_d2h = False
        for C in sizes:
            b = jnp.zeros((C, height, width), jnp.uint8)
            tf = threshold_front(b, scale)
            if not primed_d2h:
                # prime the device->host TRANSFER path, not just the
                # executables: a backend may set up its download path
                # lazily on the first d2h copy.  One small fetch here moves
                # that into the prewarm window, overlapped with decoding.
                np.asarray(tf)
                # ...and the host->device upload path, same rationale
                jnp.asarray(np.zeros((8, 4, 2), np.float32)).block_until_ready()
                primed_d2h = True
            else:
                tf.block_until_ready()
            for Mr in mq_rungs:
                qq = jnp.zeros((C, Mr, 4, 2), jnp.float32)
                qv = jnp.zeros((C, Mr), bool)
                out = refine_decode_fused_dense(
                    self.family, b, qq, qv, do_refine=self.refine
                )
                out["valid"].block_until_ready()
            if board is not None:
                # the assist decode variant (reused sharp + maps): both
                # rungs of the candidate bucket ladder
                from .assist import _BUCKET

                for Ma in {min(_BUCKET, board.n_tags), board.n_tags}:
                    aq = jnp.zeros((C, Ma, 4, 2), jnp.float32)
                    av = jnp.zeros((C, Ma), bool)
                    aout = refine_decode_fused_dense(
                        self.family, b, aq, av, do_refine=self.refine,
                        sharp=out["sharp"], maps=out["maps"],
                    )
                    aout["valid"].block_until_ready()
        if tracked:
            from .track import init_wave_carry, wave_advance

            K = max(self.cold_every, 4)
            Wmax = 1
            if n_frames is not None and n_frames >= 4:
                # mirror the triple-anchor layout of _detect_batch_tracked
                # (no streaming carry on a fresh batch): row bucket AND
                # wave count — both key compiled graph shapes
                starts = _anchor_starts(n_frames, K, 0)
                n_segs = max(len(starts) - 1, 1)
                R = -(-2 * n_segs // 8) * 8
                Wmax = max(
                    (
                        (b - a - 3 + 1) // 2
                        for a, b in zip(starts[:-1], starts[1:])
                    ),
                    default=1,
                )
            else:
                R = 8
            self._wave_rows = max(R, getattr(self, "_wave_rows", 0))
            n = board.n_tags
            bxy = jnp.zeros((n, 4, 2), jnp.float32)
            nb_rank = jnp.zeros((n, n), jnp.int32)
            # main sweep rows + the small repair-re-sweep row bucket
            for Rw in {self._wave_rows, 8}:
                z = np.zeros((Rw, n), bool)
                c = np.zeros((Rw, n, 4, 2), np.float32)
                carry = tuple(
                    jnp.asarray(a)
                    for a in init_wave_carry(c, z, c.copy(), z.copy())
                )
                imgs = jnp.zeros((Rw, height, width), jnp.uint8)
                _, outs = wave_advance(
                    self.family, imgs, bxy, nb_rank, jnp.asarray(np.int32(0)),
                    carry, jnp.zeros(Rw, bool),
                )
                outs[1].block_until_ready()
                # the per-wave output stack is one jitted graph PER WAVE
                # COUNT: warm the exact count the mirrored layout
                # produces (unwarmed, the 19-wave stack of a 534-frame
                # batch compiles inside the first real run)
                if Rw == self._wave_rows:
                    _stack_outs(tuple(tuple(outs) for _ in range(Wmax)))[
                        0
                    ].block_until_ready()
                else:
                    _stack_outs((tuple(outs),))
            if n_frames is not None and n_frames > 0:
                # ... the two fixed-shape frame gathers of the cold
                # chunk plan, keyed on the full batch length: they are
                # the first ops of the real detect call, and unwarmed
                # they land in the measured first-run latency
                dummy = jnp.zeros((n_frames, height, width), jnp.uint8)
                # the per-wave row gather (R,) has its own graph shape
                jnp.take(
                    dummy,
                    jnp.asarray(np.zeros(self._wave_rows, np.int32)),
                    axis=0,
                ).block_until_ready()
                for C in {self.chunk, self.cold_chunk}:
                    idxs = np.zeros(min(C, n_frames) or 1, np.int32)
                    jnp.take(
                        dummy, jnp.asarray(idxs), axis=0
                    ).block_until_ready()
                del dummy

    # ----------------------------------------------------- shared helpers
    def _extract_quads(self, b1, board, scale):
        """Native quad extraction over a (C, sH, sW) binary batch: both
        erosion levels, level-2 need heuristics, scale compensation and
        dedup.  Returns (quads (C, max_quads, 4, 2) full-res px, counts)."""
        half = self.max_quads // 2
        q1, c1 = extract_quads_batch(b1, max_quads=half)
        # Level 2 exists to split tags that the first erosion left
        # bridged into crosses — a LARGE-tag phenomenon (the
        # corner-square bridges grow with tag scale; measured to
        # appear around ~140 px tags, commit "dual-erosion").  A
        # frame may skip the second native pass (the single host
        # core pays ~2.3 ms/frame/level) only when BOTH hold:
        # level-1 already yielded >= n_tags candidates AND every
        # candidate is small-tag-regime sized — real imagery has
        # background clutter that inflates the count alone
        # (measured: euroc.png 99 / tum_vi 86 candidates for 36
        # tags), so the count by itself must never gate the pass.
        q2 = np.zeros_like(q1)
        c2 = np.zeros_like(c1)
        if board is None:
            need = np.arange(b1.shape[0])
        else:
            big_area = (100.0 / scale) ** 2  # ~100 px tag side
            need_l = []
            for b in range(b1.shape[0]):
                n1 = int(c1[b])
                if n1 < board.n_tags:
                    need_l.append(b)
                    continue
                x = q1[b, :n1, :, 0]
                y = q1[b, :n1, :, 1]
                a2 = np.einsum(
                    "qn,qn->q", x, np.roll(y, -1, 1)
                ) - np.einsum("qn,qn->q", np.roll(x, -1, 1), y)
                if 0.5 * np.abs(a2).max() >= big_area:
                    need_l.append(b)
            need = np.asarray(need_l, np.int64)
        if need.size:
            b2 = _dilate_white_host(b1[need])
            q2n, c2n = extract_quads_batch(b2, max_quads=half)
            q2[need] = q2n
            c2[need] = c2n
        if scale == 2:
            # Erosion shrinks black blobs ~1 px per edge per
            # dilation at the PYRAMID resolution (2 full px) and
            # the pooling blur adds ~1 more: measured ~4.5 px
            # inward corner bias for level 1 (vs ~1.4 px on the
            # full-res path) and ~2 px more for the
            # doubly-eroded level 2.  Pre-expand along the
            # outward diagonal (in pyramid units, before the
            # center-based dedup) so the subpixel refinement
            # (total shift clamped to its 4 px window) starts
            # inside its capture radius.
            q1 = _expand_quads(q1, 1.5)
            q2 = _expand_quads(q2, 2.75)
        quads, counts = _dedup_levels(q1, c1, q2, c2, self.max_quads)
        if scale == 2:
            # pyramid pixel (r, c) covers full-res [2r, 2r+1] x
            # [2c, 2c+1]; its center sits at 2x + 0.5
            quads = quads * 2.0 + 0.5
        return quads, counts

    def _dispatch_decode(self, dev_chunk, quads, counts):
        """Truncate the (C, K) quad buffer to the sticky per-frame bucket
        and enqueue the DENSE fused refine+decode graph (all sampling per
        image over whole-image maps; see decode.refine_decode_fused_dense).
        Returns the decode-output dict."""
        C = dev_chunk.shape[0]
        n_real = np.minimum(counts, quads.shape[1])
        need = int(n_real.max()) if n_real.size else 1
        # grow-only on a ~1.5x geometric rung ladder (8, 16, 24, 40, 64,
        # 96, ...): boundary-hovering per-frame counts must not flap the
        # compiled decode shape, and the ladder caps the number of
        # distinct decode graphs a dataset can create (each a compile) at
        # ~2 — prewarm() warms the
        # board rung AND the next one for clutter headroom
        self._mq = max(getattr(self, "_mq", 8), _quad_rung(need))
        Mq = min(self._mq, quads.shape[1])
        qq = np.ascontiguousarray(quads[:, :Mq], np.float32)
        qv = np.arange(Mq)[None, :] < n_real[:, None]
        out = refine_decode_fused_dense(
            self.family, dev_chunk, jnp.asarray(qq),
            jnp.asarray(qv), do_refine=self.refine,
        )
        _async_fetch(out[k] for k in ("tag_id", "hamming", "valid", "corners"))
        return out

    def _collect_results(self, out, nb) -> List[Dict[int, np.ndarray]]:
        """Fetch dense decode outputs and build per-frame
        {tag_id: corners}, keeping the lowest-hamming quad per
        (frame, tag).  Winner selection is a vectorized lexsort group-by;
        Python touches only the final detections (r02 verdict #8)."""
        tag_id = np.asarray(out["tag_id"]).reshape(-1)
        hamming = np.asarray(out["hamming"]).reshape(-1)
        valid = np.asarray(out["valid"]).reshape(-1)
        C, Mq = out["valid"].shape
        corners = np.asarray(out["corners"]).reshape(C * Mq, 4, 2)
        qf = np.repeat(np.arange(C, dtype=np.int32), Mq)

        results: List[Dict[int, np.ndarray]] = [dict() for _ in range(nb)]
        idx = np.flatnonzero(valid)
        if idx.size:
            fr = qf[idx]
            tid = tag_id[idx]
            ham = hamming[idx]
            order = np.lexsort((ham, tid, fr))
            fr, tid, qi = fr[order], tid[order], idx[order]
            first = np.ones(order.size, bool)
            first[1:] = (fr[1:] != fr[:-1]) | (tid[1:] != tid[:-1])
            for b, t, q in zip(fr[first], tid[first], qi[first]):
                if b < nb:
                    results[b][int(t)] = corners[q].copy()
        return results

    # ------------------------------------------------------------- batched
    def detect_batch(
        self, images, board=None, dev_images=None
    ) -> List[Dict[int, np.ndarray]]:
        """Detect tags in a batch of images.

        Args:
          images: (B, H, W) or (B, H, W, C) uint8/float array-like.
          board: optional Board — enables the board-assisted recovery pass
            (predict missed tags from the geometry of decoded neighbors).
          dev_images: optional (B, H, W) jax array already on device
            (uint8/f32); skips the host->device upload when the producer
            (e.g. the on-device renderer) kept the batch resident.

        Returns:
          list of {tag_id: (4, 2) float32 corners} per image, corner order
          TL, TR, BR, BL in the tag's canonical orientation (board corner
          ids tag*4 + {0,1,2,3}).
        """
        if images is None:
            if dev_images is None:
                raise ValueError("need images or dev_images")
            dev_all = dev_images
        elif dev_images is not None:
            dev_all = dev_images
        else:
            raw = np.asarray(images)
            if raw.ndim == 3 and raw.dtype == np.uint8:
                # raw uint8 upload (4x fewer bytes than f32); threshold,
                # refine and decode cast on device
                dev_all = jnp.asarray(raw)
            else:
                dev_all = jnp.asarray(np.stack([_to_gray_f32(im) for im in raw]))
        dev_all = self._shard_frames(dev_all)
        B, H, W = dev_all.shape

        # Video fast path: board-informed wave tracking (see track.py).
        # Suspect frames fall back to the cold pipeline via the audit
        # policy; whole-batch cold is kept for board-less use.
        if board is not None and self.track and self.refine and B > 0:
            return self._detect_batch_tracked(dev_all, board)
        return self._detect_batch_cold(dev_all, board)

    def _detect_batch_cold(
        self, dev_all, board, chunk: int | None = None, idx=None
    ) -> List[Dict[int, np.ndarray]]:
        """The full (cold) detection pipeline over a device-resident batch:
        threshold -> bitmap download -> native CCL quad extraction ->
        fused refine+decode -> board-assist recovery, pipelined in three
        phases across fixed-size chunks (see the class docstring).

        ``chunk`` forces a single chunk size; by default the batch is
        covered by a MIXED plan of ``self.chunk``-sized chunks plus
        ``cold_chunk``-sized tail chunks (both shapes are precompiled), so
        a 534-frame batch pads to 536 frames of real work instead of 576 —
        padding frames pay the full transfer and host-CCL cost, so the plan
        matters.

        ``idx``: optional int array of frame indices into ``dev_all`` to
        detect (the tracking audits use this); results are returned in
        ``idx`` order.  Frames are pulled per chunk with a fixed-shape
        gather — the same two compiled gather graphs serve contiguous
        batches, sweep subsets, and tail padding alike (per-offset device
        slices plus repeat/concat padding each compiled their own one-op
        graph).
        """
        B_img, H, W = dev_all.shape
        B = int(len(idx)) if idx is not None else B_img

        # Enqueue every chunk's threshold up front (dispatch is async), so
        # the packed-bitmap downloads of chunk i overlap the device work of
        # chunks i+1...
        #
        # Under backend.pad_to_fixed_shapes() chunk shapes come from the
        # FIXED two-size set {self.chunk, self.cold_chunk} even for small
        # batches (padding with repeated frames): every distinct shape
        # compiles its own graphs, so a 24-image dataset reuses the same
        # executables as a 600-image one.  Otherwise small batches keep
        # their natural size.
        from ..utils.backend import pad_to_fixed_shapes

        sizes = _chunk_plan(
            B, self.chunk, self.cold_chunk, not pad_to_fixed_shapes(), chunk
        )
        offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        n_chunks = len(sizes)

        # Large-image fast path: the pixel-proportional candidate stages
        # (adaptive threshold, bitmap download, native CCL/contour quad
        # extraction) run at HALF resolution when the image is >=
        # pyramid_min_side px a side — tags in that regime are big enough
        # that a 2x2-mean pyramid level loses no candidates, while the
        # download shrinks 4x and the single-core C++ stage sees 4x fewer
        # pixels.  Subpixel refinement and decode bit-sampling always use
        # the FULL-resolution frames (the extracted quads are scaled back
        # below), so accuracy is unchanged.
        scale = 2 if max(H, W) >= self.pyramid_min_side else 1
        sH, sW = H // scale, W // scale
        sel_all = (
            np.asarray(idx, np.int64)
            if idx is not None
            else np.arange(B, dtype=np.int64)
        )
        dev_chunks, packed_chunks = [], []
        for ci in range(n_chunks):
            lo, C = int(offsets[ci]), sizes[ci]
            sel = sel_all[lo : lo + C]
            if len(sel) < C:  # pad final chunk to keep shapes static
                sel = np.concatenate([sel, np.repeat(sel[-1:], C - len(sel))])
            part = jnp.take(dev_all, jnp.asarray(sel.astype(np.int32)), axis=0)
            dev_chunks.append(part)
            # ONE fused graph (pool + pad + threshold + pack): separate
            # dispatches each add a launch per chunk and a compile at
            # warmup (threshold.threshold_front, which prewarm() warms —
            # keep the two in lockstep)
            packed_chunks.append(threshold_front(part, scale))
        # packed width after pad_to_tile, computed host-side (a device
        # probe slice would compile its own one-op graph)
        from .threshold import TILE as _TILE

        wmul = _TILE * 8 // np.gcd(_TILE, 8)
        pw = sW + ((-sW) % wmul)

        # Prefetch the packed bitmaps with device->host async copies: the
        # copies enqueue behind each chunk's threshold compute and stream
        # to the host while it CCLs earlier chunks, so the np.asarray below
        # is a free pickup.
        _async_fetch(packed_chunks)

        # Phase 1: host quad extraction per chunk; enqueue fused
        # refine+decode (result fetched in phase 2 — device runs ahead).
        pending = []
        for ci in range(n_chunks):
            with stage("detect/threshold"):
                packed = np.asarray(packed_chunks[ci])  # (C, sHp, sWp/8)
                b1 = np.unpackbits(packed, axis=-1, count=pw)[:, :sH, :sW]
            with stage("detect/quadproc"):
                quads, counts = self._extract_quads(b1, board, scale)
            with stage("detect/dispatch"):
                out = self._dispatch_decode(dev_chunks[ci], quads, counts)
            pending.append(out)

        # Phase 2: fetch decode outputs; enqueue the assist decode.
        all_chunk_results: List[List[Dict[int, np.ndarray]]] = []
        assist_pending = []
        for ci in range(n_chunks):
            out = pending[ci]
            nb = min(sizes[ci], B - int(offsets[ci]))
            with stage("detect/decode"):
                chunk_results = self._collect_results(out, nb)
            all_chunk_results.append(chunk_results)

            if board is not None:
                from .assist import assist_candidates

                with stage("detect/assist"):
                    # candidate buffers must span the PADDED chunk (the
                    # fused decode vmaps them against dev_chunks[ci]); a
                    # padded tail chunk (nb < C) with assist work
                    # otherwise crashes the vmap with mismatched leading
                    # dims.  Padding rows are empty dicts -> no
                    # candidates -> exp_id -1, which the merge ignores.
                    C_pad = dev_chunks[ci].shape[0]
                    aq, av, aexp = assist_candidates(
                        board,
                        chunk_results + [{}] * (C_pad - len(chunk_results)),
                        W, H,
                    )
                    if aq is not None:
                        aout = refine_decode_fused_dense(
                            self.family, dev_chunks[ci], jnp.asarray(aq),
                            jnp.asarray(av), do_refine=self.refine,
                            # reuse the primary pass's device-resident
                            # sharpened frames and KLT maps (skips a
                            # second unsharp + map build over the chunk)
                            sharp=out["sharp"], maps=out["maps"],
                        )
                        _async_fetch(
                            aout[k] for k in ("tag_id", "hamming", "corners")
                        )
                        assist_pending.append((ci, aexp, aout))

        # Phase 3: fetch + merge assist results.
        if assist_pending:
            from .assist import assist_merge

            with stage("detect/assist"):
                for ci, aexp, aout in assist_pending:
                    assist_merge(self.family, aexp, aout, all_chunk_results[ci])

        return [r for chunk in all_chunk_results for r in chunk]

    # --------------------------------------------------- tracking fast path
    def _detect_batch_tracked(self, dev_all, board):
        """Wave-tracking video fast path — see detect/tracked.py."""
        from .tracked import detect_batch_tracked

        return detect_batch_tracked(self, dev_all, board)

    # -------------------------------------------------------------- single
    def detect(self, image) -> Dict[int, np.ndarray]:
        """Single-image detection (reference-compatible convenience)."""
        return self.detect_batch(np.asarray(image)[None])[0]
