"""Tracking fast-path tests: recall parity with the cold detector.

The video fast path (ccrs_jax/detect/track.py) must never silently drop a
tag the cold pipeline would find — the fallback trigger policy re-runs the
cold pipeline on any suspect frame, so per-frame detections are a superset
of the cold detector's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ccrs_jax.board import create_default_6x6_board
from ccrs_jax.detect import TagDetector, get_family
from ccrs_jax.models import GenericModel
from ccrs_jax.testdata import (
    render_board_image,
    smooth_sequence_poses,
)


@pytest.fixture(scope="module")
def video():
    """A 14-frame smooth synthetic sequence (512x512 EUCM fisheye)."""
    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses = smooth_sequence_poses(14, board, seed=3, keyframe_every=6)
    imgs = np.stack(
        [
            render_board_image(model, board, fam, p[:3], p[3:], noise=1.5, seed=f)
            for f, p in enumerate(poses)
        ]
    )
    return board, imgs


def test_track_recall_superset(video):
    """Per frame, tracked detections >= cold detections (same tags, and
    matching corners for the shared ones)."""
    board, imgs = video
    cold = TagDetector("t36h11", track=False).detect_batch(imgs, board=board)
    trk = TagDetector("t36h11", track=True).detect_batch(imgs, board=board)
    assert len(cold) == len(trk) == imgs.shape[0]
    for f, (c, t) in enumerate(zip(cold, trk)):
        missing = set(c) - set(t)
        assert not missing, f"frame {f}: tracking dropped tags {missing}"
        for tid in c:
            # both paths refine on the same image; sub-0.1 px agreement
            np.testing.assert_allclose(t[tid], c[tid], atol=0.2)


def test_track_bounded_staleness_marginal_sequence(bench_like_video):
    """The tracking guarantee on MARGINAL (rim-flickering) sequences:
    every suspect frame is audited, so a tag cold can find is never
    missing for more than the known-bad TTL (cold_every + 2) plus the
    repair window, and overall detection count matches or beats cold.
    (Strict per-frame parity on marginal tags is not a goal: both
    pipelines flicker on them with weak correlation; see detector.py
    merge_frame.)"""
    board, imgs = bench_like_video
    det = TagDetector("t36h11", track=True)
    trk = det.detect_batch(imgs, board=board)
    cold = TagDetector("t36h11", track=False).detect_batch(imgs, board=board)
    run_len: dict = {}
    worst = 0
    n_missed = n_cold = 0
    for c, t in zip(cold, trk):
        n_cold += len(c)
        m = set(c) - set(t)
        n_missed += len(m)
        for tid in list(run_len):
            if tid not in m:
                run_len.pop(tid)
        for tid in m:
            run_len[tid] = run_len.get(tid, 0) + 1
            worst = max(worst, run_len[tid])
    ttl = det.cold_every + 2
    assert worst <= ttl + 2, f"tag missing {worst} consecutive frames"
    assert n_missed <= 0.05 * n_cold, f"missed {n_missed}/{n_cold}"
    n_trk = sum(len(t) for t in trk)
    assert n_trk >= n_cold, "tracking should find at least as many tags overall"


@pytest.fixture(scope="module")
def bench_like_video():
    """48 frames of the bench's own smooth-video regime (device render)."""
    from ccrs_jax.models import GenericModel
    from ccrs_jax.testdata import render_frames_device

    board = create_default_6x6_board()
    gt = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses = smooth_sequence_poses(48, board, seed=11)
    imgs = np.asarray(
        render_frames_device(
            gt, board, get_family("t36h11"), poses, noise=1.5, seed=11
        )
    ).astype(np.uint8)
    return board, imgs


def test_track_steady_state_uses_fast_path(bench_like_video):
    """On realistic smooth video the cold fallback runs on a small
    minority of frames — the fast path must actually carry the load."""
    from ccrs_jax.utils import profiling

    board, imgs = bench_like_video
    det = TagDetector("t36h11", track=True)
    profiling.enable()
    profiling.reset()
    res = det.detect_batch(imgs, board=board)
    totals = profiling.totals()
    profiling.reset()
    profiling._ENABLED = False
    assert "detect/track" in totals
    assert det.stats["cold_frames"] <= len(res) // 3, det.stats
    assert det.stats["trigger_frames"] <= 8, det.stats
    assert all(len(r) >= 20 for r in res)


def test_track_discontinuous_falls_back(video):
    """A shuffled (non-video) sequence must still match the cold detector
    exactly — every frame fails the trigger audit and re-runs cold."""
    board, imgs = video
    order = [5, 0, 9, 2, 12, 7]
    shuffled = imgs[order]
    cold = TagDetector("t36h11", track=False).detect_batch(shuffled, board=board)
    trk = TagDetector("t36h11", track=True).detect_batch(shuffled, board=board)
    for f, (c, t) in enumerate(zip(cold, trk)):
        assert set(c) <= set(t), f"frame {f}: lost {set(c) - set(t)}"


def test_track_carry_across_calls(bench_like_video):
    """detect_batch called chunk-wise (like the dataloader) keeps the
    carry and stays consistent with one whole-batch call."""
    board, imgs = bench_like_video
    det = TagDetector("t36h11", track=True)
    whole = det.detect_batch(imgs, board=board)
    det2 = TagDetector("t36h11", track=True)
    parts = det2.detect_batch(imgs[:24], board=board) + det2.detect_batch(
        imgs[24:], board=board
    )
    # chunk boundaries shift the audit cadence, so marginal tags may
    # differ by a flicker; the bulk of each frame must agree exactly
    for f, (a, b) in enumerate(zip(whole, parts)):
        assert len(set(a) ^ set(b)) <= 2, f"frame {f}: {set(a) ^ set(b)}"
        for tid in set(a) & set(b):
            np.testing.assert_allclose(a[tid], b[tid], atol=0.2)


def test_tracked_session_streaming_matches_whole_batch(bench_like_video):
    """The streaming session (chunked feeds + one finalize) must agree
    with the whole-batch call: chunk boundaries only shift the anchor
    cadence, so marginal tags may flicker, but the bulk of each frame
    matches exactly and the audit guarantee holds across the merge."""
    board, imgs = bench_like_video  # 48 frames
    det = TagDetector("t36h11", track=True)
    whole = det.detect_batch(imgs, board=board)

    det2 = TagDetector("t36h11", track=True)
    s = det2.begin_tracked(board)
    assert s is not None
    s.feed(jnp.asarray(imgs[:20]))
    s.feed(jnp.asarray(imgs[20:40]))
    # padded tail (the dataloader pads ragged tails to the batch shape)
    tail = np.concatenate([imgs[40:], np.repeat(imgs[-1:], 12, 0)])
    s.feed(jnp.asarray(tail), n_valid=8)
    parts = s.finalize()
    assert len(parts) == 48
    n_whole = sum(len(r) for r in whole)
    n_parts = sum(len(r) for r in parts)
    assert abs(n_whole - n_parts) <= 0.01 * n_whole, (n_whole, n_parts)
    for f, (a, b) in enumerate(zip(whole, parts)):
        # chunk-boundary frames flip between anchor(cold) and tracked
        # roles, and tracking holds rim tags the cold candidate stages
        # drop — a few marginal tags may differ per frame (same bound
        # regime as test_track_carry_across_calls, plus the tail anchor)
        assert len(set(a) ^ set(b)) <= 4, f"frame {f}: {set(a) ^ set(b)}"
        # shared tags agree to refine tolerance, except marginal tags a
        # different audit layout recovered via a different mechanism
        # (tracked refine vs cold+assist) — allow <=2 such outliers
        bad = sum(
            1
            for tid in set(a) & set(b)
            if np.abs(a[tid] - b[tid]).max() > 0.25
        )
        assert bad <= 2, f"frame {f}: {bad} corner outliers"
    assert det2.stats["frames"] == 60  # padded count (bookkeeping sanity)


def test_tracked_session_prealloc_buffer(bench_like_video):
    """With an ``n_frames`` hint the session preallocates its
    whole-sequence device buffer and places feeds in place (peak HBM
    O(sequence + chunk)); results must be identical to the buffering
    (no-hint) composition — same frames through the same whole-batch
    detection."""
    board, imgs = bench_like_video  # 48 frames
    det = TagDetector("t36h11", track=True)
    s = det.begin_tracked(board, n_frames=48)
    assert s is not None
    s.feed(jnp.asarray(imgs[:20]))
    assert s._buf is not None and not s.chunks  # placement path engaged
    assert s._buf.shape[0] == 60  # ceil(48/20)*20
    s.feed(jnp.asarray(imgs[20:40]))
    tail = np.concatenate([imgs[40:], np.repeat(imgs[-1:], 12, 0)])
    s.feed(jnp.asarray(tail), n_valid=8)
    res_hint = s.finalize()

    det2 = TagDetector("t36h11", track=True)
    s2 = det2.begin_tracked(board)  # no hint: buffer + concatenate
    s2.feed(jnp.asarray(imgs[:20]))
    assert s2._buf is None and len(s2.chunks) == 1
    s2.feed(jnp.asarray(imgs[20:40]))
    s2.feed(jnp.asarray(tail), n_valid=8)
    res_concat = s2.finalize()

    assert len(res_hint) == len(res_concat) == 48
    for f, (a, b) in enumerate(zip(res_hint, res_concat)):
        assert set(a) == set(b), f"frame {f}: {set(a) ^ set(b)}"
        for tid in a:
            np.testing.assert_array_equal(a[tid], b[tid])


def test_tracked_session_padding_not_in_carry(bench_like_video):
    """Tail padding must not leak into the streaming carry: after a
    padded finalize the global frame counter advances by the VALID
    count only, and the carry triple is the last three VALID frames —
    a zero-velocity pad triple would mispredict the next call's first
    segment and shift known_bad TTL windows (round-5 review fix)."""
    board, imgs = bench_like_video  # 48 frames
    det = TagDetector("t36h11", track=True)
    s = det.begin_tracked(board)
    tail = np.concatenate([imgs, np.repeat(imgs[-1:], 12, 0)])  # 60 padded
    s.feed(jnp.asarray(tail), n_valid=48)
    res = s.finalize()
    assert len(res) == 48
    st = det._tstate
    assert st["frame_idx"] == 48  # not the padded 60
    # the carry is the last three VALID frames' results
    for carry_r, valid_r in zip(st["prev"], res[45:48]):
        assert set(carry_r) == set(valid_r)
        for tid in carry_r:
            np.testing.assert_array_equal(carry_r[tid], valid_r[tid])


def test_tracked_session_short_chunks(video):
    """Tiny feeds (including a too-short-to-track 3-frame tail) must still
    produce audited per-frame results equal in coverage to the cold
    detector — the audit phase is the recall guarantee regardless of how
    the stream was chunked."""
    board, imgs = video  # 14 frames
    cold = TagDetector("t36h11", track=False).detect_batch(imgs, board=board)
    det = TagDetector("t36h11", track=True)
    s = det.begin_tracked(board)
    s.feed(jnp.asarray(imgs[:5]))
    s.feed(jnp.asarray(imgs[5:11]))
    s.feed(jnp.asarray(imgs[11:]))  # 3 frames: below the tracking minimum
    res = s.finalize()
    assert len(res) == 14
    for f, (c, t) in enumerate(zip(cold, res)):
        missing = set(c) - set(t)
        assert not missing, f"frame {f}: session dropped tags {missing}"


def test_tracked_session_provisional_fires_once_with_all_frames(
    bench_like_video,
):
    """The session's provisional hook must fire at most once, with the
    full (unpadded) frame list — chunked callers get working speculation.
    When it fires, results must already carry the
    steady-state detections (audit corrections are the only delta)."""
    board, imgs = bench_like_video
    det = TagDetector("t36h11", track=True)
    calls = []
    det.on_provisional = lambda results: calls.append(results)
    s = det.begin_tracked(board)
    s.feed(jnp.asarray(imgs[:24]))
    tail = np.concatenate([imgs[24:], np.repeat(imgs[-1:], 0, 0)])
    s.feed(jnp.asarray(tail))
    final = s.finalize()
    assert len(calls) <= 1
    if det.stats["trigger_frames"] > 0:
        # audits existed, so the hook must have fired (lazy-fire rule)
        assert len(calls) == 1
        assert len(calls[0]) == 48
        # provisional detections are near-final: most frames already full
        assert sum(len(r) >= 20 for r in calls[0]) >= 40
    assert len(final) == 48


def _board_xy(board):
    return board.p3d.reshape(board.n_tags, 4, 3)[:, :, :2]


def test_neighbor_rank_breaks_ties_by_index():
    from ccrs_jax.detect.track import neighbor_rank

    board = create_default_6x6_board()
    n = board.n_tags
    rank = neighbor_rank(_board_xy(board))
    assert rank.dtype == np.int32
    assert (np.sort(rank, axis=1) == np.arange(n)).all()  # permutations
    assert (np.diag(rank) == 0).all()
    # corner tag 0: the right (1) and lower (6) neighbors tie at one
    # spacing, the diagonal (7) follows; tags 2 and 12 tie at two spacings
    assert (rank[0, 1], rank[0, 6], rank[0, 7]) == (1, 2, 3)
    assert rank[0, 2] + 1 == rank[0, 12]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.booleans(), min_size=36, max_size=36))
def test_nearest_valid_matches_sorted_reference(valid):
    """The 4 neighbors the predictors fit are the nearest tags with a
    detection, ties to the lower index: a stable sort of the exact grid
    distances of the 6x6 board."""
    from ccrs_jax.detect.track import N_NEIGHBORS, _nearest_valid, neighbor_rank

    board = create_default_6x6_board()
    bxy = _board_xy(board)
    valid = np.asarray(valid)
    idx, ok = jax.jit(_nearest_valid)(
        jnp.asarray(neighbor_rank(bxy)), jnp.asarray(valid)
    )
    idx, ok = np.asarray(idx), np.asarray(ok)
    rc = np.array([divmod(i, 6) for i in range(board.n_tags)])
    d2 = ((rc[:, None] - rc[None]) ** 2).sum(-1)
    cand = np.flatnonzero(valid)
    for i in range(board.n_tags):
        want = cand[np.argsort(d2[i, cand], kind="stable")][:N_NEIGHBORS]
        assert ok[i] == (len(cand) >= N_NEIGHBORS)
        if ok[i]:
            assert idx[i].tolist() == want.tolist()


def test_wave_advance_graph_direct():
    """Unit-level: wave_advance decodes tags from an exact-prediction seed,
    masks inactive rows, and reports acc <= att.

    NOTE: this test (and its neighbors) compiles fresh wave_advance
    executables late in the suite, which used to crash the process: XLA:CPU
    JIT code maps are never unmapped and the suite exhausts the kernel's
    default vm.max_map_count — conftest.py raises the limit (or bypasses
    the persistent cache when it can't).
    """
    from ccrs_jax.detect.track import (
        detections_to_arrays,
        init_wave_carry,
        neighbor_rank,
        wave_advance,
    )

    board = create_default_6x6_board()
    fam = get_family("t36h11")
    model = GenericModel(
        "eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046], 512, 512
    )
    poses = smooth_sequence_poses(3, board, seed=5, keyframe_every=16)
    imgs = np.stack(
        [
            render_board_image(model, board, fam, p[:3], p[3:], noise=1.0, seed=f)
            for f, p in enumerate(poses)
        ]
    )
    cold = TagDetector("t36h11", track=False).detect_batch(
        imgs[:2], board=board
    )
    assert len(cold[1]) >= 20
    n = board.n_tags
    c1, v1 = detections_to_arrays(cold[1], board)
    c2, v2 = detections_to_arrays(cold[0], board)
    R = 2  # row 0: real sweep seeded from frames 0/1; row 1: inactive pad
    c1r = np.stack([c1, c1])
    v1r = np.stack([v1, v1])
    c2r = np.stack([c2, c2])
    v2r = np.stack([v2, v2])
    bxy_np = board.p3d.reshape(n, 4, 3)[:, :, :2]
    bxy = jnp.asarray(bxy_np.astype(np.float32))
    carry = tuple(
        jnp.asarray(a) for a in init_wave_carry(c1r, v1r, c2r, v2r)
    )
    active = jnp.asarray(np.array([True, False]))
    wave_imgs = jnp.asarray(np.stack([imgs[2], imgs[2]]))
    carry2, (cor, acc, att, ben) = wave_advance(
        fam, wave_imgs, bxy, jnp.asarray(neighbor_rank(bxy_np)),
        jnp.asarray(np.int32(board.config.first_id)),
        carry, active,
    )
    acc = np.asarray(acc)
    att = np.asarray(att)
    # the active row tracks the small motion; the inactive row does nothing
    assert acc[0].sum() >= len(cold[1]) - 2
    assert att[1].sum() == 0 and acc[1].sum() == 0
    assert (acc <= att).all()
    # the carry advanced: c1 slot of the new carry holds accepted corners
    new_c1, new_v1 = np.asarray(carry2[4]), np.asarray(carry2[5])
    assert (new_v1[0] == acc[0]).all()


def test_no_audits_no_speculation(video, monkeypatch):
    """The provisional hook must fire ONLY when an audit round exists:
    with zero audits there is nothing to overlap, and a speculation the
    caller joins SERIALIZES in front of the final solve (measured
    +0.08 s on the clean 128-frame 1024 bench regime)."""
    import ccrs_jax.detect.audit as audit_mod

    board, imgs = video
    # a batch that audits (the noisy fixture) fires the hook once
    det = TagDetector("t36h11", track=True)
    fired = []
    det.on_provisional = lambda res: fired.append(len(res))
    det.detect_batch(imgs, board=board)
    assert det.stats["trigger_frames"] > 0
    assert fired == [len(imgs)]

    # the same batch with no suspects (policy reports none) must not
    monkeypatch.setattr(
        audit_mod.AuditPolicy, "plan_round", lambda self, *a: None
    )
    det2 = TagDetector("t36h11", track=True)
    fired2 = []
    det2.on_provisional = lambda res: fired2.append(len(res))
    det2.detect_batch(imgs, board=board)
    assert det2.stats["trigger_frames"] == 0
    assert fired2 == [], "hook fired with nothing to overlap"
