"""Lockstep helpers: the anchor layout and quad-bucket ladder key
compiled graph shapes, and prewarm() mirrors them — drift between the
mirror and the real path silently reintroduces first-run compiles
(the round-3 warmup regression)."""

import numpy as np

from ccrs_jax.detect.detector import _anchor_starts, _quad_rung


def test_anchor_starts_cover_every_frame():
    for B in (4, 5, 7, 8, 40, 41, 128, 534, 1000):
        for K in (4, 8, 32, 40, 48):
            starts = _anchor_starts(B, K, 0)
            # B < 6: the tail anchor replaces the head one (frames before
            # it are recovered by the audit path, not a sweep segment)
            assert starts[0] == (0 if B >= 6 else B - 3)
            assert starts[-1] == B - 3
            # every frame lies inside some [start, next_start+2] segment
            # (anchors are triples at start, start+1, start+2)
            seg_ok = np.zeros(B, bool)
            for a, b in zip(starts, starts[1:]):
                seg_ok[a : b + 3] = True
            seg_ok[starts[-1] :] = True
            # head frames before the first anchor (B < 6 only) fall to
            # the audit path rather than a sweep segment
            assert seg_ok[starts[0] :].all(), (B, K, starts)
            assert starts[0] < 3, (B, K, starts)
            # segments are non-degenerate and in order
            assert all(b > a for a, b in zip(starts, starts[1:]))


def test_anchor_starts_tail_never_overlaps():
    # the tail anchor replaces a grid anchor closer than 3 frames
    for B in range(6, 100):
        starts = _anchor_starts(B, 8, 0)
        gaps = [b - a for a, b in zip(starts, starts[1:])]
        assert all(g >= 3 for g in gaps), (B, starts)


def test_quad_rung_ladder():
    assert [_quad_rung(n) for n in (1, 8, 9, 16, 17, 25, 41, 65, 97)] == [
        8, 8, 16, 16, 24, 40, 64, 96, 144
    ]
    # monotone, 8-aligned, bounded growth
    prev = 0
    for n in range(1, 400):
        r = _quad_rung(n)
        assert r >= n and r % 8 == 0 and r >= prev
        assert r <= max(16, 2 * n)  # never pads more than ~2x
        prev = r


def test_prewarm_wave_count_matches_layout():
    """The Wmax formula prewarm mirrors equals the one the tracked path
    derives from the same starts list."""
    for B in (16, 128, 534, 531, 72):
        for K in (32, 40):
            starts = _anchor_starts(B, K, 0)
            n_list = [b - a - 3 for a, b in zip(starts, starts[1:])]
            wmax_real = max(((n + 1) // 2 for n in n_list), default=0)
            wmax_mirror = max(
                ((b - a - 3 + 1) // 2 for a, b in zip(starts[:-1], starts[1:])),
                default=1,
            )
            assert wmax_real == wmax_mirror or (wmax_real == 0 and wmax_mirror == 1)
