"""Checks of the detect path on the GPU against the same code on the host
CPU backend, at the widths of the 512x512 mono regime.

They carry the ``gpu`` marker and skip where JAX finds no GPU.  On a machine
with one, ``CCRS_TESTS_ON_GPU=1 python -m pytest -m gpu tests/`` runs them;
phase (d) of chip_smoke.py runs them in its own process.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from detect_vs_cpu import detect_like_cli  # noqa: E402

pytestmark = pytest.mark.gpu

# A different fusion order on the card reassociates the f32 sums of the
# iterative subpixel refine: the bound of the chunk-shape tests in
# test_detector.py, held on 16 frames.
CORNER_PX = 5e-3
# Over the whole video a few corners are poorly conditioned (on the H100,
# every tag more than 5e-3 px apart sat 0.5 to 4.3 px off ground truth):
# the fixed 12 Newton steps of the refine do not iterate away the f32
# differences of its start point (tracked: a prediction carried through
# the frames before) or of its sums.  The largest gaps read 7.0e-3 px
# (cold, one corner of ~72,000) and 1.04e-2 px (tracked).  The bound is
# twice the larger; the tag sets must be equal.
VIDEO_CORNER_PX = 2e-2


@pytest.fixture(scope="module")
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture(scope="module")
def video(gpu):
    """The smoke's whole 534-frame 512x512 EUCM video, rendered on the card."""
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import get_family
    from ccrs_jax.models import GenericModel
    from ccrs_jax.testdata import render_frames_device, smooth_sequence_poses

    board = create_default_6x6_board()
    gt = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046],
                      512, 512)
    poses = smooth_sequence_poses(534, board, seed=11)
    return np.asarray(render_frames_device(gt, board, get_family("t36h11"),
                                           poses, noise=1.5, seed=11))


@pytest.fixture(scope="module")
def frames(gpu):
    """16 frames of a 16-frame take of the same trajectory, rendered on the
    card."""
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import get_family
    from ccrs_jax.models import GenericModel
    from ccrs_jax.testdata import render_frames_device, smooth_sequence_poses

    board = create_default_6x6_board()
    gt = GenericModel("eucm", [190.9, 190.87, 254.94, 256.86, 0.628, 1.046],
                      512, 512)
    poses = smooth_sequence_poses(16, board, seed=11)
    return np.asarray(render_frames_device(gt, board, get_family("t36h11"),
                                           poses, noise=1.5, seed=11))


def _on_cpu():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


def test_threshold_bitmaps_match_cpu(video):
    import jax.numpy as jnp

    from ccrs_jax.detect.threshold import threshold_front

    for scale in (1, 2):
        dev = np.asarray(threshold_front(jnp.asarray(video), scale))
        with _on_cpu():
            ref = np.asarray(threshold_front(jnp.asarray(video), scale))
        np.testing.assert_array_equal(dev, ref)


def _assert_same_detections(got, ref, corner_px):
    assert len(got) == len(ref)
    diff = [f for f, (a, b) in enumerate(zip(got, ref)) if set(a) != set(b)]
    assert not diff, f"tag sets differ on frames {diff}"
    far = [f for f, (a, b) in enumerate(zip(got, ref))
           if any(np.abs(a[t] - b[t]).max() > corner_px for t in a)]
    assert not far, f"corners differ by more than {corner_px} px on {far}"
    # the board is really in view
    assert sum(map(len, got)) >= 10 * len(got)


def _cold(frames, chunk=None):
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import TagDetector

    board = create_default_6x6_board()

    def detect(**kw):
        det = TagDetector("t36h11", track=False, **kw)
        det.chunk = chunk or det.chunk
        return det.detect_batch(frames, board=board)

    # both backends take the same chunk plan: the default backend is the
    # GPU's (utils/backend.py)
    got = detect()
    with _on_cpu():
        ref = detect(shard=False)
    return got, ref


def test_detection_matches_cpu(frames):
    # one chunk: no padding on either backend
    _assert_same_detections(*_cold(frames, chunk=len(frames)), CORNER_PX)


def test_detection_matches_cpu_whole_video(video):
    _assert_same_detections(*_cold(video), VIDEO_CORNER_PX)


def test_tracked_detection_matches_cpu(video):
    """The CLI's detect path (wave tracking, audits, cold anchors, fed in
    the loader's chunks) over the whole video: the card must find what the
    CPU finds, frame by frame.  With several GPUs visible the detector
    frame-shards the video, and this compares the sharded run."""
    from ccrs_jax.board import create_default_6x6_board
    from ccrs_jax.detect import TagDetector

    board = create_default_6x6_board()
    got = detect_like_cli(TagDetector("t36h11"), video, board)
    with _on_cpu():
        ref = detect_like_cli(TagDetector("t36h11", shard=False), video,
                              board)
    assert len(got) == len(video)
    _assert_same_detections(got, ref, VIDEO_CORNER_PX)


def test_code_scores_default_precision_exact(gpu):
    """The code-matching matmuls run at DEFAULT precision (TF32 on the
    card): +-1 entries and sums of at most 64 terms are exact there."""
    import jax
    import jax.numpy as jnp

    from ccrs_jax.detect import get_family

    codes = jnp.asarray(get_family("t36h11").rotated_codes, jnp.float32)
    rng = np.random.default_rng(0)
    bits = jnp.asarray(
        rng.choice([-1.0, 1.0], size=(72 * 36, codes.shape[1])).astype(np.float32)
    )
    mm = jax.jit(lambda b, c, p: jnp.matmul(b, c.T, precision=p),
                 static_argnums=2)
    lo = np.asarray(mm(bits, codes, jax.lax.Precision.DEFAULT))
    hi = np.asarray(mm(bits, codes, jax.lax.Precision.HIGHEST))
    np.testing.assert_array_equal(lo, hi)
