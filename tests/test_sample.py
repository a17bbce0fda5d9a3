"""The detector's whole-image sampling kernels (detect/sample.py) against
independent numpy/scipy references."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.ndimage import correlate1d, map_coordinates

from ccrs_jax.detect import sample
from ccrs_jax.detect.sample import (
    build_klt_maps,
    refine_corners_maps,
    sample_bilinear,
    unsharp_batch,
)


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, size=(3, 96, 128)).astype(np.float32)


def _bilinear_ref(img, x, y):
    H, W = img.shape
    x = np.clip(x, 0.0, W - 1.001)
    y = np.clip(y, 0.0, H - 1.001)
    return map_coordinates(img.astype(np.float64), [y, x], order=1)


def _klt_maps_ref(img):
    f = img.astype(np.float64)
    gx = np.zeros_like(f)
    gy = np.zeros_like(f)
    gx[:, 1:-1] = (f[:, 2:] - f[:, :-2]) * 0.5
    gy[1:-1, :] = (f[2:, :] - f[:-2, :]) * 0.5
    g, go = sample._G_TAPS.astype(np.float64), sample._GO_TAPS.astype(np.float64)

    def sep(x, ky, kx):  # zero boundary, correlation (not convolution)
        x = correlate1d(x, ky, axis=0, mode="constant")
        return correlate1d(x, kx, axis=1, mode="constant")

    gxx, gxy, gyy = gx * gx, gx * gy, gy * gy
    return np.stack([
        sep(gxx, g, g), sep(gxy, g, g), sep(gyy, g, g), sep(gxx, g, go),
        sep(gxy, go, g), sep(gxy, g, go), sep(gyy, go, g),
    ])


def test_bilinear_matches_scipy(imgs):
    rng = np.random.default_rng(1)
    B, H, W = imgs.shape
    sx = rng.uniform(0, W - 1, size=(B, 257)).astype(np.float32)
    sy = rng.uniform(0, H - 1, size=(B, 257)).astype(np.float32)
    got = np.asarray(sample_bilinear(jnp.asarray(imgs), jnp.asarray(sx),
                                     jnp.asarray(sy)))
    for b in range(B):
        np.testing.assert_allclose(got[b], _bilinear_ref(imgs[b], sx[b], sy[b]),
                                   atol=1e-2)


def test_bilinear_clips_outside_the_image(imgs):
    rng = np.random.default_rng(2)
    B, H, W = imgs.shape
    sx = rng.uniform(-5, W + 5, size=(B, 600)).astype(np.float32)
    sy = rng.uniform(-5, H + 5, size=(B, 600)).astype(np.float32)
    got = np.asarray(sample_bilinear(jnp.asarray(imgs), jnp.asarray(sx),
                                     jnp.asarray(sy)))
    for b in range(B):
        np.testing.assert_allclose(got[b], _bilinear_ref(imgs[b], sx[b], sy[b]),
                                   atol=1e-2)


def test_unsharp_matches_scipy(imgs):
    got = np.asarray(unsharp_batch(jnp.asarray(imgs)))
    taps = sample._BLUR_TAPS.astype(np.float64)
    for b in range(imgs.shape[0]):
        f = imgs[b].astype(np.float64)
        blur = correlate1d(correlate1d(f, taps, axis=0, mode="nearest"),
                           taps, axis=1, mode="nearest")
        np.testing.assert_allclose(got[b], f + 1.2 * (f - blur), atol=1e-2)


def test_klt_maps_match_scipy(imgs):
    got = np.asarray(build_klt_maps(jnp.asarray(imgs)))
    assert got.shape == (3, 7, 96, 128) and got.dtype == np.float32
    for b in range(imgs.shape[0]):
        np.testing.assert_allclose(got[b], _klt_maps_ref(imgs[b]), rtol=1e-4,
                                   atol=2e-2)


def test_refine_matches_numpy_newton(imgs):
    """The Newton iteration against a numpy transcription of it, sampling
    the reference maps with scipy's bilinear interpolation."""
    rng = np.random.default_rng(3)
    B, H, W = imgs.shape
    c0 = np.stack([rng.uniform(8, W - 8, size=(B, 40)),
                   rng.uniform(8, H - 8, size=(B, 40))], axis=-1)
    got = np.asarray(refine_corners_maps(build_klt_maps(jnp.asarray(imgs)),
                                         jnp.asarray(c0.astype(np.float32))))
    for b in range(B):
        maps = _klt_maps_ref(imgs[b])
        q = c0[b].copy()
        for _ in range(sample.ITERS):
            m = np.stack([_bilinear_ref(mp, q[:, 0], q[:, 1]) for mp in maps], -1)
            a, bb, d = m[:, 0], m[:, 1], m[:, 2]
            bx = q[:, 0] * a + q[:, 1] * bb + m[:, 3] + m[:, 4]
            by = q[:, 0] * bb + q[:, 1] * d + m[:, 5] + m[:, 6]
            det = a * d - bb * bb
            det = np.where(np.abs(det) > 1e-9, det, 1e-9)
            n = np.stack([(d * bx - bb * by) / det, (a * by - bb * bx) / det], -1)
            q = q + np.clip(n - q, -1.0, 1.0)
        tot = q - c0[b]
        norm = np.linalg.norm(tot, axis=-1, keepdims=True)
        ref = c0[b] + tot * np.minimum(1.0, sample.MAX_SHIFT / np.maximum(norm, 1e-9))
        np.testing.assert_allclose(got[b], ref, atol=5e-3)


def test_refine_finds_synthetic_saddle():
    # checkerboard saddle at a known subpixel position: refine from a
    # ~1.5 px-off start must land within 0.05 px
    H = W = 64
    cx_true, cy_true = 31.3, 32.6
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 127.5 + 127.5 * np.tanh(0.9 * (xx - cx_true)) * np.tanh(
        0.9 * (yy - cy_true)
    )
    maps = build_klt_maps(jnp.asarray(img[None]))
    start = jnp.asarray([[[cx_true + 1.2, cy_true - 1.4]]], jnp.float32)
    out = np.asarray(refine_corners_maps(maps, start))[0, 0]
    assert abs(out[0] - cx_true) < 0.05, out
    assert abs(out[1] - cy_true) < 0.05, out


def test_detect_graph_samples_without_matmuls():
    """The fused refine+decode graph gathers: no matmul touches an image
    axis (the banded / hat-weight matmul formulation is gone).  What stays
    is the homography application and the +-1 code matching."""
    from ccrs_jax.detect import get_family
    from ccrs_jax.detect.decode import refine_decode_fused_dense

    fam = get_family("t36h11")
    H, W = 72, 88  # sizes no other axis of the graph has
    hlo = jax.jit(
        lambda i, q, v: refine_decode_fused_dense(fam, i, q, v)
    ).lower(jnp.zeros((2, H, W), jnp.uint8), jnp.zeros((2, 8, 4, 2), jnp.float32),
            jnp.zeros((2, 8), bool)).as_text()
    dots = [ln for ln in hlo.splitlines() if "dot_general" in ln]
    assert len(dots) == 2, dots
    for ln in dots:
        assert f"x{H}x" not in ln and f"x{W}x" not in ln, ln
