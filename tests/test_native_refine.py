"""Native subpixel refinement must agree with the JAX reference impl."""

import jax.numpy as jnp
import numpy as np

from ccrs_jax.detect.quads import refine_corners_native
from ccrs_jax.detect.refine import refine_corners


def _checkerboard(H=128, W=128, cell=16, blur=1.0):
    from scipy.ndimage import gaussian_filter

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = (((yy // cell) + (xx // cell)) % 2 * 180 + 40).astype(np.float32)
    return gaussian_filter(img, blur)


def test_native_matches_jax_reference():
    img = _checkerboard()
    rng = np.random.default_rng(0)
    # corners near checkerboard saddle points, perturbed up to 1.5 px
    base = np.array(
        [[x, y] for x in (32, 48, 64, 80) for y in (32, 48, 64, 80)], np.float32
    )
    init = base + rng.uniform(-1.5, 1.5, base.shape).astype(np.float32)
    jax_out = np.asarray(
        refine_corners(jnp.asarray(img[None]), jnp.asarray(init[None]))
    )[0]
    nat_out = refine_corners_native(img[None], init[None].copy())[0]
    np.testing.assert_allclose(nat_out, jax_out, atol=0.02)
    # both must land on the true saddle points (cell boundaries at -0.5
    # offsets since pixel centers sit on integers)
    err_n = np.linalg.norm(nat_out - (base - 0.5), axis=1)
    assert err_n.max() < 0.1, f"native refine err {err_n.max()}"


def test_native_refine_batch_indexing():
    img0 = _checkerboard()
    img1 = np.roll(_checkerboard(), 4, axis=1)
    init = np.array([[[48.6, 47.5]], [[52.4, 47.6]]], np.float32)
    out = refine_corners_native(np.stack([img0, img1]), init.copy())
    assert abs(out[0, 0, 0] - 47.5) < 0.1
    assert abs(out[1, 0, 0] - 51.5) < 0.1  # shifted image -> shifted corner


def test_refine_patches_matches_native_and_truth():
    """The production KLT-style patch refinement (detect/refine.py
    refine_patches — runs inside every fused decode graph) must land on
    the true saddle corner and agree with the native patch kernel.

    The two discretize the window sums differently (refine_patches
    smooths the gradient products before interpolation, the native kernel
    interpolates gradients then multiplies), so they agree to ~0.05 px —
    well under the detector's noise floor — rather than bit-exactly."""
    from ccrs_jax.detect.patches import extract_patches
    from ccrs_jax.detect.quads import refine_corners_patches_native
    from ccrs_jax.detect.refine import refine_patches

    img = _checkerboard()
    rng = np.random.default_rng(1)
    base = np.array(
        [[x, y] for x in (32, 48, 64, 80) for y in (32, 48, 64, 80)], np.float32
    )
    init = (base + rng.uniform(-1.5, 1.5, base.shape)).astype(np.float32)
    patches, local, offset = extract_patches(
        jnp.asarray(img[None]), jnp.asarray(init),
        jnp.zeros(len(init), jnp.int32),
    )
    ours = np.asarray(refine_patches(patches, local)) + np.asarray(offset)
    nat = refine_corners_patches_native(
        np.asarray(patches, np.float32), np.asarray(local)
    ) + np.asarray(offset)
    # true saddle points are the integer grid crossings (pixel-center
    # convention puts the blurred saddle at cell boundary - 0.5)
    truth = base - 0.5
    assert np.abs(ours - truth).max() < 0.08, np.abs(ours - truth).max()
    assert np.abs(nat - truth).max() < 0.08
    np.testing.assert_allclose(ours, nat, atol=0.06)
