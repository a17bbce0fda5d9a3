"""Adaptive threshold front-end (device side).

First stage of the AprilGrid detector (replacing the image pipeline of the
reference's `aprilgrid` crate, SURVEY.md §2.2): tile-based adaptive
thresholding in the style of AprilTag 3 — per-tile min/max, dilated over a
3x3 tile neighborhood, pixels classified against the local midpoint, and
low-contrast tiles neutralized so they produce no spurious black blobs.

Pure jnp ops (reshape reductions + reduce_window): XLA fuses these into a
few memory-bound passes; batched over frames.  f32 in, uint8 {0,1} out.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

TILE = 4
MIN_CONTRAST = 20.0  # on a 0..255 scale


@partial(jax.jit, static_argnames=("tile", "min_contrast", "separate"))
def adaptive_threshold(
    images, tile: int = TILE, min_contrast: float = MIN_CONTRAST,
    separate: bool = True,
):
    """Binarize a batch of grayscale images.

    Args:
      images: (B, H, W) float32 (0..255); H, W divisible by ``tile``
        (callers pad — see ``pad_to_tile``).
      separate: apply one white-dilation pass (3x3 max) after
        thresholding.  Kalibr-style AprilGrid boards place black squares
        diagonally touching every tag corner; blur bridges them into one
        connected component, which destroys quad extraction.  A single
        erosion of the black regions severs those bridges (the ~1px corner
        shrink is recovered by the gray-image subpixel refinement).

    Returns:
      binary: (B, H, W) uint8 — 1 white, 0 black; low-contrast regions
        forced white (they cannot spawn false quads).
    """
    B, H, W = images.shape
    x = images.astype(jnp.float32)  # accepts uint8 input (4x cheaper h2d)
    t = x.reshape(B, H // tile, tile, W // tile, tile)
    tmin = t.min(axis=(2, 4))
    tmax = t.max(axis=(2, 4))

    # dilate min/max over 3x3 tile neighborhood
    def pool(v, op, init):
        return jax.lax.reduce_window(
            v, init, op, (1, 3, 3), (1, 1, 1), "SAME"
        )

    nmin = pool(tmin, jax.lax.min, jnp.inf)
    nmax = pool(tmax, jax.lax.max, -jnp.inf)
    contrast_ok = (nmax - nmin) >= min_contrast
    thresh = (nmin + nmax) * 0.5

    up = lambda v: jnp.repeat(jnp.repeat(v, tile, axis=1), tile, axis=2)
    binary = x > up(thresh)
    binary = binary | ~up(contrast_ok)  # low contrast -> white
    if separate:
        binary = jax.lax.reduce_window(
            binary, False, jax.lax.bitwise_or, (1, 3, 3), (1, 1, 1), "SAME"
        )
    return binary.astype(jnp.uint8)


def _pack(binary):
    B, H, W = binary.shape
    bits = binary.reshape(B, H, W // 8, 8)
    weights = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], dtype=jnp.uint8)
    return jnp.sum(bits * weights, axis=-1, dtype=jnp.uint8)


@partial(jax.jit, static_argnames=("tile", "min_contrast", "separate"))
def adaptive_threshold_packed(
    images, tile: int = TILE, min_contrast: float = MIN_CONTRAST,
    separate: bool = True,
):
    """adaptive_threshold + on-device bit packing: returns (B, H, W//8)
    uint8 so the device->host transfer is 8x smaller."""
    return _pack(adaptive_threshold(images, tile, min_contrast, separate))


@partial(jax.jit, static_argnames=("tile", "min_contrast"))
def adaptive_threshold_packed2(
    images, tile: int = TILE, min_contrast: float = MIN_CONTRAST
):
    """Two erosion levels in one pass: (B, 2, H, W//8) packed binaries.

    Level 0 = one white-dilation (the standard separation pass); level 1 =
    two dilations.  Anti-aliased Kalibr corner-square bridges grow with
    tag scale — at ~140 px tags they survive a single erosion and merge
    the tag into a cross shape, so quad extraction runs on both levels
    and the decoder dedups."""
    b1 = adaptive_threshold(images, tile, min_contrast, separate=True)
    b2 = jax.lax.reduce_window(
        b1.astype(bool), False, jax.lax.bitwise_or, (1, 3, 3), (1, 1, 1), "SAME"
    ).astype(jnp.uint8)
    return jnp.stack([_pack(b1), _pack(b2)], axis=1)


@partial(jax.jit, static_argnames=("scale", "tile", "min_contrast"))
def threshold_front(
    images, scale: int = 1, tile: int = TILE, min_contrast: float = MIN_CONTRAST
):
    """ONE graph for the whole candidate front-end: optional 2x2-mean
    pyramid level + white pad-to-tile + adaptive threshold + bit packing.

    The pieces used to run as separate dispatches (a jitted pool, eager
    jnp.pad, the threshold jit); each dispatch adds a launch and each
    graph a compile at warmup, so the cold groups of the tracking fast
    path fuse them.  Returns (B, sH_pad, sW_pad/8)
    uint8; callers slice the unpadded region after unpacking.
    """
    if scale == 2:
        B, H, W = images.shape
        x = images[:, : H // 2 * 2, : W // 2 * 2].astype(jnp.float32)
        images = x.reshape(B, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    H, W = images.shape[-2], images.shape[-1]
    wmul = tile * 8 // np.gcd(tile, 8)
    ph = (-H) % tile
    pw = (-W) % wmul
    if ph or pw:
        images = jnp.pad(
            images, [(0, 0), (0, ph), (0, pw)], constant_values=255
        )
    return adaptive_threshold_packed(images, tile, min_contrast)


def pad_to_tile(img, tile: int = TILE):
    """Pad (H, W) or (B, H, W) on the bottom/right to tile multiples with
    white (255), so padding never creates black components.  Width pads to
    a multiple of lcm(tile, 8) so the packed-bits output stays aligned."""
    H, W = img.shape[-2], img.shape[-1]
    wmul = tile * 8 // np.gcd(tile, 8)
    ph = (-H) % tile
    pw = (-W) % wmul
    if ph == 0 and pw == 0:
        return img, H, W
    pad = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
    return jnp.pad(img, pad, constant_values=255), H, W
