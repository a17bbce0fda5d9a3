"""Device-side corner-patch extraction.

When the frame batch lives on the accelerator (on-device rendering, or a
future camera-direct path), downloading whole images just to run the
native subpixel refinement wastes transfer bandwidth (~260 KB/frame).
Instead each candidate corner's PxP neighborhood is gathered on device and
only those patches are downloaded (~1 KB/corner).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

PATCH = 18  # window 9x9 around a center that may wander +-4 px


@partial(jax.jit, static_argnames=("P", "as_u8"))
def extract_patches(images, corners, qframe, P: int = PATCH, as_u8: bool = False):
    """Gather PxP patches around corners.

    Args:
      images: (B, H, W) float32.
      corners: (Q, 2) float32 (x, y) image coordinates.
      qframe: (Q,) int32 frame index per corner.
      as_u8: quantize patches to uint8 (4x cheaper to download; matches
        real-camera bit depth, so subpixel refinement is unaffected at the
        precision that matters).

    Returns (patches (Q, P, P), local (Q, 2) patch-space coordinates,
    offset (Q, 2) patch origin in image space).
    """
    B, H, W = images.shape
    half = P // 2
    bx = jnp.clip(jnp.round(corners[:, 0]).astype(jnp.int32) - half, 0, W - P)
    by = jnp.clip(jnp.round(corners[:, 1]).astype(jnp.int32) - half, 0, H - P)
    dy = jnp.arange(P, dtype=jnp.int32)[None, :, None]
    dx = jnp.arange(P, dtype=jnp.int32)[None, None, :]
    flat = images.reshape(-1)
    idx = (
        qframe.astype(jnp.int32)[:, None, None] * (H * W)
        + (by[:, None, None] + dy) * W
        + (bx[:, None, None] + dx)
    )
    patches = flat[idx]
    if as_u8:
        patches = jnp.clip(jnp.round(patches), 0, 255).astype(jnp.uint8)
    offset = jnp.stack([bx, by], axis=1).astype(corners.dtype)
    return patches, corners - offset, offset
