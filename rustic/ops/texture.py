"""Bilinear texture sampling as explicit gathers.

The traced program samples textures without texture units; the
reference's CPU polyfill
(reference: shared_structs/src/image_polyfill.rs:38-55) *is* the right
model: scale UV by the image size, gather the four neighboring texels,
lerp. We use clamp-to-edge addressing — the reference is internally
inconsistent (GPU sampler clamps, src/trace.rs:105; CPU polyfill wraps,
image_polyfill.rs:33-35); we standardize on the GPU behavior.
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_bilinear(
    image: jnp.ndarray,
    uv: jnp.ndarray,
    tap_lo=None,
    tap_hi=None,
    wrap_x: bool = False,
) -> jnp.ndarray:
    """Bilinearly sample image [H, W, C] at uv [..., 2] in [0, 1].

    Matches the polyfill's exact weights: floor/ceil texel pair with
    frac(uv * size) interpolation (image_polyfill.rs:38-55).

    tap_lo/tap_hi ([..., 2] int32, inclusive) bound the texel taps to a
    sub-rect — used by the atlas so a cell's bilinear footprint never
    bleeds into the neighboring texture's cell. wrap_x wraps the x taps
    instead of clamping (equirect panoramas: the azimuth seam must
    interpolate across u = 0/1).
    """
    h, w = image.shape[0], image.shape[1]
    flat = image.reshape(h * w, image.shape[2])
    scaled = uv * jnp.asarray([w, h], jnp.float32)
    frac = scaled - jnp.floor(scaled)
    x0 = jnp.floor(scaled[..., 0]).astype(jnp.int32)
    y0 = jnp.floor(scaled[..., 1]).astype(jnp.int32)
    x1 = jnp.ceil(scaled[..., 0]).astype(jnp.int32)
    y1 = jnp.ceil(scaled[..., 1]).astype(jnp.int32)
    if wrap_x:
        x0 = jnp.mod(x0, w)
        x1 = jnp.mod(x1, w)
    elif tap_lo is not None:
        x0 = jnp.clip(x0, tap_lo[..., 0], tap_hi[..., 0])
        x1 = jnp.clip(x1, tap_lo[..., 0], tap_hi[..., 0])
    else:
        x0 = jnp.clip(x0, 0, w - 1)
        x1 = jnp.clip(x1, 0, w - 1)
    if tap_lo is not None and not wrap_x:
        y0 = jnp.clip(y0, tap_lo[..., 1], tap_hi[..., 1])
        y1 = jnp.clip(y1, tap_lo[..., 1], tap_hi[..., 1])
    else:
        y0 = jnp.clip(y0, 0, h - 1)
        y1 = jnp.clip(y1, 0, h - 1)

    c00 = flat[y0 * w + x0]
    c10 = flat[y0 * w + x1]
    c01 = flat[y1 * w + x0]
    c11 = flat[y1 * w + x1]
    tx = frac[..., 0:1]
    ty = frac[..., 1:2]
    top = c00 * (1.0 - tx) + c10 * tx
    bot = c01 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty


def sample_atlas(atlas: jnp.ndarray, uvst: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Sample an atlas sub-rect: atlas_uv = uvst.xy + uv * uvst.zw
    (reference: kernels/src/bsdf.rs:356-357).

    Taps are bounded to the sub-rect so uv at/near 1.0 never blends the
    neighboring cell's texels (the reference bleeds there on both of
    its backends — quadtree cells have no gutter, src/atlas.rs:26-90)."""
    h, w = atlas.shape[0], atlas.shape[1]
    size = jnp.asarray([w, h], jnp.float32)
    scaled = uvst[..., 0:2] + uv * uvst[..., 2:4]
    # Quadtree cells are texel-aligned, so round() recovers the exact
    # integer rect; taps stay in [first texel, last texel] of the cell.
    lo = jnp.round(uvst[..., 0:2] * size).astype(jnp.int32)
    hi = jnp.round((uvst[..., 0:2] + uvst[..., 2:4]) * size).astype(jnp.int32)
    hi = jnp.maximum(hi - 1, lo)
    return sample_bilinear(atlas, scaled, tap_lo=lo, tap_hi=hi)
