"""Quadtree texture atlas packer.

Capability parity with the reference packer (reference: src/atlas.rs:26-90):
the atlas square is quadtree-subdivided until there are at least as many
leaves as textures, leaves are sorted by size (descending) and assigned
to textures in load order, each texture is Lanczos-resized into its cell
and pasted vertically flipped. Returns the atlas plus one `uvst` vector
per texture: (offset_u, offset_v, scale_u, scale_v) such that
atlas_uv = uvst.xy + uv * uvst.zw (reference: src/atlas.rs:16-24 — note
the reference divides the y offset by atlas *width*; kept verbatim, it
is identical for the square atlases both frameworks use).
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

import numpy as np


def pack_textures(
    textures: List[np.ndarray],
    atlas_width: int = 4096,
    atlas_height: int = 4096,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Pack float [H, W, 4] textures into one atlas.

    Returns (atlas [atlas_height, atlas_width, 4] float32, uvst list).
    """
    atlas = np.zeros((atlas_height, atlas_width, 4), np.float32)
    if not textures:
        return atlas, []

    queue = deque([(0, 0, atlas_width, atlas_height)])
    while len(queue) <= len(textures):
        x, y, w, h = queue.popleft()
        hw, hh = w // 2, h // 2
        queue.extend(
            [
                (x, y, hw, hh),
                (x + hw, y, hw, hh),
                (x, y + hh, hw, hh),
                (x + hw, y + hh, hw, hh),
            ]
        )

    leafs = sorted(queue, key=lambda r: -r[2])[: len(textures)]

    sts = []
    for tex, (x, y, w, h) in zip(textures, leafs):
        resized = _resize_lanczos(tex, w, h)
        # vertical flip on paste (reference: src/atlas.rs:85)
        atlas[y : y + h, x : x + w] = resized[::-1]
        sts.append(
            np.array(
                [
                    x / atlas_width,
                    y / atlas_width,  # reference quirk: y offset over width
                    w / atlas_width,
                    h / atlas_height,
                ],
                np.float32,
            )
        )
    return atlas, sts


# Channel layout of the combined per-MATERIAL atlas (see
# pack_material_textures): one cell per textured material, every map
# co-located at the same rect so ONE bilinear footprint (4 row gathers)
# serves all maps, where separate per-map rects cost 4 gathers per map.
ATLAS_CHANNELS = 9
CH_ALBEDO = slice(0, 4)  # RGBA (sRGB already decoded at load)
CH_METAL = 4  # metallic scalar (loader pre-swizzles the MR B channel)
CH_ROUGH = 5  # roughness scalar (MR G channel)
CH_NORMAL = slice(6, 9)  # tangent-space normal xyz in [0,1]


def pack_material_textures(
    mat_maps: List[dict],
    atlas_width: int = 4096,
    atlas_height: int = 4096,
) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Pack per-MATERIAL map sets into one co-located 9-channel atlas.

    mat_maps[i] is a dict with optional [H, W, 4] float entries
    'albedo'/'metallic'/'roughness'/'normal' for material i. Every map
    of a material lands at the SAME quadtree cell (each Lanczos-resized
    to the cell), so a single uvst rect addresses them all and one
    bilinear footprint fetches every channel at once: 4 gathers per
    bounce instead of 4 maps x 4 corners, with bit-identical bilinear
    math per map.

    Returns (atlas [atlas_height, atlas_width, 9] float32,
    per-material uvst or None for materials without any texture).
    Allocation mirrors pack_textures (reference: src/atlas.rs:26-90):
    quadtree split until enough leaves, leaves sorted by size
    descending, assigned in material order, vertical flip on paste.
    """
    atlas = np.zeros((atlas_height, atlas_width, ATLAS_CHANNELS), np.float32)
    textured = [i for i, maps in enumerate(mat_maps)
                if any(v is not None for v in maps.values())]
    if not textured:
        return atlas, [None] * len(mat_maps)

    queue = deque([(0, 0, atlas_width, atlas_height)])
    while len(queue) <= len(textured):
        x, y, w, h = queue.popleft()
        hw, hh = w // 2, h // 2
        queue.extend([
            (x, y, hw, hh),
            (x + hw, y, hw, hh),
            (x, y + hh, hw, hh),
            (x + hw, y + hh, hw, hh),
        ])
    leafs = sorted(queue, key=lambda r: -r[2])[: len(textured)]

    channel = {
        "albedo": CH_ALBEDO,
        "metallic": slice(CH_METAL, CH_METAL + 1),
        "roughness": slice(CH_ROUGH, CH_ROUGH + 1),
        "normal": CH_NORMAL,
    }
    uvsts: List = [None] * len(mat_maps)
    for mi, (x, y, w, h) in zip(textured, leafs):
        for field, tex in mat_maps[mi].items():
            if tex is None:
                continue
            resized = _resize_lanczos(tex, w, h)[::-1]  # v-flip on paste
            ch = channel[field]
            n_ch = ch.stop - ch.start
            atlas[y : y + h, x : x + w, ch] = resized[..., :n_ch]
        uvsts[mi] = np.array(
            [
                x / atlas_width,
                y / atlas_width,  # reference quirk: y offset over width
                w / atlas_width,
                h / atlas_height,
            ],
            np.float32,
        )
    return atlas, uvsts


_PRECISION_BITS = 32 - 8 - 2  # Pillow's 8-bit resampling fixed point


def _lanczos3(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0), 0.0)


def _lanczos_weights(in_size: int, out_size: int):
    """Per-output-pixel source window and fixed-point Lanczos3 weights,
    computed as Pillow's precompute_coeffs / normalize_coeffs_8bpc do
    (an output pixel's window never exceeds `ksize` taps)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _lanczos3((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))
    idx = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return idx, fixed.astype(np.int64)


def _resample_axis0(img: np.ndarray, out_size: int) -> np.ndarray:
    """One 8-bit Lanczos3 pass along axis 0 of a uint8 [N, ...] array, as
    one dense matrix product. The weights are integers and every partial
    sum stays below 2**53, so float64 sums them exactly in any order."""
    idx, k = _lanczos_weights(img.shape[0], out_size)
    dense = np.zeros((out_size, img.shape[0]), np.float64)
    np.add.at(dense, (np.arange(out_size)[:, None], idx), k)
    acc = dense @ img.reshape(img.shape[0], -1).astype(np.float64)
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return out.reshape((out_size,) + img.shape[1:])


def _resize_lanczos(tex: np.ndarray, w: int, h: int) -> np.ndarray:
    """Lanczos3 resize of a float RGBA texture through 8 bits (the
    reference uses fast_image_resize with the same filter,
    src/atlas.rs:71-84). Bit-identical to Pillow's
    Image.resize((w, h), LANCZOS) on the RGBA image: alpha premultiplied,
    a horizontal then a vertical 8-bit pass, alpha divided back out."""
    u8 = (np.clip(tex, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if u8.shape[:2] == (h, w):
        return u8.astype(np.float32) / 255.0
    # premultiplying by alpha = 255 is exact, and an opaque image stays
    # opaque through the passes: only translucent textures pay for it
    opaque = bool((u8[..., 3] == 255).all())
    pre = u8
    if not opaque:
        a = u8[..., 3:4].astype(np.int64)
        t = u8[..., :3].astype(np.int64) * a + 128
        pre = np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)
    if pre.shape[1] != w:
        pre = _resample_axis0(pre.transpose(1, 0, 2), w).transpose(1, 0, 2)
    if pre.shape[0] != h:
        pre = _resample_axis0(pre, h)
    if not opaque:
        a = pre[..., 3:4].astype(np.int64)
        rgb = pre[..., :3].astype(np.int64)
        un = np.where(
            (a == 255) | (a == 0), rgb, np.minimum(255 * rgb // np.maximum(a, 1), 255)
        )
        pre = np.concatenate([un, a], axis=-1)
    return pre.astype(np.float32) / 255.0
