"""Minimal GLB (glTF 2.0 binary) writer.

The inverse of scene/gltf.py's loader, for authoring test/benchmark
scenes procedurally (the reference repo ships several .glb scenes that
are stripped from its public mirror — GlassTest, BreakTime — so we
generate equivalent coverage scenes ourselves; see
tools/make_scenes.py). Writes exactly the subset the loader consumes:
one node per mesh, POSITION (+ optional NORMAL / TEXCOORD_0) float32
accessors, uint32 indices, pbrMetallicRoughness factors, emissiveFactor,
and the KHR_materials_transmission / KHR_materials_ior extensions.

NOTE the emissive convention: the loader multiplies emissiveFactor by
15 (the reference's assimp emissive-strength hack, src/asset.rs:167),
and glTF clamps emissiveFactor to [0,1] — pick factors accordingly.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class MeshSpec:
    positions: np.ndarray  # [V, 3] f32 (glTF coordinates: y-up)
    indices: np.ndarray  # [T, 3] u32
    material: int
    normals: Optional[np.ndarray] = None  # [V, 3] f32
    uv0: Optional[np.ndarray] = None  # [V, 2] f32
    name: str = "mesh"


@dataclass
class MaterialSpec:
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 0.0
    roughness: float = 1.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    transmission: float = 0.0
    ior: float = 1.5
    # Indices into write_glb's `textures` list (embedded PNG images).
    # The loader (scene/gltf.py:241-252) reads baseColorTexture (sRGB,
    # decoded to linear at load), metallicRoughnessTexture (B=metallic,
    # G=roughness) and normalTexture.
    base_color_texture: Optional[int] = None
    metallic_roughness_texture: Optional[int] = None
    normal_texture: Optional[int] = None
    name: str = "material"


def _encode_png(image) -> bytes:
    """[H, W, 3|4] uint8 or float in [0,1] -> PNG bytes."""
    from rustic.utils.png import encode_png

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return encode_png(arr)


def _align(b: bytearray, n: int, pad: bytes = b"\x00"):
    while len(b) % n:
        b.extend(pad)


def write_glb(
    path: str,
    meshes: List[MeshSpec],
    materials: List[MaterialSpec],
    textures: Optional[List[np.ndarray]] = None,
):
    """`textures` is a list of [H, W, 3|4] images (uint8 or float in
    [0,1]) embedded as PNG; MaterialSpec texture fields index into it."""
    bin_blob = bytearray()
    buffer_views = []
    accessors = []

    def add_data(arr: np.ndarray, target: int) -> int:
        _align(bin_blob, 4)
        offset = len(bin_blob)
        raw = np.ascontiguousarray(arr).tobytes()
        bin_blob.extend(raw)
        buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(raw), "target": target}
        )
        return len(buffer_views) - 1

    def add_accessor(arr: np.ndarray, target: int, comp_type: int, type_: str) -> int:
        bv = add_data(arr, target)
        acc = {
            "bufferView": bv,
            "componentType": comp_type,
            "count": int(arr.shape[0]),
            "type": type_,
        }
        if type_ == "VEC3":
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        accessors.append(acc)
        return len(accessors) - 1

    gltf_meshes = []
    nodes = []
    for m in meshes:
        attrs = {
            "POSITION": add_accessor(
                m.positions.astype(np.float32), 34962, 5126, "VEC3"
            )
        }
        if m.normals is not None:
            attrs["NORMAL"] = add_accessor(
                m.normals.astype(np.float32), 34962, 5126, "VEC3"
            )
        if m.uv0 is not None:
            attrs["TEXCOORD_0"] = add_accessor(
                m.uv0.astype(np.float32), 34962, 5126, "VEC2"
            )
        idx = add_accessor(
            m.indices.astype(np.uint32).reshape(-1, 1), 34963, 5125, "SCALAR"
        )
        gltf_meshes.append(
            {
                "name": m.name,
                "primitives": [
                    {"attributes": attrs, "indices": idx, "material": m.material}
                ],
            }
        )
        nodes.append({"mesh": len(gltf_meshes) - 1, "name": m.name})

    gltf_images = []
    gltf_textures = []
    for img in textures or []:
        raw = _encode_png(img)
        _align(bin_blob, 4)
        offset = len(bin_blob)
        bin_blob.extend(raw)
        buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": len(raw)}
        )
        gltf_images.append(
            {"bufferView": len(buffer_views) - 1, "mimeType": "image/png"}
        )
        gltf_textures.append({"source": len(gltf_images) - 1, "sampler": 0})

    gltf_materials = []
    uses_ext = False
    for mat in materials:
        pbr = {
            "baseColorFactor": list(mat.base_color),
            "metallicFactor": float(mat.metallic),
            "roughnessFactor": float(mat.roughness),
        }
        if mat.base_color_texture is not None:
            pbr["baseColorTexture"] = {"index": mat.base_color_texture}
        if mat.metallic_roughness_texture is not None:
            pbr["metallicRoughnessTexture"] = {
                "index": mat.metallic_roughness_texture
            }
        entry = {
            "name": mat.name,
            "pbrMetallicRoughness": pbr,
            "emissiveFactor": list(mat.emissive),
        }
        if mat.normal_texture is not None:
            entry["normalTexture"] = {"index": mat.normal_texture}
        if mat.transmission > 0.0:
            uses_ext = True
            entry["extensions"] = {
                "KHR_materials_transmission": {
                    "transmissionFactor": float(mat.transmission)
                },
                "KHR_materials_ior": {"ior": float(mat.ior)},
            }
        gltf_materials.append(entry)

    _align(bin_blob, 4)
    gltf = {
        "asset": {"version": "2.0", "generator": "rustic glb_write"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "materials": gltf_materials,
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    if gltf_images:
        gltf["images"] = gltf_images
        gltf["textures"] = gltf_textures
        gltf["samplers"] = [{"magFilter": 9729, "minFilter": 9729}]
    if uses_ext:
        gltf["extensionsUsed"] = [
            "KHR_materials_transmission",
            "KHR_materials_ior",
        ]

    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    total = 12 + 8 + len(js) + 8 + len(bin_blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<4sII", b"glTF", 2, total))
        f.write(struct.pack("<I4s", len(js), b"JSON"))
        f.write(js)
        f.write(struct.pack("<I4s", len(bin_blob), b"BIN\x00"))
        f.write(bytes(bin_blob))


# -- procedural geometry helpers --------------------------------------------


def icosphere(subdiv: int = 2, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Subdivided icosahedron -> (positions [V,3] f32, indices [T,3] u32)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    pos = (verts * radius + np.asarray(center)).astype(np.float32)
    nrm = verts.astype(np.float32)
    return pos, faces.astype(np.uint32), nrm


def quad(
    corner, edge_u, edge_v
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One two-triangle quad: corner + u/v edge vectors.
    Normal follows the right-hand rule of (edge_u, edge_v)."""
    c = np.asarray(corner, np.float64)
    u = np.asarray(edge_u, np.float64)
    v = np.asarray(edge_v, np.float64)
    pos = np.stack([c, c + u, c + u + v, c + v]).astype(np.float32)
    idx = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    n = np.cross(u, v)
    n = (n / np.linalg.norm(n)).astype(np.float32)
    nrm = np.tile(n, (4, 1))
    return pos, idx, nrm
