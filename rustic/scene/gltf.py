"""Minimal self-contained glTF 2.0 / GLB loader.

Replaces the reference's assimp import path (reference: src/asset.rs:55-132)
with a dependency-free parser. Reproduces the reference's conventions:

- node-graph walk flattening TRS transforms (src/asset.rs:78-132),
- coordinate swizzle (x, y, z) -> (x, z, y) on positions/normals/tangents
  (src/asset.rs:102,110,114) with triangle winding reorder (i0, i2, i1)
  (src/asset.rs:106),
- normals transformed by the inverse-transpose of the linear part
  (equivalent to the reference's quat * (n / scale) for TRS transforms,
  src/asset.rs:109),
- material extraction: baseColorFactor -> albedo, metallicFactor,
  roughnessFactor, emissiveFactor * 15 (the reference's assimp-5.2.5
  emissive-strength hack, src/asset.rs:167),
- albedo *textures* are decoded sRGB -> linear with pow 2.2
  (src/asset.rs:142-147); factors are linear already,
- smooth normals / tangents are generated when missing (assimp's
  GenerateSmoothNormals / CalculateTangentSpace post-processes).

Deliberate improvement over the reference: glTF packs metallic in the B
channel and roughness in the G channel of one metallicRoughness texture;
we split it into two single-channel textures (replicated to RGB) so the
kernel's `.x` fetch reads the intended channel.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclasses.dataclass
class GltfMaterial:
    # Factors (linear space). Defaults per the glTF 2.0 spec.
    base_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    metallic: float = 1.0
    roughness: float = 1.0
    emissive: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # KHR_materials_transmission / KHR_materials_ior: drives the GGX
    # dielectric ("glass") BSDF. The reference implements the same BSDF
    # (kernels/src/bsdf.rs:107-176) but never wires it to a material;
    # we hook it to the standard glTF extension instead.
    transmission: float = 0.0
    ior: float = 1.5
    # Decoded texture images as float32 [H, W, 4] in [0, 1], or None.
    albedo_texture: Optional[np.ndarray] = None
    metallic_texture: Optional[np.ndarray] = None
    roughness_texture: Optional[np.ndarray] = None
    normal_texture: Optional[np.ndarray] = None


@dataclasses.dataclass
class GltfScene:
    """Flattened triangle soup in renderer (Y/Z-swapped) space."""

    positions: np.ndarray  # [V, 3] float32
    normals: np.ndarray  # [V, 3] float32
    tangents: np.ndarray  # [V, 3] float32
    uv0: np.ndarray  # [V, 2] float32
    triangles: np.ndarray  # [T, 4] int32: (i0, i1, i2, material)
    materials: List[GltfMaterial]


def _read_glb_chunks(data: bytes):
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    offset = 12
    chunks = {}
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunks[ctype] = data[offset : offset + clen]
        offset += clen
    return chunks


def _resolve_uri(uri: str, base_dir: str) -> bytes:
    """Fetch a glTF buffer/image uri: base64 data URI or a file relative
    to the .gltf (percent-decoded). Remote http(s) uris are rejected."""
    if uri.startswith("data:"):
        import base64

        header, _, payload = uri.partition(",")
        if ";base64" not in header:
            raise ValueError("only base64 data URIs are supported")
        return base64.b64decode(payload)
    if uri.startswith(("http:", "https:")):
        raise ValueError(f"remote glTF uri not supported: {uri}")
    from urllib.parse import unquote

    with open(os.path.join(base_dir, unquote(uri)), "rb") as f:
        return f.read()


def _load_gltf_json(path: str):
    """Parse .gltf (JSON) or .glb (binary) into (gltf dict, buffers list).

    The reference gets multi-format support from assimp (README.md:13);
    here both glTF flavors share one dependency-free parser. Buffers with
    a uri resolve to sibling files or data URIs; a uri-less buffer is the
    GLB BIN chunk."""
    base_dir = os.path.dirname(os.path.abspath(path))
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        chunks = _read_glb_chunks(data)
        gltf = json.loads(chunks[0x4E4F534A])  # 'JSON'
        bin_chunk = chunks.get(0x004E4942, b"")  # 'BIN\0'
    else:
        gltf = json.loads(data)
        bin_chunk = b""
    buffers = [
        _resolve_uri(buf["uri"], base_dir) if "uri" in buf else bin_chunk
        for buf in gltf.get("buffers", [{}])
    ]
    return gltf, buffers, base_dir


def _accessor(gltf: dict, buffers: List[bytes], index: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    count = acc["count"]
    if "bufferView" not in acc:
        out = np.zeros((count, n_comp), dtype=dtype)
    else:
        bv = gltf["bufferViews"][acc["bufferView"]]
        buf = buffers[bv["buffer"]]
        start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = bv.get("byteStride", 0)
        itemsize = np.dtype(dtype).itemsize * n_comp
        if stride and stride != itemsize:
            rows = []
            for i in range(count):
                o = start + i * stride
                rows.append(np.frombuffer(buf, dtype=dtype, count=n_comp, offset=o))
            out = np.stack(rows)
        else:
            out = np.frombuffer(buf, dtype=dtype, count=count * n_comp, offset=start)
            out = out.reshape(count, n_comp)
    if "sparse" in acc:
        sp = acc["sparse"]
        out = out.copy()
        idx_bv = gltf["bufferViews"][sp["indices"]["bufferView"]]
        idx_dtype = _COMPONENT_DTYPES[sp["indices"]["componentType"]]
        idx = np.frombuffer(
            buffers[idx_bv["buffer"]],
            dtype=idx_dtype,
            count=sp["count"],
            offset=idx_bv.get("byteOffset", 0) + sp["indices"].get("byteOffset", 0),
        )
        val_bv = gltf["bufferViews"][sp["values"]["bufferView"]]
        vals = np.frombuffer(
            buffers[val_bv["buffer"]],
            dtype=dtype,
            count=sp["count"] * n_comp,
            offset=val_bv.get("byteOffset", 0) + sp["values"].get("byteOffset", 0),
        ).reshape(sp["count"], n_comp)
        out[idx] = vals
    # Normalized integer attributes -> float
    if acc.get("normalized"):
        info = np.iinfo(dtype)
        out = out.astype(np.float32) / float(info.max)
    return out


def _node_local_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _decode_image(
    gltf: dict, buffers: List[bytes], image_index: int, base_dir: str = ""
) -> np.ndarray:
    """Decode a glTF image to float32 [H, W, 4] in [0, 1] (no color transform)."""
    from rustic.utils.png import read_image_rgba

    img = gltf["images"][image_index]
    if "bufferView" in img:
        bv = gltf["bufferViews"][img["bufferView"]]
        raw = buffers[bv["buffer"]][
            bv.get("byteOffset", 0) : bv.get("byteOffset", 0) + bv["byteLength"]
        ]
    elif "uri" in img:
        raw = _resolve_uri(img["uri"], base_dir)
    else:
        raise ValueError("glTF image has neither bufferView nor uri")
    return read_image_rgba(bytes(raw))


def _smooth_normals(positions: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (assimp GenerateSmoothNormals
    analog). Vertices are welded by (rounded) position first, so
    triangle soups with unshared index buffers (STL facets, FBX
    per-corner attributes, OBJ vertices split by differing UVs) still
    smooth across the surface — without welding each soup vertex sees
    exactly one face and the result degenerates to flat facet shading."""
    a = positions[tris[:, 0]]
    b = positions[tris[:, 1]]
    c = positions[tris[:, 2]]
    fn = np.cross(b - a, c - a)
    _, inverse = np.unique(
        positions.round(decimals=6), axis=0, return_inverse=True
    )
    inverse = inverse.reshape(-1)
    acc = np.zeros((int(inverse.max()) + 1 if len(inverse) else 0, 3))
    for k in range(3):
        np.add.at(acc, inverse[tris[:, k]], fn)
    normals = acc[inverse]
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


def _shininess_to_roughness(ns: float) -> float:
    """Classic Phong shininess -> GGX roughness (Beckmann fit), shared
    by the OBJ (Ns) and FBX (Shininess) material paths."""
    return float(np.sqrt(2.0 / (max(ns, 0.0) + 2.0)))


def _renderer_space_scene(
    positions: np.ndarray,
    normals: np.ndarray,
    tangents: np.ndarray,
    uv0: np.ndarray,
    tris4: np.ndarray,
    materials: List["GltfMaterial"],
) -> "GltfScene":
    """Shared loader tail: apply the renderer-space swizzle (x, z, y)
    and winding reorder (i0, i2, i1) (reference: src/asset.rs:102-114)
    and assemble the GltfScene. `tris4` is [T, 4] (i0, i1, i2, mat) in
    source winding."""
    triangles = np.empty((len(tris4), 4), np.int32)
    triangles[:, 0] = tris4[:, 0]
    triangles[:, 1] = tris4[:, 2]
    triangles[:, 2] = tris4[:, 1]
    triangles[:, 3] = tris4[:, 3]
    return GltfScene(
        positions=np.asarray(positions)[:, [0, 2, 1]].astype(np.float32),
        normals=np.asarray(normals)[:, [0, 2, 1]].astype(np.float32),
        tangents=np.asarray(tangents)[:, [0, 2, 1]].astype(np.float32),
        uv0=np.asarray(uv0).astype(np.float32),
        triangles=triangles,
        materials=materials,
    )


def _smooth_tangents(
    positions: np.ndarray, uv: np.ndarray, normals: np.ndarray, tris: np.ndarray
) -> np.ndarray:
    """UV-gradient tangents, averaged per vertex (CalculateTangentSpace analog)."""
    a, b, c = (positions[tris[:, k]] for k in range(3))
    ua, ub, uc = (uv[tris[:, k]] for k in range(3))
    e1, e2 = b - a, c - a
    d1, d2 = ub - ua, uc - ua
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    inv = np.where(np.abs(det) < 1e-12, 0.0, 1.0 / np.where(det == 0, 1.0, det))
    tan = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * inv[:, None]
    tangents = np.zeros_like(positions)
    for k in range(3):
        np.add.at(tangents, tris[:, k], tan)
    # Gram-Schmidt against the normal
    tangents -= normals * np.sum(tangents * normals, axis=-1, keepdims=True)
    norm = np.linalg.norm(tangents, axis=-1, keepdims=True)
    fallback = np.tile(np.array([1.0, 0.0, 0.0]), (len(positions), 1))
    return np.where(norm > 1e-8, tangents / np.maximum(norm, 1e-12), fallback)


def load_glb(path: str) -> GltfScene:
    """Load a .glb or .gltf scene (both flavors share one code path)."""
    gltf, buffers, base_dir = _load_gltf_json(path)

    # ---- materials ----------------------------------------------------------
    materials: List[GltfMaterial] = []
    tex_cache: Dict[int, np.ndarray] = {}

    def get_image(texture_index: int) -> np.ndarray:
        src = gltf["textures"][texture_index]["source"]
        if src not in tex_cache:
            tex_cache[src] = _decode_image(gltf, buffers, src, base_dir)
        return tex_cache[src]

    for mat in gltf.get("materials", []):
        m = GltfMaterial()
        pbr = mat.get("pbrMetallicRoughness", {})
        m.base_color = tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0]))
        m.metallic = float(pbr.get("metallicFactor", 1.0))
        m.roughness = float(pbr.get("roughnessFactor", 1.0))
        emissive = mat.get("emissiveFactor", [0.0, 0.0, 0.0])
        # assimp-5.2.5 emissive-strength hack, kept for scene compatibility
        # (reference: src/asset.rs:165-168)
        m.emissive = tuple(15.0 * np.asarray(emissive, np.float64))
        if "baseColorTexture" in pbr:
            img = get_image(pbr["baseColorTexture"]["index"]).copy()
            # sRGB -> linear, matching the reference's pow-2.2 decode of
            # albedo textures (reference: src/asset.rs:142-147)
            img[..., :3] = img[..., :3] ** 2.2
            m.albedo_texture = img
        if "metallicRoughnessTexture" in pbr:
            img = get_image(pbr["metallicRoughnessTexture"]["index"])
            m.metallic_texture = np.repeat(img[..., 2:3], 4, axis=-1)  # B channel
            m.roughness_texture = np.repeat(img[..., 1:2], 4, axis=-1)  # G channel
        if "normalTexture" in mat:
            m.normal_texture = get_image(mat["normalTexture"]["index"])
        ext = mat.get("extensions", {})
        if "KHR_materials_transmission" in ext:
            m.transmission = float(
                ext["KHR_materials_transmission"].get("transmissionFactor", 0.0)
            )
        if "KHR_materials_ior" in ext:
            m.ior = float(ext["KHR_materials_ior"].get("ior", 1.5))
        materials.append(m)
    if not materials:
        materials.append(GltfMaterial())

    # ---- geometry: walk the node graph -------------------------------------
    positions_l: List[np.ndarray] = []
    normals_l: List[np.ndarray] = []
    tangents_l: List[np.ndarray] = []
    uv_l: List[np.ndarray] = []
    tris_l: List[np.ndarray] = []
    vert_base = 0

    def emit_mesh(mesh_index: int, world: np.ndarray):
        nonlocal vert_base
        lin = world[:3, :3]
        # inverse-transpose for normals (equals R @ S^-1 for TRS transforms,
        # matching reference src/asset.rs:109-114)
        try:
            nrm_mat = np.linalg.inv(lin).T
        except np.linalg.LinAlgError:
            nrm_mat = lin
        for prim in gltf["meshes"][mesh_index]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue  # triangles only (assimp Triangulate analog)
            attrs = prim["attributes"]
            pos = _accessor(gltf, buffers, attrs["POSITION"]).astype(np.float64)
            n_verts = len(pos)
            world_pos = pos @ lin.T + world[:3, 3]
            if "indices" in prim:
                idx = _accessor(gltf, buffers, prim["indices"]).reshape(-1)
            else:
                idx = np.arange(n_verts, dtype=np.uint32)
            idx = idx.astype(np.int64).reshape(-1, 3)

            if "NORMAL" in attrs:
                nrm = _accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float64)
                nrm = nrm @ nrm_mat.T
                nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
            else:
                nrm = _smooth_normals(world_pos, idx)

            if "TEXCOORD_0" in attrs:
                uv = _accessor(gltf, buffers, attrs["TEXCOORD_0"]).astype(np.float64)
            else:
                uv = np.zeros((n_verts, 2))

            if "TANGENT" in attrs:
                tan = _accessor(gltf, buffers, attrs["TANGENT"]).astype(np.float64)[
                    :, :3
                ]
                tan = tan @ nrm_mat.T
                tan /= np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-12)
            else:
                tan = _smooth_tangents(world_pos, uv, nrm, idx)

            # renderer-space swizzle (x, z, y) + winding reorder (i0, i2, i1)
            # (reference: src/asset.rs:102-114)
            positions_l.append(world_pos[:, [0, 2, 1]].astype(np.float32))
            normals_l.append(nrm[:, [0, 2, 1]].astype(np.float32))
            tangents_l.append(tan[:, [0, 2, 1]].astype(np.float32))
            uv_l.append(uv.astype(np.float32))
            mat_index = prim.get("material", 0)
            t = np.empty((len(idx), 4), np.int32)
            t[:, 0] = idx[:, 0] + vert_base
            t[:, 1] = idx[:, 2] + vert_base
            t[:, 2] = idx[:, 1] + vert_base
            t[:, 3] = mat_index
            tris_l.append(t)
            vert_base += n_verts

    def walk(node_index: int, parent: np.ndarray):
        node = gltf["nodes"][node_index]
        world = parent @ _node_local_matrix(node)
        if "mesh" in node:
            emit_mesh(node["mesh"], world)
        for child in node.get("children", []):
            walk(child, world)

    scene_index = gltf.get("scene", 0)
    roots = gltf["scenes"][scene_index]["nodes"] if "scenes" in gltf else range(
        len(gltf.get("nodes", []))
    )
    for r in roots:
        walk(r, np.eye(4))

    if not positions_l:
        raise ValueError(f"no triangle meshes in {path}")

    return GltfScene(
        positions=np.concatenate(positions_l),
        normals=np.concatenate(normals_l),
        tangents=np.concatenate(tangents_l),
        uv0=np.concatenate(uv_l),
        triangles=np.concatenate(tris_l),
        materials=materials,
    )
