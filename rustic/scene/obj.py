"""Dependency-free Wavefront OBJ + MTL loader.

The reference loads "many scene and model file formats, such as glTF,
FBX, obj" through assimp (reference: README.md:13, src/asset.rs:55-69).
This module covers the OBJ half of that surface with the same output
contract as the GLB parser (`GltfScene`), reproducing the conventions
applied to every format by the reference's post-processing:

- triangulation of polygon faces (fan, assimp Triangulate analog),
- coordinate swizzle (x, y, z) -> (x, z, y) with winding reorder
  (i0, i2, i1) (reference: src/asset.rs:102-114),
- smooth normals / UV-gradient tangents generated when the file has
  none (GenerateSmoothNormals / CalculateTangentSpace analogs),
- emissive (Ke) x 15 — the reference's assimp-5.2.5 emissive-strength
  hack applies to all formats (src/asset.rs:167),
- albedo textures decoded sRGB -> linear with pow 2.2
  (src/asset.rs:142-147); Kd factors are used raw.

Material mapping (classic MTL + the de-facto PBR extension keys):
  Kd -> base_color          map_Kd  -> albedo texture (sRGB decode)
  Ke -> emissive x 15       map_Ke  -> (ignored; factors only)
  Pm -> metallic (def 0)    map_Pm  -> metallic texture (R channel)
  Pr -> roughness           map_Pr  -> roughness texture (R channel)
  Ns -> roughness fallback sqrt(2/(Ns+2)) when Pr is absent
  norm / map_bump / bump -> normal texture
FBX has no dependency-free decode path; convert to GLB/OBJ first (the
format is proprietary — assimp links a native parser this build
deliberately avoids).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from rustic.scene.gltf import (
    GltfMaterial,
    GltfScene,
    _renderer_space_scene,
    _shininess_to_roughness,
    _smooth_normals,
    _smooth_tangents,
)


def _load_image(path: str) -> Optional[np.ndarray]:
    if not os.path.exists(path):
        return None
    from rustic.utils.png import read_image_rgba

    with open(path, "rb") as f:
        return read_image_rgba(f.read())


def _parse_mtl(path: str) -> Dict[str, GltfMaterial]:
    """Parse one .mtl file into named materials."""
    materials: Dict[str, GltfMaterial] = {}
    if not os.path.exists(path):
        return materials
    base_dir = os.path.dirname(os.path.abspath(path))
    cur: Optional[GltfMaterial] = None
    cur_ns: Optional[float] = None
    cur_pr: Optional[float] = None

    def finish():
        if cur is not None and cur_pr is None and cur_ns is not None:
            cur.roughness = _shininess_to_roughness(cur_ns)

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            key, args = parts[0], parts[1:]
            if key == "newmtl":
                finish()
                cur = GltfMaterial(metallic=0.0, roughness=1.0)
                cur_ns = cur_pr = None
                materials[" ".join(args)] = cur
            elif cur is None:
                continue
            elif key == "Kd":
                cur.base_color = (*map(float, args[:3]), 1.0)
            elif key == "Ke":
                cur.emissive = tuple(15.0 * float(v) for v in args[:3])
            elif key == "Pm":
                cur.metallic = float(args[0])
            elif key == "Pr":
                cur_pr = cur.roughness = float(args[0])
            elif key == "Ns":
                cur_ns = float(args[0])
            elif key == "map_Kd":
                img = _load_image(os.path.join(base_dir, args[-1]))
                if img is not None:
                    img = img.copy()
                    img[..., :3] = img[..., :3] ** 2.2
                    cur.albedo_texture = img
            elif key == "map_Pm":
                img = _load_image(os.path.join(base_dir, args[-1]))
                if img is not None:
                    cur.metallic_texture = np.repeat(img[..., :1], 4, axis=-1)
            elif key == "map_Pr":
                img = _load_image(os.path.join(base_dir, args[-1]))
                if img is not None:
                    cur.roughness_texture = np.repeat(img[..., :1], 4, axis=-1)
            elif key in ("norm", "map_bump", "bump"):
                img = _load_image(os.path.join(base_dir, args[-1]))
                if img is not None:
                    cur.normal_texture = img
    finish()
    return materials


def load_obj(path: str) -> GltfScene:
    base_dir = os.path.dirname(os.path.abspath(path))
    raw_v: List[Tuple[float, float, float]] = []
    raw_vt: List[Tuple[float, float]] = []
    raw_vn: List[Tuple[float, float, float]] = []
    mtl_by_name: Dict[str, GltfMaterial] = {}

    materials: List[GltfMaterial] = []
    mat_index_by_name: Dict[str, int] = {}
    cur_mat = -1  # -1 = no usemtl yet -> default material appended at end

    # Vertex dedup: one output vertex per unique (v, vt, vn) triple.
    vert_index: Dict[Tuple[int, int, int], int] = {}
    out_pos: List[Tuple[float, float, float]] = []
    out_uv: List[Tuple[float, float]] = []
    out_nrm_idx: List[int] = []  # -1 when the face had no vn
    tris: List[Tuple[int, int, int, int]] = []

    def resolve(token: str) -> int:
        """Map one 'v/vt/vn' token to an output vertex index."""
        comps = token.split("/")
        vi = int(comps[0])
        ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
        ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
        # OBJ indices are 1-based; negatives count from the end.
        vi = vi - 1 if vi > 0 else len(raw_v) + vi
        ti = ti - 1 if ti > 0 else (len(raw_vt) + ti if ti else -1)
        ni = ni - 1 if ni > 0 else (len(raw_vn) + ni if ni else -1)
        key = (vi, ti, ni)
        idx = vert_index.get(key)
        if idx is None:
            idx = len(out_pos)
            vert_index[key] = idx
            out_pos.append(raw_v[vi])
            out_uv.append(raw_vt[ti] if ti >= 0 else (0.0, 0.0))
            out_nrm_idx.append(ni)
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split("#", 1)[0].split()
            if not parts:
                continue
            key, args = parts[0], parts[1:]
            if key == "v":
                raw_v.append(tuple(map(float, args[:3])))
            elif key == "vt":
                u, v = (float(args[0]), float(args[1]) if len(args) > 1 else 0.0)
                # OBJ vt origin is bottom-left; the renderer consumes
                # glTF-convention (top-left) UVs, so flip V here. Pinned
                # by test_formats.py::test_obj_textured_matches_glb.
                raw_vt.append((u, 1.0 - v))
            elif key == "vn":
                raw_vn.append(tuple(map(float, args[:3])))
            elif key == "mtllib":
                # The spec allows several libraries per line; filenames
                # may also contain spaces. Prefer the joined name when
                # it exists, else treat each token as one library.
                joined = os.path.join(base_dir, " ".join(args))
                candidates = (
                    [joined]
                    if os.path.exists(joined)
                    else [os.path.join(base_dir, a) for a in args]
                )
                for cand in candidates:
                    mtl_by_name.update(_parse_mtl(cand))
            elif key == "usemtl":
                name = " ".join(args)
                if name not in mat_index_by_name:
                    mat_index_by_name[name] = len(materials)
                    materials.append(
                        mtl_by_name.get(name, GltfMaterial(metallic=0.0))
                    )
                cur_mat = mat_index_by_name[name]
            elif key == "f":
                idx = [resolve(tok) for tok in args]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    tris.append((idx[0], idx[k], idx[k + 1], cur_mat))

    if not tris:
        raise ValueError(f"no faces in {path}")
    tri_arr = np.asarray(tris, np.int64)
    if (tri_arr[:, 3] < 0).any():  # faces before any usemtl
        default = len(materials)
        materials.append(GltfMaterial(metallic=0.0))
        tri_arr[:, 3] = np.where(tri_arr[:, 3] < 0, default, tri_arr[:, 3])
    if not materials:
        materials.append(GltfMaterial(metallic=0.0))

    pos = np.asarray(out_pos, np.float64)
    uv = np.asarray(out_uv, np.float64)
    idx3 = tri_arr[:, :3]

    # Per-vertex normals: from the file where given, smooth elsewhere.
    nrm_idx = np.asarray(out_nrm_idx, np.int64)
    smooth = _smooth_normals(pos, idx3)
    if len(raw_vn):
        file_nrm = np.asarray(raw_vn, np.float64)
        file_nrm /= np.maximum(
            np.linalg.norm(file_nrm, axis=-1, keepdims=True), 1e-12
        )
        has = nrm_idx >= 0
        nrm = np.where(has[:, None], file_nrm[np.maximum(nrm_idx, 0)], smooth)
    else:
        nrm = smooth
    tan = _smooth_tangents(pos, uv, nrm, idx3)
    return _renderer_space_scene(pos, nrm, tan, uv, tri_arr, materials)
