import hashlib
import json

import numpy as np
import pytest

from rustic.scene.gltf import _read_glb_chunks, load_glb
from tests.conftest import scene_path

# SHA-256 prefixes of each shipped scene's JSON chunk (without its
# `asset` header, which names the writer) and binary chunk. The
# reference films and the furnace gate were rendered from exactly this
# content.
SHIPPED_SCENES = {
    "BreakTime.glb": ("05b2e64ca60ef052", "e28620cc20871b60"),
    "DarkCornell.glb": ("e0b1b90b3b97879a", "270392c99c1a4ede"),
    "FurnaceTest.glb": ("492ebd2affed5c88", "b0f5baf4ad5dc346"),
    "GlassTest.glb": ("2a6e8cb210716c88", "e362921f97f350af"),
    "PBRTest.glb": ("88ee54517e908d5d", "c4ca740c196cdb99"),
    "VeachMIS.glb": ("967e051854e8a1c4", "e1b7524a3e0c2d33"),
}


@pytest.mark.parametrize("name", sorted(SHIPPED_SCENES))
def test_shipped_scene_content_pinned(name):
    with open(scene_path(name), "rb") as f:
        chunks = _read_glb_chunks(f.read())
    doc = json.loads(chunks[0x4E4F534A])  # 'JSON'
    doc.pop("asset", None)
    json_hash = hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]
    bin_hash = hashlib.sha256(chunks.get(0x004E4942, b"")).hexdigest()[:16]  # 'BIN'
    assert (json_hash, bin_hash) == SHIPPED_SCENES[name]


def test_cornell_counts():
    s = load_glb(scene_path("DarkCornell.glb"))
    assert len(s.triangles) == 184
    assert len(s.materials) == 8
    assert s.positions.shape[1] == 3
    assert len(s.positions) == len(s.normals) == len(s.uv0)


def test_emissive_x15_hack():
    # DarkCornell's lamp has emissiveFactor 0.6266...; the loader applies
    # the reference's assimp x15 workaround (src/asset.rs:167).
    s = load_glb(scene_path("DarkCornell.glb"))
    emissive = np.array([m.emissive for m in s.materials])
    lit = emissive[np.any(emissive != 0, axis=1)]
    assert len(lit) == 1
    np.testing.assert_allclose(lit[0], 0.6266478896141052 * 15.0, rtol=1e-5)


def test_furnace_materials():
    s = load_glb(scene_path("FurnaceTest.glb"))
    base = np.array([m.base_color for m in s.materials])
    # inner sphere albedo 0.18, emitter shell base 0.8
    assert np.isclose(base[:, 0], 0.18, atol=1e-3).any()
    emissive = np.array([m.emissive for m in s.materials])
    np.testing.assert_allclose(emissive.max(), 3.0, atol=1e-4)


def test_yz_swap_and_winding():
    """The renderer-space swizzle must keep triangles front-facing from
    their original outside direction: swapping Y/Z mirrors space, and the
    (i0, i2, i1) reorder restores orientation — so the composition
    preserves the sign of det(e1, e2, outward)."""
    s = load_glb(scene_path("FurnaceTest.glb"))
    tris = s.triangles
    a = s.positions[tris[:, 0]]
    b = s.positions[tris[:, 1]]
    c = s.positions[tris[:, 2]]
    geo_n = np.cross(b - a, c - a)
    geo_n /= np.maximum(np.linalg.norm(geo_n, axis=-1, keepdims=True), 1e-12)
    shade_n = (
        s.normals[tris[:, 0]] + s.normals[tris[:, 1]] + s.normals[tris[:, 2]]
    ) / 3.0
    agree = np.sum(geo_n * shade_n, axis=-1) > 0
    # Geometric and shading normals agree for nearly every triangle.
    assert agree.mean() > 0.95


def test_normals_unit_length():
    s = load_glb(scene_path("VeachMIS.glb"))
    norms = np.linalg.norm(s.normals, axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-3)


def test_textured_glb_roundtrip(tmp_path):
    """write_glb embeds PNG textures the loader decodes back: baseColor
    (sRGB->linear), metallicRoughness (B/G split), normal map."""
    from rustic.scene.glb_write import MaterialSpec, MeshSpec, quad, write_glb

    albedo = np.zeros((8, 8, 3), np.float32)
    albedo[..., 0] = 0.5  # mid-gray red channel
    mr = np.zeros((8, 8, 3), np.float32)
    mr[..., 1] = 0.25  # roughness G
    mr[..., 2] = 1.0  # metallic B
    nmap = np.full((8, 8, 3), 0.5, np.float32)
    nmap[..., 2] = 1.0  # flat tangent-space normal

    p, i, n = quad((0, 0, 0), (1, 0, 0), (0, 1, 0))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    mat = MaterialSpec(
        base_color_texture=0, metallic_roughness_texture=1, normal_texture=2
    )
    path = str(tmp_path / "t.glb")
    write_glb(
        path,
        [MeshSpec(p, i, 0, normals=n, uv0=uv)],
        [mat],
        textures=[albedo, mr, nmap],
    )
    s = load_glb(path)
    m = s.materials[0]
    assert m.albedo_texture is not None
    # loader applies pow(2.2) sRGB->linear to albedo (src/asset.rs:142-147)
    got = m.albedo_texture[0, 0, 0]
    np.testing.assert_allclose(got, 0.5 ** 2.2, atol=0.01)
    np.testing.assert_allclose(m.albedo_texture[0, 0, 1], 0.0, atol=1e-3)
    # metallicRoughness split: metallic from B, roughness from G
    np.testing.assert_allclose(m.metallic_texture[0, 0, 0], 1.0, atol=0.01)
    np.testing.assert_allclose(m.roughness_texture[0, 0, 0], 0.25, atol=0.01)
    # normal map decodes to ~(0.5, 0.5, 1.0) raw
    np.testing.assert_allclose(m.normal_texture[0, 0, 2], 1.0, atol=0.01)
    # UVs survive
    assert s.uv0.max() == 1.0


def test_break_time_scene_loads():
    """BASELINE config #5's generated stand-in: textured + normal-mapped
    multi-tile scene with an emissive panel."""
    s = load_glb(scene_path("BreakTime.glb"))
    has_alb = any(m.albedo_texture is not None for m in s.materials)
    has_nm = any(m.normal_texture is not None for m in s.materials)
    has_mr = any(m.metallic_texture is not None for m in s.materials)
    has_em = any(max(m.emissive) > 0 for m in s.materials)
    assert has_alb and has_nm and has_mr and has_em
    assert len(s.triangles) > 10000
