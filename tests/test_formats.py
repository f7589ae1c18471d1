"""Multi-format scene loading: .gltf (JSON) and .obj/.mtl.

The reference loads glTF/FBX/OBJ/... through assimp (reference:
README.md:13, src/asset.rs:55-69); these tests pin the dependency-free
equivalents: the JSON glTF flavor must load bit-identically to its GLB
twin, and OBJ must honor the same renderer-space conventions
(Y/Z swizzle, winding reorder, smooth normals, emissive x 15).
"""

import base64
import json
import os
import struct

import numpy as np
import pytest

from rustic.scene.gltf import load_glb
from rustic.scene.obj import load_obj
from tests.conftest import scene_path


def _glb_to_gltf(glb_path, out_dir, mode):
    """Rewrite a .glb as .gltf + external .bin or an inline data URI."""
    with open(glb_path, "rb") as f:
        data = f.read()
    assert data[:4] == b"glTF"
    offset = 12
    chunks = {}
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunks[ctype] = data[offset : offset + clen]
        offset += clen
    gltf = json.loads(chunks[0x4E4F534A])
    bin_chunk = chunks[0x004E4942]
    if mode == "external":
        with open(os.path.join(out_dir, "scene buffer.bin"), "wb") as f:
            f.write(bin_chunk)
        # percent-encoded space exercises URI decoding
        gltf["buffers"][0]["uri"] = "scene%20buffer.bin"
    else:
        gltf["buffers"][0]["uri"] = (
            "data:application/octet-stream;base64,"
            + base64.b64encode(bin_chunk).decode()
        )
    out = os.path.join(out_dir, "scene.gltf")
    with open(out, "w") as f:
        json.dump(gltf, f)
    return out


@pytest.mark.parametrize("mode", ["external", "datauri"])
def test_gltf_json_matches_glb(tmp_path, mode):
    glb = scene_path("FurnaceTest.glb")
    gltf = _glb_to_gltf(glb, str(tmp_path), mode)
    a = load_glb(glb)
    b = load_glb(gltf)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.normals, b.normals)
    assert len(a.materials) == len(b.materials)


OBJ_QUAD = """
mtllib quad.mtl
v -1 0 -1
v 1 0 -1
v 1 0 1
v -1 0 1
vn 0 1 0
vt 0 0
vt 1 0
vt 1 1
vt 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1 4/4/1
"""

MTL_RED = """
newmtl red
Kd 0.8 0.1 0.2
Ke 0.5 0 0
Ns 250
newmtl pbr
Kd 1 1 1
Pr 0.25
Pm 1.0
"""


def _write(tmp_path, name, text):
    p = os.path.join(str(tmp_path), name)
    with open(p, "w") as f:
        f.write(text)
    return p


def test_obj_quad(tmp_path):
    _write(tmp_path, "quad.mtl", MTL_RED)
    scene = load_obj(_write(tmp_path, "quad.obj", OBJ_QUAD))
    # fan triangulation: quad -> 2 triangles, 4 deduped vertices
    assert scene.triangles.shape == (2, 4)
    assert len(scene.positions) == 4
    # Y/Z swizzle: the OBJ's y-up plane normal lands on renderer z
    np.testing.assert_allclose(scene.normals, [[0, 0, 1]] * 4)
    m = scene.materials[scene.triangles[0, 3]]
    assert m.base_color[:3] == (0.8, 0.1, 0.2)
    # Ke x 15 (the reference's emissive-strength hack)
    np.testing.assert_allclose(m.emissive, (7.5, 0.0, 0.0))
    # Ns 250 -> sqrt(2/252)
    np.testing.assert_allclose(m.roughness, np.sqrt(2.0 / 252.0), rtol=1e-6)
    assert m.metallic == 0.0


def test_obj_winding_matches_glb_convention(tmp_path):
    """The same single triangle authored in OBJ and via the GLB writer
    must produce identical renderer-space geometry (winding + swizzle)."""
    from rustic.scene.glb_write import MaterialSpec, MeshSpec, write_glb

    tri_obj = _write(
        tmp_path,
        "tri.obj",
        "v 0 0 0\nv 1 0 0\nv 0 2 0\nf 1 2 3\n",
    )
    obj_scene = load_obj(tri_obj)

    glb_path = os.path.join(str(tmp_path), "tri.glb")
    write_glb(
        glb_path,
        meshes=[
            MeshSpec(
                positions=np.array(
                    [[0, 0, 0], [1, 0, 0], [0, 2, 0]], np.float32
                ),
                indices=np.array([[0, 1, 2]], np.uint32),
                material=0,
            )
        ],
        materials=[MaterialSpec()],
    )
    glb_scene = load_glb(glb_path)
    np.testing.assert_allclose(
        obj_scene.positions[obj_scene.triangles[0, :3]],
        glb_scene.positions[glb_scene.triangles[0, :3]],
        atol=1e-7,
    )


def test_obj_negative_indices_and_default_material(tmp_path):
    scene = load_obj(
        _write(
            tmp_path,
            "neg.obj",
            "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n",
        )
    )
    assert scene.triangles.shape == (1, 4)
    assert scene.triangles[0, 3] == 0  # default material appended
    assert scene.materials[0].metallic == 0.0


def test_obj_pbr_keys(tmp_path):
    _write(tmp_path, "quad.mtl", MTL_RED)
    obj = OBJ_QUAD.replace("usemtl red", "usemtl pbr")
    scene = load_obj(_write(tmp_path, "pbr.obj", obj))
    m = scene.materials[scene.triangles[0, 3]]
    assert m.roughness == 0.25 and m.metallic == 1.0


def test_obj_textured_matches_glb(tmp_path):
    """The same textured emissive-lit quad authored in OBJ (bottom-left
    vt origin) and GLB (top-left glTF UVs) must render identically —
    pins the OBJ loader's V flip to the validated GLB convention."""
    from PIL import Image

    from rustic.config import RenderSettings, TracingConfig
    from rustic.runtime.render import render_image
    from rustic.scene.glb_write import MaterialSpec, MeshSpec, write_glb
    from rustic.scene.world import World

    # Distinctive vertically-asymmetric texture.
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:4, :, 0] = 1.0  # top half red
    tex[4:, :, 1] = 1.0  # bottom half green
    Image.fromarray((tex * 255).astype(np.uint8)).save(
        os.path.join(str(tmp_path), "checker.png")
    )

    quad_pos = np.array(
        [[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32
    )
    lamp_pos = np.array(
        [[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]], np.float32
    )
    glb_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quads = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)

    glb = os.path.join(str(tmp_path), "tex.glb")
    write_glb(
        glb,
        meshes=[
            MeshSpec(positions=quad_pos, indices=quads, material=0, uv0=glb_uv),
            MeshSpec(positions=lamp_pos, indices=quads[:, ::-1], material=1),
        ],
        materials=[
            MaterialSpec(metallic=0.0, roughness=1.0, base_color_texture=0),
            MaterialSpec(emissive=(2 / 15, 2 / 15, 2 / 15)),  # writer x15 later
        ],
        textures=[tex],
    )

    # Same scene in OBJ: vt origin bottom-left -> v_obj = 1 - v_gltf.
    _write(
        tmp_path,
        "tex.mtl",
        "newmtl floor\nKd 1 1 1\nmap_Kd checker.png\n"
        "newmtl lamp\nKd 0 0 0\nKe 0.1333333333 0.1333333333 0.1333333333\n",
    )
    obj_lines = ["mtllib tex.mtl"]
    for p in quad_pos:
        obj_lines.append(f"v {p[0]} {p[1]} {p[2]}")
    for p in lamp_pos:
        obj_lines.append(f"v {p[0]} {p[1]} {p[2]}")
    for u, v in glb_uv:
        obj_lines.append(f"vt {u} {1.0 - v}")
    obj_lines += [
        "usemtl floor",
        "f 1/1 2/2 3/3",
        "f 1/1 3/3 4/4",
        "usemtl lamp",
        "f 7 6 5",
        "f 8 7 5",
    ]
    obj = _write(tmp_path, "tex.obj", "\n".join(obj_lines) + "\n")

    cfg = TracingConfig(
        width=24, height=24, cam_position=(0.0, 2.0, -3.5),
        cam_rotation=(0.45, 0.0), max_bounces=2,
    )
    st = RenderSettings(samples=8)
    film_glb = render_image(
        World.from_path(glb).to_device(), cfg, st, engine="brute"
    )
    film_obj = render_image(
        World.from_path(obj).to_device(), cfg, st, engine="brute"
    )
    assert film_glb.max() > 0.0
    # Same geometry/material/UV semantics -> same image (float tolerance;
    # GLB textures round-trip through 8-bit PNG, ours is exact 0/1 texels).
    np.testing.assert_allclose(film_obj, film_glb, atol=2e-3)


def _stl_binary(tris: np.ndarray) -> bytes:
    """tris: [T, 3, 3] float32 vertex triples."""
    out = bytearray(b"\0" * 80)
    out += struct.pack("<I", len(tris))
    for t in tris:
        out += struct.pack("<3f", 0, 0, 0)
        for v in t:
            out += struct.pack("<3f", *v)
        out += struct.pack("<H", 0)
    return bytes(out)


def test_stl_binary_and_ascii_match(tmp_path):
    from rustic.scene.mesh_formats import load_stl

    tris = np.array(
        [[[0, 0, 0], [1, 0, 0], [0, 2, 0]], [[0, 0, 0], [0, 2, 0], [-1, 0, 0]]],
        np.float32,
    )
    bin_path = os.path.join(str(tmp_path), "t.stl")
    with open(bin_path, "wb") as f:
        f.write(_stl_binary(tris))
    lines = ["solid t"]
    for t in tris:
        lines += ["facet normal 0 0 0", "outer loop"]
        lines += [f"vertex {v[0]} {v[1]} {v[2]}" for v in t]
        lines += ["endloop", "endfacet"]
    lines.append("endsolid t")
    asc_path = _write(tmp_path, "t_ascii.stl", "\n".join(lines) + "\n")

    a = load_stl(bin_path)
    b = load_stl(asc_path)
    np.testing.assert_allclose(a.positions, b.positions)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    # Y/Z swizzle applied: the glTF y=2 peak lands on renderer z
    assert a.positions[:, 2].max() == 2.0
    assert a.triangles.shape == (2, 4)


def test_ply_ascii_and_binary_match(tmp_path):
    from rustic.scene.mesh_formats import load_ply

    ascii_ply = (
        "ply\nformat ascii 1.0\n"
        "element vertex 4\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0\n1 0 0\n1 2 0\n0 2 0\n"
        "4 0 1 2 3\n"
    )
    a = load_ply(_write(tmp_path, "q.ply", ascii_ply))
    assert a.triangles.shape == (2, 4)  # quad fan-triangulated
    assert len(a.positions) == 4

    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
    )
    body = struct.pack("<12f", 0, 0, 0, 1, 0, 0, 1, 2, 0, 0, 2, 0)
    body += struct.pack("<B4i", 4, 0, 1, 2, 3)
    bin_path = os.path.join(str(tmp_path), "qb.ply")
    with open(bin_path, "wb") as f:
        f.write(header + body)
    b = load_ply(bin_path)
    np.testing.assert_allclose(a.positions, b.positions)
    np.testing.assert_array_equal(a.triangles, b.triangles)


def test_stl_soup_normals_weld_across_facets(tmp_path):
    """STL facets don't share vertices; smooth normals must still weld
    by position — a roof of two tilted quads gets an averaged (vertical)
    normal along the shared ridge, not per-facet flat normals."""
    from rustic.scene.mesh_formats import load_stl

    #   /\   two triangles meeting at the ridge x=0 (z in STL space)
    tris = np.array(
        [
            [[-2, 0, 0], [0, 2, 0], [-2, 0, 4]],
            [[0, 2, 0], [2, 0, 0], [2, 0, 4]],
        ],
        np.float32,
    )
    path = os.path.join(str(tmp_path), "roof.stl")
    with open(path, "wb") as f:
        f.write(_stl_binary(tris))
    scene = load_stl(path)
    # the ridge vertex (0,2,0) appears in both facets; its normal is the
    # average of the two slopes => within 45 deg of renderer +z (up)
    ridge = np.isclose(scene.positions[:, 2], 2.0)
    assert ridge.sum() == 2
    # averaged across the two slopes: vertical (pure +-z), not tilted
    assert np.all(np.abs(scene.normals[ridge][:, 2]) > 0.99)
    assert np.all(np.abs(scene.normals[ridge][:, 0]) < 1e-6)
    # non-ridge verts keep their slope normal (x component +-cos45)
    slope = ~ridge
    assert np.all(np.abs(np.abs(scene.normals[slope][:, 0]) - np.sqrt(0.5)) < 1e-6)


def test_ply_vertex_with_aux_list_property(tmp_path):
    """A binary vertex element that mixes scalars with a list property
    must keep its x/y/z (scalars were previously discarded)."""
    from rustic.scene.mesh_formats import load_ply

    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 3\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"property list uchar int adjacency\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
    )
    body = b""
    for v in ([0, 0, 0], [1, 0, 0], [0, 2, 0]):
        body += struct.pack("<3f", *v)
        body += struct.pack("<B2i", 2, 7, 8)  # adjacency list of 2
    body += struct.pack("<B3i", 3, 0, 1, 2)
    path = os.path.join(str(tmp_path), "aux.ply")
    with open(path, "wb") as f:
        f.write(header + body)
    scene = load_ply(path)
    assert scene.triangles.shape == (1, 4)
    np.testing.assert_allclose(sorted(scene.positions[:, 2]), [0, 0, 2])


def test_obj_multiple_mtllibs(tmp_path):
    """'mtllib a.mtl b.mtl' loads both libraries."""
    _write(tmp_path, "a.mtl", "newmtl red\nKd 1 0 0\n")
    _write(tmp_path, "b.mtl", "newmtl blue\nKd 0 0 1\n")
    scene = load_obj(
        _write(
            tmp_path,
            "two.obj",
            "mtllib a.mtl b.mtl\n"
            "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
            "usemtl red\nf 1 2 3\nusemtl blue\nf 1 2 4\n",
        )
    )
    colors = {
        tuple(scene.materials[m].base_color[:3]) for m in scene.triangles[:, 3]
    }
    assert colors == {(1.0, 0.0, 0.0), (0.0, 0.0, 1.0)}


def test_stl_renders_through_from_path(tmp_path):
    """World.from_path dispatch + a light: STL soup renders non-black."""
    from rustic.config import TracingConfig, RenderSettings
    from rustic.runtime.render import render_image
    from rustic.scene.world import World

    floor = np.array(
        [[[-5, 0, -5], [5, 0, -5], [5, 0, 5]], [[-5, 0, -5], [5, 0, 5], [-5, 0, 5]]],
        np.float32,
    )
    path = os.path.join(str(tmp_path), "floor.stl")
    with open(path, "wb") as f:
        f.write(_stl_binary(floor))
    world = World.from_path(path)
    scene = world.to_device()  # procedural sky lights it
    cfg = TracingConfig(
        width=12, height=12, cam_position=(0.0, 1.0, -4.0), max_bounces=2
    )
    film = render_image(scene, cfg, RenderSettings(samples=2), engine="brute")
    assert np.isfinite(film).all() and film.mean() > 0.0


def test_obj_renders_end_to_end(tmp_path):
    """An emissive OBJ quad over a diffuse floor must render non-black
    through World.from_path (format dispatch) on the brute engine."""
    from rustic.config import RenderSettings, TracingConfig
    from rustic.runtime.render import render_image
    from rustic.scene.world import World

    text = (
        "v -5 0 -5\nv 5 0 -5\nv 5 0 5\nv -5 0 5\n"  # floor
        "v -1 3 -1\nv 1 3 -1\nv 1 3 1\nv -1 3 1\n"  # emitter above
        "mtllib r.mtl\n"
        "usemtl grey\nf 1 2 3 4\nf 4 3 2 1\n"
        "usemtl lamp\nf 5 6 7 8\nf 8 7 6 5\n"
    )
    _write(
        tmp_path,
        "r.mtl",
        "newmtl grey\nKd 0.7 0.7 0.7\n"
        "newmtl lamp\nKd 0 0 0\nKe 2 2 2\n",
    )
    world = World.from_path(_write(tmp_path, "room.obj", text))
    scene = world.to_device()
    cfg = TracingConfig(
        width=16, height=16, cam_position=(0.0, 1.0, -4.0), max_bounces=3
    )
    film = render_image(scene, cfg, RenderSettings(samples=4), engine="brute")
    assert np.isfinite(film).all()
    assert film.mean() > 0.0
