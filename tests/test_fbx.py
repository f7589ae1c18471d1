"""Binary FBX loader (scene/fbx.py).

The test ships its own minimal binary-FBX writer following the
documented container layout (the same one Blender's importer reads), so
the loader is validated against independently-constructed bytes:
zlib-compressed arrays, polygon terminators, ByPolygonVertex /
ByVertice layers, per-polygon materials, Lcl TRS, and the Y/Z + winding
renderer-space conventions shared with the other loaders.
"""

import struct
import zlib

import numpy as np
import pytest

from rustic.scene.fbx import load_fbx

# ---------------------------------------------------------------- writer


def _prop(value) -> bytes:
    if isinstance(value, str):
        raw = value.encode()
        return b"S" + struct.pack("<I", len(raw)) + raw
    if isinstance(value, int):
        return b"L" + struct.pack("<q", value)
    if isinstance(value, float):
        return b"D" + struct.pack("<d", value)
    if isinstance(value, np.ndarray):
        code = {"float64": b"d", "int32": b"i", "int64": b"l"}[str(value.dtype)]
        raw = value.tobytes()
        comp = zlib.compress(raw)
        return code + struct.pack("<III", value.size, 1, len(comp)) + comp
    raise TypeError(type(value))


def _node(name: str, props=(), children=(), offset=0) -> bytes:
    """Serialize one node record (u32 header, FBX < 7500)."""
    name_b = name.encode()
    prop_blob = b"".join(_prop(p) for p in props)
    body = b""
    hdr_len = 12 + 1 + len(name_b)
    child_blob = b""
    if children:
        pos = offset + hdr_len + len(prop_blob)
        for c_name, c_props, c_children in children:
            blob = _node(c_name, c_props, c_children, pos)
            child_blob += blob
            pos += len(blob)
        child_blob += b"\x00" * 13  # null sentinel
    end = offset + hdr_len + len(prop_blob) + len(child_blob)
    return (
        struct.pack("<III", end, len(props), len(prop_blob))
        + bytes([len(name_b)])
        + name_b
        + prop_blob
        + child_blob
    )


def _write_fbx(path, nodes):
    header = b"Kaydara FBX Binary  \x00\x1a\x00" + struct.pack("<I", 7400)
    blob = header
    for name, props, children in nodes:
        blob += _node(name, props, children, len(blob))
    blob += b"\x00" * 13
    with open(path, "wb") as f:
        f.write(blob)


def _p70(*entries):
    return (
        "Properties70",
        (),
        [("P", e, ()) for e in entries],
    )


def _cube_fbx(path, rotate_deg=0.0, translate=(0.0, 0.0, 0.0)):
    """One quad (0..1 in x, y plane) + a second triangle-poly with a
    different material; ByVertice normals; zlib arrays throughout."""
    verts = np.array(
        [0, 0, 0, 1, 0, 0, 1, 2, 0, 0, 2, 0, 3, 0, 0, 4, 0, 0, 4, 1, 0],
        np.float64,
    )
    # quad 0-1-2-3 (terminated by ~3), triangle 4-5-6 (terminated by ~6)
    pvi = np.array([0, 1, 2, -4, 4, 5, -7], np.int32)
    normals = np.tile(np.array([0.0, 0.0, 1.0]), 7)  # per-vertex (+z in FBX)
    geometry = (
        "Geometry",
        (100, "Geometry::mesh", "Mesh"),
        [
            ("Vertices", (verts,), ()),
            ("PolygonVertexIndex", (pvi,), ()),
            (
                "LayerElementNormal",
                (0,),
                [
                    ("MappingInformationType", ("ByVertice",), ()),
                    ("ReferenceInformationType", ("Direct",), ()),
                    ("Normals", (normals,), ()),
                ],
            ),
            (
                "LayerElementMaterial",
                (0,),
                [
                    ("MappingInformationType", ("ByPolygon",), ()),
                    ("ReferenceInformationType", ("IndexToDirect",), ()),
                    ("Materials", (np.array([0, 1], np.int32),), ()),
                ],
            ),
        ],
    )
    model = (
        "Model",
        (200, "Model::mesh", "Mesh"),
        [
            _p70(
                ["Lcl Rotation", "Lcl Rotation", "", "A", 0.0, 0.0, float(rotate_deg)],
                ["Lcl Translation", "Lcl Translation", "", "A", *map(float, translate)],
            )
        ],
    )
    mat_a = (
        "Material",
        (300, "Material::a", ""),
        [
            _p70(
                ["DiffuseColor", "Color", "", "A", 0.8, 0.1, 0.2],
                ["EmissiveColor", "Color", "", "A", 1.0, 0.0, 0.0],
                ["EmissiveFactor", "Number", "", "A", 0.5],
            )
        ],
    )
    mat_b = (
        "Material",
        (301, "Material::b", ""),
        [_p70(["DiffuseColor", "Color", "", "A", 0.0, 1.0, 0.0])],
    )
    connections = (
        "Connections",
        (),
        [
            ("C", ("OO", 100, 200), ()),
            ("C", ("OO", 300, 200), ()),
            ("C", ("OO", 301, 200), ()),
        ],
    )
    _write_fbx(
        path,
        [("Objects", (), [geometry, model, mat_a, mat_b]), connections],
    )


# ----------------------------------------------------------------- tests


def test_fbx_geometry_and_materials(tmp_path):
    path = str(tmp_path / "cube.fbx")
    _cube_fbx(path)
    scene = load_fbx(path)
    # quad -> 2 tris + 1 tri = 3 triangles, unshared corners = 9 verts
    assert scene.triangles.shape == (3, 4)
    assert len(scene.positions) == 9
    # ByVertice +z normal lands on renderer +y after the (x,z,y) swizzle
    np.testing.assert_allclose(scene.normals, [[0, 1, 0]] * 9, atol=1e-12)
    # per-polygon materials: quad -> mat a, triangle -> mat b
    assert scene.triangles[0, 3] == scene.triangles[1, 3]
    assert scene.triangles[2, 3] != scene.triangles[0, 3]
    a = scene.materials[scene.triangles[0, 3]]
    b = scene.materials[scene.triangles[2, 3]]
    np.testing.assert_allclose(a.base_color[:3], (0.8, 0.1, 0.2))
    # EmissiveColor x EmissiveFactor x 15
    np.testing.assert_allclose(a.emissive, (7.5, 0.0, 0.0))
    np.testing.assert_allclose(b.base_color[:3], (0.0, 1.0, 0.0))


def test_fbx_lcl_transform(tmp_path):
    path = str(tmp_path / "moved.fbx")
    _cube_fbx(path, rotate_deg=90.0, translate=(10.0, 0.0, 0.0))
    scene = load_fbx(path)
    # rotZ90 maps (x, y) -> (-y, x); +10 in x; swizzle keeps x first.
    # Quad verts (0,0),(1,0),(1,2),(0,2) -> x' in {10, 10, 8, 8}.
    quad_x = np.unique(np.round(scene.positions[:6, 0], 6))
    np.testing.assert_allclose(quad_x, [8.0, 10.0])
    # y (FBX) -> renderer z: quad y' = old x in {0, 1}
    np.testing.assert_allclose(
        np.unique(np.round(scene.positions[:6, 2], 6)), [0.0, 1.0]
    )


def test_fbx_winding_matches_obj(tmp_path):
    """The same triangle through FBX and OBJ yields identical
    renderer-space geometry."""
    from rustic.scene.obj import load_obj

    verts = np.array([0, 0, 0, 1, 0, 0, 0, 2, 0], np.float64)
    pvi = np.array([0, 1, -3], np.int32)
    geometry = (
        "Geometry",
        (100, "Geometry::t", "Mesh"),
        [("Vertices", (verts,), ()), ("PolygonVertexIndex", (pvi,), ())],
    )
    model = ("Model", (200, "Model::t", "Mesh"), [])
    conn = ("Connections", (), [("C", ("OO", 100, 200), ())])
    fbx_path = str(tmp_path / "t.fbx")
    _write_fbx(fbx_path, [("Objects", (), [geometry, model]), conn])

    obj_path = str(tmp_path / "t.obj")
    with open(obj_path, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 2 0\nf 1 2 3\n")

    a = load_fbx(fbx_path)
    b = load_obj(obj_path)
    np.testing.assert_allclose(
        a.positions[a.triangles[0, :3]],
        b.positions[b.triangles[0, :3]],
        atol=1e-12,
    )
    np.testing.assert_allclose(a.normals, b.normals, atol=1e-12)


ASCII_FBX = """
; FBX 7.4.0 project file
Objects:  {
    Geometry: 100, "Geometry::t", "Mesh" {
        Vertices: *9 {
            a: 0,0,0,1,0,0,0,2,0
        }
        PolygonVertexIndex: *3 {
            a: 0,1,-3
        }
        LayerElementNormal: 0 {
            MappingInformationType: "ByVertice"
            ReferenceInformationType: "Direct"
            Normals: *9 {
                a: 0,0,1,0,0,1,0,0,1
            }
        }
    }
    Model: 200, "Model::t", "Mesh" {
        Properties70:  {
            P: "Lcl Translation", "Lcl Translation", "", "A",5,0,0
        }
    }
    Material: 300, "Material::m", "" {
        Properties70:  {
            P: "DiffuseColor", "Color", "", "A",0.25,0.5,0.75
        }
    }
}
Connections:  {
    C: "OO",100,200
    C: "OO",300,200
}
"""


def test_fbx_ascii(tmp_path):
    p = tmp_path / "a.fbx"
    p.write_text(ASCII_FBX)
    scene = load_fbx(str(p))
    assert scene.triangles.shape == (1, 4)
    # translation +5x applied; swizzle keeps x
    np.testing.assert_allclose(sorted(scene.positions[:, 0]), [5, 5, 6])
    # FBX +z normal -> renderer +y
    np.testing.assert_allclose(scene.normals, [[0, 1, 0]] * 3, atol=1e-12)
    np.testing.assert_allclose(
        scene.materials[scene.triangles[0, 3]].base_color[:3],
        (0.25, 0.5, 0.75),
    )


def test_fbx_ascii_matches_binary(tmp_path):
    """The same triangle through the ASCII and binary containers."""
    verts = np.array([0, 0, 0, 1, 0, 0, 0, 2, 0], np.float64)
    pvi = np.array([0, 1, -3], np.int32)
    geometry = (
        "Geometry",
        (100, "Geometry::t", "Mesh"),
        [("Vertices", (verts,), ()), ("PolygonVertexIndex", (pvi,), ())],
    )
    model = (
        "Model",
        (200, "Model::t", "Mesh"),
        [_p70(["Lcl Translation", "Lcl Translation", "", "A", 5.0, 0.0, 0.0])],
    )
    conn = ("Connections", (), [("C", ("OO", 100, 200), ())])
    bin_path = str(tmp_path / "b.fbx")
    _write_fbx(bin_path, [("Objects", (), [geometry, model]), conn])
    asc_path = tmp_path / "a.fbx"
    asc_path.write_text(ASCII_FBX)

    a = load_fbx(str(asc_path))
    b = load_fbx(bin_path)
    np.testing.assert_allclose(a.positions, b.positions, atol=1e-12)
    np.testing.assert_array_equal(a.triangles[:, :3], b.triangles[:, :3])


def test_fbx_model_hierarchy_composes(tmp_path):
    """A mesh under a translated parent Model inherits the parent's
    transform (model->model OO connection)."""
    verts = np.array([0, 0, 0, 1, 0, 0, 0, 2, 0], np.float64)
    pvi = np.array([0, 1, -3], np.int32)
    geometry = (
        "Geometry",
        (100, "Geometry::t", "Mesh"),
        [("Vertices", (verts,), ()), ("PolygonVertexIndex", (pvi,), ())],
    )
    child = (
        "Model",
        (200, "Model::child", "Mesh"),
        [_p70(["Lcl Translation", "Lcl Translation", "", "A", 1.0, 0.0, 0.0])],
    )
    parent = (
        "Model",
        (201, "Model::parent", "Null"),
        [
            _p70(
                ["Lcl Translation", "Lcl Translation", "", "A", 0.0, 5.0, 0.0],
                ["Lcl Scaling", "Lcl Scaling", "", "A", 2.0, 2.0, 2.0],
            )
        ],
    )
    conn = (
        "Connections",
        (),
        [("C", ("OO", 100, 200), ()), ("C", ("OO", 200, 201), ())],
    )
    path = str(tmp_path / "h.fbx")
    _write_fbx(path, [("Objects", (), [geometry, child, parent]), conn])
    scene = load_fbx(path)
    # FBX (0,0,0) -> child +1x -> (1,0,0) -> parent scale 2 + (0,5,0)
    # -> (2,5,0); renderer swizzle (x,z,y) -> (2,0,5)
    np.testing.assert_allclose(
        scene.positions[scene.triangles[0, 0]], [2.0, 0.0, 5.0], atol=1e-12
    )


def test_fbx_allsame_material_index(tmp_path):
    """AllSame LayerElementMaterial with Materials=[1] must pick the
    SECOND connected material for every polygon."""
    verts = np.array([0, 0, 0, 1, 0, 0, 0, 2, 0], np.float64)
    pvi = np.array([0, 1, -3], np.int32)
    geometry = (
        "Geometry",
        (100, "Geometry::t", "Mesh"),
        [
            ("Vertices", (verts,), ()),
            ("PolygonVertexIndex", (pvi,), ()),
            (
                "LayerElementMaterial",
                (0,),
                [
                    ("MappingInformationType", ("AllSame",), ()),
                    ("ReferenceInformationType", ("IndexToDirect",), ()),
                    ("Materials", (np.array([1], np.int32),), ()),
                ],
            ),
        ],
    )
    model = ("Model", (200, "Model::t", "Mesh"), [])
    mat_a = (
        "Material",
        (300, "Material::a", ""),
        [_p70(["DiffuseColor", "Color", "", "A", 1.0, 0.0, 0.0])],
    )
    mat_b = (
        "Material",
        (301, "Material::b", ""),
        [_p70(["DiffuseColor", "Color", "", "A", 0.0, 0.0, 1.0])],
    )
    conn = (
        "Connections",
        (),
        [
            ("C", ("OO", 100, 200), ()),
            ("C", ("OO", 300, 200), ()),
            ("C", ("OO", 301, 200), ()),
        ],
    )
    path = str(tmp_path / "m.fbx")
    _write_fbx(path, [("Objects", (), [geometry, model, mat_a, mat_b]), conn])
    scene = load_fbx(path)
    m = scene.materials[scene.triangles[0, 3]]
    np.testing.assert_allclose(m.base_color[:3], (0.0, 0.0, 1.0))


def test_fbx_rejects_garbage(tmp_path):
    p = tmp_path / "g.fbx"
    p.write_bytes(b"\x89PNG not a scene")
    with pytest.raises(ValueError):
        load_fbx(str(p))


def test_fbx_renders_through_from_path(tmp_path):
    from rustic.config import RenderSettings, TracingConfig
    from rustic.runtime.render import render_image
    from rustic.scene.world import World

    path = str(tmp_path / "cube.fbx")
    _cube_fbx(path)
    scene = World.from_path(path).to_device()
    cfg = TracingConfig(
        width=12, height=12, cam_position=(0.5, 1.0, -3.0), max_bounces=2
    )
    film = render_image(scene, cfg, RenderSettings(samples=2), engine="brute")
    assert np.isfinite(film).all() and film.mean() > 0.0
