"""Glass (GGX dielectric transmission) — wired via KHR_materials_transmission.

The reference implements this BSDF but never connects it to a material
(kernels/src/bsdf.rs:107-176); we drive it from the standard glTF
extension, so a transmissive pane lets light through while the same
geometry with transmission=0 blocks it.
"""

import numpy as np
import pytest

from rustic.config import TracingConfig, RenderSettings
from rustic.runtime.render import render_pixels
from rustic.scene.gltf import GltfMaterial, GltfScene
from rustic.scene.world import World


def _quad(x0, x1, y0, y1, z, flip=False):
    verts = np.array(
        [[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]], np.float32
    )
    tris = np.array([[0, 2, 1], [0, 3, 2]] if not flip else [[0, 1, 2], [0, 2, 3]])
    return verts, tris


def _pane_scene(transmission: float) -> World:
    verts = []
    tris = []
    mats = []
    base = 0
    # pane at z=0 facing the camera (camera looks +z from z=-5)
    v, t = _quad(-4, 4, -4, 4, 0.0)
    verts.append(v)
    tris.append(np.concatenate([t + base, np.full((2, 1), 0)], axis=1))
    base += 4
    # emitter at z=2
    v, t = _quad(-4, 4, -4, 4, 2.0)
    verts.append(v)
    tris.append(np.concatenate([t + base, np.full((2, 1), 1)], axis=1))

    positions = np.concatenate(verts)
    triangles = np.concatenate(tris).astype(np.int64)
    # winding determines geometric normal; give shading normals facing -z
    normals = np.tile(np.array([0.0, 0.0, -1.0], np.float32), (len(positions), 1))
    tangents = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (len(positions), 1))
    uv = np.zeros((len(positions), 2), np.float32)

    mats = [
        GltfMaterial(
            base_color=(0.9, 0.9, 0.9, 1.0),
            metallic=0.0,
            roughness=0.05,
            transmission=transmission,
            ior=1.5,
        ),
        GltfMaterial(base_color=(0.8, 0.8, 0.8, 1.0), emissive=(5.0, 5.0, 5.0)),
    ]
    scene = GltfScene(
        positions=positions,
        normals=normals,
        tangents=tangents,
        uv0=uv,
        triangles=triangles,
        materials=mats,
    )
    return World(scene)


def _center_radiance(world: World) -> float:
    scene = world.to_device()
    cfg = TracingConfig(
        width=32, height=32, cam_position=(0.0, 0.0, -5.0), max_bounces=4
    )
    film = np.asarray(
        render_pixels(scene, cfg, np.array([16], np.int32), np.array([16], np.int32), 16)
    )
    return float(film[0].mean() / 16)


def test_glass_flag_detected():
    assert _pane_scene(1.0).to_device().has_glass
    assert not _pane_scene(0.0).to_device().has_glass


def test_light_transmits_through_glass():
    glass = _center_radiance(_pane_scene(1.0))
    opaque = _center_radiance(_pane_scene(0.0))
    # Through the pane the path reaches the 5.0 emitter; the opaque pane
    # reflects into darkness.
    assert glass > 5 * max(opaque, 1e-4), (glass, opaque)
    assert glass > 1.0, glass


def test_glass_energy_bounded():
    glass = _center_radiance(_pane_scene(1.0))
    assert glass < 5.01  # cannot exceed the emitter radiance


@pytest.mark.slow  # full-scene render
def test_glass_test_scene_loads_and_renders():
    """The generated GlassTest.glb (tools/make_scenes.py — coverage for
    the reference's stripped GlassTest scene / BASELINE config #3) must
    load with glass + lights and render identically through the brute
    oracle and the BVH engine."""
    import os

    from rustic.config import NextEventEstimation
    from rustic.runtime.render import render_image
    from rustic.scene.world import load_scene

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "scenes", "GlassTest.glb",
    )
    scene = load_scene(path)
    assert scene.has_glass and scene.has_lights and not scene.has_textures

    cfg = TracingConfig(
        width=64, height=36, nee=NextEventEstimation.MIS,
        cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0),
    )
    st = RenderSettings(samples=4)
    brute = np.asarray(render_image(scene, cfg, st, engine="brute"))
    bvh = np.asarray(render_image(scene, cfg, st, engine="bvh"))
    assert np.isfinite(brute).all()
    assert brute.mean() > 0.1  # lit scene, not black
    np.testing.assert_allclose(bvh, brute, rtol=1e-4, atol=1e-5)
