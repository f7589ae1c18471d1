"""HDR equirect skybox: load -> device -> rendered sky radiance.

Covers the reference's image-skybox path end to end (loading
src/asset.rs:238-255, sampling kernels/src/lib.rs:66-79): a synthetic
HDR file with a bright band must light up rays toward that band, scaled
by sun intensity / 15.
"""

import os

import numpy as np
import pytest

from rustic.config import RenderSettings, TracingConfig
from rustic.runtime.render import render_image
from rustic.scene.world import World, load_skybox_image
from rustic.scene.gltf import GltfMaterial, GltfScene


def _hdr_file(tmp_path) -> str:
    """Write a synthetic .hdr (radiance RGBE) via imageio if possible,
    else fall back to a PNG (the loader handles both)."""
    img = np.zeros((16, 32, 3), np.float32)
    img[6:10, :, 0] = 4.0  # bright red horizontal band at the horizon
    path = os.path.join(tmp_path, "sky.hdr")
    try:
        import imageio.v3 as iio

        iio.imwrite(path, img)
        loaded = load_skybox_image(path)
        if not np.isfinite(loaded).all() or loaded[..., 0].max() < 1.0:
            raise RuntimeError("hdr plugin mangled values")
        return path
    except Exception:
        from PIL import Image

        path = os.path.join(tmp_path, "sky.png")
        u8 = (np.clip(img / 4.0, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(u8, "RGB").save(path)
        return path


def _tiny_world() -> World:
    # one far-away triangle so the scene isn't empty; camera rays miss it
    verts = np.array([[100, 100, 100], [101, 100, 100], [100, 101, 100]], np.float32)
    scene = GltfScene(
        positions=verts,
        normals=np.tile(np.array([0.0, 0.0, -1.0], np.float32), (3, 1)),
        tangents=np.tile(np.array([1.0, 0.0, 0.0], np.float32), (3, 1)),
        uv0=np.zeros((3, 2), np.float32),
        triangles=np.array([[0, 1, 2, 0]], np.int64),
        materials=[GltfMaterial()],
    )
    return World(scene)


def test_hdr_skybox_lights_the_frame(tmp_path):
    sky_path = _hdr_file(tmp_path)
    world = _tiny_world()
    scene = world.to_device(load_skybox_image(sky_path))
    cfg = TracingConfig(width=16, height=16, has_skybox=True, max_bounces=1)
    film = render_image(scene, cfg, RenderSettings(samples=2))
    assert np.isfinite(film).all()
    # the red band dominates whatever the frame sees
    assert film[..., 0].max() > film[..., 1].max() + 1e-6
    assert film[..., 0].max() > 0.05


def test_fallback_magenta_skybox():
    """No skybox file + has_skybox=True -> the reference's 2x2 magenta
    fallback (src/asset.rs:275-289)."""
    scene = _tiny_world().to_device()
    cfg = TracingConfig(width=8, height=8, has_skybox=True, max_bounces=1)
    film = render_image(scene, cfg, RenderSettings(samples=1))
    # magenta: red & blue = intensity scale, green 0
    assert film[..., 0].max() > 0.5
    assert film[..., 1].max() < 1e-5
    assert film[..., 2].max() > 0.5


def test_sun_intensity_scales_image_sky(tmp_path):
    sky_path = _hdr_file(tmp_path)
    world = _tiny_world()
    scene = world.to_device(load_skybox_image(sky_path))
    base = TracingConfig(width=8, height=8, has_skybox=True, max_bounces=1)
    dim = base.replace(sun_direction=(*base.sun_direction[:3], 7.5))
    f1 = render_image(scene, base, RenderSettings(samples=1))
    f2 = render_image(scene, dim, RenderSettings(samples=1))
    np.testing.assert_allclose(f2, f1 * 0.5, rtol=1e-4, atol=1e-6)
