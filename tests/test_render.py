"""End-to-end render regression checks on small frames (CPU backend).

Structural assertions on DarkCornell (red wall left, green wall right,
emissive panel brightest) plus cross-checks that the CPU intersection
engines produce the same image.
"""

import numpy as np
import pytest

from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic.runtime.render import render_image


@pytest.fixture(scope="module")
def cornell_frame(cornell_scene):
    cfg = TracingConfig(width=64, height=36, nee=NextEventEstimation.MIS)
    return render_image(cornell_scene, cfg, RenderSettings(samples=8))


def test_cornell_color_structure(cornell_frame):
    film = cornell_frame
    h, w, _ = film.shape
    left = film[:, : w // 3].mean(axis=(0, 1))
    right = film[:, 2 * w // 3 :].mean(axis=(0, 1))
    assert left[0] > 3 * left[1], left  # red wall dominates left third
    assert right[1] > 3 * right[0], right  # green wall dominates right
    assert film.max() > 0.05  # lit scene
    assert np.isfinite(film).all()


@pytest.mark.slow  # engine equality renders
def test_engines_render_identically(cornell_scene):
    cfg = TracingConfig(width=24, height=16, nee=NextEventEstimation.MIS)
    settings = RenderSettings(samples=4)
    brute = render_image(cornell_scene, cfg, settings, engine="brute")
    bvh = render_image(cornell_scene, cfg, settings, engine="bvh")
    np.testing.assert_allclose(brute, bvh, rtol=1e-4, atol=1e-5)


def test_nee_off_and_mis_converge_together(cornell_scene):
    """NEE must change variance, not energy: low-res frames at moderate
    spp agree in overall brightness."""
    base = TracingConfig(width=32, height=18)
    mis = base.replace(nee=NextEventEstimation.MIS)
    a = render_image(cornell_scene, base, RenderSettings(samples=64))
    b = render_image(cornell_scene, mis, RenderSettings(samples=64))
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-9) < 0.25


def test_veach_renders(tmp_path):
    from rustic.scene.world import World
    from tests.conftest import scene_path

    scene = World.from_path(scene_path("VeachMIS.glb")).to_device()
    cfg = TracingConfig(
        width=48,
        height=27,
        nee=NextEventEstimation.MIS,
        cam_position=(0.0, 2.0, -14.0),
    )
    film = render_image(scene, cfg, RenderSettings(samples=4))
    assert np.isfinite(film).all()
    assert film.max() > 0.0


@pytest.mark.slow  # engine equality renders
def test_break_time_textured_skybox_renders():
    """BreakTime (BASELINE config #5 stand-in): full PBR maps + normal
    mapping + HDR skybox through the window. Engine-equality is the
    integration gate for the textured path (shared deterministic
    sampler => geometric agreement to float tolerance)."""
    from rustic.config import NextEventEstimation, TracingConfig
    from rustic.scene.world import load_scene
    from rustic.utils.compare import compare_engines
    from tests.conftest import scene_path

    scene = load_scene(
        scene_path("BreakTime.glb"), scene_path("BreakTimeSky.npy")
    )
    config = TracingConfig(
        width=32, height=18, nee=NextEventEstimation.MIS,
        cam_position=(0.0, 1.8, -3.2), has_skybox=True,
    )
    out = compare_engines(scene, config, samples=2, engines=("brute", "bvh"))
    assert out["brute_vs_bvh"] < 1e-4
