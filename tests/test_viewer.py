"""Headless checks of the interactive viewer's control logic."""

import numpy as np

from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic.runtime.viewer import Viewer


def _viewer(cornell_scene):
    cfg = TracingConfig(width=16, height=16, max_bounces=2)
    return Viewer(cornell_scene, cfg, RenderSettings(sync_rate=1))


def test_step_produces_frames(cornell_scene):
    v = _viewer(cornell_scene)
    frame = v.step()
    assert frame.shape == (16, 16, 3)
    assert np.isfinite(frame).all()
    assert v.state.samples == 1


def test_camera_keys_mark_dirty_and_move(cornell_scene):
    v = _viewer(cornell_scene)
    v.step()
    pos0 = v.state.config.cam_position
    v.handle_key("w")
    assert v.state.config.cam_position != pos0
    v.step()
    assert v.state.samples == 1  # accumulation restarted after the move


def test_look_keys_change_rotation(cornell_scene):
    v = _viewer(cornell_scene)
    rot0 = v.state.config.cam_rotation
    v.handle_key("left")
    assert v.state.config.cam_rotation != rot0


def test_mode_toggles(cornell_scene):
    v = _viewer(cornell_scene)
    assert v.state.config.nee == NextEventEstimation.NONE
    v.handle_key("n")
    assert v.state.config.nee == NextEventEstimation.MIS
    t0 = v.tonemap
    v.handle_key("t")
    assert v.tonemap != t0
    v.handle_key("x")
    assert v.settings.denoise


def test_escape_quits(cornell_scene):
    v = _viewer(cornell_scene)
    assert not v.handle_key("escape")


def test_speed_modifiers(cornell_scene):
    """shift = 10x, ctrl = 0.1x (reference: src/app.rs:439-492)."""
    v = _viewer(cornell_scene)
    z0 = v.state.config.cam_position[2]
    v.handle_key("w")
    plain = v.state.config.cam_position[2] - z0
    z1 = v.state.config.cam_position[2]
    v.handle_key("shift+w")
    fast = v.state.config.cam_position[2] - z1
    z2 = v.state.config.cam_position[2]
    v.handle_key("ctrl+w")
    slow = v.state.config.cam_position[2] - z2
    assert np.isclose(fast, 10 * plain) and np.isclose(slow, 0.1 * plain)
    # matplotlib delivers shift+letter as the bare uppercase letter
    z3 = v.state.config.cam_position[2]
    v.handle_key("W")
    assert np.isclose(v.state.config.cam_position[2] - z3, 10 * plain)


def test_sun_controls(cornell_scene):
    """Sun orbit + intensity (reference env GUI: src/app.rs:365-437)."""
    v = _viewer(cornell_scene)
    sun0 = np.asarray(v.state.config.sun_direction)
    v.handle_key("l")
    sun1 = np.asarray(v.state.config.sun_direction)
    assert not np.allclose(sun1[:3], sun0[:3])
    # direction stays unit-length; intensity untouched by orbit keys
    assert np.isclose(np.linalg.norm(sun1[:3]), 1.0, atol=1e-6)
    assert sun1[3] == sun0[3]
    v.handle_key("=")
    assert v.state.config.sun_direction[3] > sun1[3]
    v.handle_key("-")
    # intensity never goes negative
    for _ in range(40):
        v.handle_key("-")
    assert v.state.config.sun_direction[3] >= 0.0


def test_mouse_drag_look(cornell_scene):
    """Mouse-drag camera look (reference: src/app.rs:439-492)."""
    v = _viewer(cornell_scene)
    rot0 = v.state.config.cam_rotation
    v.on_mouse_press(100.0, 100.0)
    assert v.state.interacting
    v.on_mouse_move(120.0, 90.0)
    pitch, yaw = v.state.config.cam_rotation
    assert yaw > rot0[1]  # dragged right -> turned right
    assert pitch < rot0[0]  # dragged up (y shrinks) -> looked up
    v.on_mouse_release()
    assert not v.state.interacting
    # motion without a press is ignored
    rot1 = v.state.config.cam_rotation
    v.on_mouse_move(500.0, 500.0)
    assert v.state.config.cam_rotation == rot1


def test_load_path_switches_scene_and_skybox(cornell_world, tmp_path):
    """Runtime scene/skybox switching — the reference's drag-drop
    loader (src/app.rs:617-624) with its image-vs-scene detection
    (src/app.rs:44-52)."""
    import os

    from conftest import scene_path

    cfg = TracingConfig(width=8, height=8, max_bounces=2)
    v = Viewer(
        cornell_world.to_device(), cfg, RenderSettings(sync_rate=1),
        world=cornell_world,
    )
    v.step()
    old_scene = v.scene
    assert v.load_path(scene_path("FurnaceTest.glb"))
    assert v.scene is not old_scene
    assert v.world.triangles.shape[0] != cornell_world.triangles.shape[0]
    frame = v.step()
    assert np.isfinite(frame).all() and v.state.samples == 1

    # an image path becomes the skybox (here: a .npy HDR image)
    sky = np.full((4, 8, 3), 0.25, np.float32)
    p = tmp_path / "sky.npy"
    np.save(p, sky)
    scene_before = v.scene
    assert v.load_path(str(p))
    assert v.state.config.has_skybox
    assert v.scene is not scene_before
    assert np.isfinite(v.step()).all()

    # bad paths are survivable
    assert not v.load_path(str(tmp_path / "missing.glb"))


def test_backend_toggle_preserves_film(cornell_scene):
    """'c' flips compute CPU<->default with sum = mean * samples
    preserved (reference: src/app.rs:324-346, src/trace.rs:162-164)."""
    v = _viewer(cornell_scene)
    v.step()
    v.step()
    frame = v.state.framebuffer.copy()
    samples = v.state.samples
    v.handle_key("c")
    assert v.settings.backend == "cpu"
    assert v.state.samples == samples
    np.testing.assert_allclose(v.state.framebuffer, frame, rtol=1e-6)
    f2 = v.step()  # renders on the CPU twin, film continues
    assert v.state.samples == samples + 1
    assert np.isfinite(f2).all()
    v.handle_key("c")
    assert v.settings.backend == "auto"
