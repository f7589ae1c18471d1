import os

import numpy as np
import pytest

from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic.runtime.state import Checkpoint, TracingState


@pytest.fixture(scope="module")
def small_cfg():
    return TracingConfig(width=16, height=16, max_bounces=2)


def test_progressive_accumulation_matches_oneshot(cornell_scene, small_cfg):
    """N steps of sync_rate samples == one render of N*sync_rate samples
    (the reference preserves this by accumulating sums device-side,
    src/trace.rs:177-204)."""
    settings = RenderSettings(sync_rate=2, use_blue_noise=True)
    state = TracingState(16, 16, small_cfg, settings)
    state.step(cornell_scene)
    state.step(cornell_scene)
    frame_prog = state.framebuffer

    state2 = TracingState(16, 16, small_cfg, settings)
    frame_one = state2.step(cornell_scene, n_samples=4)
    np.testing.assert_allclose(frame_prog, frame_one, rtol=1e-5, atol=1e-6)


def test_dirty_resets_accumulator(cornell_scene, small_cfg):
    state = TracingState(16, 16, small_cfg, RenderSettings(sync_rate=1))
    state.step(cornell_scene)
    assert state.samples == 1
    state.set_config(max_bounces=3)
    state.step(cornell_scene)
    assert state.samples == 1  # reset happened before the new sample


def test_restore_continues_accumulation(cornell_scene, small_cfg):
    """Engine-switch semantics: restoring mean*samples then adding more
    samples equals rendering straight through
    (reference: src/trace.rs:162-164)."""
    settings = RenderSettings(sync_rate=2)
    a = TracingState(16, 16, small_cfg, settings)
    a.step(cornell_scene, 2)
    b = TracingState(16, 16, small_cfg, settings)
    b.restore(a.framebuffer, a.samples)
    b.step(cornell_scene, 2)

    c = TracingState(16, 16, small_cfg, settings)
    c.step(cornell_scene, 4)
    np.testing.assert_allclose(b.framebuffer, c.framebuffer, rtol=1e-4, atol=1e-5)


def test_run_until_target(cornell_scene, small_cfg):
    state = TracingState(16, 16, small_cfg, RenderSettings(sync_rate=3))
    frames = []
    state.run(cornell_scene, target_samples=7, on_frame=lambda f, s: frames.append(s))
    assert state.samples == 7
    assert frames == [3, 6, 7]


def test_checkpoint_roundtrip(cornell_scene, small_cfg, tmp_path):
    settings = RenderSettings(sync_rate=2)
    state = TracingState(16, 16, small_cfg, settings)
    state.step(cornell_scene, 2)
    path = os.path.join(tmp_path, "ckpt.npz")
    Checkpoint.from_state(state).save(path)

    resumed = Checkpoint.load(path).into_state(settings)
    assert resumed.samples == 2
    assert resumed.config.width == 16
    resumed.step(cornell_scene, 2)

    straight = TracingState(16, 16, small_cfg, settings)
    straight.step(cornell_scene, 4)
    np.testing.assert_allclose(
        resumed.framebuffer, straight.framebuffer, rtol=1e-4, atol=1e-5
    )


def test_denoise_reduces_noise():
    from rustic.runtime.denoise import denoise

    rng = np.random.default_rng(0)
    clean = np.tile(
        np.linspace(0.2, 0.8, 32)[None, :, None], (32, 1, 3)
    ).astype(np.float32)
    noisy = clean + rng.normal(0, 0.15, clean.shape).astype(np.float32)
    out = denoise(noisy)
    assert out.shape == clean.shape
    err_before = np.abs(noisy - clean).mean()
    err_after = np.abs(out - clean).mean()
    assert err_after < err_before * 0.7


def test_render_image_batching_consistent(cornell_scene, small_cfg):
    """Chunked megabatches must produce the same film as one batch."""
    from rustic.runtime.render import render_image

    s_one = RenderSettings(samples=2, batch_pixels=1 << 20)
    s_chunked = RenderSettings(samples=2, batch_pixels=64)
    a = render_image(cornell_scene, small_cfg, s_one)
    b = render_image(cornell_scene, small_cfg, s_chunked)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_resize_via_set_config(cornell_scene, small_cfg):
    """set_config(width/height) rebuilds the pixel set at the next step
    (regression: reset() left stale px/py/film at the old resolution)."""
    state = TracingState(16, 16, small_cfg, RenderSettings(sync_rate=1))
    state.step(cornell_scene)
    state.set_config(width=8, height=8)
    frame = state.step(cornell_scene)
    assert frame.shape == (8, 8, 3)
    assert state.samples == 1  # accumulation restarted


def test_settings_engine_reaches_render(cornell_scene, small_cfg, monkeypatch):
    """The progressive driver honors RenderSettings.engine."""
    import rustic.runtime.state as state_mod

    seen = {}
    real = state_mod.render_pixels

    def spy(*a, **kw):
        seen["engine"] = kw.get("engine")
        return real(*a, **kw)

    monkeypatch.setattr(state_mod, "render_pixels", spy)
    st = TracingState(
        8, 8, small_cfg, RenderSettings(sync_rate=1, engine="brute")
    )
    st.step(cornell_scene)
    assert seen["engine"] == "brute"


def test_checkpoint_resume_is_exact(cornell_scene, small_cfg, tmp_path):
    """into_state assigns the stored film sum directly — no mean
    round-trip error."""
    from rustic.runtime.state import Checkpoint

    state = TracingState(8, 8, small_cfg, RenderSettings(sync_rate=3))
    state.step(cornell_scene)
    ck = Checkpoint.from_state(state)
    resumed = ck.into_state(RenderSettings(sync_rate=3))
    np.testing.assert_array_equal(
        np.asarray(resumed._film_sum), np.asarray(state._film_sum)
    )
    assert resumed.samples == state.samples
