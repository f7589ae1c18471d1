"""Denoiser validation (round-2 verdict item 9).

The reference's denoise pass is OIDN's RayTracing filter applied to the
averaged linear framebuffer (reference: src/trace.rs:125-134). Here the
built-in fallback is an edge-aware a-trous wavelet filter
(runtime/denoise.py). These tests pin both halves:

- the OIDN import path is probed and skip-reported when the binding is
  absent from the environment (it is not baked into this image);
- the a-trous fallback is validated the way a denoiser must be: a noisy
  low-spp DarkCornell render, denoised, must land closer (in RMSE) to
  the committed 2048-spp ground-truth film than the noisy input was,
  without losing image energy.
"""

import os

import numpy as np
import pytest

from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic.runtime.denoise import denoise
from rustic.scene.world import World
from tests.conftest import scene_path

REF = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "reference", "darkcornell_256x144_2048spp.npy",
)


def test_oidn_import_status():
    """The reference prefers OIDN when its feature is enabled; this
    environment has no OIDN binding, so denoise() must fall back to
    a-trous rather than fail. Skip-with-reason records the status in
    every CI run (verdict item: 'try OIDN import in CI and
    skip-with-reason if unavailable')."""
    try:
        import oidn  # type: ignore  # noqa: F401
    except ImportError:
        pytest.skip("oidn python binding not importable here - "
                    "denoise() uses the a-trous fallback (validated below)")
    # If an OIDN binding ever appears, denoise() must still return a
    # finite image of the right shape through it.
    img = np.abs(np.random.default_rng(0).normal(0.3, 0.1, (32, 32, 3))).astype(
        np.float32
    )
    out = denoise(img)
    assert out.shape == img.shape and np.isfinite(out).all()


@pytest.mark.slow
def test_atrous_improves_noisy_render_rmse():
    """A 4-spp DarkCornell render denoised by the a-trous fallback must
    cut RMSE vs the 2048-spp ground truth (the reference validates its
    denoiser by eye in the viewer; this is the quantitative version),
    keep energy, and stay finite."""
    from rustic.runtime.render import render_image

    if not os.path.exists(REF):
        pytest.skip("ground-truth film not present")
    ref = np.load(REF)
    scene = World.from_path(scene_path("DarkCornell.glb")).to_device()
    cfg = TracingConfig(width=256, height=144, nee=NextEventEstimation.MIS)
    noisy = np.asarray(render_image(scene, cfg, RenderSettings(samples=4)))

    out = np.asarray(denoise(noisy))
    assert np.isfinite(out).all()

    rmse_noisy = float(np.sqrt(np.mean((noisy - ref) ** 2)))
    rmse_den = float(np.sqrt(np.mean((out - ref) ** 2)))
    # the filter must remove noise, not add it — and meaningfully so
    # (measured 0.0579 -> ~0.0105, a 5.5x cut; gate at 3x for headroom)
    assert rmse_den < rmse_noisy / 3.0, (rmse_noisy, rmse_den)
    # energy: the firefly clamp is a documented biased variance
    # tradeoff (runtime/denoise.py _clamp_fireflies) costing ~9% of
    # frame energy at 4 spp; gate that it stays bounded
    rel_energy = abs(out.mean() - ref.mean()) / max(ref.mean(), 1e-9)
    assert rel_energy < 0.15, (out.mean(), ref.mean())


def test_atrous_flat_region_converges():
    """On a constant image plus zero-mean noise, the a-trous filter must
    reduce variance by a large factor and preserve the mean (energy)."""
    rng = np.random.default_rng(7)
    base = np.full((64, 64, 3), 0.4, np.float32)
    noisy = base + rng.normal(0, 0.05, base.shape).astype(np.float32)
    out = np.asarray(denoise(noisy))
    assert np.isfinite(out).all()
    assert abs(float(out.mean()) - float(noisy.mean())) < 5e-3
    assert float(out.std()) < 0.4 * float(noisy.std())


def test_luminance_and_firefly_clamp_match_float64():
    """The luminance dot (full f32, not TF32) and the firefly clamp
    against a float64 NumPy twin of the same filter."""
    import jax.numpy as jnp

    from rustic.runtime.denoise import _LUM, _clamp_fireflies, _luminance

    rng = np.random.default_rng(3)
    img = rng.uniform(0.0, 1.0, (12, 10, 3))
    img[4, 5] = 40.0  # a firefly
    np.testing.assert_allclose(
        np.asarray(_luminance(jnp.asarray(img, jnp.float32))),
        img @ _LUM.astype(np.float64), rtol=1e-6,
    )
    lum = img @ _LUM.astype(np.float64)
    neigh = [np.roll(lum, (dy, dx), axis=(0, 1))
             for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
    cap = np.median(np.stack(neigh), axis=0) * 2.0 + 1e-4
    expect = img * np.where(lum > cap, cap / np.maximum(lum, 1e-9), 1.0)[..., None]
    got = np.asarray(_clamp_fireflies(jnp.asarray(img, jnp.float32)))
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)
    assert got[4, 5].sum() < 5.0
