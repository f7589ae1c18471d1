"""The furnace energy-conservation matrix — the reference's own
correctness gate (reference: tests/correctness_tests.rs:14-52): a 0.18-
albedo sphere inside a uniform emitter must render to ~0.8 after gamma
decode at pixel (65, 75) of a 128x128 frame, with and without NEE/MIS.

We run the same gate on the JAX CPU backend (the GPU runs the identical
program; chip_smoke.py exercises it on the card). Rendering only a probe
tile keeps CI fast — the wavefront integrator renders arbitrary pixel
sets natively.
"""

import numpy as np
import pytest

from rustic.config import NextEventEstimation, TracingConfig
from rustic.runtime.render import render_pixels

SIZE = 128
COORD = (65, 75)
ALBEDO = 0.8
SAMPLES = 32


def _furnace_value(
    furnace_scene, nee: NextEventEstimation, samples: int = SAMPLES
) -> np.ndarray:
    cfg = TracingConfig(width=SIZE, height=SIZE, nee=nee)
    px = np.array([COORD[0]], np.int32)
    py = np.array([COORD[1]], np.int32)
    film = np.asarray(render_pixels(furnace_scene, cfg, px, py, samples=samples))
    return (film[0] / samples) ** (1.0 / 2.2)


def test_furnace(furnace_scene):
    pixel = _furnace_value(furnace_scene, NextEventEstimation.NONE)
    assert np.all(np.abs(pixel - ALBEDO) < 0.02), pixel


def test_furnace_mis(furnace_scene):
    # MIS must conserve the same energy, inside the reference's own
    # ±0.02 gate (tests/correctness_tests.rs:14-32). The MIS estimator's
    # single-pixel variance at the reference's 32 spp straddles 0.02
    # under our (different) deterministic pixel seeds, so this cell
    # averages 4x the samples — variance, not bias: the 512-spp matrix
    # below pins all modes at ±0.02.
    pixel = _furnace_value(furnace_scene, NextEventEstimation.MIS, samples=128)
    assert np.all(np.abs(pixel - ALBEDO) < 0.02), pixel


@pytest.mark.slow
@pytest.mark.parametrize(
    "nee", [NextEventEstimation.NONE, NextEventEstimation.MIS]
)
def test_furnace_high_spp(furnace_scene, nee):
    """512-spp furnace at the reference's exact ±0.02 tolerance — the
    bias-vs-noise settle for both NEE modes. tools/quality_gate.py runs
    the same matrix on the card."""
    pixel = _furnace_value(furnace_scene, nee, samples=512)
    assert np.all(np.abs(pixel - ALBEDO) < 0.02), (nee, pixel)


def test_dls_matches_mis_on_black_emitters(tmp_path):
    """Direct light sampling (the reference's third NEE mode,
    shared_structs/src/lib.rs:193-236). NOTE: DLS is deliberately NOT
    furnace-tested — matching the reference exactly, a diffuse-bounce
    emissive hit is skipped and the path continues shading the emitter
    surface (kernels/src/lib.rs:96-101 falls through without a break),
    so emitters with nonzero albedo inter-reflect and the furnace gains
    energy; the reference's own test matrix is {off, MIS} only. With
    black-albedo emitters the estimators agree in expectation."""
    from rustic.config import RenderSettings
    from rustic.runtime.render import render_image
    from rustic.scene.glb_write import MaterialSpec, MeshSpec, write_glb
    from rustic.scene.world import World

    quad = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32)
    lamp = quad * 0.25 + np.array([0, 3, 0], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    path = str(tmp_path / "dls.glb")
    write_glb(
        path,
        meshes=[
            MeshSpec(positions=quad, indices=tris, material=0),
            MeshSpec(positions=lamp, indices=tris[:, ::-1], material=1),
        ],
        materials=[
            MaterialSpec(base_color=(0.7, 0.7, 0.7, 1.0), metallic=0.0),
            MaterialSpec(base_color=(0, 0, 0, 1), emissive=(0.2, 0.2, 0.2)),
        ],
    )
    scene = World.from_path(path).to_device()

    def mean(nee):
        cfg = TracingConfig(
            width=16, height=16, nee=nee,
            cam_position=(0.0, 1.5, -5.0), cam_rotation=(0.3, 0.0),
            max_bounces=3,
        )
        film = render_image(scene, cfg, RenderSettings(samples=48), engine="brute")
        return float(np.asarray(film).mean())

    m_mis = mean(NextEventEstimation.MIS)
    m_dls = mean(NextEventEstimation.DIRECT)
    assert m_mis > 0.01
    assert abs(m_dls - m_mis) / m_mis < 0.08, (m_dls, m_mis)


@pytest.mark.slow
def test_furnace_mis_converged(furnace_scene):
    cfg = TracingConfig(width=SIZE, height=SIZE, nee=NextEventEstimation.MIS)
    px = np.array([COORD[0]], np.int32)
    py = np.array([COORD[1]], np.int32)
    film = np.asarray(render_pixels(furnace_scene, cfg, px, py, samples=128))
    pixel = (film[0] / 128) ** (1.0 / 2.2)
    assert np.all(np.abs(pixel - ALBEDO) < 0.02), pixel


def test_emitter_seen_directly(furnace_scene):
    """A pixel on the emitter shell reads its radiance (3.0) exactly."""
    cfg = TracingConfig(width=SIZE, height=SIZE)
    px = np.array([20], np.int32)
    py = np.array([20], np.int32)
    film = np.asarray(render_pixels(furnace_scene, cfg, px, py, samples=4))
    np.testing.assert_allclose(film[0] / 4, 3.0, atol=1e-4)
