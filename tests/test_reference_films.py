"""Quality gates against committed ground-truth films.

assets/reference/ holds high-spp films rendered by an earlier validated
build (256x144; DarkCornell 2048 spp MIS, FurnaceTest 1024 spp, VeachMIS
1024 spp). A current low-spp render must agree in energy (tight) and in
per-pixel RMSE (noise-bounded) — the BASELINE.md RMSE-vs-reference gate,
made concrete. Any future change that biases the integrator trips these
before it ships.
"""

import os

import numpy as np
import pytest

from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic.runtime.render import render_image
from rustic.scene.world import World
from tests.conftest import scene_path

REF_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "reference",
)

CASES = [
    ("DarkCornell", "darkcornell_256x144_2048spp.npy", dict(nee=NextEventEstimation.MIS)),
    ("FurnaceTest", "furnacetest_256x144_1024spp.npy", dict()),
    (
        "VeachMIS",
        "veachmis_256x144_1024spp.npy",
        dict(
            nee=NextEventEstimation.MIS,
            cam_position=(5.0, 3.0, -10.0),
            cam_rotation=(0.25, 0.05),
        ),
    ),
    (
        "GlassTest",
        "glasstest_256x144_1024spp.npy",
        dict(
            nee=NextEventEstimation.MIS,
            cam_position=(0.0, 2.2, -6.5),
            cam_rotation=(0.15, 0.0),
        ),
    ),
    (
        "BreakTime",
        "breaktime_256x144_1024spp.npy",
        dict(
            nee=NextEventEstimation.MIS,
            cam_position=(0.0, 1.8, -3.2),
            has_skybox=True,
        ),
    ),
]


pytestmark = pytest.mark.slow  # film gates: ~3 min of renders


@pytest.mark.parametrize("name,ref_file,cfg_kw", CASES)
def test_against_reference_film(name, ref_file, cfg_kw):
    path = os.path.join(REF_DIR, ref_file)
    if not os.path.exists(path):
        pytest.skip(f"reference film {ref_file} not present")
    ref = np.load(path)
    skybox = None
    if cfg_kw.get("has_skybox"):
        from rustic.scene.world import load_skybox_image

        skybox = load_skybox_image(scene_path(f"{name}Sky.npy"))
    scene = World.from_path(scene_path(f"{name}.glb")).to_device(skybox)
    cfg = TracingConfig(width=256, height=144, **cfg_kw)
    film = render_image(scene, cfg, RenderSettings(samples=12))

    # Energy must match tightly (MC noise averages out over the frame).
    rel_energy = abs(film.mean() - ref.mean()) / max(ref.mean(), 1e-9)
    assert rel_energy < 0.03, (name, film.mean(), ref.mean())

    # Per-pixel RMSE bounded by 12-spp noise.
    rmse = float(np.sqrt(np.mean((film - ref) ** 2)))
    assert rmse < 0.35 * max(ref.mean(), 0.05) + 0.05, (name, rmse)
