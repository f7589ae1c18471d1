"""Brute force and the BVH render the same film on every shipped scene
under every NEE mode.

The sampler is a pure function of (pixel, sample), so both engines
integrate the same paths; any geometric disagreement shows up directly.
The scenes split over two files so the parallel test workers share them.
"""

import os

import numpy as np
import pytest

from rustic.config import NextEventEstimation, TracingConfig
from rustic.runtime.render import pixel_offsets, render_pixels
from rustic.scene.world import load_scene
from rustic.utils.compare import REFERENCE_FILMS, SCENES_DIR

# camera framings of the reference films; the rest use the default camera
CAMERAS = {case[0]: {k: v for k, v in case[4].items() if k != "nee"} for case in REFERENCE_FILMS}
SKIES = {"BreakTime.glb": "BreakTimeSky.npy"}
NEE_MODES = list(NextEventEstimation)
W, H = 12, 8


def check_agreement(name, nee):
    sky = SKIES.get(name)
    scene = load_scene(
        os.path.join(SCENES_DIR, name), os.path.join(SCENES_DIR, sky) if sky else None
    )
    config = TracingConfig(width=W, height=H, nee=nee, max_bounces=2, **CAMERAS.get(name, {}))
    y, x = np.mgrid[0:H, 0:W]
    px, py = x.reshape(-1).astype(np.int32), y.reshape(-1).astype(np.int32)
    offsets = pixel_offsets(W, H)
    films = {
        engine: np.asarray(render_pixels(scene, config, px, py, 1, offsets=offsets, engine=engine))
        for engine in ("brute", "bvh")
    }
    assert np.isfinite(films["brute"]).all() and films["brute"].max() > 0.0
    np.testing.assert_allclose(films["bvh"], films["brute"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("nee", NEE_MODES, ids=lambda n: n.name.lower())
@pytest.mark.parametrize("name", ["DarkCornell.glb", "VeachMIS.glb", "GlassTest.glb"])
def test_brute_and_bvh_agree(name, nee):
    check_agreement(name, nee)
