import json
import os

import numpy as np
import pytest

from rustic.cli import main
from rustic.config import NextEventEstimation, TracingConfig
from rustic.utils.compare import (
    REFERENCE_FILMS,
    compare_engines,
    reference_compare,
    reference_film_case,
    rmse,
)
from tests.conftest import scene_path


def test_rmse_basics():
    a = np.zeros((4, 4, 3))
    assert rmse(a, a) == 0.0
    b = a + 0.1
    assert abs(rmse(a, b) - 0.1) < 1e-12


def test_engines_rmse_near_zero(cornell_scene):
    cfg = TracingConfig(width=24, height=16, nee=NextEventEstimation.MIS, max_bounces=2)
    out = compare_engines(cornell_scene, cfg, samples=2)
    for pair, value in out.items():
        assert value < 1e-4, (pair, value)


def test_reference_compare_roundtrip(cornell_scene, tmp_path):
    cfg = TracingConfig(width=16, height=16, max_bounces=2)
    ref = os.path.join(tmp_path, "ref.npy")
    out = reference_compare(
        cornell_scene, cfg, samples=4, reference_path=ref, reference_samples=8
    )
    assert os.path.exists(ref)
    assert out["rmse"] >= 0.0
    # same spp as reference -> identical sampler prefix differences only
    out2 = reference_compare(cornell_scene, cfg, samples=8, reference_path=ref)
    assert out2["rmse"] < 1e-6


@pytest.mark.parametrize("case", REFERENCE_FILMS, ids=lambda c: c[2].split("_")[0])
def test_reference_film_pixels_match_this_code(case):
    """A few pixels of each committed film, re-rendered here at the
    film's own spp with the sample set render_image gives them, agree
    to float divergence (the chip gate's RMSE < 1e-3), far below the
    Monte-Carlo scale: the films were made by this integrator."""
    from rustic.config import RenderSettings
    from rustic.runtime.render import pixel_offsets, render_pixels

    scene, config, spp, ref = reference_film_case(case)
    w, h = config.width, config.height
    idx = np.random.default_rng(0).choice(w * h, 16, replace=False)
    px, py = (idx % w).astype(np.int32), (idx // w).astype(np.int32)
    offsets = pixel_offsets(w, h, RenderSettings().use_blue_noise)[idx]
    film = np.asarray(render_pixels(scene, config, px, py, spp, offsets=offsets)) / spp
    assert rmse(film, ref.reshape(-1, 3)[idx]) < 1e-3


@pytest.mark.slow  # CLI end-to-end render
def test_cli_compare(tmp_path, capsys):
    rc = main(
        [
            "compare",
            scene_path("DarkCornell.glb"),
            "--spp",
            "2",
            "--size",
            "16x16",
        ]
    )
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert "engines" in out
    assert all(v < 1e-4 for v in out["engines"].values())
