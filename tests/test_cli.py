"""End-to-end CLI coverage: render + info through the real entry point."""

import os

import numpy as np
import pytest

from rustic.cli import main
from tests.conftest import scene_path


def test_cli_render_png_and_hdr(tmp_path, capsys):
    out_png = os.path.join(tmp_path, "out.png")
    out_npy = os.path.join(tmp_path, "out.npy")
    rc = main(
        [
            "render",
            scene_path("DarkCornell.glb"),
            "--out",
            out_png,
            "--save-hdr",
            out_npy,
            "--spp",
            "2",
            "--size",
            "24x16",
            "--nee",
            "mis",
            "--tonemap",
            "aces_narkowicz",
            "--bounces",
            "2",
        ]
    )
    assert rc == 0
    assert os.path.exists(out_png)
    film = np.load(out_npy)
    assert film.shape == (16, 24, 3)
    assert np.isfinite(film).all()

    from rustic.utils.png import decode_png

    with open(out_png, "rb") as f:
        img = decode_png(f.read())
    assert img.shape == (16, 24, 3)


def test_cli_progressive_with_checkpoint(tmp_path):
    out_png = os.path.join(tmp_path, "prog.png")
    ckpt = os.path.join(tmp_path, "prog.npz")
    args = [
        "render",
        scene_path("DarkCornell.glb"),
        "--out",
        out_png,
        "--spp",
        "2",
        "--size",
        "16x16",
        "--bounces",
        "2",
        "--sync-rate",
        "1",
        "--progressive",
        "--checkpoint",
        ckpt,
    ]
    assert main(args) == 0
    assert os.path.exists(ckpt)
    # resume adds more samples on top of the checkpoint
    args[args.index("--spp") + 1] = "4"
    assert main(args) == 0


def test_cli_info(capsys):
    assert main(["info", scene_path("VeachMIS.glb")]) == 0
    out = capsys.readouterr().out
    assert "triangles:  2932" in out
    assert "lights:     2880" in out


def test_cli_camera_and_sun_flags(tmp_path):
    out_png = os.path.join(tmp_path, "cam.png")
    rc = main(
        [
            "render",
            scene_path("FurnaceTest.glb"),
            "--out",
            out_png,
            "--spp",
            "1",
            "--size",
            "8x8",
            "--bounces",
            "1",
            "--camera-pos",
            "0,0,-3",
            "--camera-rot",
            "0.1,0.2",
            "--sun",
            "1,2,0.5",
            "--sun-intensity",
            "10",
            "--specular-clamp",
            "0.2,0.8",
            "--engine",
            "brute",
        ]
    )
    assert rc == 0
    assert os.path.exists(out_png)


def test_engine_flag_choices():
    """The engine choices are auto and the three engines; the names of
    removed kernels and flags are rejected by the parser."""
    from rustic.cli import build_parser

    parser = build_parser()
    for engine in ("auto", "brute", "bvh", "scan"):
        assert parser.parse_args(["render", "x.glb", "--engine", engine]).engine == engine
    with pytest.raises(SystemExit):
        parser.parse_args(["render", "x.glb", "--engine", "flash"])
    with pytest.raises(SystemExit):
        parser.parse_args(["render", "x.glb", "--dot", "f32"])


def test_cli_scan_engine_needs_gpu(tmp_path):
    """--engine scan on a CPU host fails with a message instead of
    falling back to an interpreted kernel."""
    with pytest.raises(ValueError, match="needs a GPU"):
        main(
            [
                "render", scene_path("DarkCornell.glb"),
                "--out", os.path.join(tmp_path, "s.png"), "--spp", "1",
                "--size", "8x8", "--bounces", "1", "--engine", "scan",
            ]
        )


def test_cli_checkpoint_without_npz_suffix(tmp_path):
    """Checkpoint paths without '.npz' must resume (np.savez used to
    append the suffix, so the resume existence check never fired)."""
    ckpt = os.path.join(tmp_path, "ckpt")  # no extension

    def args(spp):
        return [
            "render", scene_path("DarkCornell.glb"),
            "--out", os.path.join(tmp_path, "c.png"),
            "--spp", str(spp), "--size", "8x8", "--bounces", "1",
            "--checkpoint", ckpt,
        ]

    assert main(args(2)) == 0
    assert os.path.exists(ckpt)

    from rustic.runtime.state import Checkpoint

    assert Checkpoint.load(ckpt).samples == 2
    # resume continues toward the (raised) total target
    assert main(args(4)) == 0
    assert Checkpoint.load(ckpt).samples == 4


def test_cli_zero_sun_rejected():
    with pytest.raises(SystemExit):
        main(
            [
                "render", scene_path("DarkCornell.glb"),
                "--spp", "1", "--size", "8x8", "--sun", "0,0,0",
            ]
        )


def test_cli_stats_json_line(tmp_path):
    """--stats-json writes one parseable observability record per render
    (SURVEY §5 metrics/logging: throughput + wall splits, machine-readable)."""
    import json

    out_png = os.path.join(tmp_path, "out.png")
    stats = os.path.join(tmp_path, "stats.jsonl")
    rc = main(
        [
            "render",
            scene_path("DarkCornell.glb"),
            "--out", out_png,
            "--spp", "2",
            "--size", "24x16",
            "--stats-json", stats,
        ]
    )
    assert rc == 0
    lines = [json.loads(l) for l in open(stats)]
    assert len(lines) == 1
    rec = lines[0]
    assert rec["scene"] == "DarkCornell.glb"
    assert rec["mpaths_per_s"] > 0
    assert rec["spp_per_s"] > 0
    assert rec["render_s"] > 0
    assert np.isfinite(rec["film_mean"])
