"""Smoke test of the path tracer on one GPU: the quickest proof that the
system starts and renders correctly on the card.

    python chip_smoke.py            # one GPU: phases (a)-(e)
    python chip_smoke.py --multi    # four GPUs: render_sharded vs one card

Phases, in one process that holds the card:
  (a) device check: JAX's default device must be a GPU;
  (b) the CLI at full width (DarkCornell 1280x720, MIS, ACES, PNG out),
      PBRTest 1280x720 through render_image (BVH), BreakTime 1280x720
      with its HDR sky and textures;
  (c) TracingState steps with a dirty reset and a checkpoint restore;
  (d) the furnace gate (NEE off and MIS) and film RMSE < 1e-3 against
      the five committed 256x144 reference films at their own spp;
  (e) the Triton scan against the brute-force oracle at 921,600 rays.
With --multi only: DarkCornell 1280x720 through render_sharded on a
('px', 'spp') mesh of four GPUs, against the same render on one.

Any failed phase exits non-zero. The last line of standard output is
one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1280, 720
RMSE_LIMIT = 1e-3
FURNACE_TOL = 0.02
# 4-card film vs 1-card film: the same samples summed in another order
# (a psum of per-card partial sums), so float32 rounding only.
MULTI_ATOL, MULTI_RTOL = 1e-4, 1e-4
# scan vs brute: rays whose hit test sits on a threshold may go either
# way under another summation order; at most this share of them
GRAZING_SHARE = 1e-5


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    return out


def scene_path(name):
    return os.path.join(REPO, "assets", "scenes", name)


def phase_cli(out_dir):
    import numpy as np

    from rustic.cli import main as cli_main
    from rustic.utils.png import decode_png

    png = os.path.join(out_dir, "darkcornell.png")
    npy = os.path.join(out_dir, "darkcornell.npy")
    stats = os.path.join(out_dir, "cli_stats.jsonl")
    t0 = time.time()
    rc = cli_main([
        "render", scene_path("DarkCornell.glb"), "--out", png,
        "--save-hdr", npy, "--spp", "8", "--size", f"{WIDTH}x{HEIGHT}",
        "--nee", "mis", "--tonemap", "aces_narkowicz", "--stats-json", stats,
    ])
    check(rc == 0, f"cli exit code {rc}")
    with open(png, "rb") as f:
        img = decode_png(f.read())
    check(img.shape == (HEIGHT, WIDTH, 3), f"png shape {img.shape}")
    film = np.load(npy)
    check(np.isfinite(film).all() and film.mean() > 0.0, "cli film not finite/lit")
    with open(stats) as f:
        line = json.loads(f.read().splitlines()[-1])
    log(f"(b) cli DarkCornell {WIDTH}x{HEIGHT} 8spp mis: engine={line['engine']} "
        f"film_mean={film.mean():.5f} wall={time.time() - t0:.1f}s (compile included)")


def _render(name, sky, spp, **cfg_kw):
    import numpy as np

    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.ops.intersect import resolve_engine
    from rustic.runtime.render import render_image
    from rustic.scene.world import load_scene

    scene = load_scene(scene_path(name), scene_path(sky) if sky else None)
    config = TracingConfig(
        width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS, **cfg_kw
    )
    t0 = time.time()
    film = render_image(scene, config, RenderSettings(samples=spp))
    check(film.shape == (HEIGHT, WIDTH, 3), f"{name} film shape {film.shape}")
    check(np.isfinite(film).all() and film.mean() > 0.0, f"{name} film not finite/lit")
    log(f"(b) {name} {WIDTH}x{HEIGHT} {spp}spp mis: engine="
        f"{resolve_engine(scene, 'auto')} tris={scene.n_tris} "
        f"film_mean={film.mean():.5f} wall={time.time() - t0:.1f}s (compile included)")


def phase_state(out_dir):
    import numpy as np

    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.runtime.state import Checkpoint, TracingState
    from rustic.scene.world import load_scene

    scene = load_scene(scene_path("DarkCornell.glb"))
    config = TracingConfig(width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS)
    state = TracingState(WIDTH, HEIGHT, config, RenderSettings(sync_rate=4))
    state.step(scene)
    state.step(scene)
    check(state.samples == 8, f"samples {state.samples}")
    state.set_config(cam_position=(0.0, 1.2, -5.0))  # dirty: reset next step
    frame = state.step(scene)
    check(state.samples == 4, f"dirty reset left samples={state.samples}")
    check(np.isfinite(frame).all() and frame.mean() > 0.0, "state frame not finite/lit")
    path = os.path.join(out_dir, "state.ckpt")
    Checkpoint.from_state(state).save(path)
    resumed = Checkpoint.load(path).into_state(RenderSettings(sync_rate=4))
    check(resumed.samples == 4, f"restored samples {resumed.samples}")
    np.testing.assert_array_equal(resumed.framebuffer, state.framebuffer)
    a = state.step(scene)
    b = resumed.step(scene)
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    log(f"(c) TracingState: 2 steps, dirty reset, checkpoint restore ok "
        f"(samples={resumed.samples}, mean={b.mean():.5f})")


def phase_correctness():
    from rustic.config import NextEventEstimation
    from rustic.scene.world import load_scene
    from rustic.utils.compare import (
        REFERENCE_FILMS,
        furnace_probe,
        reference_film_rmse,
    )

    furnace = load_scene(scene_path("FurnaceTest.glb"))
    for nee in (NextEventEstimation.NONE, NextEventEstimation.MIS):
        probe = furnace_probe(furnace, nee, 32)
        log(f"(d) furnace nee={nee.name.lower()} 32spp probe={probe.round(4).tolist()} "
            f"(gate 0.8 +- {FURNACE_TOL})")
        check(all(abs(p - 0.8) < FURNACE_TOL for p in probe), "furnace gate failed")
    for case in REFERENCE_FILMS:
        t0 = time.time()
        r = reference_film_rmse(case)
        log(f"(d) film {case[2]}: rmse={r['rmse']:.3e} max|d|={r['max_abs_d']:.3e} "
            f"rel_energy={r['rel_energy']:.2e} (gate rmse < {RMSE_LIMIT:g}) "
            f"wall={time.time() - t0:.1f}s")
        check(r["rmse"] < RMSE_LIMIT, f"{case[2]} rmse {r['rmse']}")


def phase_scan():
    from rustic.config import TracingConfig
    from rustic.scene.world import load_scene
    from rustic.utils.compare import compare_scan_to_brute

    log("(e) scan: f32 on CUDA cores vs brute f32 dot at HIGHEST; gates: "
        "hit masks and any-hit verdicts equal except grazing rays (a "
        "candidate within 1e-4 of a barycentric edge, or at a det/t "
        f"threshold) on at most {GRAZING_SHARE:g} of rays; t within "
        "1e-5*max(t,1) where both hit")
    for name, cam in (
        ("DarkCornell.glb", {}),
        ("VeachMIS.glb", dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))),
    ):
        scene = load_scene(scene_path(name))
        r = compare_scan_to_brute(scene, TracingConfig(width=WIDTH, height=HEIGHT, **cam))
        log(f"(e) scan {name}: {json.dumps(r)}")
        check(r["hit_mismatch_unexplained"] == 0, f"{name}: hit masks differ")
        check(r["occ_mismatch_unexplained"] == 0, f"{name}: any-hit verdicts differ")
        check(r["hit_mismatch"] + r["occ_mismatch"] <= GRAZING_SHARE * r["rays"],
              f"{name}: too many grazing mismatches")
        check(r["idx_diff_untied"] == 0 and r["t_out_of_tol"] == 0, f"{name}: t out of tolerance")


def phase_multi(n_cards):
    import jax
    import numpy as np

    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.parallel.shard import make_mesh, render_sharded
    from rustic.runtime.render import render_image
    from rustic.scene.world import load_scene

    check(len(jax.devices()) >= n_cards, f"--multi needs {n_cards} GPUs")
    scene = load_scene(scene_path("DarkCornell.glb"))
    config = TracingConfig(width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS)
    settings = RenderSettings(samples=8)
    mesh = make_mesh(jax.devices()[:n_cards], spp_parallel=2)
    t0 = time.time()
    multi = render_sharded(scene, config, settings, mesh=mesh)
    t_multi = time.time() - t0
    t0 = time.time()
    single = render_image(scene, config, settings)
    t_single = time.time() - t0
    d = np.abs(multi - single)
    log(f"(f) render_sharded mesh={dict(mesh.shape)} vs 1 card: max|d|={d.max():.3e} "
        f"mean={multi.mean():.5f} (tolerance atol {MULTI_ATOL:g} + rtol {MULTI_RTOL:g}); "
        f"first-call walls {t_multi:.1f}s / {t_single:.1f}s (compile included)")
    np.testing.assert_allclose(multi, single, rtol=MULTI_RTOL, atol=MULTI_ATOL)
    check(np.isfinite(multi).all() and multi.mean() > 0.0, "sharded film not finite/lit")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU render_sharded check")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}", file=sys.stderr)
        return 1
    log(card_info())  # name, power limit: one line per card, as nvidia-smi prints them
    log(f"(a) jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    sys.path.insert(0, REPO)

    t_start = time.time()
    if args.multi:
        phase_multi(4)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as out_dir:
            phase_cli(out_dir)
            _render("PBRTest.glb", None, 2)
            _render("BreakTime.glb", "BreakTimeSky.npy", 2,
                    cam_position=(0.0, 1.8, -3.2), has_skybox=True)
            phase_state(out_dir)
        phase_correctness()
        phase_scan()
    log(f"all phases passed in {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
