"""Headline benchmark: DarkCornell 1280x720 @ 160 spp — the reference's
own perf-regression case (reference: benches/benchmark.rs:17, 2.408 s on
the author's GPU => ~61.2 M camera-paths/s).

Runs on a GPU only: without one it exits non-zero. Prints the card's
name and power limit, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mpaths/s", "vs_baseline": N, ...}

vs_baseline is steady-state camera-path throughput divided by the
reference GPU's 61.2 Mpaths/s. Secondary fields record wall/compile/
scene-build splits, the device, and the furnace correctness probe.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

WIDTH, HEIGHT, SPP = 1280, 720, 160
BASELINE_MPATHS = 61.2  # 1280*720*160 / 2.408s (benches/benchmark.rs:17)
REPO = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=SPP)
    args = ap.parse_args(argv)
    spp = args.spp

    t_start = time.time()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: needs a GPU, JAX found {devices[0].platform!r}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)

    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.ops.intersect import resolve_engine
    from rustic.runtime.render import render_image
    from rustic.scene.world import World
    from rustic.utils.compare import furnace_probe

    t0 = time.time()
    scene = World.from_path(os.path.join(REPO, "assets/scenes/DarkCornell.glb")).to_device()
    scene_build_s = time.time() - t0

    config = TracingConfig(width=WIDTH, height=HEIGHT, nee=NextEventEstimation.MIS)
    settings = RenderSettings(samples=spp)

    # Warm-up compiles the one program; the sample count is a traced
    # value, so one sample compiles what the timed renders run.
    t0 = time.time()
    render_image(scene, config, RenderSettings(samples=1))
    warmup_s = time.time() - t0

    # render_image reads the film back to the host, which waits for the
    # device; the median of three is quoted, the spread kept.
    render_times = []
    for _ in range(3):
        t0 = time.time()
        film = render_image(scene, config, settings)
        render_times.append(time.time() - t0)
    render_s = float(np.median(render_times))
    mpaths_per_s = WIDTH * HEIGHT * spp / render_s / 1e6

    furnace = World.from_path(os.path.join(REPO, "assets/scenes/FurnaceTest.glb")).to_device()
    probe = furnace_probe(furnace, NextEventEstimation.NONE, 32)

    result = {
        "metric": f"DarkCornell 1280x720x{spp}spp camera-path throughput",
        "value": round(mpaths_per_s, 2),
        "unit": "Mpaths/s",
        "vs_baseline": round(mpaths_per_s / BASELINE_MPATHS, 3),
        "render_s": round(render_s, 3),
        "render_s_all": [round(t, 3) for t in render_times],
        "compile_s": round(warmup_s, 2),
        "scene_build_s": round(scene_build_s, 2),
        "startup_s": round(scene_build_s + warmup_s, 2),
        "total_s": round(time.time() - t_start, 2),
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "card": card,
        "engine": resolve_engine(scene, "auto"),
        "spp_per_s": round(spp / render_s, 2),
        "furnace_ok": bool(np.all(np.abs(probe - 0.8) < 0.02)),
        "film_mean": round(float(film.mean()), 5),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
