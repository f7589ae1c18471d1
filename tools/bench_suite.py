"""BASELINE config suite — the criterion-bench analog across all five
driver configs (BASELINE.md table; reference: benches/benchmark.rs:8-27
times startup and DarkCornell only).

Per config: scene build (startup) seconds, steady-state camera-path
throughput (Mpaths/s) and spp/s at the config's resolution, on a GPU
only (without one it exits non-zero). `--scale N` divides spp by N (the full spp counts
are hour-scale on one chip); resolution is kept so kernel shapes match
the real config.

Usage: python tools/bench_suite.py [--scale 16] [--configs 1,2,3]
Prints one JSON object per config plus a trailing summary line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

CONFIGS = {
    1: dict(scene="FurnaceTest.glb", size=(256, 256), spp=64, nee="off",
            skybox=None),
    2: dict(scene="DarkCornell.glb", size=(512, 512), spp=256, nee="mis",
            skybox=None),
    3: dict(scene="GlassTest.glb", size=(512, 512), spp=512, nee="mis",
            skybox=None),
    4: dict(scene="VeachMIS.glb", size=(1024, 1024), spp=1024, nee="mis",
            skybox=None),
    5: dict(scene="BreakTime.glb", size=(1920, 1080), spp=2048, nee="mis",
            skybox="BreakTimeSky.npy"),
}


def run_config(idx: int, spec: dict, scale: int) -> dict:
    import jax

    from rustic.config import (
        NextEventEstimation,
        RenderSettings,
        TracingConfig,
    )
    from rustic.runtime.render import render_image
    from rustic.scene.world import World, load_skybox_image

    scenes = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "scenes",
    )
    nee = {
        "off": NextEventEstimation.NONE,
        "mis": NextEventEstimation.MIS,
        "direct": NextEventEstimation.DIRECT,
    }[spec["nee"]]
    w, h = spec["size"]
    spp = max(1, spec["spp"] // max(scale, 1))

    t0 = time.time()
    world = World.from_path(os.path.join(scenes, spec["scene"]))
    skybox = (
        load_skybox_image(os.path.join(scenes, spec["skybox"]))
        if spec["skybox"]
        else None
    )
    scene = world.to_device(skybox)
    startup_s = time.time() - t0

    kwargs = dict(width=w, height=h, nee=nee)
    if spec["skybox"]:
        kwargs["has_skybox"] = True
    if spec["scene"] == "BreakTime.glb":
        kwargs["cam_position"] = (0.0, 1.8, -3.2)
    config = TracingConfig(**kwargs)

    # warm: the sample count is a traced value, so one sample compiles
    # the program the timed render runs
    t0 = time.time()
    np.asarray(render_image(scene, config, RenderSettings(samples=1)))
    warm_s = time.time() - t0

    t0 = time.time()
    film = render_image(scene, config, RenderSettings(samples=spp))
    wall = time.time() - t0  # render_image reads the film back: synced

    paths = w * h * spp
    return dict(
        config=idx,
        scene=spec["scene"],
        size=f"{w}x{h}",
        spp=spp,
        device_kind=jax.devices()[0].device_kind,
        startup_s=round(startup_s, 3),
        warmup_s=round(warm_s, 1),
        wall_s=round(wall, 2),
        mpaths_per_s=round(paths / wall / 1e6, 3),
        spp_per_s=round(spp / wall, 3),
        film_mean=round(float(np.asarray(film).mean()), 5),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=16,
                    help="divide each config's spp by this")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--out", default=None,
                    help="write the results as a JSON artifact (the "
                         "at-spec record the verdict asks to commit)")
    args = ap.parse_args()
    import jax

    if jax.devices()[0].platform != "gpu":
        print("bench_suite: needs a GPU", file=sys.stderr)
        return 1
    results = []
    for idx in (int(v) for v in args.configs.split(",")):
        try:
            r = run_config(idx, CONFIGS[idx], args.scale)
        except Exception as e:  # keep the suite going; report the failure
            r = dict(config=idx, scene=CONFIGS[idx]["scene"], error=str(e))
        print(json.dumps(r), flush=True)
        results.append(r)
        if args.out:  # persist after EVERY config: partial runs stay
            _write_out(args.out, results, args.scale)  # on the record
    ok = [r for r in results if "mpaths_per_s" in r]
    print(json.dumps({
        "summary": {r["scene"]: r["mpaths_per_s"] for r in ok},
        "scale": args.scale,
    }))


def _write_out(path, results, scale):
    import subprocess

    try:
        git = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except Exception:
        git = None
    with open(path, "w") as f:
        json.dump({
            "scale": scale,
            "measured_at": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "git": git,
            "configs": results,
        }, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
