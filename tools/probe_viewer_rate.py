"""Measure the interactive loop on hardware (round-4 verdict item 8).

Drives the viewer's step path — TracingState.step(), the exact call
Viewer.step()/run() makes per animation tick — headless at the
reference's interactive configuration (1280x720, DarkCornell, MIS) for
~30 s, and reports sustained samples/s plus per-publish latency.

Reference for comparison: the author's GPU sustains ~66 spp/s at this
config with a publish every sync_rate samples
(/root/reference/benches/benchmark.rs:17, src/app.rs:518-533).

Each step() call renders sync_rate samples and publishes (readback +
mean + framebuffer swap) — exactly the reference loop's
enqueue-N-then-read protocol (src/trace.rs:177-213).

Usage: python tools/probe_viewer_rate.py [--seconds 30] [--sync-rate 8]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--size", default="1280x720")
    ap.add_argument("--scene", default="DarkCornell.glb")
    ap.add_argument("--sync-rate", type=int, default=8)
    args = ap.parse_args()

    import jax

    from rustic.config import (
        NextEventEstimation,
        RenderSettings,
        TracingConfig,
    )
    from rustic.runtime.state import TracingState
    from rustic.scene.world import World

    w, h = (int(v) for v in args.size.split("x"))
    scenes = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "assets", "scenes",
    )
    t0 = time.time()
    scene = World.from_path(os.path.join(scenes, args.scene)).to_device()
    state = TracingState(
        w, h,
        config=TracingConfig(nee=NextEventEstimation.MIS),
        settings=RenderSettings(sync_rate=args.sync_rate),
    )
    startup_s = time.time() - t0

    # Warm: first step pays compiles; excluded from the sustained rate
    # (the reference ships precompiled SPIR-V).
    t0 = time.time()
    state.step(scene)
    warm_s = time.time() - t0

    steps = 0
    lat = []
    t_start = time.time()
    while time.time() - t_start < args.seconds:
        t0 = time.perf_counter()
        frame = state.step(scene)
        lat.append(time.perf_counter() - t0)
        steps += 1
    wall = time.time() - t_start
    spp = steps * args.sync_rate
    assert np.isfinite(frame).all()

    print(json.dumps({
        "probe": "viewer_rate", "scene": args.scene, "size": args.size,
        "backend": jax.default_backend(), "sync_rate": args.sync_rate,
        "startup_s": round(startup_s, 2), "first_step_s": round(warm_s, 1),
        "steps": steps, "wall_s": round(wall, 1),
        "spp_per_s": round(spp / wall, 2),
        "publish_latency_ms": {
            "median": round(float(np.median(lat)) * 1e3, 1),
            "p90": round(float(np.percentile(lat, 90)) * 1e3, 1),
            "max": round(float(np.max(lat)) * 1e3, 1),
        },
        "samples_accumulated": state.samples,
        "ref_spp_per_s": 66.4,  # benchmark.rs:17: 160 spp / 2.408 s
    }), flush=True)


if __name__ == "__main__":
    main()
