"""Render at-spec-resolution ground-truth films with the BVH oracle.

Round-4 verdict weakness 7: the committed ground truths exist only at
256x144, while BASELINE.md's RMSE gate is defined at the config
resolutions (512^2 for configs 2-3, 1024^2 for config 4, 1920x1080 for
config 5). This renders those films with the independent oracle engine
(lockstep BVH traversal, ops/intersect.py) and saves them to
assets/reference/.

Methodology (same as the 256x144 films): the sampler is a pure
function of (pixel, sample), so a same-seed same-spp re-render with
the production engine integrates the IDENTICAL sample set — RMSE then
measures engine divergence, not Monte-Carlo noise. The spp below are
what a one-chip session affords at these resolutions (recorded in the
filename); quality_gate.py consumes whatever exists.

Usage: python tools/make_reference_films.py [--cases darkcornell,...]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "assets", "scenes")
REF = os.path.join(REPO, "assets", "reference")

# (scene, skybox, size, spp, config kwargs) — sizes are the BASELINE
# config resolutions; spp chosen to keep each oracle render ~minutes.
CASES = [
    ("DarkCornell.glb", None, (512, 512), 256, {}),
    ("GlassTest.glb", None, (512, 512), 256,
     dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0))),
    ("VeachMIS.glb", None, (1024, 1024), 128,
     dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))),
    ("BreakTime.glb", "BreakTimeSky.npy", (1920, 1080), 64,
     dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)),
]


def render_oracle_chunked(scene, config, spp, engine="bvh",
                          spp_chunk=8, px_chunk=1 << 17):
    """Oracle render in SHORT dispatches: the lockstep-BVH while_loop at
    full spp in one program is minutes of device time in a single
    dispatch. Chunk the sample range (and the pixel set) so each
    dispatch stays seconds, syncing every chunk. Returns the mean film
    [H, W, 3]."""
    import jax.numpy as jnp

    from rustic.runtime.render import pixel_offsets, render_pixels

    w, h = config.width, config.height
    y, x = np.mgrid[0:h, 0:w]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)
    # HASH offsets (RenderSettings.use_blue_noise default) — the gate's
    # re-render must integrate the IDENTICAL sample set; pixel_offsets'
    # own default is blue noise, which silently breaks the same-seed
    # methodology (cost one wasted 1024-spp comparison this round).
    offsets = pixel_offsets(w, h, use_blue_noise=False)
    n_px = w * h
    chunk = min(px_chunk, n_px)
    pad = (-n_px) % chunk
    if pad:
        px, py = np.pad(px, (0, pad)), np.pad(py, (0, pad))
        offsets = np.pad(offsets, (0, pad))
    out = np.empty((n_px + pad, 3), np.float32)
    for lo in range(0, n_px + pad, chunk):
        hi = lo + chunk
        film = jnp.zeros((chunk, 3), jnp.float32)
        for s0 in range(0, spp, spp_chunk):
            film = render_pixels(
                scene, config, px[lo:hi], py[lo:hi],
                min(spp_chunk, spp - s0), offsets=offsets[lo:hi],
                sample_start=s0, engine=engine, film_in=film,
            )
            np.asarray(film[:1])  # hard sync: keep dispatches short
        out[lo:hi] = np.asarray(film)
    return (out[:n_px] / max(spp, 1)).reshape(h, w, 3)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default="all")
    ap.add_argument("--engine", default="bvh",
                    help="oracle engine (bvh = lockstep traversal)")
    ap.add_argument("--spp-chunk", type=int, default=8)
    args = ap.parse_args()

    from rustic.config import (
        NextEventEstimation,
        TracingConfig,
    )
    from rustic.scene.world import World, load_skybox_image

    cases = CASES
    if args.cases != "all":
        keep = set(args.cases.lower().split(","))
        cases = [c for c in cases if c[0].lower().split(".")[0] in keep]

    for name, sky, (w, h), spp, cfg_kw in cases:
        stem = f"{name.split('.')[0].lower()}_{w}x{h}_{spp}spp"
        out = os.path.join(REF, stem + ".npy")
        if os.path.exists(out):
            print(json.dumps({"film": stem, "skipped": "exists"}), flush=True)
            continue
        skybox = (
            load_skybox_image(os.path.join(SCENES, sky)) if sky else None
        )
        scene = World.from_path(os.path.join(SCENES, name)).to_device(skybox)
        config = TracingConfig(
            width=w, height=h, nee=NextEventEstimation.MIS, **cfg_kw
        )
        t0 = time.time()
        film = render_oracle_chunked(
            scene, config, spp, engine=args.engine,
            spp_chunk=args.spp_chunk,
        )
        wall = time.time() - t0
        assert np.isfinite(film).all(), f"{stem}: non-finite radiance"
        np.save(out, film.astype(np.float32))
        print(json.dumps({
            "film": stem, "engine": args.engine, "wall_s": round(wall, 1),
            "mean": round(float(film.mean()), 5),
            "mpaths_per_s": round(w * h * spp / wall / 1e6, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
