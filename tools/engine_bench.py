"""Intersection-engine measurements on the GPU: the data behind the
engine choice (ops/intersect.py `pick_engine`) and the scan's block
sizes (ops/scan.py).

    python tools/engine_bench.py kernels  # per-call times, 921,600 rays
    python tools/engine_bench.py blocks   # scan block-size sweep
    python tools/engine_bench.py render   # 1280x720 renders per engine
    python tools/engine_bench.py crossover  # renders of scenes re-cut to
                                            # 14,336 and 18,432 triangles
    python tools/engine_bench.py trace    # profiler trace of one render
    python tools/engine_bench.py compile  # cold and warm first frame

Each prints JSON lines; times are medians of repeated calls after a
warm-up call, synced with block_until_ready. Needs a GPU.
"""

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 1280, 720
# scene -> camera overrides (the framings of the reference films)
SCENES = {
    "DarkCornell.glb": {},
    "VeachMIS.glb": dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05)),
    "GlassTest.glb": dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0)),
    "FurnaceTest.glb": {},
    "PBRTest.glb": {},
    "BreakTime.glb": dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True),
}
SKIES = {"BreakTime.glb": "BreakTimeSky.npy"}


def _scene(name):
    from rustic.scene.world import load_scene

    sky = SKIES.get(name)
    return load_scene(
        os.path.join(REPO, "assets", "scenes", name),
        os.path.join(REPO, "assets", "scenes", sky) if sky else None,
    )


def emit(**kw):
    print(json.dumps(kw), flush=True)


def _time(fn, *args, reps=5):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times)), times


def _rays(scene, cam):
    """One frame of camera rays, and one shadow ray per primary hit
    toward a random point of the scene's box."""
    import jax.numpy as jnp

    from rustic.config import TracingConfig
    from rustic.ops import intersect as I
    from rustic.ops.trace import camera_rays

    config = TracingConfig(width=W, height=H, **cam)
    y, x = np.mgrid[0:H, 0:W]
    ro, rd = camera_rays(
        config.static_part(), config.dynamic_part(),
        jnp.asarray(x.reshape(-1), jnp.int32), jnp.asarray(y.reshape(-1), jnp.int32),
        jnp.uint32(0), jnp.zeros(W * H, jnp.uint32),
    )
    res = I.intersect_bvh(scene, ro, rd)
    pos = np.asarray(scene.positions)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    target = jnp.asarray(
        lo + (hi - lo) * np.random.default_rng(0).uniform(size=(W * H, 3)), jnp.float32
    )
    origin = ro + rd * jnp.where(res.hit, res.t, 1.0)[:, None] * (1.0 - 1e-4)
    to = target - origin
    dist = jnp.linalg.norm(to, axis=-1)
    return ro, rd, origin, to / jnp.maximum(dist, 1e-12)[:, None], dist


def cmd_kernels(engines):
    import jax

    from rustic.ops import intersect as I
    for name, cam in SCENES.items():
        scene = _scene(name)
        ro, rd, sro, srd, smax = _rays(scene, cam)
        for engine in engines:
            near = jax.jit(lambda s, o, d, e=engine: I.intersect_nearest(s, o, d, e))
            anyh = jax.jit(lambda s, o, d, m, e=engine: I.intersect_any(s, o, d, m, e))
            c1, t1, _ = _time(near, scene, ro, rd)
            c2, t2, _ = _time(anyh, scene, sro, srd, smax)
            emit(phase="kernels", scene=name, tris=scene.n_tris, engine=engine,
                 rays=W * H, nearest_ms=t1 * 1e3, any_ms=t2 * 1e3,
                 first_call_s=[c1, c2])


def cmd_blocks(variants):
    import jax

    from rustic.ops import intersect as I
    from rustic.ops import scan as S
    for name in ("DarkCornell.glb", "VeachMIS.glb"):
        scene = _scene(name)
        ro, rd, sro, srd, smax = _rays(scene, SCENES[name])
        for rb, tt, nw, ns in variants:
            S.RAY_BLOCK, S.TRI_TILE, S.NUM_WARPS, S.NUM_STAGES = rb, tt, nw, ns
            near = jax.jit(lambda s, o, d: I.intersect_scan(s, o, d))
            anyh = jax.jit(lambda s, o, d, m: I.occlude_scan(s, o, d, m))
            try:
                _, t1, _ = _time(near, scene, ro, rd)
                _, t2, _ = _time(anyh, scene, sro, srd, smax)
                emit(phase="blocks", scene=name, ray_block=rb, tri_tile=tt,
                     num_warps=nw, num_stages=ns, nearest_ms=t1 * 1e3, any_ms=t2 * 1e3)
            except Exception as e:  # a variant the compiler refuses
                emit(phase="blocks", scene=name, ray_block=rb, tri_tile=tt,
                     num_warps=nw, num_stages=ns, error=f"{type(e).__name__}: {str(e)[:300]}")


def _render_rows(name, scene, engines, spp, phase="render"):
    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.runtime.render import render_image

    config = TracingConfig(width=W, height=H, nee=NextEventEstimation.MIS, **SCENES[name])
    for engine in engines:
        t0 = time.perf_counter()
        render_image(scene, config, RenderSettings(samples=1), engine=engine)
        compile_s = time.perf_counter() - t0
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            film = render_image(scene, config, RenderSettings(samples=spp), engine=engine)
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        emit(phase=phase, scene=name, tris=scene.n_tris, engine=engine,
             spp=spp, walls_s=walls, mpaths_per_s=W * H * spp / wall / 1e6,
             first_call_1spp_s=compile_s, film_mean=float(film.mean()))


def cmd_render(engines, spp, scenes):
    for name in scenes:
        _render_rows(name, _scene(name), engines, spp)


def split_triangles(gltf, n_tris):
    """The same surfaces cut into `n_tris` triangles: the largest are
    halved at the midpoint of their longest edge, winding kept, vertex
    attributes interpolated (normals and tangents renormalised)."""
    import dataclasses

    pos, nrm, tan, uv = gltf.positions, gltf.normals, gltf.tangents, gltf.uv0
    tris = gltf.triangles
    while len(tris) < n_tris:
        v = pos[tris[:, :3]]
        area = np.linalg.norm(np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=-1)
        k = min(n_tris - len(tris), len(tris))
        pick = np.argsort(-area, kind="stable")[:k]
        edge = np.stack(
            [np.linalg.norm(v[pick, (i + 1) % 3] - v[pick, i], axis=-1) for i in range(3)], 1
        ).argmax(1)
        rows, t = np.arange(k), tris[pick]
        a, b, c = t[rows, edge], t[rows, (edge + 1) % 3], t[rows, (edge + 2) % 3]
        m = len(pos) + rows

        def mid(x, unit=False):
            y = (x[a] + x[b]) * 0.5
            if unit:
                y = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-12)
            return np.concatenate([x, y.astype(x.dtype)])

        pos, nrm, tan, uv = mid(pos), mid(nrm, True), mid(tan, True), mid(uv)
        keep = np.ones(len(tris), bool)
        keep[pick] = False
        halves = [np.stack([a, m, c, t[:, 3]], 1), np.stack([m, b, c, t[:, 3]], 1)]
        tris = np.concatenate([tris[keep]] + [h.astype(tris.dtype) for h in halves])
    return dataclasses.replace(
        gltf, positions=pos, normals=nrm, tangents=tan, uv0=uv, triangles=tris
    )


def cmd_crossover(engines, spp):
    """Both engines around the crossover (`SCAN_MAX_TRIS`): shipped
    scenes re-cut to more triangles, the rendered image unchanged."""
    from rustic.scene.gltf import load_glb
    from rustic.scene.world import World, load_skybox_image

    for name, counts in (
        ("FurnaceTest.glb", (None, 14336, 18432)),
        ("BreakTime.glb", (None, 14336, 18432)),
        ("PBRTest.glb", (None,)),
    ):
        gltf = load_glb(os.path.join(REPO, "assets", "scenes", name))
        sky = SKIES.get(name)
        sky = load_skybox_image(os.path.join(REPO, "assets", "scenes", sky)) if sky else None
        for n in counts:
            scene = World(split_triangles(gltf, n) if n else gltf).to_device(sky)
            _render_rows(name, scene, engines, spp, phase="crossover")


def _first_frame(name, engine, breakdown):
    """One process's first 1-spp frame; with `breakdown`, then the same
    program traced, lowered and compiled again with the persistent cache
    off, and its Triton kernels counted."""
    import jax
    import jax.numpy as jnp

    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.runtime import render as R

    t0 = time.perf_counter()
    scene = _scene(name)
    load_s = time.perf_counter() - t0
    config = TracingConfig(width=W, height=H, nee=NextEventEstimation.MIS, **SCENES[name])
    t0 = time.perf_counter()
    R.render_image(scene, config, RenderSettings(samples=1), engine=engine)
    row = dict(phase="compile", cache="cold" if breakdown else "warm", scene=name,
               tris=scene.n_tris, engine=engine, scene_load_s=load_s, first_frame_s=time.perf_counter() - t0)
    if breakdown:
        jax.config.update("jax_enable_compilation_cache", False)
        n = min(RenderSettings().batch_pixels, W * H)
        fn = R._compiled_accumulate.__wrapped__(config.static_part(), engine)
        args = (scene, config.dynamic_part(), jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.int32),
                jnp.zeros(n, jnp.uint32), jnp.uint32(0), jnp.int32(1),
                jnp.zeros((n, 3), jnp.float32))
        t0 = time.perf_counter()
        lowered = fn.lower(*args)
        row["trace_lower_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lowered.compile()
        row["compile_s"] = time.perf_counter() - t0
        row["triton_kernels"] = lowered.as_text().count("__gpu$xla.gpu.triton")
    emit(**row)


def cmd_compile(engines, scenes):
    """Time to first frame per engine, each in a fresh process: cold
    (empty compile cache), then warm (the cache the cold run filled).
    This process never touches the GPU, so each child gets it whole."""
    for name in scenes:
        for engine in engines:
            with tempfile.TemporaryDirectory(prefix="engine_bench_cache_") as cache:
                env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": cache}
                for state in ("cold", "warm"):
                    subprocess.run(
                        [sys.executable, os.path.abspath(__file__), "_first_frame",
                         "--scenes", name, "--engines", engine]
                        + (["--breakdown"] if state == "cold" else []),
                        env=env, check=True, timeout=600,
                    )


def reduce_trace(path):
    """Device busy/idle share and the largest device events of a
    profiler trace (an .xplane.pb written by jax.profiler.trace)."""
    from jax.profiler import ProfileData

    prof = ProfileData.from_file(path)
    out = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = {line.name: list(line.events) for line in plane.lines}
        streams = [n for n in lines if "stream" in n.lower()] or list(lines)
        spans, by_name = [], {}
        for name in streams:
            for ev in lines[name]:
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                tot, cnt = by_name.get(ev.name, (0.0, 0))
                by_name[ev.name] = (tot + ev.duration_ns, cnt + 1)
        if not spans:
            out[plane.name] = {"lines": {n: len(e) for n, e in lines.items()}}
            continue
        spans.sort()
        busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
        out[plane.name] = {
            "lines": {n: len(e) for n, e in lines.items()},
            "window_ms": window / 1e6,
            "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / max(window, 1.0),
            "events": len(spans),
            "memcpy_events": sum(c for n, (_, c) in by_name.items() if "emcpy" in n),
            "top": [(n[:120], t / 1e6, c) for n, (t, c) in top],
        }
    return out


def cmd_trace(engines, out_dir, spp):
    import jax

    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.runtime.render import render_image
    scene = _scene("DarkCornell.glb")
    config = TracingConfig(width=W, height=H, nee=NextEventEstimation.MIS)
    for engine in engines:
        render_image(scene, config, RenderSettings(samples=1), engine=engine)
        d = os.path.join(out_dir, f"trace_{engine}")
        t0 = time.perf_counter()
        with jax.profiler.trace(d):
            render_image(scene, config, RenderSettings(samples=spp), engine=engine)
        wall = time.perf_counter() - t0
        path = sorted(glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True))[-1]
        emit(phase="trace", engine=engine, spp=spp, wall_s=wall, devices=reduce_trace(path))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cmd", choices=[
        "kernels", "blocks", "render", "crossover", "trace", "compile", "_first_frame",
    ])
    ap.add_argument("--engines", default="scan,brute,bvh")
    ap.add_argument("--scenes", default=",".join(SCENES))
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--breakdown", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cmd == "compile":
        cmd_compile(args.engines.split(","), args.scenes.split(","))
        return 0

    import jax

    if jax.devices()[0].platform != "gpu":
        print("engine_bench: needs a GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    emit(card=card, device_kind=jax.devices()[0].device_kind)
    engines = args.engines.split(",")
    if args.cmd == "kernels":
        cmd_kernels(engines)
    elif args.cmd == "blocks":
        cmd_blocks([
            (64, 16, 4, 2), (64, 8, 4, 2), (64, 4, 4, 2), (64, 2, 4, 2),
            (64, 1, 4, 2), (128, 1, 4, 2), (128, 4, 4, 2), (256, 1, 8, 2),
            (128, 8, 4, 2), (32, 8, 4, 2), (128, 2, 4, 2), (256, 2, 8, 2),
        ])
    elif args.cmd == "render":
        cmd_render(engines, args.spp, args.scenes.split(","))
    elif args.cmd == "crossover":
        cmd_crossover(engines, args.spp)
    elif args.cmd == "_first_frame":
        _first_frame(args.scenes, args.engines, args.breakdown)
    else:
        with tempfile.TemporaryDirectory(prefix="engine_bench_") as out_dir:
            cmd_trace(engines, out_dir, args.spp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
