"""Image-quality comparison harness.

The BASELINE quality gate is per-pixel RMSE against a high-spp CPU
reference (BASELINE.md: RMSE < 1e-3 at 1024 spp). This module provides
the measurement tools: RMSE/MAE between films, engine-vs-engine
comparison on the same backend, and on-disk reference handling so a CPU
reference rendered once can gate later GPU runs
(`python -m rustic.cli compare ...`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from rustic.config import RenderSettings, TracingConfig


def rmse(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def mae(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def compare_engines(
    scene,
    config: TracingConfig,
    samples: int,
    engines: Optional[Tuple[str, ...]] = None,
) -> Dict[str, float]:
    """Pairwise RMSE between intersection engines on the current backend
    (default: every engine that runs there).

    With the shared deterministic sampler, engines must agree to float
    tolerance — any geometric disagreement shows up directly."""
    import jax

    from rustic.runtime.render import render_image

    if engines is None:
        engines = ("brute", "bvh") + (
            ("scan",) if jax.default_backend() == "gpu" else ()
        )
    settings = RenderSettings(samples=samples)
    films = {e: render_image(scene, config, settings, engine=e) for e in engines}
    out = {}
    names = list(engines)
    for i, a in enumerate(names):
        for b in names[i + 1 :]:
            out[f"{a}_vs_{b}"] = rmse(films[a], films[b])
    return out


def reference_compare(
    scene,
    config: TracingConfig,
    samples: int,
    reference_path: str,
    reference_samples: Optional[int] = None,
    save_if_missing: bool = True,
) -> Optional[Dict[str, float]]:
    """Render and compare against (or create) an on-disk reference film.

    Typical flow: run once on the CPU backend with high spp to create
    the reference .npy, then run on the GPU to measure RMSE against it."""
    from rustic.runtime.render import render_image

    film = render_image(
        scene, config, RenderSettings(samples=samples)
    )
    if not os.path.exists(reference_path):
        if save_if_missing:
            ref = render_image(
                scene,
                config,
                RenderSettings(samples=reference_samples or samples * 4),
            )
            # file object: np.save appends '.npy' to bare string paths,
            # which would break the np.load right below
            with open(reference_path, "wb") as f:
                np.save(f, ref)
        else:
            return None
    ref = np.load(reference_path)
    return {
        "rmse": rmse(film, ref),
        "mae": mae(film, ref),
        "mean": float(np.asarray(film).mean()),
        "ref_mean": float(ref.mean()),
    }


REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SCENES_DIR = os.path.join(REPO, "assets", "scenes")
REFERENCE_DIR = os.path.join(REPO, "assets", "reference")

# The committed ground-truth films (assets/reference/): (scene, skybox,
# film file, spp, TracingConfig overrides). NEE is MIS unless the
# overrides say nee="none"; the film size is parsed from the file name.
REFERENCE_FILMS = [
    ("DarkCornell.glb", None, "darkcornell_256x144_2048spp.npy", 2048, {}),
    ("FurnaceTest.glb", None, "furnacetest_256x144_1024spp.npy", 1024,
     dict(nee="none")),
    ("VeachMIS.glb", None, "veachmis_256x144_1024spp.npy", 1024,
     dict(cam_position=(5.0, 3.0, -10.0), cam_rotation=(0.25, 0.05))),
    ("GlassTest.glb", None, "glasstest_256x144_1024spp.npy", 1024,
     dict(cam_position=(0.0, 2.2, -6.5), cam_rotation=(0.15, 0.0))),
    ("BreakTime.glb", "BreakTimeSky.npy", "breaktime_256x144_1024spp.npy",
     1024, dict(cam_position=(0.0, 1.8, -3.2), has_skybox=True)),
]


def reference_film_case(case):
    """(scene, config, spp, film) of one REFERENCE_FILMS case."""
    from rustic.config import NextEventEstimation
    from rustic.scene.world import World, load_skybox_image

    name, sky, ref_file, spp, cfg_kw = case
    ref = np.load(os.path.join(REFERENCE_DIR, ref_file))
    kw = dict(cfg_kw)
    nee = (
        NextEventEstimation.NONE
        if kw.pop("nee", None) == "none"
        else NextEventEstimation.MIS
    )
    skybox = load_skybox_image(os.path.join(SCENES_DIR, sky)) if sky else None
    scene = World.from_path(os.path.join(SCENES_DIR, name)).to_device(skybox)
    w, h = (int(v) for v in ref_file.split("_")[1].split("x"))
    return scene, TracingConfig(width=w, height=h, nee=nee, **kw), spp, ref


def reference_film_rmse(case, engine: str = "auto") -> Dict[str, float]:
    """Re-render one REFERENCE_FILMS case at the film's own size and spp
    and compare. The sampler is a pure function of (pixel, sample), so
    the re-render integrates the same sample set and the RMSE measures
    engine divergence, not Monte-Carlo noise."""
    from rustic.runtime.render import render_image

    scene, config, spp, ref = reference_film_case(case)
    film = np.asarray(
        render_image(scene, config, RenderSettings(samples=spp), engine=engine)
    )
    d = film.astype(np.float64) - ref
    return {
        "rmse": float(np.sqrt(np.mean(d * d))),
        "max_abs_d": float(np.abs(d).max()),
        "rel_energy": float(abs(film.mean() - ref.mean()) / max(ref.mean(), 1e-9)),
        "size": f"{config.width}x{config.height}",
        "spp": spp,
    }


def furnace_probe(scene, nee, samples: int = 32, engine: str = "auto") -> np.ndarray:
    """The reference's furnace gate (tests/correctness_tests.rs:14-33):
    pixel (65, 75) of a 128x128 frame of FurnaceTest, gamma-decoded;
    every channel must be 0.8 +- 0.02."""
    from rustic.runtime.render import render_pixels

    config = TracingConfig(width=128, height=128, nee=nee)
    film = render_pixels(
        scene, config, np.array([65], np.int32), np.array([75], np.int32),
        samples, engine=engine,
    )
    return (np.asarray(film)[0] / samples) ** (1 / 2.2)


def _ambiguous_rays(scene, ro, rd, max_t) -> np.ndarray:
    """[n] bool: rays whose hit test is decided by float rounding, in
    float64 over every triangle: a candidate whose barycentric margin,
    determinant or t sits within a hair of a threshold of the test."""
    from rustic.ops.intersect import DET_EPS
    from rustic.ops.sampling import EPS

    tri = np.asarray(scene.positions, np.float64)[np.asarray(scene.tri_vidx)]
    a, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    ro = np.asarray(ro, np.float64)[:, None, :]
    rd = np.asarray(rd, np.float64)[:, None, :]
    max_t = np.asarray(max_t, np.float64)[:, None]
    pv = np.cross(rd, e2)
    det = np.sum(e1 * pv, axis=-1)
    inv = 1.0 / np.where(det == 0.0, 1.0, det)
    tv = ro - a
    qv = np.cross(tv, e1)
    u = np.sum(tv * pv, axis=-1) * inv
    v = np.sum(rd * qv, axis=-1) * inv
    t = np.sum(e2 * qv, axis=-1) * inv
    margin = np.minimum(np.minimum(u, v), 1.0 - u - v)
    in_range = (t > EPS - 1e-5) & (t <= max_t * (1 + 1e-5) + 1e-5)
    edge = (np.abs(margin) < 1e-4) & in_range
    thin = (np.abs(np.abs(det) - DET_EPS) < 0.1 * DET_EPS) & (margin > -1e-4) & in_range
    depth = ((np.abs(t - EPS) < 1e-5) | (np.abs(t - max_t) < 1e-5 * np.maximum(max_t, 1.0))) & (margin > -1e-4)
    return np.any(edge | thin | depth, axis=1)


def compare_scan_to_brute(scene, config: TracingConfig, seed: int = 0) -> Dict[str, float]:
    """The GPU scan engine against the brute-force oracle (f32 at
    HIGHEST precision) on one frame of camera rays (nearest hit) and one
    shadow ray from each primary hit to a random point of the scene's
    box (any hit). The two sum the same products in another order, so a
    ray whose hit test sits on a threshold may go either way: mismatches
    are counted, and those not explained by such a grazing candidate
    (`_ambiguous_rays`) are counted apart."""
    import jax.numpy as jnp

    from rustic.ops import intersect as I
    from rustic.ops.trace import camera_rays

    w, h = config.width, config.height
    y, x = np.mgrid[0:h, 0:w]
    px = jnp.asarray(x.reshape(-1), jnp.int32)
    py = jnp.asarray(y.reshape(-1), jnp.int32)
    offsets = jnp.zeros(w * h, jnp.uint32)
    ro, rd = camera_rays(
        config.static_part(), config.dynamic_part(), px, py, jnp.uint32(seed), offsets
    )
    scan = I.intersect_scan(scene, ro, rd)
    brute = I.intersect_brute(scene.tri_feats, ro, rd)
    hit = np.asarray(brute.hit)
    both = hit & np.asarray(scan.hit)
    t_s, t_b = np.asarray(scan.t), np.asarray(brute.t)
    tol = 1e-5 * np.maximum(t_b, 1.0)
    idx_diff = (np.asarray(scan.tri_idx) != np.asarray(brute.tri_idx)) & both
    t_bad = (np.abs(t_s - t_b) > tol) & both
    hit_mis = np.nonzero(np.asarray(scan.hit) != hit)[0]
    big = np.full(len(hit_mis), I.BIG)
    hit_unexplained = int((~_ambiguous_rays(
        scene, np.asarray(ro)[hit_mis], np.asarray(rd)[hit_mis], big)).sum()) if len(hit_mis) else 0

    pos = np.asarray(scene.positions)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    rng = np.random.default_rng(seed)
    target = jnp.asarray(lo + (hi - lo) * rng.uniform(size=(w * h, 3)), jnp.float32)
    origin = ro + rd * jnp.where(brute.hit, brute.t, 1.0)[:, None] * (1.0 - 1e-4)
    to = target - origin
    dist = jnp.linalg.norm(to, axis=-1)
    srd = to / jnp.maximum(dist, 1e-12)[:, None]
    occ_s = np.asarray(I.occlude_scan(scene, origin, srd, dist))
    occ_b = np.asarray(I.occlude_brute(scene.tri_feats, origin, srd, dist))
    occ_mis = np.nonzero(occ_s != occ_b)[0]
    occ_unexplained = int((~_ambiguous_rays(
        scene, np.asarray(origin)[occ_mis], np.asarray(srd)[occ_mis],
        np.asarray(dist)[occ_mis])).sum()) if len(occ_mis) else 0
    return {
        "rays": int(w * h),
        "hit_share": float(hit.mean()),
        "hit_mismatch": int(len(hit_mis)),
        "hit_mismatch_unexplained": hit_unexplained,
        "idx_diff_share": float(idx_diff.mean()),
        "idx_diff_untied": int((idx_diff & t_bad).sum()),
        "t_out_of_tol": int(t_bad.sum()),
        "max_t_rel_err": float(np.max(np.abs(t_s - t_b)[both] / np.maximum(t_b[both], 1.0))) if both.any() else 0.0,
        "occluded_share": float(occ_b.mean()),
        "occ_mismatch": int(len(occ_mis)),
        "occ_mismatch_unexplained": occ_unexplained,
    }
