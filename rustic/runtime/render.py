"""Synchronous rendering driver.

The analog of the reference's trace loop + setup_trace harness
(reference: src/trace.rs:136-224, 331-344), minus threads: the
"dispatch N samples then sync" pattern is one jitted program with a
device-side fori_loop over samples (sync_rate analog), and readback
happens once per call.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from rustic.config import RenderSettings, StaticConfig, TracingConfig
from rustic.ops.intersect import resolve_engine
from rustic.ops.rng import pcg_hash_np
from rustic.ops.trace import accumulate_samples
from rustic.scene.world import SceneArrays


@functools.lru_cache(maxsize=1)
def _bluenoise_table() -> Optional[np.ndarray]:
    """The committed 128x128 void-and-cluster rank texture (u32 offsets;
    tools/make_bluenoise.py). None if the asset is missing."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets", "bluenoise_128.npy",
    )
    try:
        return np.load(path)
    except OSError:
        return None


def pixel_offsets(
    width: int, height: int, use_blue_noise: bool = True
) -> np.ndarray:
    """Per-pixel LDS decorrelation offsets ([H*W] u32).

    The reference seeds each pixel's Cranley-Patterson offset from a
    blue-noise texture or host RNG (src/trace.rs:149-160). Blue-noise
    mode tiles a committed 128x128 void-and-cluster rank table
    (tools/make_bluenoise.py — the analog of src/resources/bluenoise.png;
    ranks x 2^32, exactly the reference's value scaling), falling back
    to interleaved-gradient noise if the asset is absent; uniform mode
    hashes the pixel id.
    """
    y, x = np.mgrid[0:height, 0:width]
    if use_blue_noise:
        table = _bluenoise_table()
        if table is not None:
            n = table.shape[0]
            return table[y % n, x % n].reshape(-1).copy()
        ign = np.mod(
            52.9829189 * np.mod(0.06711056 * x + 0.00583715 * y, 1.0), 1.0
        )
        return (ign * 4294967295.0).astype(np.uint32).reshape(-1)
    return pcg_hash_np((y * width + x).astype(np.uint32).reshape(-1))


@functools.lru_cache(maxsize=32)
def _compiled_accumulate(cfg: StaticConfig, engine: str):
    """One compiled program per (static config, concrete engine); the sample count
    and start index are runtime values, so progressive rendering and any
    spp reuse the same executable."""

    def fn(scene, cam, px, py, offsets, sample_start, n_samples, film_in):
        return accumulate_samples(
            scene,
            cfg,
            cam,
            px,
            py,
            offsets,
            sample_start,
            n_samples,
            engine=engine,
            film_in=film_in,
        )

    return jax.jit(fn, donate_argnums=(7,))


def render_pixels(
    scene: SceneArrays,
    config: TracingConfig,
    px: np.ndarray,
    py: np.ndarray,
    samples: int,
    offsets: Optional[np.ndarray] = None,
    sample_start: int = 0,
    engine: str = "auto",
    film_in: Optional[jnp.ndarray] = None,
    backend: str = "auto",
) -> jnp.ndarray:
    """Render an arbitrary pixel set; returns the film *sum* [B, 3].

    Pixel subsets make cheap correctness probes possible (the furnace
    test checks one pixel — no need to render 128^2 on CI).

    backend="cpu" forces the host backend even on a GPU host (the
    reference's live GPU->CPU switch): inputs are committed to the CPU
    device, so the same jitted program compiles and runs there, and
    `auto` picks the engine a CPU host would. Pass a CPU-resident scene
    (jax.device_put(scene, cpu)) to avoid a transfer per call when
    stepping repeatedly.
    """
    cfg = config.static_part()
    cam = config.dynamic_part()
    if film_in is None:
        film_in = jnp.zeros((len(px), 3), jnp.float32)
    if offsets is None:
        offsets = pcg_hash_np(
            (py.astype(np.uint32) * np.uint32(config.width) + px.astype(np.uint32))
        )
    platform = jax.default_backend()
    if backend == "cpu" and platform != "cpu":
        cpu0 = jax.devices("cpu")[0]
        scene = jax.device_put(scene, cpu0)
        film_in = jax.device_put(film_in, cpu0)
        platform = "cpu"

    engine = resolve_engine(scene, engine, platform)
    fn = _compiled_accumulate(cfg, engine)
    return fn(
        scene,
        cam,
        jnp.asarray(px, jnp.int32),
        jnp.asarray(py, jnp.int32),
        jnp.asarray(offsets, jnp.uint32),
        jnp.uint32(sample_start),
        jnp.int32(samples),
        film_in,
    )


def render_image(
    scene: SceneArrays,
    config: TracingConfig,
    settings: Optional[RenderSettings] = None,
    engine: str = "auto",
) -> np.ndarray:
    """Render a full frame; returns the *mean* film [H, W, 3] float32.

    Pixels are processed in megabatches of settings.batch_pixels; each
    batch folds all samples device-side before the single readback.
    """
    settings = settings or RenderSettings()
    w, h = config.width, config.height
    offsets = pixel_offsets(w, h, settings.use_blue_noise)
    y, x = np.mgrid[0:h, 0:w]
    px = x.reshape(-1).astype(np.int32)
    py = y.reshape(-1).astype(np.int32)

    n_px = h * w
    chunk = min(int(settings.batch_pixels), n_px)
    # Pad to a whole number of chunks so every dispatch shares one
    # compiled shape.
    pad = (-n_px) % chunk
    if pad:
        px = np.pad(px, (0, pad))
        py = np.pad(py, (0, pad))
        offsets = np.pad(offsets, (0, pad))

    out = np.empty((n_px + pad, 3), np.float32)
    for lo in range(0, n_px + pad, chunk):
        hi = lo + chunk
        film = render_pixels(
            scene,
            config,
            px[lo:hi],
            py[lo:hi],
            settings.samples,
            offsets=offsets[lo:hi],
            engine=engine,
        )
        out[lo:hi] = np.asarray(film)
    return (out[:n_px] / max(settings.samples, 1)).reshape(h, w, 3)
