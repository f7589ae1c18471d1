"""shard_map data-parallel rendering over a jax.sharding.Mesh."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from rustic.config import RenderSettings, StaticConfig, TracingConfig
from rustic.ops.trace import accumulate_samples
from rustic.runtime.render import pixel_offsets


def make_mesh(
    devices=None, spp_parallel: Optional[int] = None
) -> Mesh:
    """Build a ('px', 'spp') mesh over the available devices.

    spp_parallel controls how many devices split the sample range
    (default: 2 when the device count is even, else 1); the rest split
    the pixel batch.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if spp_parallel is None:
        spp_parallel = 2 if n % 2 == 0 and n > 1 else 1
    assert n % spp_parallel == 0, (n, spp_parallel)
    arr = np.asarray(devices).reshape(n // spp_parallel, spp_parallel)
    return Mesh(arr, axis_names=("px", "spp"))


def sharded_step(
    mesh: Mesh,
    cfg: StaticConfig,
    n_samples: int,
    engine: str = "auto",
):
    """Compile one multi-chip render step.

    Returns fn(scene, cam, px, py, offsets, sample_start, film_in)
    -> film sums [B, 3], where B shards over 'px' and each 'spp' peer
    integrates n_samples/|spp| samples before the psum.
    """
    spp_size = mesh.shape["spp"]
    assert n_samples % spp_size == 0, (n_samples, spp_size)
    local_samples = n_samples // spp_size

    def step(scene, cam, px, py, offsets, sample_start, film_in):
        my_spp = jax.lax.axis_index("spp").astype(jnp.uint32)
        start = sample_start + my_spp * jnp.uint32(local_samples)
        film = accumulate_samples(
            scene,
            cfg,
            cam,
            px,
            py,
            offsets,
            start,
            local_samples,
            engine=engine,
            film_in=None,
        )
        film = jax.lax.psum(film, axis_name="spp")
        return film_in + film

    shard = P("px")
    mapped = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P(), shard, shard, shard, P(), shard),
        out_specs=shard,
        check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(6,))


@functools.lru_cache(maxsize=8)
def _compiled_sharded(mesh: Mesh, cfg: StaticConfig, n_samples: int, engine: str):
    # Mesh is hashable, so the lru_cache holds it directly — no
    # unbounded id->Mesh side table keeping evicted meshes alive.
    return sharded_step(mesh, cfg, n_samples, engine)


def assemble_film(film_local: np.ndarray) -> np.ndarray:
    """Multi-host film assembly over DCN.

    Each host renders a slice of the frame (tile-split of the film); the
    full frame is gathered across processes. The reference has no
    multi-node layer at all (SURVEY §2) — this is the multi-host analog
    of its single readback (src/trace.rs:198). Single-process runs return
    the input unchanged, so the call is safe everywhere."""
    if jax.process_count() == 1:
        return np.asarray(film_local)
    from jax.experimental import multihost_utils

    return np.asarray(
        multihost_utils.process_allgather(jnp.asarray(film_local))
    ).reshape(-1, *np.asarray(film_local).shape[1:])


def render_sharded(
    scene,
    config: TracingConfig,
    settings: Optional[RenderSettings] = None,
    mesh: Optional[Mesh] = None,
    engine: str = "auto",
) -> np.ndarray:
    """Full-frame multi-chip render; returns mean film [H, W, 3]."""
    settings = settings or RenderSettings()
    mesh = mesh or make_mesh()

    w, h = config.width, config.height
    n_px = w * h
    px_shards = mesh.shape["px"]
    pad = (-n_px) % px_shards

    y, x = np.mgrid[0:h, 0:w]
    px = np.pad(x.reshape(-1).astype(np.int32), (0, pad))
    py = np.pad(y.reshape(-1).astype(np.int32), (0, pad))
    offsets = np.pad(
        pixel_offsets(w, h, settings.use_blue_noise), (0, pad)
    )

    fn = _compiled_sharded(mesh, config.static_part(), settings.samples, engine)
    film = fn(
        scene,
        config.dynamic_part(),
        jnp.asarray(px),
        jnp.asarray(py),
        jnp.asarray(offsets),
        jnp.uint32(0),
        jnp.zeros((len(px), 3), jnp.float32),
    )
    # assemble_film gathers across processes on multi-host runs (a raw
    # np.asarray on a globally-sharded array would raise there); it is
    # the identity single-process.
    film = assemble_film(film)[:n_px] / max(settings.samples, 1)
    return film.reshape(h, w, 3)
