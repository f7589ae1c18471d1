"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
from rustic.parallel.shard import make_mesh, render_sharded, sharded_step


@pytest.fixture(scope="module")
def cfg():
    return TracingConfig(
        width=16, height=16, max_bounces=2, nee=NextEventEstimation.MIS
    )


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["px"] * mesh.shape["spp"] == 8
    mesh1 = make_mesh(spp_parallel=1)
    assert mesh1.shape["spp"] == 1
    mesh4 = make_mesh(spp_parallel=4)
    assert mesh4.shape == {"px": 2, "spp": 4}


def test_sharded_matches_single_device(cornell_scene, cfg):
    """The mesh-parallel render must equal the single-device render
    bit-for-bit-ish: the sampler is a pure function of (pixel, sample),
    so the split across devices cannot change the result."""
    from rustic.runtime.render import render_image

    settings = RenderSettings(samples=4, use_blue_noise=True)
    single = render_image(cornell_scene, cfg, settings)
    for spp_par in (1, 2, 4):
        mesh = make_mesh(spp_parallel=spp_par)
        multi = render_sharded(cornell_scene, cfg, settings, mesh=mesh)
        np.testing.assert_allclose(multi, single, rtol=1e-4, atol=1e-5)


def test_sharded_step_film_accumulates(cornell_scene, cfg):
    mesh = make_mesh(spp_parallel=2)
    fn = sharded_step(mesh, cfg.static_part(), n_samples=2)
    n_px = 64
    px = jnp.arange(n_px, dtype=jnp.int32) % 16
    py = jnp.arange(n_px, dtype=jnp.int32) // 16 % 16
    offsets = jnp.zeros(n_px, jnp.uint32)
    film0 = jnp.zeros((n_px, 3), jnp.float32)
    film1 = fn(cornell_scene, cfg.dynamic_part(), px, py, offsets, jnp.uint32(0), film0)
    sum1 = float(jnp.sum(film1))  # before donation to the next call
    film2 = fn(
        cornell_scene, cfg.dynamic_part(), px, py, offsets, jnp.uint32(2), film1
    )
    assert np.isfinite(np.asarray(film2)).all()
    assert float(jnp.sum(film2)) > sum1 * 1.2


@pytest.mark.slow  # mesh renders
def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_assemble_film_single_process():
    """Multi-host film assembly degrades to identity in one process."""
    import numpy as np

    from rustic.parallel.shard import assemble_film

    film = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = assemble_film(film)
    np.testing.assert_array_equal(out, film)


@pytest.mark.slow  # mesh renders


@pytest.mark.parametrize("px_par,spp_par", [(1, 1), (2, 1), (2, 2), (4, 2), (8, 1)])
def test_sharded_step_matches_single_device(cornell_scene, cfg, px_par, spp_par):
    """sharded_step on a (px, spp) mesh of the virtual devices equals the
    single-device film: pixels split over 'px', samples over 'spp', one
    film psum."""
    from rustic.runtime.render import pixel_offsets, render_pixels

    devices = jax.devices()[: px_par * spp_par]
    mesh = make_mesh(devices, spp_parallel=spp_par)
    assert dict(mesh.shape) == {"px": px_par, "spp": spp_par}
    n_px, n_samples = 64, 4
    px = np.arange(n_px, dtype=np.int32) % 16
    py = np.arange(n_px, dtype=np.int32) // 16
    offsets = pixel_offsets(16, 16)[:n_px]
    single = render_pixels(cornell_scene, cfg, px, py, n_samples, offsets=offsets)
    fn = sharded_step(mesh, cfg.static_part(), n_samples=n_samples)
    multi = fn(
        cornell_scene, cfg.dynamic_part(), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(offsets), jnp.uint32(0), jnp.zeros((n_px, 3), jnp.float32),
    )
    np.testing.assert_allclose(
        np.asarray(multi), np.asarray(single), rtol=1e-5, atol=1e-6
    )
