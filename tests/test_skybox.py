import numpy as np
import jax.numpy as jnp

from rustic.ops.skybox import image_sky, procedural_sky


def _sun():
    d = np.array([0.5, 1.3, 1.0])
    d = d / np.linalg.norm(d)
    return jnp.asarray([*d, 15.0], jnp.float32)


def test_procedural_sky_finite_nonnegative():
    n = 256
    rng = np.random.default_rng(0)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro = np.zeros((n, 3), np.float32)
    out = np.asarray(procedural_sky(_sun(), jnp.asarray(ro), jnp.asarray(rd)))
    assert np.isfinite(out).all()
    assert (out >= 0.0).all()


def test_procedural_sky_brighter_toward_sun():
    sun = _sun()
    toward = np.asarray(sun[:3])[None, :].astype(np.float32)
    away = -toward
    ro = np.zeros((1, 3), np.float32)
    bright = np.asarray(procedural_sky(sun, jnp.asarray(ro), jnp.asarray(toward))).sum()
    dark = np.asarray(procedural_sky(sun, jnp.asarray(ro), jnp.asarray(away))).sum()
    assert bright > dark


def test_image_sky_intensity_normalization():
    """Uniform skybox image -> radiance = pixel * intensity/15
    (reference: kernels/src/lib.rs:76)."""
    img = jnp.full((8, 16, 4), 2.0)
    rd = jnp.asarray(np.random.default_rng(1).normal(0, 1, (64, 3)).astype(np.float32))
    rd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    out = np.asarray(image_sky(img, _sun(), rd))
    np.testing.assert_allclose(out, 2.0 * (15.0 / 15.0), atol=1e-4)


def test_image_sky_equirect_poles():
    """Looking straight up/down lands on the first/last image rows."""
    img = jnp.zeros((8, 16, 4)).at[0].set(1.0)  # v=0 row bright
    up = jnp.asarray([[0.0, 1.0, 0.0]])
    down = jnp.asarray([[0.0, -1.0, 0.0]])
    sun = _sun()
    # v = 1 - (0.5 + asin(y)/pi): up -> v=0, down -> v=1
    assert np.asarray(image_sky(img, sun, up))[0, 0] > 0.5
    assert np.asarray(image_sky(img, sun, down))[0, 0] < 0.5


def test_deferred_sky_compact_matches_full():
    """The compact (top_k) deferred-sky path must equal the full-batch
    march bit-for-bit: the march is elementwise in the lane, so
    gather -> march -> scatter-add reproduces the masked full result
    exactly (ops/trace.py deferred_sky_term)."""
    from types import SimpleNamespace

    import jax

    from rustic.ops import trace as trace_mod
    from rustic.ops.skybox import sky_radiance

    batch = 2 * trace_mod._SKY_SEG * trace_mod._SKY_SEGS_K  # compact path
    rng = np.random.default_rng(7)
    rd = rng.normal(size=(batch, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro = rng.normal(scale=2.0, size=(batch, 3)).astype(np.float32)
    throughput = rng.random((batch, 3), dtype=np.float32)
    missed = np.zeros(batch, bool)
    missed[rng.choice(batch, size=137, replace=False)] = True

    scene = SimpleNamespace(skybox=None)
    cfg = SimpleNamespace(has_skybox=False, max_bounces=4)
    cam = SimpleNamespace(
        sun_direction=jnp.asarray([0.4, 0.8, 0.2, 15.0], jnp.float32)
    )
    args = (jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(throughput),
            jnp.asarray(missed))
    got = np.asarray(
        jax.jit(
            lambda ro, rd, tp, m: trace_mod.deferred_sky_term(
                scene, cfg, cam, ro, rd, tp, m
            )
        )(*args)
    )
    sky = np.asarray(sky_radiance(scene, False, cam.sun_direction,
                                  args[0], args[1]))
    want = np.where(missed[:, None], throughput * sky, 0.0)
    # not bit-equal: XLA contracts the march's FMAs differently for the
    # gathered [K] shape than the full [B] one — float-rounding only
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert (got[~missed] == 0.0).all()

    # overflow (more miss-carrying segments than the budget) must fall
    # back to the full march
    missed_many = np.zeros(batch, bool)
    missed_many[:: trace_mod._SKY_SEG] = True  # one per segment > K segs
    got2 = np.asarray(
        trace_mod.deferred_sky_term(
            scene, cfg, cam, args[0], args[1], args[2],
            jnp.asarray(missed_many),
        )
    )
    want2 = np.where(missed_many[:, None], throughput * sky, 0.0)
    np.testing.assert_allclose(got2, want2, rtol=1e-4, atol=1e-5)
