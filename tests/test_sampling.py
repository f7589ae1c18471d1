import numpy as np
import jax.numpy as jnp

from rustic.ops import sampling as s


def _rand(shape, seed=0):
    return jnp.asarray(np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32))


def test_cosine_hemisphere_distribution():
    r1 = _rand((1 << 14,), 1)
    r2 = _rand((1 << 14,), 2)
    d = np.asarray(s.cosine_sample_hemisphere(r1, r2))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert d[:, 1].min() >= 0.0  # y-up hemisphere
    # E[cos theta] = 2/3 for pdf = cos/pi
    assert abs(d[:, 1].mean() - 2.0 / 3.0) < 0.01


def test_create_cartesian_orthonormal():
    n = s.normalize(_rand((256, 3), 3) * 2.0 - 1.0)
    up, right, forward = s.create_cartesian(n)
    for a, b in [(up, right), (up, forward), (right, forward)]:
        np.testing.assert_allclose(np.asarray(s.dot(a, b)), 0.0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(s.length(right)), 1.0, atol=1e-5)


def test_reflect():
    i = jnp.asarray([[1.0, -1.0, 0.0]]) / np.sqrt(2)
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = np.asarray(s.reflect(i, n))
    np.testing.assert_allclose(r, [[1.0 / np.sqrt(2), 1.0 / np.sqrt(2), 0.0]], atol=1e-6)


def test_refract_tir_returns_zero():
    # grazing entry from dense to sparse medium -> total internal reflection
    i = s.normalize(jnp.asarray([[0.99, -0.1, 0.0]]))
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = np.asarray(s.refract(i, n, 1.5, 1.0))
    np.testing.assert_allclose(r, 0.0, atol=1e-6)


def test_fresnel_schlick_limits():
    f0 = jnp.asarray([[0.04, 0.04, 0.04]])
    head_on = np.asarray(s.fresnel_schlick(jnp.asarray([1.0]), f0))
    grazing = np.asarray(s.fresnel_schlick(jnp.asarray([0.0]), f0))
    np.testing.assert_allclose(head_on, 0.04, atol=1e-6)
    np.testing.assert_allclose(grazing, 1.0, atol=1e-6)
    assert abs(float(s.fresnel_schlick_scalar(1.0, 1.5, jnp.asarray(1.0))) - 0.04) < 1e-3


def test_barycentric_roundtrip():
    rng = np.random.default_rng(5)
    a, b, c = (jnp.asarray(rng.normal(0, 1, (64, 3)).astype(np.float32)) for _ in range(3))
    w = rng.dirichlet([1, 1, 1], 64).astype(np.float32)
    p = w[:, 0:1] * a + w[:, 1:2] * b + w[:, 2:3] * c
    bary = np.asarray(s.barycentric(jnp.asarray(p), a, b, c))
    np.testing.assert_allclose(bary, w, atol=1e-3)


def test_power_heuristic():
    assert abs(float(s.power_heuristic(jnp.asarray(1.0), jnp.asarray(1.0))) - 0.5) < 1e-6
    assert float(s.power_heuristic(jnp.asarray(10.0), jnp.asarray(0.1))) > 0.99


def test_mask_nan():
    v = jnp.asarray([[1.0, 2.0, 3.0], [np.nan, 1.0, 1.0], [np.inf, 0.0, 0.0]])
    out = np.asarray(s.mask_nan(v))
    np.testing.assert_allclose(out[0], [1, 2, 3])
    np.testing.assert_allclose(out[1], 0.0)
    np.testing.assert_allclose(out[2], 0.0)


def test_ggx_distribution_normalization():
    # Integral of D(h) cos(h) over hemisphere should be ~1.
    rough = 0.5
    n_samp = 1 << 16
    rng = np.random.default_rng(7)
    # uniform hemisphere sampling
    u = rng.uniform(0, 1, n_samp)
    phi = rng.uniform(0, 2 * np.pi, n_samp)
    cos_t = u
    sin_t = np.sqrt(1 - cos_t**2)
    h = np.stack([sin_t * np.cos(phi), cos_t, sin_t * np.sin(phi)], -1).astype(np.float32)
    n = jnp.asarray(np.tile([0.0, 1.0, 0.0], (n_samp, 1)).astype(np.float32))
    d = np.asarray(s.ggx_distribution(n, jnp.asarray(h), rough))
    integral = (d * cos_t).mean() * 2 * np.pi  # pdf = 1/2pi
    assert abs(integral - 1.0) < 0.05
