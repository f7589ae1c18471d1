import numpy as np
import jax.numpy as jnp

from rustic.ops import bsdf as B
from rustic.ops import sampling as s


def _rands(n, seed):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.uniform(0, 1, n).astype(np.float32)) for _ in range(3))


def test_lambertian_white_furnace():
    """E[spectrum/pdf] == albedo exactly for cosine-sampled Lambertian."""
    n = 1 << 14
    albedo = jnp.tile(jnp.asarray([[0.8, 0.6, 0.4]]), (n, 1))
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    r1, r2, _ = _rands(n, 0)
    bs = B.lambertian_sample(albedo, normal, r1, r2)
    weight = np.asarray(bs.spectrum) / np.asarray(bs.pdf)[:, None]
    np.testing.assert_allclose(weight.mean(axis=0), [0.8, 0.6, 0.4], atol=1e-3)


def test_pbr_diffuse_metal0_furnace():
    """A rough, non-metallic PBR surface must not create energy."""
    n = 1 << 14
    mat = B.PBRMaterial(
        albedo=jnp.tile(jnp.asarray([[1.0, 1.0, 1.0]]), (n, 1)),
        roughness=jnp.full(n, 0.8),
        metallic=jnp.full(n, 0.0),
        specular_weight_clamp=jnp.asarray([0.1, 0.9]),
    )
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    view = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    r1, r2, r3 = _rands(n, 1)
    bs = B.pbr_sample(mat, view, normal, r1, r2, r3)
    weight = np.asarray(bs.spectrum) / np.asarray(bs.pdf)[:, None]
    mean = weight.mean(axis=0)
    assert np.all(mean < 1.05), mean
    assert np.all(mean > 0.5), mean


def test_pbr_lobe_split_matches_specular_weight():
    """Lobe selection frequency equals the clamped specular weight
    (reference: kernels/src/bsdf.rs:275-282)."""
    n = 1 << 14
    mat = B.PBRMaterial(
        albedo=jnp.tile(jnp.asarray([[0.5, 0.5, 0.5]]), (n, 1)),
        roughness=jnp.full(n, 0.5),
        metallic=jnp.full(n, 0.0),
        specular_weight_clamp=jnp.asarray([0.1, 0.9]),
    )
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    view = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    r1, r2, r3 = _rands(n, 2)
    bs = B.pbr_sample(mat, view, normal, r1, r2, r3)
    frac_spec = float((np.asarray(bs.lobe) == B.LOBE_SPECULAR).mean())
    # fresnel at normal incidence ~0.04 -> clamped to 0.1
    assert abs(frac_spec - 0.1) < 0.02


def test_pbr_metal_has_no_diffuse():
    n = 1 << 12
    mat = B.PBRMaterial(
        albedo=jnp.tile(jnp.asarray([[1.0, 0.8, 0.2]]), (n, 1)),
        roughness=jnp.full(n, 0.3),
        metallic=jnp.full(n, 1.0 - 1e-3),
        specular_weight_clamp=jnp.asarray([0.1, 0.9]),
    )
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    view = s.normalize(jnp.tile(jnp.asarray([[0.3, 1.0, 0.0]]), (n, 1)))
    r1, r2, r3 = _rands(n, 3)
    bs = B.pbr_sample(mat, view, normal, r1, r2, r3)
    # metallic ~1 -> specular weight ~1 (unclamped at exactly 1; here ~0.9+)
    assert (np.asarray(bs.lobe) == B.LOBE_SPECULAR).mean() > 0.85


def test_pbr_sampled_directions_above_surface_for_diffuse():
    n = 1 << 12
    mat = B.PBRMaterial(
        albedo=jnp.tile(jnp.asarray([[0.5, 0.5, 0.5]]), (n, 1)),
        roughness=jnp.full(n, 0.9),
        metallic=jnp.full(n, 0.0),
        specular_weight_clamp=jnp.asarray([0.1, 0.9]),
    )
    normal = s.normalize(jnp.tile(jnp.asarray([[0.3, 0.8, -0.1]]), (n, 1)))
    view = s.normalize(jnp.tile(jnp.asarray([[0.1, 1.0, 0.3]]), (n, 1)))
    r1, r2, r3 = _rands(n, 4)
    bs = B.pbr_sample(mat, view, normal, r1, r2, r3)
    diffuse = np.asarray(bs.lobe) == B.LOBE_DIFFUSE
    cos = np.asarray(s.dot(bs.direction, normal))
    assert np.all(cos[diffuse] > -1e-4)


def test_glass_sample_unit_directions_and_fresnel_split():
    n = 1 << 14
    albedo = jnp.tile(jnp.asarray([[0.9, 0.9, 0.9]]), (n, 1))
    normal = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    view = s.normalize(jnp.tile(jnp.asarray([[0.0, 1.0, 0.4]]), (n, 1)))
    r1, r2, r3 = _rands(n, 5)
    bs = B.glass_sample(albedo, 1.5, 0.05, view, normal, r1, r2, r3)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(bs.direction), axis=-1), 1.0, atol=1e-4
    )
    frac_reflect = float((np.asarray(bs.lobe) == B.LOBE_SPECULAR).mean())
    assert 0.02 < frac_reflect < 0.2  # near-normal incidence: mostly refracts
    # transmitted rays go below the surface
    trans = np.asarray(bs.lobe) == B.LOBE_SPECULAR_T
    assert np.asarray(bs.direction)[trans, 1].max() < 0.0


def test_specular_weight_clamp_applied():
    n = 4
    mat = B.PBRMaterial(
        albedo=jnp.tile(jnp.asarray([[0.5, 0.5, 0.5]]), (n, 1)),
        roughness=jnp.full(n, 0.5),
        metallic=jnp.full(n, 0.5),
        specular_weight_clamp=jnp.asarray([0.3, 0.6]),
    )
    w = np.asarray(B._specular_weight(mat, jnp.full(n, 1.0)))
    assert np.all(w >= 0.3 - 1e-6) and np.all(w <= 0.6 + 1e-6)
