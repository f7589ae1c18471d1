import numpy as np
import jax
import jax.numpy as jnp

from rustic.ops import intersect as I
from rustic.scene.world import _triangle_features


def _single_triangle_scene():
    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int64)
    return _triangle_features(verts, tris)


def test_brute_single_triangle_hit_and_miss():
    tf = jnp.asarray(_single_triangle_scene())
    ro = jnp.asarray([[0.0, 0.0, -2.0], [0.0, 0.0, -2.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
    res = I.intersect_brute(tf, ro, rd)
    assert bool(res.hit[0]) and not bool(res.hit[1])
    np.testing.assert_allclose(float(res.t[0]), 2.0, atol=1e-5)


def test_brute_backface_flag():
    tf = jnp.asarray(_single_triangle_scene())
    ro = jnp.asarray([[0.0, 0.0, -2.0], [0.0, 0.0, 2.0]])
    rd = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    res = I.intersect_brute(tf, ro, rd)
    assert bool(res.hit[0]) and bool(res.hit[1])
    # Opposite approach directions flip the determinant sign.
    assert bool(res.backface[0]) != bool(res.backface[1])


def test_brute_barycentrics():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int64)
    tf = jnp.asarray(_triangle_features(verts, tris))
    # Shoot at the point 0.2*b + 0.3*c
    target = 0.5 * verts[0] + 0.2 * verts[1] + 0.3 * verts[2]
    ro = jnp.asarray([np.append(target[:2], -1.0)], jnp.float32)
    rd = jnp.asarray([[0.0, 0.0, 1.0]])
    res = I.intersect_brute(tf, ro, rd)
    assert bool(res.hit[0])
    np.testing.assert_allclose(float(res.u[0]), 0.2, atol=1e-5)
    np.testing.assert_allclose(float(res.v[0]), 0.3, atol=1e-5)


def test_t_min_epsilon():
    # Hits closer than EPS (1e-3) are rejected, as in the reference
    # (kernels/src/intersection.rs:195).
    tf = jnp.asarray(_single_triangle_scene())
    ro = jnp.asarray([[0.0, 0.0, -0.0005]])
    rd = jnp.asarray([[0.0, 0.0, 1.0]])
    res = I.intersect_brute(tf, ro, rd)
    assert not bool(res.hit[0])


def _random_rays(n, seed, center=(0.0, 1.0, -3.0), spread=1.0):
    rng = np.random.default_rng(seed)
    ro = (rng.normal(0, spread, (n, 3)) + np.asarray(center)).astype(np.float32)
    rd = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return jnp.asarray(ro), jnp.asarray(rd)


def test_engines_agree_nearest(cornell_scene):
    scene = cornell_scene
    ro, rd = _random_rays(1024, 0)
    rb = jax.jit(lambda ro, rd: I.intersect_brute(scene.tri_feats, ro, rd))(ro, rd)
    rv = jax.jit(lambda ro, rd: I.intersect_bvh(scene, ro, rd))(ro, rd)
    np.testing.assert_array_equal(np.asarray(rb.hit), np.asarray(rv.hit))
    both = np.asarray(rb.hit)
    np.testing.assert_allclose(
        np.asarray(rb.t)[both], np.asarray(rv.t)[both], rtol=1e-4, atol=1e-4
    )
    np.testing.assert_array_equal(
        np.asarray(rb.tri_idx)[both], np.asarray(rv.tri_idx)[both]
    )
    np.testing.assert_array_equal(
        np.asarray(rb.backface)[both], np.asarray(rv.backface)[both]
    )


def test_engines_agree_occlusion(cornell_scene):
    scene = cornell_scene
    ro, rd = _random_rays(1024, 1)
    max_t = jnp.asarray(
        np.random.default_rng(2).uniform(0.2, 6.0, 1024).astype(np.float32)
    )
    ob = jax.jit(lambda *a: I.occlude_brute(scene.tri_feats, *a))(ro, rd, max_t)
    ov = jax.jit(lambda *a: I.occlude_bvh(scene, *a))(ro, rd, max_t)
    np.testing.assert_array_equal(np.asarray(ob), np.asarray(ov))
    assert 0.05 < float(np.asarray(ob).mean()) < 1.0


def test_slab_test_through_box():
    lo = jnp.asarray([[-1.0, -1.0, -1.0]])
    hi = jnp.asarray([[1.0, 1.0, 1.0]])
    ro = jnp.asarray([[0.0, 0.0, -5.0]])
    inv = 1.0 / jnp.asarray([[1e-12, 1e-12, 1.0]])
    d = I._slab_test(lo, hi, ro, inv, jnp.asarray([1e9]))
    np.testing.assert_allclose(np.asarray(d), 4.0, atol=1e-4)
    # behind the ray -> miss
    d2 = I._slab_test(lo, hi, ro, -inv, jnp.asarray([1e9]))
    assert np.isinf(np.asarray(d2)).all()
