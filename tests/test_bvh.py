import numpy as np
import pytest

from rustic.scene.bvh import _build_bvh_numpy, build_bvh, validate_bvh


def _tri_bounds(verts, tris):
    va, vb, vc = (verts[tris[:, k]] for k in range(3))
    return np.minimum(np.minimum(va, vb), vc), np.maximum(np.maximum(va, vb), vc)


def _random_soup(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 1, 3))
    verts = (centers + rng.normal(0, 0.3, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    tris = np.arange(3 * n).reshape(n, 3)
    tris = np.concatenate([tris, np.zeros((n, 1), np.int64)], axis=1)
    return verts, tris


@pytest.mark.parametrize("n", [1, 2, 7, 500])
def test_bvh_invariants_random_soup(n):
    verts, tris = _random_soup(n, seed=n)
    bvh, perm = _build_bvh_numpy(verts, tris, sah_samples=32)
    assert sorted(perm.tolist()) == list(range(n))
    tmin, tmax = _tri_bounds(verts, tris[perm])
    validate_bvh(bvh, tmin, tmax)


def test_bvh_invariants_cornell(cornell_world):
    w = cornell_world
    tmin, tmax = _tri_bounds(w.positions, w.triangles)
    validate_bvh(w.bvh, tmin, tmax)


def test_bvh_root_covers_everything():
    verts, tris = _random_soup(100, seed=3)
    bvh, perm = build_bvh(verts, tris, sah_samples=64, use_native=False)
    tmin, tmax = _tri_bounds(verts, tris[perm])
    assert np.all(bvh.aabb_min[0] <= tmin.min(axis=0) + 1e-5)
    assert np.all(bvh.aabb_max[0] >= tmax.max(axis=0) - 1e-5)


def test_bvh_leaves_are_small_for_spread_triangles():
    # Well-separated triangles should be split down to small leaves.
    verts, tris = _random_soup(256, seed=9)
    bvh, _ = _build_bvh_numpy(verts, tris, sah_samples=64)
    leaf_sizes = bvh.count[bvh.count > 0]
    assert leaf_sizes.mean() <= 4.0
