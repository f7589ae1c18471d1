"""Binned-SAH BVH builder (host-side preprocessing).

Semantics-compatible with the reference builder (reference:
src/bvh.rs:178-324): per axis, triangles are binned into `sah_samples`
segments over the node's centroid bounds, prefix/suffix sweeps produce
left/right areas and counts for every candidate plane, the cheapest
plane wins, and a node stays a leaf when its own cost
(area * tri_count) is at most the best split cost. The triangle index
buffer is reordered in place so leaves reference contiguous ranges.

Layout difference: nodes are a struct-of-arrays (aabb_min[N,3],
aabb_max[N,3], left_first[N], count[N]) instead of the reference's
bit-cast vec4 pair (shared_structs/src/lib.rs:121-191) — integer fields
stay integers, which XLA gathers far more happily than bit-cast floats.
Per-node binning uses np.minimum.at/np.maximum.at scatter reductions
instead of scalar loops.

An optional C++ implementation of the same algorithm (native/bvh.cpp)
is used automatically when its shared library has been built.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_INF = np.float32(np.inf)


@dataclasses.dataclass
class BVH:
    """Flattened binary BVH. Node 0 is the root; children are (left, left+1).

    A node is a leaf iff count > 0, in which case left_first is the index
    of its first triangle in the (reordered) triangle buffer.
    """

    aabb_min: np.ndarray  # [N, 3] float32
    aabb_max: np.ndarray  # [N, 3] float32
    left_first: np.ndarray  # [N] int32: left child (internal) / first tri (leaf)
    count: np.ndarray  # [N] int32: 0 for internal nodes

    @property
    def n_nodes(self) -> int:
        return len(self.count)


def _node_area(lo: np.ndarray, hi: np.ndarray) -> float:
    e = hi - lo
    if not np.all(np.isfinite(e)):
        return 0.0
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def build_bvh(
    vertices: np.ndarray,
    triangles: np.ndarray,
    sah_samples: int = 128,
    use_native: bool = True,
) -> tuple[BVH, np.ndarray]:
    """Build a BVH; returns (bvh, permutation) where permutation maps
    new triangle order -> old triangle index. Callers must reorder any
    per-triangle side tables with the permutation.

    Args:
      vertices: [V, >=3] float array of positions.
      triangles: [T, 4] int array (i0, i1, i2, material).
      sah_samples: number of SAH bins (reference default 128,
        src/asset.rs:196).
    """
    if use_native:
        try:
            from rustic.scene import bvh_native

            if bvh_native.available():
                return bvh_native.build_bvh(vertices, triangles, sah_samples)
        except Exception:
            pass
    return _build_bvh_numpy(vertices, triangles, sah_samples)


def _build_bvh_numpy(
    vertices: np.ndarray, triangles: np.ndarray, sah_samples: int
) -> tuple[BVH, np.ndarray]:
    verts = np.asarray(vertices, np.float32)[:, :3]
    tris = np.asarray(triangles, np.int64)
    n_tris = len(tris)

    # Per-triangle precomputation: vertex positions, tight AABBs, centroids.
    va = verts[tris[:, 0]]
    vb = verts[tris[:, 1]]
    vc = verts[tris[:, 2]]
    tri_min = np.minimum(np.minimum(va, vb), vc)
    tri_max = np.maximum(np.maximum(va, vb), vc)
    centroids = (va + vb + vc) / 3.0

    perm = np.arange(n_tris)

    if n_tris == 0:
        raise ValueError(
            "scene has no triangle geometry (cameras/lights only?)"
        )
    max_nodes = max(2 * n_tris - 1, 1)
    aabb_min = np.full((max_nodes, 3), _INF, np.float32)
    aabb_max = np.full((max_nodes, 3), -_INF, np.float32)
    left_first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)

    left_first[0] = 0
    count[0] = n_tris
    aabb_min[0] = tri_min.min(axis=0)
    aabb_max[0] = tri_max.max(axis=0)

    node_count = 1
    stack = [0]
    while stack:
        node = stack.pop()
        first = int(left_first[node])
        n = int(count[node])
        sl = slice(first, first + n)
        cen = centroids[sl]
        tmin = tri_min[sl]
        tmax = tri_max[sl]

        best_cost = np.inf
        best_axis = -1
        best_split = 0.0
        for axis in range(3):
            c = cen[:, axis]
            lo = float(c.min())
            hi = float(c.max())
            if lo == hi:
                continue
            # Bin triangles (reference: src/bvh.rs:199-218)
            scale = sah_samples / (hi - lo)
            seg = np.minimum(((c - lo) * scale).astype(np.int64), sah_samples - 1)
            bin_min = np.full((sah_samples, 3), _INF, np.float32)
            bin_max = np.full((sah_samples, 3), -_INF, np.float32)
            np.minimum.at(bin_min, seg, tmin)
            np.maximum.at(bin_max, seg, tmax)
            bin_n = np.bincount(seg, minlength=sah_samples)

            # Prefix/suffix sweeps (reference: src/bvh.rs:221-240)
            lmin = np.minimum.accumulate(bin_min[:-1], axis=0)
            lmax = np.maximum.accumulate(bin_max[:-1], axis=0)
            rmin = np.minimum.accumulate(bin_min[:0:-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[:0:-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_n[:-1])
            rcnt = np.cumsum(bin_n[:0:-1])[::-1]

            def area(lo_, hi_):
                e = np.maximum(hi_ - lo_, 0.0)
                e = np.where(np.isfinite(e), e, 0.0)
                return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 2] * e[:, 0]

            cost = lcnt * area(lmin, lmax) + rcnt * area(rmin, rmax)
            # Degenerate empty-side planes must not win (matches the
            # reference's result>0 guard, src/bvh.rs:132-137).
            cost = np.where((lcnt == 0) | (rcnt == 0), np.inf, cost)
            i = int(np.argmin(cost))
            if cost[i] < best_cost:
                best_cost = float(cost[i])
                best_axis = axis
                best_split = lo + (hi - lo) / sah_samples * (i + 1)

        # Leaf if splitting is not cheaper than the parent
        # (reference: src/bvh.rs:274-277)
        parent_cost = _node_area(aabb_min[node], aabb_max[node]) * n
        if best_axis < 0 or parent_cost <= best_cost:
            continue

        mask = cen[:, best_axis] < best_split
        n_left = int(mask.sum())
        if n_left == 0 or n_left == n:
            continue

        # Partition this node's triangle range in place
        order = np.concatenate([np.nonzero(mask)[0], np.nonzero(~mask)[0]]) + first
        perm[sl] = perm[order]
        centroids[sl] = centroids[order]
        tri_min[sl] = tri_min[order]
        tri_max[sl] = tri_max[order]

        left = node_count
        right = node_count + 1
        node_count += 2
        left_first[node] = left
        count[node] = 0
        left_first[left] = first
        count[left] = n_left
        left_first[right] = first + n_left
        count[right] = n - n_left
        aabb_min[left] = tri_min[first : first + n_left].min(axis=0)
        aabb_max[left] = tri_max[first : first + n_left].max(axis=0)
        aabb_min[right] = tri_min[first + n_left : first + n].min(axis=0)
        aabb_max[right] = tri_max[first + n_left : first + n].max(axis=0)
        stack.append(right)
        stack.append(left)

    bvh = BVH(
        aabb_min=aabb_min[:node_count].copy(),
        aabb_max=aabb_max[:node_count].copy(),
        left_first=left_first[:node_count].copy(),
        count=count[:node_count].copy(),
    )
    return bvh, perm


def validate_bvh(bvh: BVH, tri_min: np.ndarray, tri_max: np.ndarray) -> None:
    """Sanity-check BVH invariants (used by tests): every leaf's box
    contains its triangles, internal boxes contain their children, and
    the leaves partition the triangle array exactly."""
    seen = np.zeros(len(tri_min), bool)
    stack = [0]
    while stack:
        node = stack.pop()
        lo, hi = bvh.aabb_min[node], bvh.aabb_max[node]
        if bvh.count[node] > 0:
            sl = slice(
                int(bvh.left_first[node]),
                int(bvh.left_first[node] + bvh.count[node]),
            )
            assert not seen[sl].any(), "leaf ranges overlap"
            seen[sl] = True
            assert np.all(tri_min[sl] >= lo - 1e-4), "leaf box too small"
            assert np.all(tri_max[sl] <= hi + 1e-4), "leaf box too small"
        else:
            l = int(bvh.left_first[node])
            for child in (l, l + 1):
                assert np.all(bvh.aabb_min[child] >= lo - 1e-4)
                assert np.all(bvh.aabb_max[child] <= hi + 1e-4)
                stack.append(child)
    assert seen.all(), "some triangles not referenced by any leaf"
