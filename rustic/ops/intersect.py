"""Ray-scene intersection.

Three engines with the same interface:

1. `intersect_brute` — Möller–Trumbore over *all* (ray, triangle) pairs
   as one f32 [B,10]x[10,4T] contraction plus an elementwise epilogue
   and a min-reduction. The pairwise scalars factor exactly as F @ G
   with F = [rd, ro×rd, ro, 1] per ray and a precomputed [10,4T]
   triangle tensor (see scene/world.py:_triangle_features). Rays are
   processed in chunks so the [chunk, 4T] intermediate stays bounded.
   It is the oracle the other engines are tested against.

2. `intersect_bvh` — semantics-faithful twin of the reference's ordered
   stackful traversal (reference: kernels/src/intersection.rs:177-234):
   every ray ("lane") keeps a fixed-depth stack; all lanes advance in
   lockstep inside one lax.while_loop, popping nodes / testing leaf
   triangles under masks. Scales to large scenes where brute force is
   quadratic-infeasible.

3. `intersect_scan` — the brute-force factorisation as one Pallas
   kernel through Triton (ops/scan.py): the running minimum stays in
   registers instead of a [chunk, 4T] intermediate in device memory.
   GPU only.

`intersect_nearest` / `intersect_any` take an engine name, mirroring the
reference's two entry points (kernels/src/intersection.rs:169-175);
`pick_engine` is the one place where "auto" becomes an engine, from the
platform and the triangle count.

Result convention matches the reference TraceResult
(kernels/src/intersection.rs:56-74): default t = 1e6 ("BIG"), a hit
requires t > 0.001 (EPS), backface = sign of the Möller–Trumbore
determinant, and any-hit additionally requires t <= max_t.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from rustic.ops.sampling import EPS, cross

BIG = 1e6  # reference: kernels/src/intersection.rs:69
DET_EPS = 1e-6  # reference: kernels/src/intersection.rs:23
STACK_DEPTH = 32  # reference: kernels/src/intersection.rs:178
ENGINES = ("brute", "bvh", "scan")
# `auto` on the CPU: brute force at or below this triangle count, the
# BVH above. On XLA:CPU the lockstep BVH beats brute force at every
# shipped scene size (brute's [chunk, 4T] epilogue is memory-bound on
# the host); brute only pays below the BVH's bookkeeping.
BRUTE_FORCE_MAX_TRIS = 64
# `auto` on the GPU: the Triton scan at or below this triangle count,
# the BVH above. On the H100 the scan won end to end on every scene
# measured up to 18,432 triangles (shipped scenes re-cut to 14,336 and
# 18,432) and lost on PBRTest at 24,002, whose BVH is the most efficient
# measured. Where the two cross depends on the scene's structure as
# well as its triangle count: extrapolated, ~20-23k on the re-cut
# scenes and near 16k for a PBRTest-like BVH. 16,384 is the bound that
# keeps the scan on the winning side of both (PERF.md, "crossover").
SCAN_MAX_TRIS = 16384
# Target f32 elements for one [chunk, 4T] intermediate (~64 MB).
_CHUNK_BUDGET = 1 << 24


class TraceResult(NamedTuple):
    t: jnp.ndarray  # [B] f32, BIG when missed
    tri_idx: jnp.ndarray  # [B] i32
    hit: jnp.ndarray  # [B] bool
    backface: jnp.ndarray  # [B] bool
    u: jnp.ndarray  # [B] f32 barycentric weight of vertex b
    v: jnp.ndarray  # [B] f32 barycentric weight of vertex c


def _ray_features(ro: jnp.ndarray, rd: jnp.ndarray) -> jnp.ndarray:
    ones = jnp.ones(ro.shape[:-1] + (1,), ro.dtype)
    return jnp.concatenate([rd, cross(ro, rd), ro, ones], axis=-1)


def _brute_chunk_size(n_tris: int, batch: int) -> int:
    per_ray = max(4 * n_tris, 1)
    chunk = max(_CHUNK_BUDGET // per_ray, 8)
    return min(chunk, max(batch, 1))


def _mt_scalars(feats: jnp.ndarray, tri_feats_flat: jnp.ndarray, n_tris: int):
    """[Bc,10] x [10,4T] -> det, u, v, t, valid-geometry mask, each [Bc, T]."""
    raw = jnp.dot(
        feats, tri_feats_flat, precision=lax.Precision.HIGHEST
    ).reshape(feats.shape[0], n_tris, 4)
    det = raw[..., 0]
    good_det = jnp.abs(det) >= DET_EPS
    inv_det = jnp.where(good_det, jnp.reciprocal(jnp.where(good_det, det, 1.0)), 0.0)
    u = raw[..., 1] * inv_det
    v = raw[..., 2] * inv_det
    t = raw[..., 3] * inv_det
    valid = (
        good_det
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return det, u, v, t, valid


def intersect_brute(
    tri_feats: jnp.ndarray, ro: jnp.ndarray, rd: jnp.ndarray
) -> TraceResult:
    """Nearest-hit over all triangles. tri_feats: [10, T, 4]."""
    n_tris = tri_feats.shape[1]
    batch = ro.shape[0]
    tf = tri_feats.reshape(10, n_tris * 4)
    chunk = _brute_chunk_size(n_tris, batch)
    pad = (-batch) % chunk
    ro_p = jnp.pad(ro, ((0, pad), (0, 0)))
    rd_p = jnp.pad(rd, ((0, pad), (0, 0)), constant_values=1.0)

    def body(args):
        ro_c, rd_c = args
        det, u, v, t, valid = _mt_scalars(_ray_features(ro_c, rd_c), tf, n_tris)
        t_masked = jnp.where(valid, t, BIG)
        idx = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
        tb = jnp.take_along_axis(t_masked, idx[:, None], axis=-1)[:, 0]
        db = jnp.take_along_axis(det, idx[:, None], axis=-1)[:, 0]
        ub = jnp.take_along_axis(u, idx[:, None], axis=-1)[:, 0]
        vb = jnp.take_along_axis(v, idx[:, None], axis=-1)[:, 0]
        hit = tb < BIG
        return tb, idx, hit, db < 0.0, ub, vb

    parts = lax.map(
        body,
        (
            ro_p.reshape(-1, chunk, 3),
            rd_p.reshape(-1, chunk, 3),
        ),
    )
    res = TraceResult(*(p.reshape(-1)[:batch] for p in parts))
    return res


def occlude_brute(
    tri_feats: jnp.ndarray,
    ro: jnp.ndarray,
    rd: jnp.ndarray,
    max_t: jnp.ndarray,
) -> jnp.ndarray:
    """Any-hit within (EPS, max_t] over all triangles. Returns [B] bool."""
    n_tris = tri_feats.shape[1]
    batch = ro.shape[0]
    tf = tri_feats.reshape(10, n_tris * 4)
    chunk = _brute_chunk_size(n_tris, batch)
    pad = (-batch) % chunk
    ro_p = jnp.pad(ro, ((0, pad), (0, 0)))
    rd_p = jnp.pad(rd, ((0, pad), (0, 0)), constant_values=1.0)
    mt_p = jnp.pad(max_t, (0, pad), constant_values=-1.0)

    def body(args):
        ro_c, rd_c, mt_c = args
        _, _, _, t, valid = _mt_scalars(_ray_features(ro_c, rd_c), tf, n_tris)
        return jnp.any(valid & (t <= mt_c[:, None]), axis=-1)

    occ = lax.map(
        body,
        (
            ro_p.reshape(-1, chunk, 3),
            rd_p.reshape(-1, chunk, 3),
            mt_p.reshape(-1, chunk),
        ),
    )
    return occ.reshape(-1)[:batch]


# ---------------------------------------------------------------------------
# BVH traversal engine
# ---------------------------------------------------------------------------


def _slab_test(lo, hi, ro, inv_rd, prev_t):
    """Slab AABB entry distance, +inf when missed
    (reference: kernels/src/intersection.rs:104-122)."""
    t1 = (lo - ro) * inv_rd
    t2 = (hi - ro) * inv_rd
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    ok = (tmax >= tmin) & (tmax > 0.0) & (tmin < prev_t)
    return jnp.where(ok, tmin, jnp.inf)


def _mt_single(a, b, c, ro, rd):
    """Möller–Trumbore for one gathered triangle per lane
    (reference: kernels/src/intersection.rs:9-54)."""
    e1 = b - a
    e2 = c - a
    pv = cross(rd, e2)
    det = jnp.sum(e1 * pv, axis=-1)
    backface = det < 0.0
    good = jnp.abs(det) >= DET_EPS
    inv_det = jnp.where(good, jnp.reciprocal(jnp.where(good, det, 1.0)), 0.0)
    tv = ro - a
    u = jnp.sum(tv * pv, axis=-1) * inv_det
    qv = cross(tv, e1)
    v = jnp.sum(rd * qv, axis=-1) * inv_det
    t = jnp.sum(e2 * qv, axis=-1) * inv_det
    valid = good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    return t, u, v, backface, valid


def _intersect_bvh_impl(scene, ro, rd, max_t, nearest: bool):
    batch = ro.shape[0]
    inv_rd = jnp.reciprocal(
        jnp.where(jnp.abs(rd) < 1e-12, jnp.where(rd < 0, -1e-12, 1e-12), rd)
    )
    lane = jnp.arange(batch)

    stack = jnp.zeros((batch, STACK_DEPTH), jnp.int32)  # root pre-pushed
    sp = jnp.ones(batch, jnp.int32)
    leaf_ptr = jnp.zeros(batch, jnp.int32)
    leaf_end = jnp.zeros(batch, jnp.int32)
    best_t = jnp.full(batch, BIG, jnp.float32)
    best_idx = jnp.zeros(batch, jnp.int32)
    best_back = jnp.zeros(batch, bool)
    best_u = jnp.zeros(batch, jnp.float32)
    best_v = jnp.zeros(batch, jnp.float32)
    done = jnp.zeros(batch, bool)  # any-hit early out

    def cond(state):
        sp, leaf_ptr, leaf_end, done = state[1], state[2], state[3], state[9]
        return jnp.any(~done & ((sp > 0) | (leaf_ptr < leaf_end)))

    def body(state):
        (
            stack,
            sp,
            leaf_ptr,
            leaf_end,
            best_t,
            best_idx,
            best_back,
            best_u,
            best_v,
            done,
        ) = state

        active = ~done
        in_leaf = active & (leaf_ptr < leaf_end)

        # --- leaf lanes: test one triangle ---------------------------------
        ti = jnp.clip(leaf_ptr, 0, scene.tri_vidx.shape[0] - 1)
        vidx = scene.tri_vidx[ti]
        a = scene.positions[vidx[:, 0]]
        b = scene.positions[vidx[:, 1]]
        c = scene.positions[vidx[:, 2]]
        t, u, v, backface, valid = _mt_single(a, b, c, ro, rd)
        better = in_leaf & valid & (t < best_t)
        if not nearest:
            better = better & (t <= max_t)
        best_t = jnp.where(better, t, best_t)
        best_idx = jnp.where(better, ti, best_idx)
        best_back = jnp.where(better, backface, best_back)
        best_u = jnp.where(better, u, best_u)
        best_v = jnp.where(better, v, best_v)
        if not nearest:
            done = done | better  # early-exit shadow rays
        leaf_ptr = leaf_ptr + in_leaf.astype(jnp.int32)

        # --- non-leaf lanes: pop a node ------------------------------------
        popping = active & ~in_leaf & (sp > 0)
        sp = sp - popping.astype(jnp.int32)
        node = stack[lane, jnp.clip(sp, 0, STACK_DEPTH - 1)]
        node = jnp.where(popping, node, 0)
        n_count = scene.bvh_count[node]
        n_left = scene.bvh_left_first[node]
        is_leaf = popping & (n_count > 0)

        # enter leaf: set the triangle cursor
        leaf_ptr = jnp.where(is_leaf, n_left, leaf_ptr)
        leaf_end = jnp.where(is_leaf, n_left + n_count, leaf_end)

        # internal: ordered push of both children
        # (reference: kernels/src/intersection.rs:206-230)
        internal = popping & (n_count == 0)
        li = n_left
        ri = n_left + 1
        ld = _slab_test(
            scene.bvh_min[li], scene.bvh_max[li], ro, inv_rd, best_t
        )
        rdist = _slab_test(
            scene.bvh_min[ri], scene.bvh_max[ri], ro, inv_rd, best_t
        )
        swap = ld > rdist
        near_i = jnp.where(swap, ri, li)
        far_i = jnp.where(swap, li, ri)
        near_d = jnp.minimum(ld, rdist)
        far_d = jnp.maximum(ld, rdist)

        push_far = internal & jnp.isfinite(far_d) & (sp < STACK_DEPTH)
        stack = stack.at[lane, jnp.clip(sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(push_far, far_i, stack[lane, jnp.clip(sp, 0, STACK_DEPTH - 1)])
        )
        sp = sp + push_far.astype(jnp.int32)
        push_near = internal & jnp.isfinite(near_d) & (sp < STACK_DEPTH)
        stack = stack.at[lane, jnp.clip(sp, 0, STACK_DEPTH - 1)].set(
            jnp.where(push_near, near_i, stack[lane, jnp.clip(sp, 0, STACK_DEPTH - 1)])
        )
        sp = sp + push_near.astype(jnp.int32)

        return (
            stack,
            sp,
            leaf_ptr,
            leaf_end,
            best_t,
            best_idx,
            best_back,
            best_u,
            best_v,
            done,
        )

    state = (
        stack,
        sp,
        leaf_ptr,
        leaf_end,
        best_t,
        best_idx,
        best_back,
        best_u,
        best_v,
        done,
    )
    state = lax.while_loop(cond, body, state)
    best_t, best_idx, best_back, best_u, best_v = state[4:9]
    hit = best_t < BIG
    return TraceResult(best_t, best_idx, hit, best_back, best_u, best_v)


def intersect_bvh(scene, ro, rd) -> TraceResult:
    return _intersect_bvh_impl(scene, ro, rd, None, nearest=True)


def occlude_bvh(scene, ro, rd, max_t) -> jnp.ndarray:
    return _intersect_bvh_impl(scene, ro, rd, max_t, nearest=False).hit


def intersect_scan(scene, ro, rd, interpret: bool = False) -> TraceResult:
    """Nearest hit through the Triton scan; the winner is re-tested in
    exact f32 (`_mt_single`) for its barycentrics and facing."""
    from rustic.ops.scan import scan_nearest

    t, idx = scan_nearest(_ray_features(ro, rd), scene.tri_feats, interpret)
    hit = t < BIG
    vidx = scene.tri_vidx[idx]
    _, u, v, backface, _ = _mt_single(
        scene.positions[vidx[:, 0]],
        scene.positions[vidx[:, 1]],
        scene.positions[vidx[:, 2]],
        ro,
        rd,
    )
    # a grazing winner the re-test puts a hair outside the triangle
    # stays a hit: clamp its barycentrics into the simplex
    u = jnp.clip(u, 0.0, 1.0)
    v = jnp.clip(v, 0.0, 1.0 - u)
    return TraceResult(t, idx, hit, backface & hit, u, v)


def occlude_scan(scene, ro, rd, max_t, interpret: bool = False) -> jnp.ndarray:
    from rustic.ops.scan import scan_any

    return scan_any(_ray_features(ro, rd), scene.tri_feats, max_t, interpret)


def gather_attr_rows(scene, idx):
    """The hit triangles' packed shading rows (scene/world.py ATTR_*)."""
    return scene.tri_attrs[jnp.clip(idx, 0, scene.tri_attrs.shape[0] - 1)]


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def pick_engine(n_tris: int, platform: str) -> str:
    """The engine `auto` resolves to on `platform` ("cpu", "gpu") for a
    scene of `n_tris` triangles."""
    if platform == "gpu" and n_tris <= SCAN_MAX_TRIS:
        return "scan"
    return "brute" if n_tris <= BRUTE_FORCE_MAX_TRIS else "bvh"


def resolve_engine(scene, engine: str, platform: str | None = None) -> str:
    """A concrete engine name; `auto` is picked for `platform` (default:
    the default JAX backend)."""
    platform = platform or jax.default_backend()
    if engine == "auto":
        return pick_engine(scene.n_tris, platform)
    engine = _traced_engine(scene, engine)
    if engine == "scan" and platform != "gpu":
        raise ValueError(f"the scan engine needs a GPU, not {platform!r}")
    return engine


def _traced_engine(scene, engine: str) -> str:
    # Inside a traced program the platform is the one being compiled
    # for, which the caller checked (resolve_engine); only `auto` and
    # the name are settled here.
    if engine == "auto":
        return pick_engine(scene.n_tris, jax.default_backend())
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected auto or one of {ENGINES}")
    return engine


def intersect_nearest(scene, ro, rd, engine: str = "auto") -> TraceResult:
    """Nearest hit (reference: kernels/src/intersection.rs:169-171)."""
    engine = _traced_engine(scene, engine)
    if engine == "scan":
        return intersect_scan(scene, ro, rd)
    if engine == "brute":
        return intersect_brute(scene.tri_feats, ro, rd)
    return intersect_bvh(scene, ro, rd)


def intersect_any(scene, ro, rd, max_t, engine: str = "auto") -> jnp.ndarray:
    """Occlusion within (EPS, max_t] (reference: kernels/src/intersection.rs:173-175)."""
    engine = _traced_engine(scene, engine)
    if engine == "scan":
        return occlude_scan(scene, ro, rd, max_t)
    if engine == "brute":
        return occlude_brute(scene.tri_feats, ro, rd, max_t)
    return occlude_bvh(scene, ro, rd, max_t)
