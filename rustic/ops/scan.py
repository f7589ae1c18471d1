"""Single-pass triangle scan: nearest hit and any hit, one Pallas kernel
through Triton.

XLA's brute engine (ops/intersect.py `intersect_brute`) writes the
[rays, 4T] Möller–Trumbore scalars of every (ray, triangle) pair to
device memory and reads them back for the epilogue and the min
reduction. This kernel computes the same scalars from the same
factorisation (ray features [rd, ro×rd, ro, 1] against the per-triangle
columns of scene/world.py `_triangle_features`) and keeps the running
(t, index) minimum, or the occluded flag, in registers: one program per
block of rays, an in-kernel loop over triangle tiles, nothing but the
per-ray result written back.

The arithmetic is float32 on the CUDA cores. A tensor-core dot would
round the features to TF32, which breaks the exact t ranking of nearby
triangles, and with only 10 features per pair it would gain little.

The kernel finds the winner; the caller re-tests it in exact float32
(`intersect_scan`), so a hit carries the same u, v and backface as the
other engines.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from rustic.ops.intersect import BIG, DET_EPS
from rustic.ops.sampling import EPS

N_FEAT = 10  # ray features [rd, ro x rd, ro, 1]
RAY_ROWS = 16  # feature rows padded to a power of two; row 10 holds max_t
MAXT_ROW = 10
# Block sizes chosen on the H100 (PERF.md, "scan block sizes").
RAY_BLOCK = 128
TRI_TILE = 4
NUM_WARPS = 4
NUM_STAGES = 2


# The features each numerator reads; the triangle tensor is zero
# elsewhere (scene/world.py `_triangle_features`): det = -rd.n,
# u and v mix rd and ro x rd, t = ro.n - a.n. 19 products per pair
# instead of 40, and skipping exact zeros leaves every sum unchanged.
_TERMS = (range(0, 3), range(0, 6), range(0, 6), range(6, 10))


def _tile_scalars(f, tri_ref, j):
    """det, u, v, t and the validity mask of one [RAY_BLOCK, TRI_TILE] tile."""
    cols = pl.ds(pl.multiple_of(j * TRI_TILE, TRI_TILE), TRI_TILE)
    out = []
    for c, terms in enumerate(_TERMS):  # det, u, v, t numerators
        acc = None
        for k in terms:
            term = f[k][:, None] * tri_ref[c * N_FEAT + k, cols][None, :]
            acc = term if acc is None else acc + term
        out.append(acc)
    det, u_num, v_num, t_num = out
    good = jnp.abs(det) >= DET_EPS
    inv_det = jnp.where(good, 1.0 / jnp.where(good, det, 1.0), 0.0)
    u = u_num * inv_det
    v = v_num * inv_det
    t = t_num * inv_det
    valid = (
        good & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS)
    )
    return t, valid


def _nearest_kernel(ray_ref, tri_ref, t_ref, idx_ref, *, n_tiles):
    f = [ray_ref[k, :] for k in range(N_FEAT)]
    col = jax.lax.broadcasted_iota(jnp.int32, (RAY_BLOCK, TRI_TILE), 1)

    def body(j, carry):
        best_t, best_idx = carry
        t, valid = _tile_scalars(f, tri_ref, j)
        tm = jnp.where(valid, t, BIG)
        tmin = jnp.min(tm, axis=1)
        first = jnp.min(jnp.where(tm == tmin[:, None], col, TRI_TILE), axis=1)
        # strict: an earlier tile keeps a tie, as argmin over all columns does
        better = tmin < best_t
        return (
            jnp.where(better, tmin, best_t),
            jnp.where(better, first + j * TRI_TILE, best_idx),
        )

    init = (
        jnp.full((RAY_BLOCK,), BIG, jnp.float32),
        jnp.zeros((RAY_BLOCK,), jnp.int32),
    )
    best_t, best_idx = jax.lax.fori_loop(0, n_tiles, body, init)
    t_ref[...] = best_t
    idx_ref[...] = best_idx


def _any_kernel(ray_ref, tri_ref, occ_ref, *, n_tiles):
    f = [ray_ref[k, :] for k in range(N_FEAT)]
    max_t = ray_ref[MAXT_ROW, :]

    def body(j, occ):
        t, valid = _tile_scalars(f, tri_ref, j)
        hit = jnp.where(valid & (t <= max_t[:, None]), 1, 0)
        return jnp.maximum(occ, jnp.max(hit, axis=1))

    occ_ref[...] = jax.lax.fori_loop(
        0, n_tiles, body, jnp.zeros((RAY_BLOCK,), jnp.int32)
    )


def tri_table(tri_feats: jnp.ndarray) -> jnp.ndarray:
    """[10, T, 4] triangle features -> [40, T_pad] rows (c * 10 + k), T
    padded with zero columns to whole tiles. A zero column has det = 0,
    so padding never hits."""
    n_tris = tri_feats.shape[1]
    t_pad = max(-(-n_tris // TRI_TILE), 1) * TRI_TILE
    table = jnp.transpose(tri_feats, (2, 0, 1)).reshape(4 * N_FEAT, n_tris)
    return jnp.pad(table, ((0, 0), (0, t_pad - n_tris)))


def ray_table(feats: jnp.ndarray, max_t=None) -> jnp.ndarray:
    """[B, 10] ray features (+ [B] max_t) -> [16, B_pad], B padded to
    whole ray blocks."""
    batch = feats.shape[0]
    b_pad = max(-(-batch // RAY_BLOCK), 1) * RAY_BLOCK
    rows = [feats.T]
    if max_t is not None:
        rows.append(max_t[None, :])
    table = jnp.concatenate(rows, axis=0)
    return jnp.pad(
        table, ((0, RAY_ROWS - table.shape[0]), (0, b_pad - batch))
    )


def _call(kernel, out_shape, rays, tris, interpret):
    n_blocks = rays.shape[1] // RAY_BLOCK
    n_tiles = tris.shape[1] // TRI_TILE
    out_spec = pl.BlockSpec((RAY_BLOCK,), lambda i: (i,))
    return pl.pallas_call(
        functools.partial(kernel, n_tiles=n_tiles),
        out_shape=out_shape,
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec((RAY_ROWS, RAY_BLOCK), lambda i: (0, i)),
            pl.BlockSpec(tris.shape, lambda i: (0, 0)),
        ],
        out_specs=(
            tuple(out_spec for _ in out_shape)
            if isinstance(out_shape, tuple)
            else out_spec
        ),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES
        ),
        interpret=interpret,
        name="triangle_scan",
    )(rays, tris)


def scan_nearest(feats, tri_feats, interpret: bool = False):
    """Nearest valid hit per ray: (t [B] f32, BIG on a miss; index [B] i32)."""
    batch = feats.shape[0]
    rays = ray_table(feats)
    b_pad = rays.shape[1]
    t, idx = _call(
        _nearest_kernel,
        (
            jax.ShapeDtypeStruct((b_pad,), jnp.float32),
            jax.ShapeDtypeStruct((b_pad,), jnp.int32),
        ),
        rays,
        tri_table(tri_feats),
        interpret,
    )
    return t[:batch], idx[:batch]


def scan_any(feats, tri_feats, max_t, interpret: bool = False):
    """Any valid hit with t <= max_t per ray: [B] bool."""
    batch = feats.shape[0]
    rays = ray_table(feats, max_t)
    occ = _call(
        _any_kernel,
        jax.ShapeDtypeStruct((rays.shape[1],), jnp.int32),
        rays,
        tri_table(tri_feats),
        interpret,
    )
    return occ[:batch] != 0
