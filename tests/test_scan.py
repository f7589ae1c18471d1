"""The Triton triangle scan (ops/scan.py) against the brute-force oracle.

The kernel runs here in Pallas interpret mode, which executes the same
kernel body on the CPU; tests pass interpret=True explicitly, since no
production path interprets it. The card-side twin of these checks is
`compare_scan_to_brute`, run by chip_smoke.py at 921,600 rays.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rustic.ops import intersect as I
from rustic.ops import scan as S
from rustic.scene.world import World
from tests.conftest import scene_path

SCENES = ("DarkCornell.glb", "VeachMIS.glb", "FurnaceTest.glb")


@pytest.fixture(scope="module")
def scenes():
    return {name: World.from_path(scene_path(name)).to_device() for name in SCENES}


def _rays(scene, n, seed):
    """Rays from random points inside the scene's box in random
    directions: a mix of hits, misses and grazing pairs."""
    pos = np.asarray(scene.positions)
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    rng = np.random.default_rng(seed)
    ro = lo + (hi - lo) * rng.uniform(0.1, 0.9, (n, 3))
    rd = rng.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return jnp.asarray(ro, jnp.float32), jnp.asarray(rd, jnp.float32)


def _check_nearest(scene, ro, rd, res, ref):
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(res.hit), hit)
    same = np.asarray(res.tri_idx) == np.asarray(ref.tri_idx)
    # Both engines round the same factorised sums in another order. t is
    # ill-conditioned at grazing incidence (rounding grows as 1/cos of
    # the angle to the normal), so the tolerance is 1e-5 * max(t, 1) /
    # cos; a different winner is only allowed for a tie within it.
    n = -np.asarray(scene.tri_feats)[0:3, :, 0].T[np.asarray(ref.tri_idx)]
    cos = np.abs(np.sum(n * np.asarray(rd), axis=-1)) / np.linalg.norm(n, axis=-1)
    t, t_ref = np.asarray(res.t), np.asarray(ref.t)
    tol = 1e-5 * np.maximum(t_ref, 1.0) / np.maximum(cos, 1e-3)
    assert np.all((np.abs(t - t_ref) <= tol)[hit])
    both = hit & same
    np.testing.assert_allclose(np.asarray(res.u)[both], np.asarray(ref.u)[both], atol=1e-4)
    np.testing.assert_allclose(np.asarray(res.v)[both], np.asarray(ref.v)[both], atol=1e-4)
    np.testing.assert_array_equal(
        np.asarray(res.backface)[both], np.asarray(ref.backface)[both]
    )


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("batch", [4 * S.RAY_BLOCK, 3 * S.RAY_BLOCK + 11])
def test_scan_nearest_matches_brute(scenes, name, batch):
    scene = scenes[name]
    ro, rd = _rays(scene, batch, seed=batch)
    res = I.intersect_scan(scene, ro, rd, interpret=True)
    ref = I.intersect_brute(scene.tri_feats, ro, rd)
    assert res.t.shape == (batch,) and res.tri_idx.dtype == jnp.int32
    assert np.asarray(ref.hit).any()
    _check_nearest(scene, ro, rd, res, ref)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("batch", [4 * S.RAY_BLOCK, 3 * S.RAY_BLOCK + 11])
def test_scan_any_matches_brute(scenes, name, batch):
    scene = scenes[name]
    ro, rd = _rays(scene, batch, seed=batch + 1)
    max_t = jnp.asarray(np.random.default_rng(batch).uniform(0.0, 10.0, batch), jnp.float32)
    occ = I.occlude_scan(scene, ro, rd, max_t, interpret=True)
    ref = I.occlude_brute(scene.tri_feats, ro, rd, max_t)
    assert occ.shape == (batch,) and occ.dtype == jnp.bool_
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


def test_scan_all_miss(scenes):
    """Rays from far outside the box pointing away: every ray misses."""
    scene = scenes["DarkCornell.glb"]
    n = 2 * S.RAY_BLOCK
    rd = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    ro = jnp.tile(jnp.asarray([[0.0, 1e3, 0.0]]), (n, 1))
    res = I.intersect_scan(scene, ro, rd, interpret=True)
    assert not np.asarray(res.hit).any()
    np.testing.assert_array_equal(np.asarray(res.t), I.BIG)
    occ = I.occlude_scan(scene, ro, rd, jnp.full((n,), 1e5), interpret=True)
    assert not np.asarray(occ).any()


@pytest.mark.parametrize("n_tris", [1, S.TRI_TILE + 5])
def test_scan_partial_tile(scenes, n_tris):
    """A triangle count that is not a whole number of tiles: the zero
    padding columns never win."""
    scene = scenes["VeachMIS.glb"]
    feats = scene.tri_feats[:, :n_tris]
    ro, rd = _rays(scene, 2 * S.RAY_BLOCK, seed=n_tris)
    t, idx = S.scan_nearest(I._ray_features(ro, rd), feats, interpret=True)
    ref = I.intersect_brute(feats, ro, rd)
    np.testing.assert_array_equal(np.asarray(t < I.BIG), np.asarray(ref.hit))
    assert np.all(np.asarray(idx) < n_tris)
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(idx)[hit], np.asarray(ref.tri_idx)[hit])


def test_scan_any_respects_max_t_on_a_hit(scenes):
    """Occluded exactly when the nearest hit lies within max_t."""
    scene = scenes["DarkCornell.glb"]
    ro, rd = _rays(scene, 4 * S.RAY_BLOCK, seed=7)
    ref = I.intersect_brute(scene.tri_feats, ro, rd)
    hit = np.asarray(ref.hit)
    t = jnp.where(ref.hit, ref.t, 1.0)
    beyond = I.occlude_scan(scene, ro, rd, t * 1.001, interpret=True)
    short = I.occlude_scan(scene, ro, rd, t * 0.999, interpret=True)
    np.testing.assert_array_equal(np.asarray(beyond), hit)
    assert not np.asarray(short)[hit].any()


def test_scan_tables_pad_to_blocks(scenes):
    scene = scenes["DarkCornell.glb"]
    table = S.tri_table(scene.tri_feats)
    assert table.shape == (40, -(-scene.n_tris // S.TRI_TILE) * S.TRI_TILE)
    assert not np.asarray(table[:, scene.n_tris:]).any()
    feats = jnp.ones((S.RAY_BLOCK + 3, 10))
    rays = S.ray_table(feats, jnp.full((S.RAY_BLOCK + 3,), 2.0))
    assert rays.shape == (S.RAY_ROWS, 2 * S.RAY_BLOCK)
    np.testing.assert_array_equal(np.asarray(rays[S.MAXT_ROW, : S.RAY_BLOCK + 3]), 2.0)


def test_scan_lowers_for_the_gpu_without_interpret(scenes, monkeypatch):
    """Tracing a render with the scan engine calls the kernel with
    interpret=False, and the kernel lowers to a Triton call for CUDA."""
    from rustic.config import NextEventEstimation, TracingConfig
    from rustic.ops.trace import trace_paths

    seen = []
    real = S.pl.pallas_call

    def spy(*args, **kwargs):
        seen.append(kwargs.get("interpret"))
        return real(*args, **kwargs)

    monkeypatch.setattr(S.pl, "pallas_call", spy)
    scene = scenes["DarkCornell.glb"]
    config = TracingConfig(width=8, height=8, nee=NextEventEstimation.MIS, max_bounces=1)
    px = jnp.arange(64, dtype=jnp.int32) % 8
    py = jnp.arange(64, dtype=jnp.int32) // 8

    def fn(scene, cam):
        return trace_paths(
            scene, config.static_part(), cam, px, py, jnp.uint32(0),
            jnp.zeros(64, jnp.uint32), engine="scan",
        )

    lowered = jax.jit(fn).trace(scene, config.dynamic_part()).lower(
        lowering_platforms=("cuda",)
    )
    assert seen and not any(seen)
    assert "triton" in lowered.as_text()


@pytest.mark.gpu
def test_scan_on_the_card_matches_brute(gpu, scenes):
    """The compiled kernel (no interpret mode) at a full 1280x720 frame
    of camera rays; chip_smoke.py phase (e) runs the same check."""
    from rustic.config import TracingConfig
    from rustic.utils.compare import compare_scan_to_brute

    r = compare_scan_to_brute(scenes["DarkCornell.glb"], TracingConfig(width=1280, height=720))
    assert r["hit_mismatch_unexplained"] == 0 and r["occ_mismatch_unexplained"] == 0
    assert r["hit_mismatch"] + r["occ_mismatch"] <= 1e-5 * r["rays"]
    assert r["idx_diff_untied"] == 0 and r["t_out_of_tol"] == 0


def test_ambiguous_rays_flags_grazing_candidates(scenes):
    """The mismatch explainer of compare_scan_to_brute: a ray through a
    triangle's edge is decided by rounding, one through its centroid is
    not."""
    from rustic.utils.compare import _ambiguous_rays

    scene = scenes["FurnaceTest.glb"]
    pos = np.asarray(scene.positions, np.float64)
    a, b, c = pos[np.asarray(scene.tri_vidx)[0]]
    normal = np.cross(b - a, c - a)
    normal /= np.linalg.norm(normal)
    targets = np.stack([(a + b) / 2, (a + b + c) / 3])
    ro = targets + normal * 0.5
    rd = np.tile(-normal, (2, 1))
    flags = _ambiguous_rays(scene, ro, rd, np.full(2, 1e6))
    assert flags.tolist() == [True, False]
