import numpy as np
import jax.numpy as jnp

from rustic.scene.light_table import (
    build_light_table,
    compute_emissive_mask,
    triangle_areas,
)


def _quad_scene():
    # Two emissive triangles of different area + one dark triangle.
    verts = np.array(
        [
            [0, 0, 0], [1, 0, 0], [0, 1, 0],          # area 0.5, emissive (1,1,1)
            [2, 0, 0], [4, 0, 0], [2, 2, 0],          # area 2.0, emissive (2,2,2)
            [5, 0, 0], [6, 0, 0], [5, 1, 0],          # dark
        ],
        np.float32,
    )
    tris = np.array([[0, 1, 2, 0], [3, 4, 5, 1], [6, 7, 8, 2]], np.int64)
    emissive = np.array([[1, 1, 1], [2, 2, 2], [0, 0, 0]], np.float32)
    return verts, tris, emissive


def test_triangle_areas_heron():
    a = np.array([[0.0, 0, 0]])
    b = np.array([[1.0, 0, 0]])
    c = np.array([[0.0, 1, 0]])
    np.testing.assert_allclose(triangle_areas(a, b, c), 0.5, atol=1e-6)


def test_emissive_mask():
    verts, tris, emissive = _quad_scene()
    mask = compute_emissive_mask(tris, emissive)
    np.testing.assert_array_equal(mask, [True, True, False])


def test_sentinel_when_no_lights():
    verts, tris, _ = _quad_scene()
    emissive = np.zeros((3, 3), np.float32)
    t = build_light_table(verts, tris, compute_emissive_mask(tris, emissive), emissive)
    assert t.is_sentinel and len(t) == 1


def test_pick_pdfs_sum_to_one():
    verts, tris, emissive = _quad_scene()
    t = build_light_table(verts, tris, compute_emissive_mask(tris, emissive), emissive)
    assert not t.is_sentinel
    # Powers: tri0 = 3*0.5 = 1.5, tri1 = 6*2 = 12; probabilities 1.5/13.5, 12/13.5
    np.testing.assert_allclose(sorted(t.pdf_a), sorted([1.5 / 13.5, 12 / 13.5]), atol=1e-6)


def test_alias_sampling_matches_pdf(cornell_scene):
    """Empirical pick frequency through the device-side alias sampler
    must match the stored per-triangle probability."""
    from rustic.ops.nee import pick_light

    scene = cornell_scene
    n = 1 << 16
    rng = np.random.default_rng(0)
    r1 = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    r2 = jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))
    idx, area, pdf = pick_light(scene, r1, r2)
    idx = np.asarray(idx)
    pdf = np.asarray(pdf)
    counts = {}
    for i in idx:
        counts[int(i)] = counts.get(int(i), 0) + 1
    for tri, cnt in counts.items():
        expected = pdf[idx == tri][0]
        assert abs(cnt / n - expected) < 0.02, (tri, cnt / n, expected)


def test_single_light():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2, 0]], np.int64)
    emissive = np.array([[5, 5, 5]], np.float32)
    t = build_light_table(verts, tris, np.array([True]), emissive)
    assert not t.is_sentinel
    np.testing.assert_allclose(t.pdf_a, [1.0])
    np.testing.assert_allclose(t.ratio, [1.0])


def test_unequal_powers_unbiased():
    """The effective pick distribution through the alias table must
    equal the stored pdfs exactly — the adversarial case for the
    reference's early-break construction (its effective distribution
    diverges for unequal powers, e.g. [.05,.05,.3,.6] picks as
    [.05,.05,.25,.65] while contributions divide by the stored pdf)."""
    # Four unit-ish triangles, powers 0.05/0.05/0.3/0.6 via emissive.
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0]], np.float64)
    verts = np.concatenate([base + [3 * k, 0, 0] for k in range(4)])
    tris = np.array(
        [[3 * k, 3 * k + 1, 3 * k + 2, k] for k in range(4)], np.int64
    )
    emissive = np.array(
        [[0.05, 0, 0], [0.05, 0, 0], [0.3, 0, 0], [0.6, 0, 0]], np.float32
    )
    mask = compute_emissive_mask(tris, emissive)
    t = build_light_table(verts, tris, mask, emissive)
    assert not t.is_sentinel

    n_bins = len(t.ratio)
    effective = {}
    for i in range(n_bins):
        effective[int(t.idx_a[i])] = (
            effective.get(int(t.idx_a[i]), 0.0) + float(t.ratio[i]) / n_bins
        )
        effective[int(t.idx_b[i])] = (
            effective.get(int(t.idx_b[i]), 0.0)
            + (1.0 - float(t.ratio[i])) / n_bins
        )
    target = {0: 0.05, 1: 0.05, 2: 0.3, 3: 0.6}
    for tri, p in target.items():
        assert abs(effective.get(tri, 0.0) - p) < 1e-6, (tri, effective)
        # the stored pdf (what contributions divide by) matches too
        stored = [
            float(t.pdf_a[i]) for i in range(n_bins) if int(t.idx_a[i]) == tri
        ]
        assert stored and abs(stored[0] - p) < 1e-6
