"""Packed-table layout guards.

The intersection engines and the shading stage communicate through packed
rows (ATTR_*/ENTRY_* in scene/world.py). These tests pin every column against
the unpacked source arrays so a silent layout drift cannot survive CI.
Plus end-to-end determinism: the sampler is a pure function, so renders
must be bit-identical across runs.
"""

import numpy as np

from rustic.scene import world as W


def test_attr_rows_match_source_arrays(cornell_world):
    w = cornell_world
    tris = w.triangles
    n = len(tris)
    attrs = w.tri_attrs
    vi = tris[:, :3]
    mi = tris[:, 3]
    np.testing.assert_array_equal(
        attrs[:n, W.ATTR_POS], w.positions[vi].reshape(n, 9)
    )
    np.testing.assert_array_equal(
        attrs[:n, W.ATTR_NRM], w.normals[vi].reshape(n, 9)
    )
    np.testing.assert_array_equal(
        attrs[:n, W.ATTR_TAN], w.tangents[vi].reshape(n, 9)
    )
    np.testing.assert_array_equal(attrs[:n, W.ATTR_UV], w.uv0[vi].reshape(n, 6))
    np.testing.assert_array_equal(attrs[:n, W.ATTR_EMISSIVE], w.mat_emissive[mi])
    np.testing.assert_array_equal(attrs[:n, W.ATTR_ALBEDO], w.mat_albedo[mi])
    np.testing.assert_array_equal(attrs[:n, W.ATTR_ROUGH], w.mat_roughness[mi])
    np.testing.assert_array_equal(attrs[:n, W.ATTR_METAL], w.mat_metallic[mi])
    np.testing.assert_array_equal(
        attrs[:n, W.ATTR_HASTEX], w.mat_has_tex[mi].astype(np.float32)
    )
    assert attrs.shape == (n, W.ATTR_WIDTH)


def test_entry_rows_match_light_table(cornell_world):
    w = cornell_world
    lt = w.light_table
    rows = w.entry_rows
    n = len(lt)
    np.testing.assert_allclose(rows[:n, W.ENTRY_AREA_A], lt.area_a)
    np.testing.assert_allclose(rows[:n, W.ENTRY_PDF_A], lt.pdf_a)
    np.testing.assert_allclose(rows[:n, W.ENTRY_RATIO], lt.ratio)
    vi = w.triangles[:, :3]
    for side, idx in (("A", lt.idx_a), ("B", lt.idx_b)):
        gi = idx.astype(np.int64)
        verts = w.positions[vi[gi]].reshape(n, 9)
        sl = W.ENTRY_A_VERTS if side == "A" else W.ENTRY_B_VERTS
        np.testing.assert_allclose(rows[:n, sl], verts)
        tri_col = W.ENTRY_A_TRI if side == "A" else W.ENTRY_B_TRI
        np.testing.assert_array_equal(rows[:n, tri_col].astype(np.int64), gi)


def test_render_is_deterministic(cornell_scene):
    from rustic.config import NextEventEstimation, RenderSettings, TracingConfig
    from rustic.runtime.render import render_image

    cfg = TracingConfig(width=16, height=16, nee=NextEventEstimation.MIS, max_bounces=2)
    a = render_image(cornell_scene, cfg, RenderSettings(samples=3))
    b = render_image(cornell_scene, cfg, RenderSettings(samples=3))
    np.testing.assert_array_equal(a, b)


def test_gather_attr_rows_matches_row_index(cornell_scene):
    """The shading path's one indexed fetch returns exactly the hit
    triangle's packed row."""
    import jax.numpy as jnp

    from rustic.ops.intersect import gather_attr_rows

    scene = cornell_scene
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, scene.n_tris, 257), jnp.int32)
    rows = np.asarray(gather_attr_rows(scene, idx))
    np.testing.assert_array_equal(rows, np.asarray(scene.tri_attrs)[np.asarray(idx)])
