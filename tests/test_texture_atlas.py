import numpy as np
import jax.numpy as jnp

from rustic.ops.texture import sample_atlas, sample_bilinear
from rustic.scene.atlas import pack_textures


def test_bilinear_exact_texel_centers():
    img = jnp.asarray(
        np.arange(16, dtype=np.float32).reshape(4, 4, 1).repeat(4, axis=-1)
    )
    # uv hitting the exact texel grid point (x+0,y+0 scaled) has frac 0
    uv = jnp.asarray([[0.25, 0.5]])  # scaled = (1.0, 2.0) -> texel (1,2)
    out = np.asarray(sample_bilinear(img, uv))
    np.testing.assert_allclose(out[0, 0], img[2, 1, 0], atol=1e-5)


def test_bilinear_interpolates():
    img = jnp.zeros((2, 2, 4)).at[0, 1].set(1.0)
    uv = jnp.asarray([[0.75, 0.25]])  # scaled (1.5, 0.5): between texels
    out = np.asarray(sample_bilinear(img, uv))
    assert 0.2 < out[0, 0] < 1.0


def test_bilinear_clamps_at_edges():
    img = jnp.asarray(np.ones((4, 4, 4), np.float32))
    uv = jnp.asarray([[-0.5, 1.7], [2.0, -3.0]])
    out = np.asarray(sample_bilinear(img, uv))
    np.testing.assert_allclose(out, 1.0, atol=1e-6)


def test_atlas_roundtrip_single_texture():
    """Pack one constant texture; sampling through the uvst rect must
    return the original texel values."""
    tex = np.zeros((8, 8, 4), np.float32)
    tex[:] = [0.2, 0.4, 0.6, 1.0]
    atlas, sts = pack_textures([tex], 64, 64)
    out = np.asarray(
        sample_atlas(jnp.asarray(atlas), jnp.asarray(sts[0]), jnp.asarray([[0.5, 0.5]]))
    )
    np.testing.assert_allclose(out[0], [0.2, 0.4, 0.6, 1.0], atol=2e-2)


def test_atlas_vertical_flip():
    """The packer flips textures vertically (reference: src/atlas.rs:85),
    so uv.y = 0 samples the texture's *bottom* row."""
    tex = np.zeros((8, 8, 4), np.float32)
    tex[0, :] = 1.0  # top row of the source image
    atlas, sts = pack_textures([tex], 64, 64)
    top = np.asarray(
        sample_atlas(jnp.asarray(atlas), jnp.asarray(sts[0]), jnp.asarray([[0.5, 0.97]]))
    )
    bottom = np.asarray(
        sample_atlas(jnp.asarray(atlas), jnp.asarray(sts[0]), jnp.asarray([[0.5, 0.03]]))
    )
    assert top[0, 0] > 0.8 and bottom[0, 0] < 0.2


def test_atlas_multiple_textures_disjoint():
    texs = []
    for v in [0.25, 0.5, 0.75, 1.0, 0.1]:
        t = np.full((16, 16, 4), v, np.float32)
        texs.append(t)
    atlas, sts = pack_textures(texs, 128, 128)
    assert len(sts) == 5
    for v, uvst in zip([0.25, 0.5, 0.75, 1.0, 0.1], sts):
        mid = np.asarray(
            sample_atlas(jnp.asarray(atlas), jnp.asarray(uvst), jnp.asarray([[0.5, 0.5]]))
        )
        np.testing.assert_allclose(mid[0, 0], v, atol=2e-2)


def test_atlas_taps_stay_in_cell():
    """Bilinear taps at uv=1.0 must NOT blend the neighboring cell's
    texels (the reference bleeds there — quadtree cells have no gutter)."""
    import jax.numpy as jnp

    from rustic.ops.texture import sample_atlas

    # 8x8 atlas: left half red cell, right half green cell.
    atlas = np.zeros((8, 8, 4), np.float32)
    atlas[:, :4, 0] = 1.0
    atlas[:, 4:, 1] = 1.0
    uvst = jnp.asarray([[0.0, 0.0, 0.5, 1.0]], jnp.float32)  # left cell
    for u in (0.999, 1.0):
        uv = jnp.asarray([[u, 0.5]], jnp.float32)
        c = np.asarray(sample_atlas(jnp.asarray(atlas), uvst, uv))[0]
        assert c[0] == 1.0 and c[1] == 0.0, (u, c)


def test_material_atlas_colocated_channels():
    """pack_material_textures: every map of a material lands at the
    SAME rect, each in its channel group, bilinear-equal to packing
    that map alone with the per-texture packer (round-5 gather fix)."""
    import jax.numpy as jnp

    from rustic.ops.texture import sample_atlas
    from rustic.scene.atlas import (
        CH_ALBEDO,
        CH_METAL,
        CH_NORMAL,
        CH_ROUGH,
        pack_material_textures,
        pack_textures,
    )

    rng = np.random.default_rng(3)
    albedo = rng.random((16, 16, 4)).astype(np.float32)
    metal = rng.random((8, 8, 4)).astype(np.float32)
    normal = rng.random((16, 16, 4)).astype(np.float32)
    mats = [
        {"albedo": albedo, "metallic": metal, "roughness": None,
         "normal": normal},
        {"albedo": None, "metallic": None, "roughness": None,
         "normal": None},
    ]
    atlas, uvsts = pack_material_textures(mats, 64, 64)
    assert atlas.shape[-1] == 9
    assert uvsts[0] is not None and uvsts[1] is None

    uv = jnp.asarray(rng.random((32, 2)), jnp.float32)
    rect = jnp.broadcast_to(jnp.asarray(uvsts[0]), (32, 4))
    rows = np.asarray(sample_atlas(jnp.asarray(atlas), rect, uv))

    for tex, ch, width in (
        (albedo, CH_ALBEDO, 4), (metal, slice(CH_METAL, CH_METAL + 1), 1),
        (normal, CH_NORMAL, 3),
    ):
        solo_atlas, solo_sts = pack_textures([tex], 64, 64)
        # the solo packer gives the single texture the whole square;
        # repack at the material cell's size for an exact comparison
        x = int(round(float(uvsts[0][0]) * 64))
        y = int(round(float(uvsts[0][1]) * 64))
        w = int(round(float(uvsts[0][2]) * 64))
        h = int(round(float(uvsts[0][3]) * 64))
        from rustic.scene.atlas import _resize_lanczos

        expect_cell = _resize_lanczos(tex, w, h)[::-1]
        np.testing.assert_array_equal(
            atlas[y : y + h, x : x + w, ch], expect_cell[..., :width]
        )
        got = rows[..., ch]
        assert np.isfinite(got).all()


def test_equirect_seam_interpolates():
    """The azimuth wrap must blend the first and last panorama columns
    instead of clamping (no vertical seam line)."""
    import jax.numpy as jnp

    from rustic.ops.texture import sample_bilinear

    img = np.zeros((4, 8, 3), np.float32)
    img[:, 0] = [1.0, 0.0, 0.0]
    img[:, -1] = [0.0, 1.0, 0.0]
    # u just below 1: taps must be columns 7 and 0 (wrapped), blending
    u = (7.5 / 8.0) + (0.25 / 8.0)  # quarter way from col 7 to col 0
    c = np.asarray(
        sample_bilinear(
            jnp.asarray(img), jnp.asarray([[u, 0.5]], jnp.float32), wrap_x=True
        )
    )[0]
    assert c[1] > 0.0 and c[0] > 0.0  # both seam columns contribute
    np.testing.assert_allclose(c[0] + c[1], 1.0, atol=1e-6)
