"""The stdlib PNG codec, the NumPy Lanczos resize and the SceneArrays
pytree: the pieces that keep the main path on jax, numpy and the
standard library. Pillow, where installed, serves as the reference."""

import dataclasses
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rustic.utils.png import decode_png, encode_png, read_image_rgba, to_rgba_float


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (13, 21, channels)).astype(np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decodes_what_pillow_writes(mode):
    """Pillow chooses its own scanline filters (Sub, Up, Average,
    Paeth); the decoder must undo each exactly, and read_image_rgba must
    equal Pillow's convert("RGBA")."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.integers(0, 9, (24, 31, 4)), axis=1).astype(np.uint8)
    if mode == "P":
        pil = Image.fromarray(base[..., :3], "RGB").quantize(17)
    else:
        arr = {"RGB": base[..., :3], "RGBA": base, "L": base[..., 0], "LA": base[..., :2]}[mode]
        pil = Image.fromarray(arr, mode)
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    data = buf.getvalue()
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.float32) / 255.0
    np.testing.assert_array_equal(read_image_rgba(data), ref)


def test_png_gray_expands_to_opaque_rgba():
    img = np.array([[[0], [255]]], np.uint8)
    out = to_rgba_float(img)
    np.testing.assert_array_equal(out, [[[0, 0, 0, 1], [1, 1, 1, 1]]])


def test_saved_png_reads_back(tmp_path):
    from rustic.config import Tonemapping
    from rustic.utils.image_io import film_to_u8, save_png

    film = np.random.default_rng(1).uniform(0, 2, (9, 16, 3)).astype(np.float32)
    path = str(tmp_path / "f.png")
    save_png(path, film, Tonemapping.ACES_NARKOWICZ)
    with open(path, "rb") as f:
        got = decode_png(f.read())
    np.testing.assert_array_equal(got, film_to_u8(film, Tonemapping.ACES_NARKOWICZ))


@pytest.mark.parametrize(
    "src,dst,opaque",
    [((8, 8), (32, 32), True), ((13, 7), (5, 20), False), ((64, 32), (16, 8), False)],
)
def test_lanczos_matches_pillow(src, dst, opaque):
    """The atlas resize is bit-identical to Pillow's LANCZOS resize, so
    textured renders (and the committed films) do not depend on which
    of the two ran."""
    Image = pytest.importorskip("PIL.Image")
    from rustic.scene.atlas import _resize_lanczos

    rng = np.random.default_rng(sum(src))
    u8 = rng.integers(0, 256, src + (4,)).astype(np.uint8)
    if opaque:
        u8[..., 3] = 255
    ref = Image.fromarray(u8, "RGBA").resize(dst[::-1], Image.LANCZOS)
    got = _resize_lanczos(u8.astype(np.float32) / 255.0, dst[1], dst[0])
    np.testing.assert_array_equal(got, np.asarray(ref, np.float32) / 255.0)


def test_scene_arrays_pytree(cornell_scene):
    """Arrays are leaves; the static fields ride as aux data, so they
    survive a round trip and select the compiled program."""
    from rustic.scene.world import SceneArrays

    leaves, treedef = jax.tree_util.tree_flatten(cornell_scene)
    assert all(isinstance(x, jax.Array) for x in leaves)
    assert len(leaves) == len(
        [f for f in SceneArrays.__dataclass_fields__ if f not in SceneArrays.STATIC_FIELDS]
    )
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.n_tris == cornell_scene.n_tris and back.has_lights
    doubled = jax.tree_util.tree_map(lambda x: x * 2, cornell_scene)
    np.testing.assert_array_equal(
        np.asarray(doubled.positions), 2 * np.asarray(cornell_scene.positions)
    )

    traces = []

    @jax.jit
    def count(scene):
        traces.append(scene.n_tris)
        return jnp.sum(scene.positions)

    count(cornell_scene)
    count(doubled)  # same static fields: no retrace
    assert traces == [cornell_scene.n_tris]
    count(dataclasses.replace(cornell_scene, n_tris=1))  # new aux: retrace
    assert traces == [cornell_scene.n_tris, 1]


def test_scene_arrays_device_put(cornell_scene):
    cpu = jax.devices("cpu")[1]
    moved = jax.device_put(cornell_scene, cpu)
    assert moved.positions.devices() == {cpu}
    assert moved.n_nodes == cornell_scene.n_nodes
