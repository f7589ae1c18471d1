"""Radiance RGBE (.hdr) codec (utils/hdr.py).

The reference loads .hdr skyboxes natively (reference:
src/asset.rs:238-255); these tests pin our decoder against the format's
precision model (shared exponent => <=1/256 relative error), the
new-style RLE scanline encoding, and the skybox-loading entry point.
"""

import numpy as np
import pytest

from rustic.utils.hdr import _float_to_rgbe, read_hdr, write_hdr


def test_roundtrip_precision(tmp_path):
    rng = np.random.default_rng(7)
    # radiance spanning 8 decades, incl. zeros
    img = (rng.random((6, 16, 3)) * 10.0 ** rng.integers(-4, 4, (6, 16, 1))).astype(
        np.float32
    )
    img[0, 0] = 0.0
    path = str(tmp_path / "t.hdr")
    write_hdr(path, img)
    back = read_hdr(path)
    assert back.shape == img.shape
    v = img.max(axis=-1, keepdims=True)
    np.testing.assert_array_equal(back[0, 0], 0.0)  # zeros exact
    # shared-exponent quantization: error <= max_component / 256 + tiny
    assert np.all(np.abs(back - img) <= v / 256.0 + 1e-30)


def test_rle_scanlines_decode(tmp_path):
    """Hand-encode a new-style RLE file: a 16-wide scanline whose
    components mix runs and literals."""
    width, height = 16, 2
    rows = np.zeros((height, width, 4), np.uint8)
    rows[:, :, 0] = 100  # constant red mantissa
    rows[0, :, 1] = np.arange(16)  # ramp green
    rows[1, :, 1] = 7
    rows[:, :, 2] = 0
    rows[:, :, 3] = 128  # exponent: scale 2^-8

    payload = bytearray()
    for y in range(height):
        payload += bytes([2, 2, width >> 8, width & 0xFF])
        # red: one run of 16
        payload += bytes([128 + 16, 100])
        # green: literals (row 0) or run (row 1)
        if y == 0:
            payload += bytes([16]) + bytes(range(16))
        else:
            payload += bytes([128 + 16, 7])
        # blue + exponent: runs
        payload += bytes([128 + 16, 0])
        payload += bytes([128 + 16, 128])
    path = str(tmp_path / "rle.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {height} +X {width}\n".encode())
        f.write(bytes(payload))

    img = read_hdr(path)
    expect = rows.astype(np.float32)
    expect = expect[..., :3] * np.float32(2.0 ** (128 - 136))
    np.testing.assert_allclose(img, expect)


def test_old_style_repeat_shift(tmp_path):
    """(1,1,1,n) repeats the previous pixel n<<shift times."""
    width = 6
    px = bytes([10, 20, 30, 130])
    payload = px + bytes([1, 1, 1, 5])  # 1 pixel + repeat x5
    path = str(tmp_path / "old.hdr")
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y 1 +X {width}\n".encode())
        f.write(payload)
    img = read_hdr(path)
    assert img.shape == (1, width, 3)
    np.testing.assert_allclose(img, np.broadcast_to(img[0, :1][None], img.shape))
    np.testing.assert_allclose(
        img[0, 0], np.array([10, 20, 30], np.float32) * 2.0 ** (130 - 136)
    )


def test_skybox_loader_keeps_radiance(tmp_path):
    """load_skybox_image('.hdr') must preserve >1 radiance values (the
    old imageio path silently tonemapped to uint8 0-255)."""
    from rustic.scene.world import load_skybox_image

    img = np.full((4, 8, 3), 37.5, np.float32)
    path = str(tmp_path / "sky.hdr")
    write_hdr(path, img)
    sky = load_skybox_image(path)
    assert sky.shape == (4, 8, 4)
    np.testing.assert_allclose(sky[..., :3], img, rtol=1 / 128)
    np.testing.assert_allclose(sky[..., 3], 1.0)


def test_reject_non_hdr(tmp_path):
    p = tmp_path / "x.hdr"
    p.write_bytes(b"PNG not really")
    with pytest.raises(ValueError):
        read_hdr(str(p))


def test_encoder_bytes_match_convention():
    # 1.0 -> v = 1.0 = 0.5 * 2^1 -> e=129, mantissa byte 128
    rgbe = _float_to_rgbe(np.array([[[1.0, 0.5, 0.25]]], np.float32))
    assert rgbe[0, 0, 3] == 129
    assert rgbe[0, 0, 0] == 128 and rgbe[0, 0, 1] == 64 and rgbe[0, 0, 2] == 32
