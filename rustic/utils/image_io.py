"""Image output: tonemapped PNG and raw EXR/NPY export.

The analog of the reference's PNG save path (reference:
src/app.rs:759-844 re-renders offscreen and swizzles BGRA; we simply
tonemap the film and write it).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from rustic.config import Tonemapping
from rustic.ops.tonemap import apply_tonemap


def film_to_u8(film: np.ndarray, tonemap: Tonemapping = Tonemapping.NONE) -> np.ndarray:
    """Linear film [H, W, 3] -> display u8 with tonemap + gamma encode."""
    mapped = np.asarray(apply_tonemap(jnp.asarray(film), tonemap))
    return (np.clip(mapped, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, film: np.ndarray, tonemap: Tonemapping = Tonemapping.NONE):
    from rustic.utils.png import write_png

    write_png(path, film_to_u8(film, tonemap))


def save_hdr(path: str, film: np.ndarray):
    """Raw linear radiance. .npy always works; .exr via imageio if the
    plugin is present (gracefully falls back to .npy next to it)."""
    if path.endswith(".npy"):
        np.save(path, film.astype(np.float32))
        return
    if path.endswith(".hdr"):
        from rustic.utils.hdr import write_hdr

        write_hdr(path, np.asarray(film, np.float32))
        return
    try:
        import imageio.v3 as iio

        iio.imwrite(path, film.astype(np.float32))
    except Exception:
        np.save(path + ".npy", film.astype(np.float32))
