"""Display tonemapping operators.

Capability parity with the reference's WGSL display shader
(reference: src/resources/render.wgsl:36-117, selected by the
Tonemapping enum in src/app.rs:18-42). Applied as a jnp post-op on the
averaged film; the final pow(1/2.2) gamma encode matches
render.wgsl fs_main.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from rustic.config import Tonemapping


def reinhard(x):
    return x / (x + 1.0)


def _aces_narkowicz_curve(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def aces_narkowicz(x):
    """The reference's default ACES applies a 0.6 pre-exposure
    (render.wgsl:136); the 'overexposed' variant omits it (:139-140)."""
    return _aces_narkowicz_curve(x * 0.6)


def aces_narkowicz_overexposed(x):
    return _aces_narkowicz_curve(x)


_ACES_INPUT = jnp.asarray(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    jnp.float32,
)
_ACES_OUTPUT = jnp.asarray(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    jnp.float32,
)


# The 3x3 colour matrices run at full f32: at default precision a GPU
# may round the operands to TF32 (~3 decimal digits).
_HIGHEST = lax.Precision.HIGHEST


def aces_hill(x):
    color = jnp.matmul(x, _ACES_INPUT.T, precision=_HIGHEST)
    a = color * (color + 0.0245786) - 0.000090537
    b = color * (0.983729 * color + 0.4329510) + 0.238081
    color = a / b
    color = jnp.matmul(color, _ACES_OUTPUT.T, precision=_HIGHEST)
    return jnp.clip(color, 0.0, 1.0)


def _neutral_curve(x, a, b, c, d, e, f):
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def neutral(x):
    a, b, c, d, e, f = 0.2, 0.29, 0.24, 0.272, 0.02, 0.3
    white_level, white_clip = 5.3, 1.0
    white_scale = 1.0 / _neutral_curve(jnp.float32(white_level), a, b, c, d, e, f)
    x = _neutral_curve(x * white_scale, a, b, c, d, e, f)
    x = x * white_scale
    return x / white_clip


def _uncharted_partial(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


def uncharted2(x):
    exposure_bias = 2.0
    curr = _uncharted_partial(x * exposure_bias)
    white_scale = 1.0 / _uncharted_partial(jnp.float32(11.2))
    return curr * white_scale


_OPS = {
    Tonemapping.NONE: lambda x: x,
    Tonemapping.REINHARD: reinhard,
    Tonemapping.ACES_NARKOWICZ: aces_narkowicz,
    Tonemapping.ACES_NARKOWICZ_OVEREXPOSED: aces_narkowicz_overexposed,
    Tonemapping.ACES_HILL: aces_hill,
    Tonemapping.NEUTRAL: neutral,
    Tonemapping.UNCHARTED2: uncharted2,
}


def apply_tonemap(hdr: jnp.ndarray, op: Tonemapping, gamma_encode: bool = True):
    """Map linear HDR radiance to display. With gamma_encode, applies the
    pow(1/2.2) encode the reference display shader performs after the
    operator (render.wgsl:120-155)."""
    out = _OPS[Tonemapping(op)](hdr)
    if gamma_encode:
        out = jnp.power(jnp.maximum(out, 0.0), 1.0 / 2.2)
    return out
