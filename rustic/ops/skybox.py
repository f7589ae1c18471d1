"""Sky radiance: single-scattering procedural atmosphere + HDR equirect.

Capability parity with the reference sky (reference: kernels/src/skybox.rs
for the Rayleigh+Mie march; kernels/src/lib.rs:66-79 for the equirect
image path). Fully batched over rays; the 12-step march is a static
Python loop, unrolled by XLA into straight-line vector code.
"""

from __future__ import annotations

import jax.numpy as jnp

from rustic.ops.sampling import dot, mask_nan
from rustic.ops.texture import sample_bilinear

# (reference: kernels/src/skybox.rs:8-16).
_RAY_COEFF = (58e-7, 135e-7, 331e-7)
_MIE_SCATTER = 2e-5
_MIE_EFFECTIVE = 2e-5 * 1.1
_EARTH_RADIUS = 6360e3
_ATMOSPHERE_RADIUS = 6380e3
_H_RAY = 8e3
_H_MIE = 12e2
_STEPS = 12  # reference: kernels/src/skybox.rs:80


def _escape(p, d, r):
    """Distance to sphere of radius r about the earth center (at
    (0, -R_earth, 0)), -1 if none (reference: kernels/src/skybox.rs:18-32)."""
    vx = p[..., 0]
    vy = p[..., 1] + _EARTH_RADIUS
    vz = p[..., 2]
    b = vx * d[..., 0] + vy * d[..., 1] + vz * d[..., 2]
    det = b * b - (vx * vx + vy * vy + vz * vz) + r * r
    sq = jnp.sqrt(jnp.maximum(det, 0.0))
    t1 = -b - sq
    t2 = -b + sq
    t = jnp.where(t1 >= 0.0, t1, t2)
    # t2 can still be negative (origin outside the sphere, facing away);
    # the reference returns it unchecked too (skybox.rs:31) — parity.
    return jnp.where(det < 0.0, -1.0, t)


def _densities_rm(p):
    vx = p[..., 0]
    vy = p[..., 1] + _EARTH_RADIUS
    vz = p[..., 2]
    h = jnp.maximum(jnp.sqrt(vx * vx + vy * vy + vz * vz) - _EARTH_RADIUS, 0.0)
    return jnp.exp(-h / _H_RAY), jnp.exp(-h / _H_MIE)


def _scatter_depth_int(o, d, l, r0, m0):
    """Trapezoid optical depth along the sun ray. (r0, m0) are the
    densities at `o`, which every caller has already computed — reusing
    them drops 2 exp + 1 sqrt per march step, bit-exactly."""
    r1, m1 = _densities_rm(o + d * l[..., None])
    return r0 * (l / 2.0) + r1 * (l / 2.0), m0 * (l / 2.0) + m1 * (l / 2.0)


def procedural_sky(sun_direction: jnp.ndarray, ro: jnp.ndarray, rd: jnp.ndarray):
    """Rayleigh+Mie single-scattering sky (reference: kernels/src/skybox.rs:46-94).

    Args:
      sun_direction: [4] — xyz direction, w intensity.
      ro, rd: [..., 3] ray origin/direction.
    """
    sundir = jnp.broadcast_to(sun_direction[:3], rd.shape)
    depth = _escape(ro, rd, _ATMOSPHERE_RADIUS) / _STEPS

    i_r = [jnp.zeros(rd.shape[:-1], jnp.float32) for _ in range(3)]
    i_m = [jnp.zeros(rd.shape[:-1], jnp.float32) for _ in range(3)]
    total_r = jnp.zeros(rd.shape[:-1], jnp.float32)
    total_m = jnp.zeros(rd.shape[:-1], jnp.float32)
    for i in range(_STEPS):
        p = ro + rd * (depth * i)[..., None]
        r0, m0 = _densities_rm(p)
        dr = r0 * depth
        dm = m0 * depth
        total_r = total_r + dr
        total_m = total_m + dm
        sr, sm = _scatter_depth_int(
            p, sundir, _escape(p, sundir, _ATMOSPHERE_RADIUS), r0, m0
        )
        depth_r = total_r + sr
        depth_m = total_m + sm
        for c in range(3):
            a = jnp.exp(-_RAY_COEFF[c] * depth_r - _MIE_EFFECTIVE * depth_m)
            i_r[c] = i_r[c] + a * dr
            i_m[c] = i_m[c] + a * dm

    mu = dot(rd, sundir)
    # phase^1.5 written as x*sqrt(x)
    ph = jnp.maximum(1.58 - 1.52 * mu, 1e-6)
    phase_mie = 0.0196 / (ph * jnp.sqrt(ph))
    scale = sun_direction[3] * (1.0 + mu * mu)
    res = jnp.stack(
        [
            scale
            * (i_r[c] * _RAY_COEFF[c] * 0.0597 + i_m[c] * _MIE_SCATTER * phase_mie)
            for c in range(3)
        ],
        axis=-1,
    )
    # sqrt-then-pow(2.2) gamma juggle, NaN masked
    # (reference: kernels/src/skybox.rs:93); x^2.2 = x^2 * x^0.2 with
    # x^0.2 = exp(0.2*log x) guarded at zero.
    g = mask_nan(jnp.sqrt(jnp.maximum(res, 0.0)))
    safe = jnp.maximum(g, 1e-20)
    return jnp.where(g > 0.0, jnp.exp(2.2 * jnp.log(safe)), 0.0)


def image_sky(
    skybox: jnp.ndarray, sun_direction: jnp.ndarray, rd: jnp.ndarray
) -> jnp.ndarray:
    """Equirect HDR skybox with sun-rotation-aligned mapping and the
    reference's 1/15 intensity normalization (kernels/src/lib.rs:71-77)."""
    rotation = jnp.arctan2(sun_direction[2], sun_direction[0])
    cosr = jnp.cos(rotation)
    sinr = jnp.sin(rotation)
    # Mat3::from_rotation_y(rotation) applied to rd
    x = cosr * rd[..., 0] + sinr * rd[..., 2]
    y = rd[..., 1]
    z = -sinr * rd[..., 0] + cosr * rd[..., 2]
    u = 0.5 + jnp.arctan2(z, x) / (2.0 * jnp.pi)
    v = 1.0 - (0.5 + jnp.arcsin(jnp.clip(y, -1.0, 1.0)) / jnp.pi)
    uv = jnp.stack([u, v], axis=-1)
    intensity = sun_direction[3] * (1.0 / 15.0)
    # wrap_x: the azimuth seam must interpolate across u = 0/1 (a clamp
    # leaves an unfiltered vertical line at the wrap longitude)
    return sample_bilinear(skybox, uv, wrap_x=True)[..., :3] * intensity


def sky_radiance(scene, has_skybox: bool, sun_direction, ro, rd):
    """Dispatch procedural vs image sky (static has_skybox, like the
    reference's config.has_skybox branch, kernels/src/lib.rs:66-78)."""
    if has_skybox:
        return image_sky(scene.skybox, sun_direction, rd)
    return procedural_sky(sun_direction, ro, rd)
