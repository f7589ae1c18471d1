"""Vectorized sampling & shading math.

Capability parity with the reference's util module (reference:
kernels/src/util.rs), re-expressed as batched jnp ops: every function
takes arrays shaped [..., 3] (or scalars broadcast over [...]) so the
whole wavefront is processed per call — no per-pixel scalar code.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-3  # (reference: kernels/src/util.rs:5)
PI = float(jnp.pi)  # plain float: array constants cannot be captured by kernels


def dot(a, b):
    # Unrolled over the 3 components instead of jnp.sum(a*b, -1): a
    # reduce op can split the enclosing elementwise fusion, while slices
    # + adds fuse through. Association matches the reduction's
    # ((a0b0 + a1b1) + a2b2).
    return (
        a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
    ) + a[..., 2] * b[..., 2]


def dotk(a, b):
    """Dot product, keepdims — convenient for broadcasting against [...,3]."""
    return dot(a, b)[..., None]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def length(v):
    return jnp.sqrt(dot(v, v))


def normalize(v, eps: float = 1e-20):
    return v * jnp.reciprocal(jnp.maximum(length(v), eps))[..., None]


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def uniform_sample_hemisphere(r1, r2):
    """y-up local hemisphere (reference: kernels/src/util.rs:16-22)."""
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - r1 * r1, 0.0))
    phi = 2.0 * PI * r2
    return jnp.stack(
        [sin_theta * jnp.cos(phi), r1, sin_theta * jnp.sin(phi)], axis=-1
    )


def cosine_sample_hemisphere(r1, r2):
    """Cosine-weighted y-up local hemisphere (reference: kernels/src/util.rs:24-32)."""
    cos_theta = jnp.sqrt(jnp.maximum(r1, 0.0))
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))
    phi = 2.0 * PI * r2
    return jnp.stack(
        [sin_theta * jnp.cos(phi), cos_theta, sin_theta * jnp.sin(phi)], axis=-1
    )


def create_cartesian(up):
    """Orthonormal basis about `up` — returns (up, right, forward).

    Matches the reference's fixed arbitrary vector so sampled directions
    agree between backends (reference: kernels/src/util.rs:34-40).
    """
    ax, ay, az = 0.1, 0.5, 0.9
    ux, uy, uz = up[..., 0], up[..., 1], up[..., 2]
    temp = normalize(
        jnp.stack(
            [uy * az - uz * ay, uz * ax - ux * az, ux * ay - uy * ax],
            axis=-1,
        )
    )
    right = normalize(cross(temp, up))
    forward = normalize(cross(up, right))
    return up, right, forward


def local_to_world(local, up, right, forward):
    """Express a y-up local sample in the (up, right, forward) frame.

    Matches the reference frame contraction x->forward, y->up, z->right
    (reference: kernels/src/bsdf.rs:76-80).
    """
    return normalize(
        local[..., 0:1] * forward + local[..., 1:2] * up + local[..., 2:3] * right
    )


def reflect(i, n):
    """Mirror reflect incident `i` about normal (reference: kernels/src/util.rs:42-44)."""
    return i - n * 2.0 * dotk(i, n)


def refract(i, n, in_ior, out_ior):
    """Snell refraction; zero vector on TIR (reference: kernels/src/util.rs:47-56)."""
    eta = in_ior / out_ior
    n_dot_i = dotk(n, i)
    k = 1.0 - eta * eta * (1.0 - n_dot_i * n_dot_i)
    refr = eta * i - (eta * n_dot_i + jnp.sqrt(jnp.maximum(k, 0.0))) * n
    return jnp.where(k < 0.0, 0.0, refr)


def ggx_distribution(n, h, roughness):
    """GGX NDF with alpha = roughness^2 (reference: kernels/src/util.rs:58-64)."""
    a2 = roughness * roughness
    n_dot_h = jnp.maximum(dot(n, h), 0.0)
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    denom = jnp.maximum(PI * denom * denom, EPS)
    return a2 / denom


def sample_ggx(r1, r2, reflection_direction, roughness):
    """Karis GGX sampling about the reflection direction
    (reference: kernels/src/util.rs:67-85; Karis 2013 Epic notes)."""
    a = roughness * roughness
    phi = 2.0 * PI * r1
    cos_theta = jnp.sqrt(
        jnp.maximum((1.0 - r2) / (r2 * (a * a - 1.0) + 1.0), 0.0)
    )
    sin_theta = jnp.sqrt(jnp.maximum(1.0 - cos_theta * cos_theta, 0.0))
    h_local = jnp.stack(
        [jnp.cos(phi) * sin_theta, jnp.sin(phi) * sin_theta, cos_theta], axis=-1
    )
    take_z = jnp.abs(reflection_direction[..., 2]) < 0.999
    zero = jnp.zeros_like(take_z, jnp.float32)
    up = jnp.stack(
        [jnp.where(take_z, 0.0, 1.0), zero, jnp.where(take_z, 1.0, 0.0)],
        axis=-1,
    )
    tangent = normalize(cross(up, reflection_direction))
    bitangent = cross(reflection_direction, tangent)
    return normalize(
        tangent * h_local[..., 0:1]
        + bitangent * h_local[..., 1:2]
        + reflection_direction * h_local[..., 2:3]
    )


def sample_ggx_microsurface_normal(r1, r2, macro_normal, roughness):
    """Walter-style GGX microfacet-normal sampling for dielectrics
    (reference: kernels/src/util.rs:117-139; EGSR07 eq. 35-36)."""
    a_g = roughness * roughness
    theta_m = jnp.arctan(
        (a_g * jnp.sqrt(r1)) / jnp.sqrt(jnp.maximum(1.0 - r1, 1e-20))
    )
    phi_m = 2.0 * PI * r2
    m_local = jnp.stack(
        [
            jnp.sin(theta_m) * jnp.cos(phi_m),
            jnp.cos(theta_m),
            jnp.sin(theta_m) * jnp.sin(phi_m),
        ],
        axis=-1,
    )
    up, right, forward = create_cartesian(macro_normal)
    return local_to_world(m_local, up, right, forward)


def geometry_schlick_ggx(n, v, roughness):
    """Schlick-GGX masking term (reference: kernels/src/util.rs:211-216)."""
    n_dot_v = jnp.maximum(dot(n, v), 0.0)
    r = (roughness * roughness) / 8.0
    return n_dot_v / (n_dot_v * (1.0 - r) + r)


def geometry_smith_schlick_ggx(n, v, l, roughness):
    """Smith geometry via Schlick-GGX (reference: kernels/src/util.rs:219-227)."""
    return geometry_schlick_ggx(n, v, roughness) * geometry_schlick_ggx(
        n, l, roughness
    )


def fresnel_schlick(cos_theta, f0):
    """Schlick fresnel, vector f0 (reference: kernels/src/util.rs:229-231)."""
    ct = jnp.clip(cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (1.0 - ct[..., None]) ** 5


def fresnel_schlick_scalar(in_ior, out_ior, cos_theta):
    """Schlick fresnel, scalar ior pair (reference: kernels/src/util.rs:233-236)."""
    f0 = ((in_ior - out_ior) / (in_ior + out_ior)) ** 2
    ct = jnp.clip(cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * (1.0 - ct) ** 5


def barycentric(p, a, b, c):
    """Barycentric coords of p in triangle abc (reference: kernels/src/util.rs:238-251)."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = dot(v0, v0)
    d01 = dot(v0, v1)
    d11 = dot(v1, v1)
    d20 = dot(v2, v0)
    d21 = dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    inv = jnp.reciprocal(jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom))
    v = (d11 * d20 - d01 * d21) * inv
    w = (d00 * d21 - d01 * d20) * inv
    return jnp.stack([1.0 - v - w, v, w], axis=-1)


def power_heuristic(p1, p2):
    """Power heuristic MIS weight (reference: kernels/src/util.rs:253-256)."""
    p1_2 = p1 * p1
    return p1_2 / jnp.maximum(p1_2 + p2 * p2, 1e-20)


def balance_heuristic(p1, p2):
    return p1 / jnp.maximum(p1 + p2, 1e-20)


def expand_mask(m):
    """[...] bool -> [..., 1] bool."""
    return m[..., None]


def mask_nan(v):
    """Zero out non-finite radiance — NaN containment on every accumulate
    (reference: kernels/src/util.rs:271-277)."""
    f = jnp.isfinite(v)
    finite = f[..., 0] & f[..., 1] & f[..., 2]
    return jnp.where(expand_mask(finite), v, 0.0)
