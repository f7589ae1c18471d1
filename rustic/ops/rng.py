"""Low-discrepancy sampling (R2-style LDS) and hashing.

Capability parity with the reference sampler (reference:
kernels/src/rng.rs:20-63): a pure function of
(sample_index n, dimension, per-pixel offset), so CPU and GPU renders
are deterministic and reproducible — no stateful RNG anywhere.

Wavefront difference: instead of a mutable RngState struct threaded
through the kernel, dimensions are assigned *statically* per draw site
(each stage of each bounce owns fixed dimensions), so the whole batch
consumes the same dimension at the same program point — lockstep-friendly
and still a proper (0,1)-ish low-discrepancy stream per pixel.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Square roots of primes as 0.32 fixed point — frac(sqrt(p_k)) * 2^32,
# the classic R2-style additive-recurrence multipliers (reference:
# kernels/src/rng.rs:21-26, originally from shadertoy NlGXzz; the first
# 8 are the SHA-256 H constants). The reference bakes 32 entries and
# indexes them directly (panicking past ~4 bounces, rng.rs:19,31); our
# static per-draw-site assignment reserves 8 dims per bounce, so 32
# entries would wrap bounce-3 draws onto the AA-jitter dims (exact,
# systematic correlation). The table is therefore extended with the
# same construction, sized for 15 bounces, keeping the reference's 32
# baked values verbatim for bit parity on the dims it can express.


def _sqrt_prime_fixed(count: int) -> np.ndarray:
    """First `count` entries of floor(frac(sqrt(prime_k)) * 2^32),
    computed exactly via integer sqrt (no float rounding)."""
    import math

    primes = []
    n = 2
    while len(primes) < count:
        if all(n % p for p in primes if p * p <= n):
            primes.append(n)
        n += 1
    # floor(sqrt(p) * 2^32) = isqrt(p << 64); its low 32 bits are the
    # fractional part in 0.32 fixed point.
    return np.array(
        [math.isqrt(p << 64) & 0xFFFFFFFF for p in primes], dtype=np.uint32
    )


LDS_MAX_DIMENSIONS = 128
# Dims 0..31: the reference's table verbatim (bit parity — its values
# carry the original shadertoy's float rounding, so they differ from
# the exact construction by 1-2 ulp and two transcription quirks).
_REFERENCE_PRIMES = np.array(
    [
        0x6A09E667, 0xBB67AE84, 0x3C6EF372, 0xA54FF539,
        0x510E527F, 0x9B05688A, 0x1F83D9AB, 0x5BE0CD18,
        0xCBBB9D5C, 0x629A2929, 0x91590159, 0x452FECD8,
        0x67332667, 0x8EB44A86, 0xDB0C2E0B, 0x47B5481D,
        0xAE5F9155, 0xCF6C85D1, 0x2F73477D, 0x6D1826CA,
        0x8B43D455, 0xE360B595, 0x1C456002, 0x6F196330,
        0xD94EBEAF, 0x9CC4A611, 0x261DC1F2, 0x5815A7BD,
        0x70B7ED67, 0xA1513C68, 0x44F93634, 0x720DCDFC,
    ],
    dtype=np.uint32,
)
# Dims 32+: exactly-constructed continuation (primes 137, 139, ...).
_LDS_PRIMES = np.concatenate(
    [_REFERENCE_PRIMES, _sqrt_prime_fixed(LDS_MAX_DIMENSIONS)[32:]]
)

_INV_U32 = np.float32(1.0 / 4294967296.0)


def lds(n, dimension: int, offset):
    """R2 low-discrepancy value in [0, 1).

    frac(prime[dim] * (n + offset)) computed in u32 wraparound arithmetic
    (reference: kernels/src/rng.rs:29-32).

    Args:
      n: uint32 array — sample index (the reference's rng.state.x).
      dimension: static python int — draw-site dimension (wrapped mod
        LDS_MAX_DIMENSIONS=128; the default 8-dims-per-bounce layout
        stays collision-free through 15 bounces).
      offset: uint32 array broadcastable to n — per-pixel decorrelation
        offset (the reference's rng.state.y).
    """
    prime = jnp.uint32(int(_LDS_PRIMES[dimension % LDS_MAX_DIMENSIONS]))
    n = n.astype(jnp.uint32)
    offset = jnp.asarray(offset, jnp.uint32)
    bits = prime * (n + offset)
    return bits.astype(jnp.float32) * _INV_U32


def pcg_hash(x):
    """PCG output-function hash of a u32 (reference: kernels/src/rng.rs:4-17).

    Used to seed per-pixel offsets in 'uniform' seeding mode (the
    reference uses host rand::thread_rng; we use a reproducible hash of
    the pixel id instead so renders are deterministic end-to-end).
    """
    x = jnp.asarray(x, jnp.uint32)
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) * jnp.uint32(
        277803737
    )
    return (word >> jnp.uint32(22)) ^ word


def pcg_hash_np(x: np.ndarray) -> np.ndarray:
    """NumPy twin of pcg_hash for host-side seeding."""
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        state = x * np.uint32(747796405) + np.uint32(2891336453)
        word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * np.uint32(
            277803737
        )
    return (word >> np.uint32(22)) ^ word
