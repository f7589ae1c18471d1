import numpy as np
import jax.numpy as jnp

from rustic.ops import rng


def test_lds_range_and_determinism():
    n = jnp.arange(4096, dtype=jnp.uint32)
    for dim in [0, 1, 5, 31, 33]:
        v = np.asarray(rng.lds(n, dim, jnp.uint32(12345)))
        assert v.min() >= 0.0 and v.max() < 1.0
        v2 = np.asarray(rng.lds(n, dim, jnp.uint32(12345)))
        np.testing.assert_array_equal(v, v2)


def test_lds_dimension_table():
    """128-entry extended table: dims wrap at 128 (not 32 — a 32-dim
    wrap collided bounce-3 draws with the AA jitter dims), the first 32
    entries stay bit-identical to the reference's baked constants
    (reference: kernels/src/rng.rs:21-26), and the extension follows
    the same frac(sqrt(prime)) * 2^32 construction."""
    n = jnp.arange(64, dtype=jnp.uint32)
    a = np.asarray(rng.lds(n, 1, jnp.uint32(7)))
    b = np.asarray(rng.lds(n, 33, jnp.uint32(7)))
    assert not np.array_equal(a, b)  # the old mod-32 collision is gone
    c = np.asarray(rng.lds(n, 5, jnp.uint32(7)))
    d = np.asarray(rng.lds(n, 5 + rng.LDS_MAX_DIMENSIONS, jnp.uint32(7)))
    np.testing.assert_array_equal(c, d)  # wraps at the table size

    assert rng.LDS_MAX_DIMENSIONS == 128
    assert int(rng._LDS_PRIMES[0]) == 0x6A09E667  # sqrt(2), reference[0]
    assert int(rng._LDS_PRIMES[31]) == 0x720DCDFC  # reference[31]
    # entry 32 = frac(sqrt(137)) * 2^32, exactly
    import math

    assert int(rng._LDS_PRIMES[32]) == (math.isqrt(137 << 64) & 0xFFFFFFFF)


def test_lds_equidistribution():
    # An additive-recurrence sequence should cover [0,1) uniformly.
    n = jnp.arange(1 << 14, dtype=jnp.uint32)
    v = np.asarray(rng.lds(n, 3, jnp.uint32(0)))
    hist, _ = np.histogram(v, bins=16, range=(0, 1))
    assert hist.min() > 0.8 * (len(v) / 16)
    assert abs(v.mean() - 0.5) < 0.01


def test_pcg_hash_matches_numpy_twin():
    x = np.arange(1000, dtype=np.uint32) * np.uint32(2654435761)
    a = np.asarray(rng.pcg_hash(jnp.asarray(x)))
    b = rng.pcg_hash_np(x)
    np.testing.assert_array_equal(a, b)


def test_pcg_hash_spreads():
    h = rng.pcg_hash_np(np.arange(1 << 14, dtype=np.uint32))
    assert len(np.unique(h)) > (1 << 14) * 0.999
    assert abs(h.astype(np.float64).mean() / 2**32 - 0.5) < 0.01


class TestBlueNoise:
    """The committed void-and-cluster seed table (tools/make_bluenoise.py)
    — the analog of the reference's bluenoise.png offsets
    (src/trace.rs:149-160)."""

    def test_table_is_permutation(self):
        from rustic.runtime.render import _bluenoise_table

        t = _bluenoise_table()
        assert t is not None and t.shape == (128, 128)
        assert t.dtype == np.uint32
        # ranks/N * 2^32: all values distinct and uniformly spread
        assert len(np.unique(t)) == t.size
        u = np.sort(t.reshape(-1).astype(np.float64)) / 2**32
        np.testing.assert_allclose(u, np.arange(t.size) / t.size, atol=1e-9)

    def test_spectrum_is_blue(self):
        """Low-frequency energy must be suppressed well below white
        noise: that's the property that makes per-pixel seed offsets
        turn sample error into high-frequency (visually uniform)
        noise."""
        from rustic.runtime.render import _bluenoise_table

        t = _bluenoise_table().astype(np.float64) / 2**32 - 0.5
        f = np.abs(np.fft.fft2(t)) ** 2
        f[0, 0] = 0.0
        n = t.shape[0]
        fy = np.minimum(np.arange(n), n - np.arange(n))
        r = np.hypot(fy[:, None], fy[None, :])
        lo = f[(r > 0) & (r <= n / 16)].mean()
        hi = f[r >= n / 4].mean()
        assert lo < 0.2 * hi, (lo, hi)

    def test_pixel_offsets_tile(self):
        from rustic.runtime.render import _bluenoise_table, pixel_offsets

        t = _bluenoise_table()
        off = pixel_offsets(300, 200, use_blue_noise=True).reshape(200, 300)
        assert off[0, 0] == t[0, 0]
        assert off[5, 130] == t[5, 2]  # tiles with period 128
        assert off[131, 7] == t[3, 7]
