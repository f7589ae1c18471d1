import numpy as np
import jax.numpy as jnp
import pytest

from rustic.config import Tonemapping
from rustic.ops.tonemap import apply_tonemap


@pytest.mark.parametrize("op", list(Tonemapping))
def test_black_stays_black(op):
    out = np.asarray(apply_tonemap(jnp.zeros((4, 3)), op))
    np.testing.assert_allclose(out, 0.0, atol=1e-3)


@pytest.mark.parametrize(
    "op",
    [
        Tonemapping.REINHARD,
        Tonemapping.ACES_NARKOWICZ,
        Tonemapping.NEUTRAL,
        Tonemapping.UNCHARTED2,
    ],
)
def test_monotone_and_bounded(op):
    x = jnp.linspace(0.0, 20.0, 256)[:, None].repeat(3, axis=1)
    y = np.asarray(apply_tonemap(x, op, gamma_encode=False))[:, 0]
    assert np.all(np.diff(y) >= -1e-5)
    assert y.max() < 1.5


def test_none_is_identity_before_gamma():
    x = jnp.asarray([[0.25, 0.5, 1.0]])
    y = np.asarray(apply_tonemap(x, Tonemapping.NONE, gamma_encode=False))
    np.testing.assert_allclose(y, np.asarray(x), atol=1e-7)


def test_gamma_encode():
    x = jnp.asarray([[0.5, 0.5, 0.5]])
    y = np.asarray(apply_tonemap(x, Tonemapping.NONE))
    np.testing.assert_allclose(y, 0.5 ** (1 / 2.2), atol=1e-5)


def test_aces_hill_neutral_for_gray():
    x = jnp.full((1, 3), 0.18)
    y = np.asarray(apply_tonemap(x, Tonemapping.ACES_HILL, gamma_encode=False))
    assert np.abs(y - y.mean()).max() < 0.01  # stays near-achromatic


def test_aces_narkowicz_pre_exposure():
    """The default ACES applies x0.6 pre-exposure (render.wgsl:136);
    the overexposed variant is the bare curve (:139-140)."""
    import jax.numpy as jnp

    from rustic.config import Tonemapping

    x = jnp.full((1, 3), 1.0)
    default = np.asarray(
        apply_tonemap(x, Tonemapping.ACES_NARKOWICZ, gamma_encode=False)
    )
    over = np.asarray(
        apply_tonemap(
            x, Tonemapping.ACES_NARKOWICZ_OVEREXPOSED, gamma_encode=False
        )
    )
    assert (default < over).all()
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    v = 0.6
    expect = (v * (a * v + b)) / (v * (c * v + d) + e)
    np.testing.assert_allclose(default, expect, rtol=1e-6)


def _np_reference(op, x):
    """float64 NumPy twins of the operators (render.wgsl:36-117)."""
    def narkowicz(v):
        return np.clip((v * (2.51 * v + 0.03)) / (v * (2.43 * v + 0.59) + 0.14), 0, 1)

    def curve(v, a, b, c, d, e, f):
        return ((v * (a * v + c * b) + d * e) / (v * (a * v + b) + d * f)) - e / f

    if op == Tonemapping.NONE:
        return x
    if op == Tonemapping.REINHARD:
        return x / (x + 1.0)
    if op == Tonemapping.ACES_NARKOWICZ:
        return narkowicz(x * 0.6)
    if op == Tonemapping.ACES_NARKOWICZ_OVEREXPOSED:
        return narkowicz(x)
    if op == Tonemapping.ACES_HILL:
        m_in = np.array([[0.59719, 0.35458, 0.04823], [0.07600, 0.90834, 0.01566],
                         [0.02840, 0.13383, 0.83777]])
        m_out = np.array([[1.60475, -0.53108, -0.07367], [-0.10208, 1.10813, -0.00605],
                          [-0.00327, -0.07276, 1.07602]])
        c = x @ m_in.T
        c = (c * (c + 0.0245786) - 0.000090537) / (c * (0.983729 * c + 0.4329510) + 0.238081)
        return np.clip(c @ m_out.T, 0, 1)
    if op == Tonemapping.NEUTRAL:
        k = (0.2, 0.29, 0.24, 0.272, 0.02, 0.3)
        ws = 1.0 / curve(5.3, *k)
        return curve(x * ws, *k) * ws
    uc = (0.15, 0.50, 0.10, 0.20, 0.02, 0.30)
    return curve(x * 2.0, *uc) / curve(11.2, *uc)


@pytest.mark.parametrize("op", list(Tonemapping))
def test_matches_float64_reference(op):
    """Each operator, including ACES Hill's 3x3 colour matrices (pinned
    to full f32, not TF32), agrees with float64 NumPy to f32 rounding."""
    x = np.random.default_rng(int(op)).uniform(0.0, 8.0, (64, 3))
    got = np.asarray(apply_tonemap(jnp.asarray(x, jnp.float32), op, gamma_encode=False))
    np.testing.assert_allclose(got, _np_reference(op, x), rtol=2e-5, atol=2e-6)
