"""Chebyshev series / power-basis PS evaluation and the hybrid compare."""

import numpy as np
import pytest

from image_matching.ckks.params import SchemeParams
from image_matching.ckks.context import CkksContext
from image_matching.ckks import poly_eval as pe

RNG = np.random.default_rng(5)


@pytest.fixture(scope="module")
def ctx():
    params = SchemeParams.create(ring_dim=512, mult_depth=10, security="none")
    c = CkksContext(params, seed=11)
    c.gen_power_of_two_rotation_keys()
    return c


def test_cheb_coefficients_reproduce_function():
    coeffs = pe.chebyshev_coefficients(np.sin, 15)
    xs = np.linspace(-1, 1, 101)
    tv = np.polynomial.chebyshev.chebval(xs, coeffs)
    np.testing.assert_allclose(tv, np.sin(xs), atol=1e-9)


def test_cheb_divmod_identity():
    c = list(RNG.normal(size=60))
    q, r = pe._cheb_divmod(list(c), 32)
    xs = np.linspace(-1, 1, 57)
    lhs = np.polynomial.chebyshev.chebval(xs, c)
    rhs = (
        np.polynomial.chebyshev.chebval(xs, q)
        * np.polynomial.chebyshev.chebval(xs, [0] * 32 + [1])
        + np.polynomial.chebyshev.chebval(xs, r)
    )
    np.testing.assert_allclose(lhs, rhs, atol=1e-9)


def test_eval_chebyshev_series_smooth(ctx):
    z = RNG.uniform(-1, 1, size=ctx.slots)
    ct = ctx.encrypt(z, scale=ctx.params.scale)
    coeffs = pe.chebyshev_coefficients(np.sin, 27)
    out = pe.eval_chebyshev_series(ctx, ct, coeffs)
    got = ctx.decrypt(out)
    np.testing.assert_allclose(got, np.sin(z), atol=5e-3)


def test_eval_poly_ps_f4(ctx):
    z = RNG.uniform(-1, 1, size=ctx.slots)
    ct = ctx.encrypt(z, scale=ctx.params.scale)
    out = pe.eval_poly_ps(ctx, ct, pe.F4_COEFS)
    expect = np.polyval(pe.F4_COEFS[::-1], z)
    got = ctx.decrypt(out)
    # depth 4 at degree 9
    assert ct.limbs - out.limbs == 4
    np.testing.assert_allclose(got, expect, atol=5e-3)


def test_chebyshev_compare(ctx):
    delta = 0.44
    z = RNG.uniform(-1, 1, size=ctx.slots)
    z[:8] = [0.3, 0.42, 0.46, 0.6, 0.9, -0.9, 0.0, 1.0]
    ct = ctx.encrypt(z, scale=ctx.params.scale)
    out = pe.chebyshev_compare(ctx, ct, delta, sign_depth=10)
    got = ctx.decrypt(out)
    # exactly COMP_DEPTH = 10 levels consumed
    assert ct.limbs - out.limbs == 10
    expect = np.where(z >= delta, 2.0, 0.0)
    margin = np.abs(z - delta) > 0.03
    np.testing.assert_allclose(got[margin], expect[margin], atol=0.05)
    # decision rule of the receivers: flag >= 1.0
    assert np.all((got[margin] >= 1.0) == (z[margin] >= delta))