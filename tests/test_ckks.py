"""CKKS scheme correctness on small (insecure) test parameters."""

import numpy as np
import pytest

from image_matching.ckks.params import SchemeParams
from image_matching.ckks.context import CkksContext

RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def ctx():
    params = SchemeParams.create(
        ring_dim=512, mult_depth=6, scale_bits=28, first_mod_bits=30,
        dnum=3, security="none",
    )
    c = CkksContext(params, seed=42)
    c.gen_power_of_two_rotation_keys()
    return c


def _rand_slots(ctx, lo=-1.0, hi=1.0):
    return RNG.uniform(lo, hi, size=ctx.slots)


def test_encrypt_decrypt(ctx):
    z = _rand_slots(ctx)
    ct = ctx.encrypt(z)
    back = ctx.decrypt(ct)
    np.testing.assert_allclose(back, z, atol=1e-5)


def test_add_sub(ctx):
    a, b = _rand_slots(ctx), _rand_slots(ctx)
    ca, cb = ctx.encrypt(a), ctx.encrypt(b)
    np.testing.assert_allclose(ctx.decrypt(ctx.add(ca, cb)), a + b, atol=1e-5)
    np.testing.assert_allclose(ctx.decrypt(ctx.sub(ca, cb)), a - b, atol=1e-5)
    np.testing.assert_allclose(ctx.decrypt(ctx.add_scalar(ca, 0.5)), a + 0.5, atol=1e-5)


def test_mul_relin_rescale(ctx):
    a, b = _rand_slots(ctx), _rand_slots(ctx)
    ca, cb = ctx.encrypt(a), ctx.encrypt(b)
    prod = ctx.rescale(ctx.mul_relin(ca, cb))
    assert prod.limbs == ca.limbs - 1
    np.testing.assert_allclose(ctx.decrypt(prod), a * b, atol=1e-4)


def test_mul_no_relin_decrypts(ctx):
    a, b = _rand_slots(ctx), _rand_slots(ctx)
    prod = ctx.mul(ctx.encrypt(a), ctx.encrypt(b))  # 3 components
    np.testing.assert_allclose(ctx.decrypt(ctx.rescale(prod)), a * b, atol=1e-4)


def test_square(ctx):
    a = _rand_slots(ctx)
    sq = ctx.rescale(ctx.relinearize(ctx.square(ctx.encrypt(a))))
    np.testing.assert_allclose(ctx.decrypt(sq), a * a, atol=1e-4)


def test_mul_plain_and_scalar(ctx):
    a, m = _rand_slots(ctx), _rand_slots(ctx)
    ca = ctx.encrypt(a)
    pt = ctx.encode(m, ca.limbs, ctx.params.scale)
    out = ctx.rescale(ctx.mul_plain(ca, pt))
    np.testing.assert_allclose(ctx.decrypt(out), a * m, atol=1e-4)
    out2 = ctx.rescale(ctx.mul_scalar(ca, 0.44, ctx.params.scale))
    np.testing.assert_allclose(ctx.decrypt(out2), a * 0.44, atol=1e-4)
    out3 = ctx.mul_scalar_int(ca, 3)
    np.testing.assert_allclose(ctx.decrypt(out3), a * 3, atol=1e-4)


def test_depth_chain(ctx):
    """Iterated squarings to the guard level stay accurate."""
    a = RNG.uniform(0.5, 1.0, size=ctx.slots)
    ct = ctx.encrypt(a)
    val = a * a
    ct = ctx.rescale_score(ctx.relinearize(ctx.square(ct)))
    for _ in range(ctx.params.mult_depth - 1):
        ct = ctx.rescale(ctx.relinearize(ctx.square(ct)))
        val = val * val
    assert ct.limbs == 2
    np.testing.assert_allclose(ctx.decrypt(ct), val, atol=1e-3)


def test_rotate(ctx):
    a = np.arange(ctx.slots, dtype=np.float64) / ctx.slots
    ca = ctx.encrypt(a)
    for r in (1, 2, 16, -4):
        out = ctx.decrypt(ctx.rotate(ca, r))
        np.testing.assert_allclose(out, np.roll(a, -r), atol=1e-4)


def test_binary_rotate(ctx):
    a = np.arange(ctx.slots, dtype=np.float64) / ctx.slots
    ca = ctx.encrypt(a)
    for r in (3, 7, -5, 100):
        out = ctx.decrypt(ctx.binary_rotate(ca, r))
        np.testing.assert_allclose(out, np.roll(a, -r), atol=1e-4)


def test_hoisted_rotations(ctx):
    ctx.gen_rotation_keys(list(range(1, 8)))
    a = np.arange(ctx.slots, dtype=np.float64) / ctx.slots
    ca = ctx.encrypt(a)
    digs = ctx.hoisted_precompute(ca)
    for r in (1, 3, 7):
        out = ctx.decrypt(ctx.hoisted_rotate(ca, digs, r))
        np.testing.assert_allclose(out, np.roll(a, -r), atol=1e-4)


def test_eval_sum(ctx):
    a = _rand_slots(ctx)
    ca = ctx.encrypt(a)
    out = ctx.decrypt(ctx.eval_sum(ca, ctx.slots))
    np.testing.assert_allclose(out, np.full(ctx.slots, a.sum()), atol=1e-3)
    # blockwise sum: slot j = sum a[j..j+7]
    out8 = ctx.decrypt(ctx.eval_sum(ca, 8))
    expect = np.array([a[np.arange(j, j + 8) % ctx.slots].sum() for j in range(ctx.slots)])
    np.testing.assert_allclose(out8, expect, atol=1e-3)


def test_align_to(ctx):
    a = _rand_slots(ctx)
    ca = ctx.encrypt(a)
    tgt_scale = ctx.params.scale * 1.37
    out = ctx.align_to(ca, ca.limbs - 2, tgt_scale)
    assert out.limbs == ca.limbs - 2
    assert abs(out.scale - tgt_scale) < 1e-6 * tgt_scale
    np.testing.assert_allclose(ctx.decrypt(out), a, atol=1e-4)


def test_add_after_mult_exact_scales(ctx):
    a, b, c = _rand_slots(ctx), _rand_slots(ctx), _rand_slots(ctx)
    ab = ctx.rescale(ctx.mul_relin(ctx.encrypt(a), ctx.encrypt(b)))
    cc = ctx.align_to(ctx.encrypt(c), ab.limbs, ab.scale)
    np.testing.assert_allclose(ctx.decrypt(ctx.add(ab, cc)), a * b + c, atol=1e-4)
