"""Unit tests for uint32 modular arithmetic vs python-int oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from image_matching.ops import modmath as mm
from image_matching.ckks.params import find_primes_near

RNG = np.random.default_rng(0)


def _rand(n, hi):
    return RNG.integers(0, hi, size=n, dtype=np.uint64).astype(np.uint32)


def test_mul32_wide():
    a = _rand(4096, 1 << 32)
    b = _rand(4096, 1 << 32)
    hi, lo = mm.mul32_wide(jnp.asarray(a), jnp.asarray(b))
    prod = a.astype(np.uint64) * b.astype(np.uint64)
    np.testing.assert_array_equal(np.asarray(hi), (prod >> 32).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), (prod & 0xFFFFFFFF).astype(np.uint32))


EDGE32 = [0, 1, 0xFFFF, 0x10000, (1 << 31) - 1, (1 << 32) - 1]


@pytest.mark.parametrize("a", EDGE32)
@pytest.mark.parametrize("b", [0, 1, (1 << 32) - 1])
def test_mul32_wide_edges(a, b):
    hi, lo = mm.mul32_wide(jnp.asarray([a], jnp.uint32),
                           jnp.asarray([b], jnp.uint32))
    prod = a * b
    assert int(hi[0]) == prod >> 32 and int(lo[0]) == prod & 0xFFFFFFFF


_Q30 = find_primes_near(1 << 30, 2048, 1)[0]


@pytest.mark.parametrize("a", [0, 1, _Q30 - 1, (1 << 32) - 1])
@pytest.mark.parametrize("b", [0, 1, _Q30 - 1])
def test_mont_mul_edges(a, b):
    """mont_mul(a, b) = a * b * R^-1 mod q for a < 2^32, b < q."""
    qneg_inv = mm.host_mont_constants(_Q30)[0]
    out = mm.mont_mul(jnp.asarray([a], jnp.uint32), jnp.asarray([b], jnp.uint32),
                      jnp.uint32(_Q30), jnp.uint32(qneg_inv))
    assert int(out[0]) == a * b * pow(1 << 32, -1, _Q30) % _Q30


def test_mont_mul_roundtrip():
    for q in [find_primes_near(1 << b, 2048, 1)[0] for b in (28, 30)] + [(1 << 31) - 1]:
        if not q % 2:
            continue
        qneg_inv, r1, r2, _ = mm.host_mont_constants(q)
        a = _rand(2048, q)
        b = _rand(2048, q)
        am = mm.host_to_mont(a, q)
        bm = mm.host_to_mont(b, q)
        out = mm.mont_mul(
            jnp.asarray(am), jnp.asarray(bm), jnp.uint32(q), jnp.uint32(qneg_inv)
        )
        expect = a.astype(np.uint64) * b.astype(np.uint64) % np.uint64(q)
        got = mm.host_from_mont(np.asarray(out), q)
        np.testing.assert_array_equal(got, expect.astype(np.uint32))


def test_shoup_mul():
    q = find_primes_near(1 << 29, 2048, 1)[0]
    a = _rand(2048, q)
    w = np.uint32(RNG.integers(0, q))
    w_sh = mm.host_shoup(np.array(w, dtype=np.uint32), q)
    out = mm.shoup_mul(jnp.asarray(a), jnp.uint32(w), jnp.uint32(w_sh), jnp.uint32(q))
    expect = a.astype(np.uint64) * np.uint64(w) % np.uint64(q)
    np.testing.assert_array_equal(np.asarray(out), expect.astype(np.uint32))


def test_add_sub_neg():
    q = find_primes_near(1 << 30, 2048, 1)[0]
    a = _rand(1024, q)
    b = _rand(1024, q)
    np.testing.assert_array_equal(
        np.asarray(mm.mod_add(jnp.asarray(a), jnp.asarray(b), jnp.uint32(q))),
        ((a.astype(np.uint64) + b) % q).astype(np.uint32),
    )
    np.testing.assert_array_equal(
        np.asarray(mm.mod_sub(jnp.asarray(a), jnp.asarray(b), jnp.uint32(q))),
        ((a.astype(np.int64) - b.astype(np.int64)) % q).astype(np.uint32),
    )
    np.testing.assert_array_equal(
        np.asarray(mm.mod_neg(jnp.asarray(a), jnp.uint32(q))),
        ((-a.astype(np.int64)) % q).astype(np.uint32),
    )


def test_reduce_small():
    for q in (find_primes_near(1 << 27, 2048, 1)[0], find_primes_near(1 << 30, 2048, 1)[0]):
        x = RNG.integers(0, min(16 * q, 1 << 31), size=2048, dtype=np.int64).astype(np.uint32)
        out = mm.reduce_small(jnp.asarray(x), jnp.uint32(q))
        np.testing.assert_array_equal(np.asarray(out), (x.astype(np.uint64) % q).astype(np.uint32))


def test_mont_dot():
    q = find_primes_near(1 << 28, 2048, 1)[0]
    qneg_inv, _, _, _ = mm.host_mont_constants(q)
    p16 = jnp.asarray(mm.host_pow16_mont(q))
    K, n = 512, 8
    a = _rand(K * n, q).reshape(K, n)
    b = _rand(K * n, q).reshape(K, n)
    am = mm.host_to_mont(a, q)
    bm = mm.host_to_mont(b, q)
    out = mm.mont_dot(
        jnp.asarray(am), jnp.asarray(bm), 0, jnp.uint32(q), jnp.uint32(qneg_inv), p16
    )
    got = mm.host_from_mont(np.asarray(out), q)
    expect = np.array(
        [
            sum(int(a[k, j]) * int(b[k, j]) for k in range(K)) % q
            for j in range(n)
        ],
        dtype=np.uint32,
    )
    np.testing.assert_array_equal(got, expect)
