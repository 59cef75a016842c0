"""Encoding roundtrip and slot-rotation semantics."""

import numpy as np

from image_matching.ckks import encoding as enc

RNG = np.random.default_rng(2)
N = 128


def test_encode_decode_roundtrip():
    z = RNG.normal(size=(3, N // 2))
    scale = 2.0 ** 40
    coeffs = enc.encode(z, N, scale)
    back = enc.decode(coeffs, N, scale)
    np.testing.assert_allclose(back, z, atol=1e-8)


def test_galois_5_rotates_left():
    """m(X) -> m(X^{5^r}) must rotate slots left by r."""
    z = np.arange(N // 2, dtype=np.float64)
    scale = 2.0 ** 40
    a = enc.encode(z, N, scale)[0]
    for r in (1, 3, 7):
        g = pow(5, r, 2 * N)
        b = np.zeros(N, dtype=np.int64)
        for j in range(N):
            e = (j * g) % (2 * N)
            if e < N:
                b[e] += a[j]
            else:
                b[e - N] -= a[j]
        back = enc.decode(b.astype(np.float64), N, scale)
        np.testing.assert_allclose(back, np.roll(z, -r), atol=1e-6)


def test_rns_roundtrip_fast_and_exact():
    from image_matching.ckks.params import find_primes_near

    primes2 = find_primes_near(1 << 28, 2 * N, 2)
    primes4 = find_primes_near(1 << 28, 2 * N, 4)
    c = RNG.integers(-(1 << 40), 1 << 40, size=(2, N)).astype(np.int64)
    for primes in (primes2, primes4):
        r = enc.to_rns(c, primes)
        back = enc.from_rns_centered(r, primes)
        np.testing.assert_array_equal(back, c.astype(np.float64))


def test_constant_encodes_to_constant_poly():
    z = np.full(N // 2, 1.5)
    coeffs = enc.encode(z, N, 2.0 ** 20)[0]
    assert abs(coeffs[0] - 1.5 * 2 ** 20) <= 1
    assert np.all(np.abs(coeffs[1:]) <= 1)
