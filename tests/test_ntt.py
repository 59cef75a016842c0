"""NTT correctness: roundtrip, negacyclic convolution, automorphisms."""

import numpy as np
import jax.numpy as jnp

from image_matching.ops import modmath as mm
from image_matching.ops import ntt as nttmod
from image_matching.ckks.params import find_primes_near, root_of_unity

RNG = np.random.default_rng(1)
N = 64


def _plan():
    primes = find_primes_near(1 << 28, 2 * N, 3)
    roots = [root_of_unity(q, 2 * N) for q in primes]
    return nttmod.NttPlan(N, primes, roots), primes


def _to_mont_stack(coeffs, primes):
    """int64 [..., N] -> mont uint32 [..., L, N]"""
    out = np.stack(
        [mm.host_to_mont(np.mod(coeffs, q).astype(np.uint32), q) for q in primes],
        axis=-2,
    )
    return jnp.asarray(out)


def _from_mont_stack(arr, primes):
    arr = np.asarray(arr)
    return np.stack(
        [mm.host_from_mont(arr[..., i, :], q) for i, q in enumerate(primes)], axis=-2
    )


def test_roundtrip():
    plan, primes = _plan()
    limbs = tuple(range(len(primes)))
    a = RNG.integers(0, 1 << 20, size=(2, len(primes), N)).astype(np.int64)
    am = _to_mont_stack(a[:, 0, :], primes)  # same coeffs per limb
    out = plan.inv(plan.fwd(am, limbs), limbs)
    got = _from_mont_stack(out, primes)
    for i, q in enumerate(primes):
        np.testing.assert_array_equal(got[:, i, :], np.mod(a[:, 0, :], q).astype(np.uint32))


def test_negacyclic_convolution():
    plan, primes = _plan()
    limbs = tuple(range(len(primes)))
    q0 = primes[0]
    a = RNG.integers(0, 100, size=N).astype(np.int64)
    b = RNG.integers(0, 100, size=N).astype(np.int64)
    # naive negacyclic product
    c = np.zeros(N, dtype=np.int64)
    for i in range(N):
        for j in range(N):
            k = i + j
            if k < N:
                c[k] += a[i] * b[j]
            else:
                c[k - N] -= a[i] * b[j]
    am = _to_mont_stack(a, primes)
    bm = _to_mont_stack(b, primes)
    fa = plan.fwd(am, limbs)
    fb = plan.fwd(bm, limbs)
    qs = plan.q[np.asarray(limbs)][:, None]
    qneg = jnp.asarray(
        np.array([mm.host_mont_constants(q)[0] for q in primes], dtype=np.uint32)
    )[:, None]
    prod = mm.mont_mul(fa, fb, qs, qneg)
    out = plan.inv(prod, limbs)
    got = _from_mont_stack(out, primes)
    for i, q in enumerate(primes):
        np.testing.assert_array_equal(got[i], np.mod(c, q).astype(np.uint32))


def test_automorphism_perm_matches_coeff_domain():
    """auto_perm(g) in eval domain == X -> X^g substitution in coeff domain."""
    plan, primes = _plan()
    limbs = tuple(range(len(primes)))
    a = RNG.integers(0, 1000, size=N).astype(np.int64)
    for g in (5, 25, pow(5, 7, 2 * N), 2 * N - 1, pow(5, -3, 2 * N)):
        # coeff-domain: b[j*g mod 2N ...] with sign from X^{jg} = ±X^{jg mod N}
        b = np.zeros(N, dtype=np.int64)
        for j in range(N):
            e = (j * g) % (2 * N)
            if e < N:
                b[e] += a[j]
            else:
                b[e - N] -= a[j]
        am = _to_mont_stack(a, primes)
        fa = plan.fwd(am, limbs)
        perm = plan.auto_perm(g)
        fb = jnp.take(fa, perm, axis=-1)
        out = plan.inv(fb, limbs)
        got = _from_mont_stack(out, primes)
        for i, q in enumerate(primes):
            np.testing.assert_array_equal(got[i], np.mod(b, q).astype(np.uint32))


def test_host_ntt_matches_device():
    plan, primes = _plan()
    limbs = (0,)
    q = primes[0]
    psis, ipsis, ninv = nttmod._psi_tables(N, q, root_of_unity(q, 2 * N))
    a = RNG.integers(0, q, size=N, dtype=np.int64)
    host = nttmod.host_ntt_fwd(a.astype(np.uint64), q, psis)
    am = _to_mont_stack(a, primes[:1])
    dev = _from_mont_stack(plan.fwd(am, limbs), primes[:1])[0]
    np.testing.assert_array_equal(dev, host.astype(np.uint32))
    back = nttmod.host_ntt_inv(host, q, ipsis, ninv)
    np.testing.assert_array_equal(back.astype(np.uint32), a.astype(np.uint32))
