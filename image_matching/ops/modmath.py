"""Modular arithmetic primitives for RNS-CKKS.

All residue arithmetic uses uint32 words with Montgomery reduction at
R = 2^32.  The 32x32 -> 64-bit product is one native unsigned 64-bit
multiply (a scoped 64-bit region, so the rest of the program keeps its
32-bit default types); the GPU lowers it to a wide integer multiply.
Every device-resident polynomial residue is kept in *Montgomery form*
(x' = x*R mod q); conversions happen only at host boundaries
(encode/decode, key generation).

Conventions
-----------
* ``q`` is always < 2^31 so that sums of two reduced residues fit in uint32.
* ``mont_mul(a, b)`` is valid whenever ``a < 2^32`` and ``b < q`` (or
  symmetrically); the intermediate T = a*b then satisfies T < R*q.
* Per-limb constants are passed as uint32 arrays broadcastable against the
  trailing polynomial axis (shape ``[L, 1]`` against ``[L, N]`` data).

This replaces the big-int arithmetic the reference outsources to
OpenFHE's DCRTPoly (see reference src/openFHE_wrapper.cpp and SURVEY.md
section 2.1).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

MASK16 = np.uint32(0xFFFF)
U32 = np.uint32


def mul32_wide(a, b):
    """Full 64-bit product of two uint32 arrays as (hi, lo) uint32 pair."""
    with jax.enable_x64(True):
        p = jnp.asarray(a).astype(jnp.uint64) * jnp.asarray(b).astype(jnp.uint64)
        return (p >> 32).astype(jnp.uint32), p.astype(jnp.uint32)


def mul32_hi(a, b):
    """High 32 bits of the 64-bit product."""
    hi, _ = mul32_wide(a, b)
    return hi


def mont_mul(a, b, q, qneg_inv):
    """Montgomery product: a * b * R^{-1} mod q, R = 2^32.

    ``qneg_inv`` = -q^{-1} mod 2^32.  Requires a < 2^32 and b < q (or
    vice versa) so T = a*b < R*q; output is fully reduced (< q).
    """
    hi, lo = mul32_wide(a, b)
    m = lo * qneg_inv  # wraps mod 2^32 == mod R
    mq_hi, _ = mul32_wide(m, q)
    # (lo + mullo(m, q)) is congruent 0 mod 2^32; the carry out is 1 iff lo != 0.
    carry = (lo != 0).astype(jnp.uint32)
    t = hi + mq_hi + carry  # < 2q <= 2^32, no overflow
    return jnp.where(t >= q, t - q, t)


def mont_sqr(a, q, qneg_inv):
    return mont_mul(a, a, q, qneg_inv)


def shoup_mul(a, w, w_shoup, q):
    """Multiply by a precomputed constant w via Shoup's trick.

    ``w_shoup`` = floor(w * 2^32 / q).  Requires a < q (true for all
    in-domain residues).  ~6 int multiplies instead of 9.
    """
    hi = mul32_hi(a, w_shoup)
    r = a * w - hi * q  # both wrap mod 2^32; result in [0, 2q)
    return jnp.where(r >= q, r - q, r)


def mod_add(a, b, q):
    s = a + b
    return jnp.where(s >= q, s - q, s)


def mod_sub(a, b, q):
    return jnp.where(a >= b, a - b, a + (q - b))


def mod_neg(a, q):
    return jnp.where(a == 0, a, q - a)


def reduce_small(x, q):
    """Reduce x to [0, q), assuming x < 16*q and x < 2^31.

    Used when transferring a (standard-form) residue from one prime's
    domain to another; valid because all primes live within a 16x band
    (see ckks/params.py).  Thresholds that would overflow uint32 are
    clamped to 2^32-1 and can never trigger since x < 2^31.
    """
    big = U32(0xFFFFFFFF)
    q2 = q * U32(2)  # q < 2^31 so this never wraps
    q4 = jnp.where(q < U32(1 << 30), q * U32(4), big)
    q8 = jnp.where(q < U32(1 << 29), q * U32(8), big)
    x = jnp.where(x >= q8, x - q8, x)
    x = jnp.where(x >= q4, x - q4, x)
    x = jnp.where(x >= q2, x - q2, x)
    x = jnp.where(x >= q, x - q, x)
    return x


def mont_dot(a, b, axis, q, qneg_inv, pow16_mont):
    """Deferred-reduction modular contraction: sum_k a_k * b_k * R^{-1} mod q.

    For Montgomery-form operands this returns the Montgomery form of the
    dot product.  Products are split into four 16-bit lanes and summed in
    plain uint32 (valid for contraction length K <= 2^16), then folded
    with one Montgomery reduction per lane.  ~4 multiplies per term versus
    9 for reduce-every-term — this is the hot primitive behind every
    homomorphic similarity computation (reference src/sender/*.cpp inner
    loops).

    ``pow16_mont`` = uint32[4] with pow16_mont[k] = 2^{16k} * R mod q
    (broadcastable per limb: shape [4] or [4, L, 1]).
    """
    hi, lo = mul32_wide(a, b)
    s0 = jnp.sum(lo & MASK16, axis=axis)
    s1 = jnp.sum(lo >> 16, axis=axis)
    s2 = jnp.sum(hi & MASK16, axis=axis)
    s3 = jnp.sum(hi >> 16, axis=axis)
    # u = (s0 + s1*2^16 + s2*2^32 + s3*2^48) mod q, standard form.
    u = mont_mul(s0, pow16_mont[0], q, qneg_inv)
    u = mod_add(u, mont_mul(s1, pow16_mont[1], q, qneg_inv), q)
    u = mod_add(u, mont_mul(s2, pow16_mont[2], q, qneg_inv), q)
    u = mod_add(u, mont_mul(s3, pow16_mont[3], q, qneg_inv), q)
    # Result must carry one net R^{-1} (operands each carry one R):
    # value = sum a*b = R^2 * dot; u = value mod q; REDC(u) = value * R^{-1}
    # = dot * R mod q  -> Montgomery form of dot.
    m = u * qneg_inv
    mq_hi, _ = mul32_wide(m, q)
    carry = (u != 0).astype(jnp.uint32)
    t = mq_hi + carry
    return jnp.where(t >= q, t - q, t)


# ---------------------------------------------------------------------------
# Host-side (numpy / python int) helpers for constant generation
# ---------------------------------------------------------------------------


def host_mont_constants(q: int):
    """Return (qneg_inv, r1, r2, r3) for prime q: -q^{-1} mod 2^32, and
    R, R^2, R^3 mod q."""
    r = 1 << 32
    qinv = pow(q, -1, r)
    qneg_inv = (r - qinv) % r
    r1 = r % q
    r2 = (r * r) % q
    r3 = (r * r * r) % q
    return qneg_inv, r1, r2, r3


def host_to_mont(x: np.ndarray, q: int) -> np.ndarray:
    """Convert standard residues (any numpy int array, values in [0, q)) to
    Montgomery form, on host with exact python ints via uint64."""
    r1 = (1 << 32) % q
    return ((x.astype(np.uint64) * np.uint64(r1)) % np.uint64(q)).astype(np.uint32)


def host_from_mont(x: np.ndarray, q: int) -> np.ndarray:
    rinv = pow(1 << 32, -1, q)
    return ((x.astype(np.uint64) * np.uint64(rinv)) % np.uint64(q)).astype(np.uint32)


def host_shoup(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) for constant arrays (exact, via uint64)."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


def host_pow16_mont(q: int) -> np.ndarray:
    """uint32[4]: 2^{16k} * R mod q for the mont_dot fold."""
    r = 1 << 32
    return np.array([(1 << (16 * k)) * r % q for k in range(4)], dtype=np.uint32)
