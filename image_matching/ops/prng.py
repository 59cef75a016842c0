"""Threefry-2x32-20 counter-based PRNG, implemented identically in jnp
(device-side c1 expansion), numpy (tests), and C++ (native host enrollment
engine, native/imtpu_native.cpp) so seed-compressed DB ciphertexts enroll
on the host and regenerate their c1 on the device bit-exactly.

This deliberately does NOT depend on jax.random's internal key derivation:
the expansion is part of the framework's serialization contract (like the
reference's serialized ciphertext files, src/sender/sender_diag.cpp:85-94),
so it must be stable across backends, jax versions, and languages.

Counter layout for c1 of DB group g under base seed s: one Threefry block
per (hi, lo) 64-bit draw, key = (s, g), counter = (idx, 0) with
idx = (ct * L + limb) * N + coef; the draw reduces to a uniform residue
mod q_limb (bias < 2^-36), used directly as the Montgomery/eval-form c1.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from . import modmath as mm

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds.  All args uint32 arrays (broadcastable);
    returns (y0, y1).  Works identically under jnp tracing and numpy."""
    ks0 = np.uint32(k0) if np.isscalar(k0) else k0
    ks1 = np.uint32(k1) if np.isscalar(k1) else k1
    ks2 = ks0 ^ ks1 ^ np.uint32(_PARITY)
    x0 = x0 + ks0
    x1 = x1 + ks1
    ks = (ks1, ks2, ks0)
    for i in range(5):
        for r in _ROT[4 * i % 8 : 4 * i % 8 + 4]:
            x0 = x0 + x1
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = x0 + ks[i % 3]
        x1 = x1 + ks[(i + 1) % 3] + np.uint32(i + 1)
    return x0, x1


def uniform_residues(seed: int, group, idx0: int, shape, q_row, qneg_row,
                     r1_row, r2_row):
    """Device: uniform residues mod q per limb, [*shape] with shape ending
    in (l, N); idx0 is the linear counter offset of element [0,...,0].

    q_row/qneg_row/r1_row/r2_row: per-limb constants broadcastable against
    `shape` (e.g. [l, 1]).  Returns uint32 in [0, q) — by convention the
    Montgomery/eval-domain value."""
    total = int(np.prod(shape))
    idx = (jnp.uint32(idx0) + jnp.arange(total, dtype=jnp.uint32)).reshape(shape)
    g32 = jnp.asarray(group, dtype=jnp.uint32)
    hi, lo = threefry2x32(jnp.uint32(seed), g32, idx, jnp.zeros_like(idx))
    # (hi * 2^32 + lo) mod q == mont_mul(hi, R^2) + mont_mul(lo, R)
    return mm.mod_add(
        mm.mont_mul(hi, r2_row, q_row, qneg_row),
        mm.mont_mul(lo, r1_row, q_row, qneg_row),
        q_row,
    )


def uniform_residues_np(seed: int, group: int, idx0: int, shape,
                        primes) -> np.ndarray:
    """Numpy reference of `uniform_residues` (shape ends in (l, N))."""
    total = int(np.prod(shape))
    idx = (np.uint32(idx0) + np.arange(total, dtype=np.uint32)).reshape(shape)
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(np.uint32(seed), np.uint32(group), idx,
                              np.zeros_like(idx))
    l = shape[-2]
    q = np.array([int(primes[i]) for i in range(l)], dtype=np.uint64)
    q = q.reshape((1,) * (len(shape) - 2) + (l, 1))
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v % q).astype(np.uint32)
