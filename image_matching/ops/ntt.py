"""Negacyclic number-theoretic transform over RNS limbs, batched.

Implements the merged-twiddle CT/GS algorithms (Longa & Naehrig style): the
2N-th root psi is folded into the twiddle tables so no separate bit-reversal
or psi pre/post scaling pass is needed.  Forward maps natural-order
coefficients to a bit-reversed evaluation order; inverse undoes it.

Data convention: uint32 arrays shaped [..., L, N] in Montgomery form; one
limb per row.  Twiddles are stored in *standard* form with Shoup companions
(shoup_mul keeps Montgomery operands in-domain: (aR) * w -> (a*w)R).

Galois automorphisms X -> X^g act on the evaluation form as a pure index
permutation; `NttPlan.auto_perm(g)` computes the permutation table from the
exponent map of the transform, which is itself derived empirically (by
transforming X and taking discrete logs), so the permutation is correct by
construction regardless of twiddle ordering conventions.

This replaces the polynomial arithmetic inside OpenFHE's DCRTPoly that the
reference relies on for every EvalMult / EvalRotate (SURVEY.md section 7,
layer 2).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from . import modmath as mm


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _pow_table(base: int, n: int, q: int) -> np.ndarray:
    """[base^0, ..., base^{n-1}] mod q, vectorized square-and-multiply."""
    exps = np.arange(n, dtype=np.uint64)
    result = np.ones(n, dtype=np.uint64)
    b = np.uint64(base % q)
    qq = np.uint64(q)
    k = 0
    while (1 << k) < n:
        mask = (exps >> np.uint64(k)) & np.uint64(1)
        result = np.where(mask == 1, result * b % qq, result)
        b = b * b % qq
        k += 1
    return result


def _psi_tables(n: int, q: int, psi: int):
    """Return (psis, ipsis, ninv): psi^brv(i) and psi^-brv(i) tables plus
    n^{-1}, all standard form, as uint32 numpy arrays."""
    brv = _bit_reverse_perm(n)
    pows = _pow_table(psi, n, q)
    ipows = _pow_table(pow(psi, -1, q), n, q)
    psis = pows[brv].astype(np.uint32)
    ipsis = ipows[brv].astype(np.uint32)
    ninv = pow(n, -1, q)
    return psis, ipsis, ninv


class NttPlan:
    """Precomputed NTT tables for a fixed prime chain (Q limbs + specials).

    All tables are stacked [L_total, N]; operations take a static tuple of
    limb indices selecting which rows participate.
    """

    def __init__(self, n: int, primes: Sequence[int], roots: Sequence[int]):
        self.n = n
        self.logn = n.bit_length() - 1
        self.primes = tuple(primes)
        L = len(primes)
        psis = np.empty((L, n), dtype=np.uint32)
        ipsis = np.empty((L, n), dtype=np.uint32)
        psis_sh = np.empty((L, n), dtype=np.uint32)
        ipsis_sh = np.empty((L, n), dtype=np.uint32)
        ninv = np.empty((L,), dtype=np.uint32)
        ninv_sh = np.empty((L,), dtype=np.uint32)
        for i, (q, psi) in enumerate(zip(primes, roots)):
            p, ip, nv = _psi_tables(n, q, psi)
            psis[i] = p
            ipsis[i] = ip
            psis_sh[i] = mm.host_shoup(p, q)
            ipsis_sh[i] = mm.host_shoup(ip, q)
            ninv[i] = nv
            ninv_sh[i] = mm.host_shoup(np.array(nv, dtype=np.uint32), q)
        self.psis_np = psis  # host copy (encoding, keygen — trace-safe)
        self.ipsis_np = ipsis
        self.psis = jnp.asarray(psis)
        self.ipsis = jnp.asarray(ipsis)
        self.psis_sh = jnp.asarray(psis_sh)
        self.ipsis_sh = jnp.asarray(ipsis_sh)
        self.ninv = jnp.asarray(ninv)
        self.ninv_sh = jnp.asarray(ninv_sh)
        self.q = jnp.asarray(np.array(primes, dtype=np.uint32))
        self._build_loop_tables(psis, ipsis)
        # exponent map: eval position j holds m(psi^{exp[j]}) — derived
        # once from the smallest limb (identical structure for all limbs).
        self._exp = self._derive_exponents()
        pos = np.full(2 * n, -1, dtype=np.int64)
        pos[self._exp] = np.arange(n)
        self._pos_of_exp = pos
        self._auto_cache = {}

    def _build_loop_tables(self, psis: np.ndarray, ipsis: np.ndarray):
        """Uniform-stage butterfly tables so all log2(N) stages run under a
        single lax.fori_loop: every stage is
            out[j] = s1[j] * (x[u[j]] + s2[j] * x[v[j]])   (mod q)
        with subtraction folded into s2 via negated twiddles.  This keeps
        jitted pipeline graphs constant-size per NTT — essential for
        whole-scenario compilation — at the cost of one extra Shoup
        multiply per element in the inverse."""
        n, logn, L = self.n, self.logn, len(self.primes)
        qarr = np.array(self.primes, dtype=np.uint64)
        j = np.arange(n)

        f_lo = np.empty((logn, n), dtype=bool)
        f_s2 = np.empty((logn, L, n), dtype=np.uint32)
        for s in range(logn):
            m = 1 << s
            t = n // (2 * m)
            g = j // (2 * t)
            p = j % (2 * t)
            lo = p < t
            f_lo[s] = lo
            w = psis[:, m + g]  # [L, n]
            f_s2[s] = np.where(lo[None, :], w, (qarr[:, None] - w) % qarr[:, None])
        self.f_lo = jnp.asarray(f_lo)
        self.f_s2 = jnp.asarray(f_s2)
        self.f_s2_sh = jnp.asarray(
            np.stack([
                np.stack([mm.host_shoup(f_s2[s, i], self.primes[i]) for i in range(L)])
                for s in range(logn)
            ])
        )

        i_lo = np.empty((logn, n), dtype=bool)
        i_s1 = np.empty((logn, L, n), dtype=np.uint32)
        i_s2 = np.empty((logn, L, n), dtype=np.uint32)
        for s in range(logn):
            m = n >> s
            h = m // 2
            t = n // m
            g = j // (2 * t)
            p = j % (2 * t)
            lo = p < t
            i_lo[s] = lo
            w = ipsis[:, h + g]
            one = np.ones_like(w)
            i_s1[s] = np.where(lo[None, :], one, w)
            i_s2[s] = np.where(lo[None, :], one, (qarr[:, None] - 1) % qarr[:, None])
        self.i_lo = jnp.asarray(i_lo)
        self.i_s1 = jnp.asarray(i_s1)
        self.i_s2 = jnp.asarray(i_s2)
        self.i_s1_sh = jnp.asarray(
            np.stack([
                np.stack([mm.host_shoup(i_s1[s, i], self.primes[i]) for i in range(L)])
                for s in range(logn)
            ])
        )
        self.i_s2_sh = jnp.asarray(
            np.stack([
                np.stack([mm.host_shoup(i_s2[s, i], self.primes[i]) for i in range(L)])
                for s in range(logn)
            ])
        )

    def _derive_exponents(self) -> np.ndarray:
        """eval position -> exponent of psi, via NTT(X) and discrete log."""
        n = self.n
        q = self.primes[0]
        # recover psi from the table: psis[1] = psi^brv(1) = psi^{n/2};
        # easier: recompute from scratch is avoided by storing root later;
        # we instead transform X directly with the numpy table algorithm.
        a = np.zeros(n, dtype=np.uint64)
        a[1] = 1
        psis = np.asarray(self.psis[0]).astype(np.uint64)
        vals = host_ntt_fwd(a, q, psis)
        # discrete log over the cyclic group generated by vals[0] (a
        # primitive 2n-th root: vals[j] = psi^{e_j} with e_j odd).
        table = {}
        g = int(vals[0])
        x = 1
        for e in range(2 * n):
            table[x] = e
            x = x * g % q
        # exponents relative to g; convert to absolute odd exponents:
        # vals[j] = g^{t_j} = psi^{e0 * t_j}; we only ever need the
        # *relative* structure for automorphisms: define exp[j] := e0*t_j
        # mod 2n with e0 unknown ⇒ automorphism g·exp works identically
        # since mapping exp -> g*exp is in terms of absolute psi exponents:
        # pos[(g_auto * exp[j]) mod 2n]. Relative exponents scale both
        # sides by e0 (odd, invertible mod 2n) ⇒ same permutation. So use
        # t_j directly.
        exps = np.array([table[int(v)] for v in vals], dtype=np.int64)
        # all exponents must be odd multiples (invertible scaling keeps odd)
        assert np.all(exps % 2 == 1), "exponent table not odd — NTT wiring bug"
        return exps

    # ----- automorphism permutations -------------------------------------

    def auto_perm(self, g: int) -> jnp.ndarray:
        """Index permutation P with out_eval[j] = in_eval[P[j]] implementing
        m(X) -> m(X^g) in the evaluation domain (g odd, mod 2N)."""
        g = g % (2 * self.n)
        if g not in self._auto_cache:
            tgt = (g * self._exp) % (2 * self.n)
            perm = self._pos_of_exp[tgt]
            assert np.all(perm >= 0)
            # numpy, not jnp: a device array created inside a jit trace
            # would leak as a cached tracer into later traces
            self._auto_cache[g] = perm.astype(np.int32)
        return self._auto_cache[g]

    # ----- device transforms ---------------------------------------------

    def _consts(self, limbs: Tuple[int, ...]):
        idx = np.asarray(limbs, dtype=np.int32)
        q = self.q[idx][:, None]
        return idx, q

    def fwd(self, a: jnp.ndarray, limbs: Tuple[int, ...]) -> jnp.ndarray:
        """Forward negacyclic NTT.  a: [..., L, N] Montgomery-form coeffs
        (natural order) -> eval form (bit-reversed order).

        All log2(N) stages run under one fori_loop of uniform butterflies;
        the U/V partner exchange is two cyclic rolls + masked selects
        (contiguous shifts, no gathers), with the subtraction
        folded into negated twiddles:
            out = sel_u + s2 * sel_v,
            sel_u = lo ? x : roll(x, +t),  sel_v = lo ? roll(x, -t) : x.
        """
        import jax

        idx, q = self._consts(limbs)
        s2 = self.f_s2[:, idx]      # [logn, l, n]
        s2_sh = self.f_s2_sh[:, idx]
        n = self.n

        def body(s, x):
            t = n >> (s + 1)
            va = jnp.roll(x, -t, axis=-1)
            vb = jnp.roll(x, t, axis=-1)
            lo = self.f_lo[s]
            u = jnp.where(lo, x, vb)
            v = jnp.where(lo, va, x)
            return mm.mod_add(u, mm.shoup_mul(v, s2[s], s2_sh[s], q), q)

        return jax.lax.fori_loop(0, self.logn, body, a)

    def inv(self, a: jnp.ndarray, limbs: Tuple[int, ...]) -> jnp.ndarray:
        """Inverse NTT: eval form (bit-reversed) -> natural-order coeffs,
        including the 1/N scaling."""
        import jax

        idx, q = self._consts(limbs)
        s1 = self.i_s1[:, idx]
        s1_sh = self.i_s1_sh[:, idx]
        s2 = self.i_s2[:, idx]
        s2_sh = self.i_s2_sh[:, idx]
        n = self.n

        def body(s, x):
            t = n >> (self.logn - s)
            va = jnp.roll(x, -t, axis=-1)
            vb = jnp.roll(x, t, axis=-1)
            lo = self.i_lo[s]
            u = jnp.where(lo, x, vb)
            v = jnp.where(lo, va, x)
            tt = mm.mod_add(u, mm.shoup_mul(v, s2[s], s2_sh[s], q), q)
            return mm.shoup_mul(tt, s1[s], s1_sh[s], q)

        a = jax.lax.fori_loop(0, self.logn, body, a)
        ninv = self.ninv[idx][:, None]
        ninv_sh = self.ninv_sh[idx][:, None]
        return mm.shoup_mul(a, ninv, ninv_sh, q)


# ---------------------------------------------------------------------------
# Host-side transforms (numpy uint64, standard form) — used by key
# generation and tests; identical wiring to the device transforms.
# ---------------------------------------------------------------------------


def host_ntt_fwd(a: np.ndarray, q: int, psis: np.ndarray) -> np.ndarray:
    """Forward negacyclic NTT on host.  a: uint64[..., n] standard form,
    natural order -> bit-reversed eval order.  psis: table from _psi_tables."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    a = a.astype(np.uint64) % np.uint64(q)
    psis = psis.astype(np.uint64)
    m = 1
    while m < n:
        t = n // (2 * m)
        a = a.reshape(*lead, m, 2, t)
        s = psis[m : 2 * m].reshape(m, 1)
        u = a[..., 0, :]
        v = a[..., 1, :] * s % np.uint64(q)
        a = np.stack([(u + v) % np.uint64(q), (u - v + np.uint64(q)) % np.uint64(q)], axis=-2)
        m *= 2
    return a.reshape(*lead, n)


def host_ntt_inv(a: np.ndarray, q: int, ipsis: np.ndarray, ninv: int) -> np.ndarray:
    n = a.shape[-1]
    lead = a.shape[:-1]
    a = a.astype(np.uint64) % np.uint64(q)
    ipsis = ipsis.astype(np.uint64)
    m = n
    while m > 1:
        h = m // 2
        t = n // m
        a = a.reshape(*lead, h, 2, t)
        s = ipsis[h : 2 * h].reshape(h, 1)
        u = a[..., 0, :]
        v = a[..., 1, :]
        a = np.stack(
            [(u + v) % np.uint64(q), (u - v + np.uint64(q)) * s % np.uint64(q)],
            axis=-2,
        )
        m //= 2
    a = a.reshape(*lead, n)
    return a * np.uint64(ninv) % np.uint64(q)
