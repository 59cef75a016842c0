"""CKKS crypto context: key generation, encryption, and the homomorphic
evaluator, all on the device.

Replaces the reference's use of OpenFHE (CryptoContext<DCRTPoly>, reference
src/main.cpp:169-207 for setup/keygen; every EvalMult/EvalRotate/Rescale
call in src/sender/*.cpp and src/openFHE_wrapper.cpp).  Everything on the
device is uint32 RNS in Montgomery form, evaluation (NTT) domain.

Key-switching is the hybrid (Han-Ki) scheme with `dnum` digits over the
full RNS basis.  The gadget vector g_j is congruent to delta_{ij} modulo
every ciphertext prime, so one key set serves every level; the ciphertext
side extends its digit only over the limbs present at its level.

Scale management: every ciphertext carries an exact float64 scale.  Adds
require exactly matching scales; `align_to` retargets a ciphertext to any
(limbs, scale) pair using a spare level (multiply by 1.0 encoded at the
correcting scale, then rescale).  Plaintext constants are always encoded at
the exact scale the consuming operation requires, so there is no FIXEDMANUAL
scale drift even with 28-bit primes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import modmath as mm
from ..ops.ntt import NttPlan, host_ntt_fwd
from . import encoding
from .params import SchemeParams, root_of_unity


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Ciphertext:
    """RNS-CKKS ciphertext: data [k, l, N] (k components, l limbs) in
    Montgomery/eval form.  `scale` is exact static metadata."""

    data: jnp.ndarray
    scale: float

    @property
    def limbs(self) -> int:
        return self.data.shape[-2]

    @property
    def ncomp(self) -> int:
        return self.data.shape[-3]

    def tree_flatten(self):
        return (self.data,), (self.scale,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])


@dataclasses.dataclass
class Plaintext:
    data: jnp.ndarray  # [l, N] eval Montgomery
    scale: float


def _sample_gauss(rng, n, sigma):
    return np.rint(rng.normal(0.0, sigma, size=n)).astype(np.int64)


def _sample_ternary(rng, n):
    return rng.integers(-1, 2, size=n).astype(np.int64)


class CkksContext:
    """Scheme context + evaluator.  One instance per parameter set."""

    def __init__(self, params: SchemeParams, seed: int = 0):
        self.params = params
        n = params.ring_dim
        self.n = n
        self.slots = params.slots
        self.Lq = params.num_limbs
        self.S = params.num_special
        self.all_primes: Tuple[int, ...] = params.q_primes + params.sp_primes
        self.Ltot = len(self.all_primes)
        roots = [root_of_unity(q, 2 * n) for q in self.all_primes]
        self.plan = NttPlan(n, self.all_primes, roots)

        # per-prime device constants
        qs = np.array(self.all_primes, dtype=np.uint32)
        consts = [mm.host_mont_constants(int(q)) for q in self.all_primes]
        self.q_np = qs
        self.qs = jnp.asarray(qs)
        self.qneg = jnp.asarray(np.array([c[0] for c in consts], dtype=np.uint32))
        self.r2 = jnp.asarray(np.array([c[2] for c in consts], dtype=np.uint32))
        self.pow16 = jnp.asarray(
            np.stack([mm.host_pow16_mont(int(q)) for q in self.all_primes], axis=1)
        )  # [4, Ltot]

        # digit partition over full Q basis
        g0 = math.ceil(self.Lq / params.dnum)
        self.groups: List[List[int]] = [
            list(range(j * g0, min((j + 1) * g0, self.Lq)))
            for j in range(params.dnum)
            if j * g0 < self.Lq
        ]
        self.dnum = len(self.groups)

        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._keygen()
        # rotation keys live in stacked sets ([R, dnum, 2, Ltot, N]) so
        # groups of rotations can run as ONE vmapped/scanned keyswitch
        # body — essential to keep XLA graphs (and compile times) small.
        self._rot_sets: List[Tuple[jnp.ndarray, jnp.ndarray]] = []  # (perms, keys)
        self.rot_keys: Dict[int, Dict[int, int]] = {}  # galois -> {set: row}
        self._pow2_rots: List[int] = []
        self._pt_cache: Dict = {}
        self._fbc_cache: Dict = {}

    # ------------------------------------------------------------------
    # device-state threading: all large device buffers (NTT tables, keys)
    # are passed into jitted functions as ARGUMENTS via this pytree, not
    # captured as closure constants — closure constants get embedded in
    # the compiled module (GBs of keys in every segment's HLO, hashed for
    # every compile-cache lookup), and a mesh can replicate one pytree once
    # (parallel/sharded.replicated_state).
    # ------------------------------------------------------------------

    _PLAN_BUFS = (
        "psis", "ipsis", "psis_sh", "ipsis_sh", "ninv", "ninv_sh", "q",
        "f_lo", "f_s2", "f_s2_sh", "i_lo", "i_s1", "i_s2", "i_s1_sh",
        "i_s2_sh",
    )
    _CTX_BUFS = ("qs", "qneg", "r2", "pow16", "s_eval", "pk_b", "pk_a",
                 "relin_key")

    def device_state(self):
        return {
            "plan": {k: getattr(self.plan, k) for k in self._PLAN_BUFS},
            "ctx": {k: getattr(self, k) for k in self._CTX_BUFS},
            "rot": [list(t) for t in self._rot_sets],
        }

    @contextlib.contextmanager
    def bound_state(self, state):
        old_p = {k: getattr(self.plan, k) for k in self._PLAN_BUFS}
        old_c = {k: getattr(self, k) for k in self._CTX_BUFS}
        old_r = self._rot_sets
        try:
            for k, v in state["plan"].items():
                setattr(self.plan, k, v)
            for k, v in state["ctx"].items():
                setattr(self, k, v)
            self._rot_sets = [tuple(t) for t in state["rot"]]
            yield
        finally:
            for k, v in old_p.items():
                setattr(self.plan, k, v)
            for k, v in old_c.items():
                setattr(self, k, v)
            self._rot_sets = old_r

    # ------------------------------------------------------------------
    # constant helpers
    # ------------------------------------------------------------------

    def _qrow(self, limbs: Sequence[int]):
        """Per-limb constant views [l, 1] for the given limb indices."""
        idx = np.asarray(list(limbs), dtype=np.int32)
        return (
            self.qs[idx][:, None],
            self.qneg[idx][:, None],
        )

    @property
    def fresh_scale(self) -> float:
        """Scale for fresh encryptions: sqrt(Delta * q_top * q_top2) when
        fresh_levels == 1 (so two rescales after the first ct*ct product
        land exactly on Delta), else Delta."""
        p = self.params
        if p.fresh_levels == 1:
            return math.sqrt(
                p.scale * self.all_primes[self.Lq - 1] * self.all_primes[self.Lq - 2]
            )
        return p.scale

    def rescale_score(self, ct: Ciphertext) -> Ciphertext:
        """Rescale after a product of two fresh ciphertexts: 1+fresh_levels
        rescales, landing the scale back on ~Delta."""
        for _ in range(1 + self.params.fresh_levels):
            ct = self.rescale(ct)
        return ct

    def q_limbs(self, l: int) -> Tuple[int, ...]:
        return tuple(range(l))

    def sp_limbs(self) -> Tuple[int, ...]:
        return tuple(range(self.Lq, self.Ltot))

    def ext_limbs(self, l: int) -> Tuple[int, ...]:
        return tuple(range(l)) + self.sp_limbs()

    # ------------------------------------------------------------------
    # key generation (host side, numpy/python ints)
    # ------------------------------------------------------------------

    def _host_rns_eval(self, coeffs: np.ndarray, limb_ids: Sequence[int]) -> np.ndarray:
        """signed coeffs [n] -> eval-domain standard residues uint64 [L, n]."""
        out = np.empty((len(limb_ids), self.n), dtype=np.uint64)
        for row, i in enumerate(limb_ids):
            q = self.all_primes[i]
            psis = self.plan.psis_np[i]
            res = np.mod(coeffs, q).astype(np.uint64)
            out[row] = host_ntt_fwd(res, q, psis)
        return out

    def _to_mont_dev(self, std: np.ndarray, limb_ids: Sequence[int]) -> jnp.ndarray:
        rows = []
        for row, i in enumerate(limb_ids):
            rows.append(mm.host_to_mont(std[row].astype(np.uint32), self.all_primes[i]))
        return jnp.asarray(np.stack(rows))

    def _keygen(self):
        n, rng = self.n, self._rng
        p = self.params
        self._s_coeffs = _sample_ternary(rng, n)
        s_eval = self._host_rns_eval(self._s_coeffs, range(self.Ltot))
        self._s_eval_std = s_eval  # standard form, host, for key gen
        self.s_eval = self._to_mont_dev(s_eval, range(self.Ltot))

        # public key over Q basis
        a = np.stack(
            [
                rng.integers(0, q, size=n, dtype=np.uint64)
                for q in self.all_primes[: self.Lq]
            ]
        )
        e = self._host_rns_eval(_sample_gauss(rng, n, p.sigma), range(self.Lq))
        b = np.empty_like(a)
        for i, q in enumerate(self.all_primes[: self.Lq]):
            b[i] = (q - a[i] * s_eval[i] % q + e[i]) % q
        self.pk_b = self._to_mont_dev(b, range(self.Lq))
        self.pk_a = self._to_mont_dev(a, range(self.Lq))

        # relinearization key: KSK for s^2
        s2_eval = np.empty_like(s_eval)
        for i, q in enumerate(self.all_primes):
            s2_eval[i] = s_eval[i] * s_eval[i] % q
        self.relin_key = self._gen_ksk(s2_eval)

    def _gen_ksk(self, sp_eval_std: np.ndarray) -> jnp.ndarray:
        """Key-switching key for target secret s' (eval std [Ltot, n]):
        ksk[j] = (b_j, a_j) with b_j = -a_j s + e_j + P*g_j*s' (mod QP).
        Returns mont device array [dnum, 2, Ltot, N]."""
        n, rng = self.n, self._rng
        P = 1
        for q in self.params.sp_primes:
            P *= q
        Qfull = 1
        for q in self.params.q_primes:
            Qfull *= q
        ksk = np.empty((self.dnum, 2, self.Ltot, n), dtype=np.uint64)
        for j, grp in enumerate(self.groups):
            Qj = 1
            for i in grp:
                Qj *= self.all_primes[i]
            Qhat = Qfull // Qj
            t = pow(Qhat % Qj, -1, Qj)
            a = np.stack(
                [rng.integers(0, q, size=n, dtype=np.uint64) for q in self.all_primes]
            )
            e = self._host_rns_eval(_sample_gauss(rng, n, self.params.sigma), range(self.Ltot))
            for i, q in enumerate(self.all_primes):
                fac = (P * Qhat * t) % q  # == P mod q for i in grp; 0 for specials
                b = (q - a[i] * self._s_eval_std[i] % q + e[i]) % q
                b = (b + fac * sp_eval_std[i]) % q
                ksk[j, 0, i] = b
                ksk[j, 1, i] = a[i]
        rows = []
        for c in range(2):
            rows.append(
                np.stack(
                    [
                        np.stack(
                            [
                                mm.host_to_mont(
                                    ksk[j, c, i].astype(np.uint32), self.all_primes[i]
                                )
                                for i in range(self.Ltot)
                            ]
                        )
                        for j in range(self.dnum)
                    ]
                )
            )
        return jnp.asarray(np.stack(rows, axis=1))

    def rotation_galois(self, r: int) -> int:
        """Galois element for EvalRotate(ct, r): left-rotate slots by r."""
        return pow(5, r % self.slots, 2 * self.n)

    def gen_rotation_keys(self, rotations: Sequence[int], force: bool = False):
        """Generate keys for the given slot rotations as one stacked set.
        With force=True, rotations already covered by other sets are
        regenerated here so the whole list lives in a single set (required
        for vmapped/scanned rotation batches)."""
        new = []
        for r in rotations:
            g = self.rotation_galois(r)
            if g == 1 or g in [x[0] for x in new]:
                continue
            if g in self.rot_keys and not force:
                continue
            new.append((g, r))
        if not new:
            return
        perms = []
        keys = []
        set_idx = len(self._rot_sets)
        for row, (g, _r) in enumerate(new):
            perm = self.plan.auto_perm(g)
            s_rot = self._s_eval_std[:, perm]
            keys.append(self._gen_ksk(s_rot))
            perms.append(perm)
            self.rot_keys.setdefault(g, {})[set_idx] = row
        self._rot_sets.append(
            (jnp.asarray(np.stack(perms)), jnp.stack(keys))
        )

    def gen_power_of_two_rotation_keys(self):
        """Keys for +-2^k — the reference's binaryRotate key policy
        (src/main.cpp:195-206).  Ordered [1, 2, 4, ...] first so eval_sum
        can use a static prefix of the stacked set."""
        rots = []
        i = 1
        while i < self.slots:
            rots.append(i)
            i *= 2
        i = 1
        while i < self.slots:
            rots.append(-i)
            i *= 2
        self._pow2_set_idx = len(self._rot_sets)
        self._pow2_rots = rots
        self.gen_rotation_keys(rots)

    def _rot_entry(self, g: int):
        set_idx, row = next(iter(self.rot_keys[g].items()))
        perms, keys = self._rot_sets[set_idx]
        return perms[row], keys[row]

    # ------------------------------------------------------------------
    # encoding / encryption (host <-> device boundary)
    # ------------------------------------------------------------------

    def encode(self, values: np.ndarray, limbs: int, scale: float) -> Plaintext:
        """Encode slot values into an eval-domain Montgomery plaintext at
        the given limb count and exact scale.  Entirely host-side (numpy
        NTT) so cached plaintexts are plain constants — safe to reuse
        across jit traces."""
        coeffs = encoding.encode(np.asarray(values), self.n, scale)[0]
        rows = []
        for i in range(limbs):
            q = self.all_primes[i]
            res = np.mod(coeffs, q).astype(np.uint64)
            ev = host_ntt_fwd(res, q, self.plan.psis_np[i])
            rows.append(mm.host_to_mont(ev.astype(np.uint32), q))
        return Plaintext(np.stack(rows), scale)

    def encode_cached(self, key, values, limbs: int, scale: float) -> Plaintext:
        ck = (key, limbs, round(math.log2(scale) * 1e6))
        if ck not in self._pt_cache:
            self._pt_cache[ck] = self.encode(values, limbs, scale)
        return self._pt_cache[ck]

    def _fresh_noise(self, batch: int = 1):
        """Sample host-side encryption randomness for `batch` ciphertexts:
        (v, e0, e1) signed coeffs [batch, n]."""
        rng = self._rng
        v = np.stack([_sample_ternary(rng, self.n) for _ in range(batch)])
        e0 = np.stack([_sample_gauss(rng, self.n, self.params.sigma) for _ in range(batch)])
        e1 = np.stack([_sample_gauss(rng, self.n, self.params.sigma) for _ in range(batch)])
        return v, e0, e1

    def encrypt_batch(self, values: np.ndarray, limbs: Optional[int] = None,
                      scale: Optional[float] = None) -> jnp.ndarray:
        """Encrypt a batch of slot-value vectors [B, slots] -> ciphertext
        data array [B, 2, l, N].  Only the encoded message crosses the
        host->device boundary; encryption randomness (ternary v, gaussian
        e0/e1) is sampled on-device with jax.random, and all NTTs / pk
        MACs run on-device."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        B = values.shape[0]
        l = limbs if limbs is not None else self.Lq
        sc = scale if scale is not None else self.fresh_scale
        primes = [self.all_primes[i] for i in range(l)]
        coeffs = encoding.encode(values, self.n, sc)  # [B, n]
        m_rns = encoding.to_rns(coeffs, primes)  # [B, l, n] std
        key = jax.random.key(int(self._rng.integers(0, 2 ** 63)))
        return self._encrypt_dev(self.device_state(), jnp.asarray(m_rns), key, l)

    def _small_signed_to_rns(self, x, l):
        """Device: small signed int32 [..., n] -> standard residues
        uint32 [..., l, n]."""
        lim = self.q_limbs(l)
        q, _ = self._qrow(lim)
        xe = x[..., None, :].astype(jnp.int32)
        return jnp.where(xe < 0, q.astype(jnp.int32) + xe, xe).astype(jnp.uint32)

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _encrypt_dev(self, state, m_rns, key, l):
        with self.bound_state(state):
            return self._encrypt_impl(m_rns, key, l)

    def _encrypt_impl(self, m_rns, key, l):
        lim = self.q_limbs(l)
        q, qneg = self._qrow(lim)
        r2 = self.r2[np.asarray(lim, dtype=np.int32)][:, None]
        to_mont = lambda x: mm.mont_mul(x, r2, q, qneg)
        B = m_rns.shape[0]
        kv, k0, k1 = jax.random.split(key, 3)
        v_s = jax.random.randint(kv, (B, self.n), -1, 2, dtype=jnp.int32)
        e0_s = jnp.round(
            jax.random.normal(k0, (B, self.n), dtype=jnp.float32) * self.params.sigma
        ).astype(jnp.int32)
        e1_s = jnp.round(
            jax.random.normal(k1, (B, self.n), dtype=jnp.float32) * self.params.sigma
        ).astype(jnp.int32)
        m = self.plan.fwd(to_mont(m_rns), lim)
        v = self.plan.fwd(to_mont(self._small_signed_to_rns(v_s, l)), lim)
        e0 = self.plan.fwd(to_mont(self._small_signed_to_rns(e0_s, l)), lim)
        e1 = self.plan.fwd(to_mont(self._small_signed_to_rns(e1_s, l)), lim)
        b = self.pk_b[:l]
        a = self.pk_a[:l]
        c0 = mm.mod_add(mm.mod_add(mm.mont_mul(b, v, q, qneg), e0, q), m, q)
        c1 = mm.mod_add(mm.mont_mul(a, v, q, qneg), e1, q)
        return jnp.stack([c0, c1], axis=-3)

    def encrypt(self, values: np.ndarray, limbs: Optional[int] = None,
                scale: Optional[float] = None) -> Ciphertext:
        data = self.encrypt_batch(values, limbs, scale)[0]
        return Ciphertext(data, scale if scale is not None else self.fresh_scale)

    # ------------------------------------------------------------------
    # seed-compressed (symmetric) encryption for streamed databases
    #
    # The reference streams its serialized DB ciphertexts from disk per
    # operation (reference src/sender/sender_hers.cpp:88-98,
    # sender_diag.cpp:85-94).  The device equivalent keeps the DB in host RAM
    # and streams it to HBM per group; to halve that traffic the enroller
    # (the key holder in the reference's single-process simulation,
    # src/main.cpp:236-330) uses seeded RLWE ciphertexts: c1 is expanded
    # from a PRNG seed on-device, only c0 is stored/streamed.
    # ------------------------------------------------------------------

    _SPLIT_BITS = 24            # coefficient split: c + OFFSET = hi*2^24 + lo
    _SPLIT_OFFSET = 1 << 47     # |coeff| must stay below this

    def uniform_mont(self, seed: int, group, shape_prefix, l: int) -> jnp.ndarray:
        """Uniform residues in [0, q_i) per limb, [*shape_prefix, l, N]
        uint32 — a 64-bit Threefry draw reduced per limb (bias < 2^-36;
        stream defined in ops/prng.py, reproduced bit-exactly by the C++
        host enroller).  Uniform residues are uniform in Montgomery/eval
        form too, so the output is directly usable as the seed-expanded c1
        of an RLWE ciphertext.  `group` may be a traced scalar."""
        from ..ops import prng

        lim = self.q_limbs(l)
        q, qneg = self._qrow(lim)
        idx = np.asarray(lim, dtype=np.int32)
        r1 = jnp.asarray(
            np.array([mm.host_mont_constants(int(self.q_np[i]))[1] for i in idx],
                     dtype=np.uint32))[:, None]
        r2 = self.r2[idx][:, None]
        shape = tuple(shape_prefix) + (l, self.n)
        return prng.uniform_residues(seed, group, 0, shape, q, qneg, r1, r2)

    def split_coeffs(self, coeffs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Signed int64 coefficients [..., N] -> (hi, lo) uint32 halves of
        coeff + OFFSET, for compact host->device transfer (8 bytes/coeff
        instead of 4*limbs)."""
        off = np.uint64(self._SPLIT_OFFSET)
        assert np.abs(coeffs).max(initial=0) < self._SPLIT_OFFSET, \
            "coefficient overflows 48-bit split; raise _SPLIT_OFFSET"
        u = (coeffs.astype(np.int64) + np.int64(off)).astype(np.uint64)
        hi = (u >> np.uint64(self._SPLIT_BITS)).astype(np.uint32)
        lo = (u & np.uint64((1 << self._SPLIT_BITS) - 1)).astype(np.uint32)
        return hi, lo

    def _coeffs_from_split(self, hi, lo, l: int) -> jnp.ndarray:
        """Device: (hi, lo) uint32 [..., N] -> standard residues
        [..., l, N]."""
        lim = self.q_limbs(l)
        q, qneg = self._qrow(lim)
        c24 = np.array(
            [(1 << (self._SPLIT_BITS + 32)) % int(self.q_np[i]) for i in lim],
            dtype=np.uint32)[:, None]
        offm = np.array(
            [self._SPLIT_OFFSET % int(self.q_np[i]) for i in lim],
            dtype=np.uint32)[:, None]
        hie = hi[..., None, :]
        loe = lo[..., None, :]
        # mont_mul(hi, 2^24 * R) = hi * 2^24 mod q; lo < 2^24 < q already
        t = mm.mod_add(mm.mont_mul(hie, jnp.asarray(c24), q, qneg), loe, q)
        return mm.mod_sub(t, jnp.asarray(offm), q)

    @functools.partial(jax.jit, static_argnums=(0, 6, 7))
    def _encrypt_seeded_dev(self, state, hi, lo, group, ekey, l, seed):
        with self.bound_state(state):
            lim = self.q_limbs(l)
            q, qneg = self._qrow(lim)
            r2 = self.r2[np.asarray(lim, dtype=np.int32)][:, None]
            B = hi.shape[0]
            m_std = self._coeffs_from_split(hi, lo, l)
            m = self.plan.fwd(mm.mont_mul(m_std, r2, q, qneg), lim)
            e_s = jnp.round(
                jax.random.normal(ekey, (B, self.n), dtype=jnp.float32)
                * self.params.sigma
            ).astype(jnp.int32)
            e = self.plan.fwd(
                mm.mont_mul(self._small_signed_to_rns(e_s, l), r2, q, qneg), lim
            )
            c1 = self.uniform_mont(seed, group, (B,), l)
            # c0 = m + e - c1*s  so that  c0 + c1*s = m + e
            c0 = mm.mod_sub(
                mm.mod_add(m, e, q),
                mm.mont_mul(c1, self.s_eval[:l], q, qneg), q,
            )
            return c0

    def encode_split(self, values: np.ndarray,
                     scale: Optional[float] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side CKKS encode of [B, slots] values to the compact
        (hi, lo) uint32 coefficient transfer form consumed by
        `encrypt_seeded_from_split` — cacheable enroller-side material
        (it is a deterministic function of the plaintext, independent of
        keys and noise)."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        sc = scale if scale is not None else self.fresh_scale
        coeffs = encoding.encode(values, self.n, sc)
        return self.split_coeffs(coeffs)

    def encrypt_seeded_from_split(self, hi: np.ndarray, lo: np.ndarray,
                                  seed: int, group: int,
                                  limbs: Optional[int] = None) -> jnp.ndarray:
        """Seeded encryption from pre-encoded (hi, lo) coefficients: the
        8-bytes/coeff transfer is the only host->device traffic; NTT,
        noise, and the seeded mask all run on-device."""
        l = limbs if limbs is not None else self.Lq
        ekey = jax.random.key(int(self._rng.integers(0, 2 ** 63)))
        return self._encrypt_seeded_dev(
            self.device_state(), jnp.asarray(hi), jnp.asarray(lo),
            jnp.uint32(group), ekey, l, seed,
        )

    def encrypt_seeded_batch(self, values: np.ndarray, seed: int, group: int,
                             limbs: Optional[int] = None,
                             scale: Optional[float] = None) -> jnp.ndarray:
        """Symmetric seeded encryption of [B, slots] values -> c0 only,
        [B, l, N] uint32 (Montgomery/eval), on the device.  The matching c1
        is `expand_c1(seed, group, B, l)` — regenerate it on-device at use
        time instead of storing/streaming it.  The C++ host engine
        (utils/native.enroll_group) produces the identical c0 stream
        without any device round-trip."""
        hi, lo = self.encode_split(values, scale)
        return self.encrypt_seeded_from_split(hi, lo, seed, group, limbs)

    def encrypt_seeded_batch_host(self, values: np.ndarray, seed: int,
                                  group: int,
                                  limbs: Optional[int] = None,
                                  scale: Optional[float] = None):
        """Host-side counterpart of `encrypt_seeded_batch` via the native
        C++ engine — no device involvement at all (offline enrollment of a
        gallery larger than the device).  Returns
        numpy c0 [B, l, N] or None when the native library is unavailable."""
        from ..utils import native

        if not native.available():
            return None
        values = np.atleast_2d(np.asarray(values, dtype=np.float64))
        l = limbs if limbs is not None else self.Lq
        sc = scale if scale is not None else self.fresh_scale
        coeffs = encoding.encode(values, self.n, sc)
        e = np.rint(self._rng.normal(
            0.0, self.params.sigma, size=coeffs.shape)).astype(np.int64)
        s_std = np.ascontiguousarray(
            self._s_eval_std[:l].astype(np.uint32))
        return native.enroll_group(
            coeffs + e, self.q_np[:l], self.plan.psis_np[:l], s_std,
            seed, group)

    def expand_c1(self, seed: int, group, B: int, l: int) -> jnp.ndarray:
        """Regenerate the seeded c1 for a batch encrypted with
        `encrypt_seeded_batch(seed, group)`: [B, l, N] uint32.  `group`
        may be a traced scalar (one jit serves every group)."""
        return self.uniform_mont(seed, group, (B,), l)

    @functools.partial(jax.jit, static_argnums=(0,))
    def _decrypt_dev(self, state, data):
        with self.bound_state(state):
            return self._decrypt_impl(data)

    def _decrypt_impl(self, data):
        k, l = data.shape[-3], data.shape[-2]
        lim = self.q_limbs(l)
        q, qneg = self._qrow(lim)
        s = self.s_eval[:l]
        m = data[..., 0, :, :]
        spow = s
        for i in range(1, k):
            m = mm.mod_add(m, mm.mont_mul(data[..., i, :, :], spow, q, qneg), q)
            if i + 1 < k:
                spow = mm.mont_mul(spow, s, q, qneg)
        coeff_mont = self.plan.inv(m, lim)
        # from Montgomery: REDC(x) = mont_mul(x, 1)
        one = jnp.ones((l, 1), dtype=jnp.uint32)
        return mm.mont_mul(coeff_mont, one, q, qneg)

    def decrypt_coeffs(self, ct: Ciphertext) -> np.ndarray:
        """-> centered float64 coefficient vector [n]."""
        std = np.asarray(self._decrypt_dev(self.device_state(), ct.data))
        primes = [self.all_primes[i] for i in range(ct.limbs)]
        return encoding.from_rns_centered(std[None, ...], primes)[0]

    def decrypt(self, ct: Ciphertext, num_slots: Optional[int] = None) -> np.ndarray:
        coeffs = self.decrypt_coeffs(ct)
        return encoding.decode(coeffs, self.n, ct.scale, num_slots)

    # ------------------------------------------------------------------
    # basic homomorphic ops
    # ------------------------------------------------------------------

    def _check_scales(self, a: float, b: float):
        if abs(math.log2(a) - math.log2(b)) > 1e-6:
            raise ValueError(f"scale mismatch: {a} vs {b}; use align_to")

    def add(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        l = min(x.limbs, y.limbs)
        x, y = self.drop_to(x, l), self.drop_to(y, l)
        self._check_scales(x.scale, y.scale)
        q, _ = self._qrow(self.q_limbs(l))
        kx, ky = x.ncomp, y.ncomp
        if kx == ky:
            return Ciphertext(mm.mod_add(x.data, y.data, q), x.scale)
        big, small = (x, y) if kx > ky else (y, x)
        head = mm.mod_add(big.data[: small.ncomp], small.data, q)
        return Ciphertext(
            jnp.concatenate([head, big.data[small.ncomp :]], axis=0), x.scale
        )

    def sub(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        return self.add(x, self.neg(y))

    def neg(self, x: Ciphertext) -> Ciphertext:
        q, _ = self._qrow(self.q_limbs(x.limbs))
        return Ciphertext(mm.mod_neg(x.data, q), x.scale)

    def add_scalar(self, x: Ciphertext, c: float) -> Ciphertext:
        """Add constant c to every slot: constant polynomial, exact at the
        ciphertext's scale."""
        l = x.limbs
        val = int(round(c * x.scale))
        consts = np.array(
            [
                mm.host_to_mont(
                    np.array(val % self.all_primes[i], dtype=np.uint32),
                    self.all_primes[i],
                )
                for i in range(l)
            ],
            dtype=np.uint32,
        )[:, None]
        q, _ = self._qrow(self.q_limbs(l))
        c0 = mm.mod_add(x.data[0], jnp.asarray(consts), q)
        return Ciphertext(
            jnp.concatenate([c0[None], x.data[1:]], axis=0), x.scale
        )

    def mul_scalar_int(self, x: Ciphertext, k: int) -> Ciphertext:
        """Exact multiply by a (small) integer; no level, no scale change."""
        l = x.limbs
        consts = np.array(
            [
                mm.host_to_mont(
                    np.array(k % self.all_primes[i], dtype=np.uint32), self.all_primes[i]
                )
                for i in range(l)
            ],
            dtype=np.uint32,
        )[:, None]
        q, qneg = self._qrow(self.q_limbs(l))
        # mont constant: mont_mul(x_mont, k*R) = x*k*R? k stored std -> need
        # (k*R mod q): host_to_mont gives exactly that.
        return Ciphertext(
            mm.mont_mul(x.data, jnp.asarray(consts)[None], q, qneg), x.scale
        )

    def mul_plain(self, x: Ciphertext, pt: Plaintext) -> Ciphertext:
        if pt.data.shape[-2] < x.limbs:
            x = self.drop_to(x, pt.data.shape[-2])
        l = x.limbs
        q, qneg = self._qrow(self.q_limbs(l))
        return Ciphertext(
            mm.mont_mul(x.data, pt.data[None, :l], q, qneg), x.scale * pt.scale
        )

    def mul_scalar(self, x: Ciphertext, c: float, pt_scale: float) -> Ciphertext:
        """Multiply every slot by real constant c encoded at pt_scale (a
        constant polynomial — no encoding FFT needed)."""
        l = x.limbs
        val = int(round(c * pt_scale))
        consts = np.array(
            [
                mm.host_to_mont(
                    np.array(val % self.all_primes[i], dtype=np.uint32),
                    self.all_primes[i],
                )
                for i in range(l)
            ],
            dtype=np.uint32,
        )[:, None]
        q, qneg = self._qrow(self.q_limbs(l))
        return Ciphertext(
            mm.mont_mul(x.data, jnp.asarray(consts)[None], q, qneg),
            x.scale * pt_scale,
        )

    def mul(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        """Tensor product without relinearization (EvalMultNoRelin,
        the hot op of every sender: e.g. reference src/sender/sender_diag.cpp:93)."""
        assert x.ncomp == 2 and y.ncomp == 2, "relinearize first"
        l = min(x.limbs, y.limbs)
        x, y = self.drop_to(x, l), self.drop_to(y, l)
        q, qneg = self._qrow(self.q_limbs(l))
        x0, x1 = x.data[0], x.data[1]
        y0, y1 = y.data[0], y.data[1]
        c0 = mm.mont_mul(x0, y0, q, qneg)
        c1 = mm.mod_add(
            mm.mont_mul(x0, y1, q, qneg), mm.mont_mul(x1, y0, q, qneg), q
        )
        c2 = mm.mont_mul(x1, y1, q, qneg)
        return Ciphertext(jnp.stack([c0, c1, c2]), x.scale * y.scale)

    def square(self, x: Ciphertext) -> Ciphertext:
        assert x.ncomp == 2
        l = x.limbs
        q, qneg = self._qrow(self.q_limbs(l))
        x0, x1 = x.data[0], x.data[1]
        c0 = mm.mont_mul(x0, x0, q, qneg)
        m = mm.mont_mul(x0, x1, q, qneg)
        c1 = mm.mod_add(m, m, q)
        c2 = mm.mont_mul(x1, x1, q, qneg)
        return Ciphertext(jnp.stack([c0, c1, c2]), x.scale * x.scale)

    def drop_to(self, x: Ciphertext, l: int) -> Ciphertext:
        """Free modulus reduction: drop top limbs (scale unchanged)."""
        if x.limbs == l:
            return x
        assert x.limbs > l
        return Ciphertext(x.data[:, :l, :], x.scale)

    def rescale(self, x: Ciphertext) -> Ciphertext:
        """Divide by the top prime (FIXEDMANUAL RescaleInPlace)."""
        l = x.limbs
        assert l >= 2, "cannot rescale below guard level"
        qt = int(self.all_primes[l - 1])
        lim_rest = self.q_limbs(l - 1)
        q, qneg = self._qrow(lim_rest)
        r2 = self.r2[np.asarray(lim_rest, dtype=np.int32)][:, None]
        qt_u = jnp.uint32(qt)
        # top limb -> coeff std
        top = x.data[:, l - 1 : l, :]
        top_c = self.plan.inv(top, (l - 1,))
        one = jnp.ones((1, 1), dtype=jnp.uint32)
        qrow_t, qneg_t = self._qrow((l - 1,))
        top_std = mm.mont_mul(top_c, one, qrow_t, qneg_t)  # [k,1,N] std < qt
        # centered transfer mod each remaining prime
        half = jnp.uint32(qt // 2)
        pos = mm.reduce_small(top_std, q)  # broadcast [k, l-1, N]
        negv = mm.mod_neg(mm.reduce_small(qt_u - top_std, q), q)
        t_std = jnp.where(top_std <= half, pos, negv)
        t_mont = mm.mont_mul(t_std, r2, q, qneg)
        t_eval = self.plan.fwd(t_mont, lim_rest)
        diff = mm.mod_sub(x.data[:, : l - 1, :], t_eval, q)
        qtinv = np.array(
            [
                pow(qt, -1, self.all_primes[i]) * ((1 << 32) % self.all_primes[i])
                % self.all_primes[i]
                for i in range(l - 1)
            ],
            dtype=np.uint32,
        )[:, None]
        out = mm.mont_mul(diff, jnp.asarray(qtinv), q, qneg)
        return Ciphertext(out, x.scale / qt)

    # ------------------------------------------------------------------
    # key switching
    # ------------------------------------------------------------------

    def _fbc_consts(self, src: Tuple[int, ...], dst: Tuple[int, ...]):
        """Fast-base-conversion constants from source primes to target
        primes (limb indices into all_primes)."""
        key = (src, dst)
        if key in self._fbc_cache:
            return self._fbc_cache[key]
        R = 1 << 32
        src_p = [self.all_primes[i] for i in src]
        dst_p = [self.all_primes[i] for i in dst]
        QG = 1
        for q in src_p:
            QG *= q
        t_std = np.array(
            [
                pow((QG // q) % q, -1, q)
                for q in src_p
            ],
            dtype=np.uint32,
        )[:, None]  # standard-form multiplier: y_i = x_i * t_i
        qhat = np.array(
            [[(QG // sq) * R * R % dq for dq in dst_p] for sq in src_p],
            dtype=np.uint32,
        )  # [g, t]: (Qhat_i * R^2) mod p
        qg_r2 = np.array([QG * R * R % dq for dq in dst_p], dtype=np.uint32)[:, None]
        inv_q = np.array([1.0 / q for q in src_p], dtype=np.float32)[:, None]
        # cache host-side numpy only: device conversion must happen fresh
        # inside each trace, or cached tracers would leak across jits
        out = (t_std, qhat, qg_r2, inv_q)
        self._fbc_cache[key] = out
        return out

    def _fbc(self, x_mont: jnp.ndarray, src: Tuple[int, ...], dst: Tuple[int, ...]):
        """Fast base conversion of coeff-domain Montgomery residues
        [..., g, N] (basis src) -> [..., t, N] (basis dst), approximate
        (±1 multiple of Q_src, standard for hybrid key switching)."""
        t_std, qhat, qg_r2, inv_q = self._fbc_consts(src, dst)
        qs, qnegs = self._qrow(src)
        qd, qnegd = self._qrow(dst)
        y = mm.mont_mul(x_mont, t_std, qs, qnegs)  # standard form, [.., g, N]
        v = jnp.round(jnp.sum(y.astype(jnp.float32) * inv_q, axis=-2)).astype(
            jnp.uint32
        )  # [.., N]
        # out[p] = sum_i y_i * qhat[i, p] - v * QG   (all Montgomery mod p)
        g = len(src)
        acc = None
        for i in range(g):
            term = mm.mont_mul(
                y[..., i : i + 1, :], qhat[i][:, None], qd, qnegd
            )  # [.., t, N]
            acc = term if acc is None else mm.mod_add(acc, term, qd)
        corr = mm.mont_mul(v[..., None, :], qg_r2, qd, qnegd)
        return mm.mod_sub(acc, corr, qd)

    def _decompose_extended(self, poly_eval: jnp.ndarray, l: int) -> jnp.ndarray:
        """Hoisting precompute: digit-decompose an eval-domain poly [l, N]
        and extend every digit to the full current basis Q_l + P.
        Returns [ndig, l + S, N] eval Montgomery."""
        lim = self.q_limbs(l)
        coeff = self.plan.inv(poly_eval, lim)
        ext = self.ext_limbs(l)
        digs = []
        for grp in self.groups:
            g = [i for i in grp if i < l]
            if not g:
                continue
            x = coeff[g, :]
            other = tuple(i for i in ext if i not in g)
            conv = self._fbc(x, tuple(g), other)
            # reassemble rows in ext order: own rows copied exactly
            rows = []
            ci = 0
            for i in ext:
                if i in g:
                    rows.append(x[g.index(i)])
                else:
                    rows.append(conv[ci])
                    ci += 1
            dig = jnp.stack(rows)
            digs.append(self.plan.fwd(dig, ext))
        return jnp.stack(digs)

    def _ksk_rows(self, ksk: jnp.ndarray, l: int) -> jnp.ndarray:
        return jnp.concatenate([ksk[:, :, :l], ksk[:, :, self.Lq :]], axis=2)

    def _moddown(self, comp: jnp.ndarray, l: int) -> jnp.ndarray:
        """[l + S, N] eval over Q_l + P -> [l, N] eval over Q_l, dividing
        by P (with centered correction)."""
        sp = self.sp_limbs()
        lim = self.q_limbs(l)
        part_p = comp[l:]
        part_q = comp[:l]
        cp = self.plan.inv(part_p, sp)
        # centered FBC: shift by +P/2 before conversion, subtract after
        P = 1
        for q in self.params.sp_primes:
            P *= q
        qsp, qnegsp = self._qrow(sp)
        half_rows = np.array(
            [
                mm.host_to_mont(
                    np.array((P // 2) % self.all_primes[i], dtype=np.uint32),
                    self.all_primes[i],
                )
                for i in sp
            ],
            dtype=np.uint32,
        )[:, None]
        cp_shift = mm.mod_add(cp, jnp.asarray(half_rows), qsp)
        conv = self._fbc(cp_shift, sp, lim)
        qd, qnegd = self._qrow(lim)
        halfq = np.array(
            [
                mm.host_to_mont(
                    np.array((P // 2) % self.all_primes[i], dtype=np.uint32),
                    self.all_primes[i],
                )
                for i in lim
            ],
            dtype=np.uint32,
        )[:, None]
        conv = mm.mod_sub(conv, jnp.asarray(halfq), qd)
        conv_eval = self.plan.fwd(conv, lim)
        diff = mm.mod_sub(part_q, conv_eval, qd)
        pinv = np.array(
            [
                pow(P % self.all_primes[i], -1, self.all_primes[i])
                * ((1 << 32) % self.all_primes[i])
                % self.all_primes[i]
                for i in lim
            ],
            dtype=np.uint32,
        )[:, None]
        return mm.mont_mul(diff, jnp.asarray(pinv), qd, qnegd)

    def _keyswitch_digits(self, digs: jnp.ndarray, ksk: jnp.ndarray, l: int):
        """digs [ndig, l+S, N] x ksk -> (d0, d1) each [l, N] over Q_l."""
        rows = self._ksk_rows(ksk, l)  # [ndig, 2, l+S, N]
        ext = self.ext_limbs(l)
        q, qneg = self._qrow(ext)
        acc0 = acc1 = None
        for j in range(digs.shape[0]):
            t0 = mm.mont_mul(digs[j], rows[j, 0], q, qneg)
            t1 = mm.mont_mul(digs[j], rows[j, 1], q, qneg)
            acc0 = t0 if acc0 is None else mm.mod_add(acc0, t0, q)
            acc1 = t1 if acc1 is None else mm.mod_add(acc1, t1, q)
        return self._moddown(acc0, l), self._moddown(acc1, l)

    def keyswitch(self, poly_eval: jnp.ndarray, ksk: jnp.ndarray) -> Tuple:
        l = poly_eval.shape[-2]
        digs = self._decompose_extended(poly_eval, l)
        return self._keyswitch_digits(digs, ksk, l)

    def relinearize(self, x: Ciphertext) -> Ciphertext:
        if x.ncomp == 2:
            return x
        assert x.ncomp == 3
        l = x.limbs
        d0, d1 = self.keyswitch(x.data[2], self.relin_key)
        q, _ = self._qrow(self.q_limbs(l))
        c0 = mm.mod_add(x.data[0], d0, q)
        c1 = mm.mod_add(x.data[1], d1, q)
        return Ciphertext(jnp.stack([c0, c1]), x.scale)

    def mul_relin(self, x: Ciphertext, y: Ciphertext) -> Ciphertext:
        return self.relinearize(self.mul(x, y))

    # ------------------------------------------------------------------
    # rotations
    # ------------------------------------------------------------------

    def _permute(self, data: jnp.ndarray, g: int) -> jnp.ndarray:
        perm = self.plan.auto_perm(g)
        return jnp.take(data, perm, axis=-1)

    def rotate(self, x: Ciphertext, r: int) -> Ciphertext:
        """EvalRotate: left-rotate slots by r (requires key for this r)."""
        if r % self.slots == 0:
            return x
        g = self.rotation_galois(r)
        if g not in self.rot_keys:
            raise KeyError(f"no rotation key for r={r} (g={g})")
        assert x.ncomp == 2
        l = x.limbs
        _, key = self._rot_entry(g)
        c0 = self._permute(x.data[0], g)
        c1 = self._permute(x.data[1], g)
        d0, d1 = self.keyswitch(c1, key)
        q, _ = self._qrow(self.q_limbs(l))
        return Ciphertext(jnp.stack([mm.mod_add(c0, d0, q), d1]), x.scale)

    def rotate_any(self, x: Ciphertext, r: int) -> Ciphertext:
        """One direct keyswitch when a key for exactly r exists (e.g. the
        merge-chain amounts requested via Sender.required_rotations),
        else the signed power-of-two decomposition — halves the keyswitch
        count of merge_single's rotate-add chain."""
        if r % self.slots == 0:
            return x
        if self.rotation_galois(r) in self.rot_keys:
            return self.rotate(x, r)
        return self.binary_rotate(x, r)

    def binary_rotate(self, x: Ciphertext, r: int) -> Ciphertext:
        """Arbitrary rotation via signed nearest-power-of-two steps using
        only ±2^k keys (reference binaryRotate,
        src/openFHE_wrapper.cpp:103-128)."""
        factor = r
        while factor != 0:
            sign = 1 if factor > 0 else -1
            step = 2 ** int(round(math.log2(abs(factor))))
            cur = (step * sign) % self.slots
            if cur != 0:
                x = self.rotate(x, step * sign)
            factor -= step * sign
        return x

    def hoisted_precompute(self, x: Ciphertext) -> jnp.ndarray:
        """EvalFastRotationPrecompute: digit-decompose+extend c1 once."""
        return self._decompose_extended(x.data[1], x.limbs)

    def hoisted_rotate(self, x: Ciphertext, digs: jnp.ndarray, r: int) -> Ciphertext:
        """EvalFastRotation using precomputed digits (reference
        src/sender/sender_diag.cpp:22-26)."""
        if r % self.slots == 0:
            return x
        g = self.rotation_galois(r)
        l = x.limbs
        _, key = self._rot_entry(g)
        pdigs = self._permute(digs, g)
        d0, d1 = self._keyswitch_digits(pdigs, key, l)
        c0 = self._permute(x.data[0], g)
        q, _ = self._qrow(self.q_limbs(l))
        return Ciphertext(jnp.stack([mm.mod_add(c0, d0, q), d1]), x.scale)

    def _rot_rows(self, rots: Sequence[int]):
        """Stacked (perms [R, N], keys [R, ...]) for the given rotations —
        rows gathered from the stored sets (zero-copy when they form a
        prefix of one set)."""
        locs = [self.rot_keys[self.rotation_galois(r)] for r in rots]
        common = set(locs[0])
        for d in locs[1:]:
            common &= set(d)
        assert common, "rotations must share one key set"
        sid = min(common)
        rows = [d[sid] for d in locs]
        perms, keys = self._rot_sets[sid]
        if rows == list(range(len(rows))):
            return perms[: len(rows)], keys[: len(rows)]
        idx = np.asarray(rows, dtype=np.int32)
        return perms[idx], keys[idx]

    def hoisted_rotate_stack(self, x: Ciphertext, digs: jnp.ndarray,
                             rots: Sequence[int]) -> jnp.ndarray:
        """Batch of hoisted rotations as ONE vmapped keyswitch body:
        -> data [len(rots), 2, l, N].  The batched fan-out replacing
        the reference's OpenMP loop over EvalFastRotation
        (src/sender/sender_diag.cpp:23-26)."""
        l = x.limbs
        perms, keys = self._rot_rows(rots)
        q, _ = self._qrow(self.q_limbs(l))

        def one(perm, key):
            pdigs = jnp.take(digs, perm, axis=-1)
            d0, d1 = self._keyswitch_digits(pdigs, key, l)
            c0 = jnp.take(x.data[0], perm, axis=-1)
            return jnp.stack([mm.mod_add(c0, d0, q), d1])

        return jax.vmap(one)(perms, keys)

    def rotate_stack(self, data: jnp.ndarray, rots: Sequence[int],
                     scale: float) -> jnp.ndarray:
        """Rotate a stack of ciphertexts [R, 2, l, N] by per-row rotation
        amounts — one vmapped keyswitch body."""
        l = data.shape[-2]
        perms, keys = self._rot_rows(rots)
        q, _ = self._qrow(self.q_limbs(l))

        def one(d, perm, key):
            c0 = jnp.take(d[0], perm, axis=-1)
            c1 = jnp.take(d[1], perm, axis=-1)
            d0, d1 = self.keyswitch(c1, key)
            return jnp.stack([mm.mod_add(c0, d0, q), d1])

        return jax.vmap(one)(data, perms, keys)

    def rotate_rows_binary(self, data: jnp.ndarray,
                           rots: Sequence[int]) -> jnp.ndarray:
        """Rotate every row of a [R, 2, l, N] ciphertext stack by its OWN
        arbitrary amount using only the +2^k rotation keys: one scanned
        bit-stage loop whose body is a single vmapped keyswitch, with a
        per-(stage, row) select mask.

        This is the graph-compact replacement for looping binary_rotate
        over R ciphertexts (reference mergeCiphers/compressCiphers,
        src/openFHE_wrapper.cpp:191-312, rotate each output ciphertext
        independently): the unrolled form emits O(R * log slots)
        keyswitch bodies (44 MB of MLIR at R=128, minutes to compile and
        out of compiler memory); this form emits
        O(active bit-stages) bodies regardless of R."""
        R = data.shape[0]
        amounts = [r % self.slots for r in rots]
        assert len(amounts) == R
        nbits = int(math.log2(self.slots))
        used = [k for k in range(nbits) if any((a >> k) & 1 for a in amounts)]
        if not used:
            return data
        perms, keys = self._rot_rows([1 << k for k in used])
        masks = jnp.asarray(
            np.asarray([[(a >> k) & 1 for a in amounts] for k in used],
                       np.uint32))  # [S, R]
        l = data.shape[-2]
        q, _ = self._qrow(self.q_limbs(l))

        def stage(carry, pkm):
            perm, key, m = pkm

            def one(d):
                c0 = jnp.take(d[0], perm, axis=-1)
                c1 = jnp.take(d[1], perm, axis=-1)
                d0, d1 = self.keyswitch(c1, key)
                return jnp.stack([mm.mod_add(c0, d0, q), d1])

            rot = jax.vmap(one)(carry)
            sel = m[:, None, None, None]
            return jnp.where(sel == 1, rot, carry), None

        out, _ = jax.lax.scan(stage, data, (perms, keys, masks))
        return out

    def eval_sum(self, x: Ciphertext, m: int) -> Ciphertext:
        """Every slot j becomes sum of slots j..j+m-1 (cyclic): log2(m)
        rotate-and-add steps (reference sumAllSlots / EvalSum), run as one
        scanned keyswitch body over the power-of-two key-set prefix."""
        if m <= 1:
            return x
        steps = int(math.log2(m))
        rots = [1 << k for k in range(steps)]
        perms, keys = self._rot_rows(rots)
        l = x.limbs
        q, _ = self._qrow(self.q_limbs(l))

        def body(carry, pk):
            perm, key = pk
            c0 = jnp.take(carry[0], perm, axis=-1)
            c1 = jnp.take(carry[1], perm, axis=-1)
            d0, d1 = self.keyswitch(c1, key)
            rot = jnp.stack([mm.mod_add(c0, d0, q), d1])
            return mm.mod_add(carry, rot, q), None

        out, _ = jax.lax.scan(body, x.data, (perms, keys))
        return Ciphertext(out, x.scale)

    # ------------------------------------------------------------------
    # introspection (reference printSchemeDetails / printCipherDetails,
    # src/openFHE_wrapper.cpp:47-70)
    # ------------------------------------------------------------------

    def scheme_summary(self) -> str:
        p = self.params
        logqp = sum(math.log2(q) for q in self.all_primes)
        return (
            f"CKKS-RNS: ring dim {p.ring_dim}, batch {self.slots}, "
            f"mult depth {p.mult_depth}, scaling 2^{p.scale_bits}, "
            f"{self.Lq} limbs + {self.S} special, dnum {self.dnum}, "
            f"log2(QP) = {logqp:.1f}, security {p.security}"
        )

    def cipher_summary(self, ct: Ciphertext) -> str:
        return (
            f"Ciphertext: {ct.ncomp} components, {ct.limbs} limbs "
            f"(level {self.Lq - ct.limbs}), scale 2^{math.log2(ct.scale):.2f}, "
            f"slots {self.slots}"
        )

    # ------------------------------------------------------------------
    # scale alignment
    # ------------------------------------------------------------------

    def align_to(self, x: Ciphertext, limbs: int, scale: float) -> Ciphertext:
        """Bring x to exactly (limbs, scale) using free limb drops and, if
        the scale differs, one spare level (multiply by 1.0 at the
        correcting scale, then rescale)."""
        if x.limbs == limbs and abs(math.log2(x.scale / scale)) < 1e-9:
            return x
        if abs(math.log2(x.scale / scale)) < 1e-9:
            return self.drop_to(x, limbs)
        assert x.limbs > limbs, "no spare level for scale alignment"
        x = self.drop_to(x, limbs + 1)
        qt = int(self.all_primes[limbs])
        sigma = scale * qt / x.scale
        y = self.mul_scalar(x, 1.0, sigma)
        y = self.rescale(y)
        # exact by construction up to float rounding of sigma
        return Ciphertext(y.data, scale)
