"""CKKS parameter selection: NTT-friendly primes, roots of unity, security.

The reference delegates this to OpenFHE (GenCryptoContext with
HEStd_128_classic / ScalingModSize 45, reference src/main.cpp:169-179).
Here we pick our own RNS basis tailored to 32-bit word arithmetic:

* all primes q < 2^31 and q ≡ 1 (mod 2N) so the negacyclic NTT exists and
  uint32 lazy arithmetic never overflows;
* scaling primes as close as possible to the target scale 2^SCALE_BITS,
  chosen alternately above/below so cumulative scale drift stays tiny
  (exact per-ciphertext scales are tracked regardless);
* a larger "first" prime q0 and special (key-switching) primes near 2^30.

Because our word primes are ~28 bits instead of OpenFHE's 45-60 bit limbs,
the same multiplicative depth needs roughly half the total modulus bits,
which lets us run ring dimension 32768 where the reference needs 65536 —
half the work and memory per ciphertext.

Security follows the homomorphic encryption standard table for classical
128-bit security (ternary secret):  log2(QP) <= 438 @ N=16384,
881 @ N=32768, 1772 @ N=65536.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Tuple

import numpy as np

# max log2(Q*P) for HEStd_128_classic, ternary secrets
_SECURITY_TABLE_128C = {
    1024: 27,
    2048: 54,
    4096: 109,
    8192: 218,
    16384: 438,
    32768: 881,
    65536: 1772,
}


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_primes_near(target: int, step: int, count: int, exclude=()) -> List[int]:
    """Find `count` primes ≡ 1 (mod step) nearest `target`, alternating
    above/below so products track target^count as closely as possible."""
    excl = set(exclude)
    base = (target // step) * step + 1
    found: List[Tuple[int, int]] = []  # (|p - target|, p)
    k = 0
    while len(found) < count * 8 and k < 1 << 22:
        for cand in (base + k * step, base - k * step) if k else (base,):
            if cand > 1 and cand < (1 << 31) and cand not in excl and _is_prime(cand):
                if all(p != cand for _, p in found):
                    found.append((abs(cand - target), cand))
        k += 1
    found.sort()
    cands = [p for _, p in found]
    if len(cands) < count:
        raise ValueError(f"not enough primes near {target} (step {step})")
    # greedy pick keeping the running product close to target^i
    picked: List[int] = []
    log_t = math.log2(target)
    drift = 0.0
    remaining = list(cands)
    for _ in range(count):
        best = min(remaining, key=lambda p: abs(drift + math.log2(p) - log_t))
        drift += math.log2(best) - log_t
        picked.append(best)
        remaining.remove(best)
    return picked


def _primitive_root(q: int) -> int:
    """Smallest generator of Z_q^*."""
    factors = []
    phi = q - 1
    n = phi
    d = 2
    while d * d <= n:
        if n % d == 0:
            factors.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        factors.append(n)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError("no generator")


def root_of_unity(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod q (order | q-1)."""
    assert (q - 1) % order == 0
    g = _primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    # primitivity check
    assert pow(w, order, q) == 1 and pow(w, order // 2, q) == q - 1
    return w


@dataclasses.dataclass(frozen=True)
class SchemeParams:
    """Static CKKS scheme parameters (hashable: keys jit caches).

    mult_depth: rescales available to the circuit (reference
    computeRequiredDepth, src/openFHE_wrapper.cpp:6-44).
    One guard limb is kept so decryption always sees >= 2 limbs.
    """

    ring_dim: int = 32768
    mult_depth: int = 11
    scale_bits: int = 30
    first_mod_bits: int = 30
    dnum: int = 3  # hybrid key-switching digits
    security: str = "128c"  # "128c" or "none" (tests)
    sigma: float = 3.19
    # Fresh ciphertexts are encrypted at scale ~ Delta^{(2+fresh_levels)/2}
    # so public-key encryption noise (~sqrt(2N/3)*sigma*sqrt(N) absolute)
    # stays ~2^-30 below the 1e-4 score-parity bar even though our word
    # primes cap Delta at ~2^30; the first ct*ct product then rescales
    # 1+fresh_levels times.  Costs one extra limb of depth.
    fresh_levels: int = 1

    q_primes: Tuple[int, ...] = ()  # filled by `create`
    sp_primes: Tuple[int, ...] = ()

    @property
    def n(self) -> int:
        return self.ring_dim

    @property
    def slots(self) -> int:
        return self.ring_dim // 2

    @property
    def num_limbs(self) -> int:
        return len(self.q_primes)

    @property
    def num_special(self) -> int:
        return len(self.sp_primes)

    @property
    def scale(self) -> float:
        return float(2 ** self.scale_bits)

    @staticmethod
    def create(
        ring_dim: int = 32768,
        mult_depth: int = 11,
        scale_bits: int = 30,
        first_mod_bits: int = 30,
        dnum: int = 3,
        security: str = "128c",
        sigma: float = 3.19,
        fresh_levels: int = 1,
    ) -> "SchemeParams":
        # limbs: q0 + mult_depth scaling + 1 guard (decode needs 2 limbs)
        # + fresh_levels extra rescales for the high-scale fresh encryption
        n_scaling = mult_depth + 1 + fresh_levels
        step = 2 * ring_dim
        q0 = find_primes_near(1 << first_mod_bits, step, 1)
        scaling = find_primes_near(1 << scale_bits, step, n_scaling, exclude=q0)
        q_primes = tuple(q0 + scaling[::-1])  # q0 first; top of the chain last
        # special primes: P must exceed the largest digit product
        n_limbs = len(q_primes)
        group = math.ceil(n_limbs / dnum)
        digit_bits = group * max(scale_bits, first_mod_bits)
        sp_bits = 30
        n_special = math.ceil((digit_bits + scale_bits) / sp_bits)
        sp = find_primes_near(1 << sp_bits, step, n_special, exclude=q_primes)
        params = SchemeParams(
            ring_dim=ring_dim,
            mult_depth=mult_depth,
            scale_bits=scale_bits,
            first_mod_bits=first_mod_bits,
            dnum=dnum,
            security=security,
            sigma=sigma,
            fresh_levels=fresh_levels,
            q_primes=q_primes,
            sp_primes=tuple(sp),
        )
        if security == "128c":
            logqp = sum(math.log2(p) for p in q_primes + tuple(sp))
            budget = _SECURITY_TABLE_128C.get(ring_dim, 0)
            if logqp > budget:
                raise ValueError(
                    f"log2(QP)={logqp:.1f} exceeds 128-bit budget {budget} "
                    f"for N={ring_dim}; increase ring_dim"
                )
        return params

    def limbs_for_level(self, level: int) -> int:
        """Number of RNS limbs for a ciphertext at `level` (level 0 =
        fresh).  level counts consumed rescales."""
        return self.num_limbs - level


@functools.lru_cache(maxsize=None)
def compute_required_depth(approach: int, comp_depth: int = 10, alpha_depth: int = 2) -> int:
    """Multiplicative depth budget per approach.

    Mirrors reference src/openFHE_wrapper.cpp:6-44 exactly (including the
    GROTE "+3" slack the reference carries, src/openFHE_wrapper.cpp:22).
    """
    if approach == 1:  # literature baseline: score + merge + compare
        return 1 + 2 + comp_depth
    if approach == 2:  # GROTE: score + merge + alpha + slack + compare
        return 1 + 2 + alpha_depth + 3 + comp_depth
    if approach == 3:  # blind-match: score + compression + compare
        return 1 + 1 + comp_depth
    if approach == 4:  # HERS: score + compare
        return 1 + comp_depth
    if approach == 5:  # HyDia diagonal: score + compare
        return 1 + comp_depth
    raise ValueError(f"approach must be 1..5, got {approach}")
