#!/usr/bin/env python
"""Kernel timings on the GPU: each hot primitive of the CKKS runtime at
production parameters (ring 32768, full limb chain, a batch of 64
ciphertexts) with its effective device-memory bandwidth against the card's
peak.

All CKKS primitives here are uint32 elementwise/permute work, not matrix
products, so the speed-of-light bound is memory bandwidth: a kernel at
X GB/s effective is at X / peak of its roofline.  Each row also names the
card and its power limit (a card set below 700 W runs slower under load).

  python tools/kernel_bench.py [--out FILE]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Device-memory bandwidth peaks in GB/s, keyed by JAX's device_kind.
# Source: NVIDIA H100 data sheet (SXM5 part, 80 GB HBM3, 3.35 TB/s).
HBM_PEAK_GBS = {"NVIDIA H100 80GB HBM3": 3350}


def peak_gbs(kind: str) -> float:
    if kind not in HBM_PEAK_GBS:
        raise KeyError(f"no bandwidth peak recorded for device {kind!r}; "
                       f"add it to HBM_PEAK_GBS with its source")
    return HBM_PEAK_GBS[kind]


def run(ring: int = 32768, batch: int = 64, reps: int = 20) -> dict:
    import jax
    import numpy as np
    from image_matching.ckks.params import SchemeParams
    from image_matching.ckks.context import CkksContext, Ciphertext
    from image_matching.ops import modmath as mm
    from image_matching.matching.senders import ct_dot
    from image_matching.utils import device

    devs = jax.devices()
    device.require_gpu(devs)
    dev = devs[0]
    peak = peak_gbs(dev.device_kind)

    params = SchemeParams.create(ring_dim=ring, mult_depth=14,
                                 security="128c" if ring >= 32768 else "none")
    ctx = CkksContext(params, seed=0)
    ctx.gen_power_of_two_rotation_keys()
    ctx.gen_rotation_keys(list(range(1, 23)), force=True)
    l = ctx.Lq
    N = ctx.n
    B = batch
    rng = np.random.default_rng(0)
    qh = np.asarray(ctx._qrow(ctx.q_limbs(l))[0])  # [l,1]
    stack = jax.device_put(
        rng.integers(0, 2 ** 31, (B, l, N)).astype(np.uint32) % qh, dev)
    ct2 = jax.device_put(
        rng.integers(0, 2 ** 31, (B, 2, l, N)).astype(np.uint32) % qh, dev)
    state = ctx.device_state()
    results = {"device": {**device.describe(devs), "card": device.card_info()},
               "hbm_peak_GBs": peak, "ring": ring, "limbs": int(l),
               "batch": B, "kernels": {}}

    def timed(name, fn, *xs, bytes_touched=None):
        jf = jax.jit(fn)
        out = jax.block_until_ready(jf(*xs))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = jf(*xs)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        row = {"ms": dt * 1e3}
        if bytes_touched:
            gbs = bytes_touched / dt / 1e9
            row["eff_GBs"] = gbs
            row["pct_of_hbm_peak"] = 100 * gbs / peak
        results["kernels"][name] = row
        print(name, row, flush=True)
        return out

    lim = ctx.q_limbs(l)
    io_bytes = stack.size * 4 * 2  # read + write once

    def ntt_fwd(s, x):
        with ctx.bound_state(s):
            return ctx.plan.fwd(x, lim)

    def ntt_inv(s, x):
        with ctx.bound_state(s):
            return ctx.plan.inv(x, lim)

    def mont_mul_k(s, x):
        with ctx.bound_state(s):
            q, qneg = ctx._qrow(lim)
            return mm.mont_mul(x, x, q, qneg)

    # the similarity contraction: B ct-ct mults fused into one mont_dot
    def similarity(s, A):
        with ctx.bound_state(s):
            return ct_dot(ctx, A, A)

    def relin(s, x):
        with ctx.bound_state(s):
            t3 = ct_dot(ctx, x, x)
            ct = Ciphertext(t3, ctx.fresh_scale ** 2)
            return ctx.rescale_score(ctx.relinearize(ct)).data

    def hoist(s, x):
        with ctx.bound_state(s):
            c = Ciphertext(x, ctx.fresh_scale)
            digs = ctx.hoisted_precompute(c)
            return ctx.hoisted_rotate_stack(c, digs, list(range(1, 23)))

    timed(f"ntt_fwd[{B}x{l}x{N}]", ntt_fwd, state, stack,
          bytes_touched=io_bytes)
    timed(f"ntt_inv[{B}x{l}x{N}]", ntt_inv, state, stack,
          bytes_touched=io_bytes)
    timed(f"mont_mul[{B}x{l}x{N}]", mont_mul_k, state, stack,
          bytes_touched=io_bytes)
    timed(f"ct_dot[{B}ct]", similarity, state, ct2,
          bytes_touched=ct2.size * 4 * 2)
    timed(f"ctmult_relin_rescale[{B}ct_dot]", relin, state, ct2,
          bytes_touched=ct2.size * 4 * 2)
    timed("hoisted_rotate_22", hoist, state, ct2[0],
          bytes_touched=22 * 2 * l * N * 4 * 2)
    _compare(ctx, state, ct2, timed)
    return results


def _compare(ctx, state, ct2, timed):
    """Compare on production-shaped scores: one relin+rescale below fresh
    level, scale tracked exactly (a fresh-scale input desyncs the
    Paterson-Stockmeyer level planner)."""
    import jax
    from image_matching.ckks import poly_eval
    from image_matching.ckks.context import Ciphertext
    from image_matching.matching.senders import ct_dot

    box = [None]
    # ncmp independent scores: ct_dot CONTRACTS its leading axis, so each
    # score is built from its own group of B // ncmp ciphertexts
    ncmp = 4
    grp = ct2.reshape(ncmp, ct2.shape[0] // ncmp, *ct2.shape[1:])

    def score_like_inner(g):
        t3 = ct_dot(ctx, g, g)
        ct = ctx.rescale_score(
            ctx.relinearize(Ciphertext(t3, ctx.fresh_scale ** 2)))
        box[0] = ct.scale
        return ct.data

    def scores_like(s, x):
        with ctx.bound_state(s):
            return jax.vmap(score_like_inner)(x)

    sc = jax.block_until_ready(jax.jit(scores_like)(state, grp))

    def compare(s, x):
        with ctx.bound_state(s):
            def one(d):
                return poly_eval.chebyshev_compare(
                    ctx, Ciphertext(d, box[0]), 0.44, 10).data
            return jax.vmap(one)(x)

    timed(f"chebyshev_compare_d10[{ncmp}]", compare, state, sc)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--ring", type=int, default=32768)
    ap.add_argument("--batch", type=int, default=64,
                    help="ciphertexts per batched kernel call")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    from image_matching.utils.jaxcfg import enable_compilation_cache
    enable_compilation_cache()
    results = run(args.ring, args.batch, args.reps)
    print(json.dumps(results))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
