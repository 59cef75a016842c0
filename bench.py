#!/usr/bin/env python
"""Benchmark: HyDia (approach 5) encrypted membership query on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "correct": bool, "device": {"platform", "kind", "count", "card"}, ...}

`value` is the fastest of the steady-state runs (compilation excluded);
`setup_s` (key generation + enrollment) and `compile_first_s` are set-up
costs reported beside it.  The run exits non-zero when any run decrypts
to a wrong result.

Baseline: reference server membership computation time at the same DB size
on a 48-core Xeon (BASELINE.md, tools/figures/approach5.csv).

Refuses to time anything but a GPU, unless JAX_PLATFORMS=cpu is set
explicitly (a CPU rehearsal at a tiny size, never a device number).

Env knobs:
  BENCH_LOG2N     log2 of DB size (default 20 — the north-star size)
  BENCH_RING      ring dimension (default 32768)
  BENCH_SCENARIO  membership (default) | index
  BENCH_APPROACH  1..5 (default 5)
  BENCH_STREAM    1 = host-streamed seed-compressed DB (default at >= 2^16)
  BENCH_METRIC    ctmult = relinearized ct-ct multiply rate instead
"""

import json
import os
import sys
import time

import numpy as np

STEADY_REPS = 3

# Reference seconds by (approach, log2n) — BASELINE.md table
# (tools/figures/approach{1..5}.csv: membership / identification).
APPROACH_NAMES = {1: "baseline", 2: "grote", 3: "blind", 4: "hers",
                  5: "hydia"}
REF = {
    (1, 10): (11.53, 11.35), (1, 11): (17.10, 16.84),
    (1, 12): (35.86, 35.58), (1, 13): (64.59, 64.22),
    (1, 14): (133.76, 135.78), (1, 15): (264.69, 265.53),
    (2, 10): (17.45, 20.64), (2, 11): (25.18, 28.30),
    (2, 12): (48.68, 50.74), (2, 13): (89.65, 92.06),
    (2, 14): (175.18, 176.00), (2, 15): (338.36, 336.71),
    (3, 10): (8.50, 8.14), (3, 11): (12.97, 12.80),
    (3, 12): (22.00, 21.04), (3, 13): (40.08, 39.51),
    (3, 14): (79.66, 79.95), (3, 15): (161.15, 161.19),
    (4, 10): (4.28, 3.46), (4, 11): (4.17, 3.49), (4, 12): (4.13, 3.46),
    (4, 13): (4.17, 3.28), (4, 14): (4.17, 3.47), (4, 15): (6.21, 5.37),
    (4, 16): (9.84, 9.11), (4, 17): (16.99, 15.84),
    (4, 18): (30.97, 28.77), (4, 19): (58.15, 54.03),
    (4, 20): (115.54, 110.91),
    (5, 10): (5.89, 4.68), (5, 11): (4.46, 4.19), (5, 12): (4.54, 4.20),
    (5, 13): (4.49, 4.35), (5, 14): (4.52, 4.18), (5, 15): (6.16, 5.85),
    (5, 16): (9.56, 9.01), (5, 17): (16.01, 15.47),
    (5, 18): (28.73, 27.63), (5, 19): (53.25, 49.70),
    (5, 20): (102.41, 96.52),
}


def bench_ctmult() -> dict:
    """Secondary metric: relinearized ct-ct mult ops/s on one device."""
    import jax
    from image_matching.ckks.params import SchemeParams
    from image_matching.ckks.context import CkksContext, Ciphertext

    ring = int(os.environ.get("BENCH_RING", "32768"))
    params = SchemeParams.create(ring_dim=ring, mult_depth=11,
                                 security="128c" if ring >= 32768 else "none")
    ctx = CkksContext(params, seed=0)
    z = np.random.default_rng(0).uniform(-1, 1, (2, ctx.slots))
    data = ctx.encrypt_batch(z)
    box = [None]

    def f(state, d1, d2):  # keys and tables as arguments, not constants
        with ctx.bound_state(state):
            a = Ciphertext(d1, ctx.fresh_scale)
            b = Ciphertext(d2, ctx.fresh_scale)
            out = ctx.rescale_score(ctx.relinearize(ctx.mul(a, b)))
            box[0] = out.scale
            return out.data

    state = ctx.device_state()
    jf = jax.jit(f)
    out = jax.block_until_ready(jf(state, data[0], data[1]))
    ok = bool(np.allclose(ctx.decrypt(Ciphertext(out, box[0])), z[0] * z[1],
                          atol=1e-4))
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jf(state, data[0], data[1])
    jax.block_until_ready(out)
    per = (time.perf_counter() - t0) / reps
    return {"metric": "ct_mult_relin_rescale_ops_per_s",
            "value": 1.0 / per, "unit": "ops/s/device", "vs_baseline": 0.0,
            "correct": ok}


def run_scenario() -> dict:
    import jax
    from image_matching.ckks.params import SchemeParams, compute_required_depth
    from image_matching.matching.config import MatchConfig
    from image_matching.matching.protocol import MatchingProtocol
    from image_matching.utils import io as dio

    log2n = int(os.environ.get("BENCH_LOG2N", "20"))
    ring = int(os.environ.get("BENCH_RING", "32768"))
    scenario = os.environ.get("BENCH_SCENARIO", "membership")
    approach = int(os.environ.get("BENCH_APPROACH", "5"))
    n = 1 << log2n
    streamed = bool(int(os.environ.get("BENCH_STREAM", str(int(log2n >= 16)))))

    cfg = MatchConfig()
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(
        ring_dim=ring, mult_depth=depth,
        security="128c" if ring >= 32768 else "none",
    )
    query, db = dio.gen_dataset(n, cfg.vector_dim, seed=0)

    t0 = time.perf_counter()
    proto = MatchingProtocol.setup(approach, db, cfg, params=params, seed=0,
                                   streamed=streamed,
                                   **({"verbose": True} if streamed else {}))
    setup_s = time.perf_counter() - t0
    print(f"# setup+enroll: {setup_s:.1f}s (streamed={streamed})",
          file=sys.stderr, flush=True)
    del db

    qcts = proto.encrypt_query(query)
    jax.block_until_ready([c.data for c in qcts])

    def run():
        if scenario == "index":
            out = proto.index(qcts)
            jax.block_until_ready([c.data for c in out])
        else:
            out = proto.membership(qcts)
            jax.block_until_ready(out.data)
        return out

    t0 = time.perf_counter()
    out = run()
    first = time.perf_counter() - t0
    ok = [_check(out, proto, scenario)]
    print(f"# compile+first run: {first:.1f}s", file=sys.stderr, flush=True)
    steady = []
    for _ in range(STEADY_REPS):
        t0 = time.perf_counter()
        out = run()
        steady.append(time.perf_counter() - t0)
        ok.append(_check(out, proto, scenario))
    pair = REF.get((approach, log2n))
    ref = (pair[1] if scenario == "index" else pair[0]) if pair else None
    best = min(steady)
    row = {
        "metric": (f"{APPROACH_NAMES[approach]}_{scenario}"
                   f"_2^{log2n}_server_compute"),
        "value": best, "unit": "seconds",
        "vs_baseline": (ref / best) if (ref and all(ok)) else 0.0,
        "correct": all(ok), "steady_s": steady, "compile_first_s": first,
        "setup_s": setup_s,
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"),
    }
    store = getattr(proto.sender, "store", None)
    if store is not None:
        row["groups"] = store.num_groups
        row["resident_groups"] = store.resident_count()
        row["pinned_groups"] = store.pinned_count()
    return row


def _check(out, proto, scenario) -> bool:
    """Decrypt and validate the scenario output (planted match at 0)."""
    if scenario == "index":
        idx = proto.decrypt_index(out)
        ok = 0 in idx
        print(f"# index result (expect planted 0): {sorted(idx)[:5]}",
              file=sys.stderr)
    else:
        ok = bool(proto.decrypt_membership(out))
        print(f"# membership result (expect True): {ok}", file=sys.stderr)
    if not ok:
        print("# CORRECTNESS FAILURE", file=sys.stderr)
    return ok


def main() -> int:
    import jax
    from image_matching.utils import device
    from image_matching.utils.jaxcfg import enable_compilation_cache

    devs = jax.devices()
    try:
        device.require_gpu(devs,
                           allow_cpu=os.environ.get("JAX_PLATFORMS") == "cpu")
    except RuntimeError as e:
        print(f"bench: {e}; set JAX_PLATFORMS=cpu for a CPU rehearsal",
              file=sys.stderr)
        return 2
    enable_compilation_cache()
    if os.environ.get("BENCH_METRIC") == "ctmult":
        row = bench_ctmult()
    else:
        row = run_scenario()
    if devs[0].platform != "gpu":
        row["vs_baseline"] = 0.0  # a CPU rehearsal's time is no device time
    row["device"] = {**device.describe(devs), "card": device.card_info()}
    print(json.dumps(row), flush=True)
    return 0 if row["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
