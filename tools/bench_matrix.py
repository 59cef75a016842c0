#!/usr/bin/env python
"""Benchmark matrix: all five approaches at the BASELINE.md config sizes on
the GPU, producing a scalability table comparable to the reference's
tools/figures/approach{1..5}.csv.  Every row names the device it ran on;
the run exits non-zero if any point erred or timed out.

Timing discipline: one warmup run (includes jit compile), then the timed
run — matching bench.py and the reference's "server computation time"
(which also excludes setup/enroll, reference src/main.cpp:330-389).

  python tools/bench_matrix.py                      # default matrix
  python tools/bench_matrix.py --configs 5:16,5:17  # specific points
  python tools/bench_matrix.py --out results.jsonl
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# (approach, log2n) -> (membership_s, index_s) from BASELINE.md
# (reference tools/figures/approach{1..5}.csv, full columns)
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
    (4, 16): (9.84, 9.11), (4, 17): (16.99, 15.84), (4, 18): (30.97, 28.77),
    (4, 19): (58.15, 54.03), (4, 20): (115.54, 110.91),
    (5, 10): (5.89, 4.68), (5, 11): (4.46, 4.19), (5, 12): (4.54, 4.20),
    (5, 13): (4.49, 4.35),
    (5, 14): (4.52, 4.18), (5, 15): (6.16, 5.85), (5, 16): (9.56, 9.01),
    (5, 17): (16.01, 15.47), (5, 18): (28.73, 27.63), (5, 19): (53.25, 49.70),
    (5, 20): (102.41, 96.52),
}

DEFAULT = "1:10,2:12,3:14,4:14,5:13,5:16,5:17"


def run_one(approach: int, log2n: int, ring: int, streamed: bool) -> dict:
    import jax
    from image_matching.utils import device
    from image_matching.utils.jaxcfg import enable_compilation_cache
    devs = jax.devices()
    device.require_gpu(devs, allow_cpu=os.environ.get("JAX_PLATFORMS") == "cpu")
    enable_compilation_cache()
    from image_matching.ckks.params import (SchemeParams,
                                                compute_required_depth)
    from image_matching.matching.config import MatchConfig
    from image_matching.matching.protocol import MatchingProtocol
    from image_matching.utils import io as dio

    # A2 runs cost-faithful: membership computes-and-discards the alpha-norm
    # colCipher exactly like the reference's timed loop does
    # (src/sender/sender_grote.cpp:23), so the vs-reference comparison
    # includes the same work.
    cfg = MatchConfig(faithful_grote=(approach == 2))
    depth = compute_required_depth(approach, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(
        ring_dim=ring, mult_depth=depth,
        security="128c" if ring >= 32768 else "none")
    query, db = dio.gen_dataset(1 << log2n, cfg.vector_dim, seed=0)
    t0 = time.time()
    proto = MatchingProtocol.setup(approach, db, cfg, params=params, seed=0,
                                   streamed=streamed,
                                   **({"verbose": True} if streamed else {}))
    enroll_s = time.time() - t0
    del db
    t0 = time.time()
    qcts = proto.encrypt_query(query)
    jax.block_until_ready([c.data for c in qcts])
    query_enc_s = time.time() - t0

    row = {"approach": approach, "log2n": log2n, "ring": ring,
           "device": {**device.describe(devs), "card": device.card_info()},
           "streamed": streamed, "enroll_s": round(enroll_s, 2),
           "query_enc_s": round(query_enc_s, 4), "query_cts": len(qcts)}

    def timed(kind):
        def go():
            if kind == "membership":
                out = proto.sender.run_membership(qcts)
                jax.block_until_ready(out.data)
            else:
                out = proto.sender.run_index(qcts)
                jax.block_until_ready([c.data for c in out])
            return out
        t0 = time.time()
        out = go()
        compile_s = time.time() - t0
        t0 = time.time()
        out = go()
        return out, time.time() - t0, compile_s

    mem, mem_s, mem_c = timed("membership")
    row["membership_s"] = round(mem_s, 4)
    row["membership_compile_s"] = round(mem_c, 2)
    t0 = time.time()
    row["membership_ok"] = bool(proto.decrypt_membership(mem))
    row["membership_dec_s"] = round(time.time() - t0, 4)

    idx, idx_s, idx_c = timed("index")
    row["index_s"] = round(idx_s, 4)
    row["index_compile_s"] = round(idx_c, 2)
    row["index_cts"] = len(idx)
    t0 = time.time()
    decoded = proto.decrypt_index(idx)
    row["index_dec_s"] = round(time.time() - t0, 4)
    row["index_ok"] = 0 in decoded
    row["index_extra"] = len(decoded) - 1

    ref = REF.get((approach, log2n))
    if ref:
        row["ref_membership_s"], row["ref_index_s"] = ref
        row["membership_vs_ref"] = round(ref[0] / mem_s, 2)
        row["index_vs_ref"] = round(ref[1] / idx_s, 2)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default=DEFAULT,
                    help="comma list of approach:log2n")
    ap.add_argument("--ring", type=int, default=32768)
    ap.add_argument("--out", default="docs/results/bench_matrix.jsonl")
    ap.add_argument("--timeout", type=float, default=5400,
                    help="per-point wall clock (subprocess mode)")
    ap.add_argument("--in-process", action="store_true",
                    help="run points in this process (child mode)")
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    specs = [s.strip() for s in args.configs.split(",") if s.strip()]
    if not args.in_process and len(specs) > 1:
        # one subprocess per matrix point: HBM/host-RAM residue from a
        # previous point (jit executables, lingering stores) otherwise
        # accumulates and OOMs mid-matrix (round-4 A5@2^17 failure)
        import subprocess
        failed = 0
        for spec in specs:
            cmd = [sys.executable, os.path.abspath(__file__),
                   "--configs", spec, "--ring", str(args.ring),
                   "--out", args.out, "--in-process"]
            try:
                rc = subprocess.run(cmd, timeout=args.timeout,
                                    check=False).returncode
            except subprocess.TimeoutExpired:
                rc = 1
                a, n = (int(x) for x in spec.split(":"))
                row = {"approach": a, "log2n": n,
                       "error": f"timeout after {args.timeout:.0f}s"}
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            failed += rc != 0
        return 1 if failed else 0

    failed = 0
    for spec in specs:
        a, n = (int(x) for x in spec.split(":"))
        streamed = a in (4, 5) and n >= 16
        print(f"=== approach {a} @ 2^{n} (streamed={streamed}) ===",
              flush=True)
        try:
            row = run_one(a, n, args.ring, streamed)
            failed += not (row["membership_ok"] and row["index_ok"])
        except Exception as e:  # recorded as an error row; exit code says so
            row = {"approach": a, "log2n": n, "error": f"{type(e).__name__}: {e}"}
            failed += 1
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
