#!/usr/bin/env python
"""Build the reference-schema latency.csv from docs/results/bench_matrix.jsonl
and regenerate the five manuscript-parity figures
(reference generate_figures.sh:7-13) from it.

The matrix rows carry steady-state timings (one warmup excluded, matching
the reference's "server computation time"), query/result ciphertext counts
and decrypt times — everything the latency.csv schema
(reference tools/setup_experiment.sh:1-16) needs.  Rows missing the count
fields (pre-round-4 format) or marked error are skipped; the latest row
per (approach, log2n) wins.

  python tools/figures_from_matrix.py \
      [--matrix docs/results/bench_matrix.jsonl] [--outdir docs/results/figures]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

NAMES = {1: "Baseline", 2: "GROTE", 3: "Blind", 4: "HERS", 5: "Diagonal"}

REQUIRED = ("query_enc_s", "query_cts", "membership_s", "membership_dec_s",
            "index_s", "index_cts", "index_dec_s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="docs/results/bench_matrix.jsonl")
    ap.add_argument("--outdir", default="docs/results/figures")
    ap.add_argument("--csv", default="docs/results/latency.csv")
    args = ap.parse_args()

    latest = {}
    with open(args.matrix) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if "error" in row or any(k not in row for k in REQUIRED):
                continue
            latest[(row["approach"], row["log2n"])] = row

    if not latest:
        sys.exit("no usable rows in the matrix (need round-4 format)")

    from image_matching.harness.latency import CSV_HEADER
    from image_matching.harness import figures

    os.makedirs(os.path.dirname(args.csv) or ".", exist_ok=True)
    with open(args.csv, "w") as f:
        f.write(CSV_HEADER)
        for (a, n), r in sorted(latest.items()):
            f.write(
                f"{NAMES[a]},{1 << n},{r['query_enc_s']:.6f},"
                f"{r['query_cts']},{r['membership_s']:.6f},1,"
                f"{r['membership_dec_s']:.6f},{r['index_s']:.6f},"
                f"{r['index_cts']},{r['index_dec_s']:.6f},"
                f"{int(bool(r['membership_ok']))},\"0\"\n"
            )
    print(f"-> {args.csv} ({len(latest)} rows)")

    # self-explanatory view of the append-only matrix: latest row per
    # (approach, log2n), superseded/error rows dropped — so a reader of
    # docs/results/ does not have to reconstruct which rows are current
    clean = args.matrix.replace(".jsonl", "_clean.jsonl")
    with open(clean, "w") as f:
        for (a, n), r in sorted(latest.items()):
            f.write(json.dumps(r) + "\n")
    print(f"-> {clean}")

    kinds = sorted({r["device"]["kind"] for r in latest.values()
                    if "device" in r})
    figures.generate(args.csv, args.outdir,
                     ", ".join(kinds) or "device not recorded")
    figures.sign_approx_table(os.path.join(args.outdir, "sign_approx.csv"))
    figures.sign_approx_plot(os.path.join(args.outdir, "sign_approx.png"))


if __name__ == "__main__":
    main()
