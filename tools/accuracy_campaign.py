#!/usr/bin/env python
"""FRGC-scale accuracy campaign with near-threshold borderline planting:
every query gets `--borderline` planted cross-identity entries
with cosine in [0.38, 0.50], so the hybrid sign approximation is
exercised straddling MATCH_THRESHOLD=0.44 (the encrypted analog of the
reference's signApprox.csv validation).

Appends reference-format rows to accuracy.csv and writes
accuracy_summary.json with the aggregate table, the near-threshold
disagreement census, and the score-parity maximum.

  python tools/accuracy_campaign.py --queries 50 --borderline 2
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=50)
    ap.add_argument("--approach", type=int, default=5)
    ap.add_argument("--n-ids", type=int, default=11057)
    ap.add_argument("--per-id", type=int, default=4)
    ap.add_argument("--borderline", type=int, default=2)
    ap.add_argument("--ring", type=int, default=32768)
    ap.add_argument("--csv", default="docs/results/accuracy.csv")
    ap.add_argument("--out", default="docs/results/accuracy_summary.json")
    ap.add_argument("--ts", default="", help="UTC timestamp for the artifact")
    args = ap.parse_args()

    import jax
    from image_matching.utils import device
    from image_matching.utils.jaxcfg import enable_compilation_cache
    enable_compilation_cache()
    from image_matching.harness.accuracy import run

    rows = run(0, args.approach, csv_path=args.csv, ring_dim=args.ring,
               n_ids=args.n_ids, per_id=args.per_id,
               n_queries=args.queries, parity=True, streamed=True,
               borderline=args.borderline)

    tot = {k: sum(r[f"enc_{k}"] for r in rows) for k in ("tp", "fn", "tn", "fp")}
    ptot = {k: sum(r[f"plain_{k}"] for r in rows) for k in ("tp", "fn", "tn", "fp")}
    agree = sum(1 for r in rows
                if all(r[f"enc_{k}"] == r[f"plain_{k}"]
                       for k in ("tp", "fn", "tn", "fp")))
    summary = {
        "db_vectors": args.n_ids * args.per_id + args.queries * args.borderline,
        "n_identities": args.n_ids,
        "queries": args.queries,
        "borderline_planted_per_query": args.borderline,
        "borderline_band_cosine": [0.38, 0.50],
        "ring_dim": args.ring,
        "scale_bits": 30,
        "security": "HEStd_128_classic",
        "comp_depth": 10,
        "approach": args.approach,
        "store": "streamed seed-compressed (c0-only)",
        "enc_equals_plain_queries": agree,
        "totals_encrypted": {"TP": tot["tp"], "FN": tot["fn"],
                             "TN": tot["tn"], "FP": tot["fp"]},
        "totals_plaintext": {"TP": ptot["tp"], "FN": ptot["fn"],
                             "TN": ptot["tn"], "FP": ptot["fp"]},
        "near_threshold": {
            "band": "plain cosine within +-0.06 of 0.44",
            "entries_total": sum(r["near_count"] for r in rows),
            "enc_plain_decision_disagreements":
                sum(r["near_disagree"] for r in rows),
            "min_margin_seen": min((r["near_margin_min"] for r in rows
                                    if r["near_margin_min"] is not None),
                                   default=None),
        },
        "decision_disagreements_total": sum(r["disagree"] for r in rows),
        "max_score_parity_err": max(r["max_score_err"] for r in rows),
        "parity_tolerance": 1e-4,
        "note": ("synthetic identity-labeled embeddings at FRGC 2.0 scale "
                 "stand in for the non-redistributable FRGC files "
                 "(reference src/main_accuracy.cpp:75-97), EXTENDED with "
                 "planted cross-identity borderline pairs straddling the "
                 "0.44 threshold so the sign approximation is exercised "
                 "where the reference validates it "
                 "(tools/figures/signApprox.csv).  Encrypted index "
                 "pipeline vs plaintext cosine oracle at production "
                 "parameters."),
        "device": {**device.describe(jax.devices()),
                   "card": device.card_info()},
    }
    if args.ts:
        summary["ts"] = args.ts
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    print(f"-> {args.out}")


if __name__ == "__main__":
    main()
