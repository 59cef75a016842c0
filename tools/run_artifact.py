#!/usr/bin/env python
"""Artifact runner: all five approaches on a 2^10 planted-match dataset,
basic correctness checks, latency.csv accumulation — the reference's
run_artifact.sh equivalent.

Usage: python tools/run_artifact.py [--log2n 10] [--ring-dim 32768]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from image_matching.harness.latency import run  # noqa: E402
from image_matching.utils import io as dio  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=10)
    ap.add_argument("--ring-dim", type=int, default=32768)
    ap.add_argument("--vector-dim", type=int, default=512)
    ap.add_argument("--csv", default="latency.csv")
    args = ap.parse_args()

    n = 1 << args.log2n
    query, db = dio.gen_dataset(n, args.vector_dim, seed=0)
    with tempfile.NamedTemporaryFile("w", suffix=".dat", delete=False) as f:
        path = f.name
    dio.write_dataset(path, query, db)

    failures = []
    for approach in (1, 2, 3, 4, 5):
        print(f"\n===== approach {approach} =====")
        row = run(path, approach, args.csv, args.ring_dim, args.vector_dim)
        ok = row["membership_result"] is True and 0 in row["index_result"]
        print(f"correctness: {'PASS' if ok else 'FAIL'}")
        if not ok:
            failures.append(approach)
    os.unlink(path)
    if failures:
        print(f"FAILED approaches: {failures}")
        sys.exit(1)
    print("\nall approaches passed basic correctness checks")


if __name__ == "__main__":
    main()
