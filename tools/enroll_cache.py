#!/usr/bin/env python
"""Offline enrollment: encrypt a (large) DB into the on-disk DiagStore
cache so benchmark/serving runs stream a pre-enrolled DB — the mirror of
the reference's offline enroller + serialized ciphertext dirs (reference
src/enroller/enroller_diag.cpp, READ_FROM_SERIAL in src/main.cpp).  Runs
entirely host-side (C++ engine): no accelerator needed.

  JAX_PLATFORMS=cpu python tools/enroll_cache.py --log2n 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=20)
    ap.add_argument("--ring", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0, help="context/dataset seed")
    args = ap.parse_args()

    from image_matching.ckks.params import (SchemeParams,
                                                compute_required_depth)
    from image_matching.ckks.context import CkksContext
    from image_matching.matching.config import MatchConfig
    from image_matching.matching import streaming
    from image_matching.utils import io as dio

    cfg = MatchConfig()
    depth = compute_required_depth(5, cfg.comp_depth, cfg.alpha_depth)
    params = SchemeParams.create(
        ring_dim=args.ring, mult_depth=depth,
        security="128c" if args.ring >= 32768 else "none")
    ctx = CkksContext(params, seed=args.seed)
    _, db = dio.gen_dataset(1 << args.log2n, cfg.vector_dim, seed=args.seed)
    t0 = time.time()
    store = streaming.enroll_diag_streamed(ctx, cfg, db, engine="native",
                                           resident_budget=0, verbose=True)
    print(f"# enrolled {store.num_groups} groups in {time.time()-t0:.0f}s "
          f"-> {streaming._cache_dir()}", file=sys.stderr)


if __name__ == "__main__":
    main()
