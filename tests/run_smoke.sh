#!/bin/bash
# Fast smoke tier: unit tests + one end-to-end approach-5 run, CPU only.
# Excludes the heavy e2e/sharding/streaming tests (marked `slow`); run
# those with tests/run_tests.sh (the full suite).
cd "$(dirname "$0")/.."
JAX_PLATFORMS=cpu exec python -m pytest tests/ -q -m "not slow" "$@"
