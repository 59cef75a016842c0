#!/bin/bash
# Run the whole test suite (slow tests included) on the CPU backend.
#
# Each test file runs in its OWN pytest process: a single process running
# streaming+sharding+tensor back-to-back accumulates jit executables and
# device arrays until the interpreter aborts on a small-RAM host.  The
# persistent XLA compilation cache keeps the per-file restart cost low.
# Any extra args are forwarded to every file's pytest invocation
# (e.g. -m "not slow").
set -u
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu
rc=0
failed=()
for f in tests/test_*.py; do
    echo "=== $f ==="
    python -m pytest "$f" -q "$@"
    r=$?
    # pytest exit 5 = no tests collected (e.g. everything deselected by a
    # marker filter) — not a failure for a per-file loop
    if [ "$r" != 0 ] && [ "$r" != 5 ]; then
        rc=1
        failed+=("$f")
    fi
done
if [ "$rc" != 0 ]; then
    echo "FAILED files: ${failed[*]}"
else
    echo "all test files green"
fi
exit $rc
