#!/bin/bash
# Full test tier (slow marks included) in SHARDED processes.
#
# One long-lived XLA:CPU process segfaults in backend_compile_and_load
# after ~150-200 program compiles (observed repeatedly, 2026-08-20/21 —
# cache on or off; the same compile always succeeds in a fresh process).
# The quick tier fits the budget; the full tier does not. Workaround:
# run the suite as a few per-file-group processes and sum the results.
#
#   JAX_PLATFORMS=cpu bash scripts/full_tier.sh [> full.log 2>&1]
set -u
cd "$(dirname "$0")/.."
total_pass=0
total_fail=0
rc_all=0
# group files so no shard compiles more than ~Ω(100) programs; the heavy
# compile consumers (replay/fused/grads/dist) get their own shards
GROUPS_LIST=(
  "tests/test_ops.py tests/test_io.py tests/test_scenefile.py tests/test_native.py tests/test_bench_utils.py"
  "tests/test_forward_golden.py tests/test_forward_oracle.py tests/test_bands.py"
  "tests/test_grid.py tests/test_bvh.py tests/test_compact.py"
  "tests/test_fused_triton.py tests/test_chip_smoke.py tests/test_hostside.py"
  "tests/test_grads.py"
  "tests/test_fused.py"
  "tests/test_replay.py tests/test_plan_remat.py"
  "tests/test_dist.py tests/test_overlap.py tests/test_multiprocess.py tests/test_dgather.py"
  "tests/test_checkpoint.py tests/test_elastic.py"
  "tests/test_cull.py"
  "tests/test_fused_vjp.py"
)
for g in "${GROUPS_LIST[@]}"; do
  echo "=== shard: $g ==="
  python -m pytest $g -q -m "" --tb=short
  rc=$?
  [ $rc -ne 0 ] && rc_all=$rc
done
echo "=== full tier done (rc=$rc_all) ==="
exit $rc_all
