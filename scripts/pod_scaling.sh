#!/usr/bin/env bash
# Multi-device scaling harness: on a host with several GPUs this ONE
# command produces the scaling-efficiency record (BASELINE.json:5) plus the
# grad-overlap A/B over the real interconnect.
#
# Single host, N local GPUs:
#   ./scripts/pod_scaling.sh
#
# Multi-host (run on EVERY host):
#   RT_COORD=<host0>:8476 RT_NPROC=<n_hosts> RT_PID=<this_host_rank> \
#       ./scripts/pod_scaling.sh
#
# CPU dry-run (validates the harness end-to-end on the 8-device simulator —
# speedup>1 is the meaningful signal there, not efficiency; see
# benchmarks/scaling.py):
#   RT_POD_DRYRUN=1 ./scripts/pod_scaling.sh
#
# Output: JSON lines (one per device count + one per overlap mode) on
# stdout.
set -euo pipefail
cd "$(dirname "$0")/.."

if [ "${RT_POD_DRYRUN:-}" = "1" ]; then
  export JAX_PLATFORMS=cpu
  EXTRA=(--sim8)
else
  EXTRA=()
fi

exec python - "${EXTRA[@]}" << 'EOF'
import json
import os
import sys

import jax

if "--sim8" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

from raytracer.parallel.mesh import init_distributed

coord = os.environ.get("RT_COORD")
nproc = int(os.environ.get("RT_NPROC", "1"))
pid = int(os.environ.get("RT_PID", "0"))
init_distributed(coord, nproc, pid)

from benchmarks.scaling import run_grad_overlap, run_scaling

n = len(jax.devices())
counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= n]

# DP pixel-tile scaling (prims=1): the headline efficiency number.
# (Dry-run uses small frames — the CPU sim is ~4 orders slower than a chip.)
sim = "--sim8" in sys.argv
W = 192 if sim else 1024
WR = 96 if sim else 512
res = run_scaling(config="config2", width=W, height=W, max_depth=2,
                  device_counts=counts)
# primitive sharding + ring variant at the largest count (comm-heavy paths)
if n >= 2:
    res += run_scaling(config="config3", width=WR, height=WR, max_depth=2,
                       device_counts=[n], prims=2)
    res += run_scaling(config="config3", width=WR, height=WR, max_depth=2,
                       device_counts=[n], prims=2, ring=True)
for r in res:
    print(json.dumps(r), flush=True)

# per-bounce overlapped grad psum vs fused psum on the real interconnect
prims = 2 if n >= 2 else 1
print(json.dumps(run_grad_overlap(config="config2",
                                  width=96 if sim else 256,
                                  height=96 if sim else 256,
                                  tiles=n // prims, prims=prims)),
      flush=True)

eff = [r for r in res if r["devices"] == max(counts)]
if eff and jax.devices()[0].platform != "cpu":
    ok = eff[0]["efficiency"] >= 0.85
    print(json.dumps({"target": ">=85% efficiency at max devices",
                      "measured": eff[0]["efficiency"], "pass": ok}),
          flush=True)
EOF
