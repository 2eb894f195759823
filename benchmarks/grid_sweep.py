"""Grid build-parameter sweep on the device (config4 forward bands).

Times `--phase fwd` subprocesses (one device process at a time, health-probed
via bench.py's guarded machinery) across RT_GRID_CAPACITY / RT_GRID_DENSITY /
RT_GRID_PREGATHER combos. The per-DDA-step HBM gather reads all `capacity`
slots whether occupied or not, so the sweet spot is the smallest capacity
whose overflow list (brute-tested against every ray once per walk) stays
small; this harness measures where that is for the config4 mesh.

Usage:  python -m benchmarks.grid_sweep            # full sweep on the GPU
        RT_SWEEP_COMBOS='16,4,0;12,8,1' python -m benchmarks.grid_sweep
        RT_SWEEP_ENVS='RT_BENCH_TRACER=bvh,RT_BVH_LEAF=16;RT_GRID_SKIP=4' \
            python -m benchmarks.grid_sweep        # arbitrary env combos
        RT_SWEEP_ENVS='RT_GRID_FANOUT=1;RT_GRID_FANOUT=2;RT_GRID_FANOUT=4' \
            python -m benchmarks.grid_sweep        # fanout fault/perf probe
            # (fanout>1 enlarges the traced loop body — a known kernel-fault
            # axis on this stack; run this before recommending fanout>1)
Output: one line per combo + a sorted summary table on stderr; JSON lines on
stdout for machine reading.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (repo-root bench.py: _guarded/_wait_healthy)

DEFAULT_COMBOS = [
    (16, 4.0, 0),   # pre-sweep defaults (shipping default is now 12/8/1)
    (16, 4.0, 1),
    (12, 8.0, 0),
    (12, 8.0, 1),
    (16, 8.0, 0),
    (24, 2.0, 0),
    (8, 16.0, 1),
]


def parse_combos(spec: str):
    out = []
    for part in spec.split(";"):
        cap, dens, pg = part.split(",")
        out.append((int(cap), float(dens), int(pg)))
    return out


def parse_envs(spec: str):
    """';'-separated groups of 'K=V,K=V' → list of env dicts."""
    out = []
    for group in spec.split(";"):
        env = {}
        for kv in group.split(","):
            k, v = kv.split("=", 1)
            env[k.strip()] = v.strip()
        out.append(env)
    return out


def _workload():
    config = os.environ.get("RT_SWEEP_CONFIG", "config4")
    extra = ("--width", os.environ.get("RT_SWEEP_W", "1920"),
             "--height", os.environ.get("RT_SWEEP_H", "270"),
             "--depth", os.environ.get("RT_SWEEP_D", "4"),
             "--repeats", "2")
    return config, extra


def run_envs(env_list):
    """Time the workload under each env dict (RT_SWEEP_ENVS mode).

    RT_SWEEP_PHASE=bwd sweeps the backward phase (fwd_bwd_s) instead of fwd.
    """
    config, extra = _workload()
    phase = os.environ.get("RT_SWEEP_PHASE", "fwd")
    key = "fwd_bwd_s" if phase == "bwd" else "fwd_s"
    results = []
    for env in env_list:
        tag = ",".join(f"{k}={v}" for k, v in sorted(env.items()))
        print(f"# sweep {tag}…", file=sys.stderr, flush=True)
        res = bench._guarded(phase, config, extra, attempts=1, env=env)
        if res is None:
            print(f"# {tag}: FAILED", file=sys.stderr, flush=True)
            print(json.dumps({"combo": tag, "error": "failed"}), flush=True)
            continue
        res["combo"] = tag
        results.append(res)
        print(f"# {tag}: {phase} {res[key]*1e3:.2f} ms", file=sys.stderr,
              flush=True)
        print(json.dumps(res), flush=True)
    results.sort(key=lambda r: r[key])
    print("# ==== sweep summary (fastest first) ====", file=sys.stderr)
    for r in results:
        print(f"# {r['combo']:<48} {r[key]*1e3:8.2f} ms/band",
              file=sys.stderr)


def main():
    env_spec = os.environ.get("RT_SWEEP_ENVS")
    if env_spec:
        return run_envs(parse_envs(env_spec))
    spec = os.environ.get("RT_SWEEP_COMBOS")
    combos = parse_combos(spec) if spec else DEFAULT_COMBOS
    run_envs([{"RT_GRID_CAPACITY": str(cap), "RT_GRID_DENSITY": str(dens),
               "RT_GRID_PREGATHER": str(pg)} for cap, dens, pg in combos])


if __name__ == "__main__":
    main()
