"""Benchmark entry: prints the headline metric as a JSON line.

Primary metric (BASELINE.json:2): rays/sec fwd+bwd at 1080p 4-bounce on the
local device (config4: ~20k-tri mesh + mirror sphere + checker plane,
grid-accelerated).

INCREMENTAL EMISSION: a caller that stops this process reads the LAST
complete JSON line of stdout, so we climb a ladder of rungs from
most-reliable to most-headline and, after every successful phase, re-emit
the best line seen so far (flushed). Exits non-zero when no rung succeeded.

Rung ladder (ascending headline-ness; kind beats config):
  fwd  config2 1080p d2  →  fwd config3 1024² d4  →  fwd config4 1080p d4
  fwd+bwd config2        →  fwd+bwd config3       →  fwd+bwd config4
Execution order is cheap-and-reliable first (config2 fused, mesh-free),
then config3 (fused fwd, no grid program),
then the grid-mesh config4 ladder with its preflight + band-budget retries.

Each phase runs in its own subprocess (one process on the device at a
time), preceded by a health probe.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

START = time.time()
# Wind-down deadline: stop starting expensive mesh rungs past this point so
# the reliable rungs' lines are never at risk from a dangling 50-min phase.
DEADLINE = START + float(os.environ.get("RT_BENCH_DEADLINE_S", "4200"))

# last_ok: the previous device subprocess exited with a result, so the
# device is known-healthy RIGHT NOW — the next phase may skip its probe
# subprocess entirely (each probe pays a fresh client init). A failed phase
# clears it and the ladder resumes. BEST lets _wait_healthy re-emit the
# best-so-far line before any long sleep.
_state = {"last_ok": False}
BEST = None


def _phase(phase: str, config: str | None = None, extra=(),
           timeout: int = 1800, env: dict | None = None) -> dict | None:
    cmd = [sys.executable, "-m", "benchmarks.rays_per_sec", "--phase", phase]
    if config:
        cmd += ["--config", config]
    cmd += list(extra)
    run_env = dict(os.environ, **env) if env else None
    try:
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=timeout, env=run_env)
    except subprocess.TimeoutExpired as e:
        tail = (e.stderr or b"")[-600:]
        sys.stderr.write(f"# phase {phase}: timeout; partial stderr:\n"
                         + tail.decode("utf-8", "replace") + "\n")
        _state["last_ok"] = False
        return None
    for line in proc.stdout.splitlines():
        if line.startswith("PHASE_RESULT "):
            _state["last_ok"] = True
            return json.loads(line[len("PHASE_RESULT "):])
    sys.stderr.write(f"# phase {phase} failed:\n")
    sys.stderr.write(proc.stderr[-1200:] + "\n")
    _state["last_ok"] = False
    return None


def _wait_healthy(max_wait: int = 2000) -> bool:
    # one patient probe at a time; retry (after a rest) only when the probe
    # exits on its own. max_wait allows two full probe cycles.
    t0 = time.time()
    while time.time() - t0 < max_wait:
        if _phase("probe", timeout=900) is not None:
            return True
        if BEST is not None and BEST.line is not None:
            print(BEST.line, flush=True)  # keep tail-parse current pre-sleep
        sys.stderr.write("# device unhealthy; resting 150s…\n")
        time.sleep(150)
    return False


def _guarded(phase: str, config: str | None = None, extra=(),
             attempts: int = 2, env: dict | None = None,
             timeout: int = 1800) -> dict | None:
    for _ in range(attempts):
        if not _state["last_ok"] and not _wait_healthy():
            return None
        res = _phase(phase, config, extra, env=env, timeout=timeout)
        if res is not None:
            return res
    return None


class Best:
    """Tracks the best rung seen; re-emits its JSON line after every update
    so the driver's tail-parse always gets the current best."""

    def __init__(self):
        self.rank = -1
        self.line = None

    def offer(self, rank: int, t: dict, n_rays: float):
        kind = "fwd_bwd" if "fwd_bwd_s" in t else "fwd"
        rate = n_rays / t.get("fwd_bwd_s", t["fwd_s"])
        line = json.dumps({
            "metric": f"rays_per_sec_per_chip_{kind}_"
                      f"{t['width']}x{t['height']}_d{t['max_depth']}_"
                      f"{t['config']}",
            "value": rate,
            "unit": "rays/s",
        })
        if rank > self.rank:
            self.rank, self.line = rank, line
        # always (re-)emit the best so the LAST stdout line is the best rung
        print(self.line, flush=True)
        sys.stderr.write(f"# [t+{time.time() - START:.0f}s] rung rank={rank} "
                         f"{t['config']} {kind}: {rate:.4g} rays/s"
                         f"{' (superseded)' if rank < self.rank else ''}\n")
        sys.stderr.flush()


def _run_rung(best: Best, config: str, extra, env, fwd_rank: int,
              bwd_rank: int, fwd_timeout: int = 1200,
              bwd_timeout: int = 1800) -> bool:
    """fwd (+count folded in) then bwd for one rung; emits after each."""
    t = _guarded("fwd", config, tuple(extra) + ("--with-count",),
                 attempts=1, env=env, timeout=fwd_timeout)
    if t is None:
        sys.stderr.write(f"# fwd {config} {env} failed\n")
        return False
    n_rays = t.get("rays_per_frame") or float(t["width"] * t["height"])
    best.offer(fwd_rank, t, n_rays)
    if time.time() > DEADLINE:
        sys.stderr.write("# deadline: skipping bwd for this rung\n")
        return True
    b = _guarded("bwd", config, extra, attempts=1, env=env,
                 timeout=bwd_timeout)
    if b is None and config == "config4":
        # bwd retry ladder: smaller band budgets mean smaller per-program
        # work and memory.
        cur = int((env or {}).get("RT_BWD_UNIT_BUDGET", 3_200_000))
        for budget in (1_600_000, 800_000):
            if budget >= cur or time.time() > DEADLINE:
                break
            sys.stderr.write(f"# bwd failed; retrying band budget {budget}\n")
            b = _guarded("bwd", config, extra, attempts=1,
                         env={**(env or {}),
                              "RT_BWD_UNIT_BUDGET": str(budget)},
                         timeout=bwd_timeout)
            if b:
                break
    if b:
        t.update(b)
        best.offer(bwd_rank, t, n_rays)
    return True


def main():
    global BEST
    best = BEST = Best()
    # RT_BENCH_SMOKE=1: tiny sizes for a CPU logic test of the full ladder
    smoke = os.environ.get("RT_BENCH_SMOKE") == "1"
    # ---- Rung 0: bound time-to-first-line to minutes. A small fused
    # config2 render attempted DIRECTLY: the phase doubles as the health
    # probe.
    c0 = (("--width", "96", "--height", "64", "--depth", "2") if smoke else
          ("--width", "512", "--height", "512", "--depth", "2"))
    t0 = _phase("fwd", "config2", c0 + ("--with-count",),
                env={"RT_BENCH_FUSED": "1"}, timeout=300)
    if t0 is not None:
        best.offer(0, t0, t0.get("rays_per_frame")
                   or float(t0["width"] * t0["height"]))
    # ---- Rung 1: config2 1080p d2, fused megakernel fwd + fused bwd.
    c2 = (("--width", "96", "--height", "64", "--depth", "2") if smoke else
          ("--width", "1920", "--height", "1080", "--depth", "2"))
    ok2 = _run_rung(best, "config2", c2, {"RT_BENCH_FUSED": "1"},
                    fwd_rank=1, bwd_rank=4, fwd_timeout=1200)
    if not ok2:
        # fused failed (unexpected) — plain wavefront twin
        _run_rung(best, "config2", c2, {}, fwd_rank=1, bwd_rank=4,
                  fwd_timeout=1200)

    # ---- Rung 2: config3 glass Cornell 1024² d4 — fused fwd (10 baked
    # tris, no grid program), compacted-wavefront bwd. 4-bounce refractive.
    if time.time() < DEADLINE:
        c3 = ("--width", "64", "--height", "64") if smoke else ()
        _run_rung(best, "config3", c3,
                  {"RT_BENCH_FUSED": "1", "RT_BENCH_TRACER": "none"},
                  fwd_rank=2, bwd_rank=5, fwd_timeout=1200)

    # ---- Rung 3: config4 20k-tri mesh 1080p d4, grid tracer, band-split.
    # Preflight the mesh path first with one band-sized render.
    primary = os.environ.get("RT_BENCH_CONFIG", "config4")
    if primary != "config2" and time.time() < DEADLINE:
        # Only a render that FAILED on a healthy device indicts the mesh
        # path; if the probe never came up, keep the rung.
        pre1 = (("--width", "64", "--height", "36", "--depth", "2") if smoke
                else ("--width", "480", "--height", "270", "--depth", "2"))
        env4 = {}
        healthy = _wait_healthy()
        if healthy and _phase("fwd", primary, pre1, timeout=900) is None:
            sys.stderr.write("# mesh-path preflight failed; "
                             "mesh rungs skipped\n")
            env4 = None
        elif healthy and not smoke:
            if _wait_healthy() and _phase(
                    "fwd", primary,
                    ("--width", "1920", "--height", "270", "--depth", "4"),
                    timeout=900) is None:
                sys.stderr.write("# band-scale preflight (2.6M units) "
                                 "failed; trying small bands\n")
                if _wait_healthy() and _phase(
                        "fwd", primary,
                        ("--width", "1920", "--height", "83", "--depth", "4"),
                        timeout=900) is not None:
                    env4 = {"RT_BWD_UNIT_BUDGET": "800000"}
                else:
                    env4 = None
        if env4 is not None and time.time() < DEADLINE:
            c4 = (("--width", "96", "--height", "54", "--depth", "4")
                  if smoke else ())
            _run_rung(best, primary, c4, env4, fwd_rank=3, bwd_rank=6,
                      fwd_timeout=2400, bwd_timeout=2400)

    if best.line is None:
        sys.stderr.write("# every rung failed; no result\n")
        return 1
    else:
        # final re-emission so the tail line is unambiguous
        print(best.line, flush=True)
        sys.stderr.write(f"# done in {time.time() - START:.0f}s; "
                         f"best rank={best.rank}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
