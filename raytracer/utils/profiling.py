"""Profiling/metrics hooks (SURVEY.md §5 "Tracing / profiling").

The reference's instrumentation is a wall-clock print around render(); ours is
`jax.profiler` traces (XProf/Perfetto) around the step plus rays/s counters
carried in the wavefront state (renderer.render count_rays=True).
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def xprof_trace(logdir: str):
    """Capture a device trace viewable in XProf/Perfetto/TensorBoard."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock timer that blocks on device completion."""

    def __init__(self):
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0


def timed(fn, *args, repeats: int = 3, inner: int | None = None):
    """Best-of-N amortized wall time of fn(*args), post-warmup.

    Issues `inner` back-to-back dispatches and blocks once: robust against
    async-dispatch timing jitter (a single block_until_ready round-trip can
    under- or over-state sub-ms kernels). No device→host readbacks. `inner`
    auto-scales so one repeat costs ~0.5 s (long kernels get inner=1).
    """
    jax.block_until_ready(fn(*args))  # compile
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))  # calibration run
    t_cal = time.perf_counter() - t0
    if inner is None:
        inner = max(1, min(8, int(0.5 / max(t_cal, 1e-4))))
    best = t_cal
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return out, best


def top_ops(trace_dir: str, k: int = 20, device_only: bool = True):
    """Rank ops in a captured trace by total duration (descending).

    Parses the .xplane.pb via jax.profiler.ProfileData — no TensorBoard
    needed. Returns [(name, total_seconds, count)]; device_only keeps the
    device planes (drop the python/runtime lines).
    """
    import collections
    import glob
    import os

    files = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    total = collections.Counter()
    counts = collections.Counter()
    for f in files:
        data = jax.profiler.ProfileData.from_file(f)
        for plane in data.planes:
            pname = plane.name.lower()
            if device_only and not ("device" in pname or "/gpu" in pname):
                continue
            for line in plane.lines:
                for ev in line.events:
                    dur = (ev.end_ns - ev.start_ns) / 1e9
                    total[ev.name] += dur
                    counts[ev.name] += 1
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [(name, secs, counts[name]) for name, secs in ranked]


def print_top_ops(trace_dir: str, k: int = 20, device_only: bool = True):
    rows = top_ops(trace_dir, k=k, device_only=device_only)
    tot = sum(r[1] for r in rows)
    for name, secs, n in rows:
        print(f"{secs * 1e3:10.3f} ms  x{n:<6} {name[:110]}")
    print(f"# top-{k} total: {tot * 1e3:.2f} ms")
    return rows
