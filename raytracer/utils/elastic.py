"""Elastic band-level recovery: subprocess band renders with backoff,
split-retry, and fault injection.

SURVEY.md §5 "Failure detection / elastic recovery / fault injection":
render steps are stateless and idempotent, so recovery = re-dispatch the
failed tile from scratch. A crash that kills the process (out of device
memory, a device fault) cannot be retried in-process, so the driver:

1. renders each horizontal band in its own python process, one at a time —
   each worker holds the card alone (a JAX process reserves most of its
   memory), and the driver itself never initialises a JAX backend;
2. on a band failure optionally waits `retry_wait` s (default 0);
3. splits the band in half and retries each piece — a smaller XLA program
   with a smaller footprint — recursing down to `min_rows`;
4. after a final whole-piece retry, zero-fills and reports bands that still
   fail: a partial frame with a failure report beats no frame.

Fault injection (tests + drills), read by every worker before jax loads:
- RT_FAULT_COUNTDOWN_FILE=<path>: atomically decrement the integer in <path>
  and hard-exit while it was > 0 — "the first K band workers crash",
  exercising backoff + split + re-dispatch deterministically on CPU.
- RT_FAULT_ROWS=a-b: hard-exit whenever the worker's band intersects image
  rows [a, b) — a permanently poisoned region, exercising the terminal
  zero-fill path.

Driver: `python -m raytracer.cli render --resilient …` (cli.py) or
`render_resilient(...)` below. The driver itself never touches a device —
it only orchestrates subprocesses and assembles numpy bands.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------- driver ----


@dataclasses.dataclass
class BandReport:
    """Outcome log of one resilient render (SURVEY §5 'Metrics')."""

    bands_ok: int = 0
    bands_failed: int = 0          # zero-filled terminal failures
    retries: int = 0               # worker launches beyond the first per piece
    failed_rows: list = dataclasses.field(default_factory=list)  # (row0, rows)
    rays: float = 0.0


def _worker_cmd(config: str, scene_path: str, row0: int, rows: int,
                width: int, height: int, max_depth: int | None, tracer: str,
                ssaa: int, out_npz: str):
    cmd = [sys.executable, "-m", "raytracer.utils.elastic",
           "--row0", str(row0), "--rows", str(rows),
           "--width", str(width), "--height", str(height),
           "--tracer", tracer, "--ssaa", str(ssaa), "--npz", out_npz]
    if scene_path:
        cmd += ["--scene", scene_path]
    else:
        cmd += ["--config", config]
    if max_depth is not None:
        cmd += ["--max-depth", str(max_depth)]
    return cmd


def _run_band(config, scene_path, row0, rows, width, height, max_depth,
              tracer, ssaa, timeout):
    """One worker launch → (img [rows,W,3] | None, rays)."""
    fd, path = tempfile.mkstemp(suffix=".npz", prefix="rt_band_")
    os.close(fd)
    try:
        cmd = _worker_cmd(config, scene_path, row0, rows, width, height,
                          max_depth, tracer, ssaa, path)
        try:
            r = subprocess.run(cmd, cwd=_REPO, timeout=timeout,
                               capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            sys.stderr.write(f"# band {row0}+{rows}: timeout {timeout}s\n")
            return None, 0.0
        if r.returncode != 0:
            tail = (r.stderr or "").strip().splitlines()[-3:]
            sys.stderr.write(f"# band {row0}+{rows}: worker exit "
                             f"{r.returncode}" +
                             ("".join("\n#   " + ln for ln in tail)) + "\n")
            return None, 0.0
        with np.load(path) as z:
            return np.asarray(z["img"], np.float32), float(z["rays"])
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def render_resilient(config: str = "", scene_path: str = "",
                     width: int = 0, height: int = 0,
                     max_depth: int | None = None, tracer: str = "auto",
                     ssaa: int = 1, band_rows: int | None = None,
                     min_rows: int = 8, retry_wait: float = 0.0,
                     band_timeout: float = 1800.0):
    """Full-frame render via re-dispatchable band subprocesses.

    Returns (img [H,W,3] f32, BandReport). Success bands are bitwise equal to
    the same renderer run in-process (render_banded slices); failed bands are
    zero-filled and listed in the report.
    """
    import time

    from raytracer.utils.hostload import load_scene_cli

    if min_rows < 1:
        raise ValueError(f"min_rows must be >= 1, got {min_rows}")
    scene, _, opts = load_scene_cli(config, scene_path, width, height,
                                    max_depth)
    height, width = opts.height, opts.width
    if band_rows is None:
        from raytracer.renderer import _auto_band_rows

        if ssaa > 1 and scene.meshes.count:
            # base-image rows per band such that the ssaa× band program
            # stays under the device budget (mirrors renderer.render_ssaa)
            budget = 2_400_000 // (opts.max_depth + 1)
            band_rows = max(1, budget // (width * ssaa * ssaa))
        else:
            band_rows = _auto_band_rows(scene, opts)

    img = np.zeros((height, width, 3), np.float32)
    rep = BandReport()

    def backoff():
        rep.retries += 1
        if retry_wait:
            time.sleep(retry_wait)

    def attempt(row0, rows):
        return _run_band(config, scene_path, row0, rows, width, height,
                         max_depth, tracer, ssaa, band_timeout)

    def do_piece(row0, rows):
        band, rays = attempt(row0, rows)
        if band is None:
            backoff()  # once per fault
            if rows >= 2 * min_rows:
                half = -(-rows // 2)
                sys.stderr.write(f"# band {row0}+{rows}: splitting -> "
                                 f"{half}/{rows - half}\n")
                do_piece(row0, half)
                do_piece(row0 + half, rows - half)
                return
            band, rays = attempt(row0, rows)  # terminal size: one last try
        if band is None:
            rep.bands_failed += 1
            rep.failed_rows.append((row0, rows))
            sys.stderr.write(f"# band {row0}+{rows}: FAILED - zero-filled\n")
            return
        img[row0:row0 + rows] = band
        rep.bands_ok += 1
        rep.rays += rays

    for r0 in range(0, height, band_rows):
        do_piece(r0, min(band_rows, height - r0))
    return img, rep



# ---------------------------------------------------------------- worker ----


def _maybe_inject_fault(row0: int, rows: int):
    """Test/drill hooks — must run before jax initializes anything."""
    path = os.environ.get("RT_FAULT_COUNTDOWN_FILE")
    if path and os.path.exists(path):
        with open(path) as f:
            k = int(f.read().strip() or 0)
        if k > 0:
            with open(path, "w") as f:
                f.write(str(k - 1))
            sys.stderr.write(f"# injected fault (countdown {k}->{k - 1})\n")
            os._exit(41)
    span = os.environ.get("RT_FAULT_ROWS")
    if span:
        a, b = (int(x) for x in span.split("-"))
        if row0 < b and row0 + rows > a:
            sys.stderr.write(f"# injected fault (rows {a}-{b})\n")
            os._exit(42)


def _worker_main(args):
    _maybe_inject_fault(args.row0, args.rows)

    from raytracer.utils.cache import setup_compile_cache

    setup_compile_cache()  # re-dispatched bands reuse each other's compiles

    from raytracer.utils.hostload import build_tracer, load_scene_cli

    scene, cam, opts = load_scene_cli(args.config, args.scene, args.width,
                                      args.height, args.max_depth)
    tracer = build_tracer(scene, args.tracer)

    from raytracer.renderer import render

    if args.ssaa > 1:
        # ssaa× band: trace the hi-res slice of the same projection and
        # box-average, exactly as renderer.render_ssaa does per band
        f = args.ssaa
        hi = dataclasses.replace(opts, width=opts.width * f,
                                 height=opts.height * f)
        img, traced = render(scene, cam, hi, count_rays=True, tracer=tracer,
                             row0=args.row0 * f, rows=args.rows * f)
        img = img.reshape(args.rows, f, opts.width, f, 3).mean(axis=(1, 3))
    else:
        img, traced = render(scene, cam, opts, count_rays=True, tracer=tracer,
                             row0=args.row0, rows=args.rows)
    img = np.asarray(img)  # the band's single D2H readback
    np.savez(args.npz, img=img, rays=float(traced))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="raytracer.utils.elastic",
        description="band worker for resilient rendering (internal)")
    p.add_argument("--config", default="")
    p.add_argument("--scene", default="")
    p.add_argument("--row0", type=int, required=True)
    p.add_argument("--rows", type=int, required=True)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--tracer", default="auto")
    p.add_argument("--ssaa", type=int, default=1)
    p.add_argument("--npz", required=True)
    _worker_main(p.parse_args(argv))


if __name__ == "__main__":
    main()
