"""Measure per-config forward throughput on the local chip → BASELINE numbers.

Runs each benchmark preset at its full resolution (forward only, chained-slope
timing, no readbacks until the end). One device process; run alone.

  python tools/measure_baseline.py
"""

import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from benchmarks.rays_per_sec import _chained_time  # noqa: E402


def main():
    from raytracer.accel.grid import GridTracer
    from raytracer.models import presets
    from raytracer.renderer import render

    rows = []
    for name in ["config1", "config2", "config3", "config4"]:
        scene, cam, opts = presets.PRESETS[name]()
        tracer = GridTracer.build(scene) if scene.meshes.count > 100 else None
        scene_d, cam_d, tr_d = jax.device_put((scene, cam, tracer))

        @jax.jit
        def fwd(eps, scene_d=scene_d, cam_d=cam_d, tr_d=tr_d, opts=opts):
            c = dataclasses.replace(cam_d, pos=cam_d.pos + eps)
            return render(scene_d, c, opts, tracer=tr_d)[0]

        t0 = time.time()
        _, per = _chained_time(fwd, repeats=2, k=6)
        rows.append({"config": name, "width": opts.width,
                     "height": opts.height, "depth": opts.max_depth,
                     "fwd_ms": per * 1e3,
                     "Mpix_per_s": opts.width * opts.height / per / 1e6,
                     "compile_s": time.time() - t0})
        print(f"# {name} done", file=sys.stderr)

    # readbacks after all timing: exact ray counts per config
    for r in rows:
        scene, cam, opts = presets.PRESETS[r["config"]]()
        tracer = GridTracer.build(scene) if scene.meshes.count > 100 else None
        n = jax.jit(lambda s, c, t, opts=opts: render(
            s, c, opts, count_rays=True, tracer=t)[1])(scene, cam, tracer)
        r["rays_per_frame"] = float(n)
        r["Grays_per_s"] = r["rays_per_frame"] / (r["fwd_ms"] / 1e3) / 1e9
        print(json.dumps(r))


if __name__ == "__main__":
    main()
