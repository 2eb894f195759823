"""Wavefront occupancy diagnostic: alive-lane fraction per bounce.

Decision data for lane compaction (SURVEY §7.3.2 "ray-buffer divergence …
compaction only if occupancy <50% measured"): glass scenes statically double
the ray buffer per bounce (renderer.bounce_step), so late bounces may run
mostly dead lanes. This tool replays the exact wavefront loop and prints, per
bounce: buffer size (×n0), alive lanes, occupancy, and the per-material
split. Mesh walk backends already PARK dead lanes (active= masking,
accel/grid.py) — compaction would additionally shrink the dense work.

Usage:  JAX_PLATFORMS=cpu python -m benchmarks.occupancy
        [config3] [--width 256] [--depth 4]
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np


def occupancy(config: str = "config3", width: int = 256,
              depth: int | None = None):
    from raytracer.core.types import (DIFFUSE_AND_GLOSSY, REFLECTION,
                                          REFLECTION_AND_REFRACTION, as_jax)
    from raytracer.models import presets
    from raytracer.ops import geometry as geom
    from raytracer.ops.trace import nearest_hit, surface_at
    from raytracer.renderer import bounce_step

    scene, cam, opts = presets.PRESETS[config]()
    opts = dataclasses.replace(opts, width=width, height=width)
    if depth is not None:
        opts = dataclasses.replace(opts, max_depth=depth)
    scene = as_jax(scene)
    n0 = opts.width * opts.height
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), (n0, 3))
    state = (orig, dirs, jnp.ones((n0, 3), jnp.float32),
             jnp.ones((n0,), bool))

    rows = []
    for d in range(opts.max_depth + 1):
        o, dd, thr, alive = state
        hit = nearest_hit(scene, o, dd, opts.t_min, opts.tri_chunk)
        surf = surface_at(scene, o, dd, hit, opts.t_min)
        valid = surf.valid & alive
        mt = surf.mtype
        row = {
            "bounce": d,
            "buffer_x_n0": o.shape[0] / n0,
            "alive": int(jnp.sum(alive)),
            "occupancy": float(jnp.mean(alive.astype(jnp.float32))),
            "diffuse": int(jnp.sum(valid & (mt == DIFFUSE_AND_GLOSSY))),
            "mirror": int(jnp.sum(valid & (mt == REFLECTION))),
            "glass": int(jnp.sum(valid & (mt == REFLECTION_AND_REFRACTION))),
            "miss": int(jnp.sum(alive & ~surf.valid)),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        _, state, _ = bounce_step(scene, state, opts, n0,
                                  is_last=d == opts.max_depth)
        if state is None:
            break
    tot = sum(r["buffer_x_n0"] for r in rows)
    live = sum(r["buffer_x_n0"] * r["occupancy"] for r in rows)
    print(f"# whole-frame weighted occupancy: {live / tot:.3f} "
          f"(buffer-lane work {tot:.1f}x n0, live {live:.2f}x n0)",
          file=sys.stderr)
    return rows


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("config", nargs="?", default="config3")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--depth", type=int, default=None)
    a = p.parse_args()
    occupancy(a.config, a.width, a.depth)
