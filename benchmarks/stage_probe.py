"""Stage-level BAND-width probe: what does each d0 stage cost when it runs
ONCE at full band width, outside the renderer's tile scan?

Motivation: a standalone full-width coherent primary walk can be far
cheaper than the tiled renderer's depth-0 round on the same band (many
tiles × per-walk fixed costs). If the walks are cheap at band width and
only the renderer CONTEXT makes them expensive, the frame should be
restructured into per-stage full-width walks + (if needed) tiled shading.

Programs (config4 band, --rows rows of 1080p):
  nearest    — one full-width grid nearest walk (winner ints only)
  shade0     — nearest + surface_at + shade WITHOUT occlusion traces
  d0         — shade0 + the per-light occlusion walks (= a depth-0 render)
  d0tiled    — renderer.render at depth 0, shipping tile (reference)

Usage:  python -m benchmarks.stage_probe --rows 216 [--stage all]
Sync-timed (readback-differenced chains), one JSON line per stage.
"""

import argparse
import dataclasses
import json
import os
import sys

import jax

from raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

import jax.numpy as jnp

from benchmarks.rays_per_sec import _timer
from raytracer.accel.grid import GridTracer
from raytracer.models import presets
from raytracer.ops import geometry as geom
from raytracer.ops.shade import shade_diffuse
from raytracer.ops.trace import surface_at
from raytracer.core.types import DIFFUSE_AND_GLOSSY, as_jax


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=216)
    ap.add_argument("--row0", type=int, default=432,
                    help="band start row of the 1080p frame (default: a "
                         "middle band over the mesh — the top band is sky "
                         "and parks every walk at entry)")
    ap.add_argument("--stage", default="all",
                    choices=["nearest", "surf", "shade0", "d0", "occl", "d0tiled",
                             "all"])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--squash", action="store_true",
                    help="use a 1920x<rows> full-frame projection (the "
                         "bench's --height workload) instead of a band of "
                         "the 1080p frame — directly comparable to the "
                         "rays_per_sec fwd numbers")
    args = ap.parse_args(argv)

    scene, cam, opts = presets.PRESETS["config4"]()
    rows = args.rows
    row0 = args.row0
    if args.squash:
        opts = dataclasses.replace(opts, height=rows)
        row0 = 0
    tracer = GridTracer.build(scene)
    scene_j, cam_j, tracer = jax.device_put((as_jax(scene), cam, tracer))
    w, h = opts.width, opts.height
    n = rows * w

    def raygen(eps):
        d = geom.raygen(cam_j.pos, cam_j.c2w, cam_j.fov_deg, w, h,
                        row0=row0, rows=rows)
        o = jnp.broadcast_to(jnp.asarray(cam_j.pos), (n, 3)) + eps
        return o, d

    @jax.jit
    def p_nearest(eps, s, tr):
        o, d = raygen(eps)
        hit = tr.nearest(o, d, opts.t_min, opts.tri_chunk)
        return hit.t.sum(), hit.idx.sum()

    @jax.jit
    def p_surf(eps, s, tr):
        o, d = raygen(eps)
        hit = tr.nearest(o, d, opts.t_min, opts.tri_chunk)
        surf = surface_at(s, o, d, hit, opts.t_min)
        return surf.p.sum() + surf.n.sum() + surf.albedo.sum(), hit.t.sum()

    @jax.jit
    def p_shade0(eps, s, tr):
        o, d = raygen(eps)
        hit = tr.nearest(o, d, opts.t_min, opts.tri_chunk)
        surf = surface_at(s, o, d, hit, opts.t_min)
        is_diff = surf.valid & (surf.mtype == DIFFUSE_AND_GLOSSY)
        # no occlusion: tracer=None + a mesh-free scene clone would change
        # the math; instead shade with occlusion REPLACED by never-shadowed
        class _NoOcc:
            def occluded(self, orig, direc, max_t, t_min, tri_chunk,
                         active=None):
                return jnp.zeros(orig.shape[:1], bool)

        rgb, _ = shade_diffuse(s, surf, d, opts.bias, opts.t_min,
                               opts.tri_chunk, tracer=_NoOcc(),
                               active=is_diff)
        return jnp.where(is_diff[:, None], rgb, 0.0).sum(), hit.t.sum()

    @jax.jit
    def p_d0(eps, s, tr):
        o, d = raygen(eps)
        hit = tr.nearest(o, d, opts.t_min, opts.tri_chunk)
        surf = surface_at(s, o, d, hit, opts.t_min)
        is_diff = surf.valid & (surf.mtype == DIFFUSE_AND_GLOSSY)
        rgb, _ = shade_diffuse(s, surf, d, opts.bias, opts.t_min,
                               opts.tri_chunk, tracer=tr, active=is_diff)
        return jnp.where(is_diff[:, None], rgb, 0.0).sum(), hit.t.sum()

    @jax.jit
    def _surf_inputs(s, tr):
        # precomputed OUTSIDE timing: the occlusion walks' inputs
        o, d = raygen(jnp.zeros(()))
        hit = tr.nearest(o, d, opts.t_min, opts.tri_chunk)
        surf = surface_at(s, o, d, hit, opts.t_min)
        from raytracer.ops.safemath import dot as _dot
        sorig = surf.p + jnp.where(_dot(d, surf.n) < 0, 1.0, -1.0)[:, None] \
            * opts.bias * surf.n
        is_diff = surf.valid & (surf.mtype == DIFFUSE_AND_GLOSSY)
        return sorig, surf.p, is_diff

    _SI = None

    def p_occl(eps):
        # full-width per-light occlusion walks alone (inputs precomputed)
        nonlocal _SI
        if _SI is None:
            _SI = jax.block_until_ready(_surf_inputs(scene_j, tracer))
        return _p_occl_jit(eps, scene_j, tracer, *_SI)

    @jax.jit
    def _p_occl_jit(eps, s, tr, sorig, p, is_diff):
        acc = jnp.zeros((n,), jnp.float32)
        sorig = sorig + eps
        for li in range(s.lights.count):
            lvec = s.lights.pos[li][None, :] - p
            d2 = jnp.sum(lvec * lvec, axis=-1)
            dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
            ldir = lvec / jnp.maximum(dist, 1e-12)[:, None]
            occ = tr.occluded(sorig, ldir, dist, opts.t_min, opts.tri_chunk,
                              active=is_diff)
            acc = acc + occ.astype(jnp.float32)
        return acc.sum()

    o_d0 = dataclasses.replace(opts, max_depth=0)

    @jax.jit
    def _tiled(s, c, tr):
        from raytracer.renderer import render

        return render(s, c, o_d0, tracer=tr, row0=row0, rows=rows)

    def p_d0tiled(eps):
        c2 = dataclasses.replace(cam_j, pos=cam_j.pos + eps)
        return _tiled(scene_j, c2, tracer)[0]

    stages = {
        "nearest": lambda eps: p_nearest(eps, scene_j, tracer),
        "surf": lambda eps: p_surf(eps, scene_j, tracer),
        "shade0": lambda eps: p_shade0(eps, scene_j, tracer),
        "d0": lambda eps: p_d0(eps, scene_j, tracer),
        "occl": p_occl,
        "d0tiled": p_d0tiled,
    }
    todo = list(stages) if args.stage == "all" else [args.stage]
    out = {"rows": rows, "row0": row0, "lanes": n,
           "squash": bool(args.squash)}
    for name in todo:
        print(f"# {name} compile+warm…", file=sys.stderr, flush=True)
        _, per = _timer()(stages[name], repeats=args.repeats)
        out[name + "_s"] = per
        print(f"# {name}: {per:.6f} s", file=sys.stderr, flush=True)
    print("PHASE_RESULT " + json.dumps(out))


if __name__ == "__main__":
    main()
