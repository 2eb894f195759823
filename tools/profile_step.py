"""Profile one fwd or fwd+bwd step on the current backend and rank ops.

Usage:
    python tools/profile_step.py --config config2 --phase bwd \
        --width 1920 --height 1080 --depth 2 [--tile 16384] [--k 25]

Captures a jax.profiler trace of a few warm steps and prints the top-k ops
by total device time (utils/profiling.top_ops — no TensorBoard needed).
The per-stage named_scope marks (renderer.py) label the rows.

One process on the device at a time (CLAUDE.md); this is a single process.
"""

import argparse
import dataclasses
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp

from raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="config2")
    ap.add_argument("--phase", default="bwd",
                    choices=["fwd", "bwd", "replay"])
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--depth", type=int, default=-1)
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--logdir", default="")
    args = ap.parse_args()

    from benchmarks import rays_per_sec as rps
    from raytracer.renderer import render
    from raytracer.utils.profiling import print_top_ops

    kw = {}
    if args.width:
        kw["width"] = args.width
        kw["height"] = args.height or args.width
    if args.depth >= 0:
        kw["max_depth"] = args.depth
    if args.tile:
        kw["tile_rays"] = args.tile
    scene, cam, opts, tracer = rps._setup(args.config, **kw)
    bands = rps._bands(opts) if scene.meshes.count else [(0, opts.height)]
    print(f"# {args.config} {opts.width}x{opts.height} d{opts.max_depth} "
          f"tile={opts.tile_rays} bands={len(bands)} phase={args.phase}",
          file=sys.stderr, flush=True)

    if args.phase == "fwd":
        fns = {}
        for _, rows in bands:
            if rows not in fns:
                fns[rows] = jax.jit(
                    lambda eps, r0, rows=rows: render(
                        scene, dataclasses.replace(cam, pos=cam.pos + eps),
                        opts, tracer=tracer, row0=r0, rows=rows)[0])

        def step(eps):
            return [fns[rows](eps, r0) for r0, rows in bands][-1]
    elif args.phase == "replay":
        # the shipping non-glass training step: fused plan + replay vg
        from raytracer.ops.fused import FusedWhitted
        from raytracer.ops.replay import value_and_grad_replay

        target = jax.jit(lambda s, c: render(s, c, opts)[0])(scene, cam)
        jax.block_until_ready(target)
        target = target * 0.9
        p0 = rps._grad_params(scene)
        fused = FusedWhitted(scene, cam, opts, param_inputs=True)

        def builder(q):
            return fused.bind(center=q["center"], albedo=q["albedo"])

        def step(eps):
            p = jax.tree.map(lambda x: x + eps, p0)
            return value_and_grad_replay(rps._with_params, p, scene, cam,
                                         opts, target, builder)[0]
    else:
        n_pix = opts.width * opts.height
        tgt_fn = jax.jit(lambda r0, rows: render(
            scene, cam, opts, tracer=tracer, row0=r0, rows=rows)[0],
            static_argnames=("rows",))
        target = jnp.concatenate(
            [tgt_fn(r0, rows) for r0, rows in bands], axis=0) * 0.9
        p0 = rps._grad_params(scene)
        opts_b = dataclasses.replace(
            opts, remat_tiles=scene.has_glass and opts.remat_tiles)
        vg_by_rows = {}
        for _, rows in bands:
            if rows not in vg_by_rows:
                def band_loss(p, r0, rows=rows):
                    o = render(rps._with_params(scene, p), cam, opts_b,
                               tracer=tracer, row0=r0, rows=rows)[0]
                    return jnp.sum((o - jax.lax.dynamic_slice_in_dim(
                        target, r0, rows, 0)) ** 2) / (n_pix * 3)

                vg_by_rows[rows] = jax.jit(jax.value_and_grad(band_loss))
        vgs = [(vg_by_rows[rows], r0) for r0, rows in bands]

        def step(eps):
            p = jax.tree.map(lambda x: x + eps, p0)
            out = [vg(p, r0) for vg, r0 in vgs]
            return out[-1][0]

    zero = jnp.zeros(())
    print("# warm…", file=sys.stderr, flush=True)
    jax.block_until_ready(step(zero))
    jax.block_until_ready(step(zero))

    logdir = args.logdir or tempfile.mkdtemp(prefix="rt_prof_")
    print(f"# tracing {args.steps} steps -> {logdir}", file=sys.stderr,
          flush=True)
    jax.profiler.start_trace(logdir)
    o = zero
    for _ in range(args.steps):
        o = step(jax.tree.leaves(o)[0].ravel()[0] * 0.0)
    jax.block_until_ready(o)
    jax.profiler.stop_trace()
    print_top_ops(logdir, k=args.k)


if __name__ == "__main__":
    main()
