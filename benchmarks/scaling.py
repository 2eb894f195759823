"""Multi-device scaling benchmark (SURVEY.md §6: rays/s at 1/N devices,
scaling efficiency vs the ≥85% target).

On the CPU the mesh is the 8-device simulator (functional check of the
harness); on a host with several GPUs the same code measures NVLink
scaling. Usage:

  JAX_PLATFORMS=cpu python -m benchmarks.scaling
"""

import dataclasses
import json
import sys
import time

import jax


def run_scaling(config: str = "config2", width: int = 256, height: int = 256,
                max_depth: int = 2, device_counts=None, prims: int = 1,
                ring: bool = False, repeats: int = 3):
    from raytracer.models import presets
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.shard import render_sharded

    scene, cam, opts = presets.PRESETS[config]()
    opts = dataclasses.replace(opts, width=width, height=height,
                               max_depth=max_depth,
                               tile_rays=max(1024, width * height // 8))
    n_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]

    results = []
    for nd in device_counts:
        p = prims if nd % max(prims, 1) == 0 and nd >= prims else 1
        mesh = make_rt_mesh(tiles=nd // p, prims=p,
                            devices=jax.devices()[:nd])
        f = jax.jit(lambda s, c: render_sharded(s, c, opts, mesh, ring=ring)[0])
        jax.block_until_ready(f(scene, cam))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(scene, cam))
            best = min(best, time.perf_counter() - t0)
        results.append({"devices": nd, "seconds": best,
                        "pixrays_per_sec": width * height / best})

    base = results[0]
    sim = jax.devices()[0].platform == "cpu"
    for r in results:
        ideal = base["pixrays_per_sec"] * r["devices"]
        r["efficiency"] = r["pixrays_per_sec"] / ideal
        r["speedup"] = r["pixrays_per_sec"] / base["pixrays_per_sec"]
        if sim:
            # On the CPU simulator all N virtual devices share the host's
            # cores AND the 1-device baseline already multi-threads across
            # them, so ideal-N "efficiency" is unreachable by construction.
            # Speedup > 1 is the meaningful signal here (the sharded program
            # is not slower than the fused single-device one); ICI
            # efficiency vs the ≥85% target needs a real pod slice.
            r["sim_shared_cores"] = True
    return results


def run_scaling_grid(width: int = 480, height: int = 272, max_depth: int = 2,
                     device_counts=None, repeats: int = 3):
    """config4 (20k-tri mesh) scaling: replicated GridTracer, pixel-tile DP
    (the headline scene's sharding mode — render_sharded(tracer=...))."""
    from raytracer.accel.grid import GridTracer
    from raytracer.models import presets
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.shard import render_sharded

    scene, cam, opts = presets.PRESETS["config4"]()
    opts = dataclasses.replace(opts, width=width, height=height,
                               max_depth=max_depth, tile_rays=4096)
    tracer = GridTracer.build(scene)
    n_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= n_dev]
    results = []
    for nd in device_counts:
        mesh = make_rt_mesh(tiles=nd, prims=1, devices=jax.devices()[:nd])
        f = jax.jit(lambda s, c, tr: render_sharded(s, c, opts, mesh,
                                                    tracer=tr)[0])
        jax.block_until_ready(f(scene, cam, tracer))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(f(scene, cam, tracer))
            best = min(best, time.perf_counter() - t0)
        results.append({"case": "config4-grid", "devices": nd,
                        "seconds": best,
                        "pixrays_per_sec": width * height / best})
    _annotate(results)
    return results


def run_plan_train_scaling(width: int = 256, height: int = 256,
                           device_counts=None, repeats: int = 3):
    """Fused-plan replay TRAINING step scaling (the --plan path): the
    param-input megakernel's plan planes shard over 'tiles' with the pixel
    rows; each rank replays + differentiates its band, scene-param grads
    psum'd by the shard_map transpose. Grads equal the 1-device step."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from raytracer.models import presets
    from raytracer.ops.fused import FusedWhitted
    from raytracer.ops.replay import PlanTracer
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.renderer import render

    scene, cam, opts0 = presets.PRESETS["config2"]()
    n_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8) if d <= n_dev]
    ns, npl = scene.spheres.count, scene.planes.count
    p0 = {"center": jnp.asarray(scene.spheres.center),
          "albedo": jnp.asarray(scene.materials.albedo)}

    def apply_p(s, p):
        return s.replace(
            spheres=dataclasses.replace(s.spheres, center=p["center"]),
            materials=dataclasses.replace(s.materials, albedo=p["albedo"]))

    results = []
    for nd in device_counts:
        h = -(-height // (8 * nd)) * 8 * nd  # rows divisible by the mesh
        opts = dataclasses.replace(opts0, width=width, height=h,
                                   tile_rays=width * (h // nd))
        mesh = make_rt_mesh(tiles=nd, prims=1, devices=jax.devices()[:nd])
        fused = FusedWhitted(scene, cam, opts, param_inputs=True)
        target = jnp.asarray(render(scene, cam, opts)[0]) * 0.9
        rows_per = h // nd
        row0s = jnp.arange(nd, dtype=jnp.int32) * rows_per

        def shard_loss(p, wins_s, occs_s, r0, tgt_s, opts=opts,
                       rows_per=rows_per):
            tracer = PlanTracer(list(wins_s), list(occs_s), ns, npl)
            o = dataclasses.replace(opts, tile_rays=rows_per * opts.width)
            img = render(apply_p(scene, p), cam, o, tracer=tracer,
                         row0=r0[0], rows=rows_per)[0]
            err = jnp.sum((img - tgt_s) ** 2) / (opts.width * opts.height * 3)
            return jax.lax.psum(err, "tiles")

        vg = jax.jit(jax.value_and_grad(jax.shard_map(
            shard_loss, mesh=mesh,
            in_specs=(P(), P("tiles"), P("tiles"), P("tiles"), P("tiles")),
            out_specs=P(), check_vma=False)))

        def step(p):
            out = fused.bind(center=p["center"],
                             albedo=p["albedo"]).render_plan()
            wins = tuple(jax.lax.stop_gradient(w) for w in out[1])
            occs = tuple(jax.lax.stop_gradient(o_) for o_ in out[2])
            return vg(p, wins, occs, row0s, target)

        jax.block_until_ready(step(p0))
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            jax.block_until_ready(step(p0))
            best = min(best, time.perf_counter() - t0)
        results.append({"case": "plan-train", "devices": nd, "seconds": best,
                        "pixrays_per_sec": width * h / best})
    _annotate(results)
    return results


def _annotate(results):
    base = results[0]
    sim = jax.devices()[0].platform == "cpu"
    for r in results:
        r["speedup"] = r["pixrays_per_sec"] / base["pixrays_per_sec"]
        r["efficiency"] = r["speedup"] / r["devices"]
        if sim:
            r["sim_shared_cores"] = True
    return results


def run_grad_overlap(config: str = "config2", width: int = 128,
                     height: int = 128, max_depth: int = 2, tiles: int = 4,
                     prims: int = 2, repeats: int = 3):
    """A/B the bounce-pipelined backward (per-bounce psum) vs the fused-psum
    twin on the full device mesh (parallel/overlap.py). On the CPU sim this
    is a functional timing smoke; on a pod slice it measures whether the
    per-bounce allreduces actually overlap the backward compute.

    Measurement discipline (CLAUDE.md): no device→host readback before
    timing (the target stays a device array) and per-step time comes from
    the dependency-chain slope, not a single block_until_ready round-trip.
    """
    import jax.numpy as jnp

    from benchmarks.rays_per_sec import _chained_time
    from raytracer.models import presets
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.overlap import make_loss_and_grad
    from raytracer.parallel.shard import render_sharded

    scene, cam, opts = presets.PRESETS[config]()
    opts = dataclasses.replace(opts, width=width, height=height,
                               max_depth=max_depth)
    mesh = make_rt_mesh(tiles=tiles, prims=prims,
                        devices=jax.devices()[:tiles * prims])
    target = jax.jit(
        lambda s, c: render_sharded(s, c, opts, mesh)[0])(scene, cam) * 0.9

    out = {}
    for name, overlap in (("overlapped", True), ("fused", False)):
        step = make_loss_and_grad(scene, cam, opts, mesh, overlap=overlap)
        _, per = _chained_time(
            lambda eps: step(scene, jnp.asarray(target) + eps),
            repeats=repeats)
        out[name] = per
    out["speedup"] = out["fused"] / out["overlapped"]
    return out


def main():
    import argparse
    import os

    if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        # CPU-sim: expose 8 virtual devices (must precede backend init)
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    ap = argparse.ArgumentParser()
    ap.add_argument("--grad-overlap", action="store_true",
                    help="A/B per-bounce-psum backward vs fused backward")
    ap.add_argument("--case", default="config2",
                    choices=["config2", "config4-grid", "plan-train"])
    args = ap.parse_args()
    if args.grad_overlap:
        print(json.dumps(run_grad_overlap()))
        return
    if args.case == "config4-grid":
        res = run_scaling_grid()
    elif args.case == "plan-train":
        res = run_plan_train_scaling()
    else:
        res = run_scaling()
    for r in res:
        print(json.dumps(r))
    if len(res) > 1:
        last = res[-1]
        if last.get("sim_shared_cores"):
            print(f"# {last['devices']}-device CPU-sim speedup: "
                  f"{last['speedup']:.2f}x (shared host cores — ideal-N "
                  "efficiency not measurable off-pod; see run_scaling)",
                  file=sys.stderr)
        else:
            print(f"# {last['devices']}-device efficiency: "
                  f"{last['efficiency']:.1%}", file=sys.stderr)


if __name__ == "__main__":
    main()
