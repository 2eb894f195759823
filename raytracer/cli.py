"""CLI entry points. Reference analog: `main()` (SURVEY §1 L5).

  python -m raytracer.cli render   --config config2 --out out.png [--width W]
  python -m raytracer.cli optimize --steps 200 --out recovered.png
  python -m raytracer.cli bench    --config config4 [--repeats 3]
"""

import argparse
import dataclasses
import sys
import time


def _supervise_optimize(args):
    """Auto-restart supervisor: re-launch the checkpointed optimize loop as a
    child process (with --resume) until it completes or --max-restarts is
    spent. Recovery = process re-dispatch + exact orbax resume."""
    import subprocess

    if not args.checkpoint:
        raise SystemExit("--supervise requires --checkpoint")
    base = [sys.executable, "-m", "raytracer.cli", "optimize",
            "--preset", args.preset, "--steps", str(args.steps),
            "--out", args.out, "--checkpoint", args.checkpoint,
            "--ckpt-every", str(args.ckpt_every),
            "--log-every", str(args.log_every)]
    if args.lr is not None:
        base += ["--lr", str(args.lr)]
    if getattr(args, "plan", False):
        base += ["--plan"]
    for attempt in range(args.max_restarts + 1):
        cmd = base + (["--resume"] if (attempt or args.resume) else [])
        r = subprocess.run(cmd)
        if r.returncode == 0:
            if attempt:
                print(f"# supervised optimize finished after {attempt} "
                      f"restart(s)", file=sys.stderr)
            return
        if attempt == args.max_restarts:
            break  # budget spent — no restart follows, skip the log/backoff
        print(f"# optimize child exit {r.returncode}; restarting with "
              f"--resume ({attempt + 1}/{args.max_restarts})",
              file=sys.stderr, flush=True)
    raise SystemExit("supervised optimize: restart budget exhausted")


def _save(path: str, img):
    from raytracer.io.image import save_png, save_ppm

    if path.endswith(".ppm"):
        save_ppm(path, img)
    else:
        save_png(path, img)
    print("wrote", path)


def cmd_render(args):
    import numpy as np

    from raytracer.utils.hostload import build_tracer, load_scene_cli

    scene, cam, opts = load_scene_cli(args.config if not args.scene else "",
                                      args.scene, args.width, args.height,
                                      args.max_depth)
    if args.tile_block:
        bh, bw = (int(x) for x in args.tile_block.lower().split("x"))
        opts = dataclasses.replace(opts, tile_rays=bh * bw,
                                   tile_block=(bh, bw))
    if args.scene:
        args.config = args.scene
    kind = "grid" if args.grid else args.tracer
    if args.resilient:
        from raytracer.utils.elastic import render_resilient

        if args.trace:
            raise SystemExit("--resilient does not support --trace "
                             "(workers are separate processes)")
        if kind == "fused":
            raise SystemExit("--resilient does not support --tracer fused "
                             "(the fused megakernel replaces the banded "
                             "renderer the workers run)")
        t0 = time.perf_counter()
        img, rep = render_resilient(
            config=args.config if not args.scene else "",
            scene_path=args.scene, width=args.width, height=args.height,
            max_depth=args.max_depth, tracer=kind, ssaa=args.ssaa,
            min_rows=args.min_rows)
        dt = time.perf_counter() - t0
        aa = f" ssaa={args.ssaa}" if args.ssaa > 1 else ""
        print(f"{args.config}: {img.shape[1]}x{img.shape[0]}{aa} resilient "
              f"in {dt:.2f}s — {rep.bands_ok} bands ok, {rep.bands_failed} "
              f"failed, {rep.retries} retries, {rep.rays:.3g} rays")
        if rep.failed_rows:
            print("zero-filled rows:", rep.failed_rows)
        _save(args.out, img)
        return
    if kind == "fused":
        from raytracer.ops import fused

        s = args.ssaa
        hi = dataclasses.replace(opts, width=opts.width * s,
                                 height=opts.height * s) if s > 1 else opts
        fw = fused.FusedWhitted(scene, cam, hi)
        t0 = time.perf_counter()
        img = np.asarray(fw.render())
        if s > 1:
            img = img.reshape(opts.height, s, opts.width, s, 3).mean(
                axis=(1, 3))
        dt = time.perf_counter() - t0
        aa = f" ssaa={s}" if s > 1 else ""
        print(f"{args.config}: {opts.width}x{opts.height} "
              f"depth={opts.max_depth}{aa} in {dt:.2f}s (fused kernel, with "
              f"compile)")
        _save(args.out, img)
        return
    if args.compact:
        opts = dataclasses.replace(opts, compact_cap=args.compact)
    from raytracer.renderer import use_compact
    compact = use_compact(scene, opts)
    tracer = build_tracer(scene, kind)
    from raytracer.renderer import render_banded, render_ssaa

    def do_render():
        if args.ssaa > 1:
            out = render_ssaa(scene, cam, opts, factor=args.ssaa,
                              tracer=tracer, count_rays=True)
        else:
            # banded: one jitted program per band height (mesh scenes split
            # into bands of _auto_band_rows)
            out = render_banded(scene, cam, opts, count_rays=True,
                                tracer=tracer)
        if compact and float(out[2]) > 0:
            print(f"WARNING: compaction dropped {float(out[2]):.0f} alive "
                  f"lanes — image is missing radiance; raise --compact")
        return out[0], out[1]

    t0 = time.perf_counter()
    if args.trace:
        from raytracer.utils.profiling import xprof_trace

        with xprof_trace(args.trace):
            img, traced = do_render()
            import jax

            jax.block_until_ready(img)
        print(f"device trace written to {args.trace} "
              "(view with XProf/TensorBoard)")
    else:
        img, traced = do_render()
    img = np.asarray(img)
    dt = time.perf_counter() - t0
    rays = float(traced)
    aa = f" ssaa={args.ssaa}" if args.ssaa > 1 else ""
    print(f"{args.config}: {opts.width}x{opts.height} depth={opts.max_depth}"
          f"{aa} in {dt:.2f}s (with compile) — {rays:.3g} rays, "
          f"{rays / dt:.3g} rays/s")
    _save(args.out, img)


def cmd_optimize(args):
    """Inverse rendering (BASELINE config 5) with orbax checkpoint/resume and
    per-step JSONL metrics (SURVEY.md §5 'Checkpoint / resume', 'Metrics').

    --supervise completes the recovery story (SURVEY §5 'Failure detection /
    elastic recovery'): the optimizer loop runs as a child process that is
    re-launched with --resume after every crash, and checkpoint/resume is
    exact (tests/test_checkpoint.py: resumed trajectory == uninterrupted,
    step-for-step), so supervised runs converge to the identical result as
    uncrashed ones. RT_FAULT_AFTER_STEPS=<n> injects a hard exit after n
    steps per process for tests/drills.

    Returns {"losses", "step_s", "compile_s", "memory"}: the loss and host
    wall time of every logged step (the loss readback ends the step), and
    the default step's compile time and memory analysis (0 and {} for the
    fused steps, which compile inside their first call)."""
    import json
    import os

    if args.supervise:
        return _supervise_optimize(args)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from raytracer.io.image import save_png
    from raytracer.models import presets
    from raytracer.renderer import render

    if args.preset == "mesh":
        # geometry recovery (presets.config6_inverse_mesh): a radial
        # displacement field over the icosphere, normals re-derived
        # differentiably from the moving vertices every step
        from raytracer.io.meshgen import vertex_normals_jnp

        init, target, cam, opts = presets.config6_inverse_mesh()
        timg = render(target, cam, opts)[0]
        iverts = jnp.asarray(init.meshes.verts)
        rdirs = iverts - jnp.mean(iverts, axis=0)
        rdirs = rdirs / jnp.linalg.norm(rdirs, axis=1, keepdims=True)
        tris = jnp.asarray(init.meshes.tris)
        params = {"disp": jnp.zeros((iverts.shape[0],), jnp.float32)}

        def apply_params(p):
            v = iverts + p["disp"][:, None] * rdirs
            return init.replace(meshes=dataclasses.replace(
                init.meshes, verts=v,
                normals=vertex_normals_jnp(v, tris)))

        def report(p):
            from raytracer.io.meshgen import vertex_normals

            tv = np.asarray(target.meshes.verts)
            for tag, pr in (("init", {"disp": jnp.zeros_like(p["disp"])}),
                            ("recovered", p)):
                v = np.asarray(apply_params(pr).meshes.verts)
                n = vertex_normals(v, np.asarray(tris))
                vis = (n * (np.asarray(cam.pos)[None] - v)).sum(1) > 0
                err = np.abs(v - tv)
                print(f"{tag}: vertex L1 visible {err[vis].mean():.5f} "
                      f"hidden {err[~vis].mean():.5f}")

        # the pixel loss is noisy in geometry (winner ids flip discretely as
        # vertices move): a decayed step settles where a constant one
        # oscillates then diverges (measured)
        lr = args.lr if args.lr is not None else 2e-3
        opt = optax.adam(optax.exponential_decay(
            lr, transition_steps=80, decay_rate=0.5))
    else:
        init, target, cam, opts = presets.config5_inverse()
        timg = render(target, cam, opts)[0]
        params = {"center": jnp.asarray(init.spheres.center),
                  "albedo": jnp.asarray(init.materials.albedo)}

        def apply_params(p):
            return init.replace(
                spheres=dataclasses.replace(init.spheres, center=p["center"]),
                materials=dataclasses.replace(
                    init.materials, albedo=jnp.clip(p["albedo"], 0.0, 1.0)))

        def report(p):
            print("recovered centers:\n", np.asarray(p["center"]))
            print("recovered albedos:\n",
                  np.clip(np.asarray(p["albedo"]), 0, 1))

        opt = optax.adam(args.lr if args.lr is not None else 1e-2)

    def loss(p):
        return jnp.mean((render(apply_params(p), cam, opts)[0] - timg) ** 2)

    state = opt.init(params)
    start = 0

    ckpt_mgr = ocp = None
    if args.checkpoint:
        try:
            import orbax.checkpoint as ocp
        except ImportError:
            raise SystemExit("--checkpoint needs the orbax-checkpoint "
                             "package, which is not installed") from None

        path = os.path.abspath(args.checkpoint)
        # synchronous saves: async checkpointing loses the save when the
        # process dies right after (the crash mode --supervise recovers
        # from); the param pytree is tiny, durability beats the write
        # overlap
        ckpt_mgr = ocp.CheckpointManager(
            path, options=ocp.CheckpointManagerOptions(
                max_to_keep=2, enable_async_checkpointing=False))
        latest = ckpt_mgr.latest_step()
        if args.resume and latest is not None:
            restored = ckpt_mgr.restore(
                latest, args=ocp.args.StandardRestore(
                    {"params": params, "opt_state": state}))
            params, state = restored["params"], restored["opt_state"]
            start = latest + 1
            print(f"resumed from step {latest} at {path}")

    if getattr(args, "kernel", False):
        # in-kernel fused VJP (ops/fused.plan_value_and_grad): the
        # param-input megakernel re-emits the plan each step and ONE Pallas
        # kernel computes the L2 loss and the ANALYTIC parameter gradients
        # (jax.value_and_grad traced inside the kernel body) — no XLA
        # autodiff graph at all. Spheres preset only (fused-baked,
        # non-glass).
        from raytracer.ops.fused import FusedWhitted, supported

        assert args.preset != "mesh", "--kernel covers the spheres preset"
        assert supported(init)
        fused = FusedWhitted(init, cam, opts, param_inputs=True)
        n3 = opts.width * opts.height * 3
        ns = init.spheres.count
        nm = np.asarray(init.materials.albedo).shape[0]
        upd_jit = jax.jit(lambda g, s, p: opt.update(g, s, p))

        def step(p, s):
            fused.bind(center=p["center"],
                       albedo=jnp.clip(p["albedo"], 0.0, 1.0))
            lsum, g, _ = fused.plan_value_and_grad(timg)
            g2 = {"center": g["sph"][:ns, 0:3] / n3,
                  "albedo": g["mat"][:nm, 0:3] / n3}
            upd, s = upd_jit(g2, s, p)
            return optax.apply_updates(p, upd), s, lsum / n3
    elif getattr(args, "plan", False):
        # fused-plan replay step (ops/replay.py): the param-input megakernel
        # emits the winner plan each step (no recompile); autodiff sees only
        # the shading replay. Spheres preset only (non-glass, fused-baked).
        from raytracer.ops.fused import FusedWhitted, supported
        from raytracer.ops.replay import value_and_grad_replay

        assert args.preset != "mesh", "--plan covers the spheres preset"
        assert supported(init) and not init.has_glass
        fused = FusedWhitted(init, cam, opts, param_inputs=True)

        def _builder(q):
            return fused.bind(center=q["center"],
                              albedo=jnp.clip(q["albedo"], 0.0, 1.0))

        # a STABLE function object: it is the static `apply_params` argument
        # of the jitted replay band program — a fresh lambda per step would
        # be a jit cache miss (full retrace + recompile every optimizer step)
        def _apply2(_s, q):
            return apply_params(q)

        upd_jit = jax.jit(lambda g, s, p: opt.update(g, s, p))

        def step(p, s):
            # 4 gradient microbatches (a default not yet tuned on the GPU);
            # grads equal the single-band step by band-sum linearity
            val, g = value_and_grad_replay(
                _apply2, p, init, cam, opts, timg,
                _builder, band_rows=max(64, opts.height // 4))
            upd, s = upd_jit(g, s, p)
            return optax.apply_updates(p, upd), s, val
    else:
        @jax.jit
        def step(p, s):
            val, g = jax.value_and_grad(loss)(p)
            upd, s = opt.update(g, s)
            return optax.apply_updates(p, upd), s, val

    memory, compile_s = {}, 0.0
    if hasattr(step, "lower"):  # the default jitted step: compile it once,
        t0 = time.perf_counter()  # here, and keep the compiled program
        step = step.lower(params, state).compile()
        compile_s = time.perf_counter() - t0
        ma = step.memory_analysis()
        if ma is not None:
            memory = {k + "_bytes": int(getattr(ma, k + "_size_in_bytes", 0))
                      for k in ("argument", "output", "temp",
                                "generated_code")}
    fault_after = int(os.environ.get("RT_FAULT_AFTER_STEPS") or 0)
    losses, step_s = [], []
    for done, i in enumerate(range(start, args.steps)):
        if fault_after and done >= fault_after:
            print(f"# injected fault after {done} steps (process step {i})",
                  file=sys.stderr, flush=True)
            os._exit(43)
        t0 = time.perf_counter()
        params, state, val = step(params, state)
        if i % args.log_every == 0 or i == args.steps - 1:
            losses.append(float(val))  # the readback ends the step
            step_s.append(time.perf_counter() - t0)
            print(json.dumps({"step": i, "loss": losses[-1],
                              "step_s": round(step_s[-1], 6)}))
        if ckpt_mgr is not None and (i % args.ckpt_every == 0
                                     or i == args.steps - 1):
            ckpt_mgr.save(i, args=ocp.args.StandardSave(
                {"params": params, "opt_state": state}))
    if ckpt_mgr is not None:
        ckpt_mgr.wait_until_finished()
    save_png(args.out, np.asarray(render(apply_params(params), cam, opts)[0]))
    report(params)
    print("wrote", args.out)
    return {"losses": losses, "step_s": step_s, "compile_s": compile_s,
            "memory": memory}


def cmd_export(args):
    """Dump a preset as an editable scene text file (render --scene reads it)."""
    from raytracer.io.scenefile import save_scene
    from raytracer.models import presets

    scene, cam, opts = presets.PRESETS[args.config]()
    save_scene(args.out, scene, cam, opts)
    print("wrote", args.out)


def cmd_bench(args):
    from benchmarks.rays_per_sec import run_bench

    run_bench(config=args.config, repeats=args.repeats, fwd_bwd=not args.fwd_only)


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracer")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render")
    pr.add_argument("--config", default="config2",
                    choices=["config1", "config2", "config3", "config4", "config7"])
    pr.add_argument("--scene", default="",
                    help="render a scene text file instead of a preset "
                         "(format: docs/SPEC.md / io/scenefile.py)")
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--max-depth", type=int, default=None)
    pr.add_argument("--grid", action="store_true",
                    help="(deprecated) alias for --tracer grid")
    pr.add_argument("--tracer", default="auto",
                    choices=["auto", "none", "grid", "bvh", "fused"],
                    help="mesh winner-search backend (auto = grid when the "
                         "scene has triangles; fused = single-kernel "
                         "forward on the GPU for scenes without big meshes, "
                         "glass included)")
    pr.add_argument("--trace", default="",
                    help="write a jax.profiler device trace to this dir")
    pr.add_argument("--compact", type=float, default=0,
                    help="wavefront lane compaction cap: keep "
                         "at most N x primary-ray lanes per bounce instead "
                         "of doubling buffers (glass scenes); warns if any "
                         "alive lane is dropped")
    pr.add_argument("--ssaa", type=int, default=1,
                    help="supersampling factor: trace an N× frame and "
                         "box-average N² subsamples per pixel")
    pr.add_argument("--tile-block", default="",
                    help="scan tiles as BHxBW screen blocks (sets tile_rays"
                         "=BH*BW); bitwise-identical images (config4 preset "
                         "default 32x160)")
    pr.add_argument("--resilient", action="store_true",
                    help="elastic mode: render bands in re-dispatchable "
                         "subprocesses with split-retry (survives a crashed "
                         "band process; utils/elastic.py)")
    pr.add_argument("--min-rows", type=int, default=8,
                    help="resilient mode: smallest band split before a piece "
                         "is declared failed and zero-filled")
    pr.set_defaults(fn=cmd_render)

    po = sub.add_parser("optimize")
    po.add_argument("--preset", default="spheres",
                    choices=["spheres", "mesh"],
                    help="spheres = config5 (centers+albedos); mesh = "
                         "config6 (vertex displacement-field recovery)")
    po.add_argument("--steps", type=int, default=200)
    po.add_argument("--lr", type=float, default=None,
                    help="default: 1e-2 (spheres) / 2e-3 exp-decayed (mesh)")
    po.add_argument("--out", default="recovered.png")
    po.add_argument("--checkpoint", default="",
                    help="orbax checkpoint dir (enables save)")
    po.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint")
    po.add_argument("--ckpt-every", type=int, default=25)
    po.add_argument("--log-every", type=int, default=10)
    po.add_argument("--plan", action="store_true",
                    help="fused-plan replay training step (spheres preset, "
                         "GPU): the megakernel plans, autodiff replays "
                         "shading")
    po.add_argument("--kernel", action="store_true",
                    help="in-kernel fused-VJP training step (spheres "
                         "preset, GPU): one Pallas kernel computes loss + "
                         "analytic param grads from the re-emitted plan")
    po.add_argument("--supervise", action="store_true",
                    help="elastic mode: run the loop as a child process and "
                         "auto-restart it with --resume after crashes "
                         "(requires --checkpoint)")
    po.add_argument("--max-restarts", type=int, default=20)
    po.set_defaults(fn=cmd_optimize)

    pe = sub.add_parser("export")
    pe.add_argument("--config", default="config2",
                    choices=["config1", "config2", "config3", "config4", "config7"])
    pe.add_argument("--out", default="scene.txt")
    pe.set_defaults(fn=cmd_export)

    pb = sub.add_parser("bench")
    pb.add_argument("--config", default="config4")
    pb.add_argument("--repeats", type=int, default=3)
    pb.add_argument("--fwd-only", action="store_true")
    pb.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    from raytracer.utils.cache import setup_compile_cache

    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    main()
