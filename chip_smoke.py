#!/usr/bin/env python3
"""Smoke run of the renderer and its trainer on the GPU, at full size.

    python chip_smoke.py             # one GPU: every phase below
    python chip_smoke.py --cards 4   # four GPUs: the sharded path only

One process drives the card(s) through the entry points users call and
checks every result against the repository's plain references:

- fused forward (`FusedWhitted`, Pallas on Triton) for config2 1920x1080
  depth 2 and config3 1024² depth 4, each against the XLA wavefront image;
- the XLA path against the committed goldens (config2, config3, config4);
- config4 (20,480 triangles) 1920x1080 depth 4 through
  `renderer.render_banded` + `hostload.build_tracer(scene, "auto")`;
- a few `cli optimize` steps on config5, with the loss falling;
- the fused in-kernel training step (`plan_value_and_grad`) for config2
  against XLA autodiff of the replayed plan and of the wavefront render;
- config3's training step (glass trains through XLA autodiff) against
  central finite differences;
- config5 gradients against central finite differences at 128².

Each phase prints its compile time, steady time per frame or step, the
compiled program's memory analysis and every comparison with its limit.
The last line is one JSON object, printed only when every phase passed;
the script exits non-zero otherwise, and when JAX finds no GPU.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

# comparison limits (see PERF.md "Kernel decisions" and CLAUDE.md)
IMG_BULK = 1.5 / 255        # fused vs wavefront: per-pixel max-channel diff
IMG_BAD_FRAC = 0.002        # ... share of pixels allowed beyond IMG_BULK
GOLDEN_TOL, GOLDEN_BAD = 0.004, 0.004   # tests/test_forward_golden.py
GRAD_REL = 1e-3             # fused VJP vs autodiff, of each table's max |g|
FLIP_REL = 1e-2             # ... vs the wavefront's own winner search
LOSS_REL = 1e-3             # fused VJP loss vs autodiff loss
SHARD_TOL, SHARD_BAD = 1e-4, 0.005      # sharded vs one-card image


class CheckFailed(AssertionError):
    pass


def log(msg=""):
    print(msg, flush=True)


def check(name, value, limit, ok=None):
    """Print one comparison with its limit; raise when it fails."""
    ok = (value <= limit) if ok is None else ok
    log(f"  check {name}: {value:.6g} (limit {limit:.6g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise CheckFailed(f"{name}: {value} > {limit}")


def card_line() -> str:
    """Name and power limit of each card, from a child that stays off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


# ------------------------------------------------------------ helpers ----


def _memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k.replace("_size_in_bytes", "_bytes"): int(getattr(ma, k, 0))
            for k in keys}


def _compile(fn, *args):
    """AOT-compile `fn` at `args` → (compiled, seconds)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _steady(fn, *args, n=5):
    """Median host time of `n` calls, each ended by block_until_ready."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _report(tag, compile_s, steady_s, memory, unit="frame"):
    log(f"  {tag}: compile {compile_s:.3f} s, steady {steady_s:.6f} s/"
        f"{unit}, memory {json.dumps(memory)}")


def _img_diff(a, b):
    import numpy as np

    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return d.max(axis=-1)


def _preset(config, width=None, height=None, depth=None, **kw):
    from raytracer.models import presets

    scene, cam, opts = presets.PRESETS[config]()
    rep = {k: v for k, v in (("width", width), ("height", height),
                             ("max_depth", depth)) if v is not None}
    return scene, cam, dataclasses.replace(opts, **rep, **kw)


def _wavefront_image_fn(opts):
    """The XLA wavefront render as a function of (scene, camera)."""
    from raytracer.renderer import render

    def fn(scene, cam):
        out = render(scene, cam, opts)
        return out[0], (out[2] if len(out) > 2 else 0.0)
    return fn


# ------------------------------------------------------------- phases ----


def phase_fused_forward(config, width, height, depth, interpret=False):
    """Fused megakernel image vs the XLA wavefront image, timed both."""
    from raytracer.ops.fused import FusedWhitted

    scene, cam, opts = _preset(config, width, height, depth)
    if scene.has_glass:  # the wavefront's glass setting (rays_per_sec.py)
        opts = dataclasses.replace(opts, compact_cap=0.5)
    fw = FusedWhitted(scene, cam, opts, interpret=interpret)
    log(f"  fused tile {fw._tile}, warps {fw._warps}")
    fused, c_s = _compile(lambda eps: fw.render(eps=eps), 0.0)
    img = fused(0.0)
    _report("fused", c_s, _steady(fused, 0.0), _memory(fused))
    wave, c_w = _compile(_wavefront_image_fn(opts), scene, cam)
    ref, dropped = wave(scene, cam)
    _report("xla wavefront", c_w, _steady(wave, scene, cam), _memory(wave))
    check("wavefront dropped lanes", float(dropped), 0.0)
    d = _img_diff(img, ref)
    log(f"  fused vs wavefront: max {d.max():.4g}, mean {d.mean():.3g}")
    check("share of pixels beyond 1.5/255", float((d > IMG_BULK).mean()),
          IMG_BAD_FRAC)
    return img


def phase_goldens(cases=(("config2", 96, 96), ("config3", 96, 96),
                         ("config4", 192, 108))):
    """XLA path vs the committed C++-oracle goldens at their sizes."""
    from raytracer.io.image import load_ppm

    here = os.path.dirname(os.path.abspath(__file__))
    for name, w, h in cases:
        want = load_ppm(os.path.join(here, "tests", "golden",
                                     f"{name}_{w}x{h}.ppm"))
        scene, cam, opts = _preset(name, w, h)
        fn, c_s = _compile(_wavefront_image_fn(opts), scene, cam)
        img = fn(scene, cam)[0]
        d = _img_diff(img, want)
        log(f"  {name} {w}x{h}: compile {c_s:.3f} s")
        check(f"{name} share of pixels beyond {GOLDEN_TOL}",
              float((d > GOLDEN_TOL).mean()), GOLDEN_BAD)


def phase_mesh_forward(width=1920, height=1080, depth=4):
    """config4 through the `cli render` path: banded render + auto tracer."""
    import jax
    import numpy as np

    from raytracer import renderer
    from raytracer.utils.hostload import build_tracer

    scene, cam, opts = _preset("config4", width, height, depth)
    t0 = time.perf_counter()
    tracer = build_tracer(scene, "auto")
    log(f"  tracer {type(tracer).__name__} built in "
        f"{time.perf_counter() - t0:.3f} s")
    rows = renderer._auto_band_rows(scene, opts)
    band = renderer._band_jit.lower(scene, cam, tracer, 0, opts=opts,
                                    rows=rows, count_rays=False)
    t0 = time.perf_counter()
    band_c = band.compile()
    c_s = time.perf_counter() - t0
    n_bands = -(-opts.height // rows)
    t0 = time.perf_counter()
    img, traced = renderer.render_banded(scene, cam, opts, tracer=tracer,
                                         count_rays=True)
    jax.block_until_ready(img)
    first = time.perf_counter() - t0
    steady = _steady(lambda: renderer.render_banded(scene, cam, opts,
                                                    tracer=tracer)[0], n=3)
    _report(f"render_banded ({n_bands} bands of {rows} rows; first call "
            f"{first:.3f} s)", c_s, steady, _memory(band_c))
    img = np.asarray(img)
    log(f"  rays traced per frame {float(traced):.6g}")
    check("non-finite pixels", float((~np.isfinite(img)).sum()), 0.0)
    check(f"image shape {img.shape} differs", float(
        img.shape != (height, width, 3)), 0.0)
    check("share of black pixels", float((img.max(-1) <= 0.05).mean()), 0.5)
    return img


def phase_optimize(steps=8):
    """A few `cli optimize` steps on config5 (the default autodiff step)."""
    import numpy as np

    from raytracer import cli

    with tempfile.TemporaryDirectory() as tmp:
        res = cli.main(["optimize", "--steps", str(steps), "--log-every",
                        "1", "--out", os.path.join(tmp, "recovered.png")])
    losses, step_s = res["losses"], res["step_s"]
    _report("optimize step", res["compile_s"], float(np.median(step_s)),
            res["memory"], unit="step")
    check("final loss / first loss", losses[-1] / losses[0], 0.9)
    return losses


def _tables_to_scene(scene, tabs):
    """Write the fused kernel's four parameter tables into a scene."""
    def put(old, new):
        import jax.numpy as jnp
        return jnp.reshape(new, jnp.shape(old))

    sp, pn, mt, lg = scene.spheres, scene.planes, scene.materials, \
        scene.lights
    ns, npl = sp.count, pn.count
    nm, nl = mt.albedo.shape[0], lg.pos.shape[0]
    s, p, m, li = (tabs["sph"][:ns], tabs["pln"][:npl], tabs["mat"][:nm],
                   tabs["lgt"][:nl])
    return scene.replace(
        spheres=dataclasses.replace(sp, center=put(sp.center, s[:, 0:3]),
                                    radius=put(sp.radius, s[:, 3])),
        planes=dataclasses.replace(pn, point=put(pn.point, p[:, 0:3]),
                                   normal=put(pn.normal, p[:, 3:6]),
                                   albedo2=put(pn.albedo2, p[:, 6:9])),
        materials=dataclasses.replace(
            mt, albedo=put(mt.albedo, m[:, 0:3]), kd=put(mt.kd, m[:, 3]),
            ks=put(mt.ks, m[:, 4]), spec_n=put(mt.spec_n, m[:, 5]),
            ior=put(mt.ior, m[:, 6])),
        lights=dataclasses.replace(lg, pos=put(lg.pos, li[:, 0:3]),
                                   intensity=put(lg.intensity, li[:, 3:6])))


def _check_grads(tag, got, ref, spread, limit):
    """Per parameter table: max over entries of |got - ref| less twice the
    entry's float32 conditioning (`spread`: how far XLA's own gradient
    moves when the camera moves by ±2e-6), over the table's max |ref|. A
    non-finite spread or error fails."""
    import numpy as np

    for name in ref:
        a, b = np.asarray(got[name]), np.asarray(ref[name])
        sp = np.asarray(spread[name])
        err = np.abs(a - b)
        scale = float(np.abs(b).max()) or 1.0
        excess = np.where(np.isfinite(err) & np.isfinite(sp),
                          np.maximum(err - 2.0 * sp, 0.0), np.inf)
        at = np.unravel_index(int(err.argmax()), err.shape)
        log(f"  {tag} {name}: max error {err.max() / scale:.3g} of max |g| "
            f"at {list(map(int, at))}, where the conditioning spread is "
            f"{sp[at] / scale:.3g}")
        check(f"{tag} {name} error beyond conditioning / max |g|",
              float(excess.max()) / scale, limit)


def _shifted(cam, d):
    import numpy as np

    return dataclasses.replace(cam, pos=np.asarray(cam.pos, np.float32)
                               + np.float32(d))


def phase_fused_train(width, height, depth, interpret=False):
    """config2 fused in-kernel VJP: loss and every table's gradient against
    XLA autodiff of (a) the replay of the kernel's own winner plan — the
    same ids, so this isolates the kernel's arithmetic — and (b) the
    wavefront render, whose own winner search can flip knife-edge pixels.

    Some entries are ill-conditioned in float32 (a mirror sphere's radius:
    rays near its rim reflect with large magnification), so each entry's
    allowance includes how far the wavefront's own gradient moves under a
    ±2e-6 shift of the camera — PERF.md "Kernel decisions"."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer.ops.fused import TABLE_COLS, FusedWhitted
    from raytracer.ops.replay import value_and_grad_replay
    from raytracer.renderer import render

    scene, cam, opts = _preset("config2", width, height, depth)
    fw = FusedWhitted(scene, cam, opts, param_inputs=True,
                      interpret=interpret)
    log(f"  fused vjp tile {fw._vjp_tile}, warps {fw._vjp_warps}")
    target = jax.jit(lambda s, c: render(s, c, opts)[0])(scene, cam) * 0.9
    n3 = opts.width * opts.height * 3

    def fused_step(tgt):
        loss, g, img = fw.plan_value_and_grad(tgt)
        return loss / n3, {k: v / n3 for k, v in g.items()}, img

    kstep, c_k = _compile(fused_step, target)
    kloss, kgrads, kimg = kstep(target)
    _report("fused vjp", c_k, _steady(kstep, target), _memory(kstep),
            unit="step")
    tabs0 = {name: jnp.asarray(getattr(fw, "_p" + name))[
        :fw._rows[name], :nc] for name, nc in TABLE_COLS}

    def wave_loss(tabs, c, tgt):
        out = render(_tables_to_scene(scene, tabs), c, opts)
        return jnp.sum((out[0] - tgt) ** 2) / n3

    wstep, c_w = _compile(jax.value_and_grad(wave_loss), tabs0, cam, target)
    wloss, wgrads = wstep(tabs0, cam, target)
    _report("xla value_and_grad", c_w, _steady(wstep, tabs0, cam, target),
            _memory(wstep), unit="step")

    t0 = time.perf_counter()
    rloss, rgrads = jax.block_until_ready(value_and_grad_replay(
        _tables_to_scene, tabs0, scene, cam, opts, target, lambda p: fw))
    log(f"  replay value_and_grad: first call {time.perf_counter() - t0:.3f}"
        f" s")
    # float32 conditioning of each entry: how far the wavefront's own
    # gradient (which searches its own winners, so stays consistent) moves
    # when the camera moves by ±2e-6
    spread = {k: 0.0 for k in wgrads}
    for d in (2e-6, -2e-6):
        g_w = wstep(tabs0, _shifted(cam, d), target)[1]
        for k in spread:
            spread[k] = np.maximum(spread[k], np.abs(
                np.asarray(g_w[k]) - np.asarray(wgrads[k])))
    own = float(jnp.sum((kimg - target) ** 2)) / n3
    check("fused loss vs L2 of its own image (rel)",
          abs(float(kloss) - own) / own, 1e-4)
    check("fused loss vs replay loss (rel)",
          abs(float(kloss) - float(rloss)) / float(rloss), 1e-4)
    _check_grads("fused vs replay (same plan):", kgrads, rgrads, spread,
                 GRAD_REL)
    check("fused loss vs wavefront autodiff loss (rel)",
          abs(float(kloss) - float(wloss)) / float(wloss), LOSS_REL)
    _check_grads("fused vs wavefront autodiff:", kgrads, wgrads, spread,
                 FLIP_REL)


def phase_glass_train(width=1024, height=1024, depth=4):
    """config3 training step as the program takes it for glass scenes: XLA
    autodiff of the compacted wavefront, against central differences."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer.renderer import render

    scene, cam, opts = _preset("config3", width, height, depth,
                               compact_cap=0.5)
    n3 = opts.width * opts.height * 3
    target = jax.jit(lambda s, c: render(s, c, opts)[0])(scene, cam) * 0.9

    def loss(p, tgt):
        sc = scene.replace(
            materials=dataclasses.replace(scene.materials,
                                          albedo=p["albedo"]),
            lights=dataclasses.replace(scene.lights,
                                       intensity=p["intensity"]))
        img, _, dropped = render(sc, cam, opts)
        return jnp.sum((img - tgt) ** 2) / n3, dropped

    p0 = {"albedo": jnp.asarray(scene.materials.albedo),
          "intensity": jnp.asarray(scene.lights.intensity)}
    vg, c_s = _compile(jax.value_and_grad(loss, has_aux=True), p0, target)
    (val, dropped), g = vg(p0, target)
    _report("xla value_and_grad", c_s, _steady(vg, p0, target), _memory(vg),
            unit="step")
    check("dropped lanes", float(dropped), 0.0)
    lf, _ = _compile(lambda p, t: loss(p, t)[0], p0, target)
    eps = 1e-3
    for key in ("albedo", "intensity"):
        ga = np.asarray(g[key])
        idx = np.unravel_index(int(np.abs(ga).argmax()), ga.shape)
        hi = dict(p0, **{key: p0[key].at[idx].add(eps)})
        lo = dict(p0, **{key: p0[key].at[idx].add(-eps)})
        fd = (float(lf(hi, target)) - float(lf(lo, target))) / (2 * eps)
        ad = float(ga[idx])
        log(f"  d/d{key}{list(map(int, idx))}: autodiff {ad:.6g}, "
            f"central FD {fd:.6g}")
        check(f"glass d/d{key} |AD-FD| / |FD|",
              abs(ad - fd) / max(abs(fd), 1e-30), 0.01)


def phase_config5_fd(width=128, height=128, eps=1e-3):
    """config5 autodiff gradients vs central finite differences on the card
    (interior pixels only: silhouettes are zero-gradient by design)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer.models import presets
    from raytracer.renderer import render

    init, target, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=width, height=height)
    timg = render(target, cam, opts)[0]
    img0 = render(init, cam, opts)[0]
    edge = np.zeros((height, width), bool)
    for im in (np.asarray(timg).max(-1), np.asarray(img0).max(-1)):
        for ax in (0, 1):
            dd = np.abs(np.diff(im, axis=ax)) > 0.05  # silhouettes
            sl = [slice(None)] * 2
            sl[ax] = slice(None, -1)
            edge[tuple(sl)] |= dd
            sl[ax] = slice(1, None)
            edge[tuple(sl)] |= dd
    for _ in range(2):
        e = edge.copy()
        e[:-1] |= edge[1:]
        e[1:] |= edge[:-1]
        e[:, :-1] |= edge[:, 1:]
        e[:, 1:] |= edge[:, :-1]
        edge = e
    check("share of pixels masked as edges", float(edge.mean()), 0.5)
    mask = jnp.asarray(~edge, jnp.float32)[:, :, None]

    def loss(p):
        sc = init.replace(
            spheres=dataclasses.replace(init.spheres, center=p["center"]),
            materials=dataclasses.replace(init.materials,
                                          albedo=p["albedo"]))
        return jnp.mean(((render(sc, cam, opts)[0] - timg) ** 2) * mask)

    p0 = {"center": jnp.asarray(init.spheres.center, jnp.float32),
          "albedo": jnp.asarray(init.materials.albedo, jnp.float32)}
    vg, c_s = _compile(jax.value_and_grad(loss), p0)
    lf, _ = _compile(loss, p0)
    _, g = vg(p0)
    _report("config5 value_and_grad", c_s, _steady(vg, p0), _memory(vg),
            unit="step")
    for key, idx, rtol in (("center", (0, 0), 0.05), ("center", (1, 1), 0.05),
                           ("albedo", (0, 0), 0.01), ("albedo", (1, 2), 0.01)):
        hi = dict(p0, **{key: p0[key].at[idx].add(eps)})
        lo = dict(p0, **{key: p0[key].at[idx].add(-eps)})
        fd = (float(lf(hi)) - float(lf(lo))) / (2 * eps)
        ad = float(np.asarray(g[key])[idx])
        log(f"  d/d{key}{list(idx)}: autodiff {ad:.6g}, central FD {fd:.6g}")
        check(f"config5 d/d{key}{list(idx)} |AD-FD| / |FD|",
              abs(ad - fd) / max(abs(fd), 1e-30), rtol,
              ok=abs(ad - fd) <= rtol * abs(fd) + 5e-7 and fd != 0.0)


# -------------------------------------------------------- four cards ----


def phase_sharded_frame(width=1920, height=1080, depth=4):
    """config4 over four cards: Mesh(tiles=4) with a replicated GridTracer
    and Mesh(tiles=2, prims=2) with ShardTracer + per-shard BVH, each
    against the one-card render."""
    import jax
    import numpy as np

    from raytracer import renderer
    from raytracer.accel.grid import GridTracer
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.shard import build_sharded_accel, \
        render_sharded

    scene, cam, opts = _preset("config4", width, height, depth)
    grid = GridTracer.build(scene)
    t0 = time.perf_counter()
    ref = np.asarray(renderer.render_banded(scene, cam, opts, tracer=grid)[0])
    log(f"  one-card render_banded (with compile) "
        f"{time.perf_counter() - t0:.3f} s")
    devs = jax.devices()[:4]
    bvh_arrs, bvh_meta = build_sharded_accel(scene, 2)
    variants = (
        ("tiles=4 GridTracer", make_rt_mesh(tiles=4, prims=1, devices=devs),
         grid, lambda x: dict(tracer=x)),
        ("tiles=2 prims=2 ShardTracer+BVH",
         make_rt_mesh(tiles=2, prims=2, devices=devs), bvh_arrs,
         lambda x: dict(accel=(x, bvh_meta))))
    for tag, mesh, extra, kw in variants:
        fn = jax.jit(lambda s, c, x, mesh=mesh, kw=kw: render_sharded(
            s, c, opts, mesh, **kw(x))[0])
        t0 = time.perf_counter()
        img = fn(scene, cam, extra)
        jax.block_until_ready(img)
        first = time.perf_counter() - t0
        steady = _steady(fn, scene, cam, extra, n=2)
        log(f"  {tag}: first call (with compile) {first:.3f} s, steady "
            f"{steady:.6f} s/frame")
        bad = float((_img_diff(img, ref) > SHARD_TOL).mean())
        check(f"{tag} share of pixels beyond {SHARD_TOL}", bad, SHARD_BAD)


def phase_sharded_train():
    """config5 sharded training step (make_loss_and_grad) on four cards vs
    the same step on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracer.models import presets
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.overlap import make_loss_and_grad
    from raytracer.renderer import render

    init, target, cam, opts = presets.config5_inverse()
    tgt = render(target, cam, opts)[0]
    one = make_rt_mesh(tiles=1, prims=1, devices=jax.devices()[:1])
    l1, g1 = make_loss_and_grad(init, cam, opts, one)(init, tgt)
    for tiles, prims in ((4, 1), (2, 2)):
        mesh = make_rt_mesh(tiles=tiles, prims=prims,
                            devices=jax.devices()[:4])
        step = make_loss_and_grad(init, cam, opts, mesh)
        t0 = time.perf_counter()
        l4, g4 = step(init, tgt)
        jax.block_until_ready(g4)
        first = time.perf_counter() - t0
        steady = _steady(step, init, tgt, n=2)
        log(f"  tiles={tiles} prims={prims}: first call {first:.3f} s, "
            f"steady {steady:.6f} s/step")
        check(f"tiles={tiles} prims={prims} loss rel error",
              abs(float(l4) - float(l1)) / abs(float(l1)), 1e-5)
        worst, where = 0.0, ""
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g4),
                                jax.tree.leaves(g1)):
            a, b = np.asarray(a), np.asarray(b)
            if not jnp.issubdtype(a.dtype, jnp.floating) or not a.size:
                continue
            err = float(np.abs(a - b).max()) / (float(np.abs(b).max())
                                                + 1e-12)
            if err >= worst:
                worst, where = err, jax.tree_util.keystr(path)
        check(f"tiles={tiles} prims={prims} worst grad error / max |g| "
              f"({where})", worst, 1e-4)


# --------------------------------------------------------------- main ----


def one_card_phases():
    return [
        ("fused forward config2 1920x1080 d2",
         lambda: phase_fused_forward("config2", 1920, 1080, 2)),
        ("fused forward config3 1024x1024 d4",
         lambda: phase_fused_forward("config3", 1024, 1024, 4)),
        ("goldens", phase_goldens),
        ("config4 1920x1080 d4 render_banded", phase_mesh_forward),
        ("cli optimize config5", phase_optimize),
        ("fused train config2 1920x1080 d2",
         lambda: phase_fused_train(1920, 1080, 2)),
        ("xla train config3 1024x1024 d4", phase_glass_train),
        ("config5 finite differences 128x128", phase_config5_fd),
    ]


def four_card_phases():
    return [("sharded frame config4 1920x1080 d4", phase_sharded_frame),
            ("sharded train config5", phase_sharded_train)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only the path split over four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < args.cards:
        print(f"chip_smoke: needs {args.cards} GPU(s); JAX found "
              f"{[str(d) for d in devices]}", file=sys.stderr)
        return 2
    from raytracer.utils.cache import setup_compile_cache
    from raytracer.utils.native import native_lib

    log(card_line())
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
        f"compile cache {setup_compile_cache()}")
    t0 = time.perf_counter()
    log(f"native library: {'built/loaded' if native_lib() else 'absent'} "
        f"({time.perf_counter() - t0:.3f} s)")

    phases = one_card_phases() if args.cards == 1 else four_card_phases()
    failed = []
    for name, fn in phases:
        log(f"phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report, run the rest, and fail at the end
            traceback.print_exc()
            failed.append(name)
            log(f"  FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        log(f"  done in {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
