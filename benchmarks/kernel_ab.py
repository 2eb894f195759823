"""The fused Pallas kernels against XLA's plain version, on the GPU, in turns.

    python -m benchmarks.kernel_ab [--sweep] [--rounds 3]

Forward (frame time): `FusedWhitted.render` vs `renderer.render`, the XLA
wavefront (config3 compacted at cap 0.5, as the benchmark runs it), for
config2 1920x1080 depth 2 and config3 1024² depth 4.

Training (step time, config2): `FusedWhitted.plan_value_and_grad` vs
`jax.value_and_grad` of the wavefront loss vs the replay step
(`ops/replay.value_and_grad_replay`); config3: `jax.value_and_grad` of the
compacted wavefront, the path glass scenes take.

Each pair is timed A, B, B, A per round, each timing the median of `--n`
calls ended by `block_until_ready`, all in this one process. `--sweep` also
times power-of-two blocks and warp counts for the config2 kernels. Prints
one JSON line per measurement (also appended to chiprun_out/kernel_ab.jsonl)
after a line with the card's name and power limit. Needs a GPU.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.models import presets
from raytracer.ops.fused import FusedWhitted
from raytracer.ops.replay import value_and_grad_replay
from raytracer.renderer import render
from raytracer.utils.cache import setup_compile_cache

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chiprun_out", "kernel_ab.jsonl")


def emit(rec):
    line = json.dumps(rec)
    print(line, flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def timed(fn, *args, n=10):
    """Median seconds of n calls (after one warm call)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def setup(config, w, h, d):
    scene, cam, opts = presets.PRESETS[config]()
    opts = dataclasses.replace(opts, width=w, height=h, max_depth=d)
    if scene.has_glass:
        opts = dataclasses.replace(opts, compact_cap=0.5)
    return scene, cam, opts


def with_p(scene, p):
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


def candidates(config, w, h, d, n):
    """{name: (callable, args, compile_s)} for forward and training."""
    scene, cam, opts = setup(config, w, h, d)
    n3 = w * h * 3
    out = {}

    def add(name, fn, *args):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out[name] = (fn, args, time.perf_counter() - t0)

    fw = FusedWhitted(scene, cam, opts)
    add("fwd fused", jax.jit(lambda eps: fw.render(eps=eps)), 0.0)
    add("fwd xla wavefront",
        jax.jit(lambda s, c: render(s, c, opts)[0]), scene, cam)
    target = out["fwd xla wavefront"][0](scene, cam) * 0.9
    p0 = {"center": jnp.asarray(scene.spheres.center),
          "albedo": jnp.asarray(scene.materials.albedo)}

    def wave_loss(p, tgt):
        return jnp.sum((render(with_p(scene, p), cam, opts)[0] - tgt) ** 2) \
            / n3

    add("train xla value_and_grad", jax.jit(jax.value_and_grad(wave_loss)),
        p0, target)
    if scene.has_glass:
        return out
    fp = FusedWhitted(scene, cam, opts, param_inputs=True)
    add("train fused vjp",
        jax.jit(lambda tgt: fp.plan_value_and_grad(tgt)[:2]), target)

    def replay(p, tgt):
        return value_and_grad_replay(
            with_p, p, scene, cam, opts, tgt,
            lambda q: fp.bind(center=q["center"], albedo=q["albedo"]),
            band_rows=max(64, h // 4))

    add("train replay", replay, p0, target)
    return out


def ab(config, w, h, d, rounds, n):
    cands = candidates(config, w, h, d, n)
    for kind in ("fwd", "train"):
        names = [k for k in cands if k.startswith(kind)]
        times = {k: [] for k in names}
        for r in range(rounds):
            order = names if r % 2 == 0 else names[::-1]
            for k in order + order[::-1]:  # A B B A
                fn, args, _ = cands[k]
                times[k].append(timed(fn, *args, n=n))
        for k in names:
            t = times[k]
            emit({"config": config, "size": f"{w}x{h}", "depth": d,
                  "what": k, "median_s": float(np.median(t)),
                  "min_s": min(t), "max_s": max(t), "samples": len(t),
                  "first_call_s": cands[k][2]})


def sweep(n):
    """Power-of-two blocks and warps for the config2 kernels."""
    scene, cam, opts = setup("config2", 1920, 1080, 2)
    for tile in ((1, 64), (1, 128), (1, 256), (1, 512), (2, 128), (4, 64)):
        for warps in (1, 2, 4, 8):
            if tile[0] * tile[1] < 32 * warps:
                continue
            fw = FusedWhitted(scene, cam, opts, tile=tile, num_warps=warps)
            f = jax.jit(lambda eps, fw=fw: fw.render(eps=eps))
            t0 = time.perf_counter()
            jax.block_until_ready(f(0.0))
            c = time.perf_counter() - t0
            emit({"sweep": "fwd config2 1920x1080 d2", "tile": tile,
                  "warps": warps, "median_s": timed(f, 0.0, n=n),
                  "first_call_s": c})
    target = jax.jit(lambda s, c: render(s, c, opts)[0])(scene, cam) * 0.9
    for tile, warps in (((1, 64), 2), ((1, 128), 2), ((1, 128), 4),
                        ((1, 256), 4)):
        fp = FusedWhitted(scene, cam, opts, param_inputs=True,
                          vjp_tile=tile, num_warps=warps)
        f = jax.jit(lambda tgt, fp=fp: fp.plan_value_and_grad(tgt)[:2])
        t0 = time.perf_counter()
        jax.block_until_ready(f(target))
        c = time.perf_counter() - t0
        emit({"sweep": "train fused vjp config2 1920x1080 d2",
              "vjp_tile": tile, "warps": warps,
              "median_s": timed(f, target, n=n), "first_call_s": c})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=10)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_ab needs a GPU")
    setup_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    emit({"card": card, "device_kind": jax.devices()[0].device_kind,
          "jax": jax.__version__})
    if args.sweep:
        sweep(args.n)
    ab("config2", 1920, 1080, 2, args.rounds, args.n)
    ab("config3", 1024, 1024, 4, args.rounds, args.n)


if __name__ == "__main__":
    main()
