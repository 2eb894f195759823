"""Direct ∂cost/∂{width, iterations, capacity, coherence} of the grid walk.

The frame-level evidence is contradictory: the coarse re-tune (iters ↓1.7×,
bytes ↑10×) won 4.8×, suggesting latency-per-row-bound; but fractional
compaction (bounce width ↓4×) was NEUTRAL on the config4 frame, suggesting
the bounce walks aren't width-bound. This probe times `grid_walk` standalone
(sync, one jit per point) on the shipping config4 grid across:

  width    — 16k … 512k lanes (coherent primaries AND incoherent rays)
  itercap  — RT_GRID_ITER_CAP ladder at fixed width (marginal cost/iter;
             wrong images, cost attribution only)
  capacity — 32/48/64/128 grids at fixed coarse res (bytes/iter lever;
             spill → overflow brute, so NOT result-identical above the
             fill line — cost attribution only)

Incoherent rays = origins uniform inside the grid AABB, directions uniform
on the sphere — the bounce-wavefront access pattern.

Run on GPU:  python -m benchmarks.walk_cost
Quick:       RT_WALK_COST_QUICK=1 python -m benchmarks.walk_cost
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


def _synced(call):
    # The first cut of this probe used 1-vs-4 chains and produced mostly
    # 0.0 ms rows (sub-ms walks lost in the ~5-20 ms readback noise —
    # /tmp/r3_walk_cost.out, 2026-08-20). Delegate to the validated
    # auto-scaling sync timer instead: 6-vs-24 chains for fast calls.
    from benchmarks.rays_per_sec import _synced_time

    _, per = _synced_time(call, repeats=3)
    return per


def main():
    from raytracer.accel.grid import GridTracer, build_grid, grid_walk
    from raytracer.models import presets
    from raytracer.ops import geometry as geom

    quick = os.environ.get("RT_WALK_COST_QUICK") == "1"
    scene, cam, opts = presets.config4_mesh()
    t_min = float(opts.t_min)
    verts = np.asarray(scene.meshes.verts)
    tris = np.asarray(scene.meshes.tris)

    # coherent primaries: central band of the frame projection
    pdirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, 1920, 1080)
    pdirs = np.asarray(pdirs).reshape(1080, 1920, 3)[350:700].reshape(-1, 3)
    # incoherent: uniform origins in the mesh AABB, isotropic dirs
    rng = np.random.default_rng(0)
    lo, hi = verts.min(0), verts.max(0)
    N_MAX = 1 << 19
    iorig = rng.uniform(lo, hi, (N_MAX, 3)).astype(np.float32)
    idir = rng.normal(size=(N_MAX, 3))
    idir /= np.linalg.norm(idir, axis=1, keepdims=True)
    idir = idir.astype(np.float32)

    def run(grid, soa, orig, dirs, n, tag, extra=None):
        o = jnp.asarray(orig[:n])
        d = jnp.asarray(dirs[:n])
        v0, e1, e2 = soa

        @jax.jit
        def walk(eps):
            t, i = grid_walk(grid, v0, e1, e2, o + eps, d, t_min)
            return jnp.stack([t, i.astype(jnp.float32)])

        per = _synced(walk)
        row = {"probe": "walk_cost", "tag": tag, "n": n,
               "ms": round(per * 1e3, 3),
               "ns_per_lane": round(per / n * 1e9, 2)}
        if extra:
            row.update(extra)
        print(json.dumps(row), flush=True)
        return per

    tr = GridTracer.build(scene)
    soa = tr._soa
    g = tr._grid

    widths = (1 << 14, 1 << 16, 1 << 17, 1 << 19)
    if quick:
        widths = (1 << 14, 1 << 16)
    for n in widths:
        run(g, soa, np.broadcast_to(np.asarray(cam.pos, np.float32),
                                    (n, 3)), pdirs, min(n, pdirs.shape[0]),
            "width_coherent")
        run(g, soa, iorig, idir, n, "width_incoherent")

    # marginal cost per iteration (fixed width 128k, incoherent)
    n = 1 << 17
    for cap in (2, 4, 8, 16, 32, 0):
        os.environ["RT_GRID_ITER_CAP"] = str(cap)
        try:
            run(g, soa, iorig, idir, n, "itercap",
                {"itercap": cap or "uncapped"})
        finally:
            del os.environ["RT_GRID_ITER_CAP"]

    # capacity (row bytes) at fixed coarse res, incoherent + coherent
    if not quick:
        for capy in (32, 64, 128):
            g2 = build_grid(verts, tris, res=g.res, capacity=capy,
                            pregather=True)
            if int(g2.overflow.shape[0]) > 512:
                # small capacities at the coarse res overflow thousands of
                # tris into the per-lane brute fallback — [N, n_overflow, 3]
                # OOM'd at 17.7 GB on the first run; cost attribution is
                # meaningless there anyway
                print(json.dumps({"probe": "walk_cost", "tag": "capacity",
                                  "capacity": capy, "skipped": "overflow",
                                  "overflow": int(g2.overflow.shape[0])}),
                      flush=True)
                continue
            run(g2, soa, iorig, idir, n, "capacity",
                {"capacity": capy,
                 "overflow": int(g2.overflow.shape[0])})
            run(g2, soa,
                np.broadcast_to(np.asarray(cam.pos, np.float32), (n, 3)),
                pdirs, n, "capacity_coherent",
                {"capacity": capy,
                 "overflow": int(g2.overflow.shape[0])})


if __name__ == "__main__":
    main()
