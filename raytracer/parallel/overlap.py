"""Bounce-pipelined backward: per-bounce gradient psum (the PP-analog).

SURVEY.md §2.3 row "PP-analog — bounce pipelining": scene-parameter gradients
"all-reduced overlapped with the backward bounce passes". The standard path
(parallel/shard.py + jax.grad) emits ONE fused psum for all scene cotangents
at the very end of the backward program, so the allreduce sits exposed on the
critical path. Here the backward sweep is written out bounce-by-bounce
(reverse depth order, recompute-based like jax.checkpoint at bounce
granularity), and each bounce's scene cotangent is psummed the moment that
bounce's VJP completes — data-independent of the remaining bounces' VJPs, so
XLA's latency-hiding scheduler can run the collective concurrently with them
(on a pod: over ICI/DCN; the 8-device CPU sim validates the math).

Mechanics: forward runs `renderer.bounce_step` saving only the per-bounce ray
states (o, d, thr, alive — O(rays) residuals); backward re-linearizes one
bounce at a time with jax.vjp over the float state (o, d, thr) and the
scene's float leaves, with the bool alive masks frozen from the forward pass
(the winner search is integer/stop-gradient, so no cotangent ever flows
through the search collectives — ShardTracer's all_gather / RingTracer's
ppermute transpose to nothing).

Scope: gradients w.r.t. the scene's float leaves (geometry/material/light
parameters); camera is treated as fixed (matching the inverse-rendering
configs). Each device processes its whole pixel shard as one wavefront.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from raytracer.core.types import Camera, RenderOptions, Scene, as_jax
from raytracer.ops import geometry as geom
from raytracer.ops.safemath import clamp01
from raytracer.parallel import tracer as tr
from raytracer.renderer import bounce_step


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def float_partition(tree):
    """Split a pytree into (float_leaves, other_leaves, rebuild):
    rebuild(floats, others) restores the tree. The differentiable-parameter
    view of a Scene — rebuild closes over structure only, so both leaf lists
    can be passed through shard_map explicitly."""
    leaves, treedef = jax.tree.flatten(tree)
    is_f = tuple(hasattr(l, "dtype")
                 and jnp.issubdtype(l.dtype, jnp.floating) for l in leaves)
    floats = tuple(l for l, f in zip(leaves, is_f) if f)
    others = tuple(l for l, f in zip(leaves, is_f) if not f)

    def rebuild(floats_new, others_new):
        fi, oi = iter(floats_new), iter(others_new)
        return jax.tree.unflatten(
            treedef, [next(fi) if f else next(oi) for f in is_f])

    return floats, others, rebuild


def loss_and_grad_overlapped(scene: Scene, camera: Camera,
                             opts: RenderOptions, mesh, target,
                             ring: bool = False, overlap: bool = True):
    """One-shot convenience wrapper around `make_loss_and_grad` (compiles per
    call — build the step once via the factory inside loops)."""
    step = make_loss_and_grad(scene, camera, opts, mesh, ring=ring,
                              overlap=overlap)
    return step(scene, target)


def make_loss_and_grad(template: Scene, camera: Camera, opts: RenderOptions,
                       mesh, ring: bool = False, overlap: bool = True):
    """Build once → `step(scene, target) -> (loss, grad_scene)`, compiled on
    first call and reused after (static layout — pytree structure, primitive
    counts, mesh, opts — is taken from `template`; later scenes must match).

    loss = MSE(render(scene), target); grad_scene is a Scene-shaped pytree
    (zeros for non-float leaves). `overlap=False` runs the identical pipeline
    through plain jax.value_and_grad (ONE fused end-of-backward psum) — the
    baseline the per-bounce sweep is verified against and benchmarked on
    hardware. The math matches parallel.shard.render_sharded gradients too,
    but knife-edge pixels (horizon/silhouette rays whose winner flips on
    1-ulp raygen differences between separately compiled programs) make that
    comparison loose; the two modes here share one forward program, so they
    agree tightly.
    """
    scene = as_jax(template)
    camera = as_jax(camera)
    n_tiles = mesh.shape["tiles"]
    n_prims = mesh.shape["prims"]
    h, w = opts.height, opts.width
    n_pix = h * w
    per_dev = _ceil_to(-(-n_pix // n_tiles), 8)
    n_pad = per_dev * n_tiles

    dirs = geom.raygen(camera.pos, camera.c2w, camera.fov_deg, w, h)
    if n_pad != n_pix:
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.asarray([0.0, 0.0, -1.0], jnp.float32),
                                    (n_pad - n_pix, 3))])

    g_full = tr.pad_trace_geom(tr.build_trace_geom(scene), n_prims)
    sizes = (g_full.sph_c.shape[0] // n_prims,
             g_full.pl_p.shape[0] // n_prims,
             g_full.tri_v0.shape[0] // n_prims)
    sc_floats, sc_others, sc_rebuild = float_partition(scene)
    depths = opts.max_depth + 1

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P("tiles", None), P("tiles", None),
                       tr.geom_pspec("prims"), P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def body(dirs_shard, tgt_shard, g_shard, floats_rep, others_rep, cam_pos):
        if ring:
            tracer = tr.RingTracer(g_shard, "prims", sizes, n_prims)
        else:
            tracer = tr.ShardTracer(g_shard, "prims", sizes)
        me = jax.lax.axis_index("tiles")
        pix_mask = ((me * per_dev + jnp.arange(per_dev)) < n_pix)[:, None]

        def step_d(d, floats, fstate, alive):
            """Float-only view of bounce d: (o, dir, thr) × scene floats →
            (terms, next (o, dir, thr)). alive is frozen from the forward."""
            o, di, thr = fstate
            terms, nstate, _ = bounce_step(
                sc_rebuild(floats, others_rep), (o, di, thr, alive), opts,
                per_dev, is_last=d == depths - 1, tracer=tracer)
            if nstate is None:
                return tuple(terms)
            return tuple(terms), nstate[:3]

        def local_loss(r):
            e = (clamp01(r) - tgt_shard) * pix_mask
            return jnp.sum(e * e) / (n_pix * 3)

        def forward(floats):
            """→ (rad, saved per-bounce states). One wavefront per device."""
            orig = jnp.broadcast_to(cam_pos, (per_dev, 3))
            fstate = (orig, dirs_shard, jnp.ones((per_dev, 3), jnp.float32))
            alive = jnp.ones((per_dev,), bool)
            saved = []
            rad = jnp.zeros((per_dev, 3), jnp.float32)
            for d in range(depths):
                saved.append((fstate, alive))
                terms, nstate, _ = bounce_step(
                    sc_rebuild(floats, others_rep), fstate + (alive,), opts,
                    per_dev, is_last=d == depths - 1, tracer=tracer)
                for t in terms:
                    rad = rad + t
                if nstate is not None:
                    fstate, alive = nstate[:3], nstate[3]
            return rad, saved

        if not overlap:
            # baseline: identical pipeline, plain autodiff — XLA emits one
            # fused psum for all scene cotangents at the end of backward
            def whole(floats):
                return local_loss(forward(floats)[0])

            lval, cot_floats = jax.value_and_grad(whole)(floats_rep)
            return (jax.lax.psum(lval, "tiles"),
                    tuple(jax.lax.psum(cot_floats, "tiles")))

        # ---- forward: save only per-bounce ray states -------------------
        rad, saved = forward(floats_rep)
        lval, loss_vjp = jax.vjp(local_loss, rad)
        loss = jax.lax.psum(lval, "tiles")
        (cot_rad,) = loss_vjp(jnp.ones((), jnp.float32))

        # ---- backward: reverse bounce sweep, psum per bounce ------------
        grads = None
        cot_state = None
        for d in reversed(range(depths)):
            fstate_d, alive_d = saved[d]

            def fn(fl, st, d=d, al=alive_d):
                return step_d(d, fl, st, al)

            primal, vjp_fn = jax.vjp(fn, floats_rep, fstate_d)
            if d == depths - 1:
                cots = tuple(cot_rad for _ in primal)
            else:
                terms_p, _nstate_p = primal
                cots = (tuple(cot_rad for _ in terms_p), cot_state)
            cot_floats, cot_state = vjp_fn(cots)
            # the per-bounce allreduce: independent of the remaining VJPs,
            # free to overlap with bounce d-1's compute
            cot_floats = jax.lax.psum(cot_floats, "tiles")
            grads = cot_floats if grads is None else jax.tree.map(
                jnp.add, grads, cot_floats)
        return loss, tuple(grads)

    jbody = jax.jit(body)

    def step(sc: Scene, target):
        sc = as_jax(sc)
        g = tr.pad_trace_geom(tr.build_trace_geom(sc), n_prims)
        fl, ot, _ = float_partition(sc)
        tgt = jnp.asarray(target, jnp.float32).reshape(-1, 3)
        if n_pad != n_pix:
            tgt = jnp.concatenate(
                [tgt, jnp.zeros((n_pad - n_pix, 3), jnp.float32)])
        loss, gfloats = jbody(dirs, tgt, g, fl, ot, camera.pos)
        zeros = tuple(jnp.zeros_like(o) if hasattr(o, "dtype") else o
                      for o in ot)
        return loss, sc_rebuild(gfloats, zeros)

    return step
