"""Wavefront Whitted renderer — the data-parallel replacement for `castRay` recursion.

Reference analog: `render()` + recursive `castRay` (SURVEY.md §3.1 L4/L3). The
recursion becomes a statically unrolled loop over bounce depth carrying per-ray
state (origin, dir, throughput, alive); radiance accumulates as
Σ_depth throughput · leaf_value (docs/SPEC.md "Wavefront equivalence").

Glass scenes statically double the ray buffer per bounce ([reflect | refract]
children concatenated); pixel of buffer slot i is `i mod n_pixels`, so folding a
[k·n0, 3] buffer back to pixels is a reshape + sum — no index tracking.

The image loop runs in fixed-size ray tiles via `lax.scan` (sequential tiles →
bounded memory; the multi-chip path shards tiles across devices instead,
see parallel/).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from raytracer.core.types import (
    DIFFUSE_AND_GLOSSY, KIND_PLANE, KIND_SPHERE, KIND_TRIANGLE, REFLECTION,
    REFLECTION_AND_REFRACTION, Camera, RenderOptions, Scene)
from raytracer.core.types import as_jax as _types_as_jax
from raytracer.ops import geometry as geom
from raytracer.ops.shade import shade_diffuse
from raytracer.ops.safemath import clamp01, normalize
from raytracer.ops.trace import nearest_hit, surface_at


def _name_plan(hit):
    """Tag winner-search outputs as remat residuals (checkpoint_name).

    The 'plan' of a frame — nearest-hit (kind, idx) per bounce and the
    per-light shadow-occlusion bits — is everything the differentiable
    recompute needs from the stop-gradient walks. Saving exactly these under
    `save_only_these_names` gives walk-free backward recompute at ids-sized
    residual memory (vs full activations with remat off, or re-walking with
    plain remat).

    `t` is deliberately NOT tagged: surface_at recomputes it from the
    integer winner, so the float plane is dead after the tracer — but a
    checkpoint_name annotation blocks DCE, so a tagged t would be
    materialized per bounce for nothing. Untagged, XLA erases it."""
    from jax.ad_checkpoint import checkpoint_name

    from raytracer.ops.trace import Hit

    return Hit(kind=checkpoint_name(hit.kind, "trace_plan"),
               idx=checkpoint_name(hit.idx, "trace_plan"),
               t=hit.t)


def use_compact(scene: Scene, opts: RenderOptions) -> bool:
    """Does this (scene, opts) pair run compacted wavefronts?

    Glass scenes compact to stop the per-bounce buffer doubling; fractional
    caps (<1) additionally compact single-child wavefronts — from bounce 1
    only specular children live, and the walk tracers pay a gather row per
    parked lane regardless, so fewer lanes is the lever."""
    return opts.compact_cap is not None and (scene.has_glass
                                             or opts.compact_cap < 1)


def _cap_lanes(cap: float, n0: int) -> int:
    """Static lane budget for a compacted wavefront (8-lane aligned)."""
    return max(8, _ceil_to(int(round(cap * n0)), 8))


def _fold(x, n0, pix=None):
    """[k·n0, C] buffer → per-pixel [n0, C] by summing the k child slots.

    With `pix` [k·n0] given (compacted wavefronts, where lane order no longer
    encodes the pixel), fold by scatter-add on the carried pixel ids instead —
    same sum up to fp association."""
    if pix is None:
        return x.reshape(-1, n0, x.shape[-1]).sum(axis=0)
    return jnp.zeros((n0, x.shape[-1]), x.dtype).at[pix].add(x)


def _compact(state, pix, cap_lanes: int):
    """Keep the first `cap_lanes` lanes, alive-first (stable) → smaller
    buffers for the next bounce. Returns (state', pix', dropped) where
    `dropped` counts alive lanes that did NOT fit (0 ⇒ result exact).

    Sort-free: the alive-first stable permutation is two prefix sums (alive
    lanes keep their order, then dead lanes) materialized by one int32
    scatter. An argsort would produce the IDENTICAL permutation but as a
    full payload sort, far dearer than cumsum at wavefront widths, and it
    would re-run inside the remat backward."""
    from raytracer.ops.dgather import permute_take

    o, d, thr, alive = state
    n = alive.shape[0]
    ai = alive.astype(jnp.int32)
    n_alive = jnp.sum(ai)
    pos = jnp.where(alive, jnp.cumsum(ai) - 1,
                    n_alive + jnp.cumsum(1 - ai) - 1)  # stable partition slot
    order = jnp.zeros((n,), jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True)[:cap_lanes]
    order = jax.lax.stop_gradient(order)
    pos = jax.lax.stop_gradient(pos)
    kept = jnp.arange(cap_lanes) < n_alive
    dropped = jnp.maximum(n_alive - cap_lanes, 0).astype(jnp.float32)
    # permute_take == x[order] in the forward; its VJP is a gather by the
    # inverse map `pos` instead of the native scatter-add of [cap] cotangents
    # into [n] rows
    return (permute_take(o, order, pos), permute_take(d, order, pos),
            permute_take(thr, order, pos), kept), pix[order], dropped


def bounce_step(scene: Scene, state, opts: RenderOptions, n0: int,
                is_last: bool, count_rays: bool = False, tracer=None,
                pix=None, plan_out: list | None = None):
    """One wavefront bounce: trace + shade + spawn children.

    `state` = (o, d, thr, alive) ray buffers (glass scenes double the buffer
    length per bounce). Returns (terms, new_state, traced_inc): `terms` are
    the per-pixel [n0,3] radiance contributions of this bounce in accumulation
    order; `new_state` is the child wavefront (None when `is_last`);
    `traced_inc` counts live trace lanes. This is the single copy of the
    bounce physics — `render_rays` loops it, and parallel/overlap.py reverses
    it bounce-by-bounce with per-bounce gradient psums.

    `pix` [len(state)] i32 carries each lane's pixel id (compacted-wavefront
    mode, opts.compact_cap): terms fold by scatter-add on `pix` instead of
    lane order, and `new_state` grows a 5th element — the children's pixel
    ids. Identical radiance up to scatter-vs-reshape fp association.
    """
    import os

    o, d, thr, alive = state
    bg = jnp.asarray(opts.background, jnp.float32)
    # `active=alive` lets walk-based tracers (grid DDA / BVH) park dead lanes
    # before step 0 instead of walking their zero-normal "reflections" — cuts
    # the while_loop trip count on bounce wavefronts; live lanes bitwise-same.
    # RT_NO_ACTIVE_MASK=1 disables the mask for A/B sweeps (trace-time env
    # read: takes effect per subprocess, not after a same-shape jit cache hit).
    msk = None if os.environ.get("RT_NO_ACTIVE_MASK") == "1" else alive
    # named_scope marks label the XProf/Perfetto trace per stage (SURVEY §5
    # tracing row: per-kernel cost attribution); zero runtime cost after trace
    with jax.named_scope("trace_nearest"):
        if tracer is None:
            hit = nearest_hit(scene, o, d, opts.t_min, opts.tri_chunk,
                              active=msk)
        else:
            hit = tracer.nearest(o, d, opts.t_min, opts.tri_chunk, active=msk)
        # tag the winner-search output as the render "plan": under the
        # save_only_these_names remat policy (opts.remat_policy == "plan")
        # the backward saves these few small arrays and recomputes only the
        # cheap differentiable shading — the walks never rerun in the bwd
        hit = _name_plan(hit)
    occ_out = None
    if plan_out is not None:
        # record this bounce's plan node: the fused-prim winner index
        # (sphere < plane < triangle flattening, −1 = miss — the encoding
        # ops/replay.PlanTracer decodes) + the per-light occlusion bitmask
        # shade_diffuse fills below. This is the wavefront acting as its
        # own training PLANNER for scenes the fused megakernel can't bake
        # (20k-tri meshes): the replay vg then differentiates shading with
        # the walks gone entirely (docs/ARCH.md "Wavefront-planner replay").
        ns, npl = scene.spheres.count, scene.planes.count
        win = jnp.where(
            hit.kind == KIND_SPHERE, hit.idx,
            jnp.where(hit.kind == KIND_PLANE, hit.idx + ns,
                      jnp.where(hit.kind == KIND_TRIANGLE,
                                hit.idx + ns + npl, -1)))
        win = jnp.where(alive, win, -1).astype(jnp.int32)
        occ_out = []
    with jax.named_scope("surface_at"):
        surf = surface_at(scene, o, d, hit, opts.t_min)
    valid = surf.valid & alive
    traced_inc = jnp.zeros((), jnp.float32)
    if count_rays:
        traced_inc = traced_inc + jnp.sum(alive.astype(jnp.float32))

    # Leaves: miss → background
    miss = alive & ~surf.valid
    terms = [_fold(jnp.where(miss[:, None], thr * bg, 0.0), n0, pix)]

    # Leaves: diffuse hit → local Phong (branchless; masked after)
    is_diff = valid & (surf.mtype == DIFFUSE_AND_GLOSSY)
    with jax.named_scope("shade_diffuse"):
        local, _ = shade_diffuse(scene, surf, d, opts.bias, opts.t_min,
                                 opts.tri_chunk, tracer=tracer,
                                 active=None if msk is None else is_diff,
                                 occ_out=occ_out)
    if plan_out is not None:
        plan_out.append((win, occ_out[0] if occ_out else
                         jnp.zeros_like(win)))
    terms.append(_fold(jnp.where(is_diff[:, None], thr * local, 0.0), n0,
                       pix))
    if count_rays:
        traced_inc = traced_inc + jnp.sum(is_diff.astype(jnp.float32)) \
            * scene.lights.count

    # Specular branches
    is_mirror = valid & (surf.mtype == REFLECTION)
    is_glass = valid & (surf.mtype == REFLECTION_AND_REFRACTION)
    spec = is_mirror | is_glass
    kr = geom.fresnel(d, surf.n, surf.ior)

    if is_last:
        # Children would exceed max_depth → each returns background
        # immediately: mirror contributes kr·bg, glass kr·bg + (1−kr)·bg
        # (kr==1 exactly on TIR, so glass always totals 1·bg).
        w = jnp.where(is_mirror, kr, jnp.where(is_glass, 1.0, 0.0))
        terms.append(_fold(thr * w[:, None] * bg, n0, pix))
        return terms, None, traced_inc

    with jax.named_scope("spawn_children"):
        return _spawn(scene, state, surf, spec, is_glass, kr, pix, terms,
                      traced_inc, opts)


def _spawn(scene, state, surf, spec, is_glass, kr, pix, terms, traced_inc,
           opts):
    o, d, thr, alive = state
    rdir = normalize(geom.reflect(d, surf.n))
    rorig = geom.spawn_origin(surf.p, surf.n, rdir, opts.bias)
    thr_r = jnp.where(spec[:, None], thr * kr[:, None], 0.0)
    if scene.has_glass:
        tdir, t_ok = geom.refract(d, surf.n, surf.ior)
        tdir = normalize(tdir, valid=t_ok)
        torig = geom.spawn_origin(surf.p, surf.n, tdir, opts.bias)
        alive_t = is_glass & t_ok
        thr_t = jnp.where(alive_t[:, None], thr * (1.0 - kr[:, None]), 0.0)
        new_state = (jnp.concatenate([rorig, torig]),
                     jnp.concatenate([rdir, tdir]),
                     jnp.concatenate([thr_r, thr_t]),
                     jnp.concatenate([spec, alive_t]))
        if pix is not None:
            new_state = new_state + (jnp.concatenate([pix, pix]),)
    else:
        new_state = (rorig, rdir, thr_r, spec)
        if pix is not None:
            new_state = new_state + (pix,)
    return terms, new_state, traced_inc


class _WideD0Tracer:
    """Serve a PRECOMPUTED depth-0 nearest hit, delegate everything else.

    A full-band-width coherent primary walk can be far cheaper than the
    tile scan's many per-tile walk loops, while full-width shading stages
    are not. The hybrid: render() runs ONE full-width nearest
    walk outside the scan, slices the integer hit per tile, and this tracer
    replays it for the first nearest() call of each tile's bounce loop
    (statically unrolled, so the call order is fixed — the PlanTracer
    cursor pattern). Occlusion and bounce-≥1 walks stay tiled.

    It lost end to end on the accelerator it was first measured on (the
    full-width hit planes ride the scan as sliced xs and break fusion). An
    A/B knob (RT_WIDE_D0, default off) until it is measured on the GPU.
    """

    def __init__(self, inner, hit0):
        self._inner = inner
        self._hit0 = hit0
        self._used = False

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        if not self._used:
            self._used = True
            return self._hit0
        return self._inner.nearest(orig, direc, t_min, tri_chunk,
                                   active=active)

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        return self._inner.occluded(orig, direc, max_t, t_min, tri_chunk,
                                    active=active)


def render_rays(scene: Scene, orig, direc, opts: RenderOptions,
                count_rays: bool = False, tracer=None,
                record_plan: bool = False):
    """Trace a wavefront of primary rays to radiance [N,3] (unclamped).

    `record_plan=True` (non-compacted scenes) additionally returns the
    render plan — per bounce, the fused-prim winner index [N] i32 (−1 miss)
    and the per-light occlusion bitmask [N] i32 — as two tuples appended to
    the return: (radiance, traced, wins, occs). This is the wavefront
    acting as its own training planner (the mesh-scene analog of
    FusedWhitted.render_plan); ops/replay consumes it.

    `tracer` overrides the winner-search backend (parallel/tracer.py: sharded,
    ring-streaming, or Pallas); the differentiable surface/shade stages always
    use the full `scene`. Returns (radiance, rays_traced) where rays_traced
    counts every live trace lane (primary + secondary + shadow) — the rays/s
    numerator. With opts.compact_cap set on a glass scene, returns
    (radiance, rays_traced, dropped) — `dropped` counts alive lanes lost to
    the cap (0 ⇒ radiance exact up to fold fp association).
    """
    scene = _types_as_jax(scene)
    if tracer is not None and getattr(tracer, "per_trace_cursor", False):
        # depth-aware tracers (accel.cull.CullTracer) map their call counter
        # to bounce depths; a fresh counter per trace keeps the mapping right
        # across scan-body traces AND remat recompute traces
        tracer = tracer.fresh()
    n0 = orig.shape[0]
    radiance = jnp.zeros((n0, 3), jnp.float32)
    state = (orig, direc, jnp.ones((n0, 3), jnp.float32),
             jnp.ones((n0,), bool))
    traced = jnp.zeros((), jnp.float32)
    # compacted-wavefront mode: cap buffers at compact_cap·n0 lanes per bounce
    # (glass scenes double per bounce; fractional caps shrink single-child
    # wavefronts too). Measured config3 d4: 31× n0 lane work at 5.5%
    # occupancy without it (benchmarks/occupancy.py).
    compact = use_compact(scene, opts)
    assert not (record_plan and compact), \
        "plan recording covers non-compacted wavefronts (mesh scenes)"
    plan = [] if record_plan else None
    # pix (per-lane pixel ids) stays None until the FIRST actual compaction:
    # before any permutation, slot i's pixel is i mod n0 (glass doubling
    # concatenates children), so terms fold by reshape — a full-width
    # scatter-add on an identity pix at bounce 0 would cost more than the
    # frame's real compaction work
    pix = None
    dropped = jnp.zeros((), jnp.float32)

    # RT_SKIP_DEAD_TILES=1 (default OFF): bounce rounds ≥1 under lax.cond on
    # "any lane alive", skipping the whole trace+shade+spawn body for
    # all-dead tiles. Exact to 1 ulp; it lost on the accelerator it was
    # first measured on (per-tile conds inside the scan body break fusion).
    # An A/B knob until it is measured on the GPU.
    # Stateful-cursor tracers (PlanTracer replay) must opt out regardless:
    # the eval_shape + cond double-trace would advance their cursors twice.
    skip_dead = (os.environ.get("RT_SKIP_DEAD_TILES", "0") not in ("", "0")
                 and not getattr(tracer, "stateful_cursor", False)
                 and plan is None)  # cond double-trace would double-record

    for depth in range(opts.max_depth + 1):
        with jax.named_scope(f"bounce{depth}"):
            step_fn = partial(
                bounce_step, opts=opts, n0=n0,
                is_last=depth == opts.max_depth, count_rays=count_rays,
                tracer=tracer, plan_out=plan)

            if depth == 0 or not skip_dead:
                terms, state, inc = step_fn(scene, state, pix=pix)
            else:
                def live_branch(scene, state, pix):
                    return step_fn(scene, state, pix=pix)

                shapes = jax.eval_shape(live_branch, scene, state, pix)

                def dead_branch(scene, state, pix):
                    # all-dead wavefront: every term/count is exactly zero
                    # (bounce_step masks by alive everywhere) — emit zeros
                    # without running the body
                    return jax.tree.map(
                        lambda s: jnp.zeros(s.shape, s.dtype), shapes)

                terms, state, inc = jax.lax.cond(
                    jnp.any(state[3]), live_branch, dead_branch, scene,
                    state, pix)
        for t in terms:
            radiance = radiance + t
        traced = traced + inc
        if compact and state is not None:
            if pix is not None:
                *state, pix = state
            cap = _cap_lanes(opts.compact_cap, n0)
            if state[0].shape[0] > cap:
                if pix is None:
                    # lane j's pixel is j mod n0 until the first permutation
                    pix = jnp.arange(state[0].shape[0], dtype=jnp.int32) % n0
                with jax.named_scope("compact_wavefront"):
                    state, pix, drop = _compact(tuple(state), pix, cap)
            else:
                drop = 0.0
            dropped = dropped + drop

    if compact:
        return radiance, traced, dropped
    if record_plan:
        return (radiance, traced, tuple(w for w, _ in plan),
                tuple(o for _, o in plan))
    return radiance, traced


def render(scene: Scene, camera: Camera, opts: RenderOptions,
           count_rays: bool = False, tracer=None, row0: int = 0,
           rows: int | None = None, record_plan: bool = False):
    """Render → (image [rows,W,3] in [0,1], rays_traced scalar).

    `record_plan=True` (non-compacted scenes) appends the band's render
    plan to the return — per bounce, the fused-prim winner index and the
    per-light occlusion bitmask, each [rows·W] in PIXEL order (block tile
    order is unpermuted like the radiance): (img, traced, wins, occs).
    See render_rays; the wavefront-planner replay trainer consumes it.

    Tiles the pixel stream into `opts.tile_rays`-ray wavefronts processed
    sequentially under `lax.scan` (bounded device memory at any resolution).
    `tracer` plugs in an alternate winner-search backend (accel.GridTracer,
    parallel tracers, Pallas) — build it outside jit from the concrete scene.
    `row0`/`rows` render a horizontal band of the full-image projection
    (band-split rendering / gradient microbatching); defaults = full image.
    With opts.compact_cap set on a glass scene returns (image, rays_traced,
    dropped) — see render_rays; callers check dropped == 0 post-hoc.
    """
    h, w = opts.height, opts.width
    rows = h if rows is None else rows
    n_pix = rows * w
    with jax.named_scope("raygen"):
        dirs = geom.raygen(camera.pos, camera.c2w, camera.fov_deg, w, h,
                           row0=row0, rows=rows)
    tile = min(opts.tile_rays, _ceil_to(n_pix, 8))
    compact = use_compact(scene, opts)
    # block order engages only when the block matches the tile exactly —
    # callers that override tile_rays without re-deriving a block shape
    # (tests, band sweeps) silently fall back to flat tiles (identical
    # images either way; block order is a perf layout, not semantics)
    block = (opts.tile_block if opts.tile_block is not None and not compact
             and n_pix > tile
             and opts.tile_block[0] * opts.tile_block[1] == tile else None)
    inv_order = None
    if block is not None:
        bh, bw = block
        perm, inv = block_perm(rows, w, bh, bw)
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (1, 3))])
        dirs = dirs[jnp.asarray(perm)]
        inv_order = jnp.asarray(inv)
        n_pad = perm.shape[0]
    else:
        n_pad = _ceil_to(n_pix, tile)
        if n_pad != n_pix:
            dirs = jnp.concatenate(
                [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]),
                                        (n_pad - n_pix, 3))])
    strided = compact and n_pad > tile
    if strided:
        # stride-interleaved tiles: slot j of tile k is pixel j·ntiles + k,
        # so every tile samples the frame uniformly. Contiguous tiles would
        # concentrate a specular object into few tiles and blow any
        # fractional compact_cap there even when the FRAME's alive fraction
        # is far below it; striding makes per-tile occupancy ≈ frame
        # occupancy (binomial noise only at wavefront widths). Reassembly
        # transposes back below; radiance values are identical per pixel.
        dirs = dirs.reshape(tile, -1, 3).transpose(1, 0, 2)
    else:
        dirs = dirs.reshape(-1, tile, 3)
    orig = jnp.broadcast_to(jnp.asarray(camera.pos), (tile, 3))

    plan_wins = plan_occs = None
    if dirs.shape[0] == 1:
        # single tile: skip the scan wrapper (simpler graph, faster compile)
        out = render_rays(scene, orig, dirs[0], opts, count_rays,
                          tracer=tracer, record_plan=record_plan)
        rad, traced = out[0], out[1]
        dropped = out[2] if compact else None
        if record_plan:
            plan_wins, plan_occs = out[2], out[3]
    else:
        zero = jnp.zeros((), jnp.float32)
        # wide-d0: hoist the depth-0 nearest walk out of the tile scan and
        # run it ONCE at full band width, replaying the integer hit per tile
        # via _WideD0Tracer. Occlusion/bounce walks and all shading stay
        # tiled.
        wide_d0 = (tracer is not None and not strided
                   and os.environ.get("RT_WIDE_D0", "0") not in ("", "0"))
        hit0_tiles = None
        if wide_d0:
            flat_dirs = dirs.reshape(-1, 3)
            ofull = jnp.broadcast_to(jnp.asarray(camera.pos),
                                     (flat_dirs.shape[0], 3))
            with jax.named_scope("wide_d0_nearest"):
                hit0 = tracer.nearest(ofull, flat_dirs, opts.t_min,
                                      opts.tri_chunk)
            hit0_tiles = jax.tree.map(
                lambda x: x.reshape(dirs.shape[0], -1), hit0)

        assert not (record_plan and wide_d0)

        def tile_fn(carry, xs):
            if hit0_tiles is None:
                tile_dirs, tr2 = xs, tracer
            else:
                tile_dirs, h0 = xs
                tr2 = _WideD0Tracer(tracer, h0)
            out = render_rays(scene, orig, tile_dirs, opts, count_rays,
                              tracer=tr2, record_plan=record_plan)
            if compact:
                return (carry[0] + out[1], carry[1] + out[2]), out[0]
            if record_plan:
                return carry + out[1], (out[0], out[2], out[3])
            return carry + out[1], out[0]

        if opts.remat_tiles:
            # recompute each tile's forward during backward instead of saving
            # per-tile/per-bounce residuals (HBM: trade FLOPs for memory —
            # backward at 1080p OOMs otherwise). The "plan" policy keeps the
            # walk outputs as residuals (see _name_plan) so only shading is
            # recomputed; "full" is the classic recompute-everything remat.
            if opts.remat_policy == "plan":
                tile_fn = jax.checkpoint(
                    tile_fn,
                    policy=jax.checkpoint_policies.save_only_these_names(
                        "trace_plan"))
            else:
                tile_fn = jax.checkpoint(tile_fn)
        carry0 = (zero, zero) if compact else zero
        xs = dirs if hit0_tiles is None else (dirs, hit0_tiles)
        carry, ys = jax.lax.scan(tile_fn, carry0, xs)
        traced, dropped = carry if compact else (carry, None)
        if record_plan:
            rad, plan_wins, plan_occs = ys
        else:
            rad = ys
        if strided:
            rad = rad.transpose(1, 0, 2)  # [tile, ntiles, 3] → pixel order
    rad = rad.reshape(-1, 3)
    if inv_order is not None:
        rad = rad[inv_order]  # block order → pixel order (static gather)
    img = clamp01(rad[:n_pix]).reshape(rows, w, 3)
    if record_plan:
        def _pixel_order(x):  # [ntiles, tile] (or [tile]) → [n_pix]
            x = x.reshape(-1)
            if inv_order is not None:
                x = x[inv_order]
            return x[:n_pix]

        plan_wins = tuple(_pixel_order(x) for x in plan_wins)
        plan_occs = tuple(_pixel_order(x) for x in plan_occs)
        return img, traced, plan_wins, plan_occs
    if compact:
        return img, traced, dropped
    return img, traced


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def block_perm(rows: int, width: int, bh: int, bw: int):
    """Screen-block tile permutation → (perm [n_pad], inv [rows·width]) np.

    perm[i] = source pixel of permuted lane i (row-major within bh×bw
    blocks, blocks row-major over a ceil-padded block grid); out-of-frame
    lanes point at index rows·width (the appended dummy dir). inv gathers
    the scan's flat radiance back to pixel order: rad_px = rad_flat[inv].
    Shared by renderer.render and accel.cull.cull_audit so the audit's
    per-tile counts are the render's per-tile counts."""
    import numpy as np

    brows, bcols = -(-rows // bh), -(-width // bw)
    r = (np.arange(brows)[:, None] * bh
         + np.arange(bh)[None, :])                       # [brows, bh]
    c = (np.arange(bcols)[:, None] * bw
         + np.arange(bw)[None, :])                       # [bcols, bw]
    rr = r[:, None, :, None]
    cc = c[None, :, None, :]
    perm = np.where((rr < rows) & (cc < width), rr * width + cc,
                    rows * width).reshape(-1).astype(np.int32)
    valid = perm < rows * width
    inv = np.empty((rows * width,), np.int32)
    inv[perm[valid]] = np.arange(perm.shape[0], dtype=np.int32)[valid]
    return perm, inv


@partial(jax.jit, static_argnames=("opts", "rows", "count_rays"))
def _band_jit(scene, camera, tracer, row0, *, opts, rows, count_rays):
    # row0 is a traced scalar: every band of the same height shares ONE
    # compiled program (raygen supports traced row0, bitwise-identical)
    return render(scene, camera, opts, count_rays=count_rays, tracer=tracer,
                  row0=row0, rows=rows)


def _auto_band_rows(scene: Scene, opts: RenderOptions) -> int:
    """Rows per band program: whole frame unless the scene has a mesh, whose
    grid/BVH programs are split into bands of ~2.4M pixel×(depth+1) units
    (band-splitting happens OUTSIDE jit). The split was made for another
    accelerator's program-size fault; on the GPU it is extra dispatches
    (ROADMAP)."""
    if not scene.meshes.count:
        return opts.height
    budget_px = max(1, 2_400_000 // (opts.max_depth + 1))
    n_bands = -(-opts.width * opts.height // budget_px)
    # near-even split: usually every band (incl. the last) shares one height
    # → one compiled program for the whole frame
    return max(1, min(opts.height, -(-opts.height // n_bands)))


def render_banded(scene: Scene, camera: Camera, opts: RenderOptions,
                  tracer=None, count_rays: bool = False,
                  band_rows: int | None = None):
    """Full-frame render as a sequence of horizontal band programs.

    Same output as `render` (bands are bitwise-identical slices of the full
    frame), but each band is its own jitted XLA program, which bounds a
    grid-traced mesh program's size at any resolution. Bands of equal
    height share one compiled program, so the whole frame costs ≤2
    compiles.
    """
    band_rows = _auto_band_rows(scene, opts) if band_rows is None else \
        min(band_rows, opts.height)
    compact = use_compact(scene, opts)
    imgs, traced = [], jnp.zeros((), jnp.float32)
    dropped = jnp.zeros((), jnp.float32)
    for r0 in range(0, opts.height, band_rows):
        rb = min(band_rows, opts.height - r0)
        out = _band_jit(scene, camera, tracer, r0, opts=opts, rows=rb,
                        count_rays=count_rays)
        imgs.append(out[0])
        traced = traced + out[1]
        if compact:
            dropped = dropped + out[2]
    img = imgs[0] if len(imgs) == 1 else jnp.concatenate(imgs, axis=0)
    if compact:
        return img, traced, dropped
    return img, traced


def render_ssaa(scene: Scene, camera: Camera, opts: RenderOptions,
                factor: int = 2, tracer=None, count_rays: bool = False,
                band_rows: int | None = None):
    """Supersampled render → (image [H,W,3], rays_traced): trace a factor×
    frame through the same projection and box-average factor² subsamples per
    pixel.

    Genre-standard AA post-step (the reference genre's optional
    "anti-aliasing" assignment stage); averaging happens after the [0,1]
    clamp, like accumulating clamped castRay results into a big framebuffer.

    Mesh scenes auto-split the factor× frame into horizontal bands (one jit
    program each), as `_auto_band_rows` does. `band_rows`
    overrides the base-image rows per band (None = auto; whole frame for
    mesh-free scenes).
    """
    assert factor >= 1
    import dataclasses as _dc
    hi = _dc.replace(opts, width=opts.width * factor,
                     height=opts.height * factor)
    if band_rows is None:
        if scene.meshes.count:
            budget = 2_400_000 // (opts.max_depth + 1)      # hi-res pixels
            band_rows = max(1, budget // (hi.width * factor))
        else:
            band_rows = opts.height
    band_rows = min(band_rows, opts.height)
    compact = use_compact(scene, opts)
    imgs, traced = [], jnp.zeros((), jnp.float32)
    dropped = jnp.zeros((), jnp.float32)
    for r0 in range(0, opts.height, band_rows):
        rb = min(band_rows, opts.height - r0)
        out = _band_jit(scene, camera, tracer, r0 * factor, opts=hi,
                        rows=rb * factor, count_rays=count_rays)
        imgs.append(out[0].reshape(rb, factor, opts.width, factor, 3)
                    .mean(axis=(1, 3)))
        traced = traced + out[1]
        if compact:
            dropped = dropped + out[2]
    img = imgs[0] if len(imgs) == 1 else jnp.concatenate(imgs, axis=0)
    if compact:
        return img, traced, dropped
    return img, traced


@partial(jax.jit, static_argnames=("apply_params", "opts", "rows"))
def _band_vg(params, scene, camera, tracer, target, row0, *, apply_params,
             opts, rows):
    def band_loss(p):
        img = render(apply_params(scene, p), camera, opts, tracer=tracer,
                     row0=row0, rows=rows)[0]
        want = jax.lax.dynamic_slice_in_dim(target, row0, rows, 0)
        return jnp.sum((img - want) ** 2) / (opts.width * opts.height * 3)

    return jax.value_and_grad(band_loss)(params)


def value_and_grad_banded(apply_params, params, scene: Scene, camera: Camera,
                          opts: RenderOptions, target, tracer=None,
                          band_rows: int | None = None):
    """Pixel-L2 inverse-rendering loss + grads as per-band microbatches.

    loss(params) = Σ_px (render(apply_params(scene, params)) − target)²
                   / (H·W·3),
    evaluated band-by-band: each band is its own value_and_grad XLA program
    (grads summed across bands), which bounds grid/BVH mesh programs in the
    BACKWARD pass too — the gradient analog of `render_banded`. Bands of one height share one compiled
    program (traced row0). Mesh-free scenes default to a single band, where
    this equals plain `jax.value_and_grad` up to band-sum association.

    `apply_params(scene, params) -> Scene` grafts the optimized parameters
    into the scene (kept explicit so grads have the params' structure).
    """
    band_rows = _auto_band_rows(scene, opts) if band_rows is None else \
        min(band_rows, opts.height)
    val, grads = None, None
    for r0 in range(0, opts.height, band_rows):
        rb = min(band_rows, opts.height - r0)
        v, g = _band_vg(params, scene, camera, tracer, target, r0,
                        apply_params=apply_params, opts=opts, rows=rb)
        val = v if val is None else val + v
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return val, grads


def render_image(scene: Scene, camera: Camera, opts: RenderOptions):
    """Convenience: jitted image-only render."""
    return _render_jit(scene, camera, opts)[0]


@partial(jax.jit, static_argnums=2)
def _render_jit(scene, camera, opts):
    return render(scene, camera, opts)
