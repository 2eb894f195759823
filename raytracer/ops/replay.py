"""Plan replay: differentiate shading against a recorded winner-search plan.

The training step's backward never needs the winner SEARCH — only its
integer outputs (the architecture's stop-gradient residuals, ops/trace.py).
`FusedWhitted.render_plan` produces those outputs at serving-forward speed
for non-glass scenes; `PlanTracer` feeds them back through the unchanged
wavefront `bounce_step` loop, so `jax.value_and_grad` over a replay render
differentiates ONLY the cheap shading recompute. This is the fused
megakernel acting as the training planner, generalizing the plan-saving remat policy (docs/ARCH.md): instead
of saving the plan from a wavefront primal, the plan comes from the fused
kernel and the wavefront primal is never run at all.

Correctness standard: the fused winner ids agree with the wavefront search
everywhere except knife-edge candidates within fp-association noise (the
cross-backend standard, tests/test_fused.py), so replay(plan) matches the
wavefront render to the same tolerance — and gradients (probed away from
edges, SURVEY §4.3) match the plain path.
"""

import functools

import jax
import jax.numpy as jnp

from raytracer.core.types import (
    KIND_NONE, KIND_PLANE, KIND_SPHERE, KIND_TRIANGLE)
from raytracer.ops.trace import Hit


class PlanTracer:
    """Replays a recorded plan through the tracer interface.

    Built per band from `FusedWhitted.render_plan` outputs flattened to the
    band's ray order ([N] per bounce). Stateful cursors sequence the calls:
    the wavefront loop is statically unrolled, calling `nearest` once per
    bounce and `occluded` once per light within that bounce — the same
    fixed order the fused kernel wrote the planes in.
    """

    # renderer.render_rays must not wrap bounces of a cursor tracer in
    # lax.cond (eval_shape + branch tracing would advance cursors twice)
    stateful_cursor = True

    def __init__(self, wins, occs, n_spheres: int, n_planes: int):
        self._wins = [jnp.asarray(w).reshape(-1) for w in wins]
        self._occs = [jnp.asarray(o).reshape(-1) for o in occs]
        self._ns = int(n_spheres)
        self._np = int(n_planes)
        self._bounce = -1
        self._light = 0

    @staticmethod
    def for_plan(plan, n_spheres: int, n_planes: int, max_depth: int = None,
                 glass: bool = False):
        """Build from a (win_planes, occ_planes) pair whose planes already
        cover exactly the rays about to be traced (band-local).

        Glass plans carry one plane per recursion NODE, ordered by
        (bounce, path-prefix p); the uncompacted wavefront's bounce-b buffer
        is exactly the p-ordered concatenation of that bounce's 2^b node
        planes (child slot = c·2^b·n + parent slot under the
        [reflect | refract] concat), so concatenate them here."""
        wins, occs = plan
        if not glass:
            return PlanTracer(list(wins), list(occs), n_spheres, n_planes)
        bw, bo, off = [], [], 0
        for b in range(max_depth + 1):
            k = 1 << b
            bw.append(jnp.concatenate(
                [jnp.asarray(wins[off + p]).reshape(-1) for p in range(k)]))
            bo.append(jnp.concatenate(
                [jnp.asarray(occs[off + p]).reshape(-1) for p in range(k)]))
            off += k
        return PlanTracer(bw, bo, n_spheres, n_planes)

    def _hit_from_win(self, win):
        miss = win < 0
        is_s = ~miss & (win < self._ns)
        is_p = ~miss & ~is_s & (win < self._ns + self._np)
        kind = jnp.where(miss, KIND_NONE,
                         jnp.where(is_s, KIND_SPHERE,
                                   jnp.where(is_p, KIND_PLANE,
                                             KIND_TRIANGLE)))
        idx = jnp.where(is_s, win,
                        jnp.where(is_p, win - self._ns,
                                  jnp.maximum(win - self._ns - self._np, 0)))
        # t is never read on the replay path (surface_at recomputes it);
        # keep the miss/hit split so any defensive `t < inf` check agrees
        t = jnp.where(miss, jnp.inf, 1.0)
        return Hit(kind=kind.astype(jnp.int32), idx=idx.astype(jnp.int32),
                   t=t.astype(jnp.float32))

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        self._bounce += 1
        self._light = 0
        assert self._bounce < len(self._wins), \
            "replay exhausted: more nearest() calls than plan bounces"
        win = self._wins[self._bounce]
        assert win.shape[0] == orig.shape[0], \
            f"plan width {win.shape[0]} != wavefront width {orig.shape[0]} " \
            "(replay requires single-tile rendering: opts.tile_rays >= band)"
        return self._hit_from_win(win)

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        li = self._light
        self._light += 1
        occ = self._occs[self._bounce]
        assert occ.shape[0] == orig.shape[0]
        return ((occ >> li) & 1).astype(bool)


def _prim_flags(scene):
    """Bool tables over the FUSED prim index (sphere<plane<tri):
    (is_spec, is_glass) — which winner ids spawn reflect / refract children.
    Used to derive the compaction permutation from a plan alone. Traceable
    (runs inside the jitted band program on a traced scene)."""
    from raytracer.core.types import REFLECTION, REFLECTION_AND_REFRACTION

    mt = jnp.asarray(scene.materials.mtype)
    mids = jnp.concatenate([
        jnp.reshape(jnp.asarray(scene.spheres.mat_id, jnp.int32), (-1,)),
        jnp.reshape(jnp.asarray(scene.planes.mat_id, jnp.int32), (-1,)),
        jnp.reshape(jnp.asarray(scene.meshes.mat_id, jnp.int32), (-1,))])
    kinds = mt[mids]
    is_gls = kinds == REFLECTION_AND_REFRACTION
    is_spec = (kinds == REFLECTION) | is_gls
    return jax.lax.stop_gradient(is_spec), jax.lax.stop_gradient(is_gls)


def _partition(alive, cap: int):
    """Stable alive-first permutation prefix (renderer._compact's math):
    → (order [cap], pos [n], kept [cap], dropped). Index-only, stop-grad."""
    n = alive.shape[0]
    ai = alive.astype(jnp.int32)
    n_alive = jnp.sum(ai)
    pos = jnp.where(alive, jnp.cumsum(ai) - 1,
                    n_alive + jnp.cumsum(1 - ai) - 1)
    order = jnp.zeros((n,), jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True)[:cap]
    kept = jnp.arange(cap) < n_alive
    dropped = jnp.maximum(n_alive - cap, 0).astype(jnp.float32)
    return (jax.lax.stop_gradient(order), jax.lax.stop_gradient(pos), kept,
            dropped)


def _plan_compaction(plan, scene, n0: int, max_depth: int, cap: int):
    """Derive the per-bounce compaction schedule from a glass plan ALONE.

    The plan's winner ids fix which lanes spawn children (reflect: any
    specular hit; refract: glass hits — TIR is not in the plan, so refract
    lanes are a SUPERSET of the truly-alive set: safe, they just ride as
    zero-throughput lanes). That makes the whole alive→permutation chain
    computable before the differentiable replay runs: the replay then
    executes at cap-bounded width with precomputed permutations
    (permute_take carries the transpose-gather VJP) and NO dynamic
    partition inside the differentiated graph — the r3-l lever
    (docs/ARCH.md "Fused-plan replay").

    Returns (planes, compacts, dropped):
      planes  — per bounce b: (win [w_b], occ [w_b]) in the COMPACTED lane
                order of that bounce, plus pix [w_b] (carried pixel ids)
      compacts — per bounce b < D: None, or (order, pos, kept) to apply to
                the children of bounce b
    """
    wins, occs = plan
    spec_tab, gls_tab = _prim_flags(scene)
    # concat node planes per bounce in path-prefix order (= uncompacted slot
    # order; see PlanTracer.for_plan)
    wb_all, ob_all, off = [], [], 0
    for b in range(max_depth + 1):
        k = 1 << b
        wb_all.append(jnp.concatenate(
            [jnp.reshape(wins[off + p], (-1,)) for p in range(k)]))
        ob_all.append(jnp.concatenate(
            [jnp.reshape(occs[off + p], (-1,)) for p in range(k)]))
        off += k

    cur_slots = jnp.arange(n0, dtype=jnp.int32)
    cur_alive = jnp.ones((n0,), bool)
    planes, compacts = [], []
    dropped = jnp.zeros((), jnp.float32)
    for b in range(max_depth + 1):
        win_b = wb_all[b][cur_slots]
        occ_b = ob_all[b][cur_slots]
        planes.append((win_b, occ_b, cur_slots % n0))
        if b == max_depth:
            break
        hit = cur_alive & (win_b >= 0)
        wsafe = jnp.maximum(win_b, 0)
        spec = hit & spec_tab[wsafe]
        gls = hit & gls_tab[wsafe]
        w_unc = (1 << b) * n0  # uncompacted width of bounce b
        child_slots = jnp.concatenate([cur_slots, cur_slots + w_unc])
        child_alive = jnp.concatenate([spec, gls])
        if child_slots.shape[0] > cap:
            order, pos, kept, drop = _partition(child_alive, cap)
            cur_slots = child_slots[order]
            cur_alive = child_alive[order] & kept
            compacts.append((order, pos, kept))
            dropped = dropped + drop
        else:
            cur_slots = child_slots
            cur_alive = child_alive
            compacts.append(None)
    return planes, compacts, dropped


def _replay_render_compact(scene, camera, opts, plan, row0: int, rows: int):
    """Glass replay at plan-compacted width (single tile per band).

    → (img, rays_traced≡0, dropped): `dropped` counts plan-alive lanes lost
    to the cap (0 ⇒ exact, same gate as the wavefront compact path)."""
    import dataclasses

    from raytracer import renderer
    from raytracer.ops import geometry as geom
    from raytracer.ops.dgather import permute_take
    from raytracer.ops.safemath import clamp01
    from raytracer.core.types import as_jax

    w = opts.width
    n_pix = rows * w
    tile = min(opts.tile_rays, -(-n_pix // 8) * 8)
    n_pad = -(-n_pix // tile) * tile
    ntiles = n_pad // tile
    cap = renderer._cap_lanes(opts.compact_cap, tile)
    wins = [_pad_plane(x, n_pix, n_pad, -1) for x in plan[0]]
    occs = [_pad_plane(x, n_pix, n_pad, 0) for x in plan[1]]
    opts1 = dataclasses.replace(opts, compact_cap=None)
    scene_j = as_jax(scene)

    dirs = geom.raygen(camera.pos, camera.c2w, camera.fov_deg, w,
                       opts.height, row0=row0, rows=rows)
    if n_pad != n_pix:
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]),
                                    (n_pad - n_pix, 3))])
    orig = jnp.broadcast_to(jnp.asarray(camera.pos), (tile, 3))

    def tile_body(tdirs, win_nodes, occ_nodes):
        """Plan-compacted bounce loop for one tile → (rad [tile,3], drop)."""
        planes, compacts, dropped = _plan_compaction(
            (list(win_nodes), list(occ_nodes)), scene_j, tile,
            opts.max_depth, cap)
        tracer = PlanTracer([p[0] for p in planes], [p[1] for p in planes],
                            scene.spheres.count, scene.planes.count)
        radiance = jnp.zeros((tile, 3), jnp.float32)
        state = (orig, tdirs, jnp.ones((tile, 3), jnp.float32),
                 jnp.ones((tile,), bool))
        pix = None
        for b in range(opts.max_depth + 1):
            terms, state, _ = renderer.bounce_step(
                scene_j, state, opts1, tile, is_last=b == opts.max_depth,
                tracer=tracer, pix=pix)
            for t in terms:
                radiance = radiance + t
            if state is None:
                break
            if pix is not None:
                *state, pix = state
            if compacts[b] is not None:
                order, pos, kept = compacts[b]
                o, d, thr, alive = state
                state = (permute_take(o, order, pos),
                         permute_take(d, order, pos),
                         permute_take(thr, order, pos), alive[order] & kept)
                pix = planes[b + 1][2]
            # (no compaction at this bounce: pix stays as-is — None folds by
            # reshape; uncompacted children keep slot%n0 == parent's pixel)
        return radiance, dropped

    if ntiles == 1:
        radiance, dropped = tile_body(dirs, wins, occs)
        img = clamp01(radiance[:n_pix]).reshape(rows, w, 3)
        return img, jnp.zeros((), jnp.float32), dropped

    # STRIDED tiles, exactly as the compacted wavefront renderer: slot j of
    # tile k is band slot j·ntiles + k, so every tile samples the band
    # uniformly and per-tile plan-alive counts track the band occupancy
    # (renderer.render's strided-compact argument). Each tile derives its
    # own compaction chain from its plan slice inside the scan.
    dirs_x = dirs.reshape(tile, ntiles, 3).transpose(1, 0, 2)
    wins_x = jnp.stack([x.reshape(tile, ntiles).T for x in wins], axis=1)
    occs_x = jnp.stack([x.reshape(tile, ntiles).T for x in occs], axis=1)

    def tile_fn(carry, xs):
        tdirs, w_sl, o_sl = xs
        rad, drop = tile_body(tdirs, w_sl, o_sl)
        return carry + drop, rad

    if opts.remat_tiles:
        if opts.remat_policy == "plan":
            tile_fn = jax.checkpoint(
                tile_fn, policy=jax.checkpoint_policies.save_only_these_names(
                    "trace_plan"))
        else:
            tile_fn = jax.checkpoint(tile_fn)
    dropped, rad = jax.lax.scan(tile_fn, jnp.zeros((), jnp.float32),
                                (dirs_x, wins_x, occs_x))
    rad = rad.transpose(1, 0, 2).reshape(n_pad, 3)
    img = clamp01(rad[:n_pix]).reshape(rows, w, 3)
    return img, jnp.zeros((), jnp.float32), dropped


def _pad_plane(x, n_pix: int, n_pad: int, fill):
    x = jnp.reshape(jnp.asarray(x), (-1,))
    assert x.shape[0] == n_pix, (x.shape, n_pix)
    if n_pad == n_pix:
        return x
    return jnp.concatenate([x, jnp.full((n_pad - n_pix,), fill, x.dtype)])


def replay_render(scene, camera, opts, plan, row0: int = 0,
                  rows: int | None = None, tile_rays: int | None = None):
    """Render a band by replaying `plan` (band-local planes from
    `FusedWhitted.render_plan(row0, rows)`).

    Identical structure to renderer.render but with the winner search
    replaced by the recorded plan. `tile_rays=None` runs the band as one
    tile (plan planes cover the band in ray order); an int tiles the band
    into `tile_rays`-lane wavefronts scanned sequentially — each tile
    replays its contiguous slice of every plan plane. Any two scanned tile
    sizes are bitwise-identical (per-pixel math and fold order are
    lane-local); scan-vs-single-tile differs only by XLA's per-context fp
    association — measured the IDENTICAL pixel set and magnitude as
    renderer.render's own tile-vs-single-tile delta. Tiling bounds the
    replay backward's memory: residual buffers scale with the tile, not the
    band. Pad lanes (band not a tile
    multiple) replay a miss plan (-1/0) and are sliced off — also fixes the
    8-lane-alignment crash when rows·width % 8 != 0.
    """
    import dataclasses

    from raytracer import renderer
    from raytracer.ops import geometry as geom
    from raytracer.ops.safemath import clamp01

    import os

    rows = opts.height - row0 if rows is None else rows
    w, h = opts.width, opts.height
    n_pix = rows * w
    glass = bool(scene.has_glass)
    if (glass and opts.compact_cap is not None
            and os.environ.get("RT_REPLAY_COMPACT", "1") not in ("", "0")):
        # plan-driven compacted glass replay (single tile per band): the
        # plan fixes the permutation chain, so the differentiated graph
        # runs at cap-bounded width with no dynamic partition
        return _replay_render_compact(scene, camera, opts, plan, row0, rows)
    ns, npl = scene.spheres.count, scene.planes.count
    wins, occs = plan
    if tile_rays is None:
        tile = -(-n_pix // 8) * 8
    else:
        tile = min(int(tile_rays), -(-n_pix // 8) * 8)
    n_pad = -(-n_pix // tile) * tile
    # replay runs UNCOMPACTED (plan planes are slot-indexed; glass buffers
    # double per bounce exactly as the plan's node tree); memory is bounded
    # by the tile (or the caller's band size when single-tile)
    opts1 = dataclasses.replace(opts, compact_cap=None, tile_rays=tile)
    wins = [_pad_plane(x, n_pix, n_pad, -1) for x in wins]
    occs = [_pad_plane(x, n_pix, n_pad, 0) for x in occs]

    if n_pad == tile:
        tracer = PlanTracer.for_plan((wins, occs), ns, npl,
                                     max_depth=opts.max_depth, glass=glass)
        out = renderer.render(scene, camera, opts1, tracer=tracer, row0=row0,
                              rows=rows)
        return out

    # tiled replay: scan contiguous tiles of (dirs, plan-plane slices).
    # Tile k's lanes are band slots [k·tile, (k+1)·tile) — the same contiguous
    # split renderer.render uses for non-compacted scenes — so each node
    # plane slices to [ntiles, tile] and rides the scan as xs.
    scene_j = scene  # render_rays converts; keep host numpy until then
    dirs = geom.raygen(camera.pos, camera.c2w, camera.fov_deg, w, h,
                       row0=row0, rows=rows)
    if n_pad != n_pix:
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]),
                                    (n_pad - n_pix, 3))])
    dirs = dirs.reshape(-1, tile, 3)
    orig = jnp.broadcast_to(jnp.asarray(camera.pos), (tile, 3))
    wins_x = jnp.stack([x.reshape(-1, tile) for x in wins], axis=1)
    occs_x = jnp.stack([x.reshape(-1, tile) for x in occs], axis=1)

    def tile_fn(carry, xs):
        tdirs, w_sl, o_sl = xs
        tracer = PlanTracer.for_plan((list(w_sl), list(o_sl)), ns, npl,
                                     max_depth=opts.max_depth, glass=glass)
        rad, traced = renderer.render_rays(scene_j, orig, tdirs, opts1,
                                           tracer=tracer)
        return carry + traced, rad

    if opts.remat_tiles:
        if opts.remat_policy == "plan":
            tile_fn = jax.checkpoint(
                tile_fn, policy=jax.checkpoint_policies.save_only_these_names(
                    "trace_plan"))
        else:
            tile_fn = jax.checkpoint(tile_fn)
    traced, rad = jax.lax.scan(tile_fn, jnp.zeros((), jnp.float32),
                               (dirs, wins_x, occs_x))
    img = clamp01(rad.reshape(-1, 3)[:n_pix]).reshape(rows, w, 3)
    return img, traced


@functools.partial(jax.jit,
                   static_argnames=("apply_params", "opts", "rb", "tile"))
def _replay_band_vg(params, scene, camera, target, plan, r0, *,
                    apply_params, opts, rb, tile=None):
    # traced r0: bands of one height share a single compiled program, as in
    # renderer._band_vg
    def band_loss(p):
        s = apply_params(scene, p)
        img = replay_render(s, camera, opts, plan, row0=r0, rows=rb,
                            tile_rays=tile)[0]
        want = jax.lax.dynamic_slice_in_dim(target, r0, rb, 0)
        return jnp.sum((img - want) ** 2) / (opts.width * opts.height * 3)

    return jax.value_and_grad(band_loss)(params)


def value_and_grad_replay(apply_params, params, scene, camera, opts, target,
                          fused_builder, band_rows: int | None = None,
                          tile_rays: int | None = None):
    """Pixel-L2 loss + grads via fused-plan replay (non-glass scenes).

    Per band: (1) `fused_builder(params)` → a FusedWhitted whose
    `render_plan` emits the band's plan under stop_gradient (fast serving
    forward, no wavefront primal); (2) `jax.value_and_grad` over the
    replay render — the differentiated graph contains ONLY the shading
    recompute. Matches renderer.value_and_grad_banded up to the fused-vs-
    wavefront knife-edge id class.

    `fused_builder(params) -> FusedWhitted` should return a CACHED
    param_inputs=True kernel with the current params bound (e.g.
    `lambda p: fused.bind(center=p["center"], albedo=p["albedo"])`) —
    plans then refresh per step with no recompile. A builder that BAKES
    params recompiles every step. Band programs are jit-cached per
    (opts, r0, rb) like renderer._band_vg. `tile_rays` tiles each band's
    replay (None = single-tile; see replay_render).
    """
    band_rows = opts.height if band_rows is None else band_rows
    fused = fused_builder(params)
    val, grads = None, None
    for r0 in range(0, opts.height, band_rows):
        rb = min(band_rows, opts.height - r0)
        out = fused.render_plan(row0=r0, rows=rb)
        plan = jax.lax.stop_gradient((out[1], out[2]))
        v, g = _replay_band_vg(params, scene, camera, target, plan, r0,
                               apply_params=apply_params, opts=opts, rb=rb,
                               tile=tile_rays)
        val = v if val is None else val + v
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return val, grads
