"""Per-ray-tile primitive culling + dense culled-list sweep (SURVEY §7.3.1).

Reference analog: the accel structure's job — cutting the per-ray candidate
set (SURVEY.md §2.2 "Accel grid/BVH") — done densely: instead of a
per-ray DDA walk (iteration-latency-bound: every while-iteration pays the
gather machinery), cull ONCE PER RAY TILE and evaluate the survivors
densely with broadcast Möller–Trumbore:

  1. clip every ray of the tile to the mesh AABB (slab test — the same math
     as `grid.walk_init`), take the union AABB of the clipped segments;
  2. overlap-test all T triangle AABBs against that tile AABB ([T] ops);
  3. compact the surviving ids to a fixed `cap`-slot list — scatter-free:
     searchsorted over the mask cumsum (no scatter at wavefront widths;
     the [cap,T] compare_all reduce is elementwise);
  4. evaluate `cap` candidates in unrolled `chunk`-wide blocks of
     `geom.triangle_hits` — the gather is per-TILE ([chunk,9] SoA rows
     shared by all lanes), not per-ray like the walk's [N,C] candidate rows.

Exactness: any triangle a tile ray can hit lies inside the mesh AABB, so its
hit point is on the ray's clipped segment, inside the tile AABB, and inside
the triangle's own AABB — the culled list is a superset of every possible
winner. Dense min-fold over a superset == brute nearest == the walk's result
(same `triangle_hits` broadcast fp as ops/trace.py's scan path, same lowest-
id tie rule), EXCEPT when the list overflows `cap`: overflowing ids are
dropped and the render is wrong. Overflow is therefore gated like the glass
compact cap: `cull_audit` recomputes the exact per-tile counts outside the
render (bench gates max_count <= cap post-timing; tests pin it in CI).

Scope: by default only depth-0 calls are culled (`cull_depths=(0,)`) — the
d0 nearest + d0 shadow walks are most of the config4 work, and their counts are auditable without replaying the whole wavefront;
bounce rounds delegate to the wrapped inner tracer (grid DDA). The
per-trace call cursor that assigns depths is reset by renderer.render_rays
via the `per_trace_cursor` protocol (fresh() per trace, remat-safe).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import geometry as geom

INF = jnp.inf


@dataclasses.dataclass
class CullData:
    """Device tensors for the per-tile cull + dense sweep."""

    soa: jax.Array      # [T+1, 9] f32 v0|e1|e2 rows; sentinel degenerate at T
    tri_lo: jax.Array   # [T, 3] f32 per-triangle AABB min
    tri_hi: jax.Array   # [T, 3] f32 per-triangle AABB max
    bmin: jax.Array     # [3] f32 mesh AABB min (padded)
    bmax: jax.Array     # [3] f32 mesh AABB max (padded)
    n_tris: int         # static T (sentinel id)
    cap: int            # static culled-list capacity
    chunk: int          # static dense-eval block width


jax.tree_util.register_dataclass(
    CullData,
    data_fields=["soa", "tri_lo", "tri_hi", "bmin", "bmax"],
    meta_fields=["n_tris", "cap", "chunk"])


def build_cull(scene, cap: int | None = None,
               chunk: int | None = None) -> CullData:
    """Host build from a concrete scene (not traceable)."""
    if cap is None:
        cap = int(os.environ.get("RT_CULL_CAP", 1024))
    if chunk is None:
        chunk = int(os.environ.get("RT_CULL_CHUNK", 128))
    cap = -(-cap // chunk) * chunk  # whole chunks
    v0, e1, e2 = (np.asarray(a, np.float32) for a in scene.meshes.tri_soa())
    t = v0.shape[0]
    assert t > 0, "cull over empty mesh"
    v1, v2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    bmin = lo.min(axis=0)
    bmax = hi.max(axis=0)
    pad = 1e-4 * float(np.linalg.norm(bmax - bmin)) + 1e-6
    soa = np.concatenate([v0, e1, e2], axis=1)          # [T, 9]
    soa = np.concatenate([soa, np.zeros((1, 9), np.float32)])  # sentinel
    return CullData(
        soa=jnp.asarray(soa), tri_lo=jnp.asarray(lo), tri_hi=jnp.asarray(hi),
        bmin=jnp.asarray(bmin - pad), bmax=jnp.asarray(bmax + pad),
        n_tris=t, cap=cap, chunk=chunk)


def _segments(cd: CullData, orig, direc, t_min, max_t=None, active=None):
    """Clip rays to the mesh AABB → (seg_lo, seg_hi [N,3], inside [N]).

    `max_t` (occlusion) additionally clips at the light distance. Inactive /
    non-intersecting lanes return inside=False (excluded from the tile AABB
    and forced to miss by the caller)."""
    inv_d = jnp.where(jnp.abs(direc) > 1e-12, 1.0 / direc, 1e12)
    t0 = (cd.bmin[None, :] - orig) * inv_d
    t1 = (cd.bmax[None, :] - orig) * inv_d
    tlo = jnp.maximum(jnp.minimum(t0, t1).max(axis=1), 0.0)
    thi = jnp.maximum(t0, t1).min(axis=1)
    if max_t is not None:
        thi = jnp.minimum(thi, max_t)
    inside = (thi >= tlo) & (thi > t_min)
    if active is not None:
        inside &= jax.lax.stop_gradient(active)
    # small t-pad absorbs slab fp slop (hits exactly on the AABB boundary)
    eps = 1e-4 * (thi - tlo) + 1e-5
    p0 = orig + (tlo - eps)[:, None] * direc
    p1 = orig + (thi + eps)[:, None] * direc
    return jnp.minimum(p0, p1), jnp.maximum(p0, p1), inside


def tile_ids(cd: CullData, seg_lo, seg_hi, inside):
    """Union-AABB cull + scatter-free compaction → (ids [cap] i32, count).

    ids are ascending triangle indices; empty slots hold the sentinel T
    (degenerate always-miss row in `soa`). `count` is the TRUE number of
    survivors — count > cap means the list overflowed (render invalid; the
    audit/gate exists to keep shipping configs away from this)."""
    big = jnp.float32(3.4e38)
    tlo = jnp.where(inside[:, None], seg_lo, big).min(axis=0)     # [3]
    thi = jnp.where(inside[:, None], seg_hi, -big).max(axis=0)
    overlap = (jnp.all(cd.tri_lo <= thi[None, :], axis=1)
               & jnp.all(cd.tri_hi >= tlo[None, :], axis=1))      # [T]
    cs = jnp.cumsum(overlap.astype(jnp.int32))
    count = cs[-1]
    # c-th survivor = first index with cumsum == c+1; queries past `count`
    # return T (searchsorted's past-the-end) — exactly the sentinel id
    q = jnp.arange(1, cd.cap + 1, dtype=cs.dtype)
    ids = jnp.searchsorted(cs, q, method="compare_all").astype(jnp.int32)
    return ids, count


def _dense_nearest(cd: CullData, orig, direc, t_min, ids, inside):
    """Unrolled chunked broadcast-MT min-fold → (best_t, best_i) [N]."""
    n = orig.shape[0]
    best_t = jnp.full((n,), INF, jnp.float32)
    best_i = jnp.full((n,), cd.n_tris, jnp.int32)
    for k in range(cd.cap // cd.chunk):
        idc = jax.lax.dynamic_slice_in_dim(ids, k * cd.chunk, cd.chunk)
        s = cd.soa[idc]                                  # [chunk, 9] per TILE
        ts, _, _ = geom.triangle_hits(orig, direc, s[:, 0:3], s[:, 3:6],
                                      s[:, 6:9], t_min)
        ts = jnp.where(inside[:, None], ts, INF)
        tc = jnp.min(ts, axis=1)
        # lowest id among the t-minima (SPEC tie order), like the grid walk
        ic = jnp.min(jnp.where(ts <= tc[:, None], idc[None, :], cd.n_tris),
                     axis=1)
        better = (tc < best_t) | ((tc == best_t) & (ic < best_i))
        best_t = jnp.where(better, tc, best_t)
        best_i = jnp.where(better, ic, best_i)
    return best_t, best_i


def _dense_occluded(cd: CullData, orig, direc, t_min, max_t, ids, inside):
    n = orig.shape[0]
    occ = jnp.zeros((n,), bool)
    for k in range(cd.cap // cd.chunk):
        idc = jax.lax.dynamic_slice_in_dim(ids, k * cd.chunk, cd.chunk)
        s = cd.soa[idc]
        ts, _, _ = geom.triangle_hits(orig, direc, s[:, 0:3], s[:, 3:6],
                                      s[:, 6:9], t_min)
        occ |= jnp.any((ts < max_t[:, None]) & inside[:, None], axis=1)
    return occ


class CullTracer:
    """Drop-in tracer: tile-culled dense triangle sweep at chosen depths,
    inner tracer (grid DDA by default) everywhere else.

    Protocol: `per_trace_cursor` — renderer.render_rays calls fresh() once
    per trace so the call counter maps calls to bounce depths (the bounce
    loop is statically unrolled; call order per trace is fixed). Remat
    recompute re-traces render_rays → fresh cursor → same mapping.
    """

    per_trace_cursor = True
    stateful_cursor = True  # opt out of RT_SKIP_DEAD_TILES double-trace

    def __init__(self, scene, inner=None, cap: int | None = None,
                 chunk: int | None = None, cull_depths=None,
                 cull_occl: bool | None = None, cull_data=None):
        from raytracer.core.types import as_jax

        self._scene = as_jax(scene)
        if inner is None:
            from raytracer.accel.grid import GridTracer

            inner = GridTracer.build(scene)
        self._inner = inner
        self._cd = (jax.lax.stop_gradient(build_cull(scene, cap, chunk))
                    if cull_data is None else cull_data)
        if cull_depths is None:
            cull_depths = tuple(
                int(x) for x in
                os.environ.get("RT_CULL_DEPTHS", "0").split(",") if x != "")
        self._depths = tuple(cull_depths)
        if cull_occl is None:
            cull_occl = os.environ.get("RT_CULL_OCCL", "1") not in ("", "0")
        self._occl = cull_occl
        self._n_nearest = 0  # per-trace call cursor (reset by fresh())

    @staticmethod
    def build(scene, **kw):
        return CullTracer(scene, **kw)

    def fresh(self):
        obj = CullTracer.__new__(CullTracer)
        obj.__dict__.update(self.__dict__)
        obj._n_nearest = 0
        return obj

    # -- tracer interface --------------------------------------------------
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        depth = self._n_nearest
        self._n_nearest += 1
        if depth not in self._depths:
            return self._inner.nearest(orig, direc, t_min, tri_chunk,
                                       active=active)
        from raytracer.core.types import KIND_TRIANGLE, Meshes
        from raytracer.ops import trace as trace_ops

        orig = jax.lax.stop_gradient(orig)
        direc = jax.lax.stop_gradient(direc)
        base = trace_ops.nearest_hit(
            self._scene.replace(meshes=Meshes.empty()), orig, direc, t_min,
            tri_chunk)
        with jax.named_scope("cull_nearest"):
            seg_lo, seg_hi, inside = _segments(self._cd, orig, direc, t_min,
                                               active=active)
            ids, _ = tile_ids(self._cd, seg_lo, seg_hi, inside)
            tb, ib = _dense_nearest(self._cd, orig, direc, t_min, ids,
                                    inside)
        better = tb < base.t
        return trace_ops.Hit(
            kind=jnp.where(better, KIND_TRIANGLE, base.kind),
            idx=jnp.where(better, ib, base.idx),
            t=jnp.where(better, tb, base.t))

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        depth = self._n_nearest - 1  # occl calls follow their bounce's nearest
        if not self._occl or depth not in self._depths:
            return self._inner.occluded(orig, direc, max_t, t_min, tri_chunk,
                                        active=active)
        from raytracer.core.types import Meshes
        from raytracer.ops import trace as trace_ops

        orig = jax.lax.stop_gradient(orig)
        direc = jax.lax.stop_gradient(direc)
        max_t = jax.lax.stop_gradient(max_t)
        occ = trace_ops.occluded(self._scene.replace(meshes=Meshes.empty()),
                                 orig, direc, max_t, t_min, tri_chunk)
        with jax.named_scope("cull_occluded"):
            seg_lo, seg_hi, inside = _segments(self._cd, orig, direc, t_min,
                                               max_t=max_t, active=active)
            ids, _ = tile_ids(self._cd, seg_lo, seg_hi, inside)
            return occ | _dense_occluded(self._cd, orig, direc, t_min, max_t,
                                         ids, inside)


jax.tree_util.register_pytree_node(
    CullTracer,
    lambda tr: ((tr._scene, tr._inner, tr._cd),
                (tr._depths, tr._occl)),
    lambda aux, ch: _cull_tracer_unflatten(aux, ch))


def _cull_tracer_unflatten(aux, children):
    obj = CullTracer.__new__(CullTracer)
    obj._scene, obj._inner, obj._cd = children
    obj._depths, obj._occl = aux
    obj._n_nearest = 0
    return obj


# ---------------------------------------------------------------------------
# Partitioned hybrid render: culled dense sweep for thin tiles, walk for fat
# ---------------------------------------------------------------------------

def _tile_dirs(camera, opts, row0: int, rows: int):
    """Replicate render()'s non-compacted tiling → (dirs [k, tile, 3],
    inv_order or None, tile, n_pix). One definition keeps the partitioned
    renderer, the audit, and render() on the same tile boundaries."""
    w = opts.width
    n_pix = rows * w
    dirs = geom.raygen(camera.pos, camera.c2w, camera.fov_deg, w,
                       opts.height, row0=row0, rows=rows)
    tile = min(opts.tile_rays, -(-n_pix // 8) * 8)
    inv_order = None
    if (opts.tile_block is not None and n_pix > tile
            and opts.tile_block[0] * opts.tile_block[1] == tile):
        from raytracer.renderer import block_perm

        bh, bw = opts.tile_block
        perm, inv = block_perm(rows, w, bh, bw)
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (1, 3))])
        dirs = dirs[jnp.asarray(perm)]
        inv_order = jnp.asarray(inv)
    else:
        n_pad = -(-n_pix // tile) * tile
        if n_pad != n_pix:
            dirs = jnp.concatenate(
                [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]),
                                        (n_pad - n_pix, 3))])
    return dirs.reshape(-1, tile, 3), inv_order, tile, n_pix


def render_partitioned(scene, camera, opts, row0: int = 0,
                       rows: int | None = None, inner=None,
                       cap: int | None = None, chunk: int | None = None,
                       count_rays: bool = False, counts_out: dict = None):
    """Band render, per-tile hybrid: tiles whose culled lists fit `cap` run
    the dense sweep (CullTracer, d0 nearest + d0 shadows), the rest run the
    inner walk. → (img, traced).

    The partition comes from an on-device audit (exact d0 counts + shadow
    upper bounds, one cheap program) read back to the host — i.e. it is
    per-(scene, camera, band) DATA, like the grid build. Class sizes are
    static program shapes: a camera move that changes them recompiles the
    two scan programs (amortized for static-scene serving/bench; pad-to-
    budget is the documented extension if that ever matters). Exactness
    does NOT depend on the audit: thin tiles are gated by the EXACT d0
    count and the superset shadow bound, so culled results equal the walk
    to 1 ulp; a conservative misclassification only costs speed.
    """
    from raytracer.core.types import as_jax

    scene = as_jax(scene)
    rows = opts.height - row0 if rows is None else rows
    if inner is None:
        from raytracer.accel.grid import GridTracer

        inner = GridTracer.build(scene)
    cull_tr = CullTracer(scene, inner=inner, cap=cap, chunk=chunk)
    cd = cull_tr._cd
    dirs, inv_order, tile, n_pix = _tile_dirs(camera, opts, row0, rows)
    orig = jnp.broadcast_to(jnp.asarray(camera.pos), (tile, 3))

    d0c, shc = _audit_counts(cd, scene, inner, orig, dirs,
                             float(opts.t_min), opts.tri_chunk,
                             float(opts.bias))
    d0c = np.asarray(d0c)
    shc = np.asarray(shc)
    thin = (d0c <= cd.cap) & (shc <= cd.cap)
    if counts_out is not None:
        counts_out.update(d0=d0c, shadow=shc, thin=thin)
    thin_idx = np.nonzero(thin)[0].astype(np.int32)
    fat_idx = np.nonzero(~thin)[0].astype(np.int32)

    parts, order_src = [], []
    zero = jnp.zeros((), jnp.float32)
    traced = zero
    if thin_idx.size:
        rad_t, tr_t = _scan_jit(scene, orig, dirs[jnp.asarray(thin_idx)],
                                cull_tr, opts=opts, count_rays=count_rays)
        parts.append(rad_t)
        order_src.append(thin_idx)
        traced = traced + tr_t
    if fat_idx.size:
        rad_f, tr_f = _scan_jit(scene, orig, dirs[jnp.asarray(fat_idx)],
                                inner, opts=opts, count_rays=count_rays)
        parts.append(rad_f)
        order_src.append(fat_idx)
        traced = traced + tr_f
    rad = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    # static reassembly permutation: concat order → tile order (gather only)
    order = np.argsort(np.concatenate(order_src)).astype(np.int32)
    rad = rad[jnp.asarray(order)].reshape(-1, 3)
    if inv_order is not None:
        rad = rad[inv_order]
    from raytracer.ops.safemath import clamp01

    img = clamp01(rad[:n_pix]).reshape(rows, opts.width, 3)
    return img, traced


class HybridBand:
    """Precomputed-partition band renderer for timing/serving loops.

    `render_partitioned` re-audits per call (correct for a moving camera,
    but eager glue per frame); this wraps one band with its partition FROZEN
    at build time — one jitted program per frame call, `eps` threading the
    bench's data-dependency chain through the ray origins. Rebuild when the
    camera/scene moves materially (same amortization contract as the grid
    build itself)."""

    def __init__(self, scene, camera, opts, row0: int = 0,
                 rows: int | None = None, inner=None, cap: int | None = None,
                 chunk: int | None = None):
        from raytracer.core.types import as_jax

        scene = as_jax(scene)
        rows = opts.height - row0 if rows is None else rows
        if inner is None:
            from raytracer.accel.grid import GridTracer

            inner = GridTracer.build(scene)
        self._cull = CullTracer(scene, inner=inner, cap=cap, chunk=chunk)
        self._inner = inner
        self._scene = scene
        self._opts = opts
        self._rows = rows
        dirs, inv_order, tile, n_pix = _tile_dirs(camera, opts, row0, rows)
        self._orig = jnp.broadcast_to(jnp.asarray(camera.pos), (tile, 3))
        d0c, shc = _audit_counts(self._cull._cd, scene, inner, self._orig,
                                 dirs, float(opts.t_min), opts.tri_chunk,
                                 float(opts.bias))
        thin = ((np.asarray(d0c) <= self._cull._cd.cap)
                & (np.asarray(shc) <= self._cull._cd.cap))
        self.n_thin, self.n_tiles = int(thin.sum()), int(thin.size)
        thin_idx = np.nonzero(thin)[0].astype(np.int32)
        fat_idx = np.nonzero(~thin)[0].astype(np.int32)
        self._thin_dirs = dirs[jnp.asarray(thin_idx)]
        self._fat_dirs = dirs[jnp.asarray(fat_idx)]
        order = np.argsort(np.concatenate([thin_idx, fat_idx])).astype(
            np.int32)
        self._order = jnp.asarray(order)
        self._inv = inv_order
        self._n_pix = n_pix

    def __call__(self, eps=0.0):
        return _hybrid_jit(self._scene, self._orig + eps, self._thin_dirs,
                           self._fat_dirs, self._cull, self._inner,
                           self._order, self._inv, opts=self._opts,
                           rows=self._rows, n_pix=self._n_pix)


def hybrid_image(scene, orig, thin_dirs, fat_dirs, cull_tr, inner, order,
                 inv_order, opts, rows: int, n_pix: int,
                 count_rays: bool = False):
    """Differentiable fixed-partition band body → (img, traced). Jit/vjp
    it from the caller (HybridBand forward, the hybrid training loss)."""
    from raytracer.ops.safemath import clamp01

    parts = []
    traced = jnp.zeros((), jnp.float32)
    if thin_dirs.shape[0]:
        rad_t, tr_t = _scan_body(scene, orig, thin_dirs, cull_tr, opts,
                                 count_rays)
        parts.append(rad_t)
        traced = traced + tr_t
    if fat_dirs.shape[0]:
        rad_f, tr_f = _scan_body(scene, orig, fat_dirs, inner, opts,
                                 count_rays)
        parts.append(rad_f)
        traced = traced + tr_f
    rad = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    rad = rad[order].reshape(-1, 3)
    if inv_order is not None:
        rad = rad[inv_order]
    return clamp01(rad[:n_pix]).reshape(rows, opts.width, 3), traced


@functools.partial(jax.jit, static_argnames=("opts", "rows", "n_pix"))
def _hybrid_jit(scene, orig, thin_dirs, fat_dirs, cull_tr, inner, order,
                inv_order, *, opts, rows, n_pix):
    return hybrid_image(scene, orig, thin_dirs, fat_dirs, cull_tr, inner,
                        order, inv_order, opts, rows, n_pix)[0]


def _scan_body(scene, orig, dirs_tiles, tracer, opts, count_rays=False):
    """Sequential-tile render scan (renderer.render's scan body with its
    remat policy, minus the compaction/wide-d0 modes the hybrid never
    uses) → (rad [k, tile, 3], traced)."""
    from raytracer import renderer

    def tile_fn(carry, tdirs):
        rad, traced = renderer.render_rays(scene, orig, tdirs, opts,
                                           count_rays, tracer=tracer)
        return carry + traced, rad

    if opts.remat_tiles:
        if opts.remat_policy == "plan":
            tile_fn = jax.checkpoint(
                tile_fn, policy=jax.checkpoint_policies.save_only_these_names(
                    "trace_plan"))
        else:
            tile_fn = jax.checkpoint(tile_fn)
    traced, rad = jax.lax.scan(tile_fn, jnp.zeros((), jnp.float32),
                               dirs_tiles)
    return rad, traced


@functools.partial(jax.jit, static_argnames=("opts", "count_rays"))
def _scan_jit(scene, orig, dirs_tiles, tracer, *, opts, count_rays):
    rad, traced = _scan_body(scene, orig, dirs_tiles, tracer, opts,
                             count_rays)
    return rad, traced


@functools.partial(jax.jit, static_argnames=("t_min", "tri_chunk", "bias"))
def _audit_counts(cd, scene, inner, orig, dirs_tiles, t_min, tri_chunk,
                  bias):
    """One program: per-tile d0 survivor count (EXACT) + max per-light
    shadow-list upper bound → ([k], [k]) i32. The d0 nearest for shadow
    origins runs ONCE at full band width (coherent primaries) and is
    sliced per tile."""
    k, tile, _ = dirs_tiles.shape
    flat = dirs_tiles.reshape(-1, 3)
    oflat = jnp.broadcast_to(orig[:1], (flat.shape[0], 3))
    hit = inner.nearest(oflat, flat, t_min, tri_chunk)
    valid = jnp.isfinite(hit.t)
    p = oflat + jnp.where(valid, hit.t, 0.0)[:, None] * flat
    lpos = jnp.asarray(scene.lights.pos, jnp.float32)
    nl = lpos.shape[0]

    def per_tile(td, pt, vt):
        seg_lo, seg_hi, inside = _segments(cd, orig, td, t_min)
        c0 = _count_overlap(cd, seg_lo, seg_hi, inside)
        cmax = jnp.zeros((), jnp.int32)
        for li in range(nl):
            lvec = lpos[li][None, :] - pt
            dist = jnp.sqrt(jnp.maximum(jnp.sum(lvec * lvec, axis=1),
                                        1e-24))
            ldir = lvec / dist[:, None]
            slo, shi, sin = _segments(cd, pt, ldir, t_min, max_t=dist,
                                      active=vt)
            pad = jnp.float32(2.0 * bias)
            cmax = jnp.maximum(cmax,
                               _count_overlap(cd, slo - pad, shi + pad, sin))
        return c0, cmax

    return jax.lax.map(
        lambda xs: per_tile(*xs),
        (dirs_tiles, p.reshape(k, tile, 3), valid.reshape(k, tile)))


def _count_overlap(cd: CullData, seg_lo, seg_hi, inside):
    big = jnp.float32(3.4e38)
    tlo = jnp.where(inside[:, None], seg_lo, big).min(axis=0)
    thi = jnp.where(inside[:, None], seg_hi, -big).max(axis=0)
    overlap = (jnp.all(cd.tri_lo <= thi[None, :], axis=1)
               & jnp.all(cd.tri_hi >= tlo[None, :], axis=1))
    return jnp.sum(overlap.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Audit: exact per-tile survivor counts (the cap gate)
# ---------------------------------------------------------------------------

def cull_audit(scene, camera, opts, row0: int = 0, rows: int | None = None,
               cap: int | None = None, chunk: int | None = None,
               inner=None):
    """Per-tile culled-list sizes for one band → dict of np arrays.

    Replicates render()'s non-compacted tiling exactly (tile_rays-lane flat
    tiles, padded with the renderer's dummy dir): 'd0' [n_tiles] is the
    EXACT survivor count of each tile's d0 nearest call; 'shadow'
    [n_tiles, L] upper-bounds each d0 per-light occlusion call (the audit
    unions over ALL valid d0 hits where the real call unions over the
    lit-facing diffuse subset — a superset AABB, so audit >= actual).
    Gate: counts.max() <= cap ⇒ the culled render is exact.
    """
    from raytracer.core.types import as_jax

    scene = as_jax(scene)
    cd = build_cull(scene, cap, chunk)
    h, w = opts.height, opts.width
    rows = h if rows is None else rows
    n_pix = rows * w
    dirs = geom.raygen(camera.pos, camera.c2w, camera.fov_deg, w, h,
                       row0=row0, rows=rows)
    tile = min(opts.tile_rays, -(-n_pix // 8) * 8)
    if (opts.tile_block is not None and n_pix > tile
            and opts.tile_block[0] * opts.tile_block[1] == tile):
        from raytracer.renderer import block_perm

        bh, bw = opts.tile_block
        perm, _ = block_perm(rows, w, bh, bw)
        dirs = jnp.concatenate(
            [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (1, 3))])
        dirs = dirs[jnp.asarray(perm)]
    else:
        n_pad = -(-n_pix // tile) * tile
        if n_pad != n_pix:
            dirs = jnp.concatenate(
                [dirs, jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]),
                                        (n_pad - n_pix, 3))])
    dirs = dirs.reshape(-1, tile, 3)
    orig = jnp.broadcast_to(jnp.asarray(camera.pos), (tile, 3))
    if inner is None:
        from raytracer.accel.grid import GridTracer

        inner = GridTracer.build(scene)
    lpos = jnp.asarray(scene.lights.pos, jnp.float32)
    nl = int(scene.lights.count)

    @jax.jit
    def tile_counts(td):
        seg_lo, seg_hi, inside = _segments(cd, orig, td, float(opts.t_min))
        _, c0 = tile_ids(cd, seg_lo, seg_hi, inside)
        hit = inner.nearest(orig, td, float(opts.t_min), opts.tri_chunk)
        valid = jnp.isfinite(hit.t)
        p = orig + jnp.where(valid, hit.t, 0.0)[:, None] * td
        cs = []
        for li in range(nl):
            lvec = lpos[li][None, :] - p
            dist = jnp.sqrt(jnp.maximum(jnp.sum(lvec * lvec, axis=1), 1e-24))
            ldir = lvec / dist[:, None]
            slo, shi, sin = _segments(cd, p, ldir, float(opts.t_min),
                                      max_t=dist, active=valid)
            # absorb the shade bias offset (sorig = p ± bias·n)
            pad = jnp.float32(2.0 * opts.bias)
            _, c = tile_ids(cd, slo - pad, shi + pad, sin)
            cs.append(c)
        return c0, jnp.stack(cs) if cs else jnp.zeros((0,), jnp.int32)

    d0, sh = [], []
    for k in range(dirs.shape[0]):
        c0, cs = tile_counts(dirs[k])
        d0.append(int(c0))
        sh.append(np.asarray(cs))
    return {"d0": np.asarray(d0), "shadow": np.stack(sh) if sh else
            np.zeros((0, 0)), "cap": cd.cap, "n_tris": cd.n_tris,
            "tile": tile, "n_tiles": dirs.shape[0]}
