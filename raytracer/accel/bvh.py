"""BVH acceleration: host SAH-lite build → threaded links → device stackless walk.

Reference analog: the naive-grid/BVH traversal for big meshes (SURVEY.md §2.2
"Accel grid/BVH", BASELINE config 4) — the BVH half of C10; `accel/grid.py` is
the grid half (SURVEY §7.3.1: "BVH only if grid can't hit perf" — both are
now first-class, selectable backends):

- Host build (NumPy, cold path): median-split on the widest centroid axis,
  fixed-capacity leaves (sentinel-padded) — every device array is static-shape.
- **Threaded traversal, no stack.** Each node gets a `hit_link` (next node when
  its AABB is hit) and a `miss_link` (escape when it isn't); traversal is a
  `lax.while_loop` over a per-ray node pointer — no per-ray stacks, no dynamic
  shapes, plain batched gathers. Links are precomputed for all 8 ray-direction
  octants so each ray walks near-child-first and the `best_t` slab pruning
  actually prunes (the classic per-octant threaded BVH).
- Inner nodes carry an all-sentinel leaf row, so every step is the same
  branchless program: slab test → (masked) leaf triangle tests → link follow.
- Legal under the framework's differentiation contract: the walk is integer-
  only and stop-gradient; `ops/trace.surface_at` recomputes all continuous
  quantities from the winning (kind, idx) residuals (docs/ARCH.md).

Gradients: tree topology is frozen at build time (host, concrete arrays);
vertex gradients flow through the winner recompute. Rebuild when vertices move
materially (inverse-rendering loops rebuild per step, outside jit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.accel.grid import _eval_candidates, _pad_soa

INF = jnp.inf


@dataclasses.dataclass
class BVHData:
    """Device-side threaded-BVH tensors + static metadata."""

    aabb_min: jax.Array   # [n_nodes, 3] f32
    aabb_max: jax.Array   # [n_nodes, 3] f32
    leaf_tris: jax.Array  # [n_nodes, C] i32 — triangle ids, sentinel = n_tris
    hit_link: jax.Array   # [8 * n_nodes] i32 — next node on AABB hit
    miss_link: jax.Array  # [8 * n_nodes] i32 — next node on AABB miss
    leaf_soa: jax.Array | None  # [n_nodes, C, 10] f32 v0|e1|e2|id pre-gathered
    #                     at build (RT_BVH_PREGATHER=1): each walk step then
    #                     does ONE leaf gather — ids ride column 9 (f32, exact
    #                     below 2^24 tris; 9-col + id gather above that)
    n_nodes: int          # static; link sentinel value = n_nodes (walk done)
    capacity: int         # static C
    n_tris: int           # static leaf sentinel (= index of degenerate pad tri)
    aabb6: jax.Array | None = None   # [n_nodes, 6] min|max packed at build —
    #                     one slab gather per step instead of two
    links2: jax.Array | None = None  # [8*n_nodes, 2] hit|miss packed at build
    #                     (None on the stacked per-shard path → split arrays)


jax.tree_util.register_dataclass(
    BVHData,
    data_fields=["aabb_min", "aabb_max", "leaf_tris", "hit_link", "miss_link",
                 "leaf_soa", "aabb6", "links2"],
    meta_fields=["n_nodes", "capacity", "n_tris"])


def _pregather_soa(verts_f32, tris, id_table, n_tris):
    """[... , C] triangle-id table → [..., C, 10] v0|e1|e2|id rows (f32 edges,
    as tri_soa computes them on device); sentinel ids → the zero triangle
    with id = n_tris. Ids ride as f32 (exact below 2^24 tris; 9-col fallback
    + separate id gather above that)."""
    v0 = verts_f32[tris[:, 0]]
    rows = np.concatenate(
        [v0, verts_f32[tris[:, 1]] - v0, verts_f32[tris[:, 2]] - v0], axis=1)
    rows = np.concatenate([rows, np.zeros((1, 9), np.float32)])
    if n_tris < (1 << 24):
        ids_col = np.arange(n_tris + 1, dtype=np.float32)[:, None]
        rows = np.concatenate([rows, ids_col], axis=1)
    return jnp.asarray(rows[np.minimum(np.asarray(id_table), n_tris)])


def _pack_fused(amin, amax, hit, miss):
    """Build-time fused gather layouts: aabb [n,6], links [8n,2]."""
    aabb6 = jnp.concatenate([jnp.asarray(amin, jnp.float32),
                             jnp.asarray(amax, jnp.float32)], axis=1)
    links2 = jnp.stack([jnp.asarray(hit).reshape(-1),
                        jnp.asarray(miss).reshape(-1)], axis=1)
    return aabb6, links2


_SAH_BINS = 16


def _sah_split(c, bmin, bmax, leaf_size):
    """Binned SAH over the node's triangles → (axis, mid_offset, perm).

    c/bmin/bmax: [k,3] centroids and per-triangle AABBs (node-local).
    Standard binned build (Wald 2007): 16 centroid bins per axis, split
    plane minimizing Σ count·surface_area of the two children. Falls back
    to the median split when every candidate is degenerate (all centroids
    coincident on every axis)."""
    k = c.shape[0]
    best = (None, None, np.inf)  # (axis, bin, cost)
    binned = {}
    for ax in range(3):
        lo, hi = c[:, ax].min(), c[:, ax].max()
        if hi <= lo:
            continue
        b = np.minimum(((c[:, ax] - lo) * (_SAH_BINS / (hi - lo))).astype(
            np.int64), _SAH_BINS - 1)
        binned[ax] = b
        counts = np.bincount(b, minlength=_SAH_BINS)
        # per-bin grown AABBs via segment min/max
        bn_min = np.full((_SAH_BINS, 3), np.inf)
        bn_max = np.full((_SAH_BINS, 3), -np.inf)
        np.minimum.at(bn_min, b, bmin)
        np.maximum.at(bn_max, b, bmax)

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        lmin = np.minimum.accumulate(bn_min, axis=0)
        lmax = np.maximum.accumulate(bn_max, axis=0)
        rmin = np.minimum.accumulate(bn_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bn_max[::-1], axis=0)[::-1]
        nl = np.cumsum(counts)[:-1]                 # after bin i, i=0..B-2
        nr = k - nl
        cost = np.where(
            (nl > 0) & (nr > 0),
            nl * area(lmin[:-1], lmax[:-1]) + nr * area(rmin[1:], rmax[1:]),
            np.inf)
        i = int(np.argmin(cost))
        if cost[i] < best[2]:
            best = (ax, i, float(cost[i]))
    if best[0] is None:  # fully degenerate node: median on widest axis
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        perm = np.argsort(c[:, ax], kind="stable")
        return ax, k // 2, perm
    ax, i, _ = best
    go_right = binned[ax] > i
    perm = np.argsort(go_right, kind="stable")  # left block first, stable
    return ax, int(k - go_right.sum()), perm


def build_bvh(verts, tris, leaf_size: int = 8,
              pregather: bool | None = None,
              sah: bool | None = None) -> BVHData:
    """Host-side build from concrete arrays (not traceable).

    Median split on the widest centroid axis; leaves hold ≤ `leaf_size`
    triangles. Produces per-octant hit/miss threading so the device walk
    visits the near child first for any ray direction.

    sah=True (env RT_BVH_SAH=1): binned surface-area-heuristic splits (16
    centroid bins per axis, min Σ area·count) instead of median — better
    trees on unevenly distributed geometry, identical walk semantics. NumPy
    builder only (the native twin stays median; SAH builds skip it).
    """
    import os

    from raytracer.utils.native import native_lib

    if pregather is None:
        pregather = os.environ.get("RT_BVH_PREGATHER") == "1"
    if sah is None:
        sah = os.environ.get("RT_BVH_SAH") == "1"
    t = np.asarray(tris).shape[0]
    assert t > 0, "BVH over empty mesh"
    # Round vertices through f32 FIRST so both builders consume identical
    # values (scenes store f32; the native ABI is f32) — otherwise f64 input
    # with sub-f32 precision could order centroids differently per builder.
    verts = np.asarray(verts, np.float32)
    tris_i = np.asarray(tris)
    lib = native_lib()
    if sah:
        lib = None  # SAH is NumPy-only; don't take the median native path
    if lib is not None and lib.has_bvh:
        amin, amax, leaf, hit, miss = lib.bvh_build(
            verts, np.asarray(tris, np.int32), leaf_size)
        aabb6, links2 = _pack_fused(amin, amax, hit, miss)
        return BVHData(
            aabb_min=jnp.asarray(amin), aabb_max=jnp.asarray(amax),
            leaf_tris=jnp.asarray(leaf), hit_link=jnp.asarray(hit),
            miss_link=jnp.asarray(miss),
            leaf_soa=(_pregather_soa(verts, tris_i, leaf, t)
                      if pregather else None),
            n_nodes=amin.shape[0], capacity=leaf_size, n_tris=t,
            aabb6=aabb6, links2=links2)

    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    cent = (tmin + tmax) * 0.5

    # --- recursive median split over an index permutation ------------------
    aabb_min: list[np.ndarray] = []
    aabb_max: list[np.ndarray] = []
    left: list[int] = []
    right: list[int] = []
    axis: list[int] = []
    leaf_rows: list[np.ndarray] = []
    order = np.arange(t)

    def alloc() -> int:
        aabb_min.append(np.zeros(3))
        aabb_max.append(np.zeros(3))
        left.append(-1)
        right.append(-1)
        axis.append(0)
        leaf_rows.append(np.full((leaf_size,), t, np.int32))
        return len(aabb_min) - 1

    # iterative DFS (explicit stack): deep meshes must not hit the Python
    # recursion limit
    root = alloc()
    stack = [(root, 0, t)]
    while stack:
        node, lo, hi = stack.pop()
        ids = order[lo:hi]
        aabb_min[node] = tmin[ids].min(axis=0)
        aabb_max[node] = tmax[ids].max(axis=0)
        if hi - lo <= leaf_size:
            leaf_rows[node][: hi - lo] = ids.astype(np.int32)
            continue
        c = cent[ids]
        if sah:
            ax, mid_off, perm = _sah_split(c, tmin[ids], tmax[ids], leaf_size)
        else:
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            # median split (argsort is stable → deterministic builds)
            perm = np.argsort(c[:, ax], kind="stable")
            mid_off = (hi - lo) // 2
        axis[node] = ax
        order[lo:hi] = ids[perm]
        mid = lo + mid_off
        l, r = alloc(), alloc()
        left[node], right[node] = l, r
        stack.append((r, mid, hi))
        stack.append((l, lo, mid))

    n = len(aabb_min)
    ax_arr = np.asarray(axis, np.int32)
    l_arr = np.asarray(left, np.int32)
    r_arr = np.asarray(right, np.int32)

    # --- per-octant threading ---------------------------------------------
    # Octant bit a of `o` is 1 when dir[a] < 0. At a node split on axis `a`,
    # the near child is `left` (lower centroids) for positive dir, `right`
    # for negative. hit_link descends near-first; miss_link escapes the
    # subtree (DFS threading).
    hit = np.full((8, n), n, np.int32)
    miss = np.full((8, n), n, np.int32)
    for o in range(8):
        tstack = [(root, n)]
        while tstack:
            node, escape = tstack.pop()
            if l_arr[node] < 0:  # leaf: after testing tris, go to escape
                hit[o, node] = escape
                miss[o, node] = escape
                continue
            bit = (o >> ax_arr[node]) & 1
            near = l_arr[node] if bit == 0 else r_arr[node]
            far = r_arr[node] if bit == 0 else l_arr[node]
            hit[o, node] = near
            miss[o, node] = escape
            tstack.append((far, escape))
            tstack.append((near, far))

    leaf_stack = np.stack(leaf_rows)
    aabb6, links2 = _pack_fused(np.stack(aabb_min).astype(np.float32),
                                np.stack(aabb_max).astype(np.float32),
                                hit.reshape(-1), miss.reshape(-1))
    return BVHData(
        aabb_min=jnp.asarray(np.stack(aabb_min), jnp.float32),
        aabb_max=jnp.asarray(np.stack(aabb_max), jnp.float32),
        leaf_tris=jnp.asarray(leaf_stack),
        hit_link=jnp.asarray(hit.reshape(-1)),
        miss_link=jnp.asarray(miss.reshape(-1)),
        leaf_soa=(_pregather_soa(verts.astype(np.float32), tris_i, leaf_stack,
                                 t) if pregather else None),
        n_nodes=n, capacity=leaf_size, n_tris=t,
        aabb6=aabb6, links2=links2)


def build_stacked_bvh(v0, e1, e2, n_shards: int, leaf_size: int = 8):
    """Per-shard BVHs over equal contiguous triangle chunks → stacked arrays.

    For the primitive-sharded / ring tracers (parallel/tracer.py): the padded
    triangle SoA is split into `n_shards` equal chunks (the same contiguous
    split `jax.sharding` applies on the 'prims' axis); each chunk gets its own
    BVH with LOCAL triangle indices; trees are padded to a common node count
    so one [S, ...] stack shards/rotates cleanly. Shorter trees' link
    sentinels are re-mapped to the common n_nodes_max; pad nodes carry
    inverted AABBs (never hit) and sentinel links, so they are unreachable
    and park any lane that lands on them.

    → dict of stacked host arrays: aabb_min/aabb_max [S,n,3] f32,
      leaf_tris [S,n,C] i32, hit_link/miss_link [S,8n] i32, plus static
      n_nodes (common) and tris_per_shard.
    """
    v0 = np.asarray(v0, np.float32)
    t_total = v0.shape[0]
    assert t_total % n_shards == 0, "pad triangles before sharding"
    ts = t_total // n_shards
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)

    parts = []
    for s in range(n_shards):
        sl = slice(s * ts, (s + 1) * ts)
        # build_bvh consumes (verts, tris); synthesize a vertex soup per chunk
        verts = np.concatenate([v0[sl], v0[sl] + e1[sl], v0[sl] + e2[sl]])
        tris = np.stack([np.arange(ts), np.arange(ts) + ts,
                         np.arange(ts) + 2 * ts], axis=1).astype(np.int32)
        # stacked arrays don't carry leaf_soa (the sharded walk gathers from
        # its local SoA) — skip the pregather even if the env flag is set
        parts.append(build_bvh(verts, tris, leaf_size=leaf_size,
                               pregather=False))

    n_max = max(p.n_nodes for p in parts)
    S = n_shards
    amin = np.full((S, n_max, 3), 1.0, np.float32)   # inverted AABB
    amax = np.full((S, n_max, 3), -1.0, np.float32)  # (min > max ⇒ no hit)
    leaf = np.full((S, n_max, leaf_size), ts, np.int32)
    hit = np.full((S, 8 * n_max), n_max, np.int32)
    miss = np.full((S, 8 * n_max), n_max, np.int32)
    for s, p in enumerate(parts):
        n = p.n_nodes
        amin[s, :n] = np.asarray(p.aabb_min)
        amax[s, :n] = np.asarray(p.aabb_max)
        leaf[s, :n] = np.asarray(p.leaf_tris)
        h = np.asarray(p.hit_link).reshape(8, n)
        m = np.asarray(p.miss_link).reshape(8, n)
        h = np.where(h == n, n_max, h)   # done-sentinel → common sentinel
        m = np.where(m == n, n_max, m)
        hit[s, :] = np.pad(h, ((0, 0), (0, n_max - n)),
                           constant_values=n_max).reshape(-1)
        miss[s, :] = np.pad(m, ((0, 0), (0, n_max - n)),
                            constant_values=n_max).reshape(-1)
    return {"aabb_min": amin, "aabb_max": amax, "leaf_tris": leaf,
            "hit_link": hit, "miss_link": miss,
            "n_nodes": n_max, "capacity": leaf_size, "tris_per_shard": ts}


def bvh_walk(bvh: BVHData, v0, e1, e2, orig, direc, t_min,
             occlusion_max_t=None, active=None):
    """Stackless threaded walk over all rays → (best_t [N], best_idx [N]).

    With `occlusion_max_t` given, lanes park as soon as any hit < max_t is
    found (any-hit mode); best_t < max_t then means occluded.
    `active` [N] bool parks lanes at the done-sentinel before step 0 (they
    return miss/INF) so dead wavefront lanes stop driving the while_loop trip
    count; active lanes' results are bitwise-unchanged.

    Gather layout: build_bvh packs node AABBs [n,6] (aabb6), hit/miss links
    [8n,2] (links2), and in pregather mode the triangle ids as a 10th f32
    leaf_soa column — 3 gathers per walk step instead of 6, built once at
    build time. The stacked per-shard path passes aabb6/links2=None and takes
    the split-array fallback.
    """
    n_rays = orig.shape[0]
    nn = bvh.n_nodes
    v0p, e1p, e2p = _pad_soa(v0, e1, e2)
    aabb6, links2 = bvh.aabb6, bvh.links2

    inv_d = jnp.where(jnp.abs(direc) > 1e-12, 1.0 / direc, 1e12)
    octant = ((direc[:, 0] < 0).astype(jnp.int32)
              | ((direc[:, 1] < 0).astype(jnp.int32) << 1)
              | ((direc[:, 2] < 0).astype(jnp.int32) << 2))
    link_base = octant * nn

    best_t = jnp.full((n_rays,), INF, jnp.float32)
    best_i = jnp.full((n_rays,), bvh.n_tris, jnp.int32)
    node = jnp.zeros((n_rays,), jnp.int32)  # root
    if active is not None:
        node = jnp.where(jax.lax.stop_gradient(active), node, nn)

    if occlusion_max_t is not None:
        prune = jnp.asarray(occlusion_max_t, jnp.float32)

    def cond(state):
        it, node, best_t, best_i = state
        return jnp.any(node < nn) & (it < nn + 1)

    def body(state):
        it, node, best_t, best_i = state
        active = node < nn
        nc = jnp.minimum(node, nn - 1)
        if aabb6 is not None:
            box = aabb6[nc]                            # [N, 6] one gather
            amin, amax = box[:, :3], box[:, 3:]
        else:
            amin = bvh.aabb_min[nc]
            amax = bvh.aabb_max[nc]
        t0 = (amin - orig) * inv_d
        t1 = (amax - orig) * inv_d
        tn = jnp.maximum(jnp.minimum(t0, t1).max(axis=1), t_min)
        tf = jnp.maximum(t0, t1).min(axis=1)
        bound = prune if occlusion_max_t is not None else best_t
        hit_box = active & (tn <= tf) & (tf > t_min) & (tn < bound)

        ts, tids = _eval_candidates(orig, direc, nc, bvh.leaf_soa,
                                    bvh.leaf_tris, v0p, e1p, e2p, t_min)
        ts = jnp.where(hit_box[:, None], ts, INF)
        tc = jnp.min(ts, axis=1)
        # winner id without a per-step gather: lowest id among the t-minima
        # (leaf rows are centroid-ordered, so this resolves exact within-leaf
        # ties to the SPEC's lowest-index rule rather than slot order)
        ic = jnp.min(jnp.where(ts <= tc[:, None], tids, bvh.n_tris), axis=1)
        # SPEC tie order on exact-t ties ACROSS steps too (lowest id wins,
        # not first-found) — removes visit-order dependence within the walk
        better = (tc < best_t) | ((tc == best_t) & (ic < best_i))
        best_t = jnp.where(better, tc, best_t)
        best_i = jnp.where(better, ic, best_i)

        if links2 is not None:
            lk = links2[link_base + nc]                # [N, 2] one gather
            nxt = jnp.where(hit_box, lk[:, 0], lk[:, 1])
        else:
            nxt = jnp.where(hit_box, bvh.hit_link[link_base + nc],
                            bvh.miss_link[link_base + nc])
        if occlusion_max_t is not None:
            nxt = jnp.where(best_t < prune, nn, nxt)   # park: occluded
        node = jnp.where(active, nxt, node)
        return it + 1, node, best_t, best_i

    state = (jnp.zeros((), jnp.int32), node, best_t, best_i)
    scope = "bvh_walk_occl" if occlusion_max_t is not None else "bvh_walk"
    with jax.named_scope(scope):
        _, _, best_t, best_i = jax.lax.while_loop(cond, body, state)
    return best_t, best_i


class BVHTracer:
    """Drop-in tracer: BVH-accelerated triangles + brute spheres/planes.

    Mirrors accel.grid.GridTracer: build on host from a concrete scene
    (`BVHTracer.build(scene)`); the result is a pytree-of-arrays closure safe
    to pass through jit.
    """

    def __init__(self, scene, bvh: BVHData):
        from raytracer.core.types import as_jax

        self._scene = as_jax(scene)
        self._bvh = bvh
        v0, e1, e2 = self._scene.meshes.tri_soa()
        self._soa = jax.lax.stop_gradient((jnp.asarray(v0, jnp.float32),
                                           jnp.asarray(e1, jnp.float32),
                                           jnp.asarray(e2, jnp.float32)))

    @staticmethod
    def build(scene, leaf_size: int | None = None,
              pregather: bool | None = None):
        import os

        if leaf_size is None:
            leaf_size = int(os.environ.get("RT_BVH_LEAF", 8))
        bvh = build_bvh(np.asarray(scene.meshes.verts),
                        np.asarray(scene.meshes.tris), leaf_size=leaf_size,
                        pregather=pregather)
        return BVHTracer(scene, bvh)

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        from raytracer.core.types import KIND_TRIANGLE
        from raytracer.accel.grid import _EMPTY_MESHES
        from raytracer.ops import trace as trace_ops

        orig = jax.lax.stop_gradient(orig)
        direc = jax.lax.stop_gradient(direc)
        base = trace_ops.nearest_hit(
            self._scene.replace(meshes=_EMPTY_MESHES), orig, direc, t_min,
            tri_chunk)
        v0, e1, e2 = self._soa
        tb, ib = bvh_walk(self._bvh, v0, e1, e2, orig, direc, t_min,
                          active=active)
        better = tb < base.t
        return trace_ops.Hit(
            kind=jnp.where(better, KIND_TRIANGLE, base.kind),
            idx=jnp.where(better, ib, base.idx),
            t=jnp.where(better, tb, base.t))

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        from raytracer.accel.grid import _EMPTY_MESHES
        from raytracer.ops import trace as trace_ops

        orig = jax.lax.stop_gradient(orig)
        direc = jax.lax.stop_gradient(direc)
        max_t = jax.lax.stop_gradient(max_t)
        occ = trace_ops.occluded(self._scene.replace(meshes=_EMPTY_MESHES),
                                 orig, direc, max_t, t_min, tri_chunk)
        v0, e1, e2 = self._soa
        tb, _ = bvh_walk(self._bvh, v0, e1, e2, orig, direc, t_min,
                         occlusion_max_t=max_t, active=active)
        return occ | (tb < max_t)


jax.tree_util.register_pytree_node(
    BVHTracer,
    lambda tr: ((tr._scene, tr._bvh, tr._soa), None),
    lambda aux, ch: _bvh_tracer_unflatten(aux, ch))


def _bvh_tracer_unflatten(_aux, children):
    scene, bvh, soa = children
    obj = BVHTracer.__new__(BVHTracer)
    obj._scene = scene
    obj._bvh = bvh
    obj._soa = soa
    return obj
