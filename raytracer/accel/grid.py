"""Uniform-grid acceleration: host build → flat tensors → device DDA walk.

Reference analog: the naive-grid/BVH traversal for big meshes (SURVEY.md §2.2
"Accel grid/BVH", BASELINE config 4). Static-shape design (SURVEY §7.3.1):

- Host build (NumPy, cold path): triangle AABBs → CSR-free *fixed-capacity*
  cell table `cell_tris[ncells, C]` (sentinel-padded). Cells that overflow C
  spill their extra triangles into a small global `overflow` list tested once
  per trace — static shapes everywhere, no per-cell variable lengths.
- Device walk: vectorized Amanatides–Woo 3D-DDA over the ray wavefront inside
  a `lax.while_loop` (runs until every lane parks or K steps). Legal because
  the winner search is integer-only and stop-gradient (ops/trace.py design);
  the differentiable recompute never sees the loop.
- A lane parks when its best hit lies inside the current cell's t-range
  (`best_t <= min(tmax)`) — the standard grid early-exit that keeps
  cross-cell triangle spans correct.

Gradients: cell assignment is frozen at build time (host, concrete arrays);
vertex gradients still flow through the winner recompute. Rebuild the grid
when vertices move materially (inverse rendering loops rebuild per step,
outside jit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import geometry as geom

INF = jnp.inf


@dataclasses.dataclass
class GridData:
    """Device-side grid tensors + static layout metadata."""

    bmin: jax.Array       # [3] f32 grid AABB min
    inv_cell: jax.Array   # [3] f32 1/cell_size
    cell_size: jax.Array  # [3] f32
    cell_tris: jax.Array  # [ncells, C] i32 — triangle ids, sentinel = n_tris
    overflow: jax.Array   # [O] i32 — spilled triangle ids (may be empty)
    ov_v0: jax.Array      # [O,3] f32 — overflow tri SoA pre-gathered at build
    ov_e1: jax.Array      # [O,3] (device gathers don't fuse; a build-time
    ov_e2: jax.Array      # [O,3]  gather keeps the brute test pure broadcast)
    cell_soa: jax.Array | None  # [ncells, C, 10] f32 v0|e1|e2|id pre-gathered
    #                     per cell at build (pregather mode, the default): the
    #                     DDA step then issues ONE gather — the winner's
    #                     triangle id rides as column 9 (f32, exact below 2^24
    #                     tris; falls back to [.., 9] + an id gather above
    #                     that) instead of 4 separate vertex/id gathers.
    #                     Gather COUNT, not bytes, dominated the walk on the
    #                     accelerator this was first tuned on.
    cell_occ: jax.Array   # [ncells] i8 — 1 where the cell lists ≥1 triangle;
    #                     lets the walk skip empty cells with a 1-byte gather
    #                     instead of the full C-slot candidate gather
    res: tuple            # static (nx, ny, nz)
    capacity: int         # static C
    n_tris: int           # static sentinel value (= index of degenerate pad tri)


jax.tree_util.register_dataclass(
    GridData,
    data_fields=["bmin", "inv_cell", "cell_size", "cell_tris", "overflow",
                 "ov_v0", "ov_e1", "ov_e2", "cell_soa", "cell_occ"],
    meta_fields=["res", "capacity", "n_tris"])


def build_grid(verts, tris, res=None, capacity: int = 24,
               density: float = 4.0, pregather: bool | None = None,
               exact: bool | None = None) -> GridData:
    """Host-side grid build from concrete arrays (not traceable).

    exact=True bins a triangle only into cells it geometrically overlaps
    (SAT, accel/satbin.py) instead of every cell its AABB touches — lower
    occupancy ⇒ smaller viable capacity ⇒ less per-DDA-step gather traffic.
    Rendered images are identical up to exact-t tie association at cell
    boundaries (every hit's cell always lists its triangle and the winner
    fold evaluates the same per-triangle fp, but a tie candidate sitting just
    past the parking cell can resolve differently) — the same knife-edge set
    the golden tests already tolerate. AABB over-binning lets rays park a
    cell earlier; exact binning is kept for the lower-capacity builds it
    enables.
    """
    import os

    if pregather is None:  # default ON (not yet re-tuned on the GPU);
        # "" and "0" both disable (VAR= is this repo's standard off idiom)
        pregather = os.environ.get("RT_GRID_PREGATHER", "1") not in ("", "0")
    if exact is None:
        exact = os.environ.get("RT_GRID_EXACT") == "1"
    # f32-first: the native builder's ABI is f32; rounding here keeps the two
    # builders byte-identical even for f64 input (scenes store f32 anyway)
    verts = np.asarray(np.asarray(verts, np.float32), np.float64)
    tris = np.asarray(tris, np.int64)
    t = tris.shape[0]
    assert t > 0, "grid over empty mesh"
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]

    bmin = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    bmax = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    extent = np.maximum(bmax - bmin, 1e-6)
    pad = 1e-4 * np.linalg.norm(extent)
    bmin -= pad
    bmax += pad
    extent = bmax - bmin

    if res is None:
        # Cleary/Wald heuristic: cells ∝ cbrt(density·T) scaled by extent shape
        base = (density * t) ** (1.0 / 3.0)
        r = np.maximum(1, np.minimum(
            64, np.round(base * extent / (extent.prod() ** (1.0 / 3.0)))
        )).astype(np.int64)
        res = tuple(int(x) for x in r)
    nx, ny, nz = res
    cell = extent / np.array([nx, ny, nz], np.float64)

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    lo = np.clip(((tmin - bmin) / cell).astype(np.int64), 0,
                 np.array([nx - 1, ny - 1, nz - 1]))
    hi = np.clip(((tmax - bmin) / cell).astype(np.int64), 0,
                 np.array([nx - 1, ny - 1, nz - 1]))

    from raytracer.utils.native import native_lib

    lib = native_lib()
    if exact:
        if lib is not None and lib.has_grid_sat:
            cell_tris, ov = lib.grid_build(verts.astype(np.float32), tris,
                                           bmin, cell, (nx, ny, nz), capacity,
                                           exact=True)
        else:
            from raytracer.accel.satbin import bin_exact

            cell_tris, ov = bin_exact(verts, tris, bmin, cell, (nx, ny, nz),
                                      capacity)
    elif lib is not None:
        cell_tris, ov = lib.grid_build(verts.astype(np.float32), tris, bmin,
                                       cell, (nx, ny, nz), capacity)
    else:
        ncells = nx * ny * nz
        lists: list[list[int]] = [[] for _ in range(ncells)]
        for i in range(t):
            for cx in range(lo[i, 0], hi[i, 0] + 1):
                for cy in range(lo[i, 1], hi[i, 1] + 1):
                    for cz in range(lo[i, 2], hi[i, 2] + 1):
                        lists[(cx * ny + cy) * nz + cz].append(i)

        cell_tris = np.full((ncells, capacity), t, np.int32)  # sentinel = t
        overflow: set[int] = set()
        for c, ids in enumerate(lists):
            cell_tris[c, : min(len(ids), capacity)] = ids[:capacity]
            overflow.update(ids[capacity:])
        ov = np.asarray(sorted(overflow), np.int32)
    ov_v0 = v0[ov].astype(np.float32) if len(ov) else np.zeros((0, 3), np.float32)
    ov_e1 = ((v1 - v0)[ov].astype(np.float32) if len(ov)
             else np.zeros((0, 3), np.float32))
    ov_e2 = ((v2 - v0)[ov].astype(np.float32) if len(ov)
             else np.zeros((0, 3), np.float32))

    cell_soa = None
    if pregather:
        # [ncells, C, 10]: rows of v0|e1|e2|id per listed triangle; sentinel
        # slots get the zero (degenerate, always-miss) triangle with id = t —
        # identical fp semantics to gathering from the sentinel-padded SoA on
        # device. Ids ride as f32 (exact below 2^24 tris; 9-col fallback +
        # separate id gather above that).
        f32 = np.float32
        # subtract IN f32 (not f64-then-round): tri_soa computes edges in f32
        # on device, and the walk must be bitwise-identical either way
        soa_rows = np.concatenate(
            [v0.astype(f32), v1.astype(f32) - v0.astype(f32),
             v2.astype(f32) - v0.astype(f32)], axis=1)   # [T, 9]
        soa_rows = np.concatenate([soa_rows, np.zeros((1, 9), f32)])
        if t < (1 << 24):
            ids_col = np.arange(t + 1, dtype=f32)[:, None]
            soa_rows = np.concatenate([soa_rows, ids_col], axis=1)  # [T+1,10]
        cell_soa = jnp.asarray(soa_rows[np.minimum(cell_tris, t)])

    return GridData(
        bmin=jnp.asarray(bmin, jnp.float32),
        inv_cell=jnp.asarray(1.0 / cell, jnp.float32),
        cell_size=jnp.asarray(cell, jnp.float32),
        cell_tris=jnp.asarray(cell_tris),
        overflow=jnp.asarray(ov),
        ov_v0=jnp.asarray(ov_v0), ov_e1=jnp.asarray(ov_e1),
        ov_e2=jnp.asarray(ov_e2), cell_soa=cell_soa,
        # slot 0 empty ⇔ cell empty (slots fill front-to-back; overflow only
        # ever spills out of already-full cells)
        cell_occ=jnp.asarray((cell_tris[:, 0] != t).astype(np.int8)),
        res=(nx, ny, nz), capacity=capacity, n_tris=t)


def _pad_soa(v0, e1, e2):
    """Append the sentinel degenerate triangle (always misses) at index T."""
    z = jnp.zeros((1, 3), v0.dtype)
    return (jnp.concatenate([v0, z]), jnp.concatenate([e1, z]),
            jnp.concatenate([e2, z]))


def _eval_tris(orig, direc, tids, v0p, e1p, e2p, t_min):
    """MT over gathered triangle ids [N,C] → (t [N,C])."""
    tv0 = v0p[tids]
    te1 = e1p[tids]
    te2 = e2p[tids]
    t, _, _ = geom.triangle_tuv(orig[:, None, :], direc[:, None, :], tv0, te1,
                                te2, t_min)
    return t


def _eval_candidates(orig, direc, idx, soa, tids_tab, v0p, e1p, e2p, t_min):
    """Candidate eval at table rows `idx` [N] or [N,K] → (ts, tids).

    Shape follows idx: [N] → ([N,C], [N,C]); [N,K] → ([N,K·C], [N,K·C]) —
    K table rows gathered per lane in ONE gather op and flattened into the
    candidate axis (the fanout walk's whole point: fewer gather ops per
    candidate).

    Shared by the grid DDA and BVH walks. Three layouts, identical fp:
    10-col pre-gathered SoA (ids ride column 9; ONE gather), 9-col SoA
    (+ separate id gather), or id gather + per-vertex gathers.
    """
    n = orig.shape[0]
    if soa is not None and soa.shape[-1] == 10:
        s = soa[idx].reshape(n, -1, 10)
        tids = s[..., 9].astype(jnp.int32)
        ts, _, _ = geom.triangle_tuv(
            orig[:, None, :], direc[:, None, :], s[..., 0:3], s[..., 3:6],
            s[..., 6:9], t_min)
    elif soa is not None:
        tids = tids_tab[idx].reshape(n, -1)
        s = soa[idx].reshape(n, -1, 9)
        ts, _, _ = geom.triangle_tuv(
            orig[:, None, :], direc[:, None, :], s[..., 0:3], s[..., 3:6],
            s[..., 6:9], t_min)
    else:
        tids = tids_tab[idx].reshape(n, -1)
        ts = _eval_tris(orig, direc, tids, v0p, e1p, e2p, t_min)
    return ts, tids


def walk_init(grid: GridData, orig, direc, t_min, active=None):
    """Shared DDA entry state (overflow brute seed + slab entry + first cell).

    Extracted so every walk backend (the classic while_loop walk and the
    visit-list walk) starts from BITWISE-identical state.
    → (best_t, best_i, cell [N,3] i32, tmax [N,3], step [N,3] i32,
       tdelta [N,3], active [N] bool)
    """
    n = orig.shape[0]
    nx, ny, nz = grid.res
    resv = jnp.asarray([nx, ny, nz], jnp.int32)

    best_t = jnp.full((n,), INF, jnp.float32)
    best_i = jnp.full((n,), grid.n_tris, jnp.int32)

    # overflow list: brute once (tiny; pre-gathered SoA so XLA fuses the
    # [N,O] candidate matrix into the reduce instead of materializing gathers)
    if grid.overflow.shape[0]:
        ts, _, _ = geom.triangle_hits(orig, direc, grid.ov_v0, grid.ov_e1,
                                      grid.ov_e2, t_min)
        if active is not None:  # parked lanes must return miss/INF (contract)
            ts = jnp.where(jax.lax.stop_gradient(active)[:, None], ts, INF)
        best_t = jnp.min(ts, axis=1)
        best_i = jnp.where(jnp.isinf(best_t), grid.n_tris,
                           grid.overflow[jnp.argmin(ts, axis=1)])

    # ray/AABB slab entry
    bmax = grid.bmin + grid.cell_size * resv.astype(jnp.float32)
    inv_d = jnp.where(jnp.abs(direc) > 1e-12, 1.0 / direc, 1e12)
    t0 = (grid.bmin[None, :] - orig) * inv_d
    t1 = (bmax[None, :] - orig) * inv_d
    tlo = jnp.minimum(t0, t1).max(axis=1)
    thi = jnp.maximum(t0, t1).min(axis=1)
    t_entry = jnp.maximum(tlo, 0.0)
    inside = (thi >= t_entry) & (thi > 0)
    if active is not None:
        inside &= jax.lax.stop_gradient(active)

    p_entry = orig + (t_entry + 1e-5)[:, None] * direc
    cellf = (p_entry - grid.bmin[None, :]) * grid.inv_cell[None, :]
    cell = jnp.clip(jnp.floor(cellf).astype(jnp.int32), 0, resv - 1)
    step = jnp.where(direc > 0, 1, -1).astype(jnp.int32)
    tdelta = jnp.abs(grid.cell_size[None, :] * inv_d)
    next_bound = (grid.bmin[None, :]
                  + (cell + (step > 0)).astype(jnp.float32)
                  * grid.cell_size[None, :])
    tmax = jnp.where(jnp.abs(direc) > 1e-12,
                     (next_bound - orig) * inv_d, INF)
    return best_t, best_i, cell, tmax, step, tdelta, inside


def grid_walk(grid: GridData, v0, e1, e2, orig, direc, t_min,
              occlusion_max_t=None, fixed_steps: bool = False,
              skip_steps: int | None = None, active=None,
              fanout: int | None = None):
    """Vectorized DDA over all rays → (best_t [N], best_idx [N]).

    With `occlusion_max_t` given, lanes park as soon as any hit < max_t is
    found (any-hit mode); best_t < max_t then means occluded.
    `active` [N] bool masks lanes out of the walk entirely (they return
    miss/INF): the wavefront renderer passes its alive/diffuse masks so dead
    lanes — whose zero-normal "reflections" re-enter the grid every bounce —
    stop driving the while_loop trip count. Active lanes' results are
    bitwise-unchanged.
    `fixed_steps=True` runs a static-trip fori_loop instead of the
    data-dependent while_loop (identical results; a robustness fallback for
    runtimes that mishandle dynamic trip counts, at the cost of always
    walking the worst-case step count).
    `skip_steps=S` (env RT_GRID_SKIP) prepends S empty-cell fast-forward
    substeps to each iteration: a lane whose cell lists no triangles advances
    on a 1-byte `cell_occ` gather instead of paying the full C-slot candidate
    gather — results are bitwise identical (empty-cell evals only ever fold
    INF), it just spends the expensive gathers on occupied cells. Whether
    it pays depends on the tile width; S=0 is the default (not yet
    re-tuned on the GPU).

    `fanout=K` (env RT_GRID_FANOUT, default 1) evaluates K consecutive DDA
    cells per loop iteration with ONE batched candidate gather ([N,K] rows)
    instead of K separate gathers. Lanes may
    overrun their parking cell by up to K-1 cells; the extra candidates are
    real intersections at t ≥ best_t (AABB/SAT binning both list a triangle
    in every cell containing one of its hit points), so results are identical
    up to the usual exact-t knife-edge tie association — the same class the
    golden tests already tolerate for RT_GRID_EXACT.

    NOTE on trace-time env reads: `skip_steps`/`fixed_steps`/`fanout` fall
    back to env at trace time, so inside one process a flag change after the
    first jit of a given shape is ignored (cached executable). GridTracer
    resolves them at build time instead; prefer rebuilding the tracer to
    mutating env.
    """
    import os

    if skip_steps is None:
        skip_steps = int(os.environ.get("RT_GRID_SKIP", 0))
    if fanout is None:
        fanout = int(os.environ.get("RT_GRID_FANOUT", 1))
    fanout = max(1, fanout)
    n = orig.shape[0]
    nx, ny, nz = grid.res
    resv = jnp.asarray([nx, ny, nz], jnp.int32)
    v0p, e1p, e2p = _pad_soa(v0, e1, e2)

    best_t, best_i, cell, tmax, step, tdelta, active = walk_init(
        grid, orig, direc, t_min, active)
    max_steps = nx + ny + nz + 2
    # each iteration advances `fanout` cells (K-1 intra-batch + 1 post-fold)
    max_iters = -(-max_steps // fanout)
    # RT_GRID_ITER_CAP (DEBUG/PROFILING ONLY): cap the walk's iteration
    # budget to measure per-iteration marginal cost (benchmarks/walk_cost).
    # Under-walking truncates grazing rays => WRONG images; never set in
    # production.
    cap = int(os.environ.get("RT_GRID_ITER_CAP", 0))
    if cap > 0:
        max_iters = min(max_iters, cap)

    def parked(best_t, tmax_min):
        if occlusion_max_t is not None:
            # any-hit: done once occluded, or once the walk passed the light
            return (best_t < occlusion_max_t) | (tmax_min > occlusion_max_t)
        return best_t <= tmax_min

    def cond(state):
        it, cell, tmax, best_t, best_i, active = state
        return jnp.any(active) & (it < max_iters)

    def dda_step(cell, tmax, may):
        """Advance `may` lanes one cell; returns (cell', tmax', still_in)."""
        axis = jnp.argmin(tmax, axis=1)
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        cell_n = cell + onehot * step
        tmax_n = tmax + onehot.astype(tmax.dtype) * tdelta
        out = jnp.any((cell_n < 0) | (cell_n >= resv[None, :]), axis=1)
        cell = jnp.where(may[:, None], cell_n, cell)
        tmax = jnp.where(may[:, None], tmax_n, tmax)
        return cell, tmax, ~(may & out)

    def body(state):
        it, cell, tmax, best_t, best_i, active = state
        for _ in range(skip_steps):
            cid = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
            occ = grid.cell_occ[jnp.where(active, cid, 0)] > 0
            done = parked(best_t, jnp.min(tmax, axis=1))
            may = active & ~done & ~occ
            cell, tmax, still_in = dda_step(cell, tmax, may)
            active &= still_in
        # collect `fanout` consecutive cells; intra-batch advances use the
        # pre-batch best_t (stale ⇒ only ever UNDER-parks: best_t shrinks
        # monotonically, so no lane stops before the sequential walk would —
        # it just overruns ≤ K-1 cells and folds extra real candidates)
        cids, masks = [], []
        for _ in range(fanout - 1):
            cids.append(jnp.where(active,
                                  (cell[:, 0] * ny + cell[:, 1]) * nz
                                  + cell[:, 2], 0))
            masks.append(active)
            may = active & ~parked(best_t, jnp.min(tmax, axis=1))
            cell, tmax, still_in = dda_step(cell, tmax, may)
            active = may & still_in
        cid = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
        cids.append(jnp.where(active, cid, 0))
        masks.append(active)
        idx = jnp.stack(cids, axis=1) if fanout > 1 else cids[0]
        ts, tids = _eval_candidates(orig, direc, idx, grid.cell_soa,
                                    grid.cell_tris, v0p, e1p, e2p, t_min)
        if fanout > 1:  # [N, K·C]: mask each sub-cell's span by its own mask
            mask = jnp.repeat(jnp.stack(masks, axis=1),
                              ts.shape[1] // fanout, axis=1)
        else:
            mask = jnp.broadcast_to(active[:, None], ts.shape)
        ts = jnp.where(mask, ts, INF)
        tc = jnp.min(ts, axis=1)
        # winner id without a per-step gather: lowest id among the t-minima —
        # identical to argmin-first (cell lists are ascending-id by build)
        ic = jnp.min(jnp.where(ts <= tc[:, None], tids, grid.n_tris), axis=1)
        # SPEC tie order on exact-t ties ACROSS steps too (lowest id wins,
        # not first-found) — removes visit-order dependence within the walk
        better = (tc < best_t) | ((tc == best_t) & (ic < best_i))
        best_t = jnp.where(better, tc, best_t)
        best_i = jnp.where(better, ic, best_i)

        done = parked(best_t, jnp.min(tmax, axis=1))
        advance = active & ~done
        cell, tmax, still_in = dda_step(cell, tmax, advance)
        active = advance & still_in
        return it + 1, cell, tmax, best_t, best_i, active

    scope = ("grid_walk_occl" if occlusion_max_t is not None
             else "grid_walk")
    with jax.named_scope(scope):
        return _run_walk(cond, body, cell, tmax, best_t, best_i, active,
                         fixed_steps, max_iters)


def grid_walk_visit(grid: GridData, v0, e1, e2, orig, direc, t_min,
                    occlusion_max_t=None, active=None,
                    scan_fanout: int | None = None,
                    eval_fanout: int | None = None):
    """Two-phase visit-list DDA → (best_t [N], best_idx [N]).

    The classic walk (grid_walk) interleaves traversal and evaluation: every
    while-iteration gathers a full [N, capacity] candidate row (~5 KB/lane at
    the shipping cap-128 grid) even when the lane's cell is EMPTY — and at
    density 0.125 most DDA steps land in empty cells, while occupied cells
    average ~41 listed triangles against the 128-slot padding. This variant
    decouples the two:

      phase 1 (thin): pure DDA over the whole traversal, gathering only the
        1-byte `cell_occ` flag per step; occupied-cell ids and their exit t
        are recorded into per-lane visit lists [N, V] (V = nx+ny+nz+2, the
        static max — exact by construction, no overflow case). Lanes run to
        grid exit (nearest) or past the light (occlusion): without t's there
        is no early-park, but each iteration moves ~3 orders of magnitude
        fewer bytes.
      phase 2 (fat): a while_loop over VISIT SLOTS — gather + Möller–Trumbore
        the [N, capacity] candidates of visit j, fold, and park exactly like
        the classic walk (best_t <= exit_t of the just-evaluated cell; any-hit
        parks on best_t < max_t). Trip count = the max number of OCCUPIED
        cells any live lane must actually evaluate (mean ~5 on config4) —
        empty cells never reach this loop.

    Per-candidate arithmetic, gather shapes, fold order, and the cross-step
    lowest-id tie rule are identical to grid_walk, so results are BITWISE
    equal (tests assert exact equality), knife edges included.

    `scan_fanout=K` (env RT_VISIT_FANOUT, default 1) advances K cells per
    phase-1 while-iteration: where the walk cost is a per-ITERATION fixed
    cost and the phase-1 body is thin (1-byte occ gathers), batching thin
    steps divides the iteration count nearly for free. Results identical
    for any K.

    `eval_fanout=J` (env RT_VISIT_EVAL_FANOUT, default 1) evaluates J visit
    slots per phase-2 iteration: ONE batched [N, J·C] candidate gather, then
    J SEQUENTIAL masked sub-folds with park checks between them — lanes that
    park mid-batch mask the remaining sub-folds to INF, so results stay
    bitwise identical (unlike the classic walk's fanout overrun).
    """
    import os

    if scan_fanout is None:
        scan_fanout = int(os.environ.get("RT_VISIT_FANOUT", 1))
    scan_fanout = max(1, scan_fanout)
    if eval_fanout is None:
        eval_fanout = int(os.environ.get("RT_VISIT_EVAL_FANOUT", 1))
    eval_fanout = max(1, eval_fanout)
    n = orig.shape[0]
    nx, ny, nz = grid.res
    resv = jnp.asarray([nx, ny, nz], jnp.int32)
    v0p, e1p, e2p = _pad_soa(v0, e1, e2)

    best_t, best_i, cell, tmax, step, tdelta, act0 = walk_init(
        grid, orig, direc, t_min, active)
    V = nx + ny + nz + 2
    col = jnp.arange(V, dtype=jnp.int32)[None, :]

    def dda_step(cell, tmax, may):
        axis = jnp.argmin(tmax, axis=1)
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        cell_n = cell + onehot * step
        tmax_n = tmax + onehot.astype(tmax.dtype) * tdelta
        out = jnp.any((cell_n < 0) | (cell_n >= resv[None, :]), axis=1)
        cell = jnp.where(may[:, None], cell_n, cell)
        tmax = jnp.where(may[:, None], tmax_n, tmax)
        return cell, tmax, ~(may & out)

    # ---- phase 1: record occupied-cell visits ---------------------------
    def cond1(s):
        it, cell, tmax, act, visited, exit_t, vcount = s
        return jnp.any(act) & (it < V)

    def substep(cell, tmax, act, visited, exit_t, vcount):
        cid = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
        occ = grid.cell_occ[jnp.where(act, cid, 0)] > 0
        t_exit = jnp.min(tmax, axis=1)
        rec = act & occ
        m = rec[:, None] & (col == vcount[:, None])
        visited = jnp.where(m, cid[:, None], visited)
        exit_t = jnp.where(m, t_exit[:, None], exit_t)
        vcount = vcount + rec.astype(jnp.int32)
        if occlusion_max_t is not None:
            # the cell whose exit lies past the light is still recorded
            # (classic walk evaluates it before parking); stop advancing after
            act = act & (t_exit <= occlusion_max_t)
        else:
            # conservative park on the PRE-walk best (overflow-brute hit):
            # the running best in phase 2 can only be nearer, so any lane the
            # classic walk parks here is parked no later — the current cell
            # was already recorded above, matching classic's park-after-eval
            act = act & (best_t > t_exit)
        cell, tmax, still_in = dda_step(cell, tmax, act)
        act = act & still_in
        return cell, tmax, act, visited, exit_t, vcount

    def body1(s):
        it, cell, tmax, act, visited, exit_t, vcount = s
        for _ in range(scan_fanout):
            cell, tmax, act, visited, exit_t, vcount = substep(
                cell, tmax, act, visited, exit_t, vcount)
        return it + scan_fanout, cell, tmax, act, visited, exit_t, vcount

    visited = jnp.zeros((n, V), jnp.int32)
    exit_t = jnp.full((n, V), INF, jnp.float32)
    vcount = jnp.zeros((n,), jnp.int32)
    act1 = act0
    if occlusion_max_t is not None:
        act1 = act1 & ~(best_t < occlusion_max_t)  # brute already occluded
    with jax.named_scope("grid_visit_scan"):
        _, _, _, _, visited, exit_t, vcount = jax.lax.while_loop(
            cond1, body1, (jnp.zeros((), jnp.int32), cell, tmax, act1,
                           visited, exit_t, vcount))

    # ---- phase 2: evaluate the visit lists ------------------------------
    def parked(best_t):
        if occlusion_max_t is not None:
            return best_t < occlusion_max_t
        return jnp.zeros_like(best_t, bool)

    done0 = ~act0 | (vcount == 0) | parked(best_t)
    J = eval_fanout
    if J > 1:  # pad visit columns so the J-wide dynamic slice never clamps
        visited = jnp.concatenate(
            [visited, jnp.zeros((n, J), jnp.int32)], axis=1)
        exit_t = jnp.concatenate(
            [exit_t, jnp.full((n, J), INF, jnp.float32)], axis=1)

    def cond2(s):
        j, best_t, best_i, done = s
        return jnp.any(~done) & (j < V)

    def body2(s):
        j, best_t, best_i, done = s
        cids = jax.lax.dynamic_slice_in_dim(visited, j, J, axis=1)
        ets = jax.lax.dynamic_slice_in_dim(exit_t, j, J, axis=1)
        idx = cids if J > 1 else cids[:, 0]
        live0 = ~done & (j < vcount)
        idx = jnp.where((live0[:, None] if J > 1 else live0), idx, 0)
        ts, tids = _eval_candidates(orig, direc, idx, grid.cell_soa,
                                    grid.cell_tris, v0p, e1p, e2p, t_min)
        c2 = ts.shape[1] // J
        # J sequential masked sub-folds: lanes parking mid-batch mask the
        # remaining sub-slots to INF — bitwise the one-visit-per-iteration
        # schedule (extra gathered rows never fold)
        for jj in range(J):
            live = ~done & (j + jj < vcount)
            tsj = jnp.where(live[:, None], ts[:, jj * c2:(jj + 1) * c2], INF)
            tc = jnp.min(tsj, axis=1)
            ic = jnp.min(jnp.where(tsj <= tc[:, None],
                                   tids[:, jj * c2:(jj + 1) * c2],
                                   grid.n_tris), axis=1)
            better = (tc < best_t) | ((tc == best_t) & (ic < best_i))
            best_t = jnp.where(better, tc, best_t)
            best_i = jnp.where(better, ic, best_i)
            done |= (best_t <= ets[:, jj]) | parked(best_t) \
                | (j + jj + 1 >= vcount)
        return j + J, best_t, best_i, done

    scope = ("grid_visit_eval_occl" if occlusion_max_t is not None
             else "grid_visit_eval")
    with jax.named_scope(scope):
        _, best_t, best_i, _ = jax.lax.while_loop(
            cond2, body2, (jnp.zeros((), jnp.int32), best_t, best_i, done0))
    return best_t, best_i


def _run_walk(cond, body, cell, tmax, best_t, best_i, active, fixed_steps,
              max_iters):
    state = (jnp.zeros((), jnp.int32), cell, tmax, best_t, best_i, active)
    if fixed_steps:
        # max_iters (not max_steps): each body advances `fanout` cells, so
        # the static trip count must match the while_loop's iteration budget
        # or the fallback does ~K× the necessary gather work under fanout
        state = jax.lax.fori_loop(0, max_iters,
                                  lambda _, s: body(s), state)
    else:
        state = jax.lax.while_loop(cond, body, state)
    _, _, _, best_t, best_i, _ = state
    return best_t, best_i


class GridTracer:
    """Drop-in tracer: grid-accelerated triangles + brute spheres/planes.

    Built on host from a concrete scene (`GridTracer.build(scene)`); the
    resulting object is a pytree-of-arrays closure safe to pass through jit.
    """

    def __init__(self, scene, grid: GridData, fixed_steps: bool | None = None,
                 skip_steps: int | None = None, fanout: int | None = None,
                 walk: str | None = None):
        import os

        from raytracer.core.types import as_jax

        self._scene = as_jax(scene)
        self._grid = grid
        if fixed_steps is None:
            fixed_steps = bool(os.environ.get("RT_GRID_FIXED_STEPS"))
        self._fixed = fixed_steps
        # resolved at BUILD time (not trace time) so a rebuilt tracer always
        # reflects the current env even under jit caching
        if skip_steps is None:
            skip_steps = int(os.environ.get("RT_GRID_SKIP", 0))
        self._skip = skip_steps
        # occlusion walks get their OWN skip count (RT_GRID_OCCL_SKIP,
        # default = the nearest walk's): shadow rays toward the lights cross
        # disproportionately many EMPTY cells (the lights sit above the
        # scene), so the empty-cell fast-forward can pay there even where it
        # loses on nearest walks — results bitwise identical for any S
        # (empty-cell evals only ever fold INF)
        self._oskip = int(os.environ.get("RT_GRID_OCCL_SKIP", self._skip))
        if fanout is None:
            fanout = int(os.environ.get("RT_GRID_FANOUT", 1))
        self._fanout = max(1, fanout)
        # walk backend: 'xla' (the classic interleaved while_loop walk) or
        # 'visit' (two-phase visit-list walk — thin traversal + fat eval of
        # only the occupied-cell visits, see grid_walk_visit)
        walk = walk or "xla"
        assert walk in ("xla", "visit"), walk
        self._walk = walk
        v0, e1, e2 = self._scene.meshes.tri_soa()
        self._soa = jax.lax.stop_gradient((jnp.asarray(v0, jnp.float32),
                                           jnp.asarray(e1, jnp.float32),
                                           jnp.asarray(e2, jnp.float32)))

    @staticmethod
    def build(scene, capacity: int | None = None, res=None,
              density: float | None = None, fixed_steps: bool | None = None,
              pregather: bool | None = None, exact: bool | None = None,
              fanout: int | None = None, walk: str | None = None):
        import os

        # env overrides so perf sweeps (benchmarks/) can tune the build
        # without plumbing flags through every harness. Defaults (capacity
        # 128 / density 0.125 / pregather on) are the benchmarks/
        # grid_sweep.py winner on the accelerator this was first tuned on:
        # a coarse grid with fat cell rows trades per-row price for fewer
        # DDA iterations. Not yet re-tuned on the GPU (ROADMAP Queue 1).
        if pregather is None:
            pregather = os.environ.get("RT_GRID_PREGATHER", "1") \
                not in ("", "0")
        capacity_defaulted = capacity is None
        if capacity is None:
            capacity = int(os.environ.get("RT_GRID_CAPACITY", 128))
        if density is None:
            # the knobs were co-tuned, so pregather-off falls back to the
            # fine density 4 with its matching capacity
            density = float(os.environ.get("RT_GRID_DENSITY",
                                           0.125 if pregather else 4.0))
        if (not pregather and capacity_defaulted
                and "RT_GRID_CAPACITY" not in os.environ):
            capacity = 16
        if res is None and os.environ.get("RT_GRID_RES"):
            res = tuple(int(x) for x in os.environ["RT_GRID_RES"].split(","))
        grid = build_grid(np.asarray(scene.meshes.verts),
                          np.asarray(scene.meshes.tris), res=res,
                          capacity=capacity, density=density,
                          pregather=pregather, exact=exact)
        return GridTracer(scene, grid, fixed_steps=fixed_steps, fanout=fanout,
                          walk=walk)

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        from raytracer.core.types import KIND_TRIANGLE
        from raytracer.ops import trace as trace_ops

        orig = jax.lax.stop_gradient(orig)
        direc = jax.lax.stop_gradient(direc)
        # spheres + planes via the standard search on a mesh-less scene
        base = trace_ops.nearest_hit(
            self._scene.replace(meshes=_EMPTY_MESHES), orig, direc, t_min,
            tri_chunk)
        v0, e1, e2 = self._soa
        if self._walk == "visit":
            tb, ib = grid_walk_visit(self._grid, v0, e1, e2, orig, direc,
                                     t_min, active=active)
        else:
            tb, ib = grid_walk(self._grid, v0, e1, e2, orig, direc, t_min,
                               fixed_steps=self._fixed, skip_steps=self._skip,
                               active=active, fanout=self._fanout)
        better = tb < base.t
        return trace_ops.Hit(
            kind=jnp.where(better, KIND_TRIANGLE, base.kind),
            idx=jnp.where(better, ib, base.idx),
            t=jnp.where(better, tb, base.t))

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        from raytracer.ops import trace as trace_ops

        orig = jax.lax.stop_gradient(orig)
        direc = jax.lax.stop_gradient(direc)
        max_t = jax.lax.stop_gradient(max_t)
        occ = trace_ops.occluded(self._scene.replace(meshes=_EMPTY_MESHES),
                                 orig, direc, max_t, t_min, tri_chunk)
        v0, e1, e2 = self._soa
        if self._walk == "visit":
            tb, _ = grid_walk_visit(self._grid, v0, e1, e2, orig, direc,
                                    t_min, occlusion_max_t=max_t,
                                    active=active)
        else:
            tb, _ = grid_walk(self._grid, v0, e1, e2, orig, direc, t_min,
                              occlusion_max_t=max_t, fixed_steps=self._fixed,
                              skip_steps=self._oskip, active=active,
                              fanout=self._fanout)
        return occ | (tb < max_t)


from raytracer.core.types import Meshes as _Meshes  # noqa: E402

_EMPTY_MESHES = _Meshes.empty()

jax.tree_util.register_pytree_node(
    GridTracer,
    lambda tr: ((tr._scene, tr._grid, tr._soa),
                (tr._fixed, tr._skip, tr._oskip, tr._fanout, tr._walk)),
    lambda aux, ch: _grid_tracer_unflatten(aux, ch))


def _grid_tracer_unflatten(aux, children):
    scene, grid, soa = children
    obj = GridTracer.__new__(GridTracer)
    obj._scene = scene
    obj._grid = grid
    obj._soa = soa
    obj._fixed, obj._skip, obj._oskip, obj._fanout, obj._walk = aux
    return obj
