"""Pluggable trace backends: local, primitive-sharded, and ring-streaming.

The winner *search* (integer residuals, stop-gradient — ops/trace.py) is the
only stage that touches every primitive, so it is the only stage that shards.
The differentiable surface recompute gathers just the per-ray winner from the
replicated scene, so gradients are identical across all tracers — the sharded
paths change where FLOPs run, not the math (SURVEY.md §2.3).

TraceGeom is the search-only SoA (triangles pre-expanded to v0/e1/e2): it is
what gets padded, sharded over the 'prims' mesh axis, or rotated around the
ICI ring. Padding uses far-away/degenerate primitives that can never win.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.core.types import (
    KIND_NONE, KIND_PLANE, KIND_SPHERE, KIND_TRIANGLE, Scene)
from raytracer.ops import geometry as geom
from raytracer.ops import trace as trace_ops

INF = jnp.inf


@dataclasses.dataclass
class TraceGeom:
    """Search-only geometry SoA (stop-gradient by construction)."""

    sph_c: jax.Array   # [Ns,3]
    sph_r: jax.Array   # [Ns]
    pl_p: jax.Array    # [Np,3]
    pl_n: jax.Array    # [Np,3]
    tri_v0: jax.Array  # [T,3]
    tri_e1: jax.Array  # [T,3]
    tri_e2: jax.Array  # [T,3]


jax.tree_util.register_dataclass(
    TraceGeom,
    data_fields=["sph_c", "sph_r", "pl_p", "pl_n", "tri_v0", "tri_e1",
                 "tri_e2"],
    meta_fields=[])


def build_trace_geom(scene: Scene) -> TraceGeom:
    v0, e1, e2 = scene.meshes.tri_soa() if scene.meshes.count else (
        jnp.zeros((0, 3)), jnp.zeros((0, 3)), jnp.zeros((0, 3)))
    g = TraceGeom(scene.spheres.center, scene.spheres.radius,
                  scene.planes.point, scene.planes.normal,
                  jnp.asarray(v0, jnp.float32), jnp.asarray(e1, jnp.float32),
                  jnp.asarray(e2, jnp.float32))
    return jax.lax.stop_gradient(g)


def _ceil_to(x: int, m: int) -> int:
    return -(-max(x, 0) // m) * m


def pad_trace_geom(g: TraceGeom, p: int) -> TraceGeom:
    """Pad each group to a multiple of p shards with can't-win primitives:
    negative-radius spheres (masked in sphere_t), zero-normal planes and
    zero-area triangles (always miss)."""

    def pad(a, n, fill=0.0):
        extra = n - a.shape[0]
        if extra <= 0:
            return a
        return jnp.concatenate(
            [a, jnp.full((extra,) + a.shape[1:], fill, a.dtype)])

    ns = _ceil_to(g.sph_c.shape[0], p)
    npl = _ceil_to(g.pl_p.shape[0], p)
    nt = _ceil_to(g.tri_v0.shape[0], p)
    return TraceGeom(
        pad(g.sph_c, ns, 0.0), pad(g.sph_r, ns, -1.0),
        pad(g.pl_p, npl, 0.0), pad(g.pl_n, npl, 0.0),
        pad(g.tri_v0, nt, 0.0), pad(g.tri_e1, nt, 0.0),
        pad(g.tri_e2, nt, 0.0))


def geom_pspec(prims_axis: str):
    """PartitionSpec pytree sharding every TraceGeom leaf along its prim dim."""
    from jax.sharding import PartitionSpec as P

    return TraceGeom(P(prims_axis, None), P(prims_axis), P(prims_axis, None),
                     P(prims_axis, None), P(prims_axis, None),
                     P(prims_axis, None), P(prims_axis, None))


def accel_pspec(prims_axis: str):
    """PartitionSpec dict for the stacked per-shard BVH arrays
    (accel.bvh.build_stacked_bvh): leading dim = shard."""
    from jax.sharding import PartitionSpec as P

    return {"aabb_min": P(prims_axis, None, None),
            "aabb_max": P(prims_axis, None, None),
            "leaf_tris": P(prims_axis, None, None),
            "hit_link": P(prims_axis, None),
            "miss_link": P(prims_axis, None)}


def _local_bvh(g: TraceGeom, accel, accel_meta):
    """Local slice of the stacked per-shard BVH → BVHData over g's tris."""
    from raytracer.accel.bvh import BVHData

    n_nodes, capacity, ts = accel_meta
    return BVHData(
        aabb_min=accel["aabb_min"][0], aabb_max=accel["aabb_max"][0],
        leaf_tris=accel["leaf_tris"][0], hit_link=accel["hit_link"][0],
        miss_link=accel["miss_link"][0], leaf_soa=None,
        n_nodes=n_nodes, capacity=capacity, n_tris=ts)


def _local_nearest(g: TraceGeom, orig, direc, t_min: float, tri_chunk: int,
                   accel=None, accel_meta=None, active=None):
    """Nearest-hit over a TraceGeom → Hit with *local* indices.
    `active` masks lanes out of the BVH walk only (dynamic trip count); the
    dense scans are static so masking them saves nothing."""
    n = orig.shape[0]
    best_t = jnp.full((n,), INF, jnp.float32)
    kind = jnp.full((n,), KIND_NONE, jnp.int32)
    idx = jnp.zeros((n,), jnp.int32)
    if g.sph_c.shape[0]:
        ts = geom.sphere_hits(orig, direc, g.sph_c, g.sph_r, t_min)
        tb = jnp.min(ts, axis=1)
        ib = jnp.argmin(ts, axis=1).astype(jnp.int32)
        better = tb < best_t
        best_t, kind, idx = (jnp.where(better, tb, best_t),
                             jnp.where(better, KIND_SPHERE, kind),
                             jnp.where(better, ib, idx))
    if g.pl_p.shape[0]:
        ts = geom.plane_hits(orig, direc, g.pl_p, g.pl_n, t_min)
        tb = jnp.min(ts, axis=1)
        ib = jnp.argmin(ts, axis=1).astype(jnp.int32)
        better = tb < best_t
        best_t, kind, idx = (jnp.where(better, tb, best_t),
                             jnp.where(better, KIND_PLANE, kind),
                             jnp.where(better, ib, idx))
    if g.tri_v0.shape[0]:
        if accel is not None:
            from raytracer.accel.bvh import bvh_walk

            tb, ib = bvh_walk(_local_bvh(g, accel, accel_meta), g.tri_v0,
                              g.tri_e1, g.tri_e2, orig, direc, t_min,
                              active=active)
        else:
            tb, ib = trace_ops._scan_tri_nearest(orig, direc, g.tri_v0,
                                                 g.tri_e1, g.tri_e2, t_min,
                                                 tri_chunk)
        better = tb < best_t
        best_t, kind, idx = (jnp.where(better, tb, best_t),
                             jnp.where(better, KIND_TRIANGLE, kind),
                             jnp.where(better, ib, idx))
    return trace_ops.Hit(kind=kind, idx=idx, t=best_t)


def _local_occluded(g: TraceGeom, orig, direc, max_t, t_min: float,
                    tri_chunk: int, accel=None, accel_meta=None, active=None):
    n = orig.shape[0]
    occ = jnp.zeros((n,), bool)
    if g.sph_c.shape[0]:
        ts = geom.sphere_hits(orig, direc, g.sph_c, g.sph_r, t_min)
        occ |= jnp.any(ts < max_t[:, None], axis=1)
    if g.pl_p.shape[0]:
        ts = geom.plane_hits(orig, direc, g.pl_p, g.pl_n, t_min)
        occ |= jnp.any(ts < max_t[:, None], axis=1)
    if g.tri_v0.shape[0]:
        if accel is not None:
            from raytracer.accel.bvh import bvh_walk

            tb, _ = bvh_walk(_local_bvh(g, accel, accel_meta), g.tri_v0,
                             g.tri_e1, g.tri_e2, orig, direc, t_min,
                             occlusion_max_t=max_t, active=active)
            occ |= tb < max_t
        else:
            occ |= trace_ops._scan_tri_occluded(orig, direc, g.tri_v0,
                                                g.tri_e1, g.tri_e2, t_min,
                                                max_t, tri_chunk)
    return occ


def _globalize(hit, shard_sizes, shard_index):
    """Local shard indices → indices into the padded full scene."""
    off = jnp.where(
        hit.kind == KIND_SPHERE, shard_index * shard_sizes[0],
        jnp.where(hit.kind == KIND_PLANE, shard_index * shard_sizes[1],
                  jnp.where(hit.kind == KIND_TRIANGLE,
                            shard_index * shard_sizes[2], 0)))
    return dataclasses.replace(hit, idx=hit.idx + off.astype(jnp.int32))


def _fold_hit(best, hit):
    """Lexicographic (t, kind, idx) min — the exact single-device tie order
    (sphere < plane < triangle, then lower index). Exact ties are real here:
    rays hitting a shared triangle edge (e.g. a wall-quad diagonal) register
    identical t in both triangles, which may live in different shards."""
    tie = hit.t == best.t
    better = (hit.t < best.t) | (tie & ((hit.kind < best.kind)
              | ((hit.kind == best.kind) & (hit.idx < best.idx))))
    return trace_ops.Hit(kind=jnp.where(better, hit.kind, best.kind),
                         idx=jnp.where(better, hit.idx, best.idx),
                         t=jnp.where(better, hit.t, best.t))


def _combine_gathered(t_all, kind_all, idx_all):
    """[P,N] partial hits → per-ray winner in (t, kind, idx) order."""
    best = trace_ops.Hit(kind=kind_all[0], idx=idx_all[0], t=t_all[0])
    for p in range(1, t_all.shape[0]):
        best = _fold_hit(best, trace_ops.Hit(kind=kind_all[p], idx=idx_all[p],
                                             t=t_all[p]))
    return best


class ShardTracer:
    """Primitive sharding (TP-analog): each device searches its shard of the
    padded TraceGeom; partial (t, kind, idx) all_gather + min-combine over the
    'prims' mesh axis (SURVEY §2.3 row 2)."""

    def __init__(self, local_geom: TraceGeom, axis: str, shard_sizes,
                 accel=None, accel_meta=None):
        self._g = local_geom
        self._axis = axis
        self._sizes = shard_sizes  # (spheres, planes, tris) per shard
        self._accel = accel        # stacked-BVH local slice (accel_pspec)
        self._accel_meta = accel_meta

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        me = jax.lax.axis_index(self._axis)
        hit = _local_nearest(self._g, orig, direc, t_min, tri_chunk,
                             self._accel, self._accel_meta, active=active)
        hit = _globalize(hit, self._sizes, me)
        t_all = jax.lax.all_gather(hit.t, self._axis)
        kind_all = jax.lax.all_gather(hit.kind, self._axis)
        idx_all = jax.lax.all_gather(hit.idx, self._axis)
        return _combine_gathered(t_all, kind_all, idx_all)

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        occ = _local_occluded(self._g, orig, direc, max_t, t_min, tri_chunk,
                              self._accel, self._accel_meta, active=active)
        return jax.lax.psum(occ.astype(jnp.int32), self._axis) > 0


class RingTracer:
    """Ring primitive streaming (the ring-attention analog, SURVEY §2.3 row 3):
    rays stay resident; the primitive shard rotates around the mesh axis via
    `ppermute`, folding a running min-hit each step. Use when the scene exceeds
    per-chip HBM — only one shard is resident per step."""

    def __init__(self, local_geom: TraceGeom, axis: str, shard_sizes,
                 num_shards: int, accel=None, accel_meta=None):
        self._g = local_geom
        self._axis = axis
        self._sizes = shard_sizes
        self._p = num_shards
        self._accel = accel        # rotates around the ring with the geometry
        self._accel_meta = accel_meta

    def _perm(self):
        return [(i, (i + 1) % self._p) for i in range(self._p)]

    def _rotate(self, tree):
        return jax.tree.map(
            lambda a: jax.lax.ppermute(a, self._axis, self._perm()), tree)

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        me = jax.lax.axis_index(self._axis)
        g, accel = self._g, self._accel
        n = orig.shape[0]
        best = trace_ops.Hit(kind=jnp.full((n,), KIND_NONE, jnp.int32),
                             idx=jnp.zeros((n,), jnp.int32),
                             t=jnp.full((n,), INF, jnp.float32))
        for step in range(self._p):
            owner = (me - step) % self._p  # whose shard we hold now
            hit = _local_nearest(g, orig, direc, t_min, tri_chunk, accel,
                                 self._accel_meta, active=active)
            hit = _globalize(hit, self._sizes, owner)
            best = _fold_hit(best, hit)
            if step + 1 < self._p:
                g, accel = self._rotate((g, accel))
        return best

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        g, accel = self._g, self._accel
        occ = jnp.zeros((orig.shape[0],), bool)
        for step in range(self._p):
            occ |= _local_occluded(g, orig, direc, max_t, t_min, tri_chunk,
                                   accel, self._accel_meta, active=active)
            if step + 1 < self._p:
                g, accel = self._rotate((g, accel))
        return occ
