"""Nearest-hit trace + occlusion + differentiable surface recomputation.

Reference analog: `trace()` — the nearest-hit loop over scene objects, and the
`getSurfaceProperties` call on the winner (SURVEY.md §3.1 L2/L1).

Design (SURVEY.md §7.1/§7.3.3):
- The *search* for the winning primitive is integer-only and runs under
  `stop_gradient`: it returns `(kind, idx)` residuals. Triangles stream through a
  `lax.scan` over fixed-size chunks (blockwise "KV-tile" pattern) so the [N,T]
  candidate matrix never materializes and the backward pass saves nothing.
- The *differentiable* quantities (t, normal, uv, albedo) are recomputed from the
  single gathered winner per ray in `surface_at` — gradients flow from pixel loss
  to sphere centers/radii, triangle vertices, plane params via implicit
  recomputation rather than differentiating the argmin sweep.
- Occlusion (shadow rays) is boolean any-hit: visibility is a.e. piecewise
  constant, so it is wrapped in stop_gradient by construction (int/bool outputs).
"""

import dataclasses

import jax
import jax.numpy as jnp

from raytracer.core.types import (
    KIND_NONE, KIND_PLANE, KIND_SPHERE, KIND_TRIANGLE, Scene)
from raytracer.ops import geometry as geom
from raytracer.ops.dgather import pgather, tselect
from raytracer.ops.safemath import cross, dot, normalize, safe_div

INF = jnp.inf


def _pad_tris(v0, e1, e2, chunk):
    """Pad triangle SoA to a multiple of `chunk` with degenerate (zero)
    triangles — det==0 ⇒ always a miss, so padding is semantically inert."""
    t = v0.shape[0]
    padded = -(-max(t, 1) // chunk) * chunk
    pad = padded - t
    if pad:
        z = jnp.zeros((pad, 3), v0.dtype)
        v0, e1, e2 = (jnp.concatenate([a, z]) for a in (v0, e1, e2))
    return v0, e1, e2


def _scan_tri_nearest(orig, direc, v0, e1, e2, t_min, chunk):
    """Streaming min-reduce over triangle chunks → (best_t, best_i) per ray."""
    n = orig.shape[0]
    v0, e1, e2 = _pad_tris(v0, e1, e2, chunk)
    k = v0.shape[0] // chunk
    v0c = v0.reshape(k, chunk, 3)
    e1c = e1.reshape(k, chunk, 3)
    e2c = e2.reshape(k, chunk, 3)
    offs = jnp.arange(k, dtype=jnp.int32) * chunk

    def body(carry, chunk_in):
        bt, bi = carry
        cv0, ce1, ce2, off = chunk_in
        ts, _, _ = geom.triangle_hits(orig, direc, cv0, ce1, ce2, t_min)  # [N,chunk]
        tc = jnp.min(ts, axis=1)
        ic = jnp.argmin(ts, axis=1).astype(jnp.int32) + off
        better = tc < bt
        return (jnp.where(better, tc, bt), jnp.where(better, ic, bi)), None

    init = (jnp.full((n,), INF, jnp.float32), jnp.zeros((n,), jnp.int32))
    (bt, bi), _ = jax.lax.scan(body, init, (v0c, e1c, e2c, offs))
    return bt, bi


def _scan_tri_occluded(orig, direc, v0, e1, e2, t_min, max_t, chunk):
    """Streaming any-hit over triangle chunks → bool [N]."""
    n = orig.shape[0]
    v0, e1, e2 = _pad_tris(v0, e1, e2, chunk)
    k = v0.shape[0] // chunk

    def body(carry, chunk_in):
        cv0, ce1, ce2 = chunk_in
        ts, _, _ = geom.triangle_hits(orig, direc, cv0, ce1, ce2, t_min)
        return carry | jnp.any(ts < max_t[:, None], axis=1), None

    init = jnp.zeros((n,), bool)
    out, _ = jax.lax.scan(body, init, (v0.reshape(k, chunk, 3),
                                       e1.reshape(k, chunk, 3),
                                       e2.reshape(k, chunk, 3)))
    return out


@dataclasses.dataclass
class Hit:
    """Per-ray hit record. kind/idx are the integer residuals of the search;
    t is the stop-gradient winning distance (kept for cross-shard min-combines,
    never used on the differentiable path — `surface_at` recomputes t)."""
    kind: jax.Array  # [N] i32 — KIND_NONE/SPHERE/PLANE/TRIANGLE
    idx: jax.Array   # [N] i32 — index within its primitive group
    t: jax.Array     # [N] f32 — stop-gradient distance (+inf on miss)


jax.tree_util.register_dataclass(Hit, data_fields=["kind", "idx", "t"],
                                 meta_fields=[])


def nearest_hit(scene: Scene, orig, direc, t_min: float, tri_chunk: int,
                active=None) -> Hit:
    """Winner search (integers only, stop_gradient). Nearest over all groups;
    equal-t tie-break: sphere < plane < triangle, lower index (SPEC).

    `active` is accepted for tracer-interface uniformity and ignored: this
    dense path has static trip counts, so masking lanes saves nothing (the
    walk backends use it to cut while_loop iterations)."""
    del active
    orig = jax.lax.stop_gradient(orig)
    direc = jax.lax.stop_gradient(direc)
    scene = jax.lax.stop_gradient(scene)
    n = orig.shape[0]
    best_t = jnp.full((n,), INF, jnp.float32)
    kind = jnp.full((n,), KIND_NONE, jnp.int32)
    idx = jnp.zeros((n,), jnp.int32)

    if scene.spheres.count:
        ts = geom.sphere_hits(orig, direc, scene.spheres.center,
                              scene.spheres.radius, t_min)
        tb = jnp.min(ts, axis=1)
        ib = jnp.argmin(ts, axis=1).astype(jnp.int32)
        better = tb < best_t
        best_t = jnp.where(better, tb, best_t)
        kind = jnp.where(better, KIND_SPHERE, kind)
        idx = jnp.where(better, ib, idx)

    if scene.planes.count:
        ts = geom.plane_hits(orig, direc, scene.planes.point,
                             scene.planes.normal, t_min)
        tb = jnp.min(ts, axis=1)
        ib = jnp.argmin(ts, axis=1).astype(jnp.int32)
        better = tb < best_t
        best_t = jnp.where(better, tb, best_t)
        kind = jnp.where(better, KIND_PLANE, kind)
        idx = jnp.where(better, ib, idx)

    if scene.meshes.count:
        v0, e1, e2 = scene.meshes.tri_soa()
        tb, ib = _scan_tri_nearest(orig, direc, v0, e1, e2, t_min, tri_chunk)
        better = tb < best_t
        best_t = jnp.where(better, tb, best_t)
        kind = jnp.where(better, KIND_TRIANGLE, kind)
        idx = jnp.where(better, ib, idx)

    return Hit(kind=kind, idx=idx, t=best_t)


def occluded(scene: Scene, orig, direc, max_t, t_min: float,
             tri_chunk: int, active=None) -> jax.Array:
    """Any-hit with t in (t_min, max_t) → bool [N]. Shadow-ray test (SPEC).
    Tests all objects including transparent ones (genre-exact).
    `active` ignored here (dense path, static trip counts) — see nearest_hit."""
    del active
    orig = jax.lax.stop_gradient(orig)
    direc = jax.lax.stop_gradient(direc)
    max_t = jax.lax.stop_gradient(max_t)
    scene = jax.lax.stop_gradient(scene)
    n = orig.shape[0]
    occ = jnp.zeros((n,), bool)
    if scene.spheres.count:
        ts = geom.sphere_hits(orig, direc, scene.spheres.center,
                              scene.spheres.radius, t_min)
        occ |= jnp.any(ts < max_t[:, None], axis=1)
    if scene.planes.count:
        ts = geom.plane_hits(orig, direc, scene.planes.point,
                             scene.planes.normal, t_min)
        occ |= jnp.any(ts < max_t[:, None], axis=1)
    if scene.meshes.count:
        v0, e1, e2 = scene.meshes.tri_soa()
        occ |= _scan_tri_occluded(orig, direc, v0, e1, e2, t_min, max_t, tri_chunk)
    return occ


@dataclasses.dataclass
class Surface:
    """Differentiable surface properties of the winning hit (per ray)."""
    valid: jax.Array       # [N] bool
    t: jax.Array           # [N] f32
    p: jax.Array           # [N,3] hit point
    n: jax.Array           # [N,3] geometric/shading normal (unit, unflipped)
    albedo: jax.Array      # [N,3] effective diffuse color (checker applied)
    mtype: jax.Array       # [N] i32
    kd: jax.Array          # [N]
    ks: jax.Array          # [N]
    spec_n: jax.Array      # [N]
    ior: jax.Array         # [N]


jax.tree_util.register_dataclass(
    Surface,
    data_fields=["valid", "t", "p", "n", "albedo", "mtype", "kd", "ks",
                 "spec_n", "ior"],
    meta_fields=[])


def surface_at(scene: Scene, orig, direc, hit: Hit, t_min: float) -> Surface:
    """Recompute t/normal/uv/material of the winner differentiably from gathered
    primitive parameters (kind/idx are frozen integer residuals)."""
    n_rays = orig.shape[0]
    t = jnp.zeros((n_rays,), jnp.float32)
    nrm = jnp.zeros((n_rays, 3), jnp.float32)
    mat_id = jnp.zeros((n_rays,), jnp.int32)
    checker_mask = jnp.zeros((n_rays,), bool)
    checker_albedo = jnp.zeros((n_rays, 3), jnp.float32)

    if scene.spheres.count:
        m = hit.kind == KIND_SPHERE
        i = jnp.where(m, hit.idx, 0)
        # pgather = table[i] with a scatter-free VJP: these per-lane gathers
        # from few-row parameter tables otherwise backward as scatter-adds
        # into a few rows (ops/dgather.py)
        c = pgather(scene.spheres.center, i)
        r = pgather(scene.spheres.radius, i)
        ts = geom.sphere_t(orig, direc, c, r, t_min)
        ts = jnp.where(m, ts, 0.0)
        p = orig + ts[:, None] * direc
        ns = safe_div(p - c, r[:, None], valid=jnp.abs(r[:, None]) > 1e-12)
        t = jnp.where(m, ts, t)
        nrm = jnp.where(m[:, None], ns, nrm)
        mat_id = jnp.where(m, tselect(scene.spheres.mat_id, i), mat_id)

    if scene.planes.count:
        m = hit.kind == KIND_PLANE
        i = jnp.where(m, hit.idx, 0)
        p0 = pgather(scene.planes.point, i)
        pn = pgather(scene.planes.normal, i)
        tp = geom.plane_t(orig, direc, p0, pn, t_min)
        tp = jnp.where(m, tp, 0.0)
        p = orig + tp[:, None] * direc
        u = dot(p - p0, pgather(scene.planes.tangent, i))
        v = dot(p - p0, pgather(scene.planes.bitangent, i))
        s = pgather(scene.planes.checker_scale, i)
        fu = u * s - jnp.floor(u * s)
        fv = v * s - jnp.floor(v * s)
        pattern = (fu > 0.5) ^ (fv > 0.5)
        # SPEC: albedo_eff = c1 if pattern==0 else c2 — per-plane color pair
        # (material albedo, albedo2); the classic colors are the preset defaults.
        mat_alb = pgather(scene.materials.albedo,
                          tselect(scene.planes.mat_id, i))
        calb = jnp.where(pattern[:, None], pgather(scene.planes.albedo2, i),
                         mat_alb)
        t = jnp.where(m, tp, t)
        nrm = jnp.where(m[:, None], pn, nrm)
        mat_id = jnp.where(m, tselect(scene.planes.mat_id, i), mat_id)
        is_checker = tselect(scene.planes.checker, i) > 0
        checker_mask = checker_mask | (m & is_checker)
        checker_albedo = jnp.where((m & is_checker)[:, None], calb, checker_albedo)

    if scene.meshes.count:
        m = hit.kind == KIND_TRIANGLE
        i = jnp.where(m, hit.idx, 0)
        tri = scene.meshes.tris[i]
        v0 = scene.meshes.verts[tri[:, 0]]
        v1 = scene.meshes.verts[tri[:, 1]]
        v2 = scene.meshes.verts[tri[:, 2]]
        e1 = v1 - v0
        e2 = v2 - v0
        tt, u, v = geom.triangle_tuv(orig, direc, v0, e1, e2, t_min)
        tt = jnp.where(m, tt, 0.0)
        if scene.meshes.smooth:
            n0, n1, n2 = (scene.meshes.normals[tri[:, k]] for k in range(3))
            nt = normalize((1.0 - u - v)[:, None] * n0 + u[:, None] * n1
                           + v[:, None] * n2)
        else:
            nt = normalize(cross(e1, e2))
        t = jnp.where(m, tt, t)
        nrm = jnp.where(m[:, None], nt, nrm)
        mat_id = jnp.where(m, scene.meshes.mat_id[i], mat_id)
        if scene.meshes.has_uv:
            # barycentric st from the winner's vertex uvs (vertex-aligned —
            # SPEC "Mesh UV"); checker pattern = the plane formula on (s,t).
            # Differentiable: st flows from (u, v) → triangle verts; albedo2
            # flows to the material-fit path like the plane checker colors.
            st0, st1, st2 = (scene.meshes.uvs[tri[:, k]] for k in range(3))
            st = ((1.0 - u - v)[:, None] * st0 + u[:, None] * st1
                  + v[:, None] * st2)
            sc = scene.meshes.checker_scale[i]
            fu = st[:, 0] * sc - jnp.floor(st[:, 0] * sc)
            fv = st[:, 1] * sc - jnp.floor(st[:, 1] * sc)
            pattern = (fu > 0.5) ^ (fv > 0.5)
            is_chk = m & (scene.meshes.checker[i] > 0)
            mat_alb = pgather(scene.materials.albedo, scene.meshes.mat_id[i])
            calb = jnp.where(pattern[:, None], scene.meshes.albedo2[i],
                             mat_alb)
            checker_mask = checker_mask | is_chk
            checker_albedo = jnp.where(is_chk[:, None], calb, checker_albedo)

    # A backend may claim a hit whose recompute HERE misses (t = inf): the
    # search and the recompute evaluate the same formula in different fp
    # association contexts, and on knife-edge candidates the hit/miss
    # boundary itself can flip 1 ulp (observed fused-plan ids vs the
    # row-form recompute, ops/replay.py). Demote such lanes to miss with a
    # sanitized finite t — an inf t would put NaNs in p and, through the
    # masked-branch trap, in gradients.
    ok = jnp.isfinite(t)
    t = jnp.where(ok, t, 0.0)
    valid = (hit.kind != KIND_NONE) & ok
    p = orig + t[:, None] * direc
    albedo = pgather(scene.materials.albedo, mat_id)
    albedo = jnp.where(checker_mask[:, None], checker_albedo, albedo)
    return Surface(
        valid=valid, t=t, p=p, n=nrm, albedo=albedo,
        mtype=tselect(scene.materials.mtype, mat_id),
        kd=pgather(scene.materials.kd, mat_id),
        ks=pgather(scene.materials.ks, mat_id),
        spec_n=pgather(scene.materials.spec_n, mat_id),
        ior=pgather(scene.materials.ior, mat_id))
