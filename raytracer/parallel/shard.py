"""Multi-device rendering: pixel-tile DP × primitive sharding (SURVEY.md §3.2).

`render_sharded` runs the wavefront renderer under `jax.shard_map` on a
Mesh('tiles','prims'):

- image rays block-shard over 'tiles' (DP — no cross-chip comm in forward
  except the output gather, which XLA inserts from the out_specs);
- the winner search shards primitives over 'prims' via ShardTracer
  (all_gather + min-combine) or streams them around the ring via RingTracer
  (`ppermute`, rays resident — the ring-attention analog for scenes > HBM);
- the differentiable surface/shade stages use the replicated scene, so
  `jax.grad` through this function equals the single-device gradient, with
  scene-parameter grads psum'd automatically by the shard_map transpose
  (SURVEY §2.3 "Gradient DP").
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from raytracer.core.types import Camera, RenderOptions, Scene
from raytracer.ops import geometry as geom
from raytracer.ops.safemath import clamp01
from raytracer.parallel import tracer as tr
from raytracer.renderer import render_rays


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def build_sharded_accel(scene: Scene, n_prims: int, leaf_size: int = 8):
    """Host prebuild of the per-shard BVH stack for render_sharded(accel=…).

    → (arrs dict, meta tuple) over the SAME padded/chunked triangle layout
    pad_trace_geom produces for an n_prims 'prims' axis. Build outside jit
    (concrete scene), then pass the tuple to render_sharded — inside jit the
    arrays become ordinary traced inputs.
    """
    import numpy as np

    from raytracer.accel.bvh import build_stacked_bvh

    # host-only: np.asarray over a device scene would be a device→host
    # readback — so build
    # (v0, e1, e2) and the pad_trace_geom triangle padding in numpy directly
    verts = np.asarray(scene.meshes.verts, np.float32)
    tris = np.asarray(scene.meshes.tris)
    v0 = verts[tris[:, 0]]
    e1 = verts[tris[:, 1]] - v0
    e2 = verts[tris[:, 2]] - v0
    t_pad = -(-max(v0.shape[0], 0) // n_prims) * n_prims
    pad = t_pad - v0.shape[0]
    if pad:
        z = np.zeros((pad, 3), np.float32)
        v0, e1, e2 = (np.concatenate([a, z]) for a in (v0, e1, e2))
    stacked = build_stacked_bvh(v0, e1, e2, n_prims, leaf_size=leaf_size)
    meta = (stacked["n_nodes"], stacked["capacity"],
            stacked["tris_per_shard"])
    arrs = {k: jnp.asarray(stacked[k]) for k in
            ("aabb_min", "aabb_max", "leaf_tris", "hit_link", "miss_link")}
    return arrs, meta


def render_sharded(scene: Scene, camera: Camera, opts: RenderOptions, mesh,
                   ring: bool = False, count_rays: bool = False,
                   accel: str | None = None, tracer=None):
    """Full-image render on a Mesh('tiles','prims') → (image, rays_traced)
    (+ dropped-lane count when the compacted-wavefront mode is active).

    accel='bvh' builds one BVH per primitive shard on the host (stacked
    arrays sharded over 'prims'; accel.bvh.build_stacked_bvh) so the per-rank
    winner search walks a tree instead of brute-scanning its triangle chunk —
    the ring variant rotates the trees around the ICI ring with the geometry.

    tracer: a replicated pytree tracer (e.g. accel.grid.GridTracer — the
    config4 headline backend) used verbatim on every rank instead of the
    ShardTracer/RingTracer winner search: pure pixel-tile DP with the accel
    structure broadcast. This is how the grid path gets a distributed
    correctness artifact.
    """
    from raytracer.core.types import as_jax
    from raytracer.renderer import use_compact

    scene = as_jax(scene)
    compact = use_compact(scene, opts)
    camera = as_jax(camera)
    n_tiles = mesh.shape["tiles"]
    n_prims = mesh.shape["prims"]
    h, w = opts.height, opts.width
    n_pix = h * w

    per_dev = _ceil_to(-(-n_pix // n_tiles), 8)
    inner = min(opts.tile_rays, per_dev)
    per_dev = _ceil_to(per_dev, inner)
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

    accel_arrs = accel_meta = None
    if accel == "bvh" and sizes[2]:
        # host build — requires a concrete (non-traced) scene; under jit,
        # prebuild with build_sharded_accel and pass the result instead
        accel_arrs, accel_meta = build_sharded_accel(scene, n_prims)
    elif isinstance(accel, tuple):
        accel_arrs, accel_meta = accel
        accel_arrs = {k: jnp.asarray(v) for k, v in accel_arrs.items()}
    elif accel not in (None, "bvh"):
        raise ValueError(f"unknown accel {accel!r}")

    in_specs = (P("tiles", None), tr.geom_pspec("prims"), P(), P())
    if accel_arrs is not None:
        in_specs = in_specs + (tr.accel_pspec("prims"),)
    if tracer is not None:
        in_specs = in_specs + (P(),)  # prefix spec: replicate every leaf
    out_specs = (P("tiles", None), P()) + ((P(),) if compact else ())

    # check_vma=False: the min-combine (all_gather/psum/ring fold) makes the
    # radiance provably equal across 'prims', but the static varying-axes
    # checker cannot infer that.
    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=out_specs, check_vma=False)
    def body(dirs_shard, g_shard, scene_rep, cam_pos, *extra):
        extra = list(extra)
        acc = extra.pop(0) if accel_arrs is not None else None
        if tracer is not None:
            rank_tracer = extra.pop(0)
        elif ring:
            rank_tracer = tr.RingTracer(g_shard, "prims", sizes, n_prims,
                                        accel=acc, accel_meta=accel_meta)
        else:
            rank_tracer = tr.ShardTracer(g_shard, "prims", sizes,
                                         accel=acc, accel_meta=accel_meta)
        orig = jnp.broadcast_to(cam_pos, (inner, 3))
        tiles = dirs_shard.reshape(-1, inner, 3)
        zero = jnp.zeros((), jnp.float32)

        def tile_fn(carry, td):
            out = render_rays(scene_rep, orig, td, opts,
                              count_rays=count_rays, tracer=rank_tracer)
            if compact:
                rad, n, drop = out
                return (carry[0] + n, carry[1] + drop), rad
            rad, n = out
            return (carry[0] + n, carry[1]), rad

        (traced, dropped), rad = jax.lax.scan(tile_fn, (zero, zero), tiles)
        # every prim-shard traces the same ray lanes → sum tiles only
        traced = jax.lax.psum(traced, "tiles")
        if compact:
            return (rad.reshape(-1, 3), traced,
                    jax.lax.psum(dropped, "tiles"))
        return rad.reshape(-1, 3), traced

    args = (dirs, g_full, scene, camera.pos)
    if accel_arrs is not None:
        args = args + (accel_arrs,)
    if tracer is not None:
        args = args + (tracer,)
    out = body(*args)
    img = clamp01(out[0][:n_pix]).reshape(h, w, 3)
    return (img,) + tuple(out[1:])
