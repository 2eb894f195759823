"""Threaded-BVH acceleration: device stackless walk must reproduce brute force.

SURVEY.md §2.2 "Accel grid/BVH" (the BVH half of C10) + §7.3.1. Same contract
as tests/test_grid.py: any accel backend must agree with the default scan
tracer up to exact-tie knife edges.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.accel.bvh import BVHTracer, build_bvh, bvh_walk
from raytracer.core.types import Meshes
from raytracer.io import meshgen
from raytracer.models import presets
from raytracer.renderer import render
from tests.helpers import assert_images_close


@pytest.fixture(scope="module")
def mesh_scene():
    scene, cam, opts = presets.config4_mesh(use_obj=False)
    verts, tris = meshgen.bumpy_sphere(subdiv=3, radius=1.3)
    normals = meshgen.vertex_normals(verts, tris)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32), normals=normals))
    opts = dataclasses.replace(opts, width=96, height=54, max_depth=2,
                               tile_rays=2592)
    return scene, cam, opts


def _tri_soa(verts, tris):
    v0 = jnp.asarray(verts[tris[:, 0]])
    e1 = jnp.asarray(verts[tris[:, 1]] - verts[tris[:, 0]])
    e2 = jnp.asarray(verts[tris[:, 2]] - verts[tris[:, 0]])
    return v0, e1, e2


def test_bvh_build_covers_all_tris(mesh_scene):
    scene, _, _ = mesh_scene
    b = build_bvh(np.asarray(scene.meshes.verts),
                  np.asarray(scene.meshes.tris), leaf_size=8)
    t = scene.meshes.count
    in_leaves = set(np.asarray(b.leaf_tris).ravel().tolist()) - {t}
    assert in_leaves == set(range(t))
    # threading invariant: every link lands in [0, n_nodes]
    for lk in (b.hit_link, b.miss_link):
        a = np.asarray(lk)
        assert a.min() >= 0 and a.max() <= b.n_nodes


def test_bvh_render_equals_brute(mesh_scene):
    scene, cam, opts = mesh_scene
    ref = np.asarray(render(scene, cam, opts)[0])
    tr = BVHTracer.build(scene)
    img = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    # exact-tie shared-edge hits may pick the other triangle → tiny pixel set
    assert_images_close(img, ref, tol=1e-6, max_bad_frac=0.001, name="bvh")


def test_bvh_render_leaf1(mesh_scene):
    """Degenerate leaves (1 tri each → deepest possible tree) must stay exact."""
    scene, cam, opts = mesh_scene
    ref = np.asarray(render(scene, cam, opts)[0])
    tr = BVHTracer.build(scene, leaf_size=1)
    img = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    assert_images_close(img, ref, tol=1e-6, max_bad_frac=0.001, name="bvh-l1")


def test_bvh_walk_unit_cases():
    verts = np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    b = build_bvh(verts, tris, leaf_size=4)
    v0, e1, e2 = _tri_soa(verts, tris)

    orig = jnp.asarray([[0.0, 0.0, 0.0],    # hit head-on
                        [0.0, 0.0, -5.0],   # behind, shooting away
                        [5.0, 5.0, 0.0],    # misses the root box
                        [0.0, 0.0, -2.9]])  # origin inside the box
    direc = jnp.asarray([[0.0, 0.0, -1.0],
                         [0.0, 0.0, -1.0],
                         [0.0, 0.0, -1.0],
                         [0.0, 0.0, -1.0]])
    t, i = bvh_walk(b, v0, e1, e2, orig, direc, 1e-4)
    t = np.asarray(t)
    assert t[0] == pytest.approx(3.0, abs=1e-5)
    assert np.isinf(t[1])
    assert np.isinf(t[2])
    assert t[3] == pytest.approx(0.1, abs=1e-5)
    assert int(i[0]) == 0


def test_bvh_all_octants(mesh_scene):
    """Nearest hit must be direction-order independent: fire the same rays
    with all 8 sign combinations through the mesh and compare to brute."""
    scene, _, _ = mesh_scene
    from raytracer.ops.trace import _scan_tri_nearest

    verts = np.asarray(scene.meshes.verts)
    tris = np.asarray(scene.meshes.tris)
    b = build_bvh(verts, tris, leaf_size=8)
    v0, e1, e2 = _tri_soa(verts, tris)

    rng = np.random.default_rng(11)
    base_d = np.abs(rng.normal(size=(64, 3))) + 0.05
    center = np.array([0.0, -0.1, -5.5])
    for o in range(8):
        sign = np.array([1 - 2 * ((o >> a) & 1) for a in range(3)])
        d = base_d * sign
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        orig = center - d * 4.0  # aim through the mesh from outside
        od = jnp.asarray(orig, jnp.float32), jnp.asarray(d, jnp.float32)
        want_t, _ = _scan_tri_nearest(od[0], od[1], v0, e1, e2, 1e-4, 256)
        got_t, _ = bvh_walk(b, v0, e1, e2, od[0], od[1], 1e-4)
        np.testing.assert_allclose(np.asarray(got_t), np.asarray(want_t),
                                   rtol=1e-5, atol=1e-5)


def test_bvh_occlusion_matches_brute(mesh_scene):
    scene, cam, opts = mesh_scene
    from raytracer.ops import trace as trace_ops

    rng = np.random.default_rng(3)
    orig = jnp.asarray(rng.normal(size=(256, 3)) * 2 +
                       np.array([0, 0, -5.5]), jnp.float32)
    d = rng.normal(size=(256, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    max_t = jnp.full((256,), 4.0, jnp.float32)
    want = trace_ops.occluded(scene, orig, d, max_t, 1e-4, 512)
    tr = BVHTracer.build(scene)
    got = tr.occluded(orig, d, max_t, 1e-4, 512)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.slow
def test_stacked_bvh_sharded_render(mesh_scene):
    """Per-shard BVHs (accel='bvh') must reproduce the brute sharded render,
    for both the all-gather combine and the ppermute ring."""
    import jax

    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.shard import render_sharded

    from raytracer.parallel.shard import build_sharded_accel

    scene, cam, opts = mesh_scene
    mesh = make_rt_mesh(tiles=2, prims=4, devices=jax.devices()[:8])
    ref = np.asarray(jax.jit(lambda s, c: render_sharded(
        s, c, opts, mesh)[0])(scene, cam))
    accel = build_sharded_accel(scene, n_prims=4)
    for ring in (False, True):
        img = np.asarray(jax.jit(lambda s, c, r=ring: render_sharded(
            s, c, opts, mesh, ring=r, accel=accel)[0])(scene, cam))
        assert_images_close(img, ref, tol=1e-6, max_bad_frac=0.001,
                            name=f"stacked-bvh ring={ring}")


def test_stacked_bvh_covers_all_tris(mesh_scene):
    from raytracer.accel.bvh import build_stacked_bvh
    from raytracer.parallel import tracer as tr
    from raytracer.core.types import as_jax

    scene, _, _ = mesh_scene
    g = tr.pad_trace_geom(tr.build_trace_geom(as_jax(scene)), 4)
    st = build_stacked_bvh(np.asarray(g.tri_v0), np.asarray(g.tri_e1),
                           np.asarray(g.tri_e2), 4)
    ts = st["tris_per_shard"]
    assert ts * 4 == g.tri_v0.shape[0]
    for s in range(4):
        ids = set(st["leaf_tris"][s].ravel().tolist()) - {ts}
        assert ids == set(range(ts)), f"shard {s} leaf coverage"
        for lk in (st["hit_link"][s], st["miss_link"][s]):
            assert lk.min() >= 0 and lk.max() <= st["n_nodes"]


@pytest.mark.slow
def test_bvh_gradients_match_brute(mesh_scene):
    """Winner recompute is backend-independent: loss grads w.r.t. vertices and
    material albedo must match the default tracer's."""
    import jax

    scene, cam, opts = mesh_scene
    opts = dataclasses.replace(opts, width=48, height=27, tile_rays=1296,
                               max_depth=1)
    tr = BVHTracer.build(scene)

    def loss(verts, albedo, tracer):
        sc = scene.replace(
            meshes=dataclasses.replace(scene.meshes, verts=verts),
            materials=dataclasses.replace(scene.materials, albedo=albedo))
        img, _ = render(sc, cam, opts, tracer=tracer)
        return jnp.sum(img ** 2)

    v = jnp.asarray(scene.meshes.verts, jnp.float32)
    a = jnp.asarray(scene.materials.albedo, jnp.float32)
    gv_ref, ga_ref = jax.grad(loss, argnums=(0, 1))(v, a, None)
    gv_bvh, ga_bvh = jax.grad(loss, argnums=(0, 1))(v, a, tr)
    np.testing.assert_allclose(np.asarray(ga_bvh), np.asarray(ga_ref),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gv_bvh), np.asarray(gv_ref),
                               rtol=1e-3, atol=1e-5)


def test_bvh_gather_fusion_bitwise_identical(mesh_scene):
    """The build-time fused layout (aabb6 [n,6], links2 [8n,2], ids as SoA
    col 10) must return bit-identical results to the split-array fallback the
    stacked per-shard path uses (aabb6/links2=None, 9-col SoA), in both
    nearest and any-hit modes, with and without pregather."""
    import dataclasses

    from raytracer.accel.bvh import bvh_walk
    from raytracer.ops import geometry as geom

    scene, cam, opts = mesh_scene
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    mx = jnp.full(orig.shape[:1], 6.0, jnp.float32)
    for pg in (False, True):
        tr = BVHTracer.build(scene, pregather=pg)
        assert tr._bvh.aabb6 is not None and tr._bvh.links2 is not None
        split = dataclasses.replace(
            tr._bvh, aabb6=None, links2=None,
            leaf_soa=(tr._bvh.leaf_soa[..., :9] if pg else None))
        v0, e1, e2 = tr._soa
        out = []
        for b in (tr._bvh, split):
            t, i = bvh_walk(b, v0, e1, e2, orig, dirs, opts.t_min)
            to, _ = bvh_walk(b, v0, e1, e2, orig, dirs, opts.t_min,
                             occlusion_max_t=mx)
            out.append((np.asarray(t), np.asarray(i), np.asarray(to) < 6.0))
        for a, b in zip(out[0], out[1]):
            np.testing.assert_array_equal(a, b)


def test_bvh_pregather_bitwise_identical(mesh_scene):
    """leaf_soa pre-gather is a pure layout change: the walk must return
    bit-identical (t, idx, kind) to the gather-per-step path."""
    scene, cam, opts = mesh_scene
    from raytracer.ops import geometry as geom

    tr0 = BVHTracer.build(scene, pregather=False)
    tr1 = BVHTracer.build(scene, pregather=True)
    assert tr1._bvh.leaf_soa is not None
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    h0 = tr0.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
    h1 = tr1.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
    np.testing.assert_array_equal(np.asarray(h0.t), np.asarray(h1.t))
    np.testing.assert_array_equal(np.asarray(h0.idx), np.asarray(h1.idx))
    np.testing.assert_array_equal(np.asarray(h0.kind), np.asarray(h1.kind))


def test_bvh_active_mask_parks_lanes(mesh_scene):
    """active=False lanes park at the done-sentinel (miss/INF); active lanes
    bitwise-unchanged — the renderer passes alive masks (bounce_step)."""
    scene, cam, opts = mesh_scene
    rng = np.random.default_rng(7)
    n = 256
    orig = jnp.asarray(rng.normal(size=(n, 3)) * 2 +
                       np.array([0, 0, -5.5]), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    active = jnp.asarray(rng.random(n) < 0.5)
    tr = BVHTracer.build(scene)

    full = tr.nearest(orig, d, 1e-4, 512)
    masked = tr.nearest(orig, d, 1e-4, 512, active=active)
    act = np.asarray(active)
    np.testing.assert_array_equal(np.asarray(masked.t)[act],
                                  np.asarray(full.t)[act])
    np.testing.assert_array_equal(np.asarray(masked.idx)[act],
                                  np.asarray(full.idx)[act])
    tb, _ = bvh_walk(tr._bvh, *tr._soa, orig, d, 1e-4, active=active)
    assert np.isinf(np.asarray(tb)[~act]).all()

    max_t = jnp.full((n,), 4.0, jnp.float32)
    occ_full = np.asarray(tr.occluded(orig, d, max_t, 1e-4, 512))
    occ_mask = np.asarray(tr.occluded(orig, d, max_t, 1e-4, 512,
                                      active=active))
    np.testing.assert_array_equal(occ_mask[act], occ_full[act])


def test_bvh_sah_build_agrees_with_median(mesh_scene):
    """RT_BVH_SAH binned-SAH build: same hits as the median-split tree (walk
    semantics are build-agnostic), smaller tree on curved meshes."""
    scene, cam, opts = mesh_scene
    verts = np.asarray(scene.meshes.verts)
    tris = np.asarray(scene.meshes.tris)
    bm = build_bvh(verts, tris, leaf_size=8, sah=False)
    bs = build_bvh(verts, tris, leaf_size=8, sah=True)
    assert bs.n_nodes <= bm.n_nodes
    t = scene.meshes.count
    leaf = np.asarray(bs.leaf_tris)
    listed = set(leaf[leaf != t].tolist())
    assert listed == set(range(t))  # every triangle in exactly the SAH tree

    v0, e1, e2 = _tri_soa(verts, tris)
    rng = np.random.default_rng(5)
    orig = jnp.asarray(rng.normal(size=(512, 3)) * 2 +
                       np.array([0, 0, -5.5]), jnp.float32)
    d = rng.normal(size=(512, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    tm, _ = bvh_walk(bm, v0, e1, e2, orig, d, 1e-4)
    ts, _ = bvh_walk(bs, v0, e1, e2, orig, d, 1e-4)
    np.testing.assert_allclose(np.asarray(tm), np.asarray(ts),
                               rtol=1e-6, atol=1e-6)


def test_bvh_sah_degenerate_centroids():
    """All-coincident centroids: SAH falls back to the median split."""
    v = np.array([[0, 0, -3], [1, 0, -3], [0, 1, -3]], np.float32)
    verts = np.concatenate([v + np.zeros((1, 3), np.float32)] * 17)
    tris = (np.arange(51).reshape(17, 3)).astype(np.int32)
    b = build_bvh(verts, tris, leaf_size=2, sah=True)
    t = 17
    leaf = np.asarray(b.leaf_tris)
    assert set(leaf[leaf != t].tolist()) == set(range(t))
