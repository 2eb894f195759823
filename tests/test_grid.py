"""Uniform-grid acceleration: device DDA walk must reproduce brute force.

SURVEY.md §4.2 (grid-DDA cell walk) + §7.3.1 (the top-risk component).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.accel.grid import GridTracer, build_grid, grid_walk
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


def test_grid_build_covers_all_tris(mesh_scene):
    scene, _, _ = mesh_scene
    g = build_grid(np.asarray(scene.meshes.verts),
                   np.asarray(scene.meshes.tris), capacity=8)
    t = scene.meshes.count
    in_cells = set(np.asarray(g.cell_tris).ravel().tolist()) - {t}
    in_overflow = set(np.asarray(g.overflow).tolist())
    assert in_cells | in_overflow == set(range(t))


def test_grid_render_equals_brute(mesh_scene):
    scene, cam, opts = mesh_scene
    ref = np.asarray(render(scene, cam, opts)[0])
    tr = GridTracer.build(scene)
    img = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    # exact-tie shared-edge hits may pick the other triangle → tiny pixel set
    assert_images_close(img, ref, tol=1e-6, max_bad_frac=0.001, name="grid")


def test_grid_render_small_capacity_overflow(mesh_scene):
    """Force heavy overflow (capacity=2): the spill path must stay exact."""
    scene, cam, opts = mesh_scene
    ref = np.asarray(render(scene, cam, opts)[0])
    tr = GridTracer.build(scene, capacity=2)
    assert tr._grid.overflow.shape[0] > 0
    img = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    assert_images_close(img, ref, tol=1e-6, max_bad_frac=0.001, name="grid-ovf")


def test_grid_visit_walk_bitwise_identical(mesh_scene):
    """Two-phase visit-list walk (grid_walk_visit): renders bitwise-equal to
    the classic interleaved walk — same candidate shapes, fold order, and tie
    rule; only the traversal/eval schedule differs. Covers nearest, shadow
    occlusion, the active mask, and an overflow (capacity-2) build."""
    scene, cam, opts = mesh_scene
    for cap in (None, 2):
        tr0 = GridTracer.build(scene, capacity=cap)
        tr1 = GridTracer.build(scene, capacity=cap, walk="visit")
        a = np.asarray(render(scene, cam, opts, tracer=tr0)[0])
        b = np.asarray(render(scene, cam, opts, tracer=tr1)[0])
        np.testing.assert_array_equal(a, b)

    from raytracer.accel.grid import grid_walk_visit
    from raytracer.core.types import as_jax

    sj = as_jax(scene)
    v0, e1, e2 = sj.meshes.tri_soa()
    tr0 = GridTracer.build(scene)
    g = tr0._grid
    rng = np.random.default_rng(7)
    o = jnp.asarray(rng.normal(0, 2, (512, 3)).astype(np.float32)
                    + np.array([0, 0, -5.5], np.float32))
    d = rng.normal(0, 1, (512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    act = jnp.asarray(rng.random(512) < 0.3)
    ta, ia = grid_walk(g, v0, e1, e2, o, d, 1e-3, active=act)
    tb, ib = grid_walk_visit(g, v0, e1, e2, o, d, 1e-3, active=act)
    assert jnp.array_equal(ta, tb) and jnp.array_equal(ia, ib)
    mt = jnp.full((512,), 5.0)
    oa, _ = grid_walk(g, v0, e1, e2, o, d, 1e-3, occlusion_max_t=mt)
    ob, _ = grid_walk_visit(g, v0, e1, e2, o, d, 1e-3, occlusion_max_t=mt)
    assert jnp.array_equal(oa < mt, ob < mt)


def test_grid_pregather_bitwise_identical(mesh_scene):
    """cell_soa pre-gather is a pure layout change: the walk must return
    bit-identical (t, idx) to the gather-per-step path on every ray."""
    scene, cam, opts = mesh_scene
    from raytracer.ops import geometry as geom

    tr0 = GridTracer.build(scene, pregather=False)
    tr1 = GridTracer.build(scene, pregather=True)
    assert tr1._grid.cell_soa is not None
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    h0 = tr0.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
    h1 = tr1.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
    np.testing.assert_array_equal(np.asarray(h0.t), np.asarray(h1.t))
    np.testing.assert_array_equal(np.asarray(h0.idx), np.asarray(h1.idx))
    np.testing.assert_array_equal(np.asarray(h0.kind), np.asarray(h1.kind))


def test_grid_walk_unit_cases():
    # single unit triangle in z=-3 plane
    verts = np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    g = build_grid(verts, tris, res=(4, 4, 1), capacity=4)
    v0 = jnp.asarray(verts[tris[:, 0]])
    e1 = jnp.asarray(verts[tris[:, 1]] - verts[tris[:, 0]])
    e2 = jnp.asarray(verts[tris[:, 2]] - verts[tris[:, 0]])

    orig = jnp.asarray([[0.0, 0.0, 0.0],    # hit head-on
                        [0.0, 0.0, -5.0],   # behind, shooting away
                        [5.0, 5.0, 0.0],    # misses the grid box
                        [0.0, 0.0, -2.9]])  # origin inside the box
    direc = jnp.asarray([[0.0, 0.0, -1.0],
                         [0.0, 0.0, -1.0],
                         [0.0, 0.0, -1.0],
                         [0.0, 0.0, -1.0]])
    t, i = grid_walk(g, v0, e1, e2, orig, direc, 1e-4)
    t = np.asarray(t)
    assert t[0] == pytest.approx(3.0, abs=1e-5)
    assert np.isinf(t[1])
    assert np.isinf(t[2])
    assert t[3] == pytest.approx(0.1, abs=1e-5)


def test_grid_axis_aligned_dir_zero_component():
    verts = np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    g = build_grid(verts, tris, res=(3, 3, 2), capacity=4)
    v0 = jnp.asarray(verts[tris[:, 0]])
    e1 = jnp.asarray(verts[tris[:, 1]] - verts[tris[:, 0]])
    e2 = jnp.asarray(verts[tris[:, 2]] - verts[tris[:, 0]])
    # dir has exact zeros in x and y
    t, _ = grid_walk(g, v0, e1, e2, jnp.asarray([[0.25, -0.5, 1.0]]),
                     jnp.asarray([[0.0, 0.0, -1.0]]), 1e-4)
    assert float(t[0]) == pytest.approx(4.0, abs=1e-5)


def test_grid_exact_binning_subset_and_coverage(mesh_scene):
    """SAT binning lists a subset of the AABB binning per cell, never loses a
    triangle, and strictly reduces total occupancy on a curved mesh."""
    scene, _, _ = mesh_scene
    verts = np.asarray(scene.meshes.verts)
    tris = np.asarray(scene.meshes.tris)
    t = scene.meshes.count
    ga = build_grid(verts, tris, capacity=16, exact=False)
    gx = build_grid(verts, tris, capacity=16, exact=True)
    ct_a = np.asarray(ga.cell_tris)
    ct_x = np.asarray(gx.cell_tris)
    for c in range(ct_a.shape[0]):
        sa = set(ct_a[c].tolist()) - {t}
        sx = set(ct_x[c].tolist()) - {t}
        # exact ⊆ aabb unless the AABB cell overflowed (then ⊆ aabb ∪ spill)
        assert sx <= sa | set(np.asarray(ga.overflow).tolist())
    in_x = set(ct_x.ravel().tolist()) - {t}
    in_x |= set(np.asarray(gx.overflow).tolist())
    assert in_x == set(range(t))
    assert (ct_x < t).sum() < (ct_a < t).sum()


def test_grid_exact_render_bitwise_identical(mesh_scene):
    """Exact binning is a pure candidate-set change: the walk still finds
    every hit in (or before) the hit point's own cell, so rendered images
    are bitwise identical to AABB binning."""
    scene, cam, opts = mesh_scene
    img_a = np.asarray(render(scene, cam, opts,
                              tracer=GridTracer.build(scene, exact=False))[0])
    img_x = np.asarray(render(scene, cam, opts,
                              tracer=GridTracer.build(scene, exact=True))[0])
    np.testing.assert_array_equal(img_x, img_a)


def test_grid_exact_excludes_diagonal_corner_cell():
    """A thin anti-diagonal sliver AABB-touches all 4 cells of a 2x2 grid but
    geometrically misses the far corner cell — SAT must drop it."""
    from raytracer.accel.satbin import tri_cells_overlap

    v0 = np.array([0.0, 1.0, 0.0])
    v1 = np.array([1.0, 0.0, 0.0])
    v2 = np.array([0.98, -0.02, 0.0])
    # 2x2 grid over ~[0,1.02]²: cell width 0.51; the sliver lies on/below the
    # x+y=1 diagonal, which clears the far-corner cell [0.51,1.02]² (the
    # (1,1,0) edge-cross axis separates with margin, no touching tie)
    half = np.array([0.255, 0.255, 0.5])
    centers = np.array([[0.255, 0.255, 0.0],
                        [0.765, 0.255, 0.0],  # below diagonal: overlapped
                        [0.255, 0.765, 0.0],  # above diagonal: overlapped
                        [0.765, 0.765, 0.0]])  # far corner: clear miss
    keep = tri_cells_overlap(v0, v1, v2, centers, half)
    assert keep[1] and keep[2]
    assert not keep[3]


def test_grid_skip_steps_bitwise_identical(mesh_scene):
    """Empty-cell fast-forward (skip_steps) only skips INF-contributing
    evals: (t, idx) must be bit-identical to the plain walk, both modes."""
    scene, cam, opts = mesh_scene
    from raytracer.ops import geometry as geom

    tr = GridTracer.build(scene, pregather=True)  # pregather: default layout
    v0, e1, e2 = tr._soa
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    for s in (2, 4):
        t0, i0 = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                           skip_steps=0)
        t1, i1 = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                           skip_steps=s)
        np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        mx = jnp.full(orig.shape[:1], 6.0, jnp.float32)
        o0, _ = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                          occlusion_max_t=mx, skip_steps=0)
        o1, _ = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                          occlusion_max_t=mx, skip_steps=s)
        np.testing.assert_array_equal(np.asarray(o0) < 6.0,
                                      np.asarray(o1) < 6.0)


def test_grid_fused_id_column_bitwise_identical(mesh_scene):
    """The 10-col pregathered SoA (ids ride column 9) must return bit-identical
    results to the 9-col + id-gather layout (the >=2^24-tris fallback),
    nearest and any-hit modes."""
    scene, cam, opts = mesh_scene
    from raytracer.ops import geometry as geom

    tr = GridTracer.build(scene, pregather=True)
    assert tr._grid.cell_soa.shape[-1] == 10
    g9 = dataclasses.replace(tr._grid, cell_soa=tr._grid.cell_soa[..., :9])
    v0, e1, e2 = tr._soa
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    mx = jnp.full(orig.shape[:1], 6.0, jnp.float32)
    out = []
    for g in (tr._grid, g9):
        t, i = grid_walk(g, v0, e1, e2, orig, dirs, opts.t_min)
        to, _ = grid_walk(g, v0, e1, e2, orig, dirs, opts.t_min,
                          occlusion_max_t=mx)
        out.append((np.asarray(t), np.asarray(i), np.asarray(to) < 6.0))
    for a, b in zip(out[0], out[1]):
        np.testing.assert_array_equal(a, b)


def test_grid_fanout_matches_sequential(mesh_scene):
    """fanout=K batches K consecutive cells into one gather. Results must
    match the sequential walk exactly away from exact-t cross-cell ties
    (the bumpy-sphere scene has none from this camera), nearest + any-hit."""
    scene, cam, opts = mesh_scene
    from raytracer.ops import geometry as geom

    tr = GridTracer.build(scene)
    v0, e1, e2 = tr._soa
    dirs = geom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    t0, i0 = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min, fanout=1)
    mx = jnp.full(orig.shape[:1], 6.0, jnp.float32)
    o0, _ = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                      occlusion_max_t=mx, fanout=1)
    for k in (2, 3, 4):
        t1, i1 = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                           fanout=k)
        # Tie-tolerant: hit distances must be bitwise equal everywhere (the
        # fanout overrun only ever folds extra real candidates at t>=best_t);
        # winner IDS may flip only on exact-t cross-cell ties, a knife-edge
        # set bounded like the RT_GRID_EXACT golden tolerance. The current
        # fixture has zero such ties — if an innocent fixture change
        # introduces a few, this stays green instead of going flaky.
        np.testing.assert_array_equal(np.asarray(t0), np.asarray(t1))
        flips = np.mean(np.asarray(i0) != np.asarray(i1))
        assert flips <= 1e-3, f"fanout={k}: {flips:.2%} id flips (not ties?)"
        o1, _ = grid_walk(tr._grid, v0, e1, e2, orig, dirs, opts.t_min,
                          occlusion_max_t=mx, fanout=k)
        np.testing.assert_array_equal(np.asarray(o0) < 6.0,
                                      np.asarray(o1) < 6.0)


@pytest.mark.slow
def test_grid_fanout_render_and_masking(mesh_scene):
    """End-to-end render through a fanout tracer equals the default tracer;
    active-mask contract (parked lanes → miss/INF) holds under fanout."""
    scene, cam, opts = mesh_scene
    ref = np.asarray(render(scene, cam, opts, tracer=GridTracer.build(scene))[0])
    tr = GridTracer.build(scene, fanout=3)
    img = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    np.testing.assert_array_equal(img, ref)

    rng = np.random.default_rng(11)
    n = 128
    orig = jnp.asarray(rng.normal(size=(n, 3)) * 2 +
                       np.array([0, 0, -5.5]), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    active = jnp.asarray(rng.random(n) < 0.5)
    tb, _ = grid_walk(tr._grid, *tr._soa, orig, d, 1e-4, active=active,
                      fanout=3)
    assert np.isinf(np.asarray(tb)[~np.asarray(active)]).all()
    full = tr.nearest(orig, d, 1e-4, 512)
    masked = tr.nearest(orig, d, 1e-4, 512, active=active)
    act = np.asarray(active)
    np.testing.assert_array_equal(np.asarray(masked.t)[act],
                                  np.asarray(full.t)[act])


def test_grid_occlusion_matches_brute(mesh_scene):
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
    tr = GridTracer.build(scene)
    got = tr.occluded(orig, d, max_t, 1e-4, 512)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_grid_active_mask_parks_lanes(mesh_scene):
    """active=False lanes return miss/INF; active lanes bitwise-unchanged.

    The wavefront renderer passes its alive mask so dead lanes stop driving
    the DDA while_loop trip count (renderer.bounce_step)."""
    scene, cam, opts = mesh_scene
    rng = np.random.default_rng(7)
    n = 256
    orig = jnp.asarray(rng.normal(size=(n, 3)) * 2 +
                       np.array([0, 0, -5.5]), jnp.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d, jnp.float32)
    active = jnp.asarray(rng.random(n) < 0.5)
    tr = GridTracer.build(scene)

    full = tr.nearest(orig, d, 1e-4, 512)
    masked = tr.nearest(orig, d, 1e-4, 512, active=active)
    act = np.asarray(active)
    np.testing.assert_array_equal(np.asarray(masked.t)[act],
                                  np.asarray(full.t)[act])
    np.testing.assert_array_equal(np.asarray(masked.idx)[act],
                                  np.asarray(full.idx)[act])
    # parked lanes: the grid contributes nothing (analytic prims still hit)
    tb, _ = grid_walk(tr._grid, *tr._soa, orig, d, 1e-4, active=active)
    assert np.isinf(np.asarray(tb)[~act]).all()
    # ... including via the overflow brute-scan (capacity=2 forces spill)
    tr2 = GridTracer.build(scene, capacity=2)
    assert tr2._grid.overflow.shape[0] > 0
    tb2, _ = grid_walk(tr2._grid, *tr2._soa, orig, d, 1e-4, active=active)
    assert np.isinf(np.asarray(tb2)[~act]).all()
    full2 = tr2.nearest(orig, d, 1e-4, 512)
    masked2 = tr2.nearest(orig, d, 1e-4, 512, active=active)
    np.testing.assert_array_equal(np.asarray(masked2.t)[act],
                                  np.asarray(full2.t)[act])

    max_t = jnp.full((n,), 4.0, jnp.float32)
    occ_full = np.asarray(tr.occluded(orig, d, max_t, 1e-4, 512))
    occ_mask = np.asarray(tr.occluded(orig, d, max_t, 1e-4, 512,
                                      active=active))
    np.testing.assert_array_equal(occ_mask[act], occ_full[act])
