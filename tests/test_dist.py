"""Distributed tests on the 8-device CPU simulator (SURVEY.md §4.4).

The real shard_map code runs on 8 fake devices: sharded render must equal the
single-device render bitwise; ring-streaming must equal the all-resident trace;
gradients through shard_map must equal unsharded gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.parallel.mesh import make_rt_mesh
from raytracer.parallel.shard import render_sharded
from raytracer.renderer import render

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (simulated) devices")


@pytest.fixture(scope="module")
def scene_small():
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=64, height=48, tile_rays=256)
    return scene, cam, opts


@pytest.fixture(scope="module")
def ref_img(scene_small):
    scene, cam, opts = scene_small
    return np.asarray(render(scene, cam, opts)[0])


MESHES = [(8, 1, False), (4, 2, False), (2, 4, False), (1, 8, False),
          (4, 2, True), (2, 4, True), (1, 8, True)]


@pytest.mark.parametrize("tiles,prims,ring", MESHES,
                         ids=[f"t{t}p{p}{'r' if r else ''}" for t, p, r in MESHES])
def test_sharded_equals_single(scene_small, ref_img, tiles, prims, ring):
    scene, cam, opts = scene_small
    mesh = make_rt_mesh(tiles=tiles, prims=prims)
    img = np.asarray(render_sharded(scene, cam, opts, mesh, ring=ring)[0])
    if ring:
        # ring programs have been 1-ulp off the single-device render since
        # the tiny-table select-gather default: the select chains
        # fuse differently inside the ppermute loop's computation than in
        # the flat program — same class as every cross-context delta.
        np.testing.assert_allclose(img, ref_img, atol=1e-7)
    else:
        np.testing.assert_array_equal(img, ref_img)


@pytest.mark.slow
def test_sharded_mesh_scene(ref_img):
    """Triangle-mesh scene through prim sharding (tri shard path)."""
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=48, height=48, tile_rays=256,
                               max_depth=2)
    ref = np.asarray(render(scene, cam, opts)[0])
    mesh = make_rt_mesh(tiles=2, prims=4)
    # ulp-level tolerance: the sharded programs are different XLA computations
    # (different fusion/FMA contraction) and exact-tie shared-edge hits may
    # resolve to the equivalent co-planar triangle.
    img = np.asarray(render_sharded(scene, cam, opts, mesh)[0])
    np.testing.assert_allclose(img, ref, atol=1e-6)
    ring = np.asarray(render_sharded(scene, cam, opts, mesh, ring=True)[0])
    np.testing.assert_allclose(ring, ref, atol=1e-6)


def test_sharded_grid_tracer_equals_single():
    """The config4 headline backend (GridTracer) as a replicated pytree
    under shard_map pixel-tile DP == the single-device grid render."""
    from raytracer.accel.grid import GridTracer
    from raytracer.io import meshgen
    from raytracer.core.types import Meshes

    scene, cam, opts = presets.config4_mesh(use_obj=False)
    verts, tris = meshgen.bumpy_sphere(subdiv=3, radius=1.3)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32),
        normals=meshgen.vertex_normals(verts, tris)))
    opts = dataclasses.replace(opts, width=64, height=40, max_depth=2,
                               tile_rays=256)
    tracer = GridTracer.build(scene)
    ref = np.asarray(render(scene, cam, opts, tracer=tracer)[0])
    mesh = make_rt_mesh(tiles=4, prims=2)
    img = np.asarray(render_sharded(scene, cam, opts, mesh, tracer=tracer)[0])
    np.testing.assert_array_equal(img, ref)


def test_sharded_compacted_glass_equals_single():
    """Compacted glass wavefronts (opts.compact_cap) under shard_map: image
    matches the single-device compacted render, zero dropped lanes both
    sides (the exactness counter render_rays carries)."""
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=32, height=24, max_depth=3,
                               tile_rays=256, compact_cap=1)
    simg, _, sdrop = render(scene, cam, opts)
    mesh = make_rt_mesh(tiles=4, prims=2)
    dimg, _, ddrop = render_sharded(scene, cam, opts, mesh)
    assert float(sdrop) == 0.0 and float(ddrop) == 0.0
    np.testing.assert_allclose(np.asarray(dimg), np.asarray(simg), atol=1e-6)


@pytest.mark.slow
def test_sharded_grads_equal_unsharded(scene_small):
    scene, cam, opts = scene_small
    opts = dataclasses.replace(opts, width=32, height=32, tile_rays=256)
    mesh = make_rt_mesh(tiles=4, prims=2)
    target = render(scene, cam, opts)[0] * 0.0 + 0.25

    def loss_single(c):
        sc = scene.replace(spheres=dataclasses.replace(scene.spheres, center=c))
        return jnp.mean((render(sc, cam, opts)[0] - target) ** 2)

    def loss_sharded(c):
        sc = scene.replace(spheres=dataclasses.replace(scene.spheres, center=c))
        return jnp.mean((render_sharded(sc, cam, opts, mesh)[0] - target) ** 2)

    c0 = scene.spheres.center
    g1 = np.asarray(jax.grad(loss_single)(c0), np.float64)
    g2 = np.asarray(jax.grad(loss_sharded)(c0), np.float64)
    assert not np.isnan(g2).any()
    np.testing.assert_allclose(g2, g1, rtol=1e-4, atol=1e-8)


def test_ray_count_consistent(scene_small):
    scene, cam, opts = scene_small
    _, n1 = render(scene, cam, opts, count_rays=True)
    mesh = make_rt_mesh(tiles=4, prims=2)
    _, n2 = render_sharded(scene, cam, opts, mesh, count_rays=True)
    assert float(n1) == pytest.approx(float(n2), rel=1e-6)
