"""Per-tile culled dense sweep (accel/cull.py) + screen-block tile order.

Standard: with a non-overflowing cap the culled render equals the grid
render to 1 ulp (same broadcast `triangle_hits` fp as the dense scan path,
superset candidate lists, same lowest-id tie rule); block tile order is a
pure permutation — bitwise-identical images on every backend.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.accel.cull import CullTracer, build_cull, cull_audit
from raytracer.accel.grid import GridTracer
from raytracer.core.types import Meshes
from raytracer.io import meshgen
from raytracer.models import presets
from raytracer.renderer import block_perm, render


@pytest.fixture(scope="module")
def mesh_scene():
    scene, cam, opts = presets.config4_mesh(use_obj=False)
    verts, tris = meshgen.bumpy_sphere(subdiv=3, radius=1.3)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32),
        normals=meshgen.vertex_normals(verts, tris)))
    opts = dataclasses.replace(opts, width=96, height=64, max_depth=3,
                               tile_rays=1536)
    return scene, cam, opts


def test_block_perm_is_permutation():
    perm, inv = block_perm(rows=13, width=21, bh=4, bw=8)
    n_pix = 13 * 21
    valid = perm < n_pix
    assert sorted(perm[valid].tolist()) == list(range(n_pix))
    # inv really inverts: lane inv[p] must source pixel p
    assert (perm[inv] == np.arange(n_pix)).all()


def test_block_order_bitwise_identical(mesh_scene):
    """Per-pixel radiance is lane-local in the non-compacted wavefront, so
    re-tiling is a pure permutation — images must be bitwise equal."""
    scene, cam, opts = mesh_scene
    tr = GridTracer.build(scene)
    ref = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    ob = dataclasses.replace(opts, tile_block=(16, 96))
    img = np.asarray(render(scene, cam, ob, tracer=tr)[0])
    np.testing.assert_array_equal(img, ref)


def test_cull_matches_grid(mesh_scene):
    """Non-overflowing cap (audit-checked) ⇒ culled == grid to 1 ulp."""
    scene, cam, opts = mesh_scene
    ob = dataclasses.replace(opts, tile_block=(16, 96))
    aud = cull_audit(scene, cam, ob, cap=1280)
    assert aud["d0"].max() <= 1280 and aud["shadow"].max() <= 1280
    ref = np.asarray(render(scene, cam, ob, tracer=GridTracer.build(scene))[0])
    img = np.asarray(render(scene, cam, ob,
                            tracer=CullTracer.build(scene, cap=1280))[0])
    assert np.abs(img - ref).max() <= 2e-7


def test_cull_all_depths_matches(mesh_scene):
    """Culling every bounce's calls (divergent secondary rays → fat lists,
    still under this tiny mesh's T) stays exact — the cursor maps calls to
    depths correctly beyond d0."""
    scene, cam, opts = mesh_scene
    ref = np.asarray(render(scene, cam, opts,
                            tracer=GridTracer.build(scene))[0])
    tr = CullTracer.build(scene, cap=1280, cull_depths=(0, 1, 2, 3))
    img = np.asarray(render(scene, cam, opts, tracer=tr)[0])
    assert np.abs(img - ref).max() <= 2e-7


def test_cull_overflow_detected_by_audit(mesh_scene):
    """A too-small cap truncates candidate lists: the audit reports counts
    above cap (the gate) and the render visibly diverges — documents WHY
    the gate is mandatory."""
    scene, cam, opts = mesh_scene
    aud = cull_audit(scene, cam, opts, cap=128)
    assert max(aud["d0"].max(), aud["shadow"].max()) > 128
    ref = np.asarray(render(scene, cam, opts,
                            tracer=GridTracer.build(scene))[0])
    img = np.asarray(render(scene, cam, opts,
                            tracer=CullTracer.build(scene, cap=128))[0])
    assert np.abs(img - ref).max() > 1e-3


def test_cull_gradients_match_grid(mesh_scene):
    """value_and_grad through the culled tracer == through the grid tracer:
    the winner ids are identical (superset search) and the remat backward
    re-traces render_rays, where fresh() re-zeros the call cursor — the
    remat-safety property this test pins."""
    scene, cam, opts = mesh_scene
    opts = dataclasses.replace(opts, width=48, height=32, max_depth=2,
                               tile_rays=512, tile_block=(8, 64))
    p0 = {"center": jnp.asarray(scene.spheres.center),
          "albedo": jnp.asarray(scene.materials.albedo)}

    def loss(p, tracer):
        sc = scene.replace(
            spheres=dataclasses.replace(scene.spheres, center=p["center"]),
            materials=dataclasses.replace(scene.materials,
                                          albedo=p["albedo"]))
        img = render(sc, cam, opts, tracer=tracer)[0]
        return jnp.sum(img ** 2)

    vg = jax.value_and_grad(loss)
    v_g, g_g = vg(p0, GridTracer.build(scene))
    v_c, g_c = vg(p0, CullTracer.build(scene, cap=1280))
    np.testing.assert_allclose(float(v_c), float(v_g), rtol=1e-6)
    for k in p0:
        np.testing.assert_allclose(np.asarray(g_c[k]), np.asarray(g_g[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


def test_build_cull_rounds_cap_to_chunks(mesh_scene):
    scene, _, _ = mesh_scene
    cd = build_cull(scene, cap=200, chunk=128)
    assert cd.cap == 256
    assert cd.soa.shape == (int(scene.meshes.count) + 1, 9)
