"""Forward correctness: wavefront JAX renderer vs the recursive NumPy oracle.

The structural cross-check of SURVEY.md §4.1: two independent implementations of
docs/SPEC.md (wavefront SoA vs literal recursion) must agree per pixel at small
resolutions. Full-resolution goldens (C++ oracle) live in test_forward_golden.py.
"""

import dataclasses

import numpy as np
import pytest

from raytracer.models import presets
from raytracer.renderer import render
from tests.helpers import assert_images_close
from tests.oracle.np_oracle import render_oracle

RES = 64


def _run(scene, cam, opts):
    opts = dataclasses.replace(opts, width=RES, height=RES)
    img = np.asarray(render(scene, cam, opts)[0])
    ref = render_oracle(scene, cam, opts)
    return img, ref


def test_config1_sphere_plane():
    img, ref = _run(*presets.config1_sphere_plane())
    assert_images_close(img, ref, name="config1")


def test_config2_mirror_spheres():
    img, ref = _run(*presets.config2_mirror_spheres())
    assert_images_close(img, ref, name="config2")


@pytest.mark.slow
def test_config3_cornell_glass():
    img, ref = _run(*presets.config3_cornell())
    assert_images_close(img, ref, name="config3")


def test_mesh_smooth_normals():
    """Small mesh scene exercising the triangle path with vertex normals."""
    scene, cam, opts = presets.config4_mesh(use_obj=False)
    # shrink the mesh for oracle speed: rebuild with a coarse icosphere
    from raytracer.core.types import Meshes
    from raytracer.io import meshgen

    verts, tris = meshgen.bumpy_sphere(subdiv=2, radius=1.3)
    normals = meshgen.vertex_normals(verts, tris)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32), normals=normals))
    opts = dataclasses.replace(opts, max_depth=2)
    img, ref = _run(scene, cam, opts)
    assert_images_close(img, ref, name="mesh")


def test_tile_boundary_invariance():
    """Radiance must not depend on the wavefront tile size."""
    scene, cam, opts = presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=40, height=24)
    a = np.asarray(render(scene, cam, dataclasses.replace(opts, tile_rays=960))[0])
    b = np.asarray(render(scene, cam, dataclasses.replace(opts, tile_rays=128))[0])
    # single-tile (no scan) vs scan are different XLA programs → fp fusion
    # differences of ~1e-5; semantics must agree to that level
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_ray_counting():
    scene, cam, opts = presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=16, height=16)
    _, traced = render(scene, cam, opts, count_rays=True)
    n = 16 * 16
    # max_depth=0: every pixel traces once; diffuse hits add 1 shadow ray each.
    assert float(traced) >= n
    assert float(traced) <= n * (1 + scene.lights.count)
