"""Fused Whitted megakernel (ops/fused.py) vs the wavefront renderer.

The single-kernel forward must reproduce the default path on mesh-free
scenes up to float-association noise, including bands, checker planes,
shadows, and mirror bounces. Runs in Pallas interpret mode on CPU.
"""

import dataclasses

import numpy as np
import pytest

from raytracer.models import presets
from raytracer.ops import fused
from raytracer.renderer import render
from tests.helpers import assert_images_close


def _fw(scene, cam, opts):
    return fused.FusedWhitted(scene, cam, opts, interpret=True)


def test_supported_gate():
    scene1, _, _ = presets.config1_sphere_plane()
    assert fused.supported(scene1)
    scene3, _, _ = presets.config3_cornell()
    assert fused.supported(scene3)  # tiny flat mesh + glass: baked/unrolled
    scene4, _, _ = presets.config4_mesh(use_obj=False)
    assert not fused.supported(scene4)  # big smooth mesh → grid/BVH tracers


@pytest.mark.slow
def test_fused_config3_glass_cornell():
    """Glass recursion + baked Cornell triangles vs the wavefront renderer.

    Exercises refract/TIR/fresnel weighting and the sphere<plane<tri tie
    order through the depth-first unrolled tree.
    """
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=96, height=96, max_depth=3)
    ref = np.asarray(render(scene, cam, opts)[0])
    img = np.asarray(_fw(scene, cam, opts).render())
    # glass paths multiply 4 fresnel factors — association noise grows, but
    # a wrong branch/weight would be O(0.5) over whole regions
    assert_images_close(img, ref, tol=1e-2, max_bad_frac=0.003, name="fused3")
    assert np.abs(img - ref).mean() < 1e-3


def test_fused_glass_depth_cap():
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, max_depth=fused.MAX_GLASS_DEPTH + 1)
    with pytest.raises(AssertionError):
        _fw(scene, cam, opts)


def test_fused_config1_matches_wavefront():
    scene, cam, opts = presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=128, height=128)
    ref = np.asarray(render(scene, cam, opts)[0])
    img = np.asarray(_fw(scene, cam, opts).render())
    assert_images_close(img, ref, tol=1e-5, max_bad_frac=0.002, name="fused1")


def test_fused_config2_mirror_checker():
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=128, height=128, max_depth=2)
    ref = np.asarray(render(scene, cam, opts)[0])
    img = np.asarray(_fw(scene, cam, opts).render())
    # mirror bounce + specular pow amplify fma-association noise to ~3e-3 on
    # a fraction of pixels; a true winner flip would be O(0.5)
    assert_images_close(img, ref, tol=1e-2, max_bad_frac=0.0005, name="fused2")
    assert np.abs(img - ref).mean() < 1e-4


@pytest.mark.slow
def test_fused_band_split():
    """Band renders must tile into exactly the full-frame render (and exercise
    non-multiple-of-8 band heights)."""
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=128, height=96, max_depth=1)
    fw = _fw(scene, cam, opts)
    full = np.asarray(fw.render())
    parts = [np.asarray(fw.render(row0=r0, rows=rows))
             for r0, rows in ((0, 37), (37, 40), (77, 19))]
    # programs of different grid shapes may differ by an ulp; a band-offset
    # or cropping bug would be O(1)
    np.testing.assert_allclose(np.concatenate(parts, axis=0), full,
                               atol=1e-6, rtol=0)


@pytest.mark.slow
def test_fused_odd_width():
    """Width not a lane multiple: padded columns must be cropped, not leak."""
    scene, cam, opts = presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=100, height=64)
    ref = np.asarray(render(scene, cam, opts)[0])
    img = np.asarray(_fw(scene, cam, opts).render())
    assert img.shape == ref.shape == (64, 100, 3)
    assert_images_close(img, ref, tol=1e-5, max_bad_frac=0.002, name="fusedw")


@pytest.mark.gpu
def test_fused_compiled_matches_wavefront_on_gpu(gpu):
    """The kernel as Triton compiles it for the card (no interpreter)."""
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=256, height=128, max_depth=2)
    ref = np.asarray(render(scene, cam, opts)[0])
    img = np.asarray(fused.FusedWhitted(scene, cam, opts).render())
    assert_images_close(img, ref, tol=1.5 / 255, max_bad_frac=0.002,
                        name="fused-gpu")
