"""Golden-image tests: JAX renderer vs committed C++-oracle renders.

The goldens in tests/golden/ are produced by `python tools/make_golden.py`
(native/oracle.cpp, double precision, docs/SPEC.md-exact) — the project's
equivalent of the reference binary's comparison images (SURVEY.md §4.1).
Comparison is at u8-PPM precision (±1.5/255) with a small allowance for
fp32 silhouette/seam pixel flips.
"""

import dataclasses
import os

import numpy as np
import pytest

from raytracer.io.image import load_ppm
from raytracer.models import presets
from raytracer.renderer import render
from tests.helpers import assert_images_close

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

CASES = [
    ("config1", 256, 256, 0.004),
    ("config2", 96, 96, 0.004),
    pytest.param("config3", 96, 96, 0.004, marks=pytest.mark.slow),
    pytest.param("config4", 192, 108, 0.004, marks=pytest.mark.slow),
    ("config7", 128, 128, 0.004),   # UV-checkered mesh (SPEC mesh_uv)
]


@pytest.mark.parametrize("name,w,h,tol", CASES)
def test_golden(name, w, h, tol):
    path = os.path.join(GOLDEN, f"{name}_{w}x{h}.ppm")
    if not os.path.exists(path):
        pytest.skip(f"golden missing: {path} (run tools/make_golden.py)")
    want = load_ppm(path)
    scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=w, height=h)
    img = np.asarray(render(scene, cam, opts)[0])
    assert_images_close(img, want, tol=tol, max_bad_frac=0.004, name=name)


@pytest.mark.slow
def test_golden_config2_full():
    path = os.path.join(GOLDEN, "config2_256x256.ppm")
    if not os.path.exists(path):
        pytest.skip("golden missing")
    want = load_ppm(path)
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=256, height=256)
    img = np.asarray(render(scene, cam, opts)[0])
    assert_images_close(img, want, tol=0.004, max_bad_frac=0.004,
                        name="config2_256")
