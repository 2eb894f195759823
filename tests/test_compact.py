"""Compacted-wavefront mode (opts.compact_cap): glass scenes stop doubling
ray buffers per bounce — lanes compact alive-first into a capped buffer with
carried pixel ids (renderer._compact / _fold scatter path).

Motivation (benchmarks/occupancy.py): config3 d4 runs 31x n0 buffer lanes at
5.5% weighted occupancy without compaction; with cap=1 the same frame is
exact (dropped == 0) at ~6x less lane work. SURVEY §7.3.2 — "compaction only
if occupancy <50% measured": measured.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.core.types import (
    DIFFUSE_AND_GLOSSY, REFLECTION_AND_REFRACTION, Camera, Lights, Planes,
    RenderOptions, Spheres, make_scene)
from raytracer.models import presets
from raytracer.renderer import render


@pytest.fixture(scope="module")
def cornell():
    scene, cam, opts = presets.PRESETS["config3"]()
    opts = dataclasses.replace(opts, width=96, height=96, tile_rays=4608)
    return scene, cam, opts


@pytest.mark.slow
def test_compact_matches_default(cornell):
    scene, cam, opts = cornell
    ref, n_ref = jax.jit(
        lambda s, c: render(s, c, opts, count_rays=True))(scene, cam)
    oc = dataclasses.replace(opts, compact_cap=1)
    img, n, drop = jax.jit(
        lambda s, c: render(s, c, oc, count_rays=True))(scene, cam)
    assert float(drop) == 0.0
    assert float(n) == float(n_ref)  # identical live-lane accounting
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref),
                               atol=1e-5)  # fold association only


@pytest.mark.slow
def test_compact_multi_tile_and_bands(cornell):
    scene, cam, opts = cornell
    oc1 = dataclasses.replace(opts, compact_cap=1)
    oc4 = dataclasses.replace(opts, compact_cap=1, tile_rays=1152)  # 8 tiles
    a = jax.jit(lambda s, c: render(s, c, oc1))(scene, cam)
    b = jax.jit(lambda s, c: render(s, c, oc4))(scene, cam)
    assert float(a[2]) == 0.0 and float(b[2]) == 0.0
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-5)


@pytest.mark.slow
def test_compact_gradients_match(cornell):
    scene, cam, opts = cornell
    opts = dataclasses.replace(opts, width=48, height=48, tile_rays=2304,
                               max_depth=3)

    def loss(p, o):
        sc = scene.replace(
            spheres=dataclasses.replace(scene.spheres, center=p))
        return jnp.mean(render(sc, cam, o)[0] ** 2)

    p0 = jnp.asarray(scene.spheres.center)
    g_ref = jax.grad(loss)(p0, opts)
    g_cmp = jax.grad(loss)(p0, dataclasses.replace(opts, compact_cap=1))
    np.testing.assert_allclose(np.asarray(g_cmp), np.asarray(g_ref),
                               rtol=1e-4, atol=1e-7)


def test_fractional_compact_mirror_scene():
    """Fractional caps compact single-child (non-glass) wavefronts: a small
    mirror sphere leaves most bounce-1 lanes dead, so cap=0.5 is exact
    (dropped==0) and matches the uncompacted image; a cap below the alive
    fraction must report drops."""
    from raytracer.models.presets import _mats
    from raytracer.core.types import REFLECTION

    mats = _mats(
        [(REFLECTION, (0, 0, 0), 0.0, 0.0, 25.0, 1.0),
         (DIFFUSE_AND_GLOSSY, (0.5, 0.3, 0.2), 0.8, 0.1, 10.0, 1.3)])
    scene = make_scene(
        spheres=Spheres.build([(0.0, 0.0, -6.0)], [1.0], [0]),
        planes=Planes.build([(0.0, -2.0, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [1]),
        materials=mats,
        lights=Lights.build([(0.0, 6.0, 0.0)], [(1.0, 1.0, 1.0)]))
    cam = Camera.build(pos=(0.0, 0.0, 1.0), fov_deg=50.0)
    base = RenderOptions(width=32, height=32, max_depth=2, tile_rays=1024)
    ref, n_ref = jax.jit(
        lambda s, c: render(s, c, base, count_rays=True))(scene, cam)
    oc = dataclasses.replace(base, compact_cap=0.5)
    img, n, drop = jax.jit(
        lambda s, c: render(s, c, oc, count_rays=True))(scene, cam)
    assert float(drop) == 0.0
    assert float(n) == float(n_ref)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-5)
    # starving cap: mirror covers more lanes than 8/1024
    tiny = dataclasses.replace(base, compact_cap=1 / 1024)
    _, _, drop2 = jax.jit(lambda s, c: render(s, c, tiny))(scene, cam)
    assert float(drop2) > 0.0


def test_compact_overflow_reported():
    """A frame-filling glass sphere spawns 2 alive children per pixel at
    bounce 0 — cap=1 must DROP lanes and say so (cap=2 must not)."""
    from raytracer.models.presets import _mats

    mats = _mats(
        [(REFLECTION_AND_REFRACTION, (0, 0, 0), 0.0, 0.0, 25.0, 1.5),
         (DIFFUSE_AND_GLOSSY, (0.5, 0.5, 0.5), 0.8, 0.1, 10.0, 1.3)])
    scene = make_scene(
        spheres=Spheres.build([(0.0, 0.0, -4.0)], [3.2], [0]),
        planes=Planes.build([(0.0, -3.5, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [1]),
        materials=mats,
        lights=Lights.build([(0.0, 6.0, 0.0)], [(1.0, 1.0, 1.0)]))
    cam = Camera.build(pos=(0.0, 0.0, 1.0), fov_deg=50.0)
    opts = RenderOptions(width=32, height=32, max_depth=2, tile_rays=1024,
                         compact_cap=1)
    img1, _, drop1 = jax.jit(lambda s, c: render(s, c, opts))(scene, cam)
    assert float(drop1) > 0.0
    o2 = dataclasses.replace(opts, compact_cap=2)
    img2, _, drop2 = jax.jit(lambda s, c: render(s, c, o2))(scene, cam)
    assert float(drop2) == 0.0
    ref = jax.jit(lambda s, c: render(
        s, c, dataclasses.replace(opts, compact_cap=None))[0])(scene, cam)
    np.testing.assert_allclose(np.asarray(img2), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("side", [256, pytest.param(512, marks=pytest.mark.slow)])
def test_config3_shipping_cap_exact(side):
    """The bench ships config3 at compact_cap 0.5 — the exact floor (0.375
    drops alive lanes at 1024²). Pin
    dropped == 0 at that cap in CI so a scene/preset change can't silently
    start clipping lanes; the gate otherwise lives only in bench post-timing.
    Strided tiles make per-tile occupancy ≈ frame occupancy (renderer), so
    the alive fraction — hence the floor — is resolution-stable; 256²/512²
    stand in for the 1024² bench frame at CPU-test cost.
    """
    scene, cam, opts = presets.PRESETS["config3"]()
    opts = dataclasses.replace(opts, width=side, height=side,
                               compact_cap=0.5)
    _, _, dropped = jax.jit(lambda s, c: render(s, c, opts))(scene, cam)
    assert float(dropped) == 0.0, (
        f"shipping cap 0.5 dropped {float(dropped)} alive lanes at {side}²")
