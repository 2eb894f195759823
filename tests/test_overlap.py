"""Bounce-pipelined backward (parallel/overlap.py) == standard autodiff.

The per-bounce-psum sweep must produce the same loss and the same scene-float
gradients as plain jax.value_and_grad over the IDENTICAL pipeline
(overlap=False — one fused end-of-backward psum), on both tracer backends,
with and without glass (buffer doubling). The comparison is tight because
both modes share one forward program; comparisons against render_sharded are
only sanity-loose (knife-edge pixels flip between separately compiled
programs — see the module docstring).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.parallel.mesh import make_rt_mesh
from raytracer.parallel.overlap import (float_partition,
                                            loss_and_grad_overlapped)
from raytracer.parallel.shard import render_sharded


def _compare(scene, cam, opts, mesh, ring=False):
    target = np.asarray(
        jax.jit(lambda s, c: render_sharded(s, c, opts, mesh)[0])(
            scene, cam)) * 0.9
    loss_o, grad_o = loss_and_grad_overlapped(scene, cam, opts, mesh,
                                              target, ring=ring)
    loss_f, grad_f = loss_and_grad_overlapped(scene, cam, opts, mesh,
                                              target, ring=ring,
                                              overlap=False)
    np.testing.assert_allclose(float(loss_o), float(loss_f),
                               rtol=1e-6, atol=1e-12)
    go, _, _ = float_partition(grad_o)
    gf, _, _ = float_partition(grad_f)
    assert len(go) == len(gf)
    for a, b in zip(go, gf):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-7)
    # the gradients must be non-trivial for the test to mean anything
    assert any(float(jnp.max(jnp.abs(g))) > 1e-6 for g in go)
    return float(loss_o)


@pytest.fixture
def mesh8():
    return make_rt_mesh(tiles=4, prims=2, devices=jax.devices()[:8])


@pytest.mark.slow
def test_overlap_mirror_scene(mesh8):
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=64, height=64, max_depth=2)
    _compare(scene, cam, opts, mesh8)


@pytest.mark.slow
def test_overlap_glass_scene(mesh8):
    """Glass: ray buffers statically double per bounce; the reverse sweep
    must thread the doubled state cotangents correctly."""
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=48, height=48, max_depth=2)
    _compare(scene, cam, opts, mesh8)


@pytest.mark.slow
def test_overlap_ring_tracer(mesh8):
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=64, height=64, max_depth=1)
    _compare(scene, cam, opts, mesh8, ring=True)


@pytest.mark.slow
def test_overlap_uneven_pixels(mesh8):
    """Pixel count not divisible by the tile axis: padded lanes must not
    contribute to loss or gradients."""
    scene, cam, opts = presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=54, height=37, max_depth=1)
    _compare(scene, cam, opts, mesh8)


def test_overlap_loss_sane_vs_render_sharded(mesh8):
    """Loose cross-check: the pipeline's loss is the render_sharded MSE up to
    knife-edge pixel flips between separately compiled forwards."""
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=64, height=64, max_depth=2)
    img = jax.jit(lambda s, c: render_sharded(s, c, opts, mesh8)[0])(scene,
                                                                     cam)
    target = np.asarray(img) * 0.9
    want = float(jnp.mean((img - target) ** 2))
    got, _ = loss_and_grad_overlapped(scene, cam, opts, mesh8, target)
    assert abs(float(got) - want) < 5e-3 + 0.1 * want
