"""Band-split rendering: render_banded == render bitwise; traced row0.

Mesh scenes render as one XLA program per horizontal band
(renderer._auto_band_rows); these tests pin the two invariants that make
that safe and cheap:
  1. banded output is a bitwise slice of the full frame (any band split),
  2. row0 may be a traced scalar — one compiled program serves every band
     of a given height, bitwise-identical to baking row0 as a constant.
"""

import dataclasses

import jax
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.ops import geometry as geom
from raytracer.renderer import render, render_banded


def _small(name, **kw):
    scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=64, height=64, tile_rays=4096, **kw)
    return scene, cam, opts


def test_raygen_traced_row0_bitwise():
    args = ((0.0, 0.5, 1.0), np.eye(3, dtype=np.float32), 60.0, 64, 64)
    conc = jax.jit(lambda: geom.raygen(*args, row0=17, rows=13))()
    trac = jax.jit(lambda r0: geom.raygen(*args, row0=r0, rows=13))(17)
    np.testing.assert_array_equal(np.asarray(conc), np.asarray(trac))


def test_banded_equals_full_analytic():
    # baseline under jit: banded bands ARE jit programs; eager render differs
    # from any jitted render by ~1e-4 (XLA fusion reassociation, longstanding)
    scene, cam, opts = _small("config2")
    full, n_full = jax.jit(
        lambda s, c: render(s, c, opts, count_rays=True))(scene, cam)
    for band_rows in (16, 24, 64):  # even split, ragged last band, single
        img, n = render_banded(scene, cam, opts, count_rays=True,
                               band_rows=band_rows)
        np.testing.assert_array_equal(np.asarray(img), np.asarray(full))
        assert float(n) == float(n_full)


def test_banded_equals_full_mesh_grid():
    from raytracer.accel.grid import GridTracer

    scene, cam, opts = _small("config4", max_depth=2)
    tracer = GridTracer.build(scene)
    full = jax.jit(
        lambda s, c, tr: render(s, c, opts, tracer=tr)[0])(scene, cam, tracer)
    img, _ = render_banded(scene, cam, opts, tracer=tracer, band_rows=24)
    np.testing.assert_array_equal(np.asarray(img), np.asarray(full))


def _apply_center(scene, p):
    s = dataclasses.replace(scene.spheres, center=p["center"])
    m = dataclasses.replace(scene.materials, albedo=p["albedo"])
    return scene.replace(spheres=s, materials=m)


@pytest.mark.slow
def test_value_and_grad_banded_matches_full():
    """Banded loss+grads == whole-frame value_and_grad (up to band-sum
    association) on a mesh scene — the gradient analog of render_banded."""
    import jax.numpy as jnp

    from raytracer.accel.grid import GridTracer
    from raytracer.renderer import value_and_grad_banded

    scene, cam, opts = _small("config4", max_depth=1)
    tracer = GridTracer.build(scene)
    target = render(scene, cam, opts, tracer=tracer)[0] * 0.9
    p0 = {"center": jnp.asarray(scene.spheres.center),
          "albedo": jnp.asarray(scene.materials.albedo)}

    def full_loss(p):
        img = render(_apply_center(scene, p), cam, opts, tracer=tracer)[0]
        return jnp.sum((img - target) ** 2) / (opts.width * opts.height * 3)

    v_full, g_full = jax.jit(jax.value_and_grad(full_loss))(p0)
    v_band, g_band = value_and_grad_banded(
        _apply_center, p0, scene, cam, opts, target, tracer=tracer,
        band_rows=24)
    np.testing.assert_allclose(float(v_band), float(v_full), rtol=1e-5)
    for k in g_full:
        np.testing.assert_allclose(np.asarray(g_band[k]),
                                   np.asarray(g_full[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_auto_bands_mesh_scene():
    """Auto band sizing splits mesh scenes under the fault budget."""
    from raytracer.renderer import _auto_band_rows

    scene, _, opts = presets.PRESETS["config4"]()   # 1920x1080 d4
    rows = _auto_band_rows(scene, opts)
    assert rows * opts.width * (opts.max_depth + 1) <= 2_400_000
    scene2, _, opts2 = presets.PRESETS["config2"]()
    assert _auto_band_rows(scene2, opts2) == opts2.height  # mesh-free: 1 band
