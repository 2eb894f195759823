"""The fused kernels as Pallas-on-Triton programs, checked without a GPU.

- Both kernels lower for CUDA here (`lowering_platforms=("cuda",)`), so a
  primitive Triton cannot lower fails on the CPU, before any chip time.
- Programs run in parallel on the GPU, so the train kernel writes one
  partial loss/gradient row per program and XLA sums them: the sum must not
  depend on the block size, and must equal jax.value_and_grad of the
  wavefront render.
- Off the GPU the kernels run only when the caller asks for the interpreter.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.ops import fused
from raytracer.renderer import render


def _small(config, depth, w=64, h=32):
    scene, cam, opts = presets.PRESETS[config]()
    return scene, cam, dataclasses.replace(opts, width=w, height=h,
                                           max_depth=depth, compact_cap=None)


@pytest.mark.parametrize("kernel,config,depth", [
    ("forward", "config2", 2), ("forward", "config3", 2),
    ("train", "config2", 2), ("train", "config5", 0)])
def test_kernel_lowers_for_cuda(kernel, config, depth):
    """Glass scenes train through XLA, so the train kernel is lowered for
    the non-glass configs it serves (config5 is the inverse-rendering
    preset)."""
    if config == "config5":
        scene, _, cam, opts = presets.config5_inverse()
        opts = dataclasses.replace(opts, width=64, height=32)
    else:
        scene, cam, opts = _small(config, depth)
    fw = fused.FusedWhitted(scene, cam, opts, param_inputs=True)
    tabs = (fw._psph, fw._ppln, fw._pmat, fw._plgt)
    plan_args = (fw, 0, opts.height, True, 0.0) + tabs
    if kernel == "forward":
        lowered = fw._render.trace(*plan_args).lower(
            lowering_platforms=("cuda",))
    else:
        _, wins, occs = jax.eval_shape(lambda: fw._render(*plan_args[1:]))
        zeros = lambda xs: [jnp.zeros(x.shape, x.dtype) for x in xs]  # noqa
        lowered = fw._train_vg.trace(
            fw, 0.0, opts.height, 0.0, *tabs, zeros(wins), zeros(occs),
            jnp.zeros((opts.height, opts.width, 3))).lower(
                lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "fused_whitted" in text  # the named Triton call is in the module


def _table_params(scene):
    return {"center": jnp.asarray(scene.spheres.center),
            "albedo": jnp.asarray(scene.materials.albedo)}


@pytest.mark.parametrize("vjp_tile", [(1, 32), (4, 16)])
def test_train_partials_sum_independent_of_block(vjp_tile):
    """Summed per-program partials: same for two block sizes (to float
    association), and equal to autodiff of the wavefront render."""
    scene, cam, opts = _small("config2", 1, 48, 24)
    tgt = np.asarray(render(scene, cam, opts)[0]) * 0.9
    n3 = opts.width * opts.height * 3
    runs = []
    for tile in ((2, 64), vjp_tile):
        fw = fused.FusedWhitted(scene, cam, opts, param_inputs=True,
                                interpret=True, vjp_tile=tile)
        loss, g, _ = fw.plan_value_and_grad(tgt)
        assert g["sph"].shape == (scene.spheres.count, 4)
        assert g["lgt"].shape == (np.asarray(scene.lights.pos).shape[0], 6)
        runs.append((float(loss), {k: np.asarray(v) for k, v in g.items()}))
    (l0, g0), (l1, g1) = runs
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for k in g0:
        scale = np.abs(g0[k]).max() + 1e-12
        np.testing.assert_allclose(g1[k] / scale, g0[k] / scale, atol=1e-6,
                                   err_msg=k)

    def wave_loss(p):
        s = scene.replace(
            spheres=dataclasses.replace(scene.spheres, center=p["center"]),
            materials=dataclasses.replace(scene.materials,
                                          albedo=p["albedo"]))
        return jnp.sum((render(s, cam, opts)[0] - tgt) ** 2)

    v_ref, g_ref = jax.value_and_grad(wave_loss)(_table_params(scene))
    np.testing.assert_allclose(l1, float(v_ref), rtol=1e-4)
    for key, tab in (("center", "sph"), ("albedo", "mat")):
        ref = np.asarray(g_ref[key])
        got = g1[tab][:ref.shape[0], 0:3]
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, atol=3e-3,
                                   err_msg=key)


def test_refuses_cpu_without_interpret():
    scene, cam, opts = _small("config1", 0)
    fw = fused.FusedWhitted(scene, cam, opts)
    with pytest.raises(RuntimeError, match="interpret=True"):
        fw.render()


def test_tables_padded_to_powers_of_two():
    """Triton blocks are powers of two: the parameter tables are padded,
    and bind() writes the real rows/columns only."""
    scene, cam, opts = _small("config3", 1)
    fw = fused.FusedWhitted(scene, cam, opts, param_inputs=True,
                            interpret=True)
    for tab, (name, cols) in zip((fw._psph, fw._ppln, fw._pmat, fw._plgt),
                                 fused.TABLE_COLS):
        r, c = np.asarray(tab).shape
        assert r == fused._pow2(r) >= fw._rows[name]
        assert c == fused._pow2(cols)
    fw.bind(albedo=np.full((fw._rows["mat"], 3), 0.25, np.float32))
    mat = np.asarray(fw._pmat)
    assert (mat[:fw._rows["mat"], :3] == 0.25).all()
    assert (mat[fw._rows["mat"]:] == 0).all() and (mat[:, 7:] == 0).all()
    with pytest.raises(AssertionError, match="powers of two"):
        fused.FusedWhitted(scene, cam, opts, tile=(3, 128))
