"""In-kernel fused VJP (ops/fused.plan_value_and_grad) vs the wavefront
value_and_grad — SURVEY §3.3's fused-backward component.

Standard: the kernel's loss matches the wavefront band loss to fp noise and
its analytic parameter gradients match the wavefront autodiff grads to the
knife-edge tolerance (winner associations differ 1 ulp near silhouettes;
grads are dominated by interior pixels). A central-finite-difference probe
pins the kernel against ground truth independently of either autodiff.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.ops.fused import FusedWhitted
from raytracer.renderer import render


def _with_p(scene, p):
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


def _wave_vg(scene, cam, opts, tgt, p0):
    n = opts.width * opts.height

    def loss(p):
        img = render(_with_p(scene, p), cam, opts)[0]
        return jnp.sum((img - tgt) ** 2) / (n * 3)

    return jax.value_and_grad(loss)(p0)


def _kernel_vg(scene, cam, opts, tgt):
    fw = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    loss, g, img = fw.plan_value_and_grad(np.asarray(tgt))
    # self-consistency: the kernel's accumulated loss must equal the L2 of
    # ITS OWN forward image vs the target, bit-for-bit-close — this pins the
    # in-kernel accumulation independent of any cross-path id flips
    own = float(np.sum((np.asarray(img, np.float64)
                        - np.asarray(tgt, np.float64)) ** 2))
    np.testing.assert_allclose(float(loss), own, rtol=1e-4)
    s = 1.0 / (opts.width * opts.height * 3)
    ns = scene.spheres.count
    nm = np.asarray(scene.materials.albedo).shape[0]
    return (float(loss) * s,
            {"center": np.asarray(g["sph"])[:ns, 0:3] * s,
             "albedo": np.asarray(g["mat"])[:nm, 0:3] * s})


@pytest.mark.parametrize("config,depth,size", [
    ("config2", 2, (96, 64)),
])
def test_kernel_vg_matches_wavefront(config, depth, size):
    scene, cam, opts = presets.PRESETS[config]()
    opts = dataclasses.replace(opts, width=size[0], height=size[1],
                               max_depth=depth, compact_cap=None)
    tgt = render(scene, cam, opts)[0] * 0.9
    p0 = {"center": jnp.asarray(scene.spheres.center),
          "albedo": jnp.asarray(scene.materials.albedo)}
    v_ref, g_ref = _wave_vg(scene, cam, opts, tgt, p0)
    v_k, g_k = _kernel_vg(scene, cam, opts, tgt)
    # cross-path loss: fused-vs-wavefront knife-edge id flips put |Δ|≈O(1)
    # at a handful of pixels where the wavefront target has diff 0 — a
    # QUADRATIC amplification at tiny frames. The kernel's own-loss
    # consistency is
    # asserted exactly in _kernel_vg; across paths, bound the loss delta by
    # the MEASURED flip budget: count the actually-flipped subpixels.
    # v_k == L2(kernel's own image) is pinned in _kernel_vg and v_ref ==
    # L2(wavefront image) by construction, so the cross-path loss delta is
    # fully determined by the image flips — assert the flips are few and
    # the delta matches them exactly instead of inventing a budget.
    wave_img = np.asarray(render(scene, cam, opts)[0], np.float64)
    fw = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    kimg = np.asarray(fw.plan_value_and_grad(tgt)[2], np.float64)
    flips = np.abs(kimg - wave_img) > 0.02
    assert flips.mean() <= 0.01, f"too many knife-edge flips: {flips.mean()}"
    t64 = np.asarray(tgt, np.float64)
    n3 = opts.width * opts.height * 3
    expect_delta = (np.sum((kimg - t64) ** 2)
                    - np.sum((wave_img - t64) ** 2)) / n3
    np.testing.assert_allclose(v_k - float(v_ref), expect_delta, rtol=1e-3,
                               atol=1e-6)
    # cross-path grad tolerance: flipped pixels carry O(1) cotangents in one
    # path and O(0.1) in the other, so each flip perturbs the summed grads
    for k, tol in (("albedo", 1e-4), ("center", 3e-3)):
        ref = np.asarray(g_ref[k])
        scale = np.abs(ref).max() + 1e-12
        np.testing.assert_allclose(g_k[k] / scale, ref / scale, atol=tol,
                                   err_msg=k)


def test_kernel_vg_refuses_glass():
    """Glass scenes train through XLA's autodiff: the glass tree's in-kernel
    value_and_grad compiled too slowly on the GPU to pay (PERF.md)."""
    scene, cam, opts = presets.PRESETS["config3"]()
    opts = dataclasses.replace(opts, width=32, height=16, max_depth=1)
    fw = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    with pytest.raises(AssertionError, match="without glass"):
        fw._train_vg(0.0, opts.height, 0.0, fw._psph, fw._ppln, fw._pmat,
                     fw._plgt, [], [], np.zeros((16, 32, 3), np.float32))


def test_kernel_vg_matches_finite_differences():
    """Central FD on a handful of parameters — ground truth independent of
    both autodiff paths (SURVEY §4.3's gradcheck discipline)."""
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=64, height=48, max_depth=1)
    tgt = np.asarray(render(scene, cam, opts)[0]) * 0.9
    n = opts.width * opts.height
    _, g_k = _kernel_vg(scene, cam, opts, tgt)

    def loss_at(scene2):
        img = render(scene2, cam, opts)[0]
        return float(jnp.sum((img - tgt) ** 2) / (n * 3))

    eps = 3e-4
    # albedo[0][0] and center[0][1] — away from silhouette-dominated axes
    for (key, idx) in (("albedo", (0, 0)), ("center", (0, 1))):
        p_hi = {"center": np.array(scene.spheres.center, np.float64),
                "albedo": np.array(scene.materials.albedo, np.float64)}
        p_lo = {k: v.copy() for k, v in p_hi.items()}
        p_hi[key][idx] += eps
        p_lo[key][idx] -= eps
        fd = (loss_at(_with_p(scene, p_hi)) - loss_at(_with_p(scene, p_lo))) \
            / (2 * eps)
        got = g_k[key][idx]
        # FD itself carries O(eps²) truncation + f32 render noise: ask for
        # 5% relative + a small absolute floor, not fp-level equality
        assert abs(got - fd) <= 0.05 * abs(fd) + 2e-6, (key, idx, got, fd)


def test_kernel_vg_covers_all_table_classes():
    """Every C13 class the fused path carries gets a nonzero gradient
    somewhere (plane albedo2 via the checker, light pos/intensity, kd/ks)."""
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=64, height=48, max_depth=1)
    tgt = np.asarray(render(scene, cam, opts)[0]) * 0.9
    fw = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    _, g, _ = fw.plan_value_and_grad(tgt)
    assert np.abs(np.asarray(g["pln"])).max() > 0      # plane geom/albedo2
    assert np.abs(np.asarray(g["lgt"])).max() > 0      # light pos/intensity
    assert np.abs(np.asarray(g["mat"])[:, 3:5]).max() > 0  # kd/ks


def test_kernel_vg_sharded_matches_single_device():
    """plan_value_and_grad_sharded on a 4-device 'tiles' mesh == the
    single-device step up to band-sum fp association (the gradient-DP
    twin of the r5 trainer; runs on the conftest's 8 simulated devices)."""
    import jax

    from raytracer.parallel.mesh import make_rt_mesh

    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=96, height=64)
    tgt = np.asarray(render(scene, cam, opts)[0]) * 0.9
    fw = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    l1, g1, _ = fw.plan_value_and_grad(tgt)
    mesh = make_rt_mesh(tiles=4, prims=1, devices=jax.devices()[:4])
    ls, gs = fw.plan_value_and_grad_sharded(tgt, mesh)
    np.testing.assert_allclose(float(ls), float(l1), rtol=1e-5)
    for k in ("sph", "pln", "mat", "lgt"):
        a, b = np.asarray(gs[k]), np.asarray(g1[k])
        scale = np.abs(b).max() + 1e-9
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4,
                                   err_msg=k)
