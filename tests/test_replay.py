"""Fused-plan replay training path (ops/replay.py + fused.render_plan).

The fused megakernel emits the winner-search plan (per-bounce prim index +
per-light occlusion bits) for non-glass scenes; PlanTracer replays it
through the unchanged wavefront loop so value_and_grad differentiates only
the shading recompute. Correctness bar: replay image == wavefront render
(same recompute, fused-vs-wavefront knife-edge ids excepted) and replay
gradients == the banded reference path to association noise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.ops.fused import FusedWhitted
from raytracer.ops.replay import replay_render, value_and_grad_replay
from raytracer.renderer import render, value_and_grad_banded

RES = 64


@pytest.fixture(scope="module")
def c2():
    scene, cam, opts = presets.PRESETS["config2"]()
    return scene, cam, dataclasses.replace(opts, width=RES, height=RES)


def test_replay_image_matches_wavefront(c2):
    scene, cam, opts = c2
    _, wins, occs = FusedWhitted(scene, cam, opts, interpret=True).render_plan()
    img_r = replay_render(scene, cam, opts, (wins, occs))[0]
    ref = render(scene, cam, opts)[0]
    d = np.abs(np.asarray(img_r) - np.asarray(ref)).max(axis=-1)
    # same differentiable recompute fed the same ids — only knife-edge id
    # flips (fused-vs-wavefront association class) may differ
    assert (d > 1.5 / 255).mean() < 0.002
    assert np.median(d) == 0.0


def test_replay_banded(c2):
    scene, cam, opts = c2
    fused = FusedWhitted(scene, cam, opts, interpret=True)
    ref = render(scene, cam, opts)[0]
    rows = RES // 2
    parts = []
    for r0 in (0, rows):
        _, wins, occs = fused.render_plan(row0=r0, rows=rows)
        parts.append(replay_render(scene, cam, opts, (wins, occs), row0=r0,
                                   rows=rows)[0])
    img = jnp.concatenate(parts, axis=0)
    d = np.abs(np.asarray(img) - np.asarray(ref)).max(axis=-1)
    assert (d > 1.5 / 255).mean() < 0.002


def _params(scene):
    return {"center": jnp.asarray(scene.spheres.center),
            "albedo": jnp.asarray(scene.materials.albedo)}


def _apply(scene, p):
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


@pytest.mark.parametrize("param_inputs", [False, True])
def test_replay_grads_match_banded(c2, param_inputs):
    scene, cam, opts = c2
    params = _params(scene)
    target = render(scene, cam, opts)[0] * 0.9
    v1, g1 = value_and_grad_banded(_apply, params, scene, cam, opts, target)
    if param_inputs:
        fused = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
        builder = lambda p: fused.bind(center=p["center"],
                                       albedo=p["albedo"])
    else:
        builder = lambda p: FusedWhitted(_apply(scene, p), cam, opts,
                                         interpret=True)
    v2, g2 = value_and_grad_replay(_apply, params, scene, cam, opts, target,
                                   builder)
    assert abs(float(v1) - float(v2)) < 1e-5 * max(abs(float(v1)), 1e-9) \
        + 1e-8
    for k in g1:
        scale = float(jnp.abs(g1[k]).max()) + 1e-9
        assert float(jnp.abs(g1[k] - g2[k]).max()) <= 2e-3 * scale


def test_replay_tiled(c2):
    """Tiled replay (tile_rays < band): any two SCANNED tilings are bitwise
    equal; scan-vs-single-tile sits in renderer.render's own per-context fp
    association class; odd (non-multiple-of-8) bands pad cleanly (the old
    single-tile path asserted on them); grads match the banded reference."""
    scene, cam, opts = c2
    fused = FusedWhitted(scene, cam, opts, interpret=True)
    _, wins, occs = fused.render_plan()
    plan = (wins, occs)
    single = np.asarray(replay_render(scene, cam, opts, plan)[0])
    t1 = np.asarray(replay_render(scene, cam, opts, plan, tile_rays=512)[0])
    t2 = np.asarray(replay_render(scene, cam, opts, plan, tile_rays=1024)[0])
    np.testing.assert_array_equal(t1, t2)
    ref_t = np.asarray(render(
        scene, cam, dataclasses.replace(opts, tile_rays=512))[0])
    # scan-context twin: tiled replay == tiled wavefront render off edges
    d = np.abs(t1 - ref_t).max(axis=-1)
    assert (d > 1.5 / 255).mean() < 0.002 and np.median(d) == 0.0
    d1 = np.abs(t1 - single).max(axis=-1)
    assert d1.max() < 1e-3  # association class only

    # odd band: 31x42 = 1302 lanes (not a multiple of 8)
    odd = dataclasses.replace(opts, width=42, height=31)
    fo = FusedWhitted(scene, cam, odd, interpret=True)
    io_, w_, o_ = fo.render_plan()
    ro = replay_render(scene, cam, odd, (w_, o_))[0]
    assert ro.shape == (31, 42, 3) and bool(jnp.isfinite(ro).all())

    # gradient path with tiling
    params = _params(scene)
    target = render(scene, cam, opts)[0] * 0.9
    v1, g1 = value_and_grad_banded(_apply, params, scene, cam, opts, target)
    fp = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    builder = lambda p: fp.bind(center=p["center"], albedo=p["albedo"])
    v2, g2 = value_and_grad_replay(_apply, params, scene, cam, opts, target,
                                   builder, tile_rays=512)
    assert abs(float(v1) - float(v2)) < 1e-4 * max(abs(float(v1)), 1e-9) \
        + 1e-8
    for k in g1:
        scale = float(jnp.abs(g1[k]).max()) + 1e-9
        assert float(jnp.abs(g1[k] - g2[k]).max()) <= 2e-3 * scale


def test_param_bind_matches_rebake(c2):
    scene, cam, opts = c2
    fp = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    c2_ = np.asarray(scene.spheres.center).copy()
    c2_[0] += 0.3
    al = np.asarray(scene.materials.albedo).copy()
    al[0] = [0.9, 0.1, 0.2]
    s2 = _apply(scene, {"center": c2_, "albedo": al})
    ref = FusedWhitted(s2, cam, opts, interpret=True).render()
    got = fp.bind(center=c2_, albedo=al).render()
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-5)


_CLASSES = {
    # param class -> (scene graft, bind kwarg)
    "center": lambda s, v: s.replace(
        spheres=dataclasses.replace(s.spheres, center=v)),
    "radius": lambda s, v: s.replace(
        spheres=dataclasses.replace(s.spheres, radius=v)),
    "albedo": lambda s, v: s.replace(
        materials=dataclasses.replace(s.materials, albedo=v)),
    "ks": lambda s, v: s.replace(
        materials=dataclasses.replace(s.materials, ks=v)),
    "spec_n": lambda s, v: s.replace(
        materials=dataclasses.replace(s.materials, spec_n=v)),
    "plane_point": lambda s, v: s.replace(
        planes=dataclasses.replace(s.planes, point=v)),
    "plane_albedo2": lambda s, v: s.replace(
        planes=dataclasses.replace(s.planes, albedo2=v)),
    "light_pos": lambda s, v: s.replace(
        lights=dataclasses.replace(s.lights, pos=v)),
    "light_intensity": lambda s, v: s.replace(
        lights=dataclasses.replace(s.lights, intensity=v)),
}

_INIT = {
    "center": lambda s: s.spheres.center,
    "radius": lambda s: s.spheres.radius,
    "albedo": lambda s: s.materials.albedo,
    "ks": lambda s: s.materials.ks,
    "spec_n": lambda s: s.materials.spec_n,
    "plane_point": lambda s: s.planes.point,
    "plane_albedo2": lambda s: s.planes.albedo2,
    "light_pos": lambda s: s.lights.pos,
    "light_intensity": lambda s: s.lights.intensity,
}


def test_replay_grads_every_param_class():
    """The fused-plan training path must carry EVERY
    C13 parameter class, not just centers+albedo — per class, bind() feeds
    the param-input kernel (plan refresh, no recompile) and the replay
    grads agree with the banded wavefront reference. Subprocess-isolated:
    the ~30 extra program compiles trip the in-suite XLA:CPU
    backend_compile segfault (see _run_isolated) when the whole quick tier
    has compiled before this test."""
    _run_isolated("""
import jax, dataclasses
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
from raytracer.models import presets
from raytracer.renderer import render, value_and_grad_banded
from raytracer.ops.fused import FusedWhitted
from raytracer.ops.replay import value_and_grad_replay
from tests.test_replay import _CLASSES, _INIT

scene, cam, opts = presets.PRESETS['config2']()
opts = dataclasses.replace(opts, width=64, height=64)
target = render(scene, cam, opts)[0] * 0.9
fp = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
for cls in sorted(_CLASSES):
    params = {cls: jnp.asarray(_INIT[cls](scene))}
    apply_c = (lambda cls: lambda s, p: _CLASSES[cls](s, p[cls]))(cls)
    v1, g1 = value_and_grad_banded(apply_c, params, scene, cam, opts,
                                   target)
    builder = (lambda cls: lambda p: fp.bind(**{cls: p[cls]}))(cls)
    v2, g2 = value_and_grad_replay(apply_c, params, scene, cam, opts,
                                   target, builder)
    assert abs(float(v1) - float(v2)) < 1e-4 * max(abs(float(v1)), 1e-9) \
        + 1e-8, cls
    g1v, g2v = g1[cls], g2[cls]
    scale = float(jnp.abs(g1v).max()) + 1e-9
    assert float(jnp.abs(g1v - g2v).max()) <= 2e-3 * scale, cls
print('all classes OK')
""", timeout=2400)


def test_replay_zero_recompiles_mixed_params(c2):
    """10 optimizer-ish steps moving EVERY bound class: the band program and
    the fused kernel must each compile exactly once (jit cache size 1)."""
    scene, cam, opts = c2
    fp = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
    params = {
        "center": jnp.asarray(scene.spheres.center),
        "radius": jnp.asarray(scene.spheres.radius),
        "albedo": jnp.asarray(scene.materials.albedo),
        "ks": jnp.asarray(scene.materials.ks),
        "light_pos": jnp.asarray(scene.lights.pos),
    }

    def apply_m(s, p):
        s = s.replace(spheres=dataclasses.replace(
            s.spheres, center=p["center"], radius=p["radius"]))
        s = s.replace(materials=dataclasses.replace(
            s.materials, albedo=p["albedo"], ks=p["ks"]))
        return s.replace(lights=dataclasses.replace(
            s.lights, pos=p["light_pos"]))

    def builder(p):
        return fp.bind(center=p["center"], radius=p["radius"],
                       albedo=p["albedo"], ks=p["ks"],
                       light_pos=p["light_pos"])

    from raytracer.ops.replay import _replay_band_vg

    target = render(scene, cam, opts)[0] * 0.9
    vg0 = None
    for i in range(10):
        p = jax.tree.map(lambda x: x * (1.0 + 0.001 * i), params)
        value_and_grad_replay(apply_m, p, scene, cam, opts, target, builder)
        if i == 0:  # everything is compiled after the first step
            vg0 = _replay_band_vg._cache_size()
            f0 = fp._render._cache_size()
    assert fp._render._cache_size() == f0, (f0, fp._render._cache_size())
    assert _replay_band_vg._cache_size() == vg0, \
        (vg0, _replay_band_vg._cache_size())


def _run_isolated(code: str, timeout=1500):
    """Run a check in a FRESH python process.

    Compiling a glass-plan program (14+ pallas outputs) inside a process
    that has already compiled the full suite's ~150 programs segfaults in
    XLA:CPU backend_compile_and_load (observed 4x, 2026-08-20 — cache on
    or off; the same compile succeeds every time in a fresh process).
    Process-level isolation is the only reliable workaround."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, f"isolated check failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}"


def test_glass_plan_node_count():
    _run_isolated("""
import jax, dataclasses
jax.config.update('jax_platforms', 'cpu')
from raytracer.models import presets
from raytracer.ops.fused import FusedWhitted
scene, cam, opts = presets.PRESETS['config3']()
opts = dataclasses.replace(opts, width=32, height=32, max_depth=2)
_, wins, occs = FusedWhitted(scene, cam, opts, interpret=True).render_plan()
assert len(wins) == len(occs) == 2 ** 3 - 1, (len(wins), len(occs))
""")


@pytest.mark.slow
def test_glass_replay_image_and_grads():
    """Glass plans: the 2^(D+1)-1 node tree replays through the uncompacted
    wavefront. Image matches to the knife-edge subtree class (an id flip at
    depth b re-roots a whole subtree); center grads essentially exact,
    albedo grads within the flipped-pixel bound. Subprocess-isolated (see
    _run_isolated)."""
    _run_isolated("""
import jax, dataclasses
import numpy as np
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
from raytracer.models import presets
from raytracer.renderer import render, value_and_grad_banded
from raytracer.ops.fused import FusedWhitted
from raytracer.ops.replay import replay_render, value_and_grad_replay

scene, cam, opts = presets.PRESETS['config3']()
opts = dataclasses.replace(opts, width=48, height=48)
fused = FusedWhitted(scene, cam, opts, interpret=True)
_, wins, occs = fused.render_plan()
assert len(wins) == 2 ** (opts.max_depth + 1) - 1
ref = render(scene, cam, dataclasses.replace(opts, compact_cap=None))[0]
img = replay_render(scene, cam, opts, (wins, occs))[0]
d = np.abs(np.asarray(img) - np.asarray(ref)).max(axis=-1)
assert np.isfinite(np.asarray(img)).all()
assert (d > 1.5 / 255).mean() < 0.02
assert np.median(d) == 0.0

params = {'center': jnp.asarray(scene.spheres.center),
          'albedo': jnp.asarray(scene.materials.albedo)}
def _apply(s, p):
    return s.replace(
        spheres=dataclasses.replace(s.spheres, center=p['center']),
        materials=dataclasses.replace(s.materials, albedo=p['albedo']))
target = ref * 0.9
v1, g1 = value_and_grad_banded(_apply, params, scene, cam, opts, target)
fp = FusedWhitted(scene, cam, opts, param_inputs=True, interpret=True)
v2, g2 = value_and_grad_replay(
    _apply, params, scene, cam, opts, target,
    lambda p: fp.bind(center=p['center'], albedo=p['albedo']))
assert abs(float(v1) - float(v2)) < 0.1 * abs(float(v1))
for k, tol in (('center', 1e-4), ('albedo', 0.05)):
    scale = float(jnp.abs(g1[k]).max()) + 1e-9
    assert float(jnp.abs(g1[k] - g2[k]).max()) <= tol * scale

# plan-driven COMPACTED glass replay (opts.compact_cap set): image is
# bitwise the uncompacted replay (dropped == 0 gate), grads match banded
opts_c = dataclasses.replace(opts, compact_cap=1.0)
from raytracer.ops.replay import replay_render
img_c, _t, dropped = replay_render(scene, cam, opts_c, (wins, occs))
assert float(dropped) == 0.0
assert np.array_equal(np.asarray(img_c), np.asarray(img))
fp2 = FusedWhitted(scene, cam, opts_c, param_inputs=True, interpret=True)
v3, g3 = value_and_grad_replay(
    _apply, params, scene, cam, opts_c, target,
    lambda p: fp2.bind(center=p['center'], albedo=p['albedo']))
for k, tol in (('center', 1e-3), ('albedo', 0.05)):
    scale = float(jnp.abs(g1[k]).max()) + 1e-9
    assert float(jnp.abs(g1[k] - g3[k]).max()) <= tol * scale
""", timeout=2400)


def test_waveplan_replay_vg_matches_standard_mesh():
    """Wavefront-planner replay (renderer.render record_plan=True →
    PlanTracer replay vg) == the standard plan-remat vg on a mesh scene:
    both backwards differentiate the same shading recompute from the same
    integer residuals — the walks just run outside the autodiff graph in
    the replay form (the r5 config4 training candidate)."""
    import dataclasses

    import numpy as np

    from raytracer.accel.grid import GridTracer
    from raytracer.core.types import Meshes
    from raytracer.io import meshgen
    from raytracer.ops.replay import _replay_band_vg

    scene, cam, opts = presets.config4_mesh(use_obj=False)
    verts, tris = meshgen.bumpy_sphere(subdiv=3, radius=1.3)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32),
        normals=meshgen.vertex_normals(verts, tris)))
    opts = dataclasses.replace(opts, width=64, height=48, max_depth=2,
                               tile_rays=1024, tile_block=(16, 64))
    tracer = GridTracer.build(scene)
    target = render(scene, cam, opts, tracer=tracer)[0] * 0.9
    p0 = {"center": jnp.asarray(scene.spheres.center),
          "albedo": jnp.asarray(scene.materials.albedo)}

    def with_p(s, p):
        return s.replace(
            spheres=dataclasses.replace(s.spheres, center=p["center"]),
            materials=dataclasses.replace(s.materials, albedo=p["albedo"]))

    n3 = opts.width * opts.height * 3

    def loss_std(p):
        img = render(with_p(scene, p), cam, opts, tracer=tracer)[0]
        return jnp.sum((img - target) ** 2) / n3

    v_std, g_std = jax.value_and_grad(loss_std)(p0)

    _, _, wins, occs = render(scene, cam, opts, tracer=tracer,
                              record_plan=True)
    v_w, g_w = _replay_band_vg(p0, scene, cam, target,
                               (list(wins), list(occs)), 0,
                               apply_params=with_p, opts=opts,
                               rb=opts.height)
    np.testing.assert_allclose(float(v_w), float(v_std), rtol=1e-5)
    for k in p0:
        a, b = np.asarray(g_w[k]), np.asarray(g_std[k])
        scale = np.abs(b).max() + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4,
                                   err_msg=k)
