"""Gradient correctness (BASELINE.json gate: "pixel-grad allclose vs finite-diff").

Central finite differences on every parameter class (SURVEY.md §4.3): sphere
centers/radii, material albedo/ks/kd, light position/intensity, triangle vertices.
Probe points avoid silhouette edges (visibility discontinuities are
zero-gradient by design — documented in docs/SPEC.md and ops/trace.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import presets
from raytracer.renderer import render

RES = 32


def _interior_mask(*imgs, thresh=0.02):
    """Pixels ≥2px away from any image edge in all given images.

    Visibility discontinuities (silhouettes, shadow boundaries) are
    zero-gradient under AD by design (docs/SPEC.md); finite differences flip
    pixels there. Masking a small band around edges makes FD measure the same
    continuous shading gradient AD computes (SURVEY.md §4.3).
    """
    mask = np.ones(np.asarray(imgs[0]).shape[:2], bool)
    for img in imgs:
        a = np.asarray(img).max(axis=-1)
        edge = np.zeros_like(a, bool)
        d = np.abs(np.diff(a, axis=0)) > thresh
        edge[:-1] |= d
        edge[1:] |= d
        d = np.abs(np.diff(a, axis=1)) > thresh
        edge[:, :-1] |= d
        edge[:, 1:] |= d
        for _ in range(2):  # dilate
            e2 = edge.copy()
            e2[:-1] |= edge[1:]
            e2[1:] |= edge[:-1]
            e2[:, :-1] |= edge[:, 1:]
            e2[:, 1:] |= edge[:, :-1]
            edge = e2
        mask &= ~edge
    assert mask.mean() > 0.3, "edge mask ate the whole image"
    return jnp.asarray(mask)


@pytest.fixture(scope="module")
def inverse_setup():
    init, target, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=RES, height=RES)
    timg = render(target, cam, opts)[0]
    mask = _interior_mask(timg, render(init, cam, opts)[0])
    return init, cam, opts, timg, mask


def _loss_fn(scene0, cam, opts, timg, mask, path):
    """Masked pixel loss as a function of one leaf array substituted in."""

    def set_leaf(scene, value):
        obj = getattr(scene, path[0])
        obj = dataclasses.replace(obj, **{path[1]: value})
        return scene.replace(**{path[0]: obj})

    def loss(value):
        img = render(set_leaf(scene0, value), cam, opts)[0]
        return jnp.mean(((img - timg) ** 2) * mask[:, :, None])

    return loss, getattr(getattr(scene0, path[0]), path[1])


PARAMS = [
    ("spheres", "center", 1e-3, 0.05),
    ("spheres", "radius", 1e-3, 0.05),
    ("materials", "albedo", 1e-3, 0.01),
    ("materials", "kd", 1e-3, 0.01),
    ("materials", "ks", 1e-3, 0.01),
    ("lights", "pos", 1e-3, 0.05),
    ("lights", "intensity", 1e-3, 0.01),
]


@pytest.mark.parametrize("group,field,eps,rtol", PARAMS,
                         ids=[f"{g}.{f}" for g, f, _, _ in PARAMS])
def test_grad_matches_finite_diff(inverse_setup, group, field, eps, rtol):
    scene0, cam, opts, timg, mask = inverse_setup
    loss, x0 = _loss_fn(scene0, cam, opts, timg, mask, (group, field))
    g = jax.grad(loss)(x0)
    g = np.asarray(g, np.float64)
    assert not np.isnan(g).any(), "NaN gradient"
    # compare a handful of coordinates by central differences
    flat = np.asarray(x0, np.float64).ravel()
    rng = np.random.default_rng(0)
    picks = rng.choice(flat.size, size=min(4, flat.size), replace=False)
    for k in picks:
        xp = jnp.asarray(flat.copy()).at[k].add(eps).reshape(x0.shape)
        xm = jnp.asarray(flat.copy()).at[k].add(-eps).reshape(x0.shape)
        fd = (float(loss(xp.astype(x0.dtype)))
              - float(loss(xm.astype(x0.dtype)))) / (2 * eps)
        ad = g.ravel()[k]
        # geometry params cross visibility edges under FD; allow loose rtol+atol
        assert ad == pytest.approx(fd, rel=rtol, abs=5e-5), (group, field, k)


def test_grad_triangle_vertices():
    """Pixel loss → mesh vertex positions (config-4 param class), tiny mesh."""
    from raytracer.core.types import (
        Lights, Materials, Meshes, RenderOptions, make_scene)
    from raytracer.core.types import Camera

    verts = np.array([[-1.5, -1.0, -4.0], [1.5, -1.0, -4.0], [0.0, 1.4, -4.2]],
                     np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    scene = make_scene(
        meshes=Meshes.build(verts, tris, [0]),
        materials=Materials.build([0], [(0.6, 0.3, 0.2)], [0.8], [0.1], [25.0],
                                  [1.3]),
        lights=Lights.build([(0.0, 4.0, 0.0)], [(1.0, 1.0, 1.0)]),
    )
    cam = Camera.build(fov_deg=60.0)
    opts = RenderOptions(width=RES, height=RES, max_depth=0)
    timg = render(scene, cam, opts)[0] * 0.0 + 0.3

    def loss(v):
        sc = scene.replace(meshes=dataclasses.replace(scene.meshes, verts=v))
        return jnp.mean((render(sc, cam, opts)[0] - timg) ** 2)

    v0 = jnp.asarray(scene.meshes.verts)
    g = np.asarray(jax.grad(loss)(v0), np.float64)
    assert not np.isnan(g).any()
    eps = 1e-3
    # probe the z coordinate of vertex 2 (moves shading, not the silhouette much)
    fd = (float(loss(v0.at[2, 2].add(eps))) - float(loss(v0.at[2, 2].add(-eps)))) \
        / (2 * eps)
    assert g[2, 2] == pytest.approx(fd, rel=0.08, abs=5e-5)


def test_inverse_rendering_converges():
    """End-to-end config 5: Adam on (centers, albedos) recovers the target."""
    import optax

    init, target, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=48, height=48)
    timg = render(target, cam, opts)[0]

    params = {"center": init.spheres.center, "albedo": init.materials.albedo}

    def loss(p):
        sc = init.replace(
            spheres=dataclasses.replace(init.spheres, center=p["center"]),
            materials=dataclasses.replace(
                init.materials, albedo=jnp.clip(p["albedo"], 0.0, 1.0)))
        return jnp.mean((render(sc, cam, opts)[0] - timg) ** 2)

    opt = optax.adam(1e-2)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        val, g = jax.value_and_grad(loss)(p)
        upd, s = opt.update(g, s)
        return optax.apply_updates(p, upd), s, val

    l0 = float(loss(params))
    for _ in range(80):
        params, state, _ = step(params, state)
    l1 = float(loss(params))
    assert l1 < 0.1 * l0, (l0, l1)
    alb = np.clip(np.asarray(params["albedo"])[:2], 0, 1)
    want = np.asarray(target.materials.albedo)[:2]
    assert np.abs(alb - want).max() < 0.06, alb
    cerr = np.abs(np.asarray(params["center"])
                  - np.asarray(target.spheres.center)).max()
    assert cerr < 0.12, cerr


def test_grad_camera_params():
    """Pixel loss → camera pos/fov (bonus differentiable params)."""
    init, target, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=RES, height=RES)
    timg = render(target, cam, opts)[0]

    def loss(pos, fov):
        c = dataclasses.replace(cam, pos=pos, fov_deg=fov)
        return jnp.mean((render(init, c, opts)[0] - timg) ** 2)

    pos0 = jnp.asarray(cam.pos)
    fov0 = jnp.asarray(cam.fov_deg)
    gp, gf = jax.grad(loss, argnums=(0, 1))(pos0, fov0)
    assert not np.isnan(np.asarray(gp)).any() and not np.isnan(float(gf))
    eps = 1e-3
    fd = (float(loss(pos0, fov0 + eps)) - float(loss(pos0, fov0 - eps))) / (2 * eps)
    assert float(gf) == pytest.approx(fd, rel=0.05, abs=5e-5)


@pytest.mark.slow
def test_inverse_mesh_preset_recovers_geometry(tmp_path, capsys):
    """config6 end-to-end (cli optimize --preset mesh, short run): pixel loss
    falls and camera-visible vertex error improves — gradients flow to
    Meshes.verts through BOTH the hit recompute and the differentiable
    smooth normals (io/meshgen.vertex_normals_jnp)."""
    import json
    import re

    from raytracer import cli

    cli.main(["optimize", "--preset", "mesh", "--steps", "30",
              "--log-every", "1", "--out", str(tmp_path / "m.png")])
    out = capsys.readouterr().out
    losses = [json.loads(l)["loss"] for l in out.splitlines()
              if l.startswith('{"step"')]
    assert losses[-1] < 0.8 * losses[0]
    vis = [float(m) for m in re.findall(r"visible (\d+\.\d+)", out)]
    assert len(vis) == 2 and vis[1] < 0.85 * vis[0]  # init -> recovered


def test_grad_uv_checker_albedo2():
    """Pixel loss → mesh st-checker colors (SPEC "Mesh UV"): gradients flow
    through the barycentric st interpolation to `Meshes.albedo2`, and FD
    agrees away from checker-cell boundaries."""
    from raytracer.models.presets import config7_uv_quad

    scene, cam, opts = config7_uv_quad()
    opts = dataclasses.replace(opts, width=RES, height=RES, max_depth=0)
    timg = render(scene, cam, opts)[0] * 0.0 + 0.25

    def loss(a2):
        sc = scene.replace(
            meshes=dataclasses.replace(scene.meshes, albedo2=a2))
        return jnp.mean((render(sc, cam, opts)[0] - timg) ** 2)

    a0 = jnp.asarray(scene.meshes.albedo2)
    g = np.asarray(jax.grad(loss)(a0), np.float64)
    assert not np.isnan(g).any()
    assert np.abs(g).max() > 0, "no gradient reached albedo2"
    eps = 1e-3
    for k in (0, 4):  # one coord per triangle row
        xp = a0.ravel().at[k].add(eps).reshape(a0.shape)
        xm = a0.ravel().at[k].add(-eps).reshape(a0.shape)
        fd = (float(loss(xp)) - float(loss(xm))) / (2 * eps)
        assert g.ravel()[k] == pytest.approx(fd, rel=0.02, abs=5e-6)
