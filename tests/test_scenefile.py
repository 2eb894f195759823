"""Scene text format: save/load round-trip + render equivalence + mesh_obj.

The scene file is the framework's answer to the reference building scenes in
`main()` (SURVEY.md §1 L5): scenes as data, shared bit-exactly with the C++
oracle (the goldens' scene.txt files are this same format).
"""

import dataclasses

import jax
import numpy as np
import pytest

from raytracer.core import types
from raytracer.io.scenefile import load_scene, save_scene
from raytracer.models import presets
from raytracer.renderer import render


def _assert_tree_equal(a, b, what):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb, f"{what}: pytree structure differs"
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=what)


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config7"])
def test_roundtrip_presets(tmp_path, name):
    scene, cam, opts = presets.PRESETS[name]()
    path = str(tmp_path / "s.txt")
    save_scene(path, scene, cam, opts)
    scene2, cam2, opts2 = load_scene(path)
    # %.9g prints float32 values exactly → the round trip is bitwise.
    _assert_tree_equal(scene, scene2, name)
    _assert_tree_equal(cam, cam2, name)
    assert scene2.has_glass == scene.has_glass
    assert (opts2.width, opts2.height, opts2.max_depth) == (
        opts.width, opts.height, opts.max_depth)
    assert opts2.bias == pytest.approx(opts.bias)
    assert np.allclose(opts2.background, opts.background)


def test_roundtrip_smooth_mesh(tmp_path):
    from raytracer.io.meshgen import icosphere, vertex_normals

    verts, tris = icosphere(subdiv=1)
    normals = vertex_normals(verts, tris)
    scene, cam, opts = presets.PRESETS["config1"]()
    scene = scene.replace(meshes=types.Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32), normals=normals))
    path = str(tmp_path / "m.txt")
    save_scene(path, scene, cam, opts)
    scene2, _, _ = load_scene(path)
    assert scene2.meshes.smooth
    _assert_tree_equal(scene.meshes, scene2.meshes, "smooth mesh")


def test_comments_and_render_equivalence(tmp_path):
    """A commented/reordered file parses; the loaded scene renders pixel-
    identically to the preset it was exported from."""
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=64, height=64, tile_rays=4096)
    path = str(tmp_path / "c.txt")
    save_scene(path, scene, cam, opts)
    text = open(path).read()
    lines = text.splitlines(keepends=True)
    # prepend a comment block and inline-comment the first line
    text = ("# authored by hand\n\n" + lines[0].rstrip("\n")
            + "  # trailing comment\n" + "".join(lines[1:]))
    open(path, "w").write(text)
    scene2, cam2, opts2 = load_scene(path)
    img1 = np.asarray(render(scene, cam, opts)[0])
    img2 = np.asarray(render(scene2, cam2, opts2)[0])
    np.testing.assert_array_equal(img1, img2)


def test_mesh_obj_section(tmp_path):
    from raytracer.io.meshgen import icosphere
    from raytracer.io.obj import save_obj

    verts, tris = icosphere(subdiv=1)
    save_obj(str(tmp_path / "ball.obj"), verts, tris)
    scene, cam, opts = presets.PRESETS["config1"]()
    path = str(tmp_path / "s.txt")
    save_scene(path, scene, cam, opts)
    # swap the inline (empty) mesh for a mesh_obj line, relative path
    out = []
    tok = open(path).read().split("\n")
    for line in tok:
        if line.startswith("mesh "):
            out.append("mesh_obj ball.obj 0 1")
        else:
            out.append(line)
    open(path, "w").write("\n".join(out))
    scene2, _, _ = load_scene(path)
    assert scene2.meshes.count == tris.shape[0]
    assert scene2.meshes.smooth  # smooth=1 built vertex normals
    np.testing.assert_allclose(np.asarray(scene2.meshes.verts), verts,
                               rtol=1e-6)


def test_golden_scene_files_parse():
    """The committed oracle scene.txt files load as valid scenes."""
    import glob
    import os

    root = os.path.join(os.path.dirname(__file__), "golden")
    files = sorted(glob.glob(os.path.join(root, "*.scene.txt")))
    assert files
    for f in files:
        scene, cam, opts = load_scene(f)
        assert scene.lights.count >= 1
        assert opts.width > 0


@pytest.mark.slow
def test_example_scenes(tmp_path):
    """Shipped examples/ scenes parse; the analytic one renders at tiny res
    and matches the NumPy oracle."""
    import glob
    import os

    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    files = sorted(glob.glob(os.path.join(root, "*.txt")))
    assert len(files) >= 2
    for f in files:
        scene, cam, opts = load_scene(f)
        assert scene.lights.count >= 1
        if "blob" in f:
            assert scene.meshes.count > 1000 and scene.meshes.smooth
        else:
            from tests.oracle.np_oracle import render_oracle

            opts = dataclasses.replace(opts, width=48, height=48,
                                       tile_rays=48 * 48)
            img = np.asarray(render(scene, cam, opts)[0])
            ref = render_oracle(scene, cam, opts)
            # atol rides above knife-edge association noise (grazing glass
            # rays at 48² land one ulp either side of a hit in f32 vs f64)
            np.testing.assert_allclose(img, ref, atol=5e-3)


def test_cli_render_scene(tmp_path):
    from raytracer import cli

    scene, cam, opts = presets.PRESETS["config1"]()
    opts = dataclasses.replace(opts, width=32, height=32)
    spath = str(tmp_path / "s.txt")
    save_scene(spath, scene, cam, opts)
    out = str(tmp_path / "o.ppm")
    cli.main(["render", "--scene", spath, "--out", out])
    from raytracer.io.image import load_ppm

    img = load_ppm(out)
    assert img.shape == (32, 32, 3)
