"""IO round-trips: PPM writer/reader, OBJ save/load, procedural meshes."""

import numpy as np

from raytracer.io import meshgen
from raytracer.io.image import load_ppm, save_ppm, to_u8
from raytracer.io.obj import load_obj, save_obj


def test_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((12, 17, 3)).astype(np.float32)
    p = tmp_path / "x.ppm"
    save_ppm(str(p), img)
    back = load_ppm(str(p))
    assert back.shape == img.shape
    assert np.abs(back - img).max() <= 0.5 / 255 + 1e-6


def test_obj_roundtrip(tmp_path):
    verts, tris = meshgen.icosphere(subdiv=1)
    normals = meshgen.vertex_normals(verts, tris)
    p = tmp_path / "m.obj"
    save_obj(str(p), verts, tris, normals)
    v2, t2, n2, uv2 = load_obj(str(p))
    np.testing.assert_allclose(v2, verts, atol=1e-5)
    np.testing.assert_array_equal(t2, tris)
    assert n2 is not None and uv2 is None
    np.testing.assert_allclose(n2, normals, atol=1e-5)


def test_obj_fan_and_negative_indices(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\nf -4 -3 -2\n")
    v, t, n, uv = load_obj(str(p))
    assert v.shape == (4, 3)
    # quad fan → 2 tris, plus the negative-index tri
    assert t.shape == (3, 3)
    np.testing.assert_array_equal(t[0], [0, 1, 2])
    np.testing.assert_array_equal(t[1], [0, 2, 3])
    np.testing.assert_array_equal(t[2], [0, 1, 2])


def test_obj_uv_roundtrip(tmp_path):
    """Vertex-aligned uv export → reload keeps uvs aligned and order intact."""
    verts, tris = meshgen.icosphere(subdiv=1)
    uvs = np.stack([np.linspace(0, 1, len(verts)),
                    np.linspace(1, 0, len(verts))], axis=1).astype(np.float32)
    p = tmp_path / "uv.obj"
    save_obj(str(p), verts, tris, uvs=uvs)
    v2, t2, n2, uv2 = load_obj(str(p))
    assert uv2 is not None and n2 is None
    np.testing.assert_allclose(v2, verts, atol=1e-5)
    np.testing.assert_array_equal(t2, tris)
    np.testing.assert_allclose(uv2, uvs, atol=1e-5)


def test_obj_uv_corner_split(tmp_path):
    """Per-corner vt indices that disagree on a shared vertex split it."""
    p = tmp_path / "split.obj"
    # two triangles sharing the edge 1-3 with DIFFERENT vt on vertex 1
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                 "f 1/1 2/2 3/3\nf 1/2 3/3 4/4\n")
    v, t, n, uv = load_obj(str(p))
    assert uv is not None
    assert v.shape[0] == 5          # vertex 1 split into (v1,vt1) and (v1,vt2)
    assert t.shape == (2, 3)
    # corners carry their own uv
    np.testing.assert_allclose(uv[t[0, 0]], [0, 0], atol=1e-6)
    np.testing.assert_allclose(uv[t[1, 0]], [1, 0], atol=1e-6)
    np.testing.assert_allclose(v[t[0, 0]], v[t[1, 0]], atol=1e-6)


def test_icosphere_counts():
    v, t = meshgen.icosphere(subdiv=3)
    assert t.shape[0] == 20 * 4**3
    # closed manifold: V - E + F = 2 with E = 3F/2
    assert v.shape[0] - 3 * t.shape[0] // 2 + t.shape[0] == 2
    assert np.allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-6)


def test_vertex_normals_sphere():
    v, t = meshgen.icosphere(subdiv=3)
    n = meshgen.vertex_normals(v, t)
    # icosphere normals ≈ positions
    assert np.abs(np.einsum("ij,ij->i", n, v) - 1.0).max() < 5e-3


def test_to_u8_clamps():
    img = np.array([[[-0.5, 0.5, 1.5]]])
    assert to_u8(img).tolist() == [[[0, 128, 255]]]
