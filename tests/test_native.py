"""Native C++ runtime components vs their Python fallbacks: byte-identical.

The contract (utils/native.py): librt_native.so is a pure accelerator, never a
semantic fork — every native builder/parser must produce arrays identical to
the Python fallback, so renders can never depend on which one ran.
"""

import contextlib
import os

import numpy as np
import pytest

import raytracer.utils.native as N

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
_OBJ = os.path.join(_ASSETS, "blob.obj")

@pytest.fixture(scope="module", autouse=True)
def lib():
    """Build the library from native/*.cpp if needed (utils/native.py does
    this on first use, behind a lock) — decided here, not at import."""
    lib = N.native_lib()
    if lib is None:
        pytest.skip("no C++ compiler to build librt_native.so")
    return lib


@contextlib.contextmanager
def _no_native():
    old_lib, old_tried = N._LIB, N._TRIED
    N._LIB, N._TRIED = None, True
    try:
        yield
    finally:
        N._LIB, N._TRIED = old_lib, old_tried


@pytest.fixture(scope="module")
def mesh(lib):
    verts, tris, _ = lib.load_obj(_OBJ)
    return verts, tris


def test_obj_loader_identical(mesh):
    from raytracer.io.obj import _load_obj_py

    nv, nt, nn = N.native_lib().load_obj(_OBJ)
    pv, pt, pn, puv = _load_obj_py(_OBJ)
    assert puv is None  # the asset has no vt; native path only covers no-vt
    np.testing.assert_array_equal(nv, pv)
    np.testing.assert_array_equal(nt, pt)
    assert (nn is None) == (pn is None)
    if nn is not None:
        np.testing.assert_array_equal(nn, pn)


def test_grid_build_identical(mesh):
    from raytracer.accel.grid import build_grid

    verts, tris = mesh
    cc = build_grid(verts, tris, capacity=8)
    with _no_native():
        py = build_grid(verts, tris, capacity=8)
    assert cc.res == py.res
    for name in ("cell_tris", "overflow", "bmin", "inv_cell", "cell_size",
                 "ov_v0", "ov_e1", "ov_e2"):
        np.testing.assert_array_equal(np.asarray(getattr(cc, name)),
                                      np.asarray(getattr(py, name)), err_msg=name)


def test_grid_build_sat_identical(mesh):
    """Exact (SAT) binning: native and NumPy twins must agree byte-for-byte
    (same f64 expression trees; gridbuild.o built with -ffp-contract=off)."""
    from raytracer.accel.grid import build_grid

    if not N.native_lib().has_grid_sat:
        pytest.skip("librt_native.so predates rt_grid_build_sat; run make")
    verts, tris = mesh
    cc = build_grid(verts, tris, capacity=8, exact=True)
    with _no_native():
        py = build_grid(verts, tris, capacity=8, exact=True)
    assert cc.res == py.res
    for name in ("cell_tris", "overflow"):
        np.testing.assert_array_equal(np.asarray(getattr(cc, name)),
                                      np.asarray(getattr(py, name)),
                                      err_msg=name)


def test_bvh_build_identical(mesh):
    from raytracer.accel.bvh import build_bvh

    verts, tris = mesh
    assert N.native_lib().has_bvh
    cc = build_bvh(verts, tris, leaf_size=8)
    with _no_native():
        py = build_bvh(verts, tris, leaf_size=8)
    assert (cc.n_nodes, cc.capacity, cc.n_tris) == (py.n_nodes, py.capacity,
                                                    py.n_tris)
    for name in ("aabb_min", "aabb_max", "leaf_tris", "hit_link", "miss_link"):
        np.testing.assert_array_equal(np.asarray(getattr(cc, name)),
                                      np.asarray(getattr(py, name)), err_msg=name)


def test_bvh_build_identical_odd_leaf(mesh):
    """Non-power-of-two leaf size exercises uneven median splits."""
    from raytracer.accel.bvh import build_bvh

    verts, tris = mesh
    cc = build_bvh(verts[:, :], tris[:301], leaf_size=3)
    with _no_native():
        py = build_bvh(verts[:, :], tris[:301], leaf_size=3)
    for name in ("aabb_min", "aabb_max", "leaf_tris", "hit_link", "miss_link"):
        np.testing.assert_array_equal(np.asarray(getattr(cc, name)),
                                      np.asarray(getattr(py, name)), err_msg=name)
