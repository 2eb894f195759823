"""ctypes bindings to the optional C++ fast path (native/librt_native.so).

The reference is a single C++ binary; our framework keeps C++ for the host-side
runtime components where the reference's are native (SURVEY §2.2): OBJ parsing
and uniform-grid building. The Python implementations are the always-available
fallback — the native lib is a pure accelerator, never a semantic fork.

Build: only the sources are committed. The first `native_lib()` call
compiles native/*.cpp for the host it runs on (`build_native`), one process
at a time behind a file lock, into a temporary file that is renamed into
place; `make -C native` does the same by hand.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

_LIB = None
_TRIED = False
NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "librt_native.so")
# the same flags as native/Makefile; gridbuild.cpp without FMA contraction so
# the SAT binner's f64 expression trees match the NumPy twin byte for byte
_CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-Wall"]


class _NativeLib:
    def __init__(self, cdll):
        self._c = cdll
        self._c.rt_load_obj.restype = ctypes.c_int
        self._c.rt_load_obj.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),   # verts
            ctypes.POINTER(ctypes.c_int),                      # n_verts
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),      # tris
            ctypes.POINTER(ctypes.c_int),                      # n_tris
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),    # normals
            ctypes.POINTER(ctypes.c_int),                      # n_normals
        ]
        self._c.rt_free.restype = None
        self._c.rt_free.argtypes = [ctypes.c_void_p]
        self._c.rt_grid_build.restype = ctypes.c_int
        self._c.rt_grid_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,    # verts, nv
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,      # tris, nt
            ctypes.POINTER(ctypes.c_double),                  # bmin[3]
            ctypes.POINTER(ctypes.c_double),                  # cell[3]
            ctypes.c_int, ctypes.c_int, ctypes.c_int,         # nx ny nz
            ctypes.c_int,                                     # capacity
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # cell_tris
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # overflow
            ctypes.POINTER(ctypes.c_int),                     # n_overflow
        ]
        # optional symbols: a librt_native.so built before these existed must
        # keep its other fast paths working
        self.has_grid_sat = hasattr(self._c, "rt_grid_build_sat")
        if self.has_grid_sat:
            self._c.rt_grid_build_sat.restype = ctypes.c_int
            self._c.rt_grid_build_sat.argtypes = self._c.rt_grid_build.argtypes
        self.has_bvh = hasattr(self._c, "rt_bvh_build")
        if not self.has_bvh:
            return
        self._c.rt_bvh_build.restype = ctypes.c_int
        self._c.rt_bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,     # verts, nv
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,       # tris, nt
            ctypes.c_int,                                     # leaf_size
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),   # aabb_min
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),   # aabb_max
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # leaf_tris
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # hit links
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),     # miss links
            ctypes.POINTER(ctypes.c_int),                     # n_nodes
        ]

    def load_obj(self, path: str):
        vp = ctypes.POINTER(ctypes.c_float)()
        np_ = ctypes.POINTER(ctypes.c_float)()
        tp = ctypes.POINTER(ctypes.c_int)()
        nv = ctypes.c_int()
        nt = ctypes.c_int()
        nn = ctypes.c_int()
        rc = self._c.rt_load_obj(path.encode(), ctypes.byref(vp),
                                 ctypes.byref(nv), ctypes.byref(tp),
                                 ctypes.byref(nt), ctypes.byref(np_),
                                 ctypes.byref(nn))
        if rc != 0:
            raise IOError(f"native OBJ load failed ({rc}): {path}")
        verts = np.ctypeslib.as_array(vp, (nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tp, (nt.value, 3)).copy()
        normals = (np.ctypeslib.as_array(np_, (nn.value, 3)).copy()
                   if nn.value else None)
        for p in (vp, tp, np_):
            if p:
                self._c.rt_free(ctypes.cast(p, ctypes.c_void_p))
        return verts.astype(np.float32), tris.astype(np.int32), normals

    def bvh_build(self, verts, tris, leaf_size):
        """→ (aabb_min [n,3] f32, aabb_max [n,3] f32, leaf_tris [n,leaf] i32,
        hit [8n] i32, miss [8n] i32)."""
        verts = np.ascontiguousarray(verts, np.float32)
        tris = np.ascontiguousarray(tris, np.int32)
        amin = ctypes.POINTER(ctypes.c_float)()
        amax = ctypes.POINTER(ctypes.c_float)()
        leaf = ctypes.POINTER(ctypes.c_int)()
        hit = ctypes.POINTER(ctypes.c_int)()
        miss = ctypes.POINTER(ctypes.c_int)()
        n = ctypes.c_int()
        rc = self._c.rt_bvh_build(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            verts.shape[0],
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), tris.shape[0],
            leaf_size, ctypes.byref(amin), ctypes.byref(amax),
            ctypes.byref(leaf), ctypes.byref(hit), ctypes.byref(miss),
            ctypes.byref(n))
        if rc != 0:
            raise MemoryError(f"rt_bvh_build failed ({rc})")
        nn = n.value
        out = (np.ctypeslib.as_array(amin, (nn, 3)).copy(),
               np.ctypeslib.as_array(amax, (nn, 3)).copy(),
               np.ctypeslib.as_array(leaf, (nn, leaf_size)).copy(),
               np.ctypeslib.as_array(hit, (8 * nn,)).copy(),
               np.ctypeslib.as_array(miss, (8 * nn,)).copy())
        for p in (amin, amax, leaf, hit, miss):
            self._c.rt_free(ctypes.cast(p, ctypes.c_void_p))
        return out

    def grid_build(self, verts, tris, bmin, cell, res, capacity,
                   exact: bool = False):
        """→ (cell_tris [ncells, capacity] i32, overflow [O] i32)."""
        verts = np.ascontiguousarray(verts, np.float32)
        tris = np.ascontiguousarray(tris, np.int32)
        bmin = np.ascontiguousarray(bmin, np.float64)
        cell = np.ascontiguousarray(cell, np.float64)
        ct = ctypes.POINTER(ctypes.c_int)()
        ov = ctypes.POINTER(ctypes.c_int)()
        nov = ctypes.c_int()
        fn = self._c.rt_grid_build_sat if exact else self._c.rt_grid_build
        rc = fn(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            verts.shape[0],
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), tris.shape[0],
            bmin.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cell.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            res[0], res[1], res[2], capacity,
            ctypes.byref(ct), ctypes.byref(ov), ctypes.byref(nov))
        if rc != 0:
            raise MemoryError("rt_grid_build failed")
        ncells = res[0] * res[1] * res[2]
        cell_tris = np.ctypeslib.as_array(ct, (ncells, capacity)).copy()
        overflow = (np.ctypeslib.as_array(ov, (nov.value,)).copy()
                    if nov.value else np.zeros((0,), np.int32))
        self._c.rt_free(ctypes.cast(ct, ctypes.c_void_p))
        self._c.rt_free(ctypes.cast(ov, ctypes.c_void_p))
        return cell_tris, overflow


def build_native(so: str = LIB_PATH) -> bool:
    """Compile librt_native.so from native/*.cpp unless it exists → whether
    it exists afterwards. Safe under concurrent callers: one builds while
    the others wait on the lock, and the library appears by atomic rename,
    so nobody loads a half-written file."""
    if os.path.exists(so):
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    import fcntl

    src = lambda name: os.path.join(NATIVE_DIR, name)  # noqa: E731
    with open(so + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):  # another process built it while we waited
            return True
        with tempfile.TemporaryDirectory(dir=os.path.dirname(so)) as tmp:
            obj = os.path.join(tmp, "gridbuild.o")
            out = os.path.join(tmp, "librt_native.so")
            try:
                subprocess.run([cxx, *_CXXFLAGS, "-ffp-contract=off", "-fPIC",
                                "-c", "-o", obj, src("gridbuild.cpp")],
                               check=True, capture_output=True, text=True)
                subprocess.run([cxx, *_CXXFLAGS, "-shared", "-fPIC", "-o",
                                out, src("objloader.cpp"), obj,
                                src("bvhbuild.cpp")],
                               check=True, capture_output=True, text=True)
            except subprocess.CalledProcessError as e:
                sys.stderr.write(f"# native build failed; NumPy fallbacks "
                                 f"engage:\n{e.stderr[-2000:]}\n")
                return False
            os.replace(out, so)
    return True


def native_lib():
    """The loaded native library, or None (Python fallbacks engage).
    Builds it from the committed sources on first use."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("RT_NO_NATIVE"):
            return None
        so = os.environ.get("RT_NATIVE_LIB") or LIB_PATH
        if so == LIB_PATH:
            build_native(so)
        if os.path.exists(so):
            try:
                _LIB = _NativeLib(ctypes.CDLL(so))
            except OSError:
                _LIB = None
    return _LIB
