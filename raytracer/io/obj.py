"""Wavefront OBJ load/save. Reference analog: the hand-rolled `loadOBJ` parser
(SURVEY §2.2 "OBJ loader" — host cold path, so Python is the right tool; a C++
fast path lives in native/objloader.cpp and is used automatically when built).

Supports: `v x y z`, `vt u v`, `vn x y z`, `f a b c ...` (fans triangulated),
`f a//n`, `f a/t`, `f a/t/n`, negative indices. Texture coordinates use
per-corner `vt` indices in the file; the loader splits shared vertices on
distinct (v, vt, vn) corner tuples so the returned uvs are vertex-aligned
(the Meshes contract, core/types.py). Files without `vt` keep their vertex
order and may take the native C fast path.
"""

import os

import numpy as np

from raytracer.io.meshgen import vertex_normals
from raytracer.utils.native import native_lib


def save_obj(path: str, verts: np.ndarray, tris: np.ndarray,
             normals: np.ndarray | None = None,
             uvs: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        f.write("# raytracer OBJ export\n")
        for v in np.asarray(verts, np.float64):
            f.write(f"v {v[0]:.8g} {v[1]:.8g} {v[2]:.8g}\n")
        if uvs is not None:
            for u in np.asarray(uvs, np.float64):
                f.write(f"vt {u[0]:.8g} {u[1]:.8g}\n")
        if normals is not None:
            for n in np.asarray(normals, np.float64):
                f.write(f"vn {n[0]:.8g} {n[1]:.8g} {n[2]:.8g}\n")
        for t in np.asarray(tris, np.int64) + 1:
            if uvs is not None and normals is not None:
                f.write(f"f {t[0]}/{t[0]}/{t[0]} {t[1]}/{t[1]}/{t[1]} "
                        f"{t[2]}/{t[2]}/{t[2]}\n")
            elif uvs is not None:
                f.write(f"f {t[0]}/{t[0]} {t[1]}/{t[1]} {t[2]}/{t[2]}\n")
            elif normals is not None:
                f.write(f"f {t[0]}//{t[0]} {t[1]}//{t[1]} {t[2]}//{t[2]}\n")
            else:
                f.write(f"f {t[0]} {t[1]} {t[2]}\n")


def _has_vt(path: str) -> bool:
    with open(path) as f:
        return any(line.startswith("vt ") for line in f)


def load_obj(path: str, smooth: bool | None = None):
    """→ (verts [V,3] f32, tris [T,3] i32, normals [V,3] f32 or None,
          uvs [V,2] f32 or None).

    smooth=True forces recomputed vertex normals; False forces flat (None);
    None keeps file normals when present (vertex-aligned), else flat.
    """
    lib = native_lib()
    if lib is not None and not _has_vt(path):
        verts, tris, vn = lib.load_obj(path)
        uvs = None
    else:
        verts, tris, vn, uvs = _load_obj_py(path)
    normals = None
    if smooth is True:
        normals = vertex_normals(verts, tris)
    elif smooth is None and vn is not None:
        normals = vn
    return verts, tris, normals, uvs


def _load_obj_py(path: str):
    verts, uvs, norms = [], [], []
    corners = []  # per-face list of (vi, ti, ni) fixed indices (-1 = absent)
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                uvs.append((float(p[1]), float(p[2])))
            elif line.startswith("vn "):
                p = line.split()
                norms.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("f "):
                face = []
                for c in line.split()[1:]:
                    parts = c.split("/")
                    vi = int(parts[0])
                    ti = (int(parts[1]) if len(parts) >= 2 and parts[1]
                          else 0)
                    ni = (int(parts[2]) if len(parts) >= 3 and parts[2]
                          else 0)
                    face.append((vi, ti, ni))
                for k in range(1, len(face) - 1):  # fan triangulation
                    corners.append((face[0], face[k], face[k + 1]))
    nv, nt_, nn = len(verts), len(uvs), len(norms)

    def fix(i: int, n: int) -> int:
        return i - 1 if i > 0 else (n + i if i < 0 else -1)

    corners = [tuple((fix(vi, nv), fix(ti, nt_), fix(ni, nn))
                     for vi, ti, ni in tri) for tri in corners]
    v = np.asarray(verts, np.float32).reshape(-1, 3)

    if nt_ == 0:
        # no texture coords: keep file vertex order (and the aligned-normal
        # heuristic for our own exports)
        t = np.asarray([[c[0] for c in tri] for tri in corners],
                       np.int32).reshape(-1, 3)
        vn = None
        if norms and all(c[2] >= 0 for tri in corners for c in tri):
            aligned = (nn == nv and all(c[2] == c[0] for tri in corners
                                        for c in tri))
            if aligned:
                vn = np.asarray(norms, np.float32).reshape(-1, 3)
        return v, t, vn, None

    # vt identity-aligned with vertices (our own exports): keep file order
    uv = np.asarray(uvs, np.float32).reshape(-1, 2)
    if nt_ == nv and all(c[1] == c[0] for tri in corners for c in tri):
        t = np.asarray([[c[0] for c in tri] for tri in corners],
                       np.int32).reshape(-1, 3)
        vn = None
        if norms and nn == nv and all(c[2] == c[0] for tri in corners
                                      for c in tri):
            vn = np.asarray(norms, np.float32).reshape(-1, 3)
        return v, t, vn, uv

    # vt present: split vertices on distinct (v, vt, vn) corner tuples so
    # uvs (and normals) become vertex-aligned
    remap: dict[tuple, int] = {}
    out_v, out_uv, out_n = [], [], []
    tris = []
    all_n = all(c[2] >= 0 for tri in corners for c in tri) and nn > 0
    uv = np.asarray(uvs, np.float32).reshape(-1, 2)
    nrm = np.asarray(norms, np.float32).reshape(-1, 3) if nn else None
    for tri in corners:
        idx = []
        for c in tri:
            j = remap.get(c)
            if j is None:
                j = remap[c] = len(out_v)
                out_v.append(v[c[0]])
                out_uv.append(uv[c[1]] if c[1] >= 0 else (0.0, 0.0))
                if all_n:
                    out_n.append(nrm[c[2]])
            idx.append(j)
        tris.append(idx)
    return (np.asarray(out_v, np.float32).reshape(-1, 3),
            np.asarray(tris, np.int32).reshape(-1, 3),
            np.asarray(out_n, np.float32).reshape(-1, 3) if all_n else None,
            np.asarray(out_uv, np.float32).reshape(-1, 2))
