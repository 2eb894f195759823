"""Scene text format: save + load (the framework's scene-description file).

Reference analog: the reference hard-codes its scenes inside `main()`
(SURVEY.md §1 L5); a framework needs scenes as data. This is the same
whitespace format `native/oracle.cpp` reads, so a file authored here renders
identically through the C++ oracle, the NumPy oracle, and this framework.

Format (whitespace-separated; `#` starts a comment; sections in any order):
  opts W H max_depth bias bg_r bg_g bg_b
  camera px py pz fov c2w[9 row-major]
  materials M   then per-row: mtype albedo(3) kd ks spec_n ior
  spheres N     then per-row: cx cy cz r mat
  planes N      then per-row: p(3) n(3) tg(3) bt(3) mat checker scale albedo2(3)
  mesh V T smooth  then V vert rows, [V normal rows], T rows: i j k mat
  mesh_uv NU checker scale a2(3)   then NU rows: u v
                (vertex-aligned uv block + st-checker spec for the PRECEDING
                 mesh section; NU must equal its V)
  mesh_obj path mat smooth [scale tx ty tz]
                (loader extension: mesh from an OBJ file, path relative to the
                 scene file; smooth=1 builds area-weighted vertex normals if
                 the OBJ has none; optional uniform scale>0 + translation
                 applied to the vertices — normals are unaffected)
  lights L      then per-row: pos(3) intensity(3)
"""

from __future__ import annotations

import os

import numpy as np

from raytracer.core.types import (Camera, Lights, Materials, Meshes,
                                      Planes, RenderOptions, Scene, Spheres,
                                      make_scene)


def _row(f, *vals):
    f.write(" ".join(f"{v:.9g}" if isinstance(v, float) else str(v)
                     for v in vals) + "\n")


def save_scene(path: str, scene: Scene, camera: Camera,
               opts: RenderOptions) -> None:
    """Write the scene text format (consumed by load_scene + native/oracle)."""
    g = lambda a: np.asarray(a, np.float64)
    with open(path, "w") as f:
        _row(f, "opts", opts.width, opts.height, opts.max_depth,
             float(opts.bias), *map(float, opts.background))
        _row(f, "camera", *map(float, g(camera.pos)),
             float(camera.fov_deg), *map(float, g(camera.c2w).reshape(-1)))

        m = scene.materials
        nm = len(np.asarray(m.mtype))
        f.write(f"materials {nm}\n")
        for i in range(nm):
            _row(f, int(np.asarray(m.mtype)[i]), *map(float, g(m.albedo)[i]),
                 float(g(m.kd)[i]), float(g(m.ks)[i]), float(g(m.spec_n)[i]),
                 float(g(m.ior)[i]))

        s = scene.spheres
        f.write(f"spheres {s.count}\n")
        for i in range(s.count):
            _row(f, *map(float, g(s.center)[i]), float(g(s.radius)[i]),
                 int(np.asarray(s.mat_id)[i]))

        p = scene.planes
        f.write(f"planes {p.count}\n")
        for i in range(p.count):
            _row(f, *map(float, g(p.point)[i]), *map(float, g(p.normal)[i]),
                 *map(float, g(p.tangent)[i]), *map(float, g(p.bitangent)[i]),
                 int(np.asarray(p.mat_id)[i]), int(np.asarray(p.checker)[i]),
                 float(g(p.checker_scale)[i]), *map(float, g(p.albedo2)[i]))

        mesh = scene.meshes
        smooth = 1 if mesh.smooth else 0
        nv, nt = g(mesh.verts).shape[0], mesh.count
        f.write(f"mesh {nv} {nt} {smooth}\n")
        for v in g(mesh.verts):
            _row(f, *map(float, v))
        if smooth:
            for n in g(mesh.normals):
                _row(f, *map(float, n))
        tris, tmat = np.asarray(mesh.tris), np.asarray(mesh.mat_id)
        for i in range(nt):
            _row(f, int(tris[i, 0]), int(tris[i, 1]), int(tris[i, 2]),
                 int(tmat[i]))
        if mesh.has_uv and nt:
            # per-mesh uv block (vertex-aligned); checker params written from
            # triangle 0 (build broadcasts one spec over the soup)
            chk = np.asarray(mesh.checker)
            _row(f, "mesh_uv", nv, int(chk[0]),
                 float(g(mesh.checker_scale)[0]),
                 *map(float, g(mesh.albedo2)[0]))
            for u in g(mesh.uvs):
                _row(f, *map(float, u))

        li = scene.lights
        f.write(f"lights {li.count}\n")
        for i in range(li.count):
            _row(f, *map(float, g(li.pos)[i]), *map(float, g(li.intensity)[i]))


class _Tokens:
    """Token stream over the file with `#`-comment stripping."""

    def __init__(self, path: str):
        toks = []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0]
                toks.extend(line.split())
        self._toks = toks
        self._i = 0
        self.path = path

    def peek(self):
        return self._toks[self._i] if self._i < len(self._toks) else None

    def word(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError(f"{self.path}: unexpected end of file")
        self._i += 1
        return t

    def f(self) -> float:
        return float(self.word())

    def i(self) -> int:
        return int(self.word())

    def floats(self, n: int):
        return [self.f() for _ in range(n)]


def load_scene(path: str):
    """Parse a scene text file → (Scene, Camera, RenderOptions).

    Host-side cold path (numpy pytrees), like every scene constructor.
    """
    tk = _Tokens(path)
    opts = RenderOptions()
    camera = Camera.build()
    materials = spheres = planes = meshes = lights = None

    while tk.peek() is not None:
        section = tk.word()
        if section == "opts":
            w, h, d = tk.i(), tk.i(), tk.i()
            bias = tk.f()
            bg = tuple(tk.floats(3))
            opts = RenderOptions(width=w, height=h, max_depth=d, bias=bias,
                                 background=bg)
        elif section == "camera":
            pos = tk.floats(3)
            fov = tk.f()
            c2w = np.array(tk.floats(9), np.float64).reshape(3, 3)
            camera = Camera.build(pos, c2w, fov)
        elif section == "materials":
            n = tk.i()
            rows = [(tk.i(), tk.floats(3), tk.f(), tk.f(), tk.f(), tk.f())
                    for _ in range(n)]
            materials = Materials.build(
                [r[0] for r in rows], [r[1] for r in rows],
                [r[2] for r in rows], [r[3] for r in rows],
                [r[4] for r in rows], [r[5] for r in rows])
        elif section == "spheres":
            n = tk.i()
            rows = [(tk.floats(3), tk.f(), tk.i()) for _ in range(n)]
            spheres = (Spheres.build([r[0] for r in rows],
                                     [r[1] for r in rows],
                                     [r[2] for r in rows])
                       if n else Spheres.empty())
        elif section == "planes":
            n = tk.i()
            rows = [(tk.floats(3), tk.floats(3), tk.floats(3), tk.floats(3),
                     tk.i(), tk.i(), tk.f(), tk.floats(3))
                    for _ in range(n)]
            planes = (Planes.build(
                [r[0] for r in rows], [r[1] for r in rows],
                [r[2] for r in rows], [r[3] for r in rows],
                [r[4] for r in rows], checker=[r[5] for r in rows],
                checker_scale=[r[6] for r in rows],
                albedo2=[r[7] for r in rows]) if n else Planes.empty())
        elif section == "mesh":
            nv, nt, smooth = tk.i(), tk.i(), tk.i()
            verts = np.array([tk.floats(3) for _ in range(nv)],
                             np.float32).reshape(-1, 3)
            normals = (np.array([tk.floats(3) for _ in range(nv)],
                                np.float32).reshape(-1, 3) if smooth else None)
            rows = [(tk.i(), tk.i(), tk.i(), tk.i()) for _ in range(nt)]
            tris = np.array([r[:3] for r in rows], np.int32).reshape(-1, 3)
            mat = np.array([r[3] for r in rows], np.int32)
            meshes = (Meshes.build(verts, tris, mat, normals=normals)
                      if nt else Meshes.empty())
        elif section == "mesh_uv":
            # applies to the preceding mesh: NU (== its V) vertex-aligned uv
            # rows + one checker spec broadcast over its triangles
            if meshes is None or not meshes.count:
                raise ValueError(f"{path}: mesh_uv before any mesh section")
            nu, chk = tk.i(), tk.i()
            scale = tk.f()
            a2 = tk.floats(3)
            if nu != meshes.verts.shape[0]:
                raise ValueError(f"{path}: mesh_uv count {nu} != mesh verts "
                                 f"{meshes.verts.shape[0]}")
            uvr = np.array([tk.floats(2) for _ in range(nu)],
                           np.float32).reshape(-1, 2)
            t = meshes.count
            meshes = Meshes.build(
                meshes.verts, meshes.tris, meshes.mat_id,
                normals=meshes.normals if meshes.smooth else None, uvs=uvr,
                checker=np.full((t,), chk, np.int32),
                checker_scale=np.full((t,), scale, np.float32),
                albedo2=np.tile(np.asarray(a2, np.float32), (t, 1)))
        elif section == "mesh_obj":
            obj_path, mat_id, smooth = tk.word(), tk.i(), tk.i()
            xform = None
            nxt = tk.peek()
            if nxt is not None:
                try:
                    float(nxt)
                except ValueError:
                    pass
                else:
                    xform = tk.floats(4)
                    if xform[0] <= 0:
                        raise ValueError(f"{path}: mesh_obj scale must be > 0 "
                                         f"(got {xform[0]})")
            if not os.path.isabs(obj_path):
                obj_path = os.path.join(os.path.dirname(os.path.abspath(path)),
                                        obj_path)
            from raytracer.io.obj import load_obj

            # smooth=1: keep the OBJ's own normals, else build area-weighted
            verts, tris, normals, uvs = load_obj(
                obj_path, smooth=None if smooth else False)
            if smooth and normals is None:
                from raytracer.io.meshgen import vertex_normals

                normals = vertex_normals(verts, tris)
            if xform is not None:
                s, t = xform[0], np.array(xform[1:], np.float32)
                verts = verts * np.float32(s) + t
            meshes = Meshes.build(
                verts, tris, np.full((tris.shape[0],), mat_id, np.int32),
                normals=normals, uvs=uvs)
        elif section == "lights":
            n = tk.i()
            rows = [(tk.floats(3), tk.floats(3)) for _ in range(n)]
            lights = Lights.build([r[0] for r in rows], [r[1] for r in rows])
        else:
            raise ValueError(f"{path}: unknown section {section!r}")

    if materials is None or lights is None:
        raise ValueError(f"{path}: scene needs 'materials' and 'lights' "
                         "sections")
    scene = make_scene(spheres=spheres, planes=planes, meshes=meshes,
                       materials=materials, lights=lights)
    return scene, camera, opts
