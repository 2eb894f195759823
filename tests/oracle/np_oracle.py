"""Recursive NumPy oracle — the ground-truth twin of native/oracle.cpp.

Implements docs/SPEC.md *literally* (scalar recursion per pixel, float64), in the
exact shape of the reference's `castRay` call stack (SURVEY.md §3.1) — deliberately
NOT sharing code or structure with the wavefront JAX renderer so the two validate
each other. `/root/reference` was an empty mount (SURVEY §0), so this pair defines
bit-level ground truth for the project.

Slow by design: use ≤128² in tests. The C++ oracle renders the big goldens.
"""

import numpy as np

from raytracer.core.types import Scene

T_MIN = 1e-4
DET_EPS = 1e-8


def _normalize(v):
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


def _sphere_t(orig, d, c, r):
    L = orig - c
    a = float(np.dot(d, d))
    b = 2.0 * float(np.dot(d, L))
    c0 = float(np.dot(L, L)) - r * r
    disc = b * b - 4 * a * c0
    if disc < 0:
        return np.inf
    sq = np.sqrt(disc)
    q = -0.5 * (b + sq) if b >= 0 else -0.5 * (b - sq)
    t0 = q / a
    t1 = c0 / q if abs(q) > 1e-300 else -np.inf
    tlo, thi = min(t0, t1), max(t0, t1)
    if tlo > T_MIN:
        return tlo
    if thi > T_MIN:
        return thi
    return np.inf


def _plane_t(orig, d, p0, n):
    denom = float(np.dot(n, d))
    if abs(denom) < DET_EPS:
        return np.inf
    t = float(np.dot(p0 - orig, n)) / denom
    return t if t > T_MIN else np.inf


def _tri_tuv(orig, d, v0, e1, e2):
    pvec = np.cross(d, e2)
    det = float(np.dot(e1, pvec))
    if abs(det) < DET_EPS:
        return np.inf, 0.0, 0.0
    inv = 1.0 / det
    tvec = orig - v0
    u = float(np.dot(tvec, pvec)) * inv
    if u < 0 or u > 1:
        return np.inf, 0.0, 0.0
    qvec = np.cross(tvec, e1)
    v = float(np.dot(d, qvec)) * inv
    if v < 0 or u + v > 1:
        return np.inf, 0.0, 0.0
    t = float(np.dot(e2, qvec)) * inv
    if t <= T_MIN:
        return np.inf, 0.0, 0.0
    return t, u, v


def _reflect(i, n):
    return i - 2.0 * np.dot(i, n) * n


def _refract(i, n, ior):
    cosi = np.clip(np.dot(i, n), -1.0, 1.0)
    etai, etat = 1.0, ior
    nn = n
    if cosi < 0:
        cosi = -cosi
    else:
        etai, etat = etat, etai
        nn = -n
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    if k < 0:
        return None  # TIR
    return eta * i + (eta * cosi - np.sqrt(k)) * nn


def _fresnel(i, n, ior):
    cosi = np.clip(np.dot(i, n), -1.0, 1.0)
    etai, etat = 1.0, ior
    if cosi > 0:
        etai, etat = etat, etai
    sint = etai / etat * np.sqrt(max(0.0, 1.0 - cosi * cosi))
    if sint >= 1.0:
        return 1.0
    cost = np.sqrt(max(0.0, 1.0 - sint * sint))
    cosi = abs(cosi)
    rs = (etat * cosi - etai * cost) / (etat * cosi + etai * cost)
    rp = (etai * cosi - etat * cost) / (etai * cosi + etat * cost)
    return 0.5 * (rs * rs + rp * rp)


class Oracle:
    """Scene unpacked to float64 numpy; renders per-pixel recursively."""

    def __init__(self, scene: Scene, opts):
        f = lambda a: np.asarray(a, np.float64)
        i = lambda a: np.asarray(a, np.int64)
        self.sc = f(scene.spheres.center)
        self.sr = f(scene.spheres.radius)
        self.sm = i(scene.spheres.mat_id)
        self.pp = f(scene.planes.point)
        self.pn = f(scene.planes.normal)
        self.pt = f(scene.planes.tangent)
        self.pb = f(scene.planes.bitangent)
        self.pm = i(scene.planes.mat_id)
        self.pc = i(scene.planes.checker)
        self.ps = f(scene.planes.checker_scale)
        self.pa2 = f(scene.planes.albedo2)
        self.verts = f(scene.meshes.verts)
        self.tris = i(scene.meshes.tris)
        self.vnorm = f(scene.meshes.normals)
        self.tm = i(scene.meshes.mat_id)
        self.tuv = f(scene.meshes.uvs)
        self.tchk = i(scene.meshes.checker)
        self.tcs = f(scene.meshes.checker_scale)
        self.ta2 = f(scene.meshes.albedo2)
        self.has_uv = scene.meshes.has_uv
        if len(self.tris):
            v0 = self.verts[self.tris[:, 0]]
            self.tv0 = v0
            self.te1 = self.verts[self.tris[:, 1]] - v0
            self.te2 = self.verts[self.tris[:, 2]] - v0
        self.mt = i(scene.materials.mtype)
        self.ma = f(scene.materials.albedo)
        self.mkd = f(scene.materials.kd)
        self.mks = f(scene.materials.ks)
        self.msn = f(scene.materials.spec_n)
        self.mior = f(scene.materials.ior)
        self.lp = f(scene.lights.pos)
        self.li = f(scene.lights.intensity)
        self.opts = opts
        self.bg = np.asarray(opts.background, np.float64)
        self.bias = opts.bias
        self.smooth = scene.meshes.smooth

    # -- trace: nearest hit over all groups (sphere < plane < tri tie order) --
    def trace(self, orig, d):
        best_t, kind, idx, uv = np.inf, 0, 0, (0.0, 0.0)
        if len(self.sc):
            L = orig[None, :] - self.sc
            a = np.dot(d, d)
            b = 2.0 * (L @ d)
            c0 = np.einsum("ij,ij->i", L, L) - self.sr * self.sr
            disc = b * b - 4 * a * c0
            with np.errstate(invalid="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
            q = np.where(b >= 0, -0.5 * (b + sq), -0.5 * (b - sq))
            t0 = q / a
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = np.where(np.abs(q) > 0, c0 / q, -np.inf)
            tlo, thi = np.minimum(t0, t1), np.maximum(t0, t1)
            ts = np.where(tlo > T_MIN, tlo, np.where(thi > T_MIN, thi, np.inf))
            ts = np.where(disc >= 0, ts, np.inf)
            k = int(np.argmin(ts))
            if ts[k] < best_t:
                best_t, kind, idx = float(ts[k]), 1, k
        if len(self.pp):
            for k in range(len(self.pp)):
                t = _plane_t(orig, d, self.pp[k], self.pn[k])
                if t < best_t:
                    best_t, kind, idx = t, 2, k
        if len(self.tris):
            pvec = np.cross(d[None, :], self.te2)
            det = np.einsum("ij,ij->i", self.te1, pvec)
            ok = np.abs(det) > DET_EPS
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
            tvec = orig[None, :] - self.tv0
            u = np.einsum("ij,ij->i", tvec, pvec) * inv
            qvec = np.cross(tvec, self.te1)
            v = (qvec @ d) * inv
            t = np.einsum("ij,ij->i", self.te2, qvec) * inv
            ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
            ts = np.where(ok, t, np.inf)
            k = int(np.argmin(ts))
            if ts[k] < best_t:
                best_t, kind, idx = float(ts[k]), 3, k
                uv = (float(u[k]), float(v[k]))
        return best_t, kind, idx, uv

    def occluded(self, orig, d, max_t):
        t, kind, _, _ = self.trace(orig, d)
        return kind != 0 and t < max_t

    def surface(self, orig, d, t, kind, idx, uv):
        p = orig + t * d
        if kind == 1:
            n = (p - self.sc[idx]) / self.sr[idx]
            mat = self.sm[idx]
            albedo = self.ma[mat]
        elif kind == 2:
            n = self.pn[idx]
            mat = self.pm[idx]
            albedo = self.ma[mat]
            if self.pc[idx]:
                u = np.dot(p - self.pp[idx], self.pt[idx])
                v = np.dot(p - self.pp[idx], self.pb[idx])
                s = self.ps[idx]
                fu = u * s - np.floor(u * s)
                fv = v * s - np.floor(v * s)
                if (fu > 0.5) != (fv > 0.5):
                    albedo = self.pa2[idx]
        else:
            u, v = uv
            if self.smooth:
                tri = self.tris[idx]
                n = _normalize((1 - u - v) * self.vnorm[tri[0]]
                               + u * self.vnorm[tri[1]] + v * self.vnorm[tri[2]])
            else:
                n = _normalize(np.cross(self.te1[idx], self.te2[idx]))
            mat = self.tm[idx]
            albedo = self.ma[mat]
            if self.has_uv and self.tchk[idx]:
                tri = self.tris[idx]
                st = ((1 - u - v) * self.tuv[tri[0]] + u * self.tuv[tri[1]]
                      + v * self.tuv[tri[2]])
                sc = self.tcs[idx]
                fu = st[0] * sc - np.floor(st[0] * sc)
                fv = st[1] * sc - np.floor(st[1] * sc)
                if (fu > 0.5) != (fv > 0.5):
                    albedo = self.ta2[idx]
        return p, n, int(mat), albedo

    def cast_ray(self, orig, d, depth):
        if depth > self.opts.max_depth:
            return self.bg.copy()
        t, kind, idx, uv = self.trace(orig, d)
        if kind == 0:
            return self.bg.copy()
        p, n, mat, albedo = self.surface(orig, d, t, kind, idx, uv)
        mtype = self.mt[mat]
        if mtype == 1:  # REFLECTION
            kr = _fresnel(d, n, self.mior[mat])
            rdir = _normalize(_reflect(d, n))
            rorig = p - n * self.bias if np.dot(rdir, n) < 0 else p + n * self.bias
            return kr * self.cast_ray(rorig, rdir, depth + 1)
        if mtype == 2:  # REFLECTION_AND_REFRACTION
            kr = _fresnel(d, n, self.mior[mat])
            rdir = _normalize(_reflect(d, n))
            rorig = p - n * self.bias if np.dot(rdir, n) < 0 else p + n * self.bias
            refl = self.cast_ray(rorig, rdir, depth + 1)
            refr = np.zeros(3)
            tdir = _refract(d, n, self.mior[mat])
            if tdir is not None:
                tdir = _normalize(tdir)
                torig = (p - n * self.bias if np.dot(tdir, n) < 0
                         else p + n * self.bias)
                refr = self.cast_ray(torig, tdir, depth + 1)
            return kr * refl + (1.0 - kr) * refr
        # DIFFUSE_AND_GLOSSY
        sorig = p + n * self.bias if np.dot(d, n) < 0 else p - n * self.bias
        light_amt = np.zeros(3)
        spec = np.zeros(3)
        for lp, li in zip(self.lp, self.li):
            lvec = lp - p
            dist = np.sqrt(np.dot(lvec, lvec))
            ldir = lvec / dist
            ldn = max(0.0, float(np.dot(ldir, n)))
            vis = 0.0 if self.occluded(sorig, ldir, dist) else 1.0
            light_amt += vis * ldn * li
            r = _reflect(-ldir, n)
            spec += max(0.0, -float(np.dot(r, d))) ** self.msn[mat] * li
        return light_amt * albedo * self.mkd[mat] + spec * self.mks[mat]

    def render(self, camera, width=None, height=None):
        w = width or self.opts.width
        h = height or self.opts.height
        pos = np.asarray(camera.pos, np.float64)
        c2w = np.asarray(camera.c2w, np.float64)
        fov = float(camera.fov_deg)
        scale = np.tan(np.deg2rad(fov) / 2.0)
        aspect = w / h
        img = np.zeros((h, w, 3))
        for j in range(h):
            y = (1.0 - 2.0 * (j + 0.5) / h) * scale
            for i in range(w):
                x = (2.0 * (i + 0.5) / w - 1.0) * aspect * scale
                d = _normalize(c2w @ np.array([x, y, -1.0]))
                img[j, i] = self.cast_ray(pos, d, 0)
        return np.clip(img, 0.0, 1.0)


def render_oracle(scene, camera, opts, width=None, height=None):
    return Oracle(scene, opts).render(camera, width, height)
