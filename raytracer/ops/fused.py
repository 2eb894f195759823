"""Fused Whitted megakernel: the whole forward render in ONE Pallas kernel.

The wavefront path (renderer.py) round-trips per-bounce ray state through
device memory between XLA-fused stages. This kernel keeps everything —
raygen, the bounce loop, shadow rays, Phong shading — in registers for one
block of pixels per program, writing only the final RGB planes.

It is compiled for the GPU by Pallas on the Triton route
(`backend="triton"`): the work is per-pixel elementwise math with a
statically unrolled recursion and no matrix products, which is what that
route is for. Blocks are (rows, cols) of pixels, both powers of two; every
program is independent (no state carried between grid steps), so the train
kernel writes one partial loss/gradient row per program and XLA sums them.
Off the GPU the kernels run only when the caller asks for Pallas's
interpreter (`interpret=True`, as the tests do).

Scope: spheres + planes + SMALL flat-shaded triangle meshes (≤ MAX_FUSED_TRIS,
baked like every other primitive), all Whitted materials including glass —
configs 1/2/3/5. Big meshes (config4) stay on the grid/BVH tracers: baking
20k triangles would sweep every one per ray. Scene and camera constants are
BAKED into the compiled program (the analog of the reference hard-coding its
scene in `main()` — SURVEY §1 L5); rebuild + recompile on scene change.
`param_inputs=True` turns the trainable tables into kernel inputs instead.
The in-kernel training step (`plan_value_and_grad`) covers scenes without
glass; glass scenes train through XLA's autodiff of the wavefront renderer.

The reference's `castRay(depth+1)` recursion (SURVEY §3.1) is statically
unrolled depth-first inside the kernel: mirror lanes spawn one child, glass
lanes two (reflect + refract), giving ≤ 2^(D+1)−1 inlined trace+shade bodies.
Depth-first keeps only one ancestor chain of ray state live at a time
(O(D) registers, not O(2^D)); the per-node weights (kr, 1−kr) reproduce the
wavefront renderer's throughput products up to fp association.

Math is a line-for-line port of ops/geometry.py + ops/shade.py +
renderer.bounce_step (docs/SPEC.md), so images agree with the default path to
float-association noise (goldens enforce it; knife-edge pixels excepted).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from raytracer.core.types import (
    DIFFUSE_AND_GLOSSY, REFLECTION, REFLECTION_AND_REFRACTION, Camera,
    RenderOptions, Scene)

_DET_EPS = 1e-8

# (pixels per program as (rows, cols), warps per program); Triton blocks are
# powers of two. From a sweep on an H100 (PERF.md "Kernel decisions"); the
# glass forward was not swept — each of its compiles takes minutes.
FWD_TILE, FWD_WARPS = (2, 128), 8
FWD_TILE_GLASS, FWD_WARPS_GLASS = (1, 128), 4
VJP_TILE, VJP_WARPS = (1, 128), 4

# Trainable parameter tables: (name, real columns). Rows and columns are
# padded to powers of two for Triton; gradients are sliced back.
TABLE_COLS = (("sph", 4), ("pln", 9), ("mat", 7), ("lgt", 6))


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _pad_table(a):
    """[n, c] f32 → [pow2(max(n,1)), pow2(c)] zero-padded."""
    a = np.asarray(a, np.float32)
    out = np.zeros((_pow2(max(a.shape[0], 1)), _pow2(a.shape[1])),
                   np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _check_tile(tile) -> tuple:
    tr, tc = (int(x) for x in tile)
    assert tr == _pow2(tr) and tc == _pow2(tc), \
        f"Triton blocks are powers of two, got {tile}"
    return tr, tc


def _train_acc(pt):
    """Accessor dict over the train kernel's param pytree (nested lists of
    0-d traced scalars loaded from the tables) — same interface as the
    baked/table accessors in `_kernel`, so `radiance` differentiates
    unchanged."""
    sph, pln, mat, lgt = pt["sph"], pt["pln"], pt["mat"], pt["lgt"]
    return {
        "sph_c": lambda sp: tuple(sph[sp["si"]][k] for k in range(3)),
        "sph_r": lambda sp: sph[sp["si"]][3],
        "pln_p": lambda pl_: tuple(pln[pl_["pi"]][k] for k in range(3)),
        "pln_n": lambda pl_: tuple(pln[pl_["pi"]][3 + k] for k in range(3)),
        "pln_a2": lambda pl_: tuple(pln[pl_["pi"]][6 + k] for k in range(3)),
        "mat_alb": lambda prm: tuple(mat[prm["mid"]][k] for k in range(3)),
        "mat_kd": lambda prm: mat[prm["mid"]][3],
        "mat_ks": lambda prm: mat[prm["mid"]][4],
        "mat_specn": lambda prm: mat[prm["mid"]][5],
        "mat_ior": lambda prm: mat[prm["mid"]][6],
        "lgt_pos": lambda li: tuple(lgt[li][k] for k in range(3)),
        "lgt_int": lambda li: tuple(lgt[li][3 + k] for k in range(3)),
    }

# Baked triangles are swept per ray like spheres/planes — fine for scene
# geometry (Cornell walls), ruinous for real meshes (use GridTracer/BVH).
MAX_FUSED_TRIS = 64
# Glass doubles the unrolled recursion per bounce: 2^(D+1)-1 bodies. Past
# D=5 (63 bodies) compile time and program size stop paying for themselves.
MAX_GLASS_DEPTH = 5


def supported(scene: Scene) -> bool:
    """Fused path: all materials; meshes only if tiny + flat-shaded + no UV
    (the baked-triangle kernel has no st-checker stage)."""
    mesh_ok = scene.meshes.count == 0 or (
        scene.meshes.count <= MAX_FUSED_TRIS and not scene.meshes.smooth
        and not scene.meshes.has_uv)
    return bool(mesh_ok)


class FusedWhitted:
    """Build once per (scene, camera, opts); call .render(row0, rows)."""

    def __init__(self, scene: Scene, camera: Camera, opts: RenderOptions,
                 interpret: bool = False, tile: tuple | None = None,
                 param_inputs: bool = False, vjp_tile: tuple | None = None,
                 num_warps: int | None = None):
        """`tile`/`vjp_tile`: pixel blocks of the forward/train kernel;
        `num_warps` overrides both kernels' warp counts (sweeps)."""
        assert supported(scene), \
            "fused path: meshes must be tiny (≤MAX_FUSED_TRIS) + flat-shaded"
        s = jax.tree.map(np.asarray, scene)
        self._has_glass = bool(scene.has_glass)
        assert not (self._has_glass and opts.max_depth > MAX_GLASS_DEPTH), \
            f"fused glass recursion capped at depth {MAX_GLASS_DEPTH}"
        self._opts = opts
        self._interpret = bool(interpret)
        # tile = pixels per kernel program (rows, cols), powers of two. The
        # glass tree keeps a whole ancestor chain of ray state live (module
        # docstring), so glass gets its own block.
        if tile is None:
            tile = FWD_TILE_GLASS if self._has_glass else FWD_TILE
        self._tile = _check_tile(tile)
        self._vjp_tile = _check_tile(vjp_tile or VJP_TILE)
        self._warps = num_warps or (
            FWD_WARPS_GLASS if self._has_glass else FWD_WARPS)
        self._vjp_warps = num_warps or VJP_WARPS

        # param_inputs: the trainable tables become KERNEL INPUTS instead of
        # baked constants, so the inverse-rendering loop can move exactly
        # the parameters it trains (bench _grad_params / config5) without a
        # rebuild+recompile per step — the enabler for fused-plan training
        # (ops/replay.py).
        self._param = bool(param_inputs)
        # param-mode tables — EVERY C13-validated class the fused path can
        # carry (triangle vertices stay wavefront-only, documented):
        #   sph [S,4]  cx cy cz r
        #   pln [P,9]  point(3) normal(3) albedo2(3)
        #   mat [M,7]  albedo(3) kd ks spec_n ior
        #   lgt [L,6]  pos(3) intensity(3)
        # stored padded to power-of-two shapes (_pad_table); `_rows` keeps
        # the real row counts (≥1 even for absent prim kinds)
        self._psph = _pad_table(np.concatenate(
            [np.asarray(s.spheres.center, np.float32).reshape(-1, 3),
             np.asarray(s.spheres.radius, np.float32).reshape(-1, 1)],
            axis=1))
        self._ppln = _pad_table(np.concatenate(
            [np.asarray(s.planes.point, np.float32).reshape(-1, 3),
             np.asarray(s.planes.normal, np.float32).reshape(-1, 3),
             np.asarray(s.planes.albedo2, np.float32).reshape(-1, 3)],
            axis=1))
        self._pmat = _pad_table(np.concatenate(
            [np.asarray(s.materials.albedo, np.float32).reshape(-1, 3),
             np.asarray(s.materials.kd, np.float32).reshape(-1, 1),
             np.asarray(s.materials.ks, np.float32).reshape(-1, 1),
             np.asarray(s.materials.spec_n, np.float32).reshape(-1, 1),
             np.asarray(s.materials.ior, np.float32).reshape(-1, 1)],
            axis=1))
        self._plgt = _pad_table(np.concatenate(
            [np.asarray(s.lights.pos, np.float32).reshape(-1, 3),
             np.asarray(s.lights.intensity, np.float32).reshape(-1, 3)],
            axis=1))
        self._rows = {
            "sph": max(1, s.spheres.count), "pln": max(1, s.planes.count),
            "mat": max(1, np.asarray(s.materials.albedo).shape[0]),
            "lgt": max(1, np.asarray(s.lights.pos).shape[0])}

        mats = s.materials
        self.spheres = [
            dict(c=tuple(map(float, s.spheres.center[i])),
                 r=float(s.spheres.radius[i]), si=i,
                 **self._mat(mats, int(s.spheres.mat_id[i])))
            for i in range(s.spheres.count)]
        self.planes = [
            dict(p=tuple(map(float, s.planes.point[i])),
                 n=tuple(map(float, s.planes.normal[i])),
                 tan=tuple(map(float, s.planes.tangent[i])),
                 bit=tuple(map(float, s.planes.bitangent[i])),
                 checker=bool(s.planes.checker[i]),
                 cscale=float(s.planes.checker_scale[i]),
                 alb2=tuple(map(float, s.planes.albedo2[i])), pi=i,
                 **self._mat(mats, int(s.planes.mat_id[i])))
            for i in range(s.planes.count)]
        self.tris = []
        if s.meshes.count:
            verts = np.asarray(s.meshes.verts, np.float32)
            tris = np.asarray(s.meshes.tris)
            for i in range(s.meshes.count):
                v0, v1, v2 = (verts[tris[i, k]] for k in range(3))
                e1, e2 = v1 - v0, v2 - v0
                # flat normal exactly as surface_at: normalize(cross(e1,e2)) f32
                cr = np.cross(e1, e2).astype(np.float32)
                n2 = np.float32(np.dot(cr, cr))
                inv = np.float32(1.0) / np.sqrt(n2) if n2 > 1e-12 else np.float32(1.0)
                nrm = (cr * inv).astype(np.float32)
                self.tris.append(
                    dict(v0=tuple(map(float, v0)), e1=tuple(map(float, e1)),
                         e2=tuple(map(float, e2)), n=tuple(map(float, nrm)),
                         **self._mat(mats, int(s.meshes.mat_id[i]))))
        self.lights = [
            (tuple(map(float, s.lights.pos[i])),
             tuple(map(float, s.lights.intensity[i])))
            for i in range(np.asarray(s.lights.pos).shape[0])]

        cam = jax.tree.map(np.asarray, camera)
        self.cam_pos = tuple(map(float, np.asarray(cam.pos)))
        self.c2w = np.asarray(cam.c2w, np.float64)
        self.scale = float(np.tan(np.deg2rad(float(np.asarray(cam.fov_deg))
                                             / 2.0)))

    @staticmethod
    def _mat(mats, mid: int):
        return dict(albedo=tuple(map(float, mats.albedo[mid])),
                    kd=float(mats.kd[mid]), ks=float(mats.ks[mid]),
                    spec_n=float(mats.spec_n[mid]),
                    ior=float(mats.ior[mid]), mid=mid,
                    mirror=int(mats.mtype[mid]) == REFLECTION,
                    glass=int(mats.mtype[mid]) == REFLECTION_AND_REFRACTION)

    # -- vector helpers on (3-tuple of [TR,TC] blocks) ----------------------
    @staticmethod
    def _dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    # -- intersection t against one primitive. `acc` (accessor dict, built
    # in _kernel) resolves trainable constants: baked python floats in
    # serving mode, table loads in param mode — the arithmetic is the
    # same expression either way. ----------------------------------------
    def _sphere_t(self, o, d, sp, t_min, acc):
        c = acc["sph_c"](sp)
        r = acc["sph_r"](sp)
        L = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
        a = self._dot(d, d)
        b = 2.0 * self._dot(d, L)
        c0 = self._dot(L, L) - r * r
        disc = b * b - 4.0 * a * c0
        has = disc >= 0  # radius > 0 statically
        sq = jnp.sqrt(jnp.maximum(jnp.where(has, disc, 1.0), 1e-12))
        sq = jnp.where(has, sq, 0.0)
        q = -0.5 * (b + jnp.where(b >= 0, sq, -sq))
        t0 = q / a
        okq = jnp.abs(q) > 1e-12
        t1 = jnp.where(okq, c0 / jnp.where(okq, q, 1.0), -jnp.inf)
        tlo = jnp.minimum(t0, t1)
        thi = jnp.maximum(t0, t1)
        t = jnp.where(tlo > t_min, tlo, jnp.where(thi > t_min, thi, jnp.inf))
        return jnp.where(has, t, jnp.inf)

    def _plane_t(self, o, d, pln, t_min, acc):
        n = acc["pln_n"](pln)
        p = acc["pln_p"](pln)
        denom = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
        valid = jnp.abs(denom) > _DET_EPS
        num = ((p[0] - o[0]) * n[0] + (p[1] - o[1]) * n[1]
               + (p[2] - o[2]) * n[2])
        t = jnp.where(valid, num / jnp.where(valid, denom, 1.0), -jnp.inf)
        return jnp.where(valid & (t > t_min), t, jnp.inf)

    def _tri_t(self, o, d, tr, t_min):
        # Möller–Trumbore with baked v0/e1/e2 (geometry.triangle_tuv port)
        e1, e2, v0 = tr["e1"], tr["e2"], tr["v0"]
        pv = (d[1] * e2[2] - d[2] * e2[1],
              d[2] * e2[0] - d[0] * e2[2],
              d[0] * e2[1] - d[1] * e2[0])
        det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
        ok = jnp.abs(det) > _DET_EPS
        inv = jnp.where(ok, 1.0, 0.0) / jnp.where(ok, det, 1.0)
        tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
        u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
        qv = (tv[1] * e1[2] - tv[2] * e1[1],
              tv[2] * e1[0] - tv[0] * e1[2],
              tv[0] * e1[1] - tv[1] * e1[0])
        v = self._dot(d, qv) * inv
        t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
        ok &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > t_min)
        return jnp.where(ok, t, jnp.inf)

    def _occluded(self, o, d, max_t, t_min, acc):
        occ = jnp.zeros_like(max_t, bool)
        for sp in self.spheres:
            occ |= self._sphere_t(o, d, sp, t_min, acc) < max_t
        for pln in self.planes:
            occ |= self._plane_t(o, d, pln, t_min, acc) < max_t
        for tr in self.tris:
            occ |= self._tri_t(o, d, tr, t_min) < max_t
        return occ

    # -- the kernel -------------------------------------------------------
    def _kernel(self, row0: int, h_px: int, w_px: int,
                emit_plan: bool = False, train: bool = False,
                band_rows: int = 0, tile: tuple | None = None):
        if train:
            assert self._param and not emit_plan and band_rows > 0, \
                "train kernel: param mode, band rows given"
            # the glass tree's value_and_grad is too big a program: on an
            # H100 its Triton compile ran past 4.5 minutes (PERF.md "Kernel
            # decisions"); glass scenes train through XLA's autodiff
            assert not self._has_glass, \
                "the fused train kernel covers scenes without glass"
        opts = self._opts
        bg = tuple(float(c) for c in opts.background)
        t_min, bias = opts.t_min, opts.bias
        # list order = the SPEC tie order (sphere < plane < triangle, lower
        # index) — the winner loop below keeps the FIRST of equal-t prims
        prims = ([("s", sp) for sp in self.spheres]
                 + [("p", pln) for pln in self.planes]
                 + [("t", tr) for tr in self.tris])
        has_glass = self._has_glass
        # plan layout: one (win, occ) plane pair per RECURSION NODE. Non-
        # glass scenes have one node per depth; glass scenes a binary tree —
        # node (depth b, path p) writes plane index node_off(b) + p, where
        # p = Σ_j c_j·2^(j-1) over the reflect(0)/refract(1) choices on the
        # path. p is exactly the wavefront's uncompacted buffer-slot prefix
        # (child slot = c·2^depth + parent slot under the [reflect|refract]
        # concat), so the replay concatenates bounce-b planes in p order.
        if emit_plan:
            # the occlusion plane packs one bit per light into an int32 —
            # more lights would silently shift-overflow into wrong shadows
            assert len(self.lights) <= 32, \
                "plan emission packs per-light occlusion into int32 bits"
        if has_glass:
            node_off = lambda b: (1 << b) - 1
            n_nodes = (1 << (opts.max_depth + 1)) - 1
        else:
            node_off = lambda b: b
            n_nodes = opts.max_depth + 1
        self._n_plan_nodes = n_nodes
        m = self.c2w
        TR, TC = tile if tile is not None else self._tile

        param = self._param

        def kernel(eps_ref, *refs):
            if param:
                sph_ref, pln_ref, mat_ref, lgt_ref = refs[:4]
                refs = refs[4:]
            if train:
                # plan-replay training kernel: inputs are the recorded plan
                # (win id + occlusion bitmask per recursion node) and the
                # target band; outputs are this program's partial L2 loss
                # and ANALYTIC parameter gradients — jax.value_and_grad
                # traces the closed-form Whitted tree right here in the
                # kernel body, so the whole backward is one in-register
                # program (SURVEY §3.3's fused-backward component).
                # row0 arrives TRACED (like eps): all bands — and all
                # shard_map ranks of the sharded trainer — share ONE
                # compiled kernel.
                row0_ref = refs[0]
                refs = refs[1:]
                win_refs = refs[:n_nodes]
                occ_refs = refs[n_nodes:2 * n_nodes]
                tr_ref, tg_ref, tb_ref = refs[2 * n_nodes:2 * n_nodes + 3]
                loss_ref, *gtab_refs = refs[2 * n_nodes + 3:]
                plan_refs = []
            else:
                r_ref, g_ref, b_ref, *plan_refs = refs

            # param-mode accessors: scalar loads (static indices) in place
            # of baked constants — 0-d values broadcast over [TR,TC].
            # Every accessor returns python floats in serving mode, so the
            # baked kernel is textually identical to before param mode.
            def _vec3(ref, row, c0):
                return tuple(ref[row, c0 + k] for k in range(3))

            acc = {
                "sph_c": (lambda sp: _vec3(sph_ref, sp["si"], 0)) if param
                else (lambda sp: sp["c"]),
                "sph_r": (lambda sp: sph_ref[sp["si"], 3]) if param
                else (lambda sp: sp["r"]),
                "pln_p": (lambda pl_: _vec3(pln_ref, pl_["pi"], 0)) if param
                else (lambda pl_: pl_["p"]),
                "pln_n": (lambda pl_: _vec3(pln_ref, pl_["pi"], 3)) if param
                else (lambda pl_: pl_["n"]),
                "pln_a2": (lambda pl_: _vec3(pln_ref, pl_["pi"], 6)) if param
                else (lambda pl_: pl_["alb2"]),
                "mat_alb": (lambda prm: _vec3(mat_ref, prm["mid"], 0))
                if param else (lambda prm: prm["albedo"]),
                "mat_kd": (lambda prm: mat_ref[prm["mid"], 3]) if param
                else (lambda prm: prm["kd"]),
                "mat_ks": (lambda prm: mat_ref[prm["mid"], 4]) if param
                else (lambda prm: prm["ks"]),
                "mat_specn": (lambda prm: mat_ref[prm["mid"], 5]) if param
                else (lambda prm: prm["spec_n"]),
                "mat_ior": (lambda prm: mat_ref[prm["mid"], 6]) if param
                else (lambda prm: prm["ior"]),
                "lgt_pos": (lambda li: _vec3(lgt_ref, li, 0)) if param
                else (lambda li: self.lights[li][0]),
                "lgt_int": (lambda li: _vec3(lgt_ref, li, 3)) if param
                else (lambda li: self.lights[li][1]),
            }
            # eps (always 0) threads a data dependency through the camera so
            # dependency-chain timing works (benchmarks/rays_per_sec.py); it
            # also future-proofs camera jitter without a rebuild.
            eps = eps_ref[0, 0]
            pi = pl.program_id(0)
            pj = pl.program_id(1)
            row = (pi * TR + jax.lax.broadcasted_iota(jnp.int32,
                                                       (TR, TC), 0)
                   + row0).astype(jnp.float32)
            if train:
                row = row + row0_ref[0, 0]  # traced band offset (f32)
            col = (pj * TC + jax.lax.broadcasted_iota(jnp.int32,
                                                       (TR, TC), 1)
                   ).astype(jnp.float32)
            # raygen (geometry.raygen): full-image projection
            aspect = float(w_px) / float(h_px)
            x = (2.0 * (col + 0.5) / w_px - 1.0) * aspect * self.scale
            y = (1.0 - 2.0 * (row + 0.5) / h_px) * self.scale
            dw = tuple(
                x * float(m[k, 0]) + y * float(m[k, 1]) - float(m[k, 2])
                for k in range(3))
            inv = jax.lax.rsqrt(self._dot(dw, dw))
            d = (dw[0] * inv, dw[1] * inv, dw[2] * inv)
            o = (jnp.full((TR, TC), self.cam_pos[0]) + eps,
                 jnp.full((TR, TC), self.cam_pos[1]),
                 jnp.full((TR, TC), self.cam_pos[2]))

            def radiance(o, d, depth, path=0, *, acc=acc, plan_in=None):
                """Whitted castRay, statically unrolled depth-first.

                Returns the [TR,TC]×3 radiance of a unit-throughput ray;
                ancestors scale by their (kr, 1−kr) weights — the product
                telescopes to the wavefront renderer's throughput. `path`
                names this node's wavefront slot prefix (plan emission).

                `acc` resolves trainable constants (kernel-mode dependent);
                `plan_in = (win_nodes, occ_nodes)` switches to REPLAY: the
                winner search is skipped (ids given), only the winner's t
                is recomputed, and shadow bits come from the plan — the
                closed-form differentiable form the train kernel grads.
                """
                if plan_in is None:
                    # winner search (strict < keeps sphere<plane<tri order)
                    best_t = jnp.full((TR, TC), jnp.inf)
                    win = jnp.full((TR, TC), -1, jnp.int32)
                    for i, (kind, prm) in enumerate(prims):
                        ti = (self._sphere_t(o, d, prm, t_min, acc)
                              if kind == "s"
                              else self._plane_t(o, d, prm, t_min, acc)
                              if kind == "p"
                              else self._tri_t(o, d, prm, t_min))
                        better = ti < best_t
                        best_t = jnp.where(better, ti, best_t)
                        win = jnp.where(better, i, win)
                    valid = win >= 0
                else:
                    # replay: winner given; recompute its t (surface_at's
                    # recompute, here in closed form). Knife-edge lanes
                    # whose recompute misses demote to miss, as on the
                    # wavefront replay path (ops/trace.surface_at).
                    win = plan_in[0][node_off(depth) + path]
                    best_t = jnp.full((TR, TC), jnp.inf)
                    for i, (kind, prm) in enumerate(prims):
                        ti = (self._sphere_t(o, d, prm, t_min, acc)
                              if kind == "s"
                              else self._plane_t(o, d, prm, t_min, acc)
                              if kind == "p"
                              else self._tri_t(o, d, prm, t_min))
                        best_t = jnp.where(win == i, ti, best_t)
                    valid = (win >= 0) & (best_t < jnp.inf)
                if emit_plan:
                    # the render "plan" for this node: fused prim index
                    # (-1 = miss). Replay maps it to (kind, idx) wavefront
                    # residuals — ops/replay.py.
                    plan_refs[node_off(depth) + path][:] = win
                tt = jnp.where(valid, best_t, 0.0)
                p = tuple(o[k] + tt * d[k] for k in range(3))

                # winner attributes (unrolled blends over the tiny scene)
                nrm = [jnp.zeros((TR, TC), jnp.float32) for _ in range(3)]
                alb = [jnp.zeros((TR, TC), jnp.float32) for _ in range(3)]
                kd = jnp.zeros((TR, TC), jnp.float32)
                ks = jnp.zeros((TR, TC), jnp.float32)
                spec_n = jnp.full((TR, TC), 1.0)
                ior = jnp.full((TR, TC), 1.0)
                is_mir = jnp.zeros((TR, TC), bool)
                is_gls = jnp.zeros((TR, TC), bool)
                for i, (kind, prm) in enumerate(prims):
                    msk = win == i
                    alb_i = acc["mat_alb"](prm)
                    if kind == "s":
                        inv_r = 1.0 / acc["sph_r"](prm)
                        cc = acc["sph_c"](prm)
                        ni = tuple((p[k] - cc[k]) * inv_r
                                   for k in range(3))
                        ai = (jnp.full((TR, TC), alb_i[0]),
                              jnp.full((TR, TC), alb_i[1]),
                              jnp.full((TR, TC), alb_i[2]))
                    elif kind == "p":
                        pn = acc["pln_n"](prm)
                        ni = tuple(jnp.full((TR, TC), pn[k])
                                   for k in range(3))
                        if prm["checker"]:
                            pp = acc["pln_p"](prm)
                            a2 = acc["pln_a2"](prm)
                            rel = tuple(p[k] - pp[k] for k in range(3))
                            u = self._dot(rel, prm["tan"]) * prm["cscale"]
                            v = self._dot(rel, prm["bit"]) * prm["cscale"]
                            fu = u - jnp.floor(u)
                            fv = v - jnp.floor(v)
                            pat = (fu > 0.5) ^ (fv > 0.5)
                            ai = tuple(jnp.where(pat, a2[k],
                                                 alb_i[k])
                                       for k in range(3))
                        else:
                            ai = tuple(jnp.full((TR, TC), alb_i[k])
                                       for k in range(3))
                    else:  # triangle: baked flat normal + material albedo
                        ni = tuple(jnp.full((TR, TC), prm["n"][k])
                                   for k in range(3))
                        ai = tuple(jnp.full((TR, TC), alb_i[k])
                                   for k in range(3))
                    for k in range(3):
                        nrm[k] = jnp.where(msk, ni[k], nrm[k])
                        alb[k] = jnp.where(msk, ai[k], alb[k])
                    kd = jnp.where(msk, acc["mat_kd"](prm), kd)
                    ks = jnp.where(msk, acc["mat_ks"](prm), ks)
                    spec_n = jnp.where(msk, acc["mat_specn"](prm), spec_n)
                    ior = jnp.where(msk, acc["mat_ior"](prm), ior)
                    if prm["mirror"]:
                        is_mir |= msk
                    if prm["glass"]:
                        is_gls |= msk
                nrm = tuple(nrm)

                # miss → background
                rad = [jnp.where(valid, 0.0, jnp.float32(bg[k]))
                       for k in range(3)]

                # diffuse leaf → Phong + shadows (ops/shade.py port)
                din = self._dot(d, nrm)
                side = jnp.where(din < 0, 1.0, -1.0)
                so = tuple(p[k] + side * bias * nrm[k] for k in range(3))
                lamt = [jnp.zeros((TR, TC), jnp.float32) for _ in range(3)]
                spec = [jnp.zeros((TR, TC), jnp.float32) for _ in range(3)]
                occ_acc = jnp.zeros((TR, TC), jnp.int32)
                for li in range(len(self.lights)):
                    lpos = acc["lgt_pos"](li)
                    lint = acc["lgt_int"](li)
                    lvec = tuple(lpos[k] - p[k] for k in range(3))
                    d2 = self._dot(lvec, lvec)
                    dist = jnp.sqrt(jnp.maximum(d2, 1e-12))
                    dist = jnp.where(d2 > 0, dist, 0.0)
                    il = 1.0 / jnp.maximum(dist, 1e-12)
                    ldir = tuple(lvec[k] * il for k in range(3))
                    ldn = jnp.maximum(0.0, self._dot(ldir, nrm))
                    if plan_in is not None:  # replay: recorded shadow bit
                        shadowed = ((plan_in[1][node_off(depth) + path]
                                     >> li) & 1) != 0
                    else:
                        shadowed = self._occluded(so, ldir, dist, t_min,
                                                  acc)
                    if emit_plan:  # bit li of the bounce's occlusion mask
                        occ_acc |= shadowed.astype(jnp.int32) << li
                    vis = jnp.where(shadowed, 0.0, 1.0)
                    # r = reflect(-ldir, n); base = -dot(r, d)
                    mld = self._dot(ldir, nrm)
                    rl = tuple(-ldir[k] + 2.0 * mld * nrm[k]
                               for k in range(3))
                    base = -self._dot(rl, d)
                    pw = jnp.where(base > 0,
                                   jnp.power(jnp.maximum(base, 1e-7),
                                             spec_n), 0.0)
                    for k in range(3):
                        lamt[k] += vis * ldn * lint[k]
                        spec[k] += pw * lint[k]
                if emit_plan:
                    plan_refs[n_nodes + node_off(depth) + path][:] = occ_acc
                is_diff = valid & ~is_mir & ~is_gls
                for k in range(3):
                    local = lamt[k] * alb[k] * kd + spec[k] * ks
                    rad[k] += jnp.where(is_diff, local, 0.0)

                # fresnel kr (geometry.fresnel port; kr=1 on TIR)
                cosi = jnp.clip(din, -1.0, 1.0)
                entering = cosi <= 0
                etai = jnp.where(entering, 1.0, ior)
                etat = jnp.where(entering, ior, 1.0)
                s2 = jnp.maximum(1.0 - cosi * cosi, 0.0)
                sq2 = jnp.where(s2 > 0, jnp.sqrt(jnp.maximum(s2, 1e-12)),
                                0.0)
                sint = etai / etat * sq2
                no_tir = sint < 1.0
                c2 = jnp.maximum(1.0 - sint * sint, 0.0)
                cost = jnp.where(no_tir,
                                 jnp.sqrt(jnp.maximum(c2, 1e-12)), 0.0)
                cosa = jnp.abs(cosi)
                den1 = etat * cosa + etai * cost
                den2 = etai * cosa + etat * cost
                rs = jnp.where(no_tir,
                               (etat * cosa - etai * cost)
                               / jnp.where(no_tir, den1, 1.0), 0.0)
                rp = jnp.where(no_tir,
                               (etai * cosa - etat * cost)
                               / jnp.where(no_tir, den2, 1.0), 0.0)
                kr = jnp.where(no_tir, 0.5 * (rs * rs + rp * rp), 1.0)

                if depth == opts.max_depth:
                    # children would exceed max_depth → each returns bg
                    # (mirror: kr·bg; glass: kr·bg + (1−kr)·bg = bg, TIR incl.)
                    w = jnp.where(valid & is_mir, kr,
                                  jnp.where(valid & is_gls, 1.0, 0.0))
                    for k in range(3):
                        rad[k] += w * bg[k]
                    return rad

                # reflect child (mirror AND glass lanes)
                rdw = tuple(d[k] - 2.0 * din * nrm[k] for k in range(3))
                rinv = jax.lax.rsqrt(jnp.maximum(self._dot(rdw, rdw),
                                                 1e-12))
                rd = tuple(rdw[k] * rinv for k in range(3))
                rside = jnp.where(self._dot(rd, nrm) < 0, -1.0, 1.0)
                ro = tuple(p[k] + rside * bias * nrm[k] for k in range(3))
                cr = radiance(ro, rd, depth + 1, path, acc=acc,
                              plan_in=plan_in)  # reflect: c=0
                w_r = jnp.where(valid & (is_mir | is_gls), kr, 0.0)
                for k in range(3):
                    rad[k] += w_r * cr[k]

                if has_glass:
                    # refract child (geometry.refract port; entering = cosi<0)
                    ent_t = din < 0  # unclipped dot as in refract()'s cosi
                    cosa_t = jnp.abs(jnp.clip(din, -1.0, 1.0))
                    etai_t = jnp.where(ent_t, 1.0, ior)
                    etat_t = jnp.where(ent_t, ior, 1.0)
                    n_o = tuple(jnp.where(ent_t, nrm[k], -nrm[k])
                                for k in range(3))
                    eta = etai_t / etat_t
                    kk = 1.0 - eta * eta * (1.0 - cosa_t * cosa_t)
                    t_ok = kk >= 0
                    sqk = jnp.where(t_ok,
                                    jnp.sqrt(jnp.maximum(
                                        jnp.where(t_ok, kk, 1.0), 1e-12)),
                                    0.0)
                    td = tuple(jnp.where(t_ok,
                                         eta * d[k]
                                         + (eta * cosa_t - sqk) * n_o[k],
                                         0.0)
                               for k in range(3))
                    tn2 = self._dot(td, td)
                    tinv = jnp.where(t_ok,
                                     1.0 / jnp.sqrt(jnp.maximum(
                                         jnp.where(t_ok, tn2, 1.0), 1e-12)),
                                     1.0)
                    td = tuple(td[k] * tinv for k in range(3))
                    tside = jnp.where(self._dot(td, nrm) < 0, -1.0, 1.0)
                    to = tuple(p[k] + tside * bias * nrm[k]
                               for k in range(3))
                    # refract: c=1 → slot prefix gains the 2^depth bit
                    ct = radiance(to, td, depth + 1, path + (1 << depth),
                                  acc=acc, plan_in=plan_in)
                    w_t = jnp.where(valid & is_gls & t_ok, 1.0 - kr, 0.0)
                    for k in range(3):
                        rad[k] += w_t * ct[k]
                return rad

            if train:
                # read the plan + target blocks and the param tables ONCE;
                # tile_loss is then a pure function of the param pytree and
                # jax.value_and_grad traces its analytic gradient inline
                win_in = [w_[:] for w_ in win_refs]
                occ_in = [o_[:] for o_ in occ_refs]
                tgt = (tr_ref[:], tg_ref[:], tb_ref[:])
                # mask off grid padding (rows beyond the band, cols beyond
                # the image): their plan is -1/0 fill but their target is 0.
                # row includes the TRACED band offset, so mask against it.
                valid_px = (row < row0_ref[0, 0] + band_rows) & (col < w_px)
                tab_refs = dict(zip((n for n, _ in TABLE_COLS),
                                    (sph_ref, pln_ref, mat_ref, lgt_ref)))
                pt0 = {name: [[tab_refs[name][i, j] for j in range(nc)]
                              for i in range(self._rows[name])]
                       for name, nc in TABLE_COLS}

                def tile_loss(pt):
                    racc = _train_acc(pt)
                    rad = radiance(o, d, 0, acc=racc,
                                   plan_in=(win_in, occ_in))
                    s = jnp.zeros((), jnp.float32)
                    for k in range(3):
                        dk = jnp.clip(rad[k], 0.0, 1.0) - tgt[k]
                        s = s + jnp.sum(jnp.where(valid_px, dk * dk, 0.0))
                    return s

                lval, g = jax.value_and_grad(tile_loss)(pt0)
                # programs run in parallel and in no order: each writes its
                # own partial row, which _train_vg sums outside the kernel.
                # The gradient block is assembled by select on iota (Triton
                # lowers no many-operand concatenate, so no jnp.stack).
                loss_ref[...] = jnp.full(loss_ref.shape, lval)
                for ref, (name, _) in zip(gtab_refs, TABLE_COLS):
                    shp = ref.shape
                    ri = jax.lax.broadcasted_iota(jnp.int32, shp, 0)
                    ci = jax.lax.broadcasted_iota(jnp.int32, shp, 1)
                    blk = jnp.zeros(shp, jnp.float32)
                    for i, row_g in enumerate(g[name]):
                        for j, gij in enumerate(row_g):
                            blk = jnp.where((ri == i) & (ci == j), gij, blk)
                    ref[...] = blk
                return

            rad = radiance(o, d, 0)
            for ref, ch in ((r_ref, rad[0]), (g_ref, rad[1]), (b_ref, rad[2])):
                ref[...] = jnp.clip(ch, 0.0, 1.0)

        return kernel

    @staticmethod
    def _compiler_params(warps):
        return pltriton.CompilerParams(num_warps=int(warps), num_stages=1)

    def _check_device(self):
        """Kernels compile for the GPU; anywhere else only Pallas's
        interpreter can run them, and only when the caller asked for it."""
        if not self._interpret and jax.default_backend() != "gpu":
            raise RuntimeError(
                "FusedWhitted compiles its kernels for the GPU (Pallas on "
                f"Triton); the default backend is {jax.default_backend()!r}."
                " Pass interpret=True to run them in Pallas's interpreter.")

    @functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
    def _render(self, row0: int, rows: int, emit_plan: bool, eps, sph, pln,
                mat, lgt):
        opts = self._opts
        TR, TC = self._tile
        h, w = opts.height, opts.width
        rp = -(-rows // TR) * TR
        wp = -(-w // TC) * TC
        grid = (rp // TR, wp // TC)
        spec = pl.BlockSpec((TR, TC), lambda i, j: (i, j))
        whole = lambda a: pl.BlockSpec(a.shape, lambda i, j: (0,) * a.ndim)
        eps2 = jnp.reshape(jnp.asarray(eps, jnp.float32), (1, 1))
        shape = jax.ShapeDtypeStruct((rp, wp), jnp.float32)
        ishape = jax.ShapeDtypeStruct((rp, wp), jnp.int32)
        n_nodes = ((1 << (opts.max_depth + 1)) - 1 if self._has_glass
                   else opts.max_depth + 1)
        n_plan = 2 * n_nodes if emit_plan else 0
        ins = [eps2]
        if self._param:
            ins += [jnp.asarray(a, jnp.float32)
                    for a in (sph, pln, mat, lgt)]
        out = pl.pallas_call(
            self._kernel(row0, h, w, emit_plan=emit_plan), grid=grid,
            in_specs=[whole(a) for a in ins],
            out_specs=(spec,) * (3 + n_plan),
            out_shape=(shape,) * 3 + (ishape,) * n_plan,
            backend="triton", compiler_params=self._compiler_params(
                self._warps),
            interpret=self._interpret, name="fused_whitted",
        )(*ins)
        img = jnp.stack(out[:3], axis=-1)[:rows, :w]
        if not emit_plan:
            return img
        plan = tuple(pl_[:rows, :w] for pl_ in out[3:])
        return img, plan[:n_nodes], plan[n_nodes:]

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _train_vg(self, row0, rows: int, eps, sph, pln, mat, lgt,
                  wins, occs, tgt):
        """Run the plan-replay training kernel for one band →
        (loss_sum, grads dict of the 4 param tables). Unnormalized: the
        caller divides by its loss denominator. `row0` is TRACED (a kernel
        input): every band — and every shard_map rank of
        plan_value_and_grad_sharded — shares one compiled kernel.

        Each program writes its partial loss and gradient tables to its own
        slot of [gi, gj, ...] outputs; the sum over programs happens here,
        in XLA, after the call."""
        opts = self._opts
        TR, TC = self._vjp_tile
        h, w = opts.height, opts.width
        rp = -(-rows // TR) * TR
        wp = -(-w // TC) * TC
        grid = (rp // TR, wp // TC)
        spec = pl.BlockSpec((TR, TC), lambda i, j: (i, j))
        whole = lambda a: pl.BlockSpec(a.shape, lambda i, j: (0,) * a.ndim)
        part = lambda shp: pl.BlockSpec((None, None) + shp,
                                        lambda i, j: (i, j, 0, 0))

        def pad2(x, fill):
            return jnp.pad(x, ((0, rp - x.shape[0]), (0, wp - x.shape[1])),
                           constant_values=fill)

        tabs = [jnp.asarray(a, jnp.float32) for a in (sph, pln, mat, lgt)]
        wins = [pad2(jnp.asarray(x, jnp.int32), -1) for x in wins]
        occs = [pad2(jnp.asarray(x, jnp.int32), 0) for x in occs]
        tgtp = [pad2(jnp.asarray(tgt[..., k], jnp.float32), 0.0)
                for k in range(3)]
        eps2 = jnp.reshape(jnp.asarray(eps, jnp.float32), (1, 1))
        r02 = jnp.reshape(jnp.asarray(row0, jnp.float32), (1, 1))
        out_shapes = ((jax.ShapeDtypeStruct(grid + (1, 1), jnp.float32),)
                      + tuple(jax.ShapeDtypeStruct(grid + t.shape,
                                                   jnp.float32)
                              for t in tabs))
        out = pl.pallas_call(
            self._kernel(0, h, w, train=True, band_rows=rows,
                         tile=(TR, TC)),
            grid=grid,
            in_specs=([whole(eps2)] + [whole(t) for t in tabs]
                      + [whole(r02)]
                      + [spec] * (len(wins) + len(occs) + 3)),
            out_specs=(part((1, 1)),) + tuple(part(t.shape) for t in tabs),
            out_shape=out_shapes,
            backend="triton", compiler_params=self._compiler_params(
                self._vjp_warps),
            interpret=self._interpret, name="fused_whitted_vjp",
        )(eps2, *tabs, r02, *wins, *occs, *tgtp)
        loss = jnp.sum(out[0])
        grads = {name: jnp.sum(o, axis=(0, 1))[:self._rows[name], :nc]
                 for (name, nc), o in zip(TABLE_COLS, out[1:])}
        return loss, grads

    def plan_value_and_grad(self, target, row0: int = 0,
                            rows: int | None = None, eps=0.0):
        """One fused training micro-step for a band: render_plan (forward at
        serving speed, ids under stop-grad) + the in-kernel analytic
        backward → (loss_sum, grads, img).

        grads are d(Σ_band (clamp(rad)−target)²)/d(table) for the four
        param tables (sph [S,4] = center|radius, pln [P,9] =
        point|normal|albedo2, mat [M,7] = albedo|kd|ks|spec_n|ior,
        lgt [L,6] = pos|intensity) — every C13 class the fused path
        carries. Normalize outside (e.g. ÷ H·W·3 for the bench's MSE).
        Requires param_inputs=True; fresh plans per call ⇒ no recompile as
        bound params move (ops/replay.py's contract, with the replay's XLA
        graph replaced by one Pallas kernel — SURVEY §3.3 'trace-vjp/
        shade-vjp' landed as a single fused VJP)."""
        rows = self._opts.height - row0 if rows is None else rows
        self._check_device()
        img, wins, occs = self.render_plan(row0=row0, rows=rows, eps=eps)
        tgt_band = jax.lax.stop_gradient(jnp.asarray(target, jnp.float32))
        loss, g = self._train_vg(row0, rows, eps, self._psph, self._ppln,
                                 self._pmat, self._plgt, wins, occs,
                                 tgt_band)
        return loss, g, img

    def plan_value_and_grad_sharded(self, target, mesh, eps=0.0):
        """Data-parallel fused-VJP training micro-step on a
        Mesh('tiles', …) → (loss_sum, grads) — the multi-chip twin of
        plan_value_and_grad (SURVEY §2.3 gradient-DP row for the r5
        trainer).

        The plan is emitted full-frame (the cheap serving forward, here
        replicated; on a pod each host renders its slice of the same
        program), then its planes + the target band-shard over 'tiles'
        with the pixel rows; each rank runs ONE train kernel on its band
        (the traced row0 keeps it a single compiled program across ranks)
        and loss/table-gradients all-reduce with `psum` — the shard_map
        expression of per-band linearity, identical to the single-device
        step up to band-sum fp association (tests/test_fused_vjp.py)."""
        from jax.sharding import PartitionSpec as P

        h, w = self._opts.height, self._opts.width
        ntiles = mesh.shape["tiles"]
        assert h % ntiles == 0, f"height {h} not divisible by tiles {ntiles}"
        rows_per = h // ntiles
        self._check_device()
        _, wins, occs = self.render_plan(eps=eps)
        tgt = jax.lax.stop_gradient(jnp.asarray(target, jnp.float32))
        row0s = jnp.arange(ntiles, dtype=jnp.float32) * rows_per
        tabs = (self._psph, self._ppln, self._pmat, self._plgt)

        def shard_fn(wins_s, occs_s, tgt_s, r0):
            loss, g = self._train_vg(r0[0], rows_per, eps, *tabs,
                                     list(wins_s), list(occs_s), tgt_s)
            loss = jax.lax.psum(loss, "tiles")
            g = jax.tree.map(lambda x: jax.lax.psum(x, "tiles"), g)
            return loss, g

        return jax.jit(jax.shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P("tiles"), P("tiles"), P("tiles"), P("tiles")),
            out_specs=(P(), P()), check_vma=False))(
                tuple(wins), tuple(occs), tgt, row0s)

    def bind(self, center=None, albedo=None, radius=None, kd=None, ks=None,
             spec_n=None, ior=None, plane_point=None, plane_normal=None,
             plane_albedo2=None, light_pos=None, light_intensity=None):
        """Param-mode: set the live trainable-parameter inputs (no recompile
        — they are kernel inputs, packed into 4 small tables). Covers
        every C13 parameter class the fused path carries: sphere
        center/radius, material albedo/kd/ks/spec_n/ior, plane
        point/normal/albedo2, light pos/intensity. (Triangle vertices stay
        wavefront-only — baked like the rest of the mesh.) Returns self."""
        assert self._param, "build with param_inputs=True to bind params"

        def _upd(tab, col, val, width):
            val = jnp.asarray(val, jnp.float32).reshape(-1, width)
            return jnp.asarray(tab, jnp.float32).at[
                :val.shape[0], col:col + width].set(val)

        if center is not None:
            self._psph = _upd(self._psph, 0, center, 3)
        if radius is not None:
            self._psph = _upd(self._psph, 3, radius, 1)
        if plane_point is not None:
            self._ppln = _upd(self._ppln, 0, plane_point, 3)
        if plane_normal is not None:
            self._ppln = _upd(self._ppln, 3, plane_normal, 3)
        if plane_albedo2 is not None:
            self._ppln = _upd(self._ppln, 6, plane_albedo2, 3)
        if albedo is not None:
            self._pmat = _upd(self._pmat, 0, albedo, 3)
        if kd is not None:
            self._pmat = _upd(self._pmat, 3, kd, 1)
        if ks is not None:
            self._pmat = _upd(self._pmat, 4, ks, 1)
        if spec_n is not None:
            self._pmat = _upd(self._pmat, 5, spec_n, 1)
        if ior is not None:
            self._pmat = _upd(self._pmat, 6, ior, 1)
        if light_pos is not None:
            self._plgt = _upd(self._plgt, 0, light_pos, 3)
        if light_intensity is not None:
            self._plgt = _upd(self._plgt, 3, light_intensity, 3)
        return self

    def render(self, row0: int = 0, rows: int | None = None, eps=0.0):
        """→ image [rows, W, 3] in [0,1] (band of the full projection).

        `eps` (keep 0) perturbs the camera x — the data-dependency hook for
        chained timing."""
        rows = self._opts.height - row0 if rows is None else rows
        self._check_device()
        return self._render(row0, rows, False, eps, self._psph, self._ppln,
                            self._pmat, self._plgt)

    def render_plan(self, row0: int = 0, rows: int | None = None, eps=0.0):
        """→ (image, win_planes, occ_planes): the forward render PLUS the
        frame's replay plan — per recursion NODE, the fused-prim winner
        index ([rows, W] i32, −1 = miss) and the per-light shadow-occlusion
        bitmask (bit l = light l occluded). Non-glass scenes emit one node
        per depth; glass scenes the full 2^(D+1)−1 node tree in (bounce,
        path-prefix) order (see _kernel's plan-layout note). ops/replay.py
        turns these into the wavefront renderer's integer residuals so
        training replays shading without re-running any winner search;
        with param_inputs=True the plan refreshes per step at zero
        recompile cost."""
        rows = self._opts.height - row0 if rows is None else rows
        self._check_device()
        return self._render(row0, rows, True, eps, self._psph, self._ppln,
                            self._pmat, self._plgt)
