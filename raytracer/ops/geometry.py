"""Vectorized intersection + optics ops (docs/SPEC.md "Intersections", "Optics").

Reference analogs (SURVEY.md §2.2): `Sphere::intersect`/`solveQuadratic`,
plane `intersect`, `rayTriangleIntersect` (Möller–Trumbore), `reflect`, `refract`,
`fresnel`. All ops are batched over rays (and primitives) as dense jnp arrays —
plain elementwise math, no data-dependent control flow.

Shapes: rays are [N,3]; primitive packs broadcast to [N,P] candidate-t matrices.
Misses are +inf so a plain `min` reduce finds the nearest hit.
"""

import jax.numpy as jnp

from raytracer.ops.safemath import cross, dot, normalize, safe_div, safe_sqrt

INF = jnp.inf
_DET_EPS = 1e-8


# ---------------------------------------------------------------------------
# Intersections
# ---------------------------------------------------------------------------

def sphere_t(orig, direc, center, radius, t_min):
    """Nearest positive hit distance, elementwise over leading broadcast shape.

    orig/direc/center: [..., 3]; radius: [...]. Returns t [...] (+inf on miss).
    Stable quadratic per SPEC (Scratchapixel `solveQuadratic` lineage).
    """
    L = orig - center
    a = dot(direc, direc)
    b = 2.0 * dot(direc, L)
    c0 = dot(L, L) - radius * radius
    disc = b * b - 4.0 * a * c0
    # radius > 0 guard: r<=0 marks padding spheres (parallel/tracer.py); for a
    # true r=0 the discriminant is ≤0 analytically but fp cancellation on huge
    # |L| can produce phantom roots.
    has_root = (disc >= 0) & (radius > 0)
    sq = safe_sqrt(disc, valid=has_root)
    q = -0.5 * (b + jnp.where(b >= 0, sq, -sq))
    t0 = safe_div(q, a)
    t1 = safe_div(c0, q, valid=jnp.abs(q) > 1e-12, fallback=-INF)
    tlo = jnp.minimum(t0, t1)
    thi = jnp.maximum(t0, t1)
    t = jnp.where(tlo > t_min, tlo, jnp.where(thi > t_min, thi, INF))
    return jnp.where(has_root, t, INF)


def sphere_hits(orig, direc, centers, radii, t_min):
    """[N,3] rays × [Ns] spheres → t [N,Ns]."""
    return sphere_t(orig[:, None, :], direc[:, None, :], centers[None, :, :],
                    radii[None, :], t_min)


def plane_t(orig, direc, point, normal, t_min):
    """Infinite plane hit distance; broadcast elementwise; +inf on miss."""
    denom = dot(normal, direc)
    valid = jnp.abs(denom) > _DET_EPS
    t = safe_div(dot(point - orig, normal), denom, valid=valid, fallback=-INF)
    return jnp.where(valid & (t > t_min), t, INF)


def plane_hits(orig, direc, points, normals, t_min):
    """[N,3] rays × [Np] planes → t [N,Np]."""
    return plane_t(orig[:, None, :], direc[:, None, :], points[None, :, :],
                   normals[None, :, :], t_min)


def triangle_tuv(orig, direc, v0, e1, e2, t_min):
    """Möller–Trumbore, no backface culling; elementwise over broadcast shape.

    Returns (t, u, v); t=+inf on miss. Reference analog: `rayTriangleIntersect`.
    """
    pvec = cross(direc, e2)
    det = dot(e1, pvec)
    valid = jnp.abs(det) > _DET_EPS
    inv = safe_div(jnp.ones_like(det), det, valid=valid)
    tvec = orig - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(direc, qvec) * inv
    t = dot(e2, qvec) * inv
    valid &= (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > t_min)
    return jnp.where(valid, t, INF), u, v


def triangle_hits(orig, direc, v0, e1, e2, t_min):
    """[N,3] rays × [T] triangles → (t, u, v) each [N,T]."""
    t, u, v = triangle_tuv(orig[:, None, :], direc[:, None, :], v0[None, :, :],
                           e1[None, :, :], e2[None, :, :], t_min)
    return t, u, v


# ---------------------------------------------------------------------------
# Optics (docs/SPEC.md "Optics helpers")
# ---------------------------------------------------------------------------

def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def refract(i, n, ior):
    """Returns (t_dir, valid). valid=False on total internal reflection."""
    cosi = jnp.clip(dot(i, n), -1.0, 1.0)
    entering = cosi < 0
    cosi_a = jnp.abs(cosi)
    etai = jnp.where(entering, 1.0, ior)
    etat = jnp.where(entering, ior, 1.0)
    n_o = jnp.where(entering[..., None], n, -n)
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - cosi_a * cosi_a)
    valid = k >= 0
    tdir = eta[..., None] * i + (eta * cosi_a - safe_sqrt(k, valid))[..., None] * n_o
    return jnp.where(valid[..., None], tdir, 0.0), valid


def fresnel(i, n, ior):
    """Unpolarized Fresnel reflectance kr; kr=1 on TIR."""
    cosi = jnp.clip(dot(i, n), -1.0, 1.0)
    entering = cosi <= 0
    etai = jnp.where(entering, 1.0, ior)
    etat = jnp.where(entering, ior, 1.0)
    sint = etai / etat * safe_sqrt(jnp.maximum(1.0 - cosi * cosi, 0.0),
                                   valid=(1.0 - cosi * cosi) > 0)
    no_tir = sint < 1.0
    cost = safe_sqrt(jnp.maximum(1.0 - sint * sint, 0.0), valid=no_tir)
    cosi_a = jnp.abs(cosi)
    rs = safe_div(etat * cosi_a - etai * cost, etat * cosi_a + etai * cost,
                  valid=no_tir)
    rp = safe_div(etai * cosi_a - etat * cost, etai * cosi_a + etat * cost,
                  valid=no_tir)
    kr = 0.5 * (rs * rs + rp * rp)
    return jnp.where(no_tir, kr, 1.0)


def spawn_origin(p, n, out_dir, bias):
    """Child/shadow ray origin offset along the normal (SPEC castRay rules)."""
    side = jnp.where(dot(out_dir, n) < 0, -1.0, 1.0)
    return p + side[..., None] * bias * n


def raygen(cam_pos, c2w, fov_deg, width, height, dtype=jnp.float32,
           row0: int = 0, rows: int | None = None):
    """Camera ray directions, row-major. → ([rows·width, 3] dirs).

    Reference analog: the `render()` prologue NDC→screen mapping (SURVEY §3.1).
    `row0`/`rows` select a horizontal band (full-image projection unchanged) —
    used for band-split rendering/gradient microbatching.
    """
    rows = height if rows is None else rows
    scale = jnp.tan(jnp.deg2rad(jnp.asarray(fov_deg, dtype) / 2.0))
    aspect = dtype(width) / dtype(height)
    i = (jnp.arange(width, dtype=dtype) + 0.5) / width                 # cols
    # row0 may be a traced scalar (one compiled program serves every band of
    # the same height); integer adds are exact in f32 for any sane height
    j = (jnp.arange(rows, dtype=dtype)
         + jnp.asarray(row0, dtype) + 0.5) / height                    # rows
    x = (2.0 * i - 1.0) * aspect * scale                  # [W]
    y = (1.0 - 2.0 * j) * scale                           # [rows]
    xx = jnp.broadcast_to(x[None, :], (rows, width))
    yy = jnp.broadcast_to(y[:, None], (rows, width))
    d_cam = jnp.stack([xx, yy, -jnp.ones_like(xx)], axis=-1).reshape(-1, 3)
    # explicit rotate (not @): a matmul at default precision may run in
    # reduced precision (TF32 on the GPU), which shifts ray directions enough
    # to flip pixels vs the fp32 oracle
    m = c2w.astype(dtype)
    d_world = (d_cam[:, 0:1] * m[:, 0][None, :]
               + d_cam[:, 1:2] * m[:, 1][None, :]
               + d_cam[:, 2:3] * m[:, 2][None, :])
    return normalize(d_world, valid=jnp.ones(d_world.shape[:-1], bool))
