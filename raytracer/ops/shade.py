"""Local Phong shading with shadow rays (docs/SPEC.md DIFFUSE_AND_GLOSSY branch).

Reference analog: the `castRay` diffuse/glossy switch arm — per-light shadow trace,
Lambert accumulation, Phong specular (SURVEY.md §3.1 L3). Genre-exact quirks kept:
specular is not shadow-masked and not multiplied by albedo; shadow rays test all
objects including transparent ones.
"""

import jax
import jax.numpy as jnp

from raytracer.core.types import Scene
from raytracer.ops import trace as trace_ops
from raytracer.ops.geometry import reflect, spawn_origin
from raytracer.ops.safemath import dot, safe_pow, safe_sqrt


def shade_diffuse(scene: Scene, surf, in_dir, bias: float, t_min: float,
                  tri_chunk: int, count_rays: bool = False, tracer=None,
                  active=None, occ_out: list | None = None):
    """Phong local radiance [N,3] for rays hitting diffuse/glossy surfaces.

    Computed for *all* rays (branchless); the caller masks by material type.
    `tracer` overrides the occlusion backend (sharded/ring paths in parallel/).
    `active` [N] bool marks the lanes whose result the caller will keep — the
    walk-based occlusion backends park the other lanes instead of DDA-walking
    shadow rays whose contribution is masked out anyway (active lanes'
    results are bitwise-unchanged).
    `occ_out` (a list) collects this bounce's per-light occlusion BITMASK
    [N] i32 (bit l = light l occluded) — the render-"plan" encoding the
    replay trainers consume (ops/replay.PlanTracer; ≤32 lights).
    Returns (rgb, shadow_ray_count) — the count is for rays/s accounting only.
    """
    if occ_out is not None:
        assert scene.lights.count <= 32, "occ bitmask packs into int32"
        occ_acc = jnp.zeros(surf.p.shape[:1], jnp.int32)
    p, n = surf.p, surf.n
    # Shadow origin: + bias·N when the viewing ray hits the front face (SPEC).
    sorig = p + jnp.where(dot(in_dir, n) < 0, 1.0, -1.0)[:, None] * bias * n

    light_amt = jnp.zeros_like(p)
    spec = jnp.zeros_like(p)
    n_shadow = jnp.zeros((), jnp.int32)
    for li in range(scene.lights.count):  # L is tiny and static — unrolled
        lpos = scene.lights.pos[li]
        lint = scene.lights.intensity[li]
        lvec = lpos[None, :] - p
        d2 = dot(lvec, lvec)
        dist = safe_sqrt(d2, valid=d2 > 0)
        ldir = lvec / jnp.maximum(dist, 1e-12)[:, None]
        ldn = jnp.maximum(0.0, dot(ldir, n))
        # lanes facing AWAY from the light (ldn == 0) park their shadow walk:
        # the occlusion bit is only ever consumed as vis·ldn in the diffuse
        # term (genre-exact: specular is not shadow-masked), so their result
        # is multiplied by zero — masking them is bitwise-exact and cuts the
        # walk's live set ~in half on curved geometry
        lit = jax.lax.stop_gradient(ldn > 0)
        oactive = lit if active is None else (active & lit)
        if tracer is None:
            shadowed = trace_ops.occluded(scene, sorig, ldir, dist, t_min,
                                          tri_chunk, active=oactive)
        else:
            shadowed = tracer.occluded(sorig, ldir, dist, t_min, tri_chunk,
                                       active=oactive)
        # part of the render "plan" (renderer._name_plan): saved as a remat
        # residual so the backward never re-walks shadow rays
        from jax.ad_checkpoint import checkpoint_name
        shadowed = checkpoint_name(shadowed, "trace_plan")
        if occ_out is not None:
            occ_acc = occ_acc | (shadowed.astype(jnp.int32) << li)
        vis = jnp.where(shadowed, 0.0, 1.0)
        light_amt = light_amt + (vis * ldn)[:, None] * lint[None, :]
        r = reflect(-ldir, n)
        spec = spec + safe_pow(-dot(r, in_dir), surf.spec_n)[:, None] * lint[None, :]
        if count_rays:
            n_shadow = n_shadow + p.shape[0]
    rgb = light_amt * surf.albedo * surf.kd[:, None] + spec * surf.ks[:, None]
    if occ_out is not None:
        occ_out.append(occ_acc)
    return rgb, n_shadow
