"""Scene / camera / options pytrees — SoA everything, no polymorphism.

Accelerator-first data model (SURVEY.md §7.1): the reference's polymorphic `Object` class
hierarchy (virtual `intersect` / `getSurfaceProperties`) becomes dense
struct-of-arrays pytrees; material dispatch becomes branchless `where` blends.
All dataclasses are registered JAX pytrees, so `jax.grad` w.r.t. a whole `Scene`
works out of the box (inverse rendering, BASELINE.json config 5).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

# Material type codes (docs/SPEC.md "Materials")
DIFFUSE_AND_GLOSSY = 0
REFLECTION = 1
REFLECTION_AND_REFRACTION = 2

# Primitive kind codes carried in hit records
KIND_NONE = 0
KIND_SPHERE = 1
KIND_PLANE = 2
KIND_TRIANGLE = 3


def _pytree(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def _f32(x):
    # Host (numpy) arrays on purpose: scene construction is cold path; jit
    # uploads leaves at call time. Building eagerly on device would also force
    # device→host readbacks in make_scene (has_glass).
    return np.asarray(x, np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


@_pytree
class Spheres:
    """Sphere pack. Reference analog: `Sphere::intersect` objects (SURVEY.md §2.2)."""

    center: jax.Array  # [Ns, 3] f32
    radius: jax.Array  # [Ns]    f32
    mat_id: jax.Array  # [Ns]    i32

    @staticmethod
    def build(center, radius, mat_id) -> "Spheres":
        return Spheres(_f32(center).reshape(-1, 3), _f32(radius).reshape(-1),
                       _i32(mat_id).reshape(-1))

    @staticmethod
    def empty() -> "Spheres":
        return Spheres.build(np.zeros((0, 3)), np.zeros((0,)), np.zeros((0,)))

    @property
    def count(self) -> int:
        return self.center.shape[0]


@_pytree
class Planes:
    """Infinite-plane pack with optional checkerboard albedo (SPEC: Plane)."""

    point: jax.Array          # [Np, 3] f32
    normal: jax.Array         # [Np, 3] f32 unit
    tangent: jax.Array        # [Np, 3] f32 unit (u axis for checker uv)
    bitangent: jax.Array      # [Np, 3] f32 unit (v axis)
    mat_id: jax.Array         # [Np]    i32
    checker: jax.Array        # [Np]    i32 0/1
    checker_scale: jax.Array  # [Np]    f32
    albedo2: jax.Array        # [Np, 3] f32 second checker color

    @staticmethod
    def build(point, normal, tangent, bitangent, mat_id, checker=None,
              checker_scale=None, albedo2=None) -> "Planes":
        point = _f32(point).reshape(-1, 3)
        n = point.shape[0]
        if checker is None:
            checker = np.zeros((n,), np.int32)
        if checker_scale is None:
            checker_scale = np.ones((n,), np.float32)
        if albedo2 is None:
            albedo2 = np.zeros((n, 3), np.float32)
        return Planes(point, _f32(normal).reshape(-1, 3),
                      _f32(tangent).reshape(-1, 3), _f32(bitangent).reshape(-1, 3),
                      _i32(mat_id).reshape(-1), _i32(checker).reshape(-1),
                      _f32(checker_scale).reshape(-1), _f32(albedo2).reshape(-1, 3))

    @staticmethod
    def empty() -> "Planes":
        z3 = np.zeros((0, 3))
        z = np.zeros((0,))
        return Planes.build(z3, z3, z3, z3, z)

    @property
    def count(self) -> int:
        return self.point.shape[0]


@_pytree
class Meshes:
    """Triangle soup (all meshes flattened). Reference analog: `TriangleMesh`.

    Vertex positions `verts` are the differentiable leaves; `tri_soa()` derives
    the Möller–Trumbore-ready (v0, e1, e2) arrays per trace so gradients flow
    back to `verts` (inverse rendering over mesh geometry).
    """

    verts: jax.Array     # [V, 3] f32 — differentiable
    tris: jax.Array      # [T, 3] i32 — static topology
    normals: jax.Array   # [V, 3] f32 vertex normals, or [0,3] for flat shading
    mat_id: jax.Array    # [T]    i32
    uvs: jax.Array       # [V, 2] f32 per-vertex texture coords, or [0,2]
    #                      (vertex-aligned; the OBJ loader splits vertices so
    #                       per-corner `vt` indices become vertex-aligned)
    checker: jax.Array   # [T]    i32 0/1 — st-checker albedo on this triangle
    checker_scale: jax.Array  # [T] f32 — checker frequency in st units
    albedo2: jax.Array   # [T, 3] f32 — second checker color

    @staticmethod
    def build(verts, tris, mat_id, normals=None, uvs=None, checker=None,
              checker_scale=None, albedo2=None) -> "Meshes":
        tris = _i32(tris).reshape(-1, 3)
        t = tris.shape[0]
        if normals is None:
            normals = np.zeros((0, 3), np.float32)
        if uvs is None:
            uvs = np.zeros((0, 2), np.float32)
        if checker is None:
            checker = np.zeros((t,), np.int32)
        if checker_scale is None:
            checker_scale = np.ones((t,), np.float32)
        if albedo2 is None:
            albedo2 = np.zeros((t, 3), np.float32)
        return Meshes(_f32(verts).reshape(-1, 3), tris,
                      _f32(normals).reshape(-1, 3), _i32(mat_id).reshape(-1),
                      _f32(uvs).reshape(-1, 2), _i32(checker).reshape(-1),
                      _f32(checker_scale).reshape(-1),
                      _f32(albedo2).reshape(-1, 3))

    @staticmethod
    def empty() -> "Meshes":
        return Meshes.build(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))

    @property
    def count(self) -> int:
        return self.tris.shape[0]

    @property
    def smooth(self) -> bool:
        return self.normals.shape[0] > 0

    @property
    def has_uv(self) -> bool:
        return self.uvs.shape[0] > 0

    def tri_soa(self):
        """Gather (v0, e1, e2) [T,3] each — the MT-ready layout."""
        v0 = self.verts[self.tris[:, 0]]
        v1 = self.verts[self.tris[:, 1]]
        v2 = self.verts[self.tris[:, 2]]
        return v0, v1 - v0, v2 - v0

    def tri_normals(self):
        """Per-vertex normals gathered per-triangle corner: 3 × [T,3]."""
        return (self.normals[self.tris[:, 0]], self.normals[self.tris[:, 1]],
                self.normals[self.tris[:, 2]])


@_pytree
class Materials:
    """Material table (docs/SPEC.md). Reference analog: per-Object params + enum."""

    mtype: jax.Array   # [M] i32 (0 diffuse/glossy, 1 mirror, 2 glass)
    albedo: jax.Array  # [M, 3] f32
    kd: jax.Array      # [M] f32
    ks: jax.Array      # [M] f32
    spec_n: jax.Array  # [M] f32 specular exponent
    ior: jax.Array     # [M] f32 index of refraction

    @staticmethod
    def build(mtype, albedo, kd, ks, spec_n, ior) -> "Materials":
        return Materials(_i32(mtype).reshape(-1), _f32(albedo).reshape(-1, 3),
                         _f32(kd).reshape(-1), _f32(ks).reshape(-1),
                         _f32(spec_n).reshape(-1), _f32(ior).reshape(-1))


@_pytree
class Lights:
    """Point lights. Reference analog: `Light { position, intensity }`."""

    pos: jax.Array        # [L, 3] f32
    intensity: jax.Array  # [L, 3] f32

    @staticmethod
    def build(pos, intensity) -> "Lights":
        return Lights(_f32(pos).reshape(-1, 3), _f32(intensity).reshape(-1, 3))

    @property
    def count(self) -> int:
        return self.pos.shape[0]


def as_jax(tree):
    """Coerce numpy leaves to jnp arrays (no-op for tracers/device arrays).

    Scenes are built as host numpy pytrees (see _f32); call this at jit-trace
    entry points so traced gathers (`verts[idx]`) work. Eagerly this is a pure
    H2D upload — it never triggers a device→host readback.
    """
    return jax.tree.map(jnp.asarray, tree)


@dataclasses.dataclass
class Scene:
    """Whole scene: SoA pytree of primitives + materials + lights.

    `has_glass` is *static* metadata: it decides whether the wavefront ray buffers
    double per bounce (glass spawns a refraction child). Keeping it out of the traced
    data means XLA compiles the tight single-child program for glass-free scenes.
    """

    spheres: Spheres
    planes: Planes
    meshes: Meshes
    materials: Materials
    lights: Lights
    has_glass: bool = False

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


jax.tree_util.register_dataclass(
    Scene,
    data_fields=["spheres", "planes", "meshes", "materials", "lights"],
    meta_fields=["has_glass"],
)


def make_scene(spheres=None, planes=None, meshes=None, materials=None,
               lights=None) -> Scene:
    spheres = spheres if spheres is not None else Spheres.empty()
    planes = planes if planes is not None else Planes.empty()
    meshes = meshes if meshes is not None else Meshes.empty()
    assert materials is not None and lights is not None
    has_glass = bool(np.any(np.asarray(materials.mtype) == REFLECTION_AND_REFRACTION))
    return Scene(spheres, planes, meshes, materials, lights, has_glass=has_glass)


@_pytree
class Camera:
    """Pinhole camera: position + camera-to-world rotation + vertical fov (degrees).

    Reference analog: `Options{fov}` + cameraToWorld matrix (SURVEY §2.2 Camera/raygen).
    All fields are differentiable arrays (camera optimization is free).
    """

    pos: jax.Array      # [3] f32
    c2w: jax.Array      # [3,3] f32 rotation (columns: right, up, -forward basis)
    fov_deg: jax.Array  # [] f32 vertical field of view

    @staticmethod
    def build(pos=(0.0, 0.0, 0.0), c2w=None, fov_deg=90.0) -> "Camera":
        if c2w is None:
            c2w = np.eye(3)
        return Camera(_f32(pos).reshape(3), _f32(c2w).reshape(3, 3),
                      _f32(fov_deg).reshape(()))

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_deg=90.0) -> "Camera":
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        c2w = np.stack([right, true_up, -fwd], axis=1)  # maps (x, y, -1) → world
        return Camera.build(eye, c2w, fov_deg)


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render options (hashable → usable as a jit static arg).

    Reference analog: the `Options{width,height,fov,maxDepth,bias,backgroundColor}`
    struct (SURVEY §1 L5), minus fov which lives on Camera (differentiable).
    """

    width: int = 256
    height: int = 256
    max_depth: int = 4
    bias: float = 1e-4
    t_min: float = 1e-4
    background: tuple = (0.235294, 0.67451, 0.843137)
    tile_rays: int = 16384   # wavefront tile size (primary rays per device step)
    remat_tiles: bool = True  # jax.checkpoint per tile (bounded backward memory)
    remat_policy: str = "plan"  # "plan": save ONLY the walk outputs (winner
    # ids/t + shadow-occlusion bits, tagged checkpoint_name 'trace_plan') and
    # recompute the cheap differentiable shading from them in the backward —
    # the winner search (the expensive stop-gradient walks) is neither
    # recomputed (its outputs are residuals) nor does it force full
    # activation storage. "full": plain jax.checkpoint (recomputes the walks
    # too).
    tri_chunk: int = 1024    # triangles per inner scan step in the jnp trace
    compact_cap: float | None = None  # wavefront lane compaction: cap the ray
    # buffer at compact_cap×(primary rays) per bounce, keeping alive lanes
    # (glass scenes otherwise DOUBLE the buffer per bounce while occupancy
    # craters — measured 5.5% weighted on config3 d4, benchmarks/occupancy).
    # FRACTIONAL caps (<1) also compact single-child wavefronts: from bounce 1
    # only specular children are alive, but parked lanes still pay full
    # gather rows in the grid/BVH walks, so shrinking the buffer multiplies
    # walk throughput.
    # Exact iff no alive lane overflows the cap — render() then returns the
    # dropped-lane count for the caller to check (see renderer.render).
    tile_block: tuple | None = None  # (bh, bw) screen-block tile order: scan
    # tiles become bh×bw pixel blocks (bh·bw == tile_rays) instead of flat
    # row-major runs. Radiance is identical per pixel (a static permutation
    # in, its inverse out); the point is LOCALITY — per-tile frustum culling
    # (accel/cull.py) needs compact tile AABBs, and a 2.7-row full-width
    # strip at 1080p sweeps the whole mesh where a 64×80 block sees a sliver
    # (measured: shadow culled-lists 20050 → O(100s) of 20480 tris).
    # Non-compacted wavefronts only (compaction's strided tiling is its own
    # occupancy-equalizing order).
