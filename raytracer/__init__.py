"""raytracer — a differentiable Whitted ray tracer in JAX.

Brand-new framework with the capabilities of the reference C++ renderer
(`Sh-Anand/Raytracer-in-CPP`; see SURVEY.md — the reference mount was empty, so the
capability contract is SURVEY.md §2.1 / BASELINE.json, and the bit-level ground truth
is our own oracle pair in tests/oracle + native/oracle.cpp, all three following
docs/SPEC.md).

Layout (SURVEY.md §7.4):
  core/      scene / camera / material / options pytrees
  ops/       compute path: safe math, intersections, trace, shade (jnp + Pallas)
  models/    scene presets — the five benchmark configs (BASELINE.json configs 1-5)
  parallel/  device-mesh sharding: pixel-tile DP, primitive sharding, ring streaming
  accel/     uniform-grid acceleration (host build, device walk)
  io/        OBJ loading, procedural meshes, image output
  utils/     profiling / misc
"""

from raytracer.core.types import (
    Camera,
    Lights,
    Materials,
    Meshes,
    Planes,
    RenderOptions,
    Scene,
    Spheres,
)
from raytracer.renderer import (render, render_banded, render_rays,
                                    value_and_grad_banded)

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Lights",
    "Materials",
    "Meshes",
    "Planes",
    "RenderOptions",
    "Scene",
    "Spheres",
    "render",
    "render_banded",
    "render_rays",
    "value_and_grad_banded",
]
