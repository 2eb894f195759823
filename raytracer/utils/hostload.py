"""Host-side scene/tracer loading shared by the CLI and the elastic workers.

One copy of: preset-vs-scenefile loading with width/height/depth overrides
(reference analog: `main()`'s Options + scene setup, SURVEY §1 L5) and the
meshes-gated winner-search backend selection. Everything here is cold-path
host code — scenes build as numpy pytrees (core/types.py) and no function
below touches a device.
"""

import dataclasses


def load_scene_cli(config: str = "", scene_path: str = "", width: int = 0,
                   height: int = 0, max_depth: int | None = None):
    """(scene, camera, opts) from a preset name or a scene text file."""
    if scene_path:
        from raytracer.io.scenefile import load_scene

        scene, cam, opts = load_scene(scene_path)
    else:
        from raytracer.models import presets

        scene, cam, opts = presets.PRESETS[config]()
    if width:
        opts = dataclasses.replace(opts, width=width, height=height or width)
    if max_depth is not None:
        opts = dataclasses.replace(opts, max_depth=max_depth)
    return scene, cam, opts


def build_tracer(scene, kind: str):
    """Winner-search backend for `kind` in {auto, none, grid, bvh}; None
    when the scene has no mesh (dense scan covers analytic prims). The
    `fused` backend is NOT built here — it replaces the whole renderer, not
    the tracer (cli.cmd_render handles it explicitly)."""
    if kind not in ("auto", "none", "grid", "bvh"):
        raise ValueError(
            f"unknown tracer kind {kind!r}: choose auto, none, grid or bvh "
            "(the brute-force Pallas, matmul and Pallas-walk tracers were "
            "removed; the grid and BVH walks are the mesh path)")
    if not scene.meshes.count or kind == "none":
        return None
    if kind in ("grid", "auto"):
        from raytracer.accel.grid import GridTracer

        return GridTracer.build(scene)
    from raytracer.accel.bvh import BVHTracer

    return BVHTracer.build(scene)
