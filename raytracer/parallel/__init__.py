from raytracer.parallel.mesh import make_rt_mesh
from raytracer.parallel.shard import render_sharded

__all__ = ["make_rt_mesh", "render_sharded"]
