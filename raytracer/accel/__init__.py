from raytracer.accel.bvh import BVHData, BVHTracer, build_bvh
from raytracer.accel.grid import GridData, GridTracer, build_grid

__all__ = ["BVHData", "BVHTracer", "build_bvh", "GridData", "GridTracer",
           "build_grid"]
