"""Device-mesh construction + multi-host bring-up (SURVEY.md §2.4, §3.4).

The mesh has two axes:
  'tiles' — pixel-tile data parallelism (zero cross-chip comm in forward except
            the final gather of image shards),
  'prims' — primitive sharding (TP-analog): each chip intersects its primitive
            shard against all its rays; partial hits min-combine over the axis.

Multi-host: call `init_distributed()` once per process before building the mesh;
XLA lowers the shard_map collectives to the device interconnect (NCCL over
NVLink between the GPUs of a host) — no custom transport (the XLA collective
compiler stands in for the reference genre's nonexistent comm layer). Every
device reaches every other at the same rate, so the mesh follows the
algorithm alone.
"""

import jax


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host runtime bring-up (no-op if single-process)."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def make_rt_mesh(tiles: int | None = None, prims: int = 1, devices=None):
    """Mesh('tiles','prims') over the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if tiles is None:
        assert n % prims == 0, (n, prims)
        tiles = n // prims
    assert tiles * prims == n, (tiles, prims, n)
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((tiles, prims), ("tiles", "prims"),
                         axis_types=auto, devices=devices)
