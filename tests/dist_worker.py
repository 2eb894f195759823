"""Multi-process distributed worker (launched by test_multiprocess.py).

Each process owns one CPU device; together they form a 2-process
jax.distributed cluster (the multi-host bring-up path of SURVEY.md §3.4 on
localhost, gloo collectives). Renders a sharded image and process 0 checks it
against the local single-device render.
"""

import os
import sys


def main():
    proc_id = int(sys.argv[1])
    num_procs = int(sys.argv[2])
    port = sys.argv[3]
    out_path = sys.argv[4]

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=num_procs, process_id=proc_id)
    assert jax.process_count() == num_procs
    assert len(jax.devices()) == num_procs  # 1 CPU device per process

    import dataclasses

    import numpy as np

    from raytracer.models import presets
    from raytracer.parallel.mesh import make_rt_mesh
    from raytracer.parallel.shard import render_sharded
    from raytracer.renderer import render

    scene, cam, opts = presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=32, height=32, tile_rays=256)

    mesh = make_rt_mesh(tiles=num_procs, prims=1)
    img_sharded = render_sharded(scene, cam, opts, mesh)[0]
    # gather the fully-addressable image on every process
    img_local = np.asarray(
        jax.experimental.multihost_utils.process_allgather(img_sharded,
                                                           tiled=True))
    if proc_id == 0:
        ref = np.asarray(render(scene, cam, opts)[0])
        np.testing.assert_allclose(img_local, ref, atol=1e-6)
        with open(out_path, "w") as f:
            f.write("OK")
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
