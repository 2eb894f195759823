"""Is the backward's scatter-add into tiny parameter tables the wall?

The wavefront backward's only scatters are the VJPs of `table[idx]` gathers
in ops/trace.surface_at — N≈0.5–2M lane cotangents scatter-added into tables
of 3–16 rows (sphere centers, material albedos: exactly the bench's grad
params). A scatter with many duplicate indices contends (atomics on the
GPU); the alternative is a one-hot masked-sum VJP (a dense reduce). This
probe measures, readback-synced:

  A. fwd+bwd of loss(table) = sum((table[idx] - x)^2)  — native gather VJP
     (scatter-add)
  B. same loss with the one-hot custom-VJP gather (ops/dgather.pgather)
  C. the raw scatter-add zeros[K,C].at[idx].add(ct) forward, for scale

Run:  python -m benchmarks.scatter_probe          # on the GPU
      JAX_PLATFORMS=cpu python -m benchmarks.scatter_probe
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

from benchmarks.gather_probe import _synced  # noqa: E402


def main():
    print(f"# backend: {jax.default_backend()}", file=sys.stderr, flush=True)
    from raytracer.ops.dgather import pgather

    rng = np.random.default_rng(0)
    for n in (262_144, 2_073_600):
        for k in (4, 16):
            idx = jnp.asarray(rng.integers(0, k, n, dtype=np.int32))
            x = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
            table0 = jnp.asarray(
                rng.standard_normal((k, 3)).astype(np.float32))

            def loss_native(t, idx=idx, x=x):
                return jnp.sum((t[idx] - x) ** 2)

            def loss_onehot(t, idx=idx, x=x):
                return jnp.sum((pgather(t, idx) - x) ** 2)

            for tag, loss in (("native_scatter", loss_native),
                              ("onehot_vjp", loss_onehot)):
                g = jax.jit(jax.grad(loss))

                def call(eps, g=g, table0=table0):
                    return g(table0 + eps)

                per = _synced(call)
                print(json.dumps({"probe": "grad_gather", "tag": tag,
                                  "n": n, "k": k,
                                  "ms": round(per * 1e3, 3)}), flush=True)

            # C: raw scatter-add for scale
            @jax.jit
            def raw(eps, idx=idx, x=x, k=k):
                return jnp.zeros((k, 3), jnp.float32).at[idx].add(x + eps)

            per = _synced(raw)
            print(json.dumps({"probe": "raw_scatter_add", "n": n, "k": k,
                              "ms": round(per * 1e3, 3)}), flush=True)

        # D: wide scatter (k == n, ≤2 collisions per slot) — the compacted
        # wavefront's per-pixel fold (renderer._fold pix mode)
        idx = jnp.asarray(rng.integers(0, n, n, dtype=np.int32))
        x = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))

        @jax.jit
        def wide(eps, idx=idx, x=x, n=n):
            return jnp.zeros((n, 3), jnp.float32).at[idx].add(x + eps)

        per = _synced(wide)
        print(json.dumps({"probe": "raw_scatter_add", "n": n, "k": n,
                          "ms": round(per * 1e3, 3)}), flush=True)


if __name__ == "__main__":
    main()
