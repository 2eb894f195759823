"""Measure the device's random-gather + loop-iteration cost model.

The grid-DDA walk's per-iteration work is one [N]-row random gather from an
device-memory table plus elementwise math inside a while_loop. This probe
measures, with readback-synced timing:

  A. random row gather cost vs ROW BYTES (1 B occupancy byte … 480 B
     pregathered cell row) at fixed N — is the gather engine latency-bound
     (cost ~ rows) or bandwidth-bound (cost ~ bytes)?
  B. gather cost vs N (descriptor amortization)
  C. while_loop vs fori_loop per-iteration overhead with a trivial body
     (the scalar-core sync cost of a data-dependent cond)
  D. gather cost when all indices are IDENTICAL (parked lanes gather row 0)
     vs uniform-random — does the engine coalesce repeated rows?

Run:  python -m benchmarks.gather_probe            # on the GPU
      JAX_PLATFORMS=cpu python -m benchmarks.gather_probe
"""

import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


def _synced(call, n1=2, n2=8):
    """Readback-synced two-length chain timing (rays_per_sec discipline)."""
    zero = jnp.zeros((), jnp.float32)
    out = call(zero)
    jax.block_until_ready(out)
    float(out.ravel()[0])

    def chain(n):
        eps = zero
        t0 = time.perf_counter()
        o = out
        for _ in range(n):
            o = call(eps)
            eps = o.ravel()[0] * 0.0
        float(o.ravel()[0])
        return time.perf_counter() - t0

    chain(2)
    t1 = min(chain(n1) for _ in range(2))
    t2 = min(chain(n2) for _ in range(2))
    return max((t2 - t1) / (n2 - n1), 1e-9)


WIDTHS = ((1, jnp.uint8, "occ_1B"),
          (12, jnp.float32, "row_48B"),
          (40, jnp.float32, "row_160B"),
          (120, jnp.float32, "row_480B"))
# the measured curve is FLAT in row bytes to 480B (~8.5-10.6 ns/row,
# latency-bound); these probe where bandwidth finally bites (~7KB at
# 8.5ns x 800GB/s) — that bound sets how fat grid cells can get
WIDE_WIDTHS = ((240, jnp.float32, "row_960B"),
               (480, jnp.float32, "row_1920B"),
               (960, jnp.float32, "row_3840B"),
               (1920, jnp.float32, "row_7680B"))


def probe_gather(n_rows=65536, n_iters=32, table_rows=80000, widths=WIDTHS,
                 same_idx=True):
    """A/B/D: chained gathers (each iteration's indices depend on the prior
    gather so XLA cannot batch iterations) across row widths."""
    print(f"# gather probe: N={n_rows} iters={n_iters} table={table_rows}",
          file=sys.stderr, flush=True)
    rng = np.random.default_rng(0)
    idx0 = jnp.asarray(rng.integers(0, table_rows, n_rows, dtype=np.int32))
    for width, dtype, tag in widths:
        table = jnp.asarray(
            rng.standard_normal((table_rows, width)).astype(np.float32)
            if dtype == jnp.float32 else
            rng.integers(0, 255, (table_rows, width), dtype=np.uint8))

        @jax.jit
        def walk(eps, idx0=idx0, table=table, w=width):
            def body(i, carry):
                idx, acc = carry
                rows = table[idx]                     # [N, w] random gather
                s = rows.astype(jnp.float32).sum(axis=1)
                idx = (idx + s.astype(jnp.int32) % 7 + 1) % table_rows
                return idx, acc + s
            idx = (idx0 + eps.astype(jnp.int32)) % table_rows
            _, acc = jax.lax.fori_loop(
                0, n_iters, body, (idx, jnp.zeros(n_rows, jnp.float32)))
            return acc

        per = _synced(walk) / n_iters
        ns_row = per / n_rows * 1e9
        gbps = n_rows * width * (1 if dtype == jnp.uint8 else 4) / per / 1e9
        print(json.dumps({"probe": "gather", "tag": tag, "n": n_rows,
                          "ns_per_row": round(ns_row, 2),
                          "eff_gbps": round(gbps, 2)}), flush=True)

    if not same_idx:
        return
    # D: all-identical indices (parked lanes) at 480B
    table = jnp.asarray(rng.standard_normal((table_rows, 120)).astype(np.float32))

    @jax.jit
    def walk_same(eps):
        def body(i, carry):
            idx, acc = carry
            rows = table[idx]
            s = rows.sum(axis=1)
            idx = (idx * 0 + s.astype(jnp.int32) * 0)  # stays 0, data-dep
            return idx, acc + s
        idx = jnp.zeros(n_rows, jnp.int32) + eps.astype(jnp.int32)
        _, acc = jax.lax.fori_loop(
            0, n_iters, body, (idx, jnp.zeros(n_rows, jnp.float32)))
        return acc

    per = _synced(walk_same) / n_iters
    print(json.dumps({"probe": "gather", "tag": "row_480B_sameidx",
                      "n": n_rows, "ns_per_row": round(per / n_rows * 1e9, 2)}),
          flush=True)


def probe_loop_overhead(n_rows=65536, n_iters=64):
    """C: while vs fori with a near-empty body → per-iteration fixed cost."""
    for kind in ("fori", "while"):
        @jax.jit
        def f(eps, kind=kind):
            x = jnp.full((n_rows,), eps)

            def body(carry):
                i, x = carry
                return i + 1, x * 1.000001 + 1e-9

            if kind == "fori":
                x = jax.lax.fori_loop(
                    0, n_iters, lambda i, c: body((jnp.int32(0), c))[1], x)
            else:
                _, x = jax.lax.while_loop(
                    lambda c: c[0] < n_iters, body, (jnp.int32(0), x))
            return x

        per = _synced(f) / n_iters
        print(json.dumps({"probe": "loop", "kind": kind,
                          "us_per_iter": round(per * 1e6, 2)}), flush=True)


def main():
    print(f"# backend: {jax.default_backend()}", file=sys.stderr, flush=True)
    if os.environ.get("RT_PROBE_WIDE") == "1":
        # wide-row mode only: where does the flat latency curve end?
        probe_gather(n_rows=65536, table_rows=20000, widths=WIDE_WIDTHS,
                     same_idx=False)
        return
    probe_loop_overhead()
    for n in (16384, 65536, 262144):
        probe_gather(n_rows=n)


if __name__ == "__main__":
    main()
