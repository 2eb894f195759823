"""Scatter-free gathers from small parameter tables.

The differentiable recompute (ops/trace.surface_at) gathers per-lane rows
from tiny scene tables — sphere centers [Ns,3], material albedos [M,3], plane
frames [Np,3] — and the VJP of a plain `table[idx]` gather is a scatter-add
of N≈0.5–2M lane cotangents into those few rows — heavy duplicate-index
contention (on the GPU an atomic add per lane; the reference genre has no
backward at all — this cost class is ours alone, SURVEY.md §2.1 C13).

`pgather(table, idx)` is bitwise-identical to `table[idx]` in the forward;
its backward materializes the one-hot mask [N, K] and reduces
`onehot^T @ ct` — a dense reduction with no scatter. Only worth it
for small K (the mask costs N·K); big tables (mesh vertices) keep the native
gather, whose backward scatter is amortized over far fewer duplicate
collisions per row.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

# Tables at or below this row count take the one-hot backward; above it the
# native gather/scatter wins (mask traffic grows as N·K).
SMALL_TABLE_ROWS = 64

# RT_PGATHER_SELECT=K (default 8, 0 disables): tables with ≤K rows replace
# the FORWARD gather with a where-select chain over static row slices —
# elementwise broadcast selects, no gather machinery, value-identical (1-ulp
# downstream association class only). Both the default and the one-hot
# backward were chosen on another accelerator; whether either wins on the
# GPU against XLA's gather and atomic scatter is open (ROADMAP).
SELECT_ROWS = int(os.environ.get("RT_PGATHER_SELECT", "8") or 0)


def _select_chain(table, idx):
    """table[idx] as K-1 broadcast selects (static row slices, no gather)."""
    k = table.shape[0]
    shape = idx.shape + (1,) * (table.ndim - 1)
    out = jnp.broadcast_to(table[0], idx.shape + table.shape[1:])
    for j in range(1, k):
        out = jnp.where(jnp.reshape(idx == j, shape), table[j], out)
    return out


def tselect(table, idx):
    """Gather-free `table[idx]` for tiny tables when RT_PGATHER_SELECT is
    on (any dtype, no custom VJP — use for integer/bool tables)."""
    if 0 < table.shape[0] <= SELECT_ROWS:
        return _select_chain(table, idx)
    return table[idx]


@functools.partial(jax.custom_vjp, nondiff_argnums=())
def _pgather(table, idx):
    if 0 < table.shape[0] <= SELECT_ROWS:
        return _select_chain(table, idx)
    return table[idx]


def _pgather_fwd(table, idx):
    return _pgather(table, idx), (table.shape, idx)


def _pgather_bwd(res, ct):
    shape, idx = res
    k = shape[0]
    n = idx.shape[0]
    # one-hot in the cotangent dtype; HIGHEST keeps the reduction in f32
    # (no TF32 on the GPU)
    onehot = (idx[:, None] == jnp.arange(k, dtype=idx.dtype)[None, :])
    ct2 = ct.reshape(n, -1)
    g = jnp.einsum("nk,nc->kc", onehot.astype(ct2.dtype), ct2,
                   precision=jax.lax.Precision.HIGHEST)
    g = g.reshape(shape)
    zero_idx = np.zeros(idx.shape, dtype=jax.dtypes.float0)
    return g, zero_idx


_pgather.defvjp(_pgather_fwd, _pgather_bwd)


def pgather(table, idx):
    """`table[idx]` with a scatter-free (one-hot reduce) VJP for small tables.

    idx must be 1-D int; table rank ≥ 1. Falls back to the native gather for
    tables larger than SMALL_TABLE_ROWS or when `table` is not a floating
    array (int tables carry no gradient — the native gather is fine).
    """
    if (table.shape[0] > SMALL_TABLE_ROWS
            or not jnp.issubdtype(table.dtype, jnp.floating)):
        return tselect(table, idx)
    return _pgather(table, idx)


@jax.custom_vjp
def permute_take(x, order, pos):
    """`x[order]` where `order` is an injective lane permutation-prefix.

    The wavefront compaction (renderer._compact) keeps `cap` of `n` lanes via
    `x[order]`; the native VJP of that gather is a scatter-add of the [cap]
    cotangents into [n] rows. But compaction
    already computes the INVERSE map for free: `pos[i]` is the slot lane i
    was sent to (order[pos[i]] == i whenever pos[i] < cap). Because `order`
    is injective, the transpose of the gather is itself a gather:
    `g[i] = ct[pos[i]] if pos[i] < cap else 0`. No scatter anywhere.

    Contract: order.shape = [cap], pos.shape = [n] = x.shape[0], and
    order[pos[i]] == i for every lane with pos[i] < cap (callers build both
    from the same prefix-sum). order/pos are index data (no gradient).
    """
    return x[order]


def _permute_take_fwd(x, order, pos):
    return x[order], (pos, order.shape[0])


def _permute_take_bwd(res, ct):
    pos, cap = res
    kept = pos < cap
    safe = jnp.where(kept, pos, 0)
    g = ct[safe]
    g = jnp.where(kept.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0)
    return (g, np.zeros((cap,), dtype=jax.dtypes.float0),
            np.zeros(pos.shape, dtype=jax.dtypes.float0))


permute_take.defvjp(_permute_take_fwd, _permute_take_bwd)
