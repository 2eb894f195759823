"""pgather (scatter-free small-table gather VJP) — ops/dgather.py.

Forward must be bitwise `table[idx]`; backward must match the native gather
VJP (a scatter-add) up to summation association over lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.ops.dgather import SMALL_TABLE_ROWS, pgather


@pytest.mark.parametrize("k,cols", [(3, 3), (16, 3), (5, None)])
def test_forward_bitwise(k, cols):
    rng = np.random.default_rng(0)
    shape = (k, cols) if cols else (k,)
    table = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, k, 4096, dtype=np.int32))
    np.testing.assert_array_equal(np.asarray(pgather(table, idx)),
                                  np.asarray(table[idx]))


@pytest.mark.parametrize("k,cols", [(3, 3), (16, 3), (5, None)])
def test_grad_matches_native(k, cols):
    rng = np.random.default_rng(1)
    shape = (k, cols) if cols else (k,)
    table = jnp.asarray(rng.standard_normal(shape).astype(np.float32))
    idx = jnp.asarray(rng.integers(0, k, 4096, dtype=np.int32))
    x = jnp.asarray(rng.standard_normal(
        (4096,) + shape[1:]).astype(np.float32))

    g_new = jax.grad(lambda t: jnp.sum((pgather(t, idx) - x) ** 2))(table)
    g_ref = jax.grad(lambda t: jnp.sum((t[idx] - x) ** 2))(table)
    np.testing.assert_allclose(np.asarray(g_new), np.asarray(g_ref),
                               rtol=2e-5, atol=1e-4)


def test_big_table_and_int_fall_back_to_native_gather():
    table = jnp.zeros((SMALL_TABLE_ROWS + 1, 3), jnp.float32)
    idx = jnp.zeros((8,), jnp.int32)
    # big table: still differentiable (native path), same values
    g = jax.grad(lambda t: pgather(t, idx).sum())(table)
    assert float(g[0, 0]) == 8.0
    itab = jnp.arange(10, dtype=jnp.int32)
    np.testing.assert_array_equal(np.asarray(pgather(itab, idx)),
                                  np.zeros(8, np.int32))


def test_jit_and_vmap_compose():
    table = jnp.asarray(np.arange(12, dtype=np.float32).reshape(4, 3))
    idx = jnp.asarray([0, 3, 1], jnp.int32)

    @jax.jit
    def f(t):
        return pgather(t, idx).sum()

    v, g = jax.value_and_grad(f)(table)
    assert float(v) == float(table[idx].sum())
    np.testing.assert_array_equal(
        np.asarray(g), np.asarray(jax.grad(lambda t: t[idx].sum())(table)))


def _partition(alive, cap):
    """The renderer._compact index construction (prefix-sum stable partition)."""
    n = alive.shape[0]
    ai = alive.astype(jnp.int32)
    n_alive = jnp.sum(ai)
    pos = jnp.where(alive, jnp.cumsum(ai) - 1,
                    n_alive + jnp.cumsum(1 - ai) - 1)
    order = jnp.zeros((n,), jnp.int32).at[pos].set(
        jnp.arange(n, dtype=jnp.int32), unique_indices=True)[:cap]
    return order, pos


@pytest.mark.parametrize("n,cap", [(64, 64), (64, 24), (257, 40)])
def test_permute_take_forward_bitwise(n, cap):
    from raytracer.ops.dgather import permute_take

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    alive = jnp.asarray(rng.random(n) < 0.3)
    order, pos = _partition(alive, cap)
    np.testing.assert_array_equal(np.asarray(permute_take(x, order, pos)),
                                  np.asarray(x[order]))


@pytest.mark.parametrize("n,cap", [(64, 64), (64, 24), (257, 40)])
def test_permute_take_grad_matches_native(n, cap):
    """VJP (inverse-map gather) == the native gather's scatter-add VJP,
    including zero cotangent for lanes the cap dropped."""
    from raytracer.ops.dgather import permute_take

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((n, 3)).astype(np.float32))
    alive = jnp.asarray(rng.random(n) < 0.5)  # may overflow cap -> drops
    order, pos = _partition(alive, cap)
    w = jnp.asarray(rng.standard_normal((cap, 3)).astype(np.float32))

    g_new = jax.grad(lambda v: jnp.sum(w * permute_take(v, order, pos)))(x)
    g_ref = jax.grad(lambda v: jnp.sum(w * v[order]))(x)
    np.testing.assert_array_equal(np.asarray(g_new), np.asarray(g_ref))


def test_permute_take_1d_and_jit():
    from raytracer.ops.dgather import permute_take

    x = jnp.asarray(np.arange(9, dtype=np.float32))
    alive = jnp.asarray([0, 1, 1, 0, 0, 1, 0, 0, 1], bool)
    order, pos = _partition(alive, 4)

    @jax.jit
    def f(v):
        return (permute_take(v, order, pos) ** 2).sum()

    v, g = jax.value_and_grad(f)(x)
    assert float(v) == float((x[order] ** 2).sum())
    np.testing.assert_array_equal(
        np.asarray(g), np.asarray(jax.grad(lambda v: (v[order] ** 2).sum())(x)))


def test_select_chain_matches_gather():
    """Tiny-table select chains: values exactly equal
    to table[idx] for every dtype/rank combination used in surface_at, with
    the pgather one-hot backward unchanged."""
    import numpy as np

    from raytracer.ops.dgather import (_select_chain, pgather, tselect,
                                           SELECT_ROWS)

    assert SELECT_ROWS == 8  # shipping default
    rng = np.random.default_rng(3)
    idx = jnp.asarray(rng.integers(0, 5, size=(1000,)))
    for table in (rng.normal(size=(5, 3)).astype(np.float32),
                  rng.normal(size=(5,)).astype(np.float32),
                  rng.integers(0, 9, size=(5,)).astype(np.int32),
                  (rng.random(5) < 0.5)):
        t = jnp.asarray(table)
        np.testing.assert_array_equal(np.asarray(_select_chain(t, idx)),
                                      np.asarray(t[idx]))
        np.testing.assert_array_equal(np.asarray(tselect(t, idx)),
                                      np.asarray(t[idx]))
    # float path still takes the scatter-free one-hot backward
    t = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    g1 = jax.grad(lambda tb: pgather(tb, idx).sum())(t)
    g2 = jax.grad(lambda tb: tb[idx].sum())(t)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-6)
    # big tables pass through to the native gather
    big = jnp.asarray(rng.normal(size=(100, 3)).astype(np.float32))
    np.testing.assert_array_equal(np.asarray(tselect(big, idx)),
                                  np.asarray(big[idx]))
