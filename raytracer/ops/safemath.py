"""NaN-safe primitives for differentiable rendering.

`jnp.where(valid, f(x), fallback)` still backpropagates NaN from the dead branch
when `f` is non-differentiable there (sqrt(0), 1/0, pow(0, n), normalize(0)).
Every op here uses the double-where trick: clamp the argument on the dead branch
*before* the primal op so both the value and the gradient are finite.

These run identically under jit on the GPU and the CPU; the oracles (tests/oracle,
native/oracle.cpp) use the plain unguarded forms — forward values agree because
the guards only rewrite inputs on branches whose output is discarded.
"""

import jax.numpy as jnp

_EPS = 1e-12


def safe_sqrt(x, valid=None):
    """sqrt with finite gradient; `valid` marks lanes whose value is actually used."""
    if valid is None:
        valid = x > 0
    x_safe = jnp.where(valid, x, 1.0)
    return jnp.where(valid, jnp.sqrt(jnp.maximum(x_safe, _EPS)), 0.0)


def safe_div(num, den, valid=None, fallback=0.0):
    if valid is None:
        valid = jnp.abs(den) > _EPS
    den_safe = jnp.where(valid, den, 1.0)
    return jnp.where(valid, num / den_safe, fallback)


def dot(a, b):
    """Batched 3-vector dot over the last axis, keepdims=False."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def norm(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), _EPS))


def normalize(v, valid=None):
    """Unit vector with finite grad at ‖v‖→0 (dead lanes get the unchanged v)."""
    n2 = dot(v, v)
    if valid is None:
        valid = n2 > _EPS
    n2_safe = jnp.where(valid, n2, 1.0)
    inv = jnp.where(valid, 1.0 / jnp.sqrt(n2_safe), 1.0)
    return v * inv[..., None]


def safe_pow(base, exponent):
    """pow(max(0,base), e) with finite grad at base<=0 (clamps to tiny positive)."""
    b = jnp.maximum(base, 1e-7)
    return jnp.where(base > 0, jnp.power(b, exponent), 0.0)


def clamp01(x):
    return jnp.clip(x, 0.0, 1.0)
