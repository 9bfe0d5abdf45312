"""Every float32 matmul in a config's render program runs at HIGHEST.

On a GPU, a float32 ``dot_general`` without an explicit precision may run
on the tensor cores in TF32 (10-bit mantissa), which breaks the 1e-5 oracle
budget. These tests trace each benchmark config's compiled render function
(the scan over the step, with every nested ``pjit``, ``scan``, ``cond`` and
``shard_map`` body) and fail on any float32 ``dot_general`` whose precision
is not ``Precision.HIGHEST`` for both operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from benchmarks.configs import CONFIGS

HIGHEST = jax.lax.Precision.HIGHEST


def _subjaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _subjaxprs(v)


def f32_dots(jaxpr):
    """Yield the precision of every float32 dot_general in ``jaxpr`` and
    all of its nested jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general" and any(
            v.aval.dtype == jnp.float32 for v in eqn.invars
        ):
            yield eqn.params["precision"]
        for value in eqn.params.values():
            for sub in _subjaxprs(value):
                yield from f32_dots(sub)


def _below_highest(precisions):
    return [p for p in precisions if p != (HIGHEST, HIGHEST)]


def test_walker_flags_default_precision_inside_scan():
    """The walk reaches a dot nested in jit -> scan and tells HIGHEST from
    the default."""

    def body(c, x):
        return c, jnp.dot(x, x) + jnp.dot(x, x, precision=HIGHEST)

    fn = jax.jit(lambda xs: jax.lax.scan(body, 0.0, xs)[1])
    jaxpr = jax.make_jaxpr(fn)(np.ones((3, 4, 4), np.float32)).jaxpr
    precisions = list(f32_dots(jaxpr))
    assert len(precisions) == 2
    assert _below_highest(precisions) == [None]


@pytest.mark.parametrize("n", sorted(CONFIGS))
def test_config_render_program_is_highest_precision(n):
    _, builder = CONFIGS[n]
    ctx = builder(superblock=2)
    ctx._drain_commands()
    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    rows = 1 + getattr(ctx._compiled, "pipe_delay", 0)
    frames_per_step = ctx.superblock * 128
    frame0s = np.arange(rows, dtype=np.int64) * frames_per_step
    block_times = (
        np.arange(rows * ctx.superblock, dtype=np.float64) * 128 / ctx.sample_rate
    ).reshape(rows, ctx.superblock)
    jaxpr = jax.make_jaxpr(ctx._render_fn)(
        ctx._states, ctx._encs, ctx._consts, {}, frame0s, block_times
    ).jaxpr
    precisions = list(f32_dots(jaxpr))
    assert _below_highest(precisions) == [], (
        f"config {n}: {len(_below_highest(precisions))} of {len(precisions)} "
        "float32 dot_general(s) below Precision.HIGHEST"
    )
