"""Static-coefficient one-pole lowpass as blocked matmuls.

A first-order recurrence y[n] = a*y[n-1] + (1-a)*x[n] with a COMPILE-TIME
constant coefficient has the closed form

    y[n] = a^(n+1) * y_in + sum_{k<=n} a^(n-k) * (1-a) * x[k]

so one 128-frame block is a single matmul against a static lower-triangular
decay matrix, and the block-to-block carry is another tiny static matmul over
the superblock axis. This replaces the per-sample associative scan used for
time-varying filters (ops/biquad._first_order_scan) on paths whose
coefficients are fixed (the spatializer's 3-band crossovers): scans cost
log-depth program blowup at compile time and sequential work at run time,
while this form is pure matmul work.

Parity note: numerically identical (to f32 rounding) to running the
reference's sequential one-pole (the DirectEffect band split the reference
delegates to phonon's C++).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK

_matrix_cache = {}


def _matrices(a: float, S: int):
    """Static (per-block decay matmul, carry weights) for coefficient ``a``.

    Returns:
      M:    f32[128, 128]  M[n, k] = a^(n-k)*(1-a) for k <= n
      apow: f32[128]       a^(n+1)
      pows: f32[S]         (a^128)^b  — carry-in propagation per block
      W:    f32[S, S]      W[b, j] = (a^128)^(b-1-j) for j < b  — how block j's
                           tail feeds block b's carry
    """
    key = (float(a), int(S))
    got = _matrix_cache.get(key)
    if got is not None:
        return got
    n = np.arange(FRAMES_PER_BLOCK)
    d = n[:, None] - n[None, :]
    # exp-space avoids underflow-to-denormal surprises for strong decay
    M = np.where(d >= 0, np.exp(d * np.log(a)) * (1.0 - a), 0.0).astype(np.float32)
    apow = (a ** (n + 1.0)).astype(np.float32)
    a128 = float(a) ** FRAMES_PER_BLOCK
    b = np.arange(S)
    pows = (a128 ** b).astype(np.float32)
    e = b[:, None] - 1 - b[None, :]
    W = np.where(e >= 0, a128 ** np.maximum(e, 0), 0.0).astype(np.float32)
    got = (M, apow, pows, W)
    _matrix_cache[key] = got
    return got


def onepole_lowpass(x, a: float, y0):
    """Run the one-pole lowpass over ``x`` with static coefficient ``a``.

    Args:
      x:  f32[..., T] input, T a multiple of 128.
      a:  python float pole, 0 < a < 1 (exp(-2*pi*fc/sr)).
      y0: f32[...] carry-in (y at sample -1).

    Returns (y f32[..., T], carry_out f32[...]).
    """
    T = x.shape[-1]
    S = T // FRAMES_PER_BLOCK
    lead = x.shape[:-1]
    xb = x.reshape(lead + (S, FRAMES_PER_BLOCK))
    M, apow, pows, W = _matrices(a, S)
    hp = jax.lax.Precision.HIGHEST
    part = jnp.einsum("nk,...sk->...sn", jnp.asarray(M), xb, precision=hp)
    last = part[..., -1]  # [..., S] block tails ignoring carry
    carry = pows * y0[..., None] + jnp.einsum(
        "bj,...j->...b", jnp.asarray(W), last, precision=hp
    )  # [..., S] carry-in per block
    y = part + jnp.asarray(apow) * carry[..., None]
    return y.reshape(lead + (T,)), y[..., -1, -1]
