"""Catmull-Rom cubic resampling as static-shape gathers.

The reference's ``CubicResampler`` (GraphAudio.Core/CubicResampler.cs:19) is a
stateful per-sample loop: a 4-sample history window slides over the input at a
fractional rate, producing each output from a Catmull-Rom polynomial of the
window (:52-57). Sequential input consumption leaves a wide device idle, so
here the window position is computed in closed form — after the 4-sample warmup the
j-th output interpolates at continuous input position

    x_j = x_0 + j * rate        (x_0 = start_position + 1 after priming)

and the output is a 4-tap gather at floor(x_j) + {-1, 0, 1, 2} with the same
polynomial. Positions are float64 (the reference keeps ``Pos`` as a double);
the polynomial is evaluated in float32 like the reference.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def cr_weights(t):
    """Catmull-Rom tap weights (w0..w3) for fraction t (f32).

    Expansion of the reference polynomial (CubicResampler.cs:52-57) in terms
    of the four taps, used to build banded interpolation matrices for the
    matmul formulation of resampling.
    """
    t = t.astype(jnp.float32)
    w0 = t * (-0.5 + t * (1.0 - 0.5 * t))
    w1 = 1.0 + t * t * (-2.5 + 1.5 * t)
    w2 = t * (0.5 + t * (2.0 - 1.5 * t))
    w3 = t * t * (-0.5 + 0.5 * t)
    return w0, w1, w2, w3


def catmull_rom(s0, s1, s2, s3, t):
    """The reference's cubic kernel (CubicResampler.cs:52-57), float32.

    out = S1 + t*(0.5(S2-S0) + t*((S0 - 2.5 S1 + 2 S2 - 0.5 S3)
                                   + t*(0.5(S3-S0) + 1.5(S1-S2))))
    """
    t = t.astype(jnp.float32)
    return s1 + t * (
        0.5 * (s2 - s0)
        + t * ((s0 - 2.5 * s1 + 2.0 * s2 - 0.5 * s3) + t * (0.5 * (s3 - s0) + 1.5 * (s1 - s2)))
    )


_poly_cache = {}


def poly_matrix(p: int, q: int) -> np.ndarray:
    """Static polyphase Catmull-Rom matrix for a constant rational rate p/q.

    For outputs at positions x_j = x_0 + j*(p/q) with x_0 on the 1/q grid,
    the fractional part of x_j cycles with period q and the integer part
    advances by a fixed pattern: output j' of the canonical (phase-0) stream
    interpolates at (j'*p)/q. Grouping j' = n*q + r, the whole resample is

        out[c, n*q + r] = sum_m chunk[c, n, m] * H[m, r]

    where chunk[c, n, m] = window[c, n*p + m] (overlapping length-(p+4)
    slabs at stride p) and H[m, r] places the 4 Catmull-Rom tap weights of
    phase r at rows base_r + k (base_r = (r*p)//q, taps at floor(x)-1..+2).
    H is built ONCE at compile time — the per-step one-hot matrix
    construction this replaces was 85%% of the flagship graph's step time.

    Returns f32[p+4, q].
    """
    key = (p, q)
    H = _poly_cache.get(key)
    if H is None:
        r = np.arange(q, dtype=np.int64)
        t = ((r * p) % q).astype(np.float64) / q
        base = (r * p) // q
        # Catmull-Rom tap weights (same expansion as cr_weights, in numpy).
        w0 = t * (-0.5 + t * (1.0 - 0.5 * t))
        w1 = 1.0 + t * t * (-2.5 + 1.5 * t)
        w2 = t * (0.5 + t * (2.0 - 1.5 * t))
        w3 = t * t * (-0.5 + 0.5 * t)
        H = np.zeros((p + 4, q), np.float32)
        for k, wk in enumerate((w0, w1, w2, w3)):
            H[base + k, r] = wk.astype(np.float32)
        _poly_cache[key] = H
    return H


def canonical_bases(p: int, q: int, n: int) -> np.ndarray:
    """floor(j'*p/q) for j' in [0, n): the canonical stream's integer-sample
    advance pattern (static; used for validity masks). Returns i32[n]."""
    return (np.arange(n, dtype=np.int64) * p // q).astype(np.int32)


SUB_CHUNK = 16


def split_positions(xb, rate_b, frames_per_block: int):
    """Expand per-block f64 positions into per-sample (i32 base, f32 frac).

    xb: f64[S] block-start positions; rate_b: f64[S] per-block rates.
    f64 anchors are computed every SUB_CHUNK samples, so the f32 intra-chunk
    offset never exceeds ~SUB_CHUNK*rate and keeps ~1e-6-sample accuracy
    while per-sample math stays in 32-bit dtypes.

    Returns (base i32[S, frames_per_block], frac f32[S, frames_per_block]).
    """
    S = xb.shape[0]
    n_sub = frames_per_block // SUB_CHUNK
    sub = jnp.arange(n_sub, dtype=jnp.float64)[None, :] * (
        SUB_CHUNK * rate_b[:, None]
    )
    anchors = xb[:, None] + sub  # [S, n_sub] f64
    a_int = jnp.floor(anchors)
    a_frac = (anchors - a_int).astype(jnp.float32)
    j = jnp.arange(SUB_CHUNK, dtype=jnp.float32)
    local = (
        a_frac[:, :, None]
        + j[None, None, :] * rate_b.astype(jnp.float32)[:, None, None]
    )  # [S, n_sub, SUB_CHUNK]
    base_local = jnp.floor(local)
    frac = (local - base_local).reshape(S, frames_per_block)
    base = (
        a_int.astype(jnp.int32)[:, :, None] + base_local.astype(jnp.int32)
    ).reshape(S, frames_per_block)
    return base, frac


def gather_resample(data, base, frac, loop_active, loop_start, loop_end,
                    loop_len, arena_offset=0, length=None):
    """Resample ``data`` at positions base + frac with loop wrapping.

    Positions are split into an int32 integer part and a float32 fraction:
    per-sample arithmetic stays in 32-bit dtypes (float64 math costs far
    more); callers keep float64 only for per-*block* position bookkeeping.

    Args:
      data: f32[C, A] source samples — possibly a packed arena holding many
        voices' buffers back to back.
      base: i32[...] integer positions *local to this voice's region* (already
        wrapped into the loop region; taps crossing the loop boundaries are
        re-wrapped here, mirroring the reference's wrap buffer at the seam,
        AudioBufferSourceNode.cs:297-313).
      frac: f32[...] fractional parts in [0, 1).
      loop_active: bool[] or scalar — whether loop wrapping applies.
      loop_start, loop_end, loop_len: i32 loop region in frames (local).
      arena_offset: i32 start of this voice's region within ``data``.
      length: i32 region length (defaults to the full array).

    Returns f32[C, ...] interpolated samples.
    """
    if length is None:
        length = jnp.int32(data.shape[1])
    safe_len = jnp.maximum(loop_len, 1)

    taps = []
    for k in (-1, 0, 1, 2):
        tk = base + k
        # Modular wrap in both directions keeps the 4-tap window continuous
        # across the loop seam (the reference's history carries end-of-loop
        # samples into the restart, AudioBufferSourceNode.cs:297-313).
        tk = jnp.where(
            loop_active,
            loop_start + jnp.mod(tk - loop_start, safe_len),
            tk,
        )
        tk = jnp.clip(tk, 0, length - 1) + arena_offset
        taps.append(tk)

    flat = [
        jnp.take(data, tk.reshape(-1), axis=1).reshape((data.shape[0],) + base.shape)
        for tk in taps
    ]
    return catmull_rom(flat[0], flat[1], flat[2], flat[3], frac)
