"""Microprofile the spatial-panner stage pieces on the current backend.

Usage: python -m benchmarks.profile_spatial [V] [S]
Times each sub-kernel of SpatialPannerNode.process (vmapped over V voices)
in isolation to locate the hot spot. Not part of the benchmark suite.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from graphaudio_tpu.nodes.spatial import XOVER_HIGH_HZ, XOVER_LOW_HZ, _hrir_grid
from graphaudio_tpu.ops.hrtf import HRIR_LENGTH, fir_per_block, interp_hrir
from graphaudio_tpu.ops.onepole import onepole_lowpass
from graphaudio_tpu.ops.param_eval import encode_events, eval_intrinsic


def _sync(out):
    jax.block_until_ready(out)


def timeit(name, fn, *args, reps=20):
    out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    dt = (time.perf_counter() - t0) / reps
    print(f"{name:28s} {dt*1e3:9.3f} ms  (incl. one dispatch)")
    return dt


def main(V=128, S=32):
    sr = 48000
    T = S * 128
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((V, 2, T)).astype(np.float32))
    grid = jnp.asarray(_hrir_grid(sr))
    import math

    a_low = math.exp(-2 * math.pi * XOVER_LOW_HZ / sr)
    a_high = math.exp(-2 * math.pi * XOVER_HIGH_HZ / sr)

    @jax.jit
    def bands(x):
        lo, _ = jax.vmap(lambda s: onepole_lowpass(s, a_low, jnp.zeros(2)))(x)
        lm, _ = jax.vmap(lambda s: onepole_lowpass(s, a_high, jnp.zeros(2)))(x)
        return lo + lm

    az = jnp.asarray(rng.uniform(0, 6.28, (V, S)).astype(np.float32))
    el = jnp.asarray(rng.uniform(-1.5, 1.5, (V, S)).astype(np.float32))

    @jax.jit
    def interp(az, el):
        return jax.vmap(lambda a, e: interp_hrir(grid, a, e))(az, el)

    mono = jnp.asarray(rng.standard_normal((V, S, 128)).astype(np.float32))
    hist = jnp.zeros((V, HRIR_LENGTH - 1), jnp.float32)

    @jax.jit
    def fir(mono, h, hist):
        return jax.vmap(fir_per_block)(mono, h, hist)

    # 17 k-rate params per voice, 1 event each (typical moving source).
    # Each of the 17 evaluations must use DISTINCT encodings: identical
    # copies over the same operands are common subexpressions that XLA CSE
    # collapses to ONE evaluation (verified in the optimized HLO), which
    # understates this stage ~17x — the classic folded-probe trap.
    enc17 = [encode_events(1.0 + 0.01 * k, [], 2) for k in range(17)]
    encs = [
        {k: jnp.asarray(np.broadcast_to(v, (V,) + np.shape(v)).copy())
         for k, v in e.items()}
        for e in enc17
    ]
    times = jnp.arange(S, dtype=jnp.float64) * (128.0 / sr)

    @jax.jit
    def params(encs):
        return [
            jax.vmap(eval_intrinsic, in_axes=(0, None))(e, times)
            for e in encs
        ]

    print(f"V={V} S={S} T={T} backend={jax.devices()[0].platform}")
    timeit("3-band split (2x onepole)", bands, x)
    h = interp(az, el)
    jax.block_until_ready(h)
    timeit("interp_hrir", interp, az, el)
    timeit("fir_per_block", fir, mono, h, hist)
    timeit("param eval x17", params, encs)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
