"""Micro-probe 10: exact cheap-precision HRIR spectra interp.

interp_hrir contracts fractional bilinear weights against the grid in ONE
Precision.HIGHEST matmul. But a {0,1} SELECTION matmul is exact at ANY
precision (one factor is 1.0), so the same interpolation can run as 4
corner selections at DEFAULT precision with the fractional weights applied
as exact f32 elementwise multiplies afterwards:

    out = sum_corner w_corner * (OH_corner @ grid)

Bit-compatibility caveat: the final sum-of-4 is associated differently
than the fused form, so outputs differ by f32 rounding only.

Times both at config-5 shapes (V=128, S=64) inside the full HRTF step
(interp + packed-basis FIR). Writes benchmarks/results/micro_probe10.json.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from graphaudio_tpu.ops.hrtf import (
    build_hrir_grid,
    hrir_grid_spectra,
    interp_hrir,
    fir_freq_per_block,
    hrtf_fft_size,
    HRIR_LENGTH,
)
from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK

V = 128
S = 64
N_STEPS = 256
FFT = hrtf_fft_size(HRIR_LENGTH)
BINS = FFT // 2 + 1
TAIL = FFT - FRAMES_PER_BLOCK


def interp_hrir_select(grid, azimuth, elevation):
    """Same bilinear interpolation as interp_hrir, via 4 exact DEFAULT-
    precision selection matmuls + f32 elementwise weighting."""
    E, A, _, L = grid.shape
    az = jnp.mod(azimuth, 2 * jnp.pi) / (2 * jnp.pi) * A
    el = (elevation + jnp.pi / 2) / jnp.pi * (E - 1)
    a0 = jnp.floor(az).astype(jnp.int32) % A
    a1 = (a0 + 1) % A
    fa = (az - jnp.floor(az)).astype(jnp.float32)
    e0 = jnp.clip(jnp.floor(el).astype(jnp.int32), 0, E - 1)
    e1 = jnp.clip(e0 + 1, 0, E - 1)
    fe = (el - jnp.floor(el)).astype(jnp.float32)
    iota = jnp.arange(E * A, dtype=jnp.int32)
    g = grid.reshape(E * A, 2 * L)

    def sel(e, a, w):  # one-hot {0,1} matmul is exact at DEFAULT precision
        oh = (iota[None, :] == (e * A + a)[:, None]).astype(jnp.float32)
        return jnp.matmul(oh, g) * w[:, None]

    out = (
        sel(e0, a0, (1 - fa) * (1 - fe))
        + sel(e0, a1, fa * (1 - fe))
        + sel(e1, a0, (1 - fa) * fe)
        + sel(e1, a1, fa * fe)
    )
    return out.reshape(-1, 2, L)


def main():
    t0 = time.perf_counter()
    rng = np.random.default_rng(9)
    grid = build_hrir_grid(48000)
    sr, si = hrir_grid_spectra(grid)
    g_r = jnp.asarray(sr)
    g_i = jnp.asarray(si)

    az = jnp.asarray(
        rng.uniform(0, 2 * np.pi, (N_STEPS, V, S)).astype(np.float32)
    )
    el = jnp.asarray(
        rng.uniform(-np.pi / 2, np.pi / 2, (N_STEPS, V, S)).astype(np.float32)
    )
    xs = jnp.sin(
        jnp.arange(N_STEPS * V * S * 128, dtype=jnp.float32).reshape(
            N_STEPS, V, S, 128
        )
        * 0.618
    )
    ov0 = jnp.zeros((V, 2, TAIL), jnp.float32)

    def make_step(interp):
        def step(ov, x, a, e):
            def voice(xv, av, ev, ovv):
                hr = interp(g_r, av, ev)
                hi = interp(g_i, av, ev)
                return fir_freq_per_block(xv.reshape(S, 128), hr, hi, ovv)

            y, nov = jax.vmap(voice)(x, a, e, ov)
            return nov, y

        return step

    def scan_over(step):
        def run(ov, xs, az, el):
            def body(c, inp):
                c, y = step(c, *inp)
                return c, jnp.sum(y)

            c, ys = jax.lax.scan(body, ov, (xs, az, el))
            return jnp.sum(ys)

        return jax.jit(run)

    report = {}
    for name, interp in (
        ("weighted_highest", interp_hrir),
        ("select_default", interp_hrir_select),
    ):
        fn = scan_over(make_step(interp))
        args = (ov0, xs, az, el)
        np.asarray(fn(*args))
        best = np.inf
        for _ in range(3):
            t1 = time.perf_counter()
            np.asarray(fn(*args))
            best = min(best, (time.perf_counter() - t1) / N_STEPS)
        report[name] = {"ms_per_step": round(best * 1e3, 4)}
        print(json.dumps({name: report[name]}), flush=True)

    # exactness: selection variant vs the weighted matmul, one step
    s0 = jax.jit(make_step(interp_hrir))
    s1 = jax.jit(make_step(interp_hrir_select))
    x1 = jnp.asarray(rng.standard_normal((V, S, 128)).astype(np.float32))
    _, y0 = s0(ov0, x1, az[0], el[0])
    _, y1 = s1(ov0, x1, az[0], el[0])
    report["max_abs_diff_select_vs_weighted"] = float(
        f"{float(jnp.max(jnp.abs(y1 - y0))):.3e}"
    )
    report["shapes"] = {"V": V, "S": S, "fft": FFT, "n_steps": N_STEPS}
    report["warmup_and_total_seconds"] = round(time.perf_counter() - t0, 1)
    from benchmarks.artifacts import write_artifact

    write_artifact("micro_probe10", report)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
