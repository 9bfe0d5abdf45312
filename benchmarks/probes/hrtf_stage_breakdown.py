"""Micro-probe 9: what is the HRTF stage actually bound on?

Decomposes the spatializer's HRTF step at config-5 shapes (V=128, S=64):
per-quantum spectra interpolation (one-hot
bilinear weights -> grid matmul) vs the frequency-domain OLA FIR (DFT
matmuls + complex MAC), plus two structural variants:

  * interp_packed: ONE interp matmul serving both real and imag spectra
    (the shipping node calls interp_hrir twice, rebuilding the one-hot W
    both times);
  * fir_fused: forward DFT as one [128, 2B] matmul and inverse as one
    [2B, 192] matmul instead of two each.

Writes benchmarks/results/micro_probe9.json.
"""

from __future__ import annotations

import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from graphaudio_tpu.ops.fft import rfft_basis, irfft_basis
from graphaudio_tpu.ops.hrtf import (
    build_hrir_grid,
    hrir_grid_spectra,
    interp_hrir,
    hrtf_fft_size,
    HRIR_LENGTH,
)
from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK

V = 128
S = 64
N_STEPS = 256
FFT = hrtf_fft_size(HRIR_LENGTH)  # 192
BINS = FFT // 2 + 1
TAIL = FFT - FRAMES_PER_BLOCK
HP = jax.lax.Precision.HIGHEST


def timed(fn, args, reps=3):
    np.asarray(fn(*args))  # compile
    best = np.inf
    for _ in range(reps):
        t1 = time.perf_counter()
        np.asarray(fn(*args))
        best = min(best, (time.perf_counter() - t1) / N_STEPS)
    return round(best * 1e3, 4)


def main():
    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    grid = build_hrir_grid(48000)
    sr, si = hrir_grid_spectra(grid)  # [E,A,2,BINS]
    E, A = sr.shape[:2]
    g_r = jnp.asarray(sr)
    g_i = jnp.asarray(si)
    g_packed = jnp.asarray(
        np.concatenate([sr, si], axis=-1).reshape(E, A, 2, 2 * BINS)
    )

    cr, ci = rfft_basis(FRAMES_PER_BLOCK, FFT)
    br, bi = irfft_basis(FFT)
    cf = jnp.concatenate([cr, ci], axis=1)  # [128, 2B]
    bf = jnp.concatenate([br, bi], axis=0)  # [2B, 192]

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

    def fir_split(x, hr, hi, overlap):
        xr = jnp.matmul(x, cr, precision=HP)
        xi = jnp.matmul(x, ci, precision=HP)
        yr = xr[:, None, :] * hr - xi[:, None, :] * hi
        yi = xr[:, None, :] * hi + xi[:, None, :] * hr
        y_full = (
            jnp.matmul(yr.reshape(S * 2, BINS), br, precision=HP)
            + jnp.matmul(yi.reshape(S * 2, BINS), bi, precision=HP)
        ).reshape(S, 2, FFT)
        first = y_full[..., :FRAMES_PER_BLOCK]
        second = y_full[..., FRAMES_PER_BLOCK:]
        prev = jnp.concatenate([overlap[None], second[:-1]], axis=0)
        prev = jnp.pad(prev, ((0, 0), (0, 0), (0, FRAMES_PER_BLOCK - TAIL)))
        return first + prev, second[-1]

    def fir_fused(x, hr, hi, overlap):
        f = jnp.matmul(x, cf, precision=HP)  # [S, 2B] = [R | I]
        xr, xi = f[:, :BINS], f[:, BINS:]
        yr = xr[:, None, :] * hr - xi[:, None, :] * hi
        yi = xr[:, None, :] * hi + xi[:, None, :] * hr
        y = jnp.concatenate(
            [yr.reshape(S * 2, BINS), yi.reshape(S * 2, BINS)], axis=1
        )
        y_full = jnp.matmul(y, bf, precision=HP).reshape(S, 2, FFT)
        first = y_full[..., :FRAMES_PER_BLOCK]
        second = y_full[..., FRAMES_PER_BLOCK:]
        prev = jnp.concatenate([overlap[None], second[:-1]], axis=0)
        prev = jnp.pad(prev, ((0, 0), (0, 0), (0, FRAMES_PER_BLOCK - TAIL)))
        return first + prev, second[-1]

    def scan_over(step):
        def run(ov, xs, az, el):
            def body(c, inp):
                c, y = step(c, *inp)
                return c, jnp.sum(y)

            c, ys = jax.lax.scan(body, ov, (xs, az, el))
            return jnp.sum(ys)

        return jax.jit(run)

    report = {}

    # -- full pipelines ----------------------------------------------------
    def step_two_interp(ov, x, a, e):  # shipping shape: interp called twice
        def voice(xv, av, ev, ovv):
            hr = interp_hrir(g_r, av, ev)
            hi = interp_hrir(g_i, av, ev)
            return fir_split(xv, hr, hi, ovv)

        y, nov = jax.vmap(voice)(x, a, e, ov)
        return nov, y

    def step_packed(ov, x, a, e):  # one interp matmul + split FIR
        def voice(xv, av, ev, ovv):
            h = interp_hrir(g_packed, av, ev)
            return fir_split(xv, h[..., :BINS], h[..., BINS:], ovv)

        y, nov = jax.vmap(voice)(x, a, e, ov)
        return nov, y

    def step_packed_fused(ov, x, a, e):  # packed interp + fused-basis FIR
        def voice(xv, av, ev, ovv):
            h = interp_hrir(g_packed, av, ev)
            return fir_fused(xv, h[..., :BINS], h[..., BINS:], ovv)

        y, nov = jax.vmap(voice)(x, a, e, ov)
        return nov, y

    # -- isolated halves ---------------------------------------------------
    def step_interp_only(ov, x, a, e):
        def voice(xv, av, ev, ovv):
            h = interp_hrir(g_packed, av, ev)
            # consume h without the FIR; keep x so input traffic matches
            return h[..., :1] * 0 + jnp.sum(xv), ovv

        y, nov = jax.vmap(voice)(x, a, e, ov)
        return nov, y

    def step_fir_only(ov, x, a, e):
        hr0 = jnp.broadcast_to(g_r[0, 0][None], (S, 2, BINS))
        hi0 = jnp.broadcast_to(g_i[0, 0][None], (S, 2, BINS))

        def voice(xv, av, ev, ovv):
            # constant kernels as broadcast of a traced arg is still device
            # work, but no interp matmul / one-hot build
            return fir_split(xv, hr0 * (1 + av[0] * 0), hi0, ovv)

        y, nov = jax.vmap(voice)(x, a, e, ov)
        return nov, y

    def step_flat_fused(ov, x, a, e):
        # No vmap: the voice axis flattens into matmul ROWS, giving
        # one [V*S, .] matmul per basis instead of a batch of 128 small ones,
        # and the OLA shift runs once across [V, S, ...].
        h = interp_hrir(g_packed, a.reshape(-1), e.reshape(-1))  # [V*S,2,2B]
        hr_, hi_ = h[..., :BINS], h[..., BINS:]
        f = jnp.matmul(x.reshape(V * S, 128), cf, precision=HP)  # [V*S, 2B]
        xr, xi = f[:, :BINS], f[:, BINS:]
        yr = xr[:, None, :] * hr_ - xi[:, None, :] * hi_  # [V*S,2,B]
        yi = xr[:, None, :] * hi_ + xi[:, None, :] * hr_
        y = jnp.concatenate(
            [yr.reshape(V * S * 2, BINS), yi.reshape(V * S * 2, BINS)], axis=1
        )
        y_full = jnp.matmul(y, bf, precision=HP).reshape(V, S, 2, FFT)
        first = y_full[..., :FRAMES_PER_BLOCK]
        second = y_full[..., FRAMES_PER_BLOCK:]
        prev = jnp.concatenate([ov[:, None], second[:, :-1]], axis=1)
        prev = jnp.pad(
            prev, ((0, 0), (0, 0), (0, 0), (0, FRAMES_PER_BLOCK - TAIL))
        )
        return second[:, -1], first + prev

    import sys

    only = sys.argv[1] if len(sys.argv) > 1 else None
    variants = (
        ("two_interp_split", step_two_interp),
        ("packed_split", step_packed),
        ("packed_fused", step_packed_fused),
        ("flat_fused", step_flat_fused),
        ("interp_only", step_interp_only),
        ("fir_only", step_fir_only),
    )
    for name, step in variants:
        if only and name not in only.split(","):
            continue
        ms = timed(scan_over(step), (ov0, xs, az, el))
        report[name] = {"ms_per_step": ms}
        print(json.dumps({name: ms}), flush=True)

    # correctness: packed/fused variants equal the two-interp baseline
    s0 = jax.jit(step_two_interp)
    s1 = jax.jit(step_packed)
    s2 = jax.jit(step_packed_fused)
    s3 = jax.jit(step_flat_fused)
    x1 = jnp.asarray(rng.standard_normal((V, S, 128)).astype(np.float32))
    _, y0 = s0(ov0, x1, az[0], el[0])
    _, y1 = s1(ov0, x1, az[0], el[0])
    _, y2 = s2(ov0, x1, az[0], el[0])
    _, y3 = s3(ov0, x1, az[0], el[0])
    report["max_abs_diff"] = {
        "packed_vs_two": float(f"{float(jnp.max(jnp.abs(y1 - y0))):.3e}"),
        "fused_vs_two": float(f"{float(jnp.max(jnp.abs(y2 - y0))):.3e}"),
        "flat_vs_two": float(f"{float(jnp.max(jnp.abs(y3 - y0))):.3e}"),
    }
    report["shapes"] = {"V": V, "S": S, "fft": FFT, "n_steps": N_STEPS}
    report["warmup_and_total_seconds"] = round(time.perf_counter() - t0, 1)
    from benchmarks.artifacts import write_artifact

    write_artifact("micro_probe9", report)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
