"""Micro-probe 8: DFT matmul precision for the HRTF stage.

Config 5's 128-voice SpatialPannerNode group runs its HRTF as matmuls at
Precision.HIGHEST: per-quantum forward 192-pt DFT, complex MAC, inverse
DFT. A lower precision is cheaper IF the result stays inside the 1e-5
oracle budget.

Times the HRTF pipeline (spectra interp + frequency-domain OLA FIR) at
config-5 shapes (V=128 voices, S=64 quanta/step) for HIGHEST vs HIGH on
the DFT matmuls, and measures max abs error vs a float64 numpy rendering
of the same quanta. Writes benchmarks/results/micro_probe8.json.
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


def make_fir(precision):
    cr, ci = rfft_basis(FRAMES_PER_BLOCK, FFT)
    br, bi = irfft_basis(FFT)

    def fir(x, hr, hi, overlap):
        # x: [S,128]; hr/hi: [S,2,BINS]; overlap: [2,TAIL]
        xr = jnp.matmul(x, cr, precision=precision)
        xi = jnp.matmul(x, ci, precision=precision)
        yr = xr[:, None, :] * hr - xi[:, None, :] * hi  # [S,2,B]
        yi = xr[:, None, :] * hi + xi[:, None, :] * hr
        flat_r = yr.reshape(S * 2, BINS)
        flat_i = yi.reshape(S * 2, BINS)
        y_full = (
            jnp.matmul(flat_r, br, precision=precision)
            + jnp.matmul(flat_i, bi, precision=precision)
        ).reshape(S, 2, FFT)
        first = y_full[..., :FRAMES_PER_BLOCK]
        second = y_full[..., FRAMES_PER_BLOCK:]
        prev = jnp.concatenate([overlap[None], second[:-1]], axis=0)
        prev = jnp.pad(prev, ((0, 0), (0, 0), (0, FRAMES_PER_BLOCK - TAIL)))
        return first + prev, second[-1]

    return fir


def make_step(precision, sr_flat, si_flat):
    """One spatializer-like step: per-voice az/el -> spectra interp ->
    per-quantum OLA FIR. State: per-voice overlap [V,2,TAIL]."""
    fir = make_fir(precision)

    def step(overlap, x, az, el):
        # x: [V,S,128]; az/el: [V,S]
        def voice(xv, azv, elv, ovv):
            h = interp_hrir_spectra(azv, elv)  # [S,2,BINS] x2
            y, nov = fir(xv, h[0], h[1], ovv)
            return y, nov

        def interp_hrir_spectra(azv, elv):
            out = interp_hrir(
                _SPEC_GRID, azv, elv
            )  # [S, 2, 2*BINS] packed r|i
            return out[..., :BINS], out[..., BINS:]

        y, nov = jax.vmap(voice)(x, az, el, overlap)
        return nov, y

    return step


def main():
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    grid = build_hrir_grid(48000)
    sr, si = hrir_grid_spectra(grid)  # [E,A,2,BINS]
    E, A = sr.shape[:2]
    # Pack spectra real|imag on the last axis so ONE interp matmul serves both.
    global _SPEC_GRID
    _SPEC_GRID = jnp.asarray(
        np.concatenate([sr, si], axis=-1).reshape(E, A, 2, 2 * BINS)
    )

    az = rng.uniform(0, 2 * np.pi, (N_STEPS, V, S)).astype(np.float32)
    el = rng.uniform(-np.pi / 2, np.pi / 2, (N_STEPS, V, S)).astype(np.float32)

    report = {}
    outs = {}
    for name, prec in (
        ("highest", jax.lax.Precision.HIGHEST),
        ("high", jax.lax.Precision.HIGH),
    ):
        step = make_step(prec, sr, si)

        def run(ov, xs, azs, els):
            def body(c, inp):
                c, y = step(c, *inp)
                return c, jnp.sum(y)

            c, ys = jax.lax.scan(body, ov, (xs, azs, els))
            return jnp.sum(ys)

        fn = jax.jit(run)
        ov0 = jnp.zeros((V, 2, TAIL), jnp.float32)
        # On-device pseudo audio for the timing scan (1 GB would not fit the
        # upload budget): deterministic iota hash per step.
        xs_t = jnp.sin(
            jnp.arange(N_STEPS * V * S * 128, dtype=jnp.float32).reshape(
                N_STEPS, V, S, 128
            )
            * 0.618
        )
        args = (ov0, xs_t, jnp.asarray(az), jnp.asarray(el))
        np.asarray(fn(*args))  # compile
        best = np.inf
        for _ in range(3):
            t1 = time.perf_counter()
            np.asarray(fn(*args))
            best = min(best, (time.perf_counter() - t1) / N_STEPS)
        report[name] = {"ms_per_step": round(best * 1e3, 4)}

        # Error check: 2 real-audio steps vs float64 numpy.
        x2 = rng.standard_normal((2, V, S, 128)).astype(np.float32) * 0.5
        sfn = jax.jit(step)
        ov = ov0
        got = []
        for t in range(2):
            ov, y = sfn(ov, jnp.asarray(x2[t]), jnp.asarray(az[t]),
                        jnp.asarray(el[t]))
            got.append(np.asarray(y))
        outs[name] = (np.stack(got), x2, az[:2], el[:2])

    # f64 reference for the same 2 steps (voice 0..V-1, all quanta).
    (got_hi, x2, az2, el2) = outs["highest"]
    got_hi = outs["highest"][0]
    got_h = outs["high"][0]

    def f64_ref():
        srg, sig = hrir_grid_spectra(grid)
        srg = srg.astype(np.float64)
        sig = sig.astype(np.float64)
        out = np.zeros((2, V, S, 2, 128))
        ov = np.zeros((V, 2, TAIL))
        for t in range(2):
            for v in range(V):
                # bilinear weights exactly as interp_hrir
                azq = np.mod(az2[t, v], 2 * np.pi) / (2 * np.pi) * A
                elq = (el2[t, v] + np.pi / 2) / np.pi * (srg.shape[0] - 1)
                a0 = np.floor(azq).astype(int) % A
                a1 = (a0 + 1) % A
                fa = azq - np.floor(azq)
                e0 = np.clip(np.floor(elq).astype(int), 0, srg.shape[0] - 1)
                e1 = np.clip(e0 + 1, 0, srg.shape[0] - 1)
                fe = elq - np.floor(elq)
                hr = (
                    srg[e0, a0] * ((1 - fa) * (1 - fe))[:, None, None]
                    + srg[e0, a1] * (fa * (1 - fe))[:, None, None]
                    + srg[e1, a0] * ((1 - fa) * fe)[:, None, None]
                    + srg[e1, a1] * (fa * fe)[:, None, None]
                )
                hi_ = (
                    sig[e0, a0] * ((1 - fa) * (1 - fe))[:, None, None]
                    + sig[e0, a1] * (fa * (1 - fe))[:, None, None]
                    + sig[e1, a0] * ((1 - fa) * fe)[:, None, None]
                    + sig[e1, a1] * (fa * fe)[:, None, None]
                )
                X = np.fft.rfft(x2[t, v].astype(np.float64), FFT, axis=-1)
                Y = X[:, None, :] * (hr + 1j * hi_)
                yf = np.fft.irfft(Y, FFT, axis=-1)  # [S,2,FFT]
                first = yf[..., :128]
                second = yf[..., 128:]
                prev = np.concatenate([ov[v][None], second[:-1]], axis=0)
                prev = np.pad(prev, ((0, 0), (0, 0), (0, 128 - TAIL)))
                out[t, v] = first + prev
                ov[v] = second[-1]
        return out

    ref = f64_ref()
    # shipping layout from step() is [V, S, 2, 128]? -> got shape check
    err_hi = float(np.max(np.abs(got_hi - ref)))
    err_h = float(np.max(np.abs(got_h - ref)))
    report["max_abs_err_vs_f64"] = {
        "highest": float(f"{err_hi:.3e}"),
        "high": float(f"{err_h:.3e}"),
    }
    report["shapes"] = {"V": V, "S": S, "fft": FFT, "n_steps": N_STEPS}
    report["warmup_and_total_seconds"] = round(time.perf_counter() - t0, 1)
    from benchmarks.artifacts import write_artifact

    write_artifact("micro_probe8", report)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
