"""Micro-probe for config-5 stage optimizations.

Times candidate kernel variants for the three hot config-5 stages
(sources row-gather, HRTF interpolation, HRTF DFT precision, superblock
convolver) in ONE process so backend start-up is paid once.

Measurement rules: every timing is a two-length scan difference (cancels
the fixed per-call dispatch cost), the scan carry evolves so XLA cannot
hoist the body, operands travel as ARGUMENTS (closure constants
constant-fold), and every wait is a device_get of a value that depends on
all the work.

Writes benchmarks/results/micro_probe.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST
HIGH = jax.lax.Precision.HIGH
F = 128  # frames per block


def bench(fn, args, n=256):
    """Per-step seconds of jitted fn(carry, n_steps arg-varied scan)."""
    jfn = jax.jit(fn, static_argnums=0)

    def timed(steps):
        np.asarray(jax.device_get(jfn(steps, *args)))  # compile+warm
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(jax.device_get(jfn(steps, *args)))
            best = min(best, time.perf_counter() - t0)
        return best

    half = n // 2
    return max((timed(n) - timed(half)) / (n - half), 1e-9)


def main():
    results = {}
    dev = jax.devices()[0]
    print(f"backend={dev.platform}", flush=True)

    t0 = time.perf_counter()
    np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros(8, jnp.float32)))
    results["warmup_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"warm-up {results['warmup_seconds']} s", flush=True)

    rng = np.random.default_rng(0)
    V, S = 128, 32
    T = S * F

    # ---- a) unity source gather: two-gather (current) vs fused ------------
    W = 1 << 24
    arena = jnp.asarray(rng.standard_normal(W).astype(np.float32)[None])
    loop_rows = 375  # 48000-frame loop

    def src_old(steps, arena, pos0):
        rows = arena.reshape(1, W // F, F)

        def body(pos, _):
            row0 = (pos % loop_rows).astype(jnp.int32)  # [V]
            bidx = jnp.arange(S, dtype=jnp.int32)[None, :] * jnp.ones(
                (V, 1), jnp.int32
            )
            ridx = jnp.clip(row0[:, None] + jnp.arange(S, dtype=jnp.int32),
                            0, W // F - 1)
            blocks = jnp.moveaxis(jnp.take(rows, ridx, axis=1), 0, 1)
            samples = jnp.take_along_axis(
                blocks, bidx[:, None, :, None], axis=2
            )
            return pos + S, jnp.sum(samples)

        pos, outs = jax.lax.scan(body, pos0, None, length=steps)
        return jnp.sum(outs) + jnp.sum(pos)

    def src_new(steps, arena, pos0):
        rows = arena.reshape(1, W // F, F)

        def body(pos, _):
            row0 = (pos % loop_rows).astype(jnp.int32)
            bidx = jnp.arange(S, dtype=jnp.int32)[None, :] * jnp.ones(
                (V, 1), jnp.int32
            )
            ridx = jnp.clip(row0[:, None] + bidx, 0, W // F - 1)
            samples = jnp.moveaxis(jnp.take(rows, ridx, axis=1), 0, 1)
            return pos + S, jnp.sum(samples)

        pos, outs = jax.lax.scan(body, pos0, None, length=steps)
        return jnp.sum(outs) + jnp.sum(pos)

    pos0 = jnp.asarray(rng.integers(0, loop_rows, V), jnp.int32)
    results["src_gather_old_ms"] = round(bench(src_old, (arena, pos0)) * 1e3, 4)
    results["src_gather_fused_ms"] = round(
        bench(src_new, (arena, pos0)) * 1e3, 4
    )
    print(f"source gather old {results['src_gather_old_ms']} ms "
          f"fused {results['src_gather_fused_ms']} ms", flush=True)

    # ---- b) HRTF interp: one-hot matmuls vs merged vs row-gather ----------
    E, A, L2 = 7, 24, 258  # grid spectra flattened [E*A, 2*129]
    gr = jnp.asarray(rng.standard_normal((E * A, L2)).astype(np.float32))
    gi = jnp.asarray(rng.standard_normal((E * A, L2)).astype(np.float32))
    gcat = jnp.concatenate([gr, gi], axis=1)  # [E*A, 516]

    def angles(phase):
        az = phase[:, None] + jnp.arange(S, dtype=jnp.float32)[None] * 0.01
        el = 0.3 * jnp.sin(az)
        return az.reshape(-1), el.reshape(-1)  # [V*S]

    def corners(az, el):
        azx = jnp.mod(az, 2 * np.pi) / (2 * np.pi) * A
        elx = (el + np.pi / 2) / np.pi * (E - 1)
        a0 = jnp.floor(azx).astype(jnp.int32) % A
        a1 = (a0 + 1) % A
        fa = (azx - jnp.floor(azx)).astype(jnp.float32)
        e0 = jnp.clip(jnp.floor(elx).astype(jnp.int32), 0, E - 1)
        e1 = jnp.clip(e0 + 1, 0, E - 1)
        fe = (elx - jnp.floor(elx)).astype(jnp.float32)
        return a0, a1, fa, e0, e1, fe

    def onehot_W(az, el):
        a0, a1, fa, e0, e1, fe = corners(az, el)
        iota = jnp.arange(E * A, dtype=jnp.int32)

        def oh(e, a, wgt):
            return (iota[None, :] == (e * A + a)[:, None]) * wgt[:, None]

        return (
            oh(e0, a0, (1 - fa) * (1 - fe))
            + oh(e0, a1, fa * (1 - fe))
            + oh(e1, a0, (1 - fa) * fe)
            + oh(e1, a1, fa * fe)
        )

    def interp_current(steps, gr, gi, phase0):
        def body(ph, _):
            az, el = angles(ph)
            w = onehot_W(az, el)
            hr = jnp.einsum("sg,gm->sm", w, gr, precision=HIGHEST)
            w2 = onehot_W(az, el)  # built twice in the current node code
            hi = jnp.einsum("sg,gm->sm", w2, gi, precision=HIGHEST)
            return ph + 0.32, jnp.sum(hr) + jnp.sum(hi)

        ph, outs = jax.lax.scan(body, phase0, None, length=steps)
        return jnp.sum(outs) + jnp.sum(ph)

    def interp_merged(prec):
        def fn(steps, gcat, phase0):
            def body(ph, _):
                az, el = angles(ph)
                w = onehot_W(az, el)
                h = jnp.einsum("sg,gm->sm", w, gcat, precision=prec)
                return ph + 0.32, jnp.sum(h)

            ph, outs = jax.lax.scan(body, phase0, None, length=steps)
            return jnp.sum(outs) + jnp.sum(ph)

        return fn

    def interp_rowgather(steps, gcat, phase0):
        def body(ph, _):
            az, el = angles(ph)
            a0, a1, fa, e0, e1, fe = corners(az, el)
            idx = jnp.stack(
                [e0 * A + a0, e0 * A + a1, e1 * A + a0, e1 * A + a1], axis=1
            )
            wts = jnp.stack(
                [(1 - fa) * (1 - fe), fa * (1 - fe), (1 - fa) * fe, fa * fe],
                axis=1,
            )
            rowsv = jnp.take(gcat, idx, axis=0)  # [VS, 4, 516]
            h = jnp.sum(rowsv * wts[:, :, None], axis=1)
            return ph + 0.32, jnp.sum(h)

        ph, outs = jax.lax.scan(body, phase0, None, length=steps)
        return jnp.sum(outs) + jnp.sum(ph)

    phase0 = jnp.asarray(rng.standard_normal(V).astype(np.float32))
    results["interp_current_ms"] = round(
        bench(interp_current, (gr, gi, phase0)) * 1e3, 4
    )
    results["interp_merged_highest_ms"] = round(
        bench(interp_merged(HIGHEST), (gcat, phase0)) * 1e3, 4
    )
    results["interp_merged_high_ms"] = round(
        bench(interp_merged(HIGH), (gcat, phase0)) * 1e3, 4
    )
    results["interp_rowgather_ms"] = round(
        bench(interp_rowgather, (gcat, phase0)) * 1e3, 4
    )
    print("interp:", {k: v for k, v in results.items() if "interp" in k},
          flush=True)

    # accuracy of merged-HIGH / row-gather vs f64 (one call, pulled back)
    az, el = angles(phase0)
    wts_np = np.asarray(onehot_W(az, el), np.float64)
    ref = wts_np @ np.asarray(gcat, np.float64)

    def one_merged(prec):
        return jax.jit(
            lambda g, p: jnp.einsum(
                "sg,gm->sm", onehot_W(*angles(p)), g, precision=prec
            )
        )(gcat, phase0)

    for name, val in (
        ("highest", one_merged(HIGHEST)),
        ("high", one_merged(HIGH)),
    ):
        err = np.max(np.abs(np.asarray(val, np.float64) - ref)) / np.max(
            np.abs(ref)
        )
        results[f"interp_err_{name}"] = float(err)
    print("interp err:", results["interp_err_highest"],
          results["interp_err_high"], flush=True)

    # ---- c) RealDft precision: HIGHEST vs HIGH ----------------------------
    from graphaudio_tpu.ops.fft import rfft_basis, irfft_basis

    cr, ci = rfft_basis(F, 2 * F)
    br, bi = irfft_basis(2 * F)
    cr, ci = jnp.asarray(cr), jnp.asarray(ci)
    br, bi = jnp.asarray(br), jnp.asarray(bi)
    xbase = jnp.asarray(rng.standard_normal((V * S, F)).astype(np.float32))
    hrk = jnp.asarray(
        rng.standard_normal((V * S, 2, F + 1)).astype(np.float32) * 0.1
    )
    hik = jnp.asarray(
        rng.standard_normal((V * S, 2, F + 1)).astype(np.float32) * 0.1
    )

    def hrtf_chain(prec):
        def fn(steps, xb, hr, hi):
            def body(carry, _):
                x = xb * (1.0 + carry * 1e-20)
                xr = jnp.matmul(x, cr, precision=prec)
                xi = jnp.matmul(x, ci, precision=prec)
                yr = xr[:, None, :] * hr - xi[:, None, :] * hi
                yi = xr[:, None, :] * hi + xi[:, None, :] * hr
                y = jnp.matmul(
                    yr.reshape(-1, F + 1), br, precision=prec
                ) + jnp.matmul(yi.reshape(-1, F + 1), bi, precision=prec)
                return jnp.sum(y) * 1e-9, jnp.sum(y)

            c, outs = jax.lax.scan(body, jnp.float32(0), None, length=steps)
            return jnp.sum(outs) + c

        return fn

    results["hrtf_dft_highest_ms"] = round(
        bench(hrtf_chain(HIGHEST), (xbase, hrk, hik)) * 1e3, 4
    )
    results["hrtf_dft_high_ms"] = round(
        bench(hrtf_chain(HIGH), (xbase, hrk, hik)) * 1e3, 4
    )
    print("hrtf dft:", results["hrtf_dft_highest_ms"],
          results["hrtf_dft_high_ms"], flush=True)

    # accuracy: full chain vs f64 numpy
    def chain_once(prec):
        def f(xb, hr, hi):
            xr = jnp.matmul(xb, cr, precision=prec)
            xi = jnp.matmul(xb, ci, precision=prec)
            yr = xr[:, None, :] * hr - xi[:, None, :] * hi
            yi = xr[:, None, :] * hi + xi[:, None, :] * hr
            return jnp.matmul(
                yr.reshape(-1, F + 1), br, precision=prec
            ) + jnp.matmul(yi.reshape(-1, F + 1), bi, precision=prec)

        return np.asarray(jax.jit(f)(xbase, hrk, hik), np.float64)

    xb64 = np.asarray(xbase, np.float64)
    spec = np.fft.rfft(np.pad(xb64, ((0, 0), (0, F))), axis=-1)
    hk64 = np.asarray(hrk, np.float64) + 1j * np.asarray(hik, np.float64)
    y64 = np.fft.irfft((spec[:, None, :] * hk64).reshape(-1, F + 1),
                       n=2 * F, axis=-1)
    scale = np.max(np.abs(y64))
    for name in ("highest", "high"):
        prec = HIGHEST if name == "highest" else HIGH
        err = np.max(np.abs(chain_once(prec) - y64)) / scale
        results[f"hrtf_dft_err_{name}"] = float(err)
    print("hrtf dft err:", results["hrtf_dft_err_highest"],
          results["hrtf_dft_err_high"], flush=True)

    # ---- d) superblock convolver step at T=4096 / 8192 --------------------
    from graphaudio_tpu.ops.convolve import conv_superblock_big

    for T_big, label in ((4096, "sb32"), (8192, "sb64")):
        P2 = -(-48000 // T_big) + 1
        hr = jnp.asarray(
            rng.standard_normal((P2, T_big + 1)).astype(np.float32) * 0.01
        )
        hi = jnp.asarray(
            rng.standard_normal((P2, T_big + 1)).astype(np.float32) * 0.01
        )
        xb = jnp.asarray(rng.standard_normal(T_big).astype(np.float32))

        def conv_fn(steps, xb, hr, hi):
            h0r = jnp.zeros((P2 - 1, T_big + 1), jnp.float32)
            h0i = jnp.zeros((P2 - 1, T_big + 1), jnp.float32)
            ov0 = jnp.zeros(T_big, jnp.float32)

            def body(carry, _):
                h_r, h_i, ov, acc = carry
                y, h_r, h_i, ov = conv_superblock_big(
                    xb * (1.0 + acc * 1e-20), hr, hi, h_r, h_i, ov
                )
                return (h_r, h_i, ov, jnp.sum(y) * 1e-9), jnp.sum(y)

            c, outs = jax.lax.scan(
                body, (h0r, h0i, ov0, jnp.float32(0)), None, length=steps
            )
            return jnp.sum(outs) + c[3]

        ms = bench(conv_fn, (xb, hr, hi), n=256) * 1e3
        results[f"conv_big_{label}_ms"] = round(ms, 4)
        print(f"conv big {label}: {ms:.4f} ms", flush=True)

    from benchmarks.artifacts import write_artifact

    results["backend"] = dev.platform
    write_artifact("micro_probe", results)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
