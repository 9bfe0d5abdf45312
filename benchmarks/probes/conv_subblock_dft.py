"""Micro-probe 7: sub-blocked batched-DFT partitioned convolution.

The superblock-grain convolver (conv_superblock_big) runs ONE 2T-point
real DFT forward and one inverse per step at batch 1 — poor matmul batching.
Uniform partitioned convolution is parallel across sub-blocks once every
input spectrum is available, so a superblock can instead split into L
sub-blocks of B = T/L frames: one batch-L forward 2B-point DFT, a depthwise
correlation along the partition axis, one batch-L inverse, and a shifted
overlap-add. Same math, L-fold DFT batching, smaller transforms.

Sweeps L for the config-5 reverb shape (mono, 1 s IR) and the config-4
flagship shape (stereo, 2 s IR) at superblock 64 (T=8192), timing a scanned
step with carried state (args not closures, device-consumed outputs,
dispatch amortized over the scan).

Writes benchmarks/results/micro_probe7.json.
"""

from __future__ import annotations

import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from graphaudio_tpu.ops.convolve import (
    conv_superblock_big,
    prepare_ir_big,
    normalization_scale,
)

T = 8192  # superblock 64
N_STEPS = 256


def conv_superblock_multi(x, hr, hi, hist_r, hist_i, overlap, L):
    """Sub-blocked form of conv_superblock_big: L sub-blocks of B = T/L.

    hr/hi: f32[P, B+1] partition spectra at grain B, partition-REVERSED.
    hist: f32[P-1, B+1] spectra of the previous P-1 sub-blocks, oldest
    first. overlap: f32[B].
    """
    from graphaudio_tpu.ops.fft import BigRealDft

    Tt = x.shape[-1]
    B = Tt // L
    P = hr.shape[0]
    dft = BigRealDft(B, 2 * B)
    xr, xi = dft.forward(x.reshape(L, B))  # [L, B+1]
    seq_r = jnp.concatenate([hist_r, xr], axis=0)  # [P-1+L, B+1]
    seq_i = jnp.concatenate([hist_i, xi], axis=0)
    # windows along the sub-block axis: win[l] = seq[l : l+P]
    win_r = jnp.stack([seq_r[l : l + P] for l in range(L)])  # [L, P, B+1]
    win_i = jnp.stack([seq_i[l : l + P] for l in range(L)])
    acc_r = jnp.sum(win_r * hr - win_i * hi, axis=1)  # [L, B+1]
    acc_i = jnp.sum(win_r * hi + win_i * hr, axis=1)
    y_full = dft.inverse(acc_r, acc_i)  # [L, 2B]
    heads = y_full[:, :B]
    tails = jnp.concatenate([overlap[None, :], y_full[:-1, B:]], axis=0)
    y = (heads + tails).reshape(Tt)
    return y, seq_r[1 - P :] if P > 1 else seq_r[:0], (
        seq_i[1 - P :] if P > 1 else seq_i[:0]
    ), y_full[-1, B:]


def make_step(K, ir_len, L, rng):
    """Returns (step_fn, state, (hr, hi)) for a K-channel convolver."""
    irs = [
        (rng.standard_normal(ir_len) * np.exp(-np.arange(ir_len) / (ir_len / 4)))
        .astype(np.float32)
        for _ in range(K)
    ]
    B = T // L
    prepped = [prepare_ir_big(ir, B) for ir in irs]
    hr = np.stack([p[0] for p in prepped])  # [K, P, B+1]
    hi = np.stack([p[1] for p in prepped])
    P = hr.shape[1]
    state = (
        np.zeros((K, P - 1, B + 1), np.float32),
        np.zeros((K, P - 1, B + 1), np.float32),
        np.zeros((K, B), np.float32),
    )

    if L == 1:
        conv = conv_superblock_big
    else:
        def conv(x, chr_, chi_, h_r, h_i, ov):
            return conv_superblock_multi(x, chr_, chi_, h_r, h_i, ov, L)

    def step(carry, x, hr, hi):
        h_r, h_i, ov = carry
        y, nh_r, nh_i, nov = jax.vmap(conv)(x, hr, hi, h_r, h_i, ov)
        return (nh_r, nh_i, nov), y

    return step, state, (hr, hi), irs


def timed(step, state, consts, K, reps=3):
    hr, hi = consts
    xs = jnp.asarray(
        np.random.default_rng(0).standard_normal((N_STEPS, K, T)).astype(np.float32)
    )

    def run(state, hr, hi, xs):
        def body(carry, x):
            carry, y = step(carry, x, hr, hi)
            return carry, jnp.sum(y)

        _, outs = jax.lax.scan(body, state, xs)
        return jnp.sum(outs)

    fn = jax.jit(run)
    args = (jax.device_put(state), jax.device_put(hr), jax.device_put(hi), xs)
    np.asarray(jax.device_get(fn(*args)))  # compile
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        np.asarray(jax.device_get(fn(*args)))
        best = min(best, (time.perf_counter() - t0) / N_STEPS)
    return best * 1e3  # ms/step


def check_correctness(step, state, consts, K, irs, n_steps=3):
    """Compare n_steps rendered superblocks against np direct convolution."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((n_steps, K, T)).astype(np.float32)
    hr, hi = consts
    carry = jax.device_put(state)
    outs = []
    for i in range(n_steps):
        carry, y = jax.jit(step)(carry, jnp.asarray(xs[i]), hr, hi)
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)  # [K, n_steps*T]
    err = 0.0
    for k in range(K):
        scale = normalization_scale(irs[k])
        ref = np.convolve(
            xs[:, k].reshape(-1).astype(np.float64),
            irs[k].astype(np.float64) * scale,
        )[: n_steps * T]
        err = max(err, float(np.max(np.abs(got[k] - ref))))
    return err


def main():
    t0 = time.perf_counter()
    report = {}
    rng = np.random.default_rng(42)

    for name, K, ir_len in (
        ("mono_1s", 1, 48000),
        ("stereo_2s", 2, 96000),
    ):
        sub = {}
        for L in (1, 2, 4, 8, 16, 32):
            step, state, consts, irs = make_step(K, ir_len, L, rng)
            err = check_correctness(step, state, consts, K, irs)
            ms = timed(step, state, consts, K)
            sub[f"L{L}"] = {
                "ms_per_step": round(ms, 4),
                "max_abs_err": float(f"{err:.3e}"),
                "partitions": int(consts[0].shape[1]),
                "sub_block": T // L,
            }
            print(json.dumps({name: {f"L{L}": sub[f"L{L}"]}}), flush=True)
        report[name] = sub

    report["warmup_and_total_seconds"] = round(time.perf_counter() - t0, 1)
    from benchmarks.artifacts import write_artifact

    write_artifact("micro_probe7", report)
    print(json.dumps({"done": True}))


if __name__ == "__main__":
    main()
