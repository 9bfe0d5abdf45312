"""Micro-probe 4: the superblock convolver's op-chain latency.

conv_superblock_big does ~0.5 MFLOP of matmuls per step; the question is
how much the CHAIN of small non-fusable ops around them costs (4 swapaxes
per ComplexDft stage pair, reverse `take` gathers in the real untangle,
concats), each a fixed per-op latency. Candidates:

  a) current conv_superblock_big (baseline)
  b) transpose-free ComplexDft: dot_general contracting the j1 axis in
     place (XLA folds the layout change into the matmul) — drops 4
     swapaxes per transform
  c) flip-based untangle: Z[h-k] via jnp.flip + roll-by-concat instead of
     a general reverse gather
  d) b + c combined

Writes benchmarks/results/micro_probe4.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST
F = 128


def bench(fn, args, n=256):
    jfn = jax.jit(fn, static_argnums=0)

    def timed(steps):
        np.asarray(jax.device_get(jfn(steps, *args)))
        best = np.inf
        for _ in range(3):
            t0 = time.perf_counter()
            np.asarray(jax.device_get(jfn(steps, *args)))
            best = min(best, time.perf_counter() - t0)
        return best

    half = n // 2
    return max((timed(n) - timed(half)) / (n - half), 1e-9)


# ---- candidate transforms ----------------------------------------------------


def _factors(n):
    from graphaudio_tpu.ops.fft import _split_factors
    return _split_factors(n)


class CdBases:
    def __init__(self, n, inverse=False):
        n1, n2 = _factors(n)
        self.n, self.n1, self.n2 = n, n1, n2
        sign = 2.0 if inverse else -2.0
        k1 = np.arange(n1, dtype=np.float64)
        k2 = np.arange(n2, dtype=np.float64)
        a1 = sign * np.pi * k1[:, None] * k1[None, :] / n1
        a2 = sign * np.pi * k2[:, None] * k2[None, :] / n2
        w1r, w1i = np.cos(a1).astype(np.float32), np.sin(a1).astype(np.float32)
        w2r, w2i = np.cos(a2).astype(np.float32), np.sin(a2).astype(np.float32)
        self.w1a = np.block([[w1r, w1i], [-w1i, w1r]]).astype(np.float32)
        self.w2a = np.block([[w2r, w2i], [-w2i, w2r]]).astype(np.float32)
        tw = sign * np.pi * k1[:, None] * k2[None, :] / n
        self.twr = np.cos(tw).astype(np.float32)
        self.twi = np.sin(tw).astype(np.float32)
        self.inverse = inverse

    def notr(self, xr, xi):
        """Transpose-free: stage-1 contraction via dot_general on axis -2."""
        n1, n2 = self.n1, self.n2
        lead = xr.shape[:-1]
        xr = xr.reshape(lead + (n1, n2))
        xi = xi.reshape(lead + (n1, n2))
        x_aug = jnp.concatenate([xr, xi], axis=-2)  # [.., 2n1, n2]
        nb = len(lead)
        # y[.., K, j2] = sum_j w1a[j, K] x[.., j, j2]
        y = jax.lax.dot_general(
            jnp.asarray(self.w1a), x_aug,
            (((0,), (nb,)), ((), ())), precision=HIGHEST,
        )  # [2n1, lead.., n2] -> move axis
        y = jnp.moveaxis(y, 0, -2) if nb else y
        yr, yi = y[..., :n1, :], y[..., n1:, :]
        twr = jnp.asarray(self.twr)
        twi = jnp.asarray(self.twi)
        zr = yr * twr - yi * twi
        zi = yr * twi + yi * twr
        q = jnp.concatenate([zr, zi], axis=-1)  # [.., n1, 2n2]
        v = jnp.matmul(q, jnp.asarray(self.w2a), precision=HIGHEST)
        vr, vi = v[..., :n2], v[..., n2:]
        # output flat index k2*n1 + k1: [.., n1, n2] -> transpose-free via
        # reshape in k1-major order is WRONG; keep one swap at the end.
        out_r = jnp.swapaxes(vr, -1, -2).reshape(lead + (self.n,))
        out_i = jnp.swapaxes(vi, -1, -2).reshape(lead + (self.n,))
        if self.inverse:
            out_r = out_r / self.n
            out_i = out_i / self.n
        return out_r, out_i


def flip_mirror(Z):
    """Z[(-k) % h] for k=0..h: [Z0, Z_{h-1}, ..., Z_1, Z_0] via flip."""
    return jnp.concatenate(
        [Z[..., :1], jnp.flip(Z[..., 1:], axis=-1), Z[..., :1]], axis=-1)


def main():
    from graphaudio_tpu.ops.convolve import conv_superblock_big, prepare_ir_big
    from graphaudio_tpu.ops.fft import ComplexDft

    results = {}
    dev = jax.devices()[0]
    print(f"backend={dev.platform}", flush=True)
    t0 = time.perf_counter()
    np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros(8, jnp.float32)))
    results["warmup_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"warm-up {results['warmup_seconds']} s", flush=True)

    rng = np.random.default_rng(0)
    T = 4096
    C = 2
    ir = (rng.standard_normal(48000) * np.exp(-np.arange(48000) / 12000)
          ).astype(np.float32)
    hr, hi = prepare_ir_big(ir, T)
    P2 = hr.shape[0]
    hr = jnp.asarray(np.stack([hr, hr]))  # [C, P2, T+1]
    hi = jnp.asarray(np.stack([hi, hi]))
    x0 = jnp.asarray(rng.standard_normal((C, T)).astype(np.float32))
    hist_r0 = jnp.zeros((C, P2 - 1, T + 1), jnp.float32)
    hist_i0 = jnp.zeros((C, P2 - 1, T + 1), jnp.float32)
    ov0 = jnp.zeros((C, T), jnp.float32)

    def scan_conv(conv1):
        def fn(steps, x0, hr, hi, hist_r, hist_i, ov):
            def body(carry, _):
                x, hist_r, hist_i, ov = carry
                y, hist_r, hist_i, ov = jax.vmap(conv1)(
                    x, hr, hi, hist_r, hist_i, ov)
                # evolve the input so nothing hoists
                x = x * 0.999 + y * 1e-6
                return (x, hist_r, hist_i, ov), jnp.sum(y)
            carry, ys = jax.lax.scan(
                body, (x0, hist_r, hist_i, ov), None, length=steps)
            return jnp.sum(ys) + sum(jnp.sum(c) for c in carry)
        return fn

    # a) baseline
    results["conv_big_current_ms"] = round(bench(
        scan_conv(conv_superblock_big),
        (x0, hr, hi, hist_r0, hist_i0, ov0)) * 1e3, 4)
    print(f"current {results['conv_big_current_ms']} ms/step", flush=True)

    # reference output for correctness checks
    def run_once(conv1, n=3):
        x, hist_r, hist_i, ov = x0, hist_r0, hist_i0, ov0
        outs = []
        for _ in range(n):
            y, hist_r, hist_i, ov = jax.vmap(conv1)(x, hr, hi, hist_r, hist_i, ov)
            outs.append(np.asarray(y))
            x = x * 0.999 + y * 1e-6
        return np.concatenate(outs, axis=-1)

    ref = run_once(conv_superblock_big)

    # b/c/d) variant transforms inside the same conv structure
    fwd_cd = CdBases(T)
    inv_cd = CdBases(T, inverse=True)
    h = T
    N = 2 * T
    k = np.arange(h + 1, dtype=np.float64)
    a = -2.0 * np.pi * k / N
    er = jnp.asarray(np.cos(a).astype(np.float32))
    ei = jnp.asarray(np.sin(a).astype(np.float32))

    def fwd_variant(x, cd, use_flip):
        lead = x.shape[:-1]
        pad = 2 * h - x.shape[-1]
        if pad > 0:
            x = jnp.concatenate(
                [x, jnp.zeros(lead + (pad,), x.dtype)], axis=-1)
        z = x.reshape(lead + (h, 2))
        zr, zi = z[..., 0], z[..., 1]
        Zr, Zi = cd.notr(zr, zi) if cd else ComplexDft(h)(zr, zi)
        if use_flip:
            Zmr, Zmi = flip_mirror(Zr), flip_mirror(Zi)
            Zkr = jnp.concatenate([Zr, Zr[..., :1]], axis=-1)
            Zki = jnp.concatenate([Zi, Zi[..., :1]], axis=-1)
        else:
            idx = (-jnp.arange(h + 1)) % h
            Zkr = jnp.concatenate([Zr, Zr[..., :1]], axis=-1)
            Zki = jnp.concatenate([Zi, Zi[..., :1]], axis=-1)
            Zmr = jnp.take(Zr, idx, axis=-1)
            Zmi = jnp.take(Zi, idx, axis=-1)
        ar = 0.5 * (Zkr + Zmr)
        ai = 0.5 * (Zki - Zmi)
        br = 0.5 * (Zki + Zmi)
        bi = -0.5 * (Zkr - Zmr)
        Xr = ar + br * er - bi * ei
        Xi = ai + br * ei + bi * er
        return Xr, Xi

    def inv_variant(R, I, cd, use_flip):
        if use_flip:
            idx_concat = None
            Rm = jnp.flip(R[..., 1:], axis=-1)
            Im = jnp.flip(I[..., 1:], axis=-1)
        else:
            idx = h - jnp.arange(h)
            Rm = jnp.take(R, idx, axis=-1)
            Im = jnp.take(I, idx, axis=-1)
        Rk, Ik = R[..., :h], I[..., :h]
        ar = 0.5 * (Rk + Rm)
        ai = 0.5 * (Ik - Im)
        dr = 0.5 * (Rk - Rm)
        di = 0.5 * (Ik + Im)
        err_, eii_ = er[..., :h], ei[..., :h]
        Zr = ar - (di * err_ - dr * eii_)
        Zi = ai + (dr * err_ + di * eii_)
        zr, zi = (cd.notr(Zr, Zi) if cd
                  else ComplexDft(h, inverse=True)(Zr, Zi))
        lead = zr.shape[:-1]
        return jnp.stack([zr, zi], axis=-1).reshape(lead + (N,))

    def make_conv(cd_f, cd_i, use_flip):
        def conv1(x, hr1, hi1, hist_r, hist_i, overlap):
            xr, xi = fwd_variant(x[None, :], cd_f, use_flip)
            seq_r = jnp.concatenate([hist_r, xr], axis=0)
            seq_i = jnp.concatenate([hist_i, xi], axis=0)
            acc_r = jnp.sum(seq_r * hr1 - seq_i * hi1, axis=0)
            acc_i = jnp.sum(seq_r * hi1 + seq_i * hr1, axis=0)
            y_full = inv_variant(acc_r[None, :], acc_i[None, :],
                                 cd_i, use_flip)[0]
            y = y_full[:T] + overlap
            return y, seq_r[1:], seq_i[1:], y_full[T:]
        return conv1

    for name, cf, ci, fl in [
        ("conv_big_notr_ms", fwd_cd, inv_cd, False),
        ("conv_big_flip_ms", None, None, True),
        ("conv_big_notr_flip_ms", fwd_cd, inv_cd, True),
    ]:
        conv1 = make_conv(cf, ci, fl)
        got = run_once(conv1)
        err = float(np.abs(got - ref).max())
        results[name.replace("_ms", "_maxerr")] = err
        results[name] = round(bench(
            scan_conv(conv1), (x0, hr, hi, hist_r0, hist_i0, ov0)) * 1e3, 4)
        print(f"{name} {results[name]} ms/step (err {err:.2e})", flush=True)

    from benchmarks.artifacts import write_artifact
    write_artifact("micro_probe4", results)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
