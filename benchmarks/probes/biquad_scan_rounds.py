"""Micro-probe 6: scan-round count vs first-order solve latency.

Asks whether config 3's step is bound by associative-scan ROUNDS (each a
fused elementwise pass over [C, S, 128]) rather than by FLOPs.
lax.associative_scan lowers to ~2*log2(B) rounds. Candidates that cut the round count for the same recurrence
s_t = p_t s_{t-1} + u_t:

  a) current two-level _first_order_scan (baseline)
  b) Hillis-Steele binary doubling on the lane axis: log2(128)=7 rounds,
     each one fused shift+combine over the full block (more total work --
     O(T log T) -- but fewer, fatter rounds)
  c) Hillis-Steele radix-4: ceil(log4(128))=4 rounds, each combining 3
     shifted copies (the two inner combines are independent, so XLA fuses
     a round into one kernel)

plus the same three driven through the full 4-biquad config-3 chain shape
(2 scans x 2 passes x 4 biquads) to see end impact. Writes
benchmarks/results/micro_probe6.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from graphaudio_tpu.ops.biquad import _first_order_scan


def _shift_right(x, k, axis):
    """x shifted right by k along axis, zero/identity-filled on the left.

    For the affine operator (p, b): shifting in identity means p=1, b=0.
    Returns the pair of shifted (p, b) with identity fill.
    """
    p, b = x
    k = min(k, p.shape[axis])  # shift past the end -> all identity
    pad = [(0, 0)] * p.ndim
    pad[axis] = (k, 0)
    sl = [slice(None)] * p.ndim
    sl[axis] = slice(0, p.shape[axis] - k)
    ps = jnp.pad(p[tuple(sl)], pad, constant_values=1.0)
    bs = jnp.pad(b[tuple(sl)], pad, constant_values=0.0)
    return ps, bs


def _comb(lhs, rhs):
    """Compose affine ops: (rhs AFTER lhs) for inclusive scan where lhs is
    the earlier (shifted) prefix: s = p2*(p1*s+b1)+b2."""
    p1, b1 = lhs
    p2, b2 = rhs
    return p1 * p2, p2 * b1 + b2


def hillis_steele(p, u, axis, radix=2):
    """Inclusive scan of the affine recurrence via shift-and-combine
    doubling. radix=2: 1 combine/round, log2(n) rounds. radix=4: 3
    combines/round (two independent), ceil(log4(n)) rounds."""
    x = (p, u)
    n = p.shape[axis]
    k = 1
    while k < n:
        if radix == 2:
            x = _comb(_shift_right(x, k, axis), x)
            k *= 2
        else:
            s1 = _shift_right(x, k, axis)
            s2 = _shift_right(x, 2 * k, axis)
            s3 = _shift_right(x, 3 * k, axis)
            lo = _comb(s1, x)        # covers [t-2k+1 .. t]
            hi = _comb(s3, s2)       # covers [t-4k+1 .. t-2k]
            x = _comb(hi, lo)
            k *= 4
    return x


def solve_hs(p, u, s_init, radix):
    """Two-level: HS scan on the 128-lane axis, affine block-total scan on
    the superblock axis (same structure as _first_order_scan)."""
    C, T = u.shape
    B = 128 if T % 128 == 0 and T > 128 else T
    S = T // B
    pc = jnp.broadcast_to(p[None, :], (C, T)).reshape(C, S, B)
    u3 = u.reshape(C, S, B)
    cp, cb = hillis_steele(pc, u3, axis=2, radix=radix)
    if S == 1:
        return (cp * s_init[:, None, None] + cb).reshape(C, T)
    bp, bb = hillis_steele(cp[:, :, -1], cb[:, :, -1], axis=1, radix=radix)
    carry = jnp.concatenate(
        [s_init[:, None], bp[:, :-1] * s_init[:, None] + bb[:, :-1]], axis=1
    )
    return (cp * carry[:, :, None] + cb).reshape(C, T)


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


def main():
    results = {}
    dev = jax.devices()[0]
    print(f"backend={dev.platform}", flush=True)
    t0 = time.perf_counter()
    np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros(8, jnp.float32)))
    results["warmup_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"warm-up {results['warmup_seconds']} s", flush=True)

    rng = np.random.default_rng(0)
    C, T = 2, 16384
    # Ship f32 pairs and build complex on device (exactly how the
    # production biquad path does it).
    ang = 0.1 + 0.02 * np.sin(np.arange(T) * 1e-3)
    pr = jnp.asarray((0.995 * np.cos(ang)).astype(np.float32))
    pi_ = jnp.asarray((0.995 * np.sin(ang)).astype(np.float32))
    ur = jnp.asarray((rng.standard_normal((C, T)) * 0.1).astype(np.float32))
    ui = jnp.asarray((rng.standard_normal((C, T)) * 0.1).astype(np.float32))
    s0r = jnp.zeros(C, jnp.float32)

    def cplx(r, i):
        return jax.lax.complex(r, i).astype(jnp.complex64)

    # correctness vs the production scan
    def once(solver):
        def fn(pr, pi_, ur, ui, s0r):
            s = solver(cplx(pr, pi_), cplx(ur, ui), cplx(s0r, s0r * 0))
            return jnp.real(s), jnp.imag(s)
        r, i = jax.jit(fn)(pr, pi_, ur, ui, s0r)
        return np.asarray(r) + 1j * np.asarray(i)

    ref = once(_first_order_scan)
    for radix in (2, 4):
        got = once(lambda p, u, s, r=radix: solve_hs(p, u, s, r))
        err = float(np.abs(got - ref).max() / np.abs(ref).max())
        results[f"hs{radix}_relerr"] = err
        print(f"radix-{radix} relerr {err:.2e}", flush=True)

    def scan_driver(solver):
        def fn(steps, pr, pi_, ur, ui, s0r):
            p = cplx(pr, pi_)
            u = cplx(ur, ui)
            s0 = cplx(s0r, s0r * 0)

            def body(carry, _):
                s = solver(p, u * (1.0 + 1e-6 * jnp.real(carry[0])), carry)
                return s[:, -1], jnp.sum(jnp.abs(s))
            c, ys = jax.lax.scan(body, s0, None, length=steps)
            return jnp.sum(ys) + jnp.sum(jnp.abs(c))
        return fn

    args = (pr, pi_, ur, ui, s0r)
    results["scan_ms"] = round(bench(
        scan_driver(_first_order_scan), args) * 1e3, 4)
    print(f"associative_scan {results['scan_ms']} ms/solve", flush=True)
    for radix in (2, 4):
        results[f"hs{radix}_ms"] = round(bench(
            scan_driver(lambda pp, uu, ss, r=radix: solve_hs(pp, uu, ss, r)),
            args) * 1e3, 4)
        print(f"radix-{radix} {results[f'hs{radix}_ms']} ms/solve", flush=True)

    from benchmarks.artifacts import write_artifact
    write_artifact("micro_probe6", results)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
