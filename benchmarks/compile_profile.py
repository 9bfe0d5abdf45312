"""Compile-latency profiler: where does a graph's COMPILE time go?

Usage: python -m benchmarks.compile_profile --configs 1,3,5 [--prefixes]
       [--no-warmup] [--n-steps N]

Unless --no-warmup, a trivial program executes FIRST and its wait is
reported as ``backend_warmup_seconds``: the first program of a process
absorbs the backend's one-time start-up (device and compiler
initialization), so the per-config numbers that follow are comparable
program-compile costs.

For the full render (and optionally each stage prefix) reports:
  * trace+lower seconds (JAX tracing -> StableHLO),
  * XLA compile seconds,
  * StableHLO text size (program bloat proxy — the compile-time driver).

Kernels that build large HLO at trace time inflate compile time; this tool
localizes which stage's program is outsized before attacking it.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.configs import CONFIGS


def profile_prefix(cg, ctx, n_steps, stage_limit=None):
    step, _ = cg.make_step_fn(stage_limit=stage_limit)
    states = ctx._states
    encs = ctx._encs
    consts = ctx._consts
    T = ctx.superblock * 128
    f0s = jnp.arange(n_steps, dtype=jnp.int64) * T
    inc = np.float64(128) / ctx.sample_rate
    bts = np.add.accumulate(
        np.full(n_steps * ctx.superblock, inc)
    ).reshape(n_steps, ctx.superblock)

    def render(s, e, c, f, bt):
        def body(carry, xs):
            f0, b = xs
            ns, out = step(carry, e, c, {}, f0, b)
            return ns, jnp.sum(out)

        s, outs = jax.lax.scan(body, s, (f, bt))
        return jnp.sum(outs)

    fn = jax.jit(render)
    t0 = time.perf_counter()
    lowered = fn.lower(states, encs, consts, f0s, bts)
    t_trace = time.perf_counter() - t0
    hlo_chars = len(lowered.as_text())
    t0 = time.perf_counter()
    lowered.compile()
    t_compile = time.perf_counter() - t0
    return t_trace, t_compile, hlo_chars


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=str, default="3",
                    help="comma-separated config numbers, e.g. 1,3,5")
    ap.add_argument("--n-steps", type=int, default=4)
    ap.add_argument("--prefixes", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the trivial warm-up program that absorbs the "
                         "backend's one-time start-up")
    args = ap.parse_args()

    backend = jax.devices()[0].platform
    report = {"backend": backend, "n_steps": args.n_steps, "configs": []}

    if not args.no_warmup:
        # A trivial program executed FIRST separates the backend's one-time
        # start-up from the program compiles timed below.
        t0 = time.perf_counter()
        np.asarray(jax.jit(lambda x: x + 1)(jnp.ones((8, 128))))
        report["backend_warmup_seconds"] = round(time.perf_counter() - t0, 1)
        print(f"backend warm-up (trivial program): "
              f"{report['backend_warmup_seconds']} s", flush=True)

    for n in [int(c) for c in args.configs.split(",")]:
        name, builder = CONFIGS[n]
        print(f"config {n} ({name}), scan={args.n_steps}, backend={backend}",
              flush=True)
        ctx = builder()
        ctx._drain_commands()
        ctx._ensure_compiled()
        ctx._ensure_params_encoded()
        cg = ctx._compiled
        entry = {"config": n, "name": name, "stages": []}

        limits = (
            list(range(1, len(cg.plan) + 1)) if args.prefixes else [None]
        )
        prev_c = prev_h = 0.0
        for k in limits:
            tr, tc, hc = profile_prefix(cg, ctx, args.n_steps, k)
            if k is None:
                entry.update(trace_s=round(tr, 2), compile_s=round(tc, 2),
                             hlo_mb=round(hc / 1e6, 2))
                print(f"FULL    trace {tr:7.1f}s  compile {tc:7.1f}s  "
                      f"hlo {hc/1e6:8.2f} MB", flush=True)
            else:
                sp = cg.plan[k - 1]
                label = (f"{sp['kind']}:{type(sp['rep']).__name__}"
                         f" x{sp['n_lanes']}")
                entry["stages"].append({
                    "prefix": k, "stage": label,
                    "trace_s": round(tr, 2), "compile_s": round(tc, 2),
                    "compile_delta_s": round(tc - prev_c, 2),
                    "hlo_mb": round(hc / 1e6, 2),
                })
                print(f"1..{k:2d}  trace {tr:6.1f}s  compile {tc:7.1f}s "
                      f"(+{tc - prev_c:7.1f})  hlo {hc/1e6:7.2f} MB "
                      f"(+{(hc - prev_h)/1e6:6.2f})  {label}", flush=True)
                prev_c, prev_h = tc, hc
        if not entry["stages"]:
            del entry["stages"]
        report["configs"].append(entry)

    from benchmarks.artifacts import write_artifact

    write_artifact("compile_profile", report)


if __name__ == "__main__":
    main()
