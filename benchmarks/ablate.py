"""Stage-prefix ablation profiler: where does a graph's step time go?

Usage: python -m benchmarks.ablate [config_number] [n_steps]

Times the compiled step scanned over n_steps superblocks, truncated to the
first k stages for k = 1..len(plan). The marginal time between consecutive
prefixes is each stage's cost. Cumulative values include the per-call
dispatch amortized over n_steps; MARGINALS cancel it and are the
trustworthy numbers. Measurement rules: sync on a value that depends on all
work (stage_limit probes return a sum of every output), and pass
encodings/constants as ARGUMENTS (closure constants let XLA fold the code
under test away).
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks.configs import CONFIGS


def ablate(ctx, n_steps=64, reps=1):
    ctx._drain_commands()
    ctx._ensure_compiled()
    ctx._ensure_params_encoded()
    cg = ctx._compiled
    states = jax.device_put(ctx._states)
    encs = jax.device_put(ctx._encs)
    consts = jax.device_put(cg.consts)
    T = ctx.superblock * 128
    f0s = jnp.arange(n_steps, dtype=jnp.int64) * T
    results = []
    prev = 0.0
    for k in range(1, len(cg.plan) + 1):
        step, _ = cg.make_step_fn(stage_limit=k)

        def render(s, e, c, f):
            def body(carry, f0):
                ns, out = step(carry, e, c, {}, f0)
                return ns, jnp.sum(out)
            s, outs = jax.lax.scan(body, s, f)
            return jnp.sum(outs)

        fn = jax.jit(render)
        np.asarray(jax.device_get(fn(states, encs, consts, f0s)))  # compile
        t0 = time.perf_counter()
        for _ in range(reps):
            np.asarray(jax.device_get(fn(states, encs, consts, f0s)))
        ms = (time.perf_counter() - t0) / reps / n_steps * 1e3
        sp = cg.plan[k - 1]
        label = f"{sp['kind']}:{type(sp['rep']).__name__} x{sp['n_lanes']}"
        results.append((k, label, ms, ms - prev))
        print(f"stages 1..{k:2d}  {ms:9.3f} ms/step  (+{ms - prev:8.3f})  {label}")
        prev = ms
    return results


def main():
    from benchmarks.run import SUPERBLOCKS

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    name, builder = CONFIGS[n]
    backend = jax.devices()[0].platform
    sb = SUPERBLOCKS.get(n, 32)  # the tuning run.py ships for this config
    print(f"config {n} ({name}), {n_steps}-step scans, SB={sb}, "
          f"backend={backend}")
    results = ablate(builder(superblock=sb), n_steps)
    from benchmarks.artifacts import write_artifact

    write_artifact(f"ablate_config{n}", {
        "config": n,
        "name": name,
        "n_steps": n_steps,
        "superblock": sb,
        "backend": backend,
        "stages": [
            {"prefix": k, "stage": label, "cum_ms_per_step": round(ms, 4),
             "marginal_ms_per_step": round(d, 4)}
            for k, label, ms, d in results
        ],
    })


if __name__ == "__main__":
    main()
