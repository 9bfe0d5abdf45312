"""Micro-probe 5: config-5 superblock sweep on current kernels.

The superblock question for config 5: the per-step fixed op-chain
overheads amortize over 2x audio at SB=64 while the convolver's partition
count halves. Measures xrt_compute (the
artifact metric) per superblock. Writes
benchmarks/results/micro_probe5.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from benchmarks.configs import CONFIGS
from benchmarks.run import _xrt_compute


def main():
    results = {}
    dev = jax.devices()[0]
    print(f"backend={dev.platform}", flush=True)
    t0 = time.perf_counter()
    np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros(8, jnp.float32)))
    results["warmup_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"warm-up {results['warmup_seconds']} s", flush=True)

    name, builder = CONFIGS[5]
    for sb in (32, 64, 96):
        t0 = time.perf_counter()
        ctx = builder(superblock=sb)
        fps = sb * 128
        frames = int(30.0 * ctx.sample_rate) // fps * fps
        ctx.render(frames)  # compile + warm
        compile_s = round(time.perf_counter() - t0, 1)
        xrt = round(_xrt_compute(ctx, frames // fps), 2)
        results[f"sb{sb}_xrt_compute"] = xrt
        results[f"sb{sb}_compile_seconds"] = compile_s
        print(f"SB={sb}: xrt_compute={xrt} (compile {compile_s}s)", flush=True)

    from benchmarks.artifacts import write_artifact
    write_artifact("micro_probe5", results)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
