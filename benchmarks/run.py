"""Run BASELINE benchmark configs: python -m benchmarks.run [--config N] [--seconds S].

Prints one JSON line per config (xRT, p50 quantum time, compile time); on a
GPU each is also written as an artifact under benchmarks/results/ with the
card it was measured on (benchmarks/artifacts.py).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from benchmarks.artifacts import write_artifact
from benchmarks.configs import CONFIGS

# Per-config superblock (quanta per device step). The biquad chain's
# associative scans have a large T-independent cost component, so config 3
# gets a much larger superblock; the convolver graphs amortize their
# per-step op chain at 64. Not yet tuned on a GPU.
SUPERBLOCKS = {3: 128, 4: 64, 5: 64}


def _xrt_compute(ctx, n_steps: int) -> float:
    """Per-step compute throughput by two-length scan difference: audio is
    consumed ON DEVICE (sum), and timing two scan lengths cancels the fixed
    per-call dispatch cost and excludes the output download."""
    import jax
    import jax.numpy as jnp

    cg = ctx._compiled
    step, _ = cg.make_step_fn()
    fps = ctx.superblock * 128

    def reduced(states, encs, consts, f0s, bts):
        def body(c, xs):
            f0, bt = xs
            ns, out = step(c, encs, consts, {}, f0, bt)
            return ns, jnp.sum(out)
        st, outs = jax.lax.scan(body, states, (f0s, bts))
        return jnp.sum(outs)

    rfn = jax.jit(reduced)
    inc = np.float64(128) / ctx.sample_rate
    states = jax.device_put(jax.device_get(ctx._states))

    def timed(n):
        f0s = jnp.arange(n, dtype=jnp.int64) * fps
        bts = np.add.accumulate(
            np.full(n * ctx.superblock, inc)
        ).reshape(n, ctx.superblock)
        np.asarray(rfn(states, ctx._encs, ctx._consts, f0s, bts))
        best = np.inf
        for _ in range(3):
            t1 = time.perf_counter()
            np.asarray(rfn(states, ctx._encs, ctx._consts, f0s, bts))
            best = min(best, time.perf_counter() - t1)
        return best

    half = max(n_steps // 2, 1)
    per_step = max((timed(n_steps) - timed(n_steps - half)) / half, 1e-9)
    return (fps / ctx.sample_rate) / per_step


def run_config(n: int, seconds: float = 30.0, compute: bool = True) -> dict:
    name, builder = CONFIGS[n]
    t0 = time.perf_counter()
    ctx = builder(superblock=SUPERBLOCKS.get(n, 32))
    frames_per_step = ctx.superblock * 128
    frames = int(seconds * ctx.sample_rate) // frames_per_step * frames_per_step
    ctx.render(frames)  # compile + warm
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = ctx.render(frames)
    wall = time.perf_counter() - t0
    rendered = out.shape[1] / ctx.sample_rate
    result = {
        "config": n,
        "name": name,
        "xrt": round(rendered / wall, 2),
        "wall_seconds": round(wall, 4),
        "rendered_seconds": rendered,
        "superblock": ctx.superblock,
        "mean_quantum_us": round(wall / (out.shape[1] // 128) * 1e6, 3),
        "compile_seconds": round(compile_s, 1),
        "output_rms": float(np.sqrt(np.mean(out.astype(np.float64) ** 2))),
    }
    if compute:
        result["xrt_compute"] = round(
            _xrt_compute(ctx, frames // frames_per_step), 2
        )
    if n == 6:
        # The point of config 6 is the COST OF MODULATION: the scene must
        # compile O(1) stages and run within ~2x of its unmodulated twin.
        result["stages"] = len(ctx._compiled.stages)
        if compute:
            from benchmarks.configs import config6_lfo_tremolo

            ctx2 = config6_lfo_tremolo(
                superblock=SUPERBLOCKS.get(6, 32), modulated=False
            )
            ctx2.render(frames)
            result["xrt_compute_unmodulated"] = round(
                _xrt_compute(ctx2, frames // frames_per_step), 2
            )
            result["stages_unmodulated"] = len(ctx2._compiled.stages)
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=0, help="config 1-6; 0 = all")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--no-artifacts", action="store_true",
                    help="skip writing benchmarks/results/config<N>.json")
    args = ap.parse_args()
    targets = [args.config] if args.config else sorted(CONFIGS)
    import jax

    backend = jax.devices()[0].platform
    for n in targets:
        result = run_config(n, args.seconds)
        result["backend"] = backend
        print(json.dumps(result), flush=True)
        if not args.no_artifacts:
            write_artifact(f"config{n}", result)


if __name__ == "__main__":
    main()
