"""Micro-probe 3: where does the unity source group's step time go?

The fused row gather is a small part of the whole stage's cost (ablate,
config 5); the rest is position bookkeeping, activity masks, and per-op
overhead. This probe times the
REAL `process_unity_group` on config 5's actual arena/geometry, then
stripped variants, so the gap gets attributed before anything is
"optimized".

Measurement rules as kernels_config5.py: two-length scan difference, carry
evolves, operands as arguments, every wait is a device_get.

Writes benchmarks/results/micro_probe3.json.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

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


def main():
    from benchmarks.configs import CONFIGS
    from graphaudio_tpu.nodes.sources import AudioBufferSourceNode
    from graphaudio_tpu.core.graph import RenderContext

    results = {}
    dev = jax.devices()[0]
    print(f"backend={dev.platform}", flush=True)
    t0 = time.perf_counter()
    np.asarray(jax.jit(lambda x: x + 1)(jnp.zeros(8, jnp.float32)))
    results["warmup_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"warm-up {results['warmup_seconds']} s", flush=True)

    # Real config-5 source stage: arena, geometry, stacked states.
    ctx = CONFIGS[5][1]()
    ctx._ensure_compiled()
    cg = ctx._compiled
    si = next(
        sp["si"] for sp in cg.plan
        if sp["bufsrc"] is not None and sp["bufsrc"][1][0] == "unity"
    )
    sp = next(p for p in cg.plan if p["si"] == si)
    w, variant, _ = sp["bufsrc"]
    aligned = variant[1]
    arena = jnp.asarray(cg.consts[f"st{si}/arena"])
    geom = {k: jnp.asarray(v) for k, v in cg.consts[f"st{si}/geom"].items()}
    states0 = jax.tree_util.tree_map(
        jnp.asarray, cg.init_states()[f"st{si}"]
    )
    # start everything at t=0 the way render does
    states0 = dict(states0)
    states0["started"] = jnp.ones_like(states0["started"])
    states0["start_time"] = jnp.zeros_like(states0["start_time"])
    info = cg.info
    S = info.superblock
    V = geom["off"].shape[0]
    print(f"stage st{si}: V={V} aligned={aligned} w={w} "
          f"arena={arena.shape} S={S}", flush=True)

    inc = np.float64(F) / info.sample_rate

    def scan_over(kernel):
        def fn(steps, states, arena, geom):
            def body(carry, xs):
                st, frame0, t0 = carry
                bts = t0 + jnp.arange(S, dtype=jnp.float64) * inc
                rc = RenderContext(info, frame0, bts)
                st, out = kernel(st, arena, geom, rc)
                return (st, frame0 + S * F, t0 + S * inc), jnp.sum(out)
            (st, _, _), outs = jax.lax.scan(
                body, (states, jnp.int64(0), jnp.float64(0.0)),
                None, length=steps)
            return jnp.sum(outs) + jax.tree_util.tree_reduce(
                lambda a, x: a + jnp.sum(x.astype(jnp.float32)),
                st, jnp.float32(0.0))
        return fn

    # ---- a) the real kernel ------------------------------------------------
    def full(st, arena, geom, rc):
        return AudioBufferSourceNode.process_unity_group(
            st, arena, geom, rc, w, aligned=aligned)

    results["full_ms"] = round(
        bench(scan_over(full), (states0, arena, geom)) * 1e3, 4)
    print(f"full {results['full_ms']} ms/step", flush=True)

    # ---- b) gather only (pos evolves, no masks/clears) ---------------------
    def gather_only(st, arena, geom, rc):
        S_ = rc.superblock
        C = arena.shape[0]
        i32 = jnp.int32
        lef, lsf, llen = geom["lef"], geom["lsf"], geom["llen"]
        looping = geom["looping"]
        p0 = st["pos"]
        qmod = jnp.mod(p0 - lsf, jnp.maximum(llen, 1.0))
        e0 = jnp.where(looping & (p0 >= lsf), lsf + llen + qmod, p0)
        hi = (geom["region_len"].astype(i32) - w) // F * F
        start = jnp.clip(e0.astype(i32), 0, hi)
        W = arena.shape[1]
        rows = arena.reshape(C, W // F, F)
        row0 = (geom["off"] + geom["front"] + start) // F
        bidx = jnp.arange(S_, dtype=i32)
        ridx = jnp.clip(row0[:, None] + bidx[None, :], 0, W // F - 1)
        samples = jnp.moveaxis(jnp.take(rows, ridx, axis=1), 0, 1)
        new_pos = p0 + np.float64(S_ * F)
        new_pos = jnp.where(
            looping & (new_pos >= lef),
            lsf + jnp.mod(new_pos - lef, jnp.maximum(llen, 1.0)), new_pos)
        st = dict(st); st["pos"] = new_pos
        return st, samples.reshape(geom["off"].shape[0], C, rc.frames)

    results["gather_only_ms"] = round(
        bench(scan_over(gather_only), (states0, arena, geom)) * 1e3, 4)
    print(f"gather_only {results['gather_only_ms']} ms/step", flush=True)

    # ---- c) full minus the f64 per-block position ladder -------------------
    # (all blocks active: delta_b = s*F exactly; bidx = s)
    def no_posladder(st, arena, geom, rc):
        S_ = rc.superblock
        C = arena.shape[0]
        V_ = geom["off"].shape[0]
        i32 = jnp.int32
        active = AudioBufferSourceNode._active_mask(st, rc)
        length, rate = geom["length"], geom["rate"]
        de = AudioBufferSourceNode._duration_end(st, rate, length)
        lef, lsf, llen = geom["lef"], geom["lsf"], geom["llen"]
        looping, loop_flag = geom["looping"], geom["loop_flag"]
        p0 = st["pos"]
        qmod = jnp.mod(p0 - lsf, jnp.maximum(llen, 1.0))
        e0 = jnp.where(looping & (p0 >= lsf), lsf + llen + qmod, p0)
        hi = (geom["region_len"].astype(i32) - w) // F * F
        start = jnp.clip(e0.astype(i32), 0, hi)
        W = arena.shape[1]
        rows = arena.reshape(C, W // F, F)
        row0 = (geom["off"] + geom["front"] + start) // F
        bidx = jnp.arange(S_, dtype=i32)
        ridx = jnp.clip(row0[:, None] + bidx[None, :], 0, W // F - 1)
        samples = jnp.moveaxis(jnp.take(rows, ridx, axis=1), 0, 1)
        i = jnp.arange(F, dtype=i32)
        g = (p0.astype(i32)[:, None, None]
             + (bidx * F)[None, :, None] + i[None, None, :])
        end_bound = jnp.where(
            loop_flag, jnp.minimum(lef.astype(i32), de.astype(i32)),
            de.astype(i32))
        valid = jnp.where(looping[:, None, None], jnp.bool_(True),
                          g < end_bound[:, None, None])
        out = jnp.where((active[:, :, None] & valid)[:, None], samples, 0.0)
        new_pos = p0 + np.float64(S_ * F)
        new_pos = jnp.where(
            looping & (new_pos >= lef),
            lsf + jnp.mod(new_pos - lef, jnp.maximum(llen, 1.0)), new_pos)
        st = dict(st); st["pos"] = new_pos
        return st, out.reshape(V_, C, rc.frames)

    results["no_posladder_ms"] = round(
        bench(scan_over(no_posladder), (states0, arena, geom)) * 1e3, 4)
    print(f"no_posladder {results['no_posladder_ms']} ms/step", flush=True)

    # ---- d) block-grain masks only (no per-sample valid grid) --------------
    def block_masks(st, arena, geom, rc):
        st2, samples = gather_only(st, arena, geom, rc)
        active = AudioBufferSourceNode._active_mask(st, rc)  # [V, S]
        V_ = geom["off"].shape[0]
        C = arena.shape[0]
        out = samples.reshape(V_, C, rc.superblock, F)
        out = jnp.where(active[:, None, :, None], out, 0.0)
        return st2, out.reshape(V_, C, rc.frames)

    results["block_masks_ms"] = round(
        bench(scan_over(block_masks), (states0, arena, geom)) * 1e3, 4)
    print(f"block_masks {results['block_masks_ms']} ms/step", flush=True)

    from benchmarks.artifacts import write_artifact
    write_artifact("micro_probe3", results)
    print(json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
