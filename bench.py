"""Benchmark: offline render throughput on the BASELINE flagship graph.

Config 4 from BASELINE.json: 64 voices (44.1 kHz buffers, cubic-resampled to
48 kHz) -> partitioned convolver with a 2 s stereo IR -> master gain ->
destination. Prints ONE JSON line:

    {"metric": ..., "value": xRT, "unit": "x_realtime", "extra": {...}}

The value is the median xRT (seconds of audio per wall second) of the f32
``render`` of GA_BENCH_SECONDS of audio delivered to the host, over
GA_BENCH_RUNS timed runs after a warm-up. ``extra`` carries every run's
wall, the same for the int16 PCM and IMA-ADPCM delivery paths, the
on-device compute throughput (``xrt_compute``), per-step latency
percentiles, set-up + compile seconds, and the device the run used.
"""

import json
import os
import sys
import time

import numpy as np

from benchmarks.artifacts import clean_breakdown

SECONDS = float(os.environ.get("GA_BENCH_SECONDS", "30.0"))
RUNS = int(os.environ.get("GA_BENCH_RUNS", "5"))
SR = 48000
VOICES = 64
SUPERBLOCK = int(os.environ.get("GA_BENCH_SUPERBLOCK", "64"))


def build_graph():
    # THE flagship graph is BASELINE config 4 — use the one shared builder
    # (benchmarks/configs.py) so bench.py and benchmarks.run can never
    # measure subtly different topologies.
    from benchmarks.configs import config4_conv_reverb

    return config4_conv_reverb(superblock=SUPERBLOCK, voices=VOICES)


def _timed(fn, frames):
    """Median-ready list of walls for RUNS calls of ``fn(frames)``, plus
    the last call's result."""
    walls = []
    out = None
    for _ in range(RUNS):
        t0 = time.perf_counter()
        out = fn(frames)
        walls.append(time.perf_counter() - t0)
    return walls, out


def main():
    import jax

    t_setup = time.perf_counter()
    ctx = build_graph()

    frames_per_step = SUPERBLOCK * 128
    # Whole superblocks, so warm-up and timed renders reuse one compiled
    # scan length (jit retraces per scan length).
    frames = int(SECONDS * SR) // frames_per_step * frames_per_step
    # Warm-up: compile + run every delivery path once (sources loop, so
    # repeated renders are valid).
    ctx.render(frames)
    ctx.render_pcm16(frames)
    ctx.render_adpcm(frames)
    setup_s = time.perf_counter() - t_setup

    walls_f32, out = _timed(ctx.render, frames)
    breakdown = clean_breakdown(ctx.stats.last_breakdown)
    walls_pcm16, pcm = _timed(ctx.render_pcm16, frames)
    walls_adpcm, stream = _timed(ctx.render_adpcm, frames)
    rendered_seconds = frames / SR

    def xrt(walls):
        return rendered_seconds / float(np.median(walls))

    # ADPCM delivery fidelity on the flagship signal: round-trip the f32
    # render through the host encoder (bit-exact twin of the device encoder,
    # tests/test_wire.py::test_ima_device_matches_host_single_chunk).
    from graphaudio_tpu.ops import wire

    spb = wire.DEFAULT_SAMPLES_PER_BLOCK
    whole = (out.shape[1] // spb) * spb
    blocks = wire.ima_encode_np(wire.quantize_i16(out[:, :whole]), spb)
    dec = wire.ima_decode_np(blocks, out.shape[0], spb).astype(np.float64)
    dec /= 32768.0
    ref = out[:, :whole].astype(np.float64)
    adpcm_snr_db = 10.0 * np.log10(
        np.sum(ref**2) / max(np.sum((dec - ref) ** 2), 1e-30)
    )

    # Compute-only throughput: the same compiled step scanned with its audio
    # consumed ON DEVICE (one scalar out), so the device->host copy is
    # excluded. The two-length scan-difference machinery is the ONE shared
    # implementation in benchmarks.run.
    from benchmarks.run import _xrt_compute

    xrt_compute = _xrt_compute(ctx, frames // frames_per_step)

    # Latency phase: synchronized single-superblock steps give TRUE per-step
    # wall-time percentiles (the throughput render above pipelines launches,
    # so only the aggregate is observable there).
    ctx._render_steps(1)  # untimed: compiles the single-step scan length
    step_walls = []
    for _ in range(48):
        t1 = time.perf_counter()
        ctx._render_steps(1)
        step_walls.append(time.perf_counter() - t1)
    sw = np.sort(np.asarray(step_walls))
    q_us = sw / SUPERBLOCK * 1e6  # per-quantum, sorted

    device = jax.devices()[0]
    result = {
        "metric": "offline_render_xrt_64voice_reverb",
        "value": xrt(walls_f32),
        "unit": "x_realtime",
        "extra": {
            "device": {
                "platform": device.platform,
                "kind": device.device_kind,
                "count": len(jax.devices()),
            },
            "rendered_seconds": rendered_seconds,
            "wall_seconds_runs_f32": walls_f32,
            "wall_breakdown_f32": breakdown,
            "xrt_pcm16": xrt(walls_pcm16),
            "wall_seconds_runs_pcm16": walls_pcm16,
            "xrt_adpcm": xrt(walls_adpcm),
            "wall_seconds_runs_adpcm": walls_adpcm,
            "wire_bytes_pcm16": int(pcm.nbytes),
            "wire_bytes_adpcm": stream.nbytes,
            "adpcm_snr_db": adpcm_snr_db,
            "xrt_compute": xrt_compute,
            "p50_quantum_us": float(np.percentile(q_us, 50)),
            "p99_quantum_us": float(np.percentile(q_us, 99)),
            "p50_step_ms": float(np.percentile(sw, 50)) * 1e3,
            "p99_step_ms": float(np.percentile(sw, 99)) * 1e3,
            "latency_steps_timed": len(step_walls),
            "voices": VOICES,
            "ir_seconds": 2.0,
            "superblock": SUPERBLOCK,
            "setup_and_compile_seconds": setup_s,
            "output_rms": float(np.sqrt(np.mean(out.astype(np.float64) ** 2))),
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
