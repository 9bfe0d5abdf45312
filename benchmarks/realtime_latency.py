"""Realtime-path latency/underrun benchmark.

The reference's design brief is "never underrun" (RealtimeAudioContext.cs:
render thread at Highest priority, GC-free device callback, ring = 5x the
device period). This benchmark measures whether the device render path can
hold a real-time deadline:

  * per-step render wall time (launch + finish) percentiles vs the step's
    audio deadline (superblock * 128 / sample_rate),
  * device-side underrun frames from the native consumer thread, which
    drains the ring in real time (null backend) or plays real hardware
    (alsa backend when libasound is present),
  * ring occupancy at each step boundary.

Usage: python -m benchmarks.realtime_latency [seconds] [voices] [device]

Prints one JSON line. Each render step pays a fixed host-device round
trip, so the realtime budget only closes with superblocks whose audio
duration exceeds it; the JSON reports both so the tradeoff is visible.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main():
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 5.0
    voices = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    device = sys.argv[3] if len(sys.argv) > 3 else "auto"

    import graphaudio_tpu as ga
    from graphaudio_tpu.realtime.context import RealtimeAudioContext

    SR = 48000
    # auto_tune measures the per-step round trip at startup and picks the
    # smallest superblock whose audio duration clears it (plus a ring
    # holding 2.5 steps).
    ctx = RealtimeAudioContext(
        sample_rate=SR, channels=2, device=device,
        auto_tune=True, auto_start_thread=False,
    )
    rng = np.random.default_rng(7)
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.05).astype(np.float32)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        src.connect(ctx.destination)
        src.start(0)

    frames_per_step = ctx.superblock * 128
    deadline_s = frames_per_step / SR

    # Warm up / compile outside the timed phase.
    ctx._render_steps(1)
    ctx.ring.write_interleaved(
        np.zeros((frames_per_step, 2), np.float32)
    )

    step_walls = []
    occupancy = []
    ctx.start()
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        if ctx.ring.available_write() >= frames_per_step:
            t0 = time.perf_counter()
            out = ctx._render_steps(1)
            step_walls.append(time.perf_counter() - t0)
            ctx.ring.write_interleaved(np.ascontiguousarray(out.T))
            occupancy.append(ctx.ring.available_read())
        else:
            ctx.ring.wait_for_space(frames_per_step, 5)
    played = ctx.frames_played
    under = ctx.underrun_frames
    backend = ctx.device_backend
    ctx.stop()
    ctx.dispose()

    sw = np.sort(np.asarray(step_walls))

    def pct(q):
        return float(np.percentile(sw, q)) if len(sw) else 0.0

    result = {
        "metric": "realtime_underrun_frames",
        "value": int(under),
        "unit": "frames",
        "extra": {
            "device_backend": backend,
            "seconds": seconds,
            "voices": voices,
            "superblock": ctx.superblock,
            "tuned_rtt_ms": (
                round(ctx.tuned_rtt_s * 1e3, 3) if ctx.tuned_rtt_s else None
            ),
            "frames_played": int(played),
            "underrun_pct": round(100.0 * under / max(played, 1), 4),
            "deadline_ms": round(deadline_s * 1e3, 3),
            "p50_step_ms": round(pct(50) * 1e3, 3),
            "p99_step_ms": round(pct(99) * 1e3, 3),
            "max_step_ms": round(float(sw[-1]) * 1e3, 3) if len(sw) else 0.0,
            "steps_over_deadline": int(np.sum(sw > deadline_s)),
            "steps_timed": len(sw),
            "mean_ring_occupancy_frames": (
                round(float(np.mean(occupancy)), 1) if occupancy else 0.0
            ),
        },
    }
    print(json.dumps(result))
    # write_artifact gates on the JAX platform (`backend` above is the
    # AUDIO device backend — 'alsa'/'null' — never 'cpu').
    from benchmarks.artifacts import write_artifact

    write_artifact("realtime_latency", result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
