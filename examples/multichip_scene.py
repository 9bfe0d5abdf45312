"""Multi-chip rendering demo: shard a voice scene over a device mesh.

Run: python examples/multichip_scene.py [n_devices]

Uses virtual CPU devices by default, so it runs anywhere: the same
`context.set_mesh(mesh)` call scales to several GPUs of one host, where the
bus fan-in psum rides NVLink (set GA_EXAMPLE_REAL_DEVICES=1).
"""

import sys


def main(n_devices: int = 4):
    import os

    import jax

    if not os.environ.get("GA_EXAMPLE_REAL_DEVICES"):
        # Demo default: virtual CPU devices (must be configured before the
        # backend initializes). The SPMD program is identical on real chips;
        # set GA_EXAMPLE_REAL_DEVICES=1 on a multi-GPU host.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", max(n_devices, 4))

    import numpy as np
    from jax.sharding import Mesh

    import graphaudio_tpu as ga

    sr = 48000
    rng = np.random.default_rng(11)
    devices = np.array(jax.devices()[:n_devices]).reshape(n_devices)
    mesh = Mesh(devices, axis_names=("voice",))

    ctx = ga.OfflineAudioContext(sample_rate=sr, superblock=8)
    ctx.set_mesh(mesh)

    master = ga.GainNode(ctx)
    master.gain.value = 0.5
    master.connect(ctx.destination)

    voices = n_devices * 8
    for v in range(voices):
        hz = 110.0 * (1.5 ** (v % 8))
        tone = (
            np.sin(2 * np.pi * hz * np.arange(sr) / sr)
            * np.exp(-np.arange(sr) / (0.3 * sr))
        ).astype(np.float32) * 0.1
        buf = ga.PlayableAudioBuffer.from_mono_array(tone, sr)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = buf
        src.loop = True
        g = ga.GainNode(ctx)
        g.gain.value = 0.8 / (1 + v % 4)
        src.connect(g).connect(master)
        src.start(v * 0.05)

    out = ctx.render_seconds(2.0)
    cg = ctx._compiled
    print(
        f"rendered {out.shape[1]} frames of {voices} voices over "
        f"{n_devices} devices; sharded stages: {sorted(cg.sharded_stages)}"
    )
    print(f"peak {np.abs(out).max():.3f}, rms {np.sqrt((out**2).mean()):.4f}")
    from graphaudio_tpu.io import write_wav

    write_wav("multichip_scene.wav", out, sr)
    print("wrote multichip_scene.wav")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
