"""The six BASELINE.json benchmark configurations.

Each builder returns an OfflineAudioContext (graph fully wired and scheduled).
``python -m benchmarks.run`` renders them and reports xRT per config.
Configs 4 and 5 also build an oracle twin (``configN_oracle``) from the same
seeded arrays (``configN_arrays``), so a render can be checked against the
independent numpy reference at any width.
"""

from __future__ import annotations

import numpy as np

import graphaudio_tpu as ga
from graphaudio_tpu.kit import AudioEngine, ReverbEffect, SoundMixState
from graphaudio_tpu.ops.hrtf import build_hrir_grid
from graphaudio_tpu.testing.oracle import (
    OracleBufferSource,
    OracleContext,
    OracleConvolver,
    OracleGain,
    OracleSpatialPanner,
)

SR = 48000


def config1_buffer_gain(superblock=32):
    """1 AudioBufferSource -> GainNode -> destination, 30 s stereo."""
    rng = np.random.default_rng(1)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    n = 30 * SR
    buf = ga.PlayableAudioBuffer.from_stereo_arrays(
        (rng.standard_normal(n) * 0.3).astype(np.float32),
        (rng.standard_normal(n) * 0.3).astype(np.float32),
        SR,
    )
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = buf
    g = ga.GainNode(ctx)
    g.gain.value = 0.8
    src.connect(g).connect(ctx.destination)
    src.start(0)
    return ctx


def config2_mix_bus(superblock=32, voices=8):
    """8-voice mix bus with linear/exponential AudioParam ramps."""
    rng = np.random.default_rng(2)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    for v in range(voices):
        sig = (rng.standard_normal(2 * SR) * 0.1).astype(np.float32)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = ga.GainNode(ctx)
        for t in range(0, 30, 2):
            g.gain.set_value_at_time(0.05, float(t))
            if v % 2 == 0:
                g.gain.linear_ramp_to_value_at_time(0.8, t + 1.0)
            else:
                g.gain.exponential_ramp_to_value_at_time(0.8, t + 1.0)
        src.connect(g).connect(ctx.destination)
        src.start(0)
    return ctx


def config3_eq_chain(superblock=32):
    """4 cascaded biquads with automated frequency/Q."""
    rng = np.random.default_rng(3)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    sig = (rng.standard_normal(2 * SR) * 0.2).astype(np.float32)
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(sig, sig[::-1].copy(), SR)
    src.loop = True
    node = src
    types = [
        ga.FilterType.LOWPASS,
        ga.FilterType.PEAKING,
        ga.FilterType.PEAKING,
        ga.FilterType.HIGHPASS,
    ]
    for i, t in enumerate(types):
        flt = ga.BiQuadFilterNode(ctx, type=t)
        flt.gain.value = 3.0 if t == ga.FilterType.PEAKING else 0.0
        for sec in range(0, 30, 3):
            flt.frequency.set_value_at_time(200.0 * (i + 1), float(sec))
            flt.frequency.linear_ramp_to_value_at_time(
                2000.0 * (i + 1), sec + 2.5
            )
            flt.q.set_value_at_time(0.5, float(sec))
            flt.q.linear_ramp_to_value_at_time(4.0, sec + 2.5)
        node = node.connect(flt)
    node.connect(ctx.destination)
    src.start(0)
    return ctx


def config4_arrays(voices=64):
    """Config 4's data from its seed: a 2 s stereo IR and one 2 s 44.1 kHz
    signal per voice. The graph and its oracle twin both build from these."""
    rng = np.random.default_rng(4)
    ir_len = 2 * SR
    decay = np.exp(-np.arange(ir_len) / (0.4 * SR))
    ir = np.stack(
        [(rng.standard_normal(ir_len) * decay).astype(np.float32) for _ in range(2)]
    )
    sigs = [
        (rng.standard_normal(2 * 44100) * 0.05).astype(np.float32)
        for _ in range(voices)
    ]
    return {"ir": ir, "sigs": sigs}


def config4_conv_reverb(superblock=32, voices=64, arrays=None):
    """64 voices -> cubic resampler (44.1->48k) -> 2 s IR convolver -> gain."""
    arrays = arrays if arrays is not None else config4_arrays(voices)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    master = ga.GainNode(ctx)
    master.gain.value = 0.5
    conv = ga.ConvolverNode(ctx)
    conv.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(
        arrays["ir"][0], arrays["ir"][1], SR
    )
    conv.connect(master).connect(ctx.destination)
    for sig in arrays["sigs"]:
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0  # resampler path
        src.connect(conv)
        src.start(0)
    return ctx


def config4_oracle(arrays):
    """Config 4 built on the numpy oracle from the same arrays."""
    octx = OracleContext(sample_rate=SR)
    master = OracleGain(octx)
    master.gain.value = 0.5
    conv = OracleConvolver(octx)
    conv.set_buffer(arrays["ir"], SR)
    conv.connect(master).connect(octx.destination)
    for sig in arrays["sigs"]:
        src = OracleBufferSource(octx)
        src.set_buffer(sig, 44100)
        src.loop = True
        src.playback_rate.value = 1.0
        src.connect(conv)
        src.start(0)
    return octx


def config5_arrays(voices=128):
    """Config 5's data from its seed: a 1 s mono reverb IR and one 1 s
    signal per voice."""
    rng = np.random.default_rng(5)
    ir = (
        rng.standard_normal(SR) * np.exp(-np.arange(SR) / (0.25 * SR))
    ).astype(np.float32)
    sigs = [
        (rng.standard_normal(SR) * 0.03).astype(np.float32) for _ in range(voices)
    ]
    return {"ir": ir, "sigs": sigs}


def _config5_position(v, voices):
    angle = 2 * np.pi * v / voices
    return (5 * np.cos(angle), 0.0, 5 * np.sin(angle))


def config5_spatial_scene(superblock=32, voices=128, arrays=None):
    """128 moving spatialized sources with a shared reverb send
    (Kit AudioBus / EffectChain topology)."""
    arrays = arrays if arrays is not None else config5_arrays(voices)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    engine = AudioEngine(ctx)
    engine.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])

    sfx = engine.get_bus("sfx")
    rev = ReverbEffect(engine)
    rev.set_impulse_response(ga.PlayableAudioBuffer.from_mono_array(arrays["ir"], SR))
    rev.wet.value = 0.3
    sfx.effects.add(rev)

    sounds = []
    for v, sig in enumerate(arrays["sigs"]):
        buf = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        s = engine.create_sound_from_buffer(
            buf, mix_state=SoundMixState.BINAURAL_SPATIALIZED, bus=sfx
        )
        s.is_looping = True
        s.position = _config5_position(v, len(arrays["sigs"]))
        s.play()
        sounds.append(s)
    ctx._engine = engine  # keep alive; callers may move sounds via engine
    ctx._sounds = sounds
    return ctx


def config5_oracle(arrays):
    """Config 5's Kit graph spelled out node by node on the numpy oracle:
    per sound source -> gain -> spatial panner -> sfx bus; the bus runs the
    ReverbEffect (split -> dry / mono downmix -> convolver -> wet -> merge)
    into the master bus and the destination."""
    octx = OracleContext(sample_rate=SR)
    octx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
    master = OracleGain(octx)
    master.connect(octx.destination)
    sfx = OracleGain(octx)
    split, merge, dry, wet, down = (OracleGain(octx) for _ in range(5))
    down.inputs[0].channel_count = 1
    down.inputs[0].mode = "explicit"
    conv = OracleConvolver(octx)
    conv.set_buffer(arrays["ir"], SR)
    wet.gain.value = 0.3
    split.connect(dry).connect(merge)
    split.connect(down).connect(conv)
    conv.connect(wet).connect(merge)
    sfx.connect(split)
    merge.connect(master)

    grid = build_hrir_grid(SR)
    for v, sig in enumerate(arrays["sigs"]):
        gain = OracleGain(octx)
        pan = OracleSpatialPanner(octx, grid)
        gain.connect(pan).connect(sfx)
        x, y, z = _config5_position(v, len(arrays["sigs"]))
        pan.position_x.value = x
        pan.position_y.value = y
        pan.position_z.value = z
        src = OracleBufferSource(octx)
        src.set_buffer(sig, SR)
        src.loop = True
        src.connect(gain)
        src.start(0)
    return octx


def config6_lfo_tremolo(superblock=32, voices=64, modulated=True):
    """64 voices with PER-VOICE LFO -> gain modulation (tremolo / ducking —
    bread-and-butter Web Audio, AudioParam.cs:66-70). Exercises modulated-
    param voice batching: the scene must compile O(1) stages (mod signature
    in group_key + per-lane mod routing), not one stage per voice.
    ``modulated=False`` builds the same scene with the LFO->depth chains
    kept but routed to a silent audio sink instead of the params — the
    xrt_compute ratio between the two isolates the MODULATION PLUMBING
    (per-lane mod stacking + clamp), not the oscillators' own cost."""
    rng = np.random.default_rng(6)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    master = ga.GainNode(ctx)
    master.gain.value = 1.0 / voices
    master.connect(ctx.destination)
    sink = None
    if not modulated:
        sink = ga.GainNode(ctx)
        sink.gain.value = 0.0
        sink.connect(master)
    for v in range(voices):
        sig = (rng.standard_normal(SR) * 0.2).astype(np.float32)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
        src.loop = True
        g = ga.GainNode(ctx)
        g.gain.value = 0.6
        lfo = ga.OscillatorNode(ctx)
        lfo.frequency.value = 1.0 + 0.25 * v  # per-voice tremolo rate
        depth = ga.GainNode(ctx)
        depth.gain.value = 0.35
        lfo.connect(depth)
        depth.connect(g.gain if modulated else sink)
        lfo.start(0)
        src.connect(g).connect(master)
        src.start(0)
    return ctx


CONFIGS = {
    1: ("buffer_gain", config1_buffer_gain),
    2: ("mix_bus_ramps", config2_mix_bus),
    3: ("biquad_eq_chain", config3_eq_chain),
    4: ("conv_reverb_64", config4_conv_reverb),
    5: ("spatial_scene_128", config5_spatial_scene),
    6: ("lfo_tremolo_64", config6_lfo_tremolo),
}
