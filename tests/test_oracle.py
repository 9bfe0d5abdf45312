"""Whole-graph comparison against the independent numpy oracle.

The oracle (graphaudio_tpu/testing/oracle.py) implements the reference's
per-block pull semantics literally — per-sample automation walk, streaming
CubicResampler, sequential f32 biquad, partitioned convolver with a
frequency-domain delay line — and shares no code with the JAX renderer.

Each test builds the same graph in both systems (structurally identical to
the BASELINE.json benchmark configs, at reduced duration/voice counts so the
deliberately slow oracle stays test-sized) and asserts sample-level
agreement. Tolerances reflect unavoidable f32 reassociation between the
sequential reference arithmetic and the renderer's batched forms; they are far
below audibility and catch any semantic divergence (wrong event boundary,
off-by-one position, wrong mixing rule) which shows up at 1e-2+.
"""

import numpy as np
import pytest

import graphaudio_tpu as ga
from graphaudio_tpu.testing.oracle import (
    OracleBiQuad,
    OracleBufferSource,
    OracleConvolver,
    OracleContext,
    OracleGain,
)

SR = 48000


def render_both(build, frames):
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=8)
    octx = OracleContext(sample_rate=SR)
    build(ctx, ga_api=True)
    build(octx, ga_api=False)
    got = np.asarray(ctx.render(frames))
    want = octx.render(frames)
    assert got.shape == want.shape, (got.shape, want.shape)
    return got, want


def test_config1_buffer_gain(rng):
    """BASELINE config 1: stereo source -> gain -> destination (bit-exact:
    the unity path is a copy and the gain is an elementwise f32 multiply)."""
    n = SR  # 1 s
    left = (rng.standard_normal(n) * 0.3).astype(np.float32)
    right = (rng.standard_normal(n) * 0.3).astype(np.float32)

    def build(ctx, ga_api):
        if ga_api:
            src = ga.AudioBufferSourceNode(ctx)
            src.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(
                left, right, SR
            )
            g = ga.GainNode(ctx)
            g.gain.value = 0.8
            src.connect(g).connect(ctx.destination)
            src.start(0)
        else:
            src = OracleBufferSource(ctx)
            src.set_buffer(np.stack([left, right]), SR)
            g = OracleGain(ctx)
            g.gain.value = 0.8
            src.connect(g).connect(ctx.destination)
            src.start(0)

    got, want = render_both(build, frames=SR // 2)
    assert np.max(np.abs(got - want)) == 0.0


def test_config2_mix_bus_ramps(rng):
    """BASELINE config 2: 8-voice mix bus, linear + exponential gain ramps."""
    voices = 8
    sigs = [(rng.standard_normal(SR // 2) * 0.1).astype(np.float32)
            for _ in range(voices)]

    def build(ctx, ga_api):
        for v in range(voices):
            if ga_api:
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(
                    sigs[v], SR
                )
                g = ga.GainNode(ctx)
                gain = g.gain
            else:
                src = OracleBufferSource(ctx)
                src.set_buffer(sigs[v], SR)
                g = OracleGain(ctx)
                gain = g.gain
            src.loop = True
            for t8 in range(0, 8):  # events every 1/8 s
                t = t8 / 8.0
                gain.set_value_at_time(0.05, t)
                if v % 2 == 0:
                    gain.linear_ramp_to_value_at_time(0.8, t + 1 / 16.0)
                else:
                    gain.exponential_ramp_to_value_at_time(0.8, t + 1 / 16.0)
            src.connect(g).connect(ctx.destination)
            src.start(0)

    got, want = render_both(build, frames=SR // 2)
    assert np.max(np.abs(got - want)) < 1e-6


def test_config3_biquad_eq_chain(rng):
    """BASELINE config 3: 4 cascaded biquads with automated frequency/Q."""
    sig = (rng.standard_normal(SR // 2) * 0.2).astype(np.float32)
    types_ga = [ga.FilterType.LOWPASS, ga.FilterType.PEAKING,
                ga.FilterType.PEAKING, ga.FilterType.HIGHPASS]
    types_o = ["lowpass", "peaking", "peaking", "highpass"]

    def build(ctx, ga_api):
        if ga_api:
            src = ga.AudioBufferSourceNode(ctx)
            src.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(
                sig, sig[::-1].copy(), SR
            )
            node = src
            types = types_ga
            mk = lambda t: ga.BiQuadFilterNode(ctx, type=t)  # noqa: E731
        else:
            src = OracleBufferSource(ctx)
            src.set_buffer(np.stack([sig, sig[::-1]]), SR)
            node = src
            types = types_o
            mk = lambda t: OracleBiQuad(ctx, type=t)  # noqa: E731
        src.loop = True
        for i, t in enumerate(types):
            flt = mk(t)
            peaking = (t == ga.FilterType.PEAKING) if ga_api \
                else (t == "peaking")
            flt.gain.value = 3.0 if peaking else 0.0
            for s8 in range(0, 4):
                sec = s8 / 8.0
                flt.frequency.set_value_at_time(200.0 * (i + 1), sec)
                flt.frequency.linear_ramp_to_value_at_time(
                    2000.0 * (i + 1), sec + 0.1
                )
                flt.q.set_value_at_time(0.5, sec)
                flt.q.linear_ramp_to_value_at_time(4.0, sec + 0.1)
            node = node.connect(flt)
        node.connect(ctx.destination)
        src.start(0)

    got, want = render_both(build, frames=SR // 2)
    assert np.max(np.abs(got - want)) < 2e-4  # IIR reassociation drift


def test_config4_conv_reverb(rng):
    """BASELINE config 4 (reduced): 8 voices -> 44.1k->48k cubic resampler
    -> partitioned convolver (0.25 s stereo IR) -> master gain."""
    voices = 8
    ir_len = SR // 4
    decay = np.exp(-np.arange(ir_len) / (0.05 * SR))
    ir_l = (rng.standard_normal(ir_len) * decay).astype(np.float32)
    ir_r = (rng.standard_normal(ir_len) * decay).astype(np.float32)
    sigs = [(rng.standard_normal(22050) * 0.05).astype(np.float32)
            for _ in range(voices)]

    def build(ctx, ga_api):
        if ga_api:
            master = ga.GainNode(ctx)
            master.gain.value = 0.5
            conv = ga.ConvolverNode(ctx)
            conv.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(
                ir_l, ir_r, SR
            )
            conv.connect(master).connect(ctx.destination)
            for v in range(voices):
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(
                    sigs[v], 44100
                )
                src.loop = True
                src.playback_rate.value = 1.0
                src.connect(conv)
                src.start(0)
        else:
            master = OracleGain(ctx)
            master.gain.value = 0.5
            conv = OracleConvolver(ctx)
            conv.set_buffer(np.stack([ir_l, ir_r]), SR)
            conv.connect(master).connect(ctx.destination)
            for v in range(voices):
                src = OracleBufferSource(ctx)
                src.set_buffer(sigs[v], 44100)
                src.loop = True
                src.playback_rate.value = 1.0
                src.connect(conv)
                src.start(0)

    got, want = render_both(build, frames=SR // 4)
    scale = max(1.0, float(np.max(np.abs(want))))
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_resampler_nonloop_tail_matches_oracle(rng):
    """Resample path without looping: end-of-buffer starvation, auto-stop."""
    sig = (rng.standard_normal(8000) * 0.3).astype(np.float32)

    def build(ctx, ga_api):
        if ga_api:
            src = ga.AudioBufferSourceNode(ctx)
            src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, 44100)
            src.playback_rate.value = 1.0
            src.connect(ctx.destination)
            src.start(0)
        else:
            src = OracleBufferSource(ctx)
            src.set_buffer(sig, 44100)
            src.playback_rate.value = 1.0
            src.connect(ctx.destination)
            src.start(0)

    got, want = render_both(build, frames=SR // 4)
    assert np.max(np.abs(got - want)) < 1e-6


def test_grouped_time_varying_playback_rate(rng):
    """Several voices with SCHEDULED playbackRate changes (the general
    time-varying resample path, grouped) against the oracle's streaming
    CubicResampler with per-block k-rate evaluation."""
    voices = 3
    sigs = [(rng.standard_normal(30000) * 0.3).astype(np.float32)
            for _ in range(voices)]

    def build(ctx, ga_api):
        for v in range(voices):
            if ga_api:
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(sigs[v], SR)
                pr = src.playback_rate
            else:
                src = OracleBufferSource(ctx)
                src.set_buffer(sigs[v], SR)
                pr = src.playback_rate
            src.loop = True
            # rates stay strictly above 1.0: at exactly 1.0 the reference
            # hops to its unity COPY path for that block (one sample earlier
            # than the resampler) — a documented deviation (PARITY.md).
            pr.set_value_at_time(1.03 + 0.1 * v, 0.0)
            pr.linear_ramp_to_value_at_time(1.29, 0.25)
            src.connect(ctx.destination)
            src.start(0)

    got, want = render_both(build, frames=SR // 4)
    assert np.max(np.abs(got - want)) < 1e-5


def test_config5_structural_panned_scene(rng):
    """BASELINE config 5's GRAPH SHAPE at oracle scale: many mono voices ->
    per-voice equal-power panners -> shared master gain -> destination.

    The spatializer itself cannot be oracle-checked: the reference delegates
    HRTF rendering to the closed-source phonon library, which this framework
    substitutes with a documented analytic model (PARITY.md). The panner mix
    below exercises the same wide fan-in topology with a reference-literal
    node instead.
    """
    from graphaudio_tpu.testing.oracle import OracleStereoPanner

    voices = 16
    sigs = [(rng.standard_normal(SR // 4) * 0.05).astype(np.float32)
            for _ in range(voices)]

    def build(ctx, ga_api):
        if ga_api:
            master = ga.GainNode(ctx)
        else:
            master = OracleGain(ctx)
        master.gain.value = 0.8
        master.connect(ctx.destination)
        for v in range(voices):
            pan_val = -1.0 + 2.0 * v / (voices - 1)
            if ga_api:
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(sigs[v], SR)
                p = ga.StereoPannerNode(ctx)
            else:
                src = OracleBufferSource(ctx)
                src.set_buffer(sigs[v], SR)
                p = OracleStereoPanner(ctx)
            src.loop = True
            p.pan.value = pan_val
            p.pan.set_value_at_time(pan_val, 0.0)
            p.pan.linear_ramp_to_value_at_time(-pan_val, 0.2)
            src.connect(p).connect(master)
            src.start(0)

    got, want = render_both(build, frames=SR // 4)
    # The reference's FIRST block resolves input channel counts from stale
    # (empty) buffers, so mono->panner runs the stereo law for one block —
    # a documented startup transient we intentionally don't replicate
    # (PARITY.md "channel counts resolve statically"). Compare from block 2.
    assert np.max(np.abs(got[:, 128:] - want[:, 128:])) < 1e-5


def test_oscillator_matches_oracle(rng):
    """All four waveforms with sample-accurate sub-block start/stop.
    Constant frequency: values are exact in both systems, so the phase
    accumulators agree to f64 and outputs to f32 rounding."""
    from graphaudio_tpu.testing.oracle import OracleOscillator

    types_ga = [("sine", ga.OscillatorType.SINE),
                ("square", ga.OscillatorType.SQUARE),
                ("sawtooth", ga.OscillatorType.SAWTOOTH),
                ("triangle", ga.OscillatorType.TRIANGLE)]

    def build(ctx, ga_api):
        for i, (oname, otype) in enumerate(types_ga):
            if ga_api:
                osc = ga.OscillatorNode(ctx, type=otype)
            else:
                osc = OracleOscillator(ctx, type=oname)
            osc.frequency.value = 220.0 * (i + 1) + 0.37
            g = ga.GainNode(ctx) if ga_api else OracleGain(ctx)
            g.gain.value = 0.2
            osc.connect(g).connect(ctx.destination)
            # start/stop inside blocks: ceil/floor frame gating
            osc.start(0.01 + 0.001 * i)
            osc.stop(0.22 - 0.003 * i)

    got, want = render_both(build, frames=SR // 4)
    assert np.max(np.abs(got - want)) < 2e-6


def test_delay_and_split_merge_match_oracle(rng):
    """Automated a-rate delay into a splitter/merger channel swap."""
    from graphaudio_tpu.testing.oracle import (
        OracleChannelMerger, OracleChannelSplitter, OracleDelay,
    )

    left = (rng.standard_normal(SR // 4) * 0.4).astype(np.float32)
    right = (rng.standard_normal(SR // 4) * 0.4).astype(np.float32)

    def build(ctx, ga_api):
        if ga_api:
            src = ga.AudioBufferSourceNode(ctx)
            src.buffer = ga.PlayableAudioBuffer.from_stereo_arrays(
                left, right, SR
            )
            dl = ga.DelayNode(ctx, max_delay_time=0.05)
            sp = ga.ChannelSplitterNode(ctx, 2)
            mg = ga.ChannelMergerNode(ctx, 2)
        else:
            src = OracleBufferSource(ctx)
            src.set_buffer(np.stack([left, right]), SR)
            dl = OracleDelay(ctx, max_delay_time=0.05)
            sp = OracleChannelSplitter(ctx, 2)
            mg = OracleChannelMerger(ctx, 2)
        dl.delay_time.set_value_at_time(0.001, 0.0)
        dl.delay_time.linear_ramp_to_value_at_time(0.04, 0.2)
        src.connect(dl).connect(sp)
        # swap channels through the merger
        sp.connect(mg, 0, 1)
        sp.connect(mg, 1, 0)
        mg.connect(ctx.destination)
        src.start(0)

    got, want = render_both(build, frames=SR // 4)
    assert np.max(np.abs(got - want)) < 1e-6


def test_source_offset_duration_loop_regions(rng):
    """The gnarly AudioBufferSourceNode scheduling corners vs the oracle:
    start offsets, finite durations, custom loop regions, and start times
    landing inside blocks — for both unity and resampled playback."""
    buf = (rng.standard_normal(20000) * 0.3).astype(np.float32)

    cases = [
        # (buffer_rate, loop, loop_start, loop_end, when, offset, duration)
        (SR, False, 0.0, 0.0, 0.0, 0.05, math_inf),       # offset, play out
        (SR, False, 0.0, 0.0, 0.013, 0.0, 0.11),          # mid-block start+duration
        (SR, True, 0.05, 0.17, 0.0, 0.0, math_inf),       # loop region
        (SR, True, 0.0, 0.0, 0.0, 0.3, math_inf),         # offset past loop end wraps
        (44100, False, 0.0, 0.0, 0.0, 0.02, 0.15),        # resampled + duration
        (44100, True, 0.04, 0.21, 0.0, 0.0, math_inf),    # resampled loop region
    ]

    def build(ctx, ga_api):
        for (br, loop, ls, le, when, off, dur) in cases:
            if ga_api:
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(buf, br)
            else:
                src = OracleBufferSource(ctx)
                src.set_buffer(buf, br)
            src.loop = loop
            src.loop_start = ls
            src.loop_end = le
            g = ga.GainNode(ctx) if ga_api else OracleGain(ctx)
            g.gain.value = 1.0 / len(cases)
            src.connect(g).connect(ctx.destination)
            src.start(when, off, dur)

    got, want = render_both(build, frames=SR // 2)
    assert np.max(np.abs(got - want)) < 1e-6


math_inf = float("inf")


def test_process_block_matches_oracle(rng):
    """Single-block pull API (ctx.process_block) against the oracle's literal
    per-block loop — exercises the superblock-carry-free path."""
    sig = (rng.standard_normal(4000) * 0.4).astype(np.float32)
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=4)
    octx = OracleContext(sample_rate=SR)
    for c, api in ((ctx, True), (octx, False)):
        if api:
            src = ga.AudioBufferSourceNode(c)
            src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, SR)
            g = ga.GainNode(c)
        else:
            src = OracleBufferSource(c)
            src.set_buffer(sig, SR)
            g = OracleGain(c)
        src.loop = True
        g.gain.value = 0.7
        g.gain.set_value_at_time(0.7, 0.0)
        g.gain.linear_ramp_to_value_at_time(0.2, 0.05)
        src.connect(g).connect(c.destination)
        src.start(0)
    for _ in range(10):
        got = np.asarray(ctx.process_block())
        want = octx.process_block()
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) < 1e-6


def test_spatial_panner_matches_oracle(rng):
    """The REAL SpatialPannerNode vs the literal numpy oracle: moving
    sources, cone directivity, occlusion + 3-band transmission, and all
    three distance models, sharing only the HRIR grid data table."""
    from graphaudio_tpu.ops.hrtf import build_hrir_grid
    from graphaudio_tpu.testing.oracle import OracleSpatialPanner

    grid = build_hrir_grid(SR)
    voices = 4
    sigs = [(rng.standard_normal(SR // 4) * 0.1).astype(np.float32)
            for _ in range(voices)]
    models_ga = [ga.DistanceModelType.INVERSE, ga.DistanceModelType.LINEAR,
                 ga.DistanceModelType.EXPONENTIAL, ga.DistanceModelType.INVERSE]
    models_o = ["inverse", "linear", "exponential", "inverse"]

    def build(ctx, ga_api):
        ctx.set_listener([0.5, -0.25, 1.0], [0.2, 0.0, -1.0], [0.0, 1.0, 0.1])
        for v in range(voices):
            if ga_api:
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(sigs[v], SR)
                p = ga.SpatialPannerNode(ctx)
                p.distance_model = models_ga[v]
            else:
                src = OracleBufferSource(ctx)
                src.set_buffer(sigs[v], SR)
                p = OracleSpatialPanner(ctx, grid)
                p.distance_model = models_o[v]
            src.loop = True
            ang = 2 * np.pi * v / voices
            p.position_x.set_value_at_time(3.0 * np.cos(ang), 0.0)
            p.position_x.linear_ramp_to_value_at_time(3.0 * np.cos(ang + 1.0), 0.25)
            p.position_y.value = 0.5 * (v - 1.5)
            p.position_z.set_value_at_time(3.0 * np.sin(ang), 0.0)
            p.position_z.linear_ramp_to_value_at_time(3.0 * np.sin(ang + 1.0), 0.25)
            if v == 1:  # cone pointing away from the listener
                p.orientation_x.value = 1.0
                p.orientation_z.value = 0.0
                p.cone_inner_angle.value = 60.0
                p.cone_outer_angle.value = 180.0
                p.cone_outer_gain.value = 0.3
            if v == 2:  # occluded with band-dependent transmission
                p.occlusion.set_value_at_time(0.0, 0.0)
                p.occlusion.linear_ramp_to_value_at_time(0.8, 0.25)
                p.transmission_low.value = 0.9
                p.transmission_mid.value = 0.4
                p.transmission_high.value = 0.1
            if v == 3:  # partial spatial blend
                p.spatial_blend.set_value_at_time(1.0, 0.0)
                p.spatial_blend.linear_ramp_to_value_at_time(0.25, 0.25)
            src.connect(p).connect(ctx.destination)
            src.start(0)

    got, want = render_both(build, frames=SR // 4)
    # Skip block 1: the oracle resolves clamped-max channel counts from
    # stale buffers on the first block (documented startup transient).
    assert np.max(np.abs(got[:, 128:] - want[:, 128:])) < 1e-5


def test_config5_spatial_scene_matches_oracle(rng):
    """BASELINE config 5 at oracle scale with the REAL spatializer: mono
    voices -> SpatialPannerNode -> master gain -> destination, plus a
    shared convolution-reverb send off the master bus (the Kit
    AudioBus/EffectChain topology's core graph)."""
    from graphaudio_tpu.ops.hrtf import build_hrir_grid
    from graphaudio_tpu.testing.oracle import OracleSpatialPanner

    grid = build_hrir_grid(SR)
    voices = 8
    sigs = [(rng.standard_normal(SR // 4) * 0.05).astype(np.float32)
            for _ in range(voices)]
    ir_len = SR // 8
    ir = (rng.standard_normal(ir_len)
          * np.exp(-np.arange(ir_len) / (0.02 * SR))).astype(np.float32)

    def build(ctx, ga_api):
        ctx.set_listener([0, 0, 0], [0, 0, -1], [0, 1, 0])
        if ga_api:
            master = ga.GainNode(ctx)
            wet = ga.GainNode(ctx)
            conv = ga.ConvolverNode(ctx)
            conv.buffer = ga.PlayableAudioBuffer.from_mono_array(ir, SR)
        else:
            master = OracleGain(ctx)
            wet = OracleGain(ctx)
            conv = OracleConvolver(ctx)
            conv.set_buffer(ir, SR)
        master.gain.value = 0.8
        wet.gain.value = 0.3
        master.connect(ctx.destination)
        master.connect(conv)
        conv.connect(wet).connect(ctx.destination)
        for v in range(voices):
            if ga_api:
                src = ga.AudioBufferSourceNode(ctx)
                src.buffer = ga.PlayableAudioBuffer.from_mono_array(sigs[v], SR)
                p = ga.SpatialPannerNode(ctx)
            else:
                src = OracleBufferSource(ctx)
                src.set_buffer(sigs[v], SR)
                p = OracleSpatialPanner(ctx, grid)
            src.loop = True
            ang = 2 * np.pi * v / voices
            p.position_x.set_value_at_time(5.0 * np.cos(ang), 0.0)
            p.position_x.linear_ramp_to_value_at_time(5.0 * np.cos(ang + 0.7), 0.25)
            p.position_z.set_value_at_time(5.0 * np.sin(ang), 0.0)
            p.position_z.linear_ramp_to_value_at_time(5.0 * np.sin(ang + 0.7), 0.25)
            src.connect(p).connect(master)
            src.start(0)

    got, want = render_both(build, frames=SR // 4)
    assert np.max(np.abs(got[:, 128:] - want[:, 128:])) < 1e-5
