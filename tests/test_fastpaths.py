"""Fast-path parity: program cache, blocked-matmul one-pole, const biquad.

These cover the device-specific performance machinery that has no reference
counterpart: the compiled-program cache (voice churn must not recompile) and
the closed-form replacements for first-order scans.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import graphaudio_tpu as ga
from graphaudio_tpu.ops.biquad import (
    FILTER_TYPES,
    biquad_apply,
    rbj_coefficients,
)
from graphaudio_tpu.ops.onepole import onepole_lowpass


def _sequential_onepole(x, a, y0):
    ref = np.zeros_like(x, dtype=np.float64)
    c = y0.astype(np.float64)
    for t in range(x.shape[-1]):
        c = a * c + (1 - a) * x[..., t]
        ref[..., t] = c
    return ref


@pytest.mark.parametrize("hz", [800.0, 8000.0])
def test_onepole_blocked_matches_sequential(hz):
    rng = np.random.default_rng(0)
    a = math.exp(-2 * math.pi * hz / 48000)
    x = rng.standard_normal((2, 8 * 128)).astype(np.float32)
    y0 = rng.standard_normal(2).astype(np.float32)
    ref = _sequential_onepole(x, a, y0)
    y, carry = onepole_lowpass(jnp.asarray(x), a, jnp.asarray(y0))
    assert np.abs(np.asarray(y) - ref).max() < 1e-5
    assert np.abs(np.asarray(carry) - ref[..., -1]).max() < 1e-5


def test_onepole_superblock_continuity():
    """Two 4-block renders == one 8-block render via the carry."""
    rng = np.random.default_rng(1)
    a = math.exp(-2 * math.pi * 800.0 / 48000)
    x = rng.standard_normal((3, 8 * 128)).astype(np.float32)
    full, _ = onepole_lowpass(jnp.asarray(x), a, jnp.zeros(3))
    h1, c = onepole_lowpass(jnp.asarray(x[:, : 4 * 128]), a, jnp.zeros(3))
    h2, _ = onepole_lowpass(jnp.asarray(x[:, 4 * 128 :]), a, c)
    glued = np.concatenate([np.asarray(h1), np.asarray(h2)], axis=1)
    assert np.abs(glued - np.asarray(full)).max() < 1e-5


@pytest.mark.parametrize("ftype", FILTER_TYPES)
def test_biquad_const_path_matches_scan(ftype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8 * 128)).astype(np.float32)
    T = x.shape[1]
    f = jnp.full((T,), 1200.0, jnp.float32)
    q = jnp.full((T,), 4.0, jnp.float32)
    g = jnp.full((T,), 6.0, jnp.float32)
    coeffs = rbj_coefficients(ftype, f, q, g, 48000)
    w1 = rng.standard_normal(2).astype(np.float32)
    w2 = rng.standard_normal(2).astype(np.float32)
    ys, s1, s2 = biquad_apply(x, coeffs, w1, w2)
    yc, c1, c2 = biquad_apply(x, coeffs, w1, w2, constant=True)
    assert np.abs(np.asarray(ys) - np.asarray(yc)).max() < 2e-3
    assert np.abs(np.asarray(s1) - np.asarray(c1)).max() < 2e-3
    assert np.abs(np.asarray(s2) - np.asarray(c2)).max() < 2e-3


def _one_shot(ctx, buf):
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = buf
    g = ga.GainNode(ctx)
    g.gain.value = 0.5
    src.connect(g).connect(ctx.destination)
    src.start(ctx.current_time)
    return src, g


def test_program_cache_reuses_on_voice_churn():
    """Disposing a voice and spawning a structurally identical one must hit
    the compiled-program cache, not recompile."""
    sr = 48000
    buf = ga.PlayableAudioBuffer.from_mono_array(
        np.sin(np.arange(4800) * 0.05).astype(np.float32), sr
    )
    ctx = ga.OfflineAudioContext(sample_rate=sr, superblock=4)
    s1, g1 = _one_shot(ctx, buf)
    s2, g2 = _one_shot(ctx, buf)
    out1 = ctx.render(4 * 128 * 2)
    assert ctx.stats.compile_count == 1
    s1.dispose()
    g1.dispose()
    _one_shot(ctx, buf)
    out2 = ctx.render(4 * 128 * 2)
    assert ctx.stats.compile_count == 1, "voice churn forced a recompile"
    assert ctx.stats.program_reuse_count >= 1
    assert np.isfinite(out2).all() and np.abs(out2).max() > 0


def test_program_cache_respects_config_change():
    """A baked-in config change (filter type) must NOT reuse the old program."""
    ctx = ga.OfflineAudioContext(superblock=2)
    osc = ga.OscillatorNode(ctx)
    osc.frequency.value = 220.0
    flt = ga.BiQuadFilterNode(ctx, ga.FilterType.LOWPASS)
    flt.frequency.value = 400.0
    osc.connect(flt).connect(ctx.destination)
    osc.start(0)
    out_lp = ctx.render(2 * 128 * 2)
    flt.type = ga.FilterType.HIGHPASS
    out_hp = ctx.render(2 * 128 * 2)
    assert ctx.stats.compile_count == 2, "config change must recompile"
    # 220 Hz fundamental: lowpass@400 passes it, highpass@400 kills it.
    assert np.abs(out_hp).max() < np.abs(out_lp).max() * 0.5


def test_program_cache_preserves_surviving_voice_state():
    """A surviving voice keeps its playback position across voice churn."""
    sr = 48000
    ramp = np.linspace(0.0, 1.0, sr, dtype=np.float32)  # position probe
    buf = ga.PlayableAudioBuffer.from_mono_array(ramp, sr)
    ctx = ga.OfflineAudioContext(sample_rate=sr, superblock=2)
    keeper, _ = _one_shot(ctx, buf)
    victim, vg = _one_shot(ctx, buf)
    n = 2 * 128 * 2
    ctx.render(n)
    victim.dispose()
    vg.dispose()
    _one_shot(ctx, buf)  # replacement voice starts at 0
    out = ctx.render(n)
    # keeper continues from frame n (value n/sr * 0.5 gain), replacement
    # restarts at 0 -> first sample of the mix ~= 0.5 * n/sr.
    expected = 0.5 * (n / sr)
    assert abs(float(out[0, 0]) - expected) < 1e-3


def test_program_cache_pow2_voice_buckets():
    """Voice counts within one pow2 bucket share a compiled program; phantom
    pad lanes must be exactly silent."""
    sr = 48000
    buf = ga.PlayableAudioBuffer.from_mono_array(
        np.sin(np.arange(4800) * 0.05).astype(np.float32), sr
    )

    def shot(c):
        src = ga.AudioBufferSourceNode(c)
        src.buffer = buf
        g = ga.GainNode(c)
        g.gain.value = 0.5
        src.connect(g).connect(c.destination)
        src.start(0)

    ctx = ga.OfflineAudioContext(sample_rate=sr, superblock=4)
    for _ in range(3):
        shot(ctx)
    out3 = ctx.render(2048)
    assert ctx.stats.compile_count == 1
    shot(ctx)  # V=4: same bucket -> cached program
    ctx.render(2048)
    assert ctx.stats.compile_count == 1
    assert ctx.stats.program_reuse_count >= 1
    shot(ctx)  # V=5: next bucket (8) -> one new compile
    ctx.render(2048)
    assert ctx.stats.compile_count == 2

    # Phantom-lane silence: a fresh 3-voice scene renders bit-identically.
    ctx2 = ga.OfflineAudioContext(sample_rate=sr, superblock=4)
    for _ in range(3):
        shot(ctx2)
    assert np.array_equal(ctx2.render(2048), out3)


def test_unity_alignment_variant_and_offset_fallback(rng):
    """Aligned unity voices (offset on a block boundary, loop length a
    multiple of 128) compile the row-gather variant; starting with a
    misaligned offset flips to the shifted variant and still plays the
    right samples."""
    import graphaudio_tpu as ga

    sig = (rng.standard_normal(12800) * 0.4).astype(np.float32)

    def play(offset_frames):
        ctx = ga.OfflineAudioContext(sample_rate=48000, superblock=4)
        src = ga.AudioBufferSourceNode(ctx)
        src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig, 48000)
        src.start(0, offset=offset_frames / 48000.0)
        src.connect(ctx.destination)
        out = ctx.render(2048)
        return src.kernel_variant(), out

    v_aligned, out_a = play(0)
    assert v_aligned == ("unity", True)
    np.testing.assert_array_equal(out_a[0], sig[:2048])

    v_off, out_o = play(300)  # not a multiple of 128
    assert v_off == ("unity", False)
    np.testing.assert_array_equal(out_o[0], sig[300:300 + 2048])

    # loop length not a multiple of 128 -> shifted variant
    ctx = ga.OfflineAudioContext(sample_rate=48000, superblock=4)
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = ga.PlayableAudioBuffer.from_mono_array(sig[:3000], 48000)
    src.loop = True
    src.start(0)
    src.connect(ctx.destination)
    assert src.kernel_variant() == ("unity", False)
    out = ctx.render(9216)[0]
    np.testing.assert_array_equal(out, sig[:3000][np.arange(9216) % 3000])
