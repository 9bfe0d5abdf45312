"""Compressed wire formats: G.711 mu-law and IMA ADPCM, encoded on device.

The reference's device path delivers interleaved PCM
(GraphAudio.Core/AudioContextBase.cs:88-161); where device-to-host bandwidth
bounds delivery these standard lossy formats cut wire bytes 2x (mu-law) /
~3.9x (ADPCM).
These tests pin three contracts:

1. Device encoders are BIT-EXACT vs the host numpy reference encoders
   (same integer dataflow, no float divergence).
2. The emitted bitstreams are STANDARD: gacodec (the native decoder, an
   independent C++ implementation) decodes the WAV wrappers to exactly the
   samples our numpy decoders produce.
3. Lossiness never leaks into the render timeline: frames over-rendered
   past a packed call carry as exact float32, so the session continues
   bit-identically to an all-f32 session.
"""

import numpy as np
import pytest

import graphaudio_tpu as ga
from graphaudio_tpu.io import native
from graphaudio_tpu.io.decode import AudioDecoder
from graphaudio_tpu.ops import wire

SR = 48000


def _signal(rng, channels, n):
    t = np.arange(n, dtype=np.float64) / SR
    tones = np.stack(
        [np.sin(2 * np.pi * 220.0 * (c + 1) * t) for c in range(channels)]
    )
    sig = 0.7 * tones + 0.05 * rng.standard_normal((channels, n))
    return np.clip(sig, -1.0, 1.0).astype(np.float32)


def _snr_db(ref, got):
    ref = ref.astype(np.float64)
    err = got.astype(np.float64) - ref
    return 10.0 * np.log10(np.sum(ref**2) / max(np.sum(err**2), 1e-30))


def _noise_ctx(superblock=2, channels=2, seconds=1.0, seed=7):
    """Offline context playing a broadband looped buffer (worst case for
    ADPCM adaptation, unlike a constant that compresses losslessly)."""
    rng = np.random.default_rng(seed)
    n = int(SR * seconds)
    buf = ga.PlayableAudioBuffer.from_channel_arrays(
        list(_signal(rng, channels, n)), SR
    )
    ctx = ga.OfflineAudioContext(sample_rate=SR, superblock=superblock)
    src = ga.AudioBufferSourceNode(ctx)
    src.buffer = buf
    src.loop = True
    src.connect(ctx.destination)
    src.start(0)
    return ctx


# -- mu-law ---------------------------------------------------------------


def test_mulaw_device_matches_host(rng):
    x = _signal(rng, 2, 4096)
    dev = np.asarray(wire.pack_mulaw(x))
    host = wire.mulaw_encode_np(x)
    np.testing.assert_array_equal(dev, host)


def test_mulaw_roundtrip_snr(rng):
    x = _signal(rng, 2, 8192)
    back = wire.mulaw_decode_np(wire.mulaw_encode_np(x), 2)
    assert back.shape == x.shape
    assert _snr_db(x, back) > 32.0  # G.711 SNDR ~38 dB on tones


def test_mulaw_wav_decodes_via_gacodec(rng, tmp_path):
    if native.load() is None:
        pytest.skip("native codec not built")
    x = _signal(rng, 2, 3000)
    data = wire.mulaw_encode_np(x)
    p = tmp_path / "m.wav"
    p.write_bytes(wire.mulaw_wav_bytes(data, 2, SR))
    with AudioDecoder(str(p)) as d:
        assert d.channels == 2 and d.sample_rate == SR
        got = d.decode_planar(3000)
    np.testing.assert_array_equal(got, wire.mulaw_decode_np(data, 2))


# -- IMA ADPCM ------------------------------------------------------------


def test_ima_device_matches_host_single_chunk(rng):
    spb = 505
    x = _signal(rng, 2, spb * 3)
    host = wire.ima_encode_np(wire.quantize_i16(x), spb)
    stream = wire.ImaDeviceStream(2, spb)
    blocks, nblk = stream.encode_chunk(x)
    assert nblk == 3 and stream.carry_len == 0
    np.testing.assert_array_equal(np.asarray(blocks)[:nblk], host)


def test_ima_stream_chunked_matches_one_shot(rng):
    """Carry threading: encoding in ragged chunks (none block-aligned)
    yields the identical block bytes as one host-side pass."""
    spb = 89  # small blocks so several boundaries land mid-chunk
    x = _signal(rng, 2, spb * 7)
    host = wire.ima_encode_np(wire.quantize_i16(x), spb)
    stream = wire.ImaDeviceStream(2, spb)
    parts, off = [], 0
    for size in (50, 200, 89 * 3, 17, 300):
        blocks, nblk = stream.encode_chunk(x[:, off : off + size])
        if nblk:
            parts.append(np.asarray(blocks)[:nblk])
        off += size
    blocks, nblk = stream.encode_chunk(x[:, off:])
    if nblk:
        parts.append(np.asarray(blocks)[:nblk])
    assert stream.carry_len == 0
    got = np.concatenate(parts, axis=0)
    np.testing.assert_array_equal(got, host)


def test_ima_roundtrip_snr(rng):
    spb = 505
    x = _signal(rng, 2, spb * 4)
    blocks = wire.ima_encode_np(wire.quantize_i16(x), spb)
    back = wire.ima_decode_np(blocks, 2, spb).astype(np.float32) / 32768.0
    assert back.shape == x.shape
    assert _snr_db(x, back) > 22.0  # ~30 dB typical; broadband worst case


def test_ima_wav_gacodec_bitexact(rng, tmp_path):
    if native.load() is None or not ga.io.codec_capabilities()["adpcm"]:
        pytest.skip("native ADPCM decoder not available")
    spb = 505
    frames = spb * 3 + 123  # final block zero-padded, fact trims
    ctx = _noise_ctx(superblock=2)
    stream = ctx.render_adpcm(frames, samples_per_block=spb)
    assert stream.frames == frames and stream.channels == 2
    p = tmp_path / "a.wav"
    stream.write_wav(p)
    with AudioDecoder(str(p)) as d:
        assert d.frames == frames
        got = d.decode_planar(frames)
    want = stream.decode()
    np.testing.assert_array_equal(got, want)


def test_render_adpcm_matches_f32_render(rng):
    frames = 48 * 128  # 12 superblocks at superblock=4
    ref = _noise_ctx(superblock=4).render(frames)
    stream = _noise_ctx(superblock=4).render_adpcm(frames)
    got = stream.decode()
    assert got.shape == ref.shape
    assert _snr_db(ref, got) > 22.0


def test_render_mulaw_matches_f32_render(rng):
    frames = 40 * 128
    ref = _noise_ctx(superblock=4).render(frames)
    data = _noise_ctx(superblock=4).render_mulaw(frames)
    assert data.dtype == np.uint8 and data.size == frames * 2
    got = wire.mulaw_decode_np(data, 2)
    assert _snr_db(ref, got) > 32.0


def test_packed_renders_do_not_poison_the_timeline(rng):
    """Frames over-rendered past a packed call carry as exact f32: an
    adpcm+mulaw+f32 session continues bit-identically to an all-f32 one."""
    a = _noise_ctx(superblock=4)
    b = _noise_ctx(superblock=4)
    n1, n2, n3 = 700, 333, 2000  # none superblock-aligned
    a.render(n1)
    a.render(n2)
    want = a.render(n3)
    b.render_adpcm(n1)
    b.render_mulaw(n2)
    got = b.render(n3)
    np.testing.assert_array_equal(got, want)


def test_render_adpcm_partial_and_sequential_calls(rng):
    """Two back-to-back adpcm calls cover the same samples as one f32
    render of the concatenated span (each stream decodes its own range)."""
    frames1, frames2 = 1000, 1500
    ref = _noise_ctx(superblock=2).render(frames1 + frames2)
    ctx = _noise_ctx(superblock=2)
    s1 = ctx.render_adpcm(frames1)
    s2 = ctx.render_adpcm(frames2)
    got = np.concatenate([s1.decode(), s2.decode()], axis=1)
    assert got.shape == ref.shape
    assert _snr_db(ref, got) > 22.0


def test_ima_stream_channel_change_raises():
    stream = wire.ImaDeviceStream(2, 505)
    with pytest.raises(RuntimeError, match="channel count changed"):
        stream.encode_chunk(np.zeros((3, 505), np.float32))


def test_validate_spb_rejects_bad_sizes():
    for bad in (0, 1, 8, 10, 512):
        with pytest.raises(ValueError):
            wire._validate_spb(bad)
    assert wire._validate_spb(9) == 9
    assert wire._validate_spb(505) == 505


def test_render_zero_frames():
    ctx = _noise_ctx()
    assert ctx.render_mulaw(0).size == 0
    s = ctx.render_adpcm(0)
    assert s.frames == 0 and s.nbytes == 0
