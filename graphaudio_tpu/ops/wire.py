"""Device-packed compressed wire formats: G.711 mu-law and IMA ADPCM.

Where the offline renderer's wall time is bound by pulling PCM from the
device to the host, these encoders quantize the rendered audio ON DEVICE so
fewer bytes cross the wire:

- mu-law: 8 bits/sample (2x fewer bytes than int16), memoryless, ~38 dB SNR.
- IMA ADPCM (WAV tag 0x11): ~4.06 bits/sample at the default 505-sample
  block (~3.9x fewer bytes than int16), ~30 dB SNR on broadband material.

Both produce the STANDARD bitstreams (ITU-T G.711; IMA/DVI ADPCM in WAV
block layout), so the streams round-trip bit-exactly through the native
decoder (native/gacodec.cpp ulaw_expand / adpcm_decode_block) and any other
compliant reader. The reference's device path is interleaved PCM
(GraphAudio.Core/AudioContextBase.cs:88-161); these are its
bandwidth-constrained generalization — same rendered signal, packed tighter.

Device shape of the ADPCM encoder: WAV-IMA blocks are independent given their
4-byte/channel headers, so encoding is `vmap` over (blocks x channels) with
one `lax.scan` over the samples-per-block dimension carrying the
(predictor, step index) pair — the in-block recurrence is inherently
sequential, but every block of every channel advances in lockstep.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# IMA/DVI ADPCM tables (from the IMA ADPCM specification; identical to the
# decoder's tables in native/gacodec.cpp kImaStepTable/kImaIndexTable).
IMA_STEP_TABLE = np.array(
    [
        7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
        41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
        190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
        724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
        2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
        6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
        16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
    ],
    dtype=np.int32,
)
# Index adjustment by 3-bit magnitude (sign bit does not affect it).
IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], dtype=np.int32)

DEFAULT_SAMPLES_PER_BLOCK = 505  # 256 bytes/channel/block -> 4.06 bits/sample


def quantize_i16(audio) -> np.ndarray:
    """f32 [-1,1] -> int16 with the wire quantizer round(clip(x)*32767)
    (same formula as the pcm16 path, so all wire formats agree on sample 0)."""
    x = np.asarray(audio, dtype=np.float32)
    return np.round(np.clip(x, -1.0, 1.0) * np.float32(32767.0)).astype(np.int16)


# -- G.711 mu-law --------------------------------------------------------------


@jax.jit
def pack_mulaw(outs):
    """Device pack: f32 audio [C, T] -> flat interleaved mu-law uint8[T*C].

    Standard G.711 mu-law compression of the int16-quantized signal; the
    exact inverse of gacodec's ulaw_expand (native/gacodec.cpp:533-541).
    """
    x = jnp.round(jnp.clip(outs, -1.0, 1.0) * jnp.float32(32767.0)).astype(jnp.int32)
    sign = (x < 0).astype(jnp.int32)
    mag = jnp.minimum(jnp.abs(x), 32635) + 0x84
    # exponent = index of the segment containing mag (7 exact comparisons,
    # no float log): 0 for mag < 0x100, ..., 7 for mag >= 0x4000.
    exp = jnp.zeros_like(mag)
    for k in range(7):
        exp = exp + (mag >= (0x100 << k)).astype(jnp.int32)
    mant = (mag >> (exp + 3)) & 0xF
    byte = (~((sign << 7) | (exp << 4) | mant)) & 0xFF
    return byte.astype(jnp.uint8).T.reshape(-1)


def mulaw_encode_np(audio) -> np.ndarray:
    """Host reference mu-law encoder (planar [C, T] -> interleaved uint8)."""
    x = quantize_i16(audio).astype(np.int32)
    sign = (x < 0).astype(np.int32)
    mag = np.minimum(np.abs(x), 32635) + 0x84
    exp = np.zeros_like(mag)
    for k in range(7):
        exp += (mag >= (0x100 << k)).astype(np.int32)
    mant = (mag >> (exp + 3)) & 0xF
    byte = (~((sign << 7) | (exp << 4) | mant)) & 0xFF
    return np.ascontiguousarray(byte.astype(np.uint8).T).reshape(-1)


def mulaw_decode_np(data: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved mu-law uint8 -> planar f32 [C, T] (gacodec's ulaw_expand
    formula exactly: sample/32768)."""
    u = (~np.asarray(data, dtype=np.uint8)).astype(np.int32) & 0xFF
    sign = u & 0x80
    exp = (u >> 4) & 0x07
    mant = u & 0x0F
    sample = (((mant << 3) + 0x84) << exp) - 0x84
    sample = np.where(sign != 0, -sample, sample)
    out = sample.astype(np.float32) / np.float32(32768.0)
    return np.ascontiguousarray(out.reshape(-1, channels).T)


# -- IMA ADPCM (WAV tag 0x11 block layout) -------------------------------------


def _validate_spb(samples_per_block: int) -> int:
    """WAV-IMA blocks hold 1 header sample + 2*D nibble samples per channel,
    with D (data bytes/channel) a multiple of 4 — so spb must be ≡ 1 (mod 8)."""
    spb = int(samples_per_block)
    if spb < 9 or (spb - 1) % 8 != 0:
        raise ValueError(
            "samples_per_block must be 8*k+1 with k >= 1 (WAV-IMA blocks are "
            f"1 header sample + 4-byte nibble words per channel); got {spb}"
        )
    return spb


def ima_block_align(channels: int, samples_per_block: int) -> int:
    return channels * (4 + (samples_per_block - 1) // 2)


def _initial_index_np(blocks_i32: np.ndarray) -> np.ndarray:
    """Per-block initial step index: the smallest step >= the block's mean
    |first difference|. Blocks are encoded independently (vmap), so the
    header index is chosen from the block's own statistics instead of being
    carried across blocks; IMA adaptation converges within ~16 samples, so
    the quality cost over a >=505-sample block is negligible.

    Pure integer comparison (sum of |diff| vs step*(spb-1)) so the host and
    device encoders agree bit-for-bit — a float mean could round differently
    across backends at table boundaries."""
    nm1 = blocks_i32.shape[-1] - 1
    sad = np.abs(np.diff(blocks_i32, axis=-1)).sum(axis=-1, dtype=np.int64)
    thresholds = IMA_STEP_TABLE.astype(np.int64) * nm1  # [89]
    idx = (sad[..., None] > thresholds).sum(axis=-1)
    return np.clip(idx, 0, 88).astype(np.int32)


def _ima_encode_step_np(pred, index, x):
    """One IMA encode step, vectorized over any leading shape. Mirrors the
    decoder's reconstruction bit-exactly (gacodec.cpp ima_step)."""
    step = IMA_STEP_TABLE[index]
    diff = x - pred
    sign = diff < 0
    adiff = np.abs(diff)
    b4 = adiff >= step
    adiff = adiff - np.where(b4, step, 0)
    vp = (step >> 3) + np.where(b4, step, 0)
    s2 = step >> 1
    b2 = adiff >= s2
    adiff = adiff - np.where(b2, s2, 0)
    vp = vp + np.where(b2, s2, 0)
    s1 = step >> 2
    b1 = adiff >= s1
    vp = vp + np.where(b1, s1, 0)
    delta = b4.astype(np.int32) * 4 + b2.astype(np.int32) * 2 + b1.astype(np.int32)
    pred = np.where(sign, pred - vp, pred + vp)
    pred = np.clip(pred, -32768, 32767)
    index = np.clip(index + IMA_INDEX_TABLE[delta], 0, 88)
    nib = delta + sign.astype(np.int32) * 8
    return pred, index, nib


def _ima_blocks_to_bytes_np(pred0, index0, nibs, channels):
    """Assemble WAV-IMA block bytes from per-block header state + nibbles.

    pred0/index0: [C, nblk]; nibs: [C, nblk, spb-1] (values 0..15).
    Layout per block: for each channel a 4-byte header (predictor int16 LE,
    step index, 0), then 4-byte nibble words round-robin per channel, low
    nibble first (gacodec.cpp adpcm_decode_block reads this exact layout).
    """
    C, nblk, nm1 = nibs.shape
    D = nm1 // 2
    u = pred0.astype(np.int32).astype(np.uint16)
    header = np.empty((nblk, C, 4), dtype=np.uint8)
    header[:, :, 0] = (u & 0xFF).T
    header[:, :, 1] = (u >> 8).T
    header[:, :, 2] = index0.astype(np.uint8).T
    header[:, :, 3] = 0
    data = (nibs[..., 0::2] | (nibs[..., 1::2] << 4)).astype(np.uint8)  # [C,nblk,D]
    words = data.reshape(C, nblk, D // 4, 4).transpose(1, 2, 0, 3)  # [nblk,D/4,C,4]
    return np.concatenate(
        [header.reshape(nblk, 4 * C), words.reshape(nblk, D * channels)], axis=1
    )


def _ima_encode_scalar_np(blocks_i32: np.ndarray) -> tuple:
    """Bit-exact scalar twin of the vectorized encode loop, for FEW lanes.

    The vectorized path costs ~35 us/step in numpy call overhead regardless
    of lane count — ~18 ms for the single final flush block of a stream,
    which lands directly on render_adpcm's wall time. Plain Python ints run
    the same 504 steps in ~1 ms when C*nblk is tiny. Integer math is
    identical operation-for-operation, so outputs match the vectorized path
    (and therefore the device encoder) bit-for-bit.
    """
    C, nblk, spb = blocks_i32.shape
    step_tab = IMA_STEP_TABLE.tolist()
    idx_tab = IMA_INDEX_TABLE.tolist()
    pred0 = np.empty((C, nblk), np.int32)
    index0 = np.empty((C, nblk), np.int32)
    nibs = np.empty((C, nblk, spb - 1), dtype=np.int32)
    nm1 = spb - 1
    for c in range(C):
        for b in range(nblk):
            xs = blocks_i32[c, b].tolist()
            p = xs[0]
            sad = sum(abs(xs[t + 1] - xs[t]) for t in range(nm1))
            ix = 0
            for st in step_tab:
                if sad > st * nm1:
                    ix += 1
            if ix > 88:
                ix = 88
            pred0[c, b] = p
            index0[c, b] = ix
            row = nibs[c, b]
            for t in range(1, spb):
                step = step_tab[ix]
                diff = xs[t] - p
                sign = diff < 0
                adiff = -diff if sign else diff
                delta = 0
                vp = step >> 3
                if adiff >= step:
                    delta = 4
                    adiff -= step
                    vp += step
                s2 = step >> 1
                if adiff >= s2:
                    delta += 2
                    adiff -= s2
                    vp += s2
                if adiff >= step >> 2:
                    delta += 1
                    vp += step >> 2
                p = p - vp if sign else p + vp
                if p < -32768:
                    p = -32768
                elif p > 32767:
                    p = 32767
                ix += idx_tab[delta]
                if ix < 0:
                    ix = 0
                elif ix > 88:
                    ix = 88
                row[t - 1] = delta + (8 if sign else 0)
    return pred0, index0, nibs


def ima_encode_np(q: np.ndarray, samples_per_block: int) -> np.ndarray:
    """Host reference IMA encoder: int16 planar [C, N] -> block bytes
    [nblk, block_align]. N must be a multiple of samples_per_block (pad the
    final partial block with zeros first; WAV records true frames in `fact`).

    Loops spb-1 steps vectorized over all (block, channel) lanes — the same
    dataflow as the device encoder, used for its bit-exactness oracle and
    for host-side edges (stream flush, leading carry frames). Few-lane
    calls (the flush block) take a bit-exact scalar path instead: the
    vectorized loop's per-step numpy overhead dwarfs its work there.
    """
    spb = _validate_spb(samples_per_block)
    q = np.asarray(q, dtype=np.int16)
    C, N = q.shape
    if N % spb:
        raise ValueError(f"sample count {N} not a multiple of block size {spb}")
    nblk = N // spb
    blocks = q.reshape(C, nblk, spb).astype(np.int32)
    if C * nblk <= 4:
        pred0, index0, nibs = _ima_encode_scalar_np(blocks)
        return _ima_blocks_to_bytes_np(pred0, index0, nibs, C)
    pred = blocks[:, :, 0].copy()
    index = _initial_index_np(blocks)
    pred0, index0 = pred.copy(), index.copy()
    nibs = np.empty((C, nblk, spb - 1), dtype=np.int32)
    for t in range(1, spb):
        pred, index, nib = _ima_encode_step_np(pred, index, blocks[:, :, t])
        nibs[:, :, t - 1] = nib
    return _ima_blocks_to_bytes_np(pred0, index0, nibs, C)


def ima_decode_np(
    blocks: np.ndarray, channels: int, samples_per_block: int, frames: int = None
) -> np.ndarray:
    """Decode WAV-IMA block bytes [nblk, block_align] (or a flat byte vector)
    -> int16 planar [C, frames]. Bit-exact vs gacodec's adpcm_decode_block."""
    spb = _validate_spb(samples_per_block)
    C = int(channels)
    ba = ima_block_align(C, spb)
    blocks = np.asarray(blocks, dtype=np.uint8).reshape(-1, ba)
    nblk = blocks.shape[0]
    D = (spb - 1) // 2
    header = blocks[:, : 4 * C].reshape(nblk, C, 4)
    pred = (
        header[:, :, 0].astype(np.uint16) | (header[:, :, 1].astype(np.uint16) << 8)
    ).astype(np.int16).astype(np.int32).T  # [C, nblk]
    index = np.minimum(header[:, :, 2].astype(np.int32), 88).T
    words = blocks[:, 4 * C:].reshape(nblk, D // 4, C, 4)
    data = words.transpose(2, 0, 1, 3).reshape(C, nblk, D)
    nibs = np.empty((C, nblk, spb - 1), dtype=np.int32)
    nibs[..., 0::2] = data & 0xF
    nibs[..., 1::2] = data >> 4
    out = np.empty((C, nblk, spb), dtype=np.int16)
    out[:, :, 0] = pred.astype(np.int16)
    step_shift = IMA_STEP_TABLE
    for t in range(1, spb):
        nib = nibs[:, :, t - 1]
        step = step_shift[index]
        diff = (step >> 3)
        diff += np.where(nib & 1, step >> 2, 0)
        diff += np.where(nib & 2, step >> 1, 0)
        diff += np.where(nib & 4, step, 0)
        pred = np.where(nib & 8, pred - diff, pred + diff)
        pred = np.clip(pred, -32768, 32767)
        index = np.clip(index + IMA_INDEX_TABLE[nib & 7], 0, 88)
        out[:, :, t] = pred.astype(np.int16)
    out = out.reshape(C, nblk * spb)
    if frames is not None:
        out = out[:, :frames]
    return out


# One compiled encoder per (channels, chunk frames, block size) — streams
# are created per render call, so caching at module scope keeps repeated
# renders from re-tracing (jit caches per function object, and each
# make_ima_chunk_encoder call returns a fresh closure).
_ENCODER_CACHE: dict = {}


def make_ima_chunk_encoder(channels: int, frames: int, samples_per_block: int):
    """Build (or fetch cached) the jitted device encoder for one chunk shape.

    encode(audio f32[C, F], carry_buf int16[C, spb-1], carry_len int32)
      -> (block bytes uint8[ncap, block_align], new_carry int16[C, spb-1])

    The stream is carried across chunks: `carry_len` leading samples of
    `carry_buf` precede this chunk's audio. ncap = (spb-1+F)//spb block
    slots are always emitted (static shape); the caller keeps the first
    (carry_len+F)//spb — the rest re-encode next chunk from the carry.
    carry_len is traced (one compiled program per chunk shape, not per
    carry phase).
    """
    spb = _validate_spb(samples_per_block)
    C, F = int(channels), int(frames)
    cached = _ENCODER_CACHE.get((C, F, spb))
    if cached is not None:
        return cached
    D = (spb - 1) // 2
    ncap = (spb - 1 + F) // spb
    BUF = ncap * spb + spb  # >= spb-1+F, and safe for the carry slice below
    step_t = jnp.asarray(IMA_STEP_TABLE)
    # Gather-free step-table lookup: a per-lane gather inside the scan can
    # force a relayout per iteration. Instead accumulate first
    # differences gated by (index >= j) with the table axis LEADING, so the
    # [C, ncap] lane layout never changes: stp = sum_j (idx>=j) * (T[j]-T[j-1])
    # with T[-1] = 0. Exact for idx in [0, 88]. Same trick would NOT be fast
    # with the table on a new minor axis (XLA relayouts each step).
    step_diffs = jnp.asarray(
        np.diff(np.concatenate([[0], IMA_STEP_TABLE])).astype(np.int32)
    )[:, None, None]
    table_iota = jnp.arange(89, dtype=jnp.int32)[:, None, None]

    def _step_for(index):
        # dtype pinned: under jax_enable_x64 an int32 sum accumulates int64.
        return jnp.sum(
            jnp.where(index[None] >= table_iota, step_diffs, 0),
            axis=0,
            dtype=jnp.int32,
        )

    @jax.jit
    def encode(audio, carry_buf, carry_len):
        q = jnp.round(jnp.clip(audio, -1.0, 1.0) * jnp.float32(32767.0)).astype(
            jnp.int16
        )
        buf = jnp.zeros((C, BUF), jnp.int16)
        buf = buf.at[:, : spb - 1].set(carry_buf)
        buf = jax.lax.dynamic_update_slice(
            buf, q, (jnp.int32(0), carry_len.astype(jnp.int32))
        )
        blocks = buf[:, : ncap * spb].reshape(C, ncap, spb).astype(jnp.int32)
        pred0 = blocks[:, :, 0]
        # Integer-exact initial-index heuristic (see _initial_index_np):
        # sum|diff| fits int32 (504 * 65535 < 2^31); thresholds fit too.
        sad = jnp.abs(jnp.diff(blocks, axis=2)).sum(axis=2, dtype=jnp.int32)
        thresholds = (step_t * jnp.int32(spb - 1))[:, None, None]  # [89,1,1]
        # Table axis leading (same layout rule as _step_for).
        index0 = jnp.sum(
            (sad[None] > thresholds).astype(jnp.int32), axis=0,
            dtype=jnp.int32,
        )
        index0 = jnp.clip(index0, 0, 88)

        def step(state, x):
            pred, index = state
            stp = _step_for(index)
            diff = x - pred
            sign = (diff < 0).astype(jnp.int32)
            adiff = jnp.abs(diff)
            b4 = (adiff >= stp).astype(jnp.int32)
            adiff = adiff - b4 * stp
            vp = (stp >> 3) + b4 * stp
            s2 = stp >> 1
            b2 = (adiff >= s2).astype(jnp.int32)
            adiff = adiff - b2 * s2
            vp = vp + b2 * s2
            s1 = stp >> 2
            b1 = (adiff >= s1).astype(jnp.int32)
            vp = vp + b1 * s1
            delta = b4 * 4 + b2 * 2 + b1
            pred = jnp.where(sign == 1, pred - vp, pred + vp)
            pred = jnp.clip(pred, -32768, 32767)
            # IMA_INDEX_TABLE[-1,-1,-1,-1,2,4,6,8] without a gather: the
            # adjustment is -1 below magnitude 4, else 2*(delta-3).
            index = jnp.clip(
                index + jnp.where(delta < 4, -1, 2 * (delta - 3)), 0, 88
            )
            return (pred, index), (delta + sign * 8).astype(jnp.uint8)

        xs = blocks[:, :, 1:].transpose(2, 0, 1)  # [spb-1, C, ncap]
        # The in-block recurrence is inherently sequential; unrolling trades
        # loop-iteration dispatch (the dominant cost — each step's compute
        # is a handful of [C, ncap] integer ops) for code size.
        _, nibs = jax.lax.scan(step, (pred0, index0), xs, unroll=8)
        nibs = nibs.transpose(1, 2, 0)  # [C, ncap, spb-1]

        u = pred0.astype(jnp.uint16)
        header = jnp.stack(
            [
                (u & 0xFF).astype(jnp.uint8),
                (u >> 8).astype(jnp.uint8),
                index0.astype(jnp.uint8),
                jnp.zeros_like(index0, dtype=jnp.uint8),
            ],
            axis=-1,
        ).transpose(1, 0, 2)  # [ncap, C, 4]
        data = nibs[..., 0::2] | (nibs[..., 1::2] << 4)  # [C, ncap, D]
        words = data.reshape(C, ncap, D // 4, 4).transpose(1, 2, 0, 3)
        out = jnp.concatenate(
            [header.reshape(ncap, 4 * C), words.reshape(ncap, D * C)], axis=1
        )
        nblk = (carry_len.astype(jnp.int32) + F) // spb
        new_carry = jax.lax.dynamic_slice(
            buf, (jnp.int32(0), nblk * spb), (C, spb - 1)
        )
        return out, new_carry

    _ENCODER_CACHE[(C, F, spb)] = encode
    return encode


class ImaDeviceStream:
    """Streaming IMA encoder threading block-boundary carry across device
    chunks, so one render call yields ONE contiguous standard WAV-IMA stream
    regardless of the launch-chunk schedule."""

    def __init__(self, channels: int, samples_per_block: int):
        self.channels = int(channels)
        self.spb = _validate_spb(samples_per_block)
        self.block_align = ima_block_align(self.channels, self.spb)
        # Host zeros: a jnp.zeros here would dispatch a device op per
        # stream (one per render_adpcm call); the first encode_chunk ships
        # it with the jit call's arguments instead.
        self.carry_buf = np.zeros((self.channels, self.spb - 1), np.int16)
        self.carry_len = 0  # host mirror (deterministic)
        self._encoders = {}

    def set_carry(self, q: np.ndarray) -> None:
        """Seed the stream with leftover host samples (int16 [C, n<spb])."""
        n = q.shape[1]
        if n >= self.spb:
            raise ValueError("carry must be shorter than one block")
        buf = np.zeros((self.channels, self.spb - 1), np.int16)
        buf[:, :n] = q
        self.carry_buf = buf  # host; ships with the next encode_chunk call
        self.carry_len = n

    def encode_chunk(self, audio):
        """Device-side: f32 [C, F] -> (uint8 block slots, kept-block count)."""
        C, F = audio.shape
        if C != self.channels:
            raise RuntimeError(
                "destination channel count changed mid-stream "
                f"({self.channels} -> {C}); an ADPCM stream has a fixed "
                "channel layout — render across the topology change with "
                "separate render_adpcm calls"
            )
        enc = self._encoders.get(F)
        if enc is None:
            enc = self._encoders[F] = make_ima_chunk_encoder(C, F, self.spb)
        blocks, self.carry_buf = enc(
            audio, self.carry_buf, jnp.int32(self.carry_len)
        )
        # Start the carry's device->host copy now: pull_carry at stream
        # flush otherwise pays a fresh round trip AFTER all block transfers
        # have drained.
        try:
            self.carry_buf.copy_to_host_async()
        except AttributeError:
            pass
        nblk = (self.carry_len + F) // self.spb
        self.carry_len = (self.carry_len + F) % self.spb
        return blocks, nblk

    def pull_carry(self) -> np.ndarray:
        """Fetch the pending carry samples to host (int16 [C, carry_len])
        and reset the device carry. Used to hand off to host-side encoding
        (stream flush / f32 tail)."""
        buf = np.asarray(jax.device_get(self.carry_buf))[:, : self.carry_len]
        self.carry_buf = jnp.zeros((self.channels, self.spb - 1), jnp.int16)
        self.carry_len = 0
        return buf


@dataclass
class AdpcmStream:
    """A rendered IMA ADPCM stream: standard WAV tag-0x11 blocks.

    ``blocks`` is uint8 [nblk, block_align]; the final block is zero-padded
    past ``frames`` (standard WAV practice — the `fact` chunk records the
    true frame count)."""

    blocks: np.ndarray
    channels: int
    samples_per_block: int
    sample_rate: int
    frames: int

    @property
    def block_align(self) -> int:
        return ima_block_align(self.channels, self.samples_per_block)

    @property
    def nbytes(self) -> int:
        return int(self.blocks.size)

    def tobytes(self) -> bytes:
        return self.blocks.tobytes()

    def decode_int16(self) -> np.ndarray:
        """Planar int16 [C, frames] (bit-exact vs gacodec's decode)."""
        return ima_decode_np(
            self.blocks, self.channels, self.samples_per_block, self.frames
        )

    def decode(self) -> np.ndarray:
        """Planar f32 [C, frames]; int16/32768, matching gacodec exactly."""
        return self.decode_int16().astype(np.float32) / np.float32(32768.0)

    def to_wav_bytes(self) -> bytes:
        """A complete, standard WAV-IMA file (fmt tag 0x11 with
        wSamplesPerBlock extension + fact chunk + data)."""
        data = self.tobytes()
        fmt = struct.pack(
            "<HHIIHHHH",
            0x11,
            self.channels,
            self.sample_rate,
            # nAvgBytesPerSec for ADPCM: bytes per second of blocks.
            int(
                round(
                    self.sample_rate * self.block_align / self.samples_per_block
                )
            ),
            self.block_align,
            4,  # bits per (compressed) sample
            2,  # cbSize
            self.samples_per_block,
        )
        chunks = (
            b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"fact" + struct.pack("<II", 4, self.frames)
            + b"data" + struct.pack("<I", len(data)) + data
        )
        if len(data) & 1:
            chunks += b"\x00"
        return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks

    def write_wav(self, path) -> None:
        with open(path, "wb") as f:
            f.write(self.to_wav_bytes())


def mulaw_wav_bytes(data: np.ndarray, channels: int, sample_rate: int) -> bytes:
    """Wrap interleaved mu-law bytes as a standard WAV (fmt tag 7)."""
    payload = np.asarray(data, dtype=np.uint8).tobytes()
    fmt = struct.pack(
        "<HHIIHHH", 7, channels, sample_rate, sample_rate * channels,
        channels, 8, 0,
    )
    chunks = (
        b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"fact" + struct.pack("<II", 4, len(payload) // channels)
        + b"data" + struct.pack("<I", len(payload)) + payload
    )
    if len(payload) & 1:
        chunks += b"\x00"
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks
