"""Uniform partitioned FFT convolution.

The reference's PartitionedConvolver (GraphAudio.Core/PartitionedConvolver.cs,
adapted there from LabSound) splits the impulse response into 128-frame
partitions, each pre-transformed with a 256-point real FFT (129 bins), keeps a
frequency-domain delay line of past input spectra, and per block computes

    acc[b] = sum_p delay[t-p][b] * H[p][b]          (complex MAC, :154-223)

followed by an inverse FFT and overlap-add (:140-151).

Formulation (all float32, no complex dtypes, DFTs as matmuls; see
ops/fft.py):

  * a superblock of S quanta transforms with one matmul-DFT;
  * the spectral accumulation across partitions *and* superblock positions is
    four real depthwise correlations along the partition axis
    (out[s,b] = sum_p H[p,b] seq[P-1+s-p, b]);
  * the inverse transform is another matmul; the overlap-add between
    consecutive quanta is a shift, not a sequential loop.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.ops.fft import RealDft

FFT_SIZE = 2 * FRAMES_PER_BLOCK  # 256 (PartitionedConvolver.cs:40)
NUM_BINS = FFT_SIZE // 2 + 1  # 129 (:41)

# Equal-power normalization constants (:93-101).
GAIN_CALIBRATION_DB = -58.0
MIN_POWER = 0.000125


def normalization_scale(ir: np.ndarray) -> float:
    """Parity: PartitionedConvolver.CalculateNormalizationScale (:93-102)."""
    ir = np.asarray(ir, dtype=np.float32)
    sum_sq = float(np.sum(ir.astype(np.float64) ** 2))
    power = np.float32(np.sqrt(sum_sq / ir.shape[0])) if ir.shape[0] else np.float32(0)
    if not np.isfinite(power) or power < MIN_POWER:
        power = np.float32(MIN_POWER)
    return float((1.0 / power) * np.float32(10.0 ** (GAIN_CALIBRATION_DB * 0.05)))


def prepare_ir(ir: np.ndarray, normalize: bool = True):
    """Partition + pre-transform an impulse response channel.

    Returns (Hr, Hi): f32[P, 129] partition spectra as split real/imag.
    Host-side numpy with a float64 FFT then float32 rounding, matching the
    reference's FftFlat double transform of float data (:65-91).
    """
    ir = np.asarray(ir, dtype=np.float32)
    scale = np.float32(normalization_scale(ir)) if normalize else np.float32(1.0)
    n_partitions = max(1, -(-ir.shape[0] // FRAMES_PER_BLOCK))
    hr = np.zeros((n_partitions, NUM_BINS), dtype=np.float32)
    hi = np.zeros((n_partitions, NUM_BINS), dtype=np.float32)
    for p in range(n_partitions):
        seg = ir[p * FRAMES_PER_BLOCK : (p + 1) * FRAMES_PER_BLOCK]
        padded = np.zeros(FFT_SIZE, dtype=np.float64)
        padded[: seg.shape[0]] = (seg * scale).astype(np.float32)
        spec = np.fft.rfft(padded)
        hr[p] = spec.real.astype(np.float32)
        hi[p] = spec.imag.astype(np.float32)
    return hr, hi


def spectral_mac(seq_r, seq_i, hr, hi):
    """Complex correlation across partitions as batched matmuls.

    acc[s,b] = sum_p H[p,b] * seq[P-1+s-p, b]  with H, seq split re/im.
    seq_*: f32[P-1+S, B]; h*: f32[P, B]. Returns (acc_r, acc_i) f32[S, B].

    The windows over the delay line are built from S STATIC shifted slices
    and contracted with one per-bin batched matmul per real component.
    (A depthwise conv with feature_group_count=B expresses the same sum
    but lowers to per-bin loops instead of one contraction.)
    """
    P = hr.shape[0]
    S = seq_r.shape[0] - (P - 1)
    kr, ki = hr[::-1], hi[::-1]  # partition-reversed -> correlation form
    win_r = jnp.stack([seq_r[s : s + P] for s in range(S)])  # [S, P, B]
    win_i = jnp.stack([seq_i[s : s + P] for s in range(S)])
    hp = jax.lax.Precision.HIGHEST

    def mac(win, ker):
        return jnp.einsum("spb,pb->sb", win, ker, precision=hp)

    acc_r = mac(win_r, kr) - mac(win_i, ki)
    acc_i = mac(win_r, ki) + mac(win_i, kr)
    return acc_r, acc_i


def conv_superblock(x, hr, hi, hist_r, hist_i, overlap):
    """Convolve one superblock of quanta against a partitioned IR.

    Args:
      x: f32[S, 128] input quanta (time order).
      hr, hi: f32[P, 129] IR partition spectra (closure constants).
      hist_r, hist_i: f32[P-1, 129] spectra of the previous P-1 quanta,
        oldest first (the frequency-domain delay line, :122-128).
      overlap: f32[128] carried second half of the last inverse DFT (:144-151).

    Returns (y f32[S, 128], hist_r', hist_i', overlap').
    """
    S = x.shape[0]
    dft = RealDft(FRAMES_PER_BLOCK, FFT_SIZE)

    spec_r, spec_i = dft.forward(x)  # [S, 129] each

    seq_r = jnp.concatenate([hist_r, spec_r], axis=0)  # [P-1+S, 129]
    seq_i = jnp.concatenate([hist_i, spec_i], axis=0)

    acc_r, acc_i = spectral_mac(seq_r, seq_i, hr, hi)  # [S, 129]

    y_full = dft.inverse(acc_r, acc_i)  # [S, 256]
    first, second = y_full[:, :FRAMES_PER_BLOCK], y_full[:, FRAMES_PER_BLOCK:]
    prev_second = jnp.concatenate([overlap[None], second[:-1]], axis=0)
    y = first + prev_second

    # seq length is P-1+S, so seq[S:] is the updated delay line.
    return y, seq_r[S:], seq_i[S:], second[-1]


# ---- superblock-granularity partitioning ------------------------------------
#
# With a superblock of T = S*128 frames available at once, partitioning the
# IR at T-sample granularity (2T-point transforms via the factorized
# BigRealDft) is mathematically the SAME linear convolution but collapses
# the per-step spectral work: a 2 s IR needs 750 partitions of 128 but only
# 24 of 4096, and the delay line shrinks to one spectrum per PAST superblock
# — no [S, P, B] window materialization at all (that window's memory
# traffic dominates the 128-grain path once IRs get long).


def prepare_ir_big(ir: np.ndarray, block: int, normalize: bool = True):
    """Partition + pre-transform an IR channel at ``block``-sample grain.

    Returns (Hr, Hi): f32[P2, block+1] spectra of 2*block-point transforms,
    PARTITION-REVERSED (newest-input partition last) so the render-time MAC
    is an elementwise multiply against the delay line in storage order.
    Same -58 dB normalization as the 128-grain path (:93-102)."""
    ir = np.asarray(ir, dtype=np.float32)
    scale = np.float32(normalization_scale(ir)) if normalize else np.float32(1.0)
    n_part = max(1, -(-ir.shape[0] // block))
    hr = np.zeros((n_part, block + 1), dtype=np.float32)
    hi = np.zeros((n_part, block + 1), dtype=np.float32)
    for p in range(n_part):
        seg = ir[p * block : (p + 1) * block]
        padded = np.zeros(2 * block, dtype=np.float64)
        padded[: seg.shape[0]] = (seg * scale).astype(np.float32)
        spec = np.fft.rfft(padded)
        # reversed: row k multiplies the spectrum of input block (now-(P2-1-k))
        hr[n_part - 1 - p] = spec.real.astype(np.float32)
        hi[n_part - 1 - p] = spec.imag.astype(np.float32)
    return hr, hi


def conv_superblock_big(x, hr, hi, hist_r, hist_i, overlap):
    """Convolve ONE superblock against a superblock-grain partitioned IR.

    Args:
      x: f32[T] input superblock (T frames).
      hr, hi: f32[P2, T+1] partition spectra from prepare_ir_big (reversed).
      hist_r, hist_i: f32[P2-1, T+1] spectra of the previous P2-1
        superblocks, oldest first.
      overlap: f32[T] carried second half of the last inverse transform.

    Returns (y f32[T], hist_r', hist_i', overlap').
    """
    from graphaudio_tpu.ops.fft import BigRealDft

    T = x.shape[-1]
    dft = BigRealDft(T, 2 * T)
    xr, xi = dft.forward(x[None, :])  # [1, T+1]
    seq_r = jnp.concatenate([hist_r, xr], axis=0)  # [P2, T+1] oldest first
    seq_i = jnp.concatenate([hist_i, xi], axis=0)
    # acc[b] = sum_p H[p,b] * delay[p][b]; hr/hi are pre-reversed so the
    # delay line multiplies in storage order.
    acc_r = jnp.sum(seq_r * hr - seq_i * hi, axis=0)
    acc_i = jnp.sum(seq_r * hi + seq_i * hr, axis=0)
    y_full = dft.inverse(acc_r[None, :], acc_i[None, :])[0]  # [2T]
    y = y_full[:T] + overlap
    return y, seq_r[1:], seq_i[1:], y_full[T:]


def conv_superblock_sub(x, hr, hi, hist_r, hist_i, overlap):
    """Sub-blocked form of conv_superblock_big: L sub-blocks of B = T/L.

    conv_superblock_big runs its 2T-point transforms at batch 1 — poor
    matmul batching. Uniform partitioned convolution is parallel across sub-blocks
    once every input spectrum is available, so a superblock can split into
    L sub-blocks of B frames: one batch-L forward 2B-point DFT, a windowed
    complex correlation along the partition axis (the same accumulation as
    PartitionedConvolver.cs:154-223, at grain B instead of 128), one batch-L
    inverse, and a shifted overlap-add. Same linear convolution, with
    L-fold wider DFT matmuls (probe: benchmarks.probe conv-subblock-dft).

    Args:
      x: f32[T] input superblock; T must be a multiple of B.
      hr, hi: f32[P, B+1] grain-B partition spectra from
        prepare_ir_big(ir, B), partition-REVERSED (newest-input row last).
      hist_r, hist_i: f32[P-1, B+1] spectra of the previous P-1 sub-blocks,
        oldest first.
      overlap: f32[B] carried second half of the last inverse transform.

    Returns (y f32[T], hist_r', hist_i', overlap').
    """
    from graphaudio_tpu.ops.fft import BigRealDft

    T = x.shape[-1]
    P, bins = hr.shape
    B = bins - 1
    L = T // B
    dft = BigRealDft(B, 2 * B)
    xr, xi = dft.forward(x.reshape(L, B))  # [L, B+1]
    seq_r = jnp.concatenate([hist_r, xr], axis=0)  # [P-1+L, B+1] oldest first
    seq_i = jnp.concatenate([hist_i, xi], axis=0)
    # windows along the sub-block axis: win[l] = seq[l : l+P]; hr/hi are
    # pre-reversed so each window multiplies in storage order.
    win_r = jnp.stack([seq_r[l : l + P] for l in range(L)])  # [L, P, B+1]
    win_i = jnp.stack([seq_i[l : l + P] for l in range(L)])
    acc_r = jnp.sum(win_r * hr - win_i * hi, axis=1)  # [L, B+1]
    acc_i = jnp.sum(win_r * hi + win_i * hr, axis=1)
    y_full = dft.inverse(acc_r, acc_i)  # [L, 2B]
    heads = y_full[:, :B]
    tails = jnp.concatenate([overlap[None, :], y_full[:-1, B:]], axis=0)
    y = (heads + tails).reshape(T)
    return y, seq_r[L:], seq_i[L:], y_full[-1, B:]


def conv_superblock_big_sharded(x, hr_shard, hi_shard, hist_r, hist_i,
                                overlap, part_axis: str):
    """conv_superblock_big with the partition axis SPLIT over a mesh axis.

    Runs inside shard_map: ``hr_shard``/``hi_shard`` are this device's rows
    [P_local, T+1] of the (reversed, possibly zero-padded) spectra; input and
    delay line are replicated. Each device MACs its own partitions and a
    psum over ``part_axis`` completes the accumulation — the distributed
    form of the reference's partition loop (PartitionedConvolver.cs:171-221).
    """
    from graphaudio_tpu.ops.fft import BigRealDft

    T = x.shape[-1]
    dft = BigRealDft(T, 2 * T)
    xr, xi = dft.forward(x[None, :])
    seq_r = jnp.concatenate([hist_r, xr], axis=0)  # [P2p, T+1]
    seq_i = jnp.concatenate([hist_i, xi], axis=0)
    pl = hr_shard.shape[0]
    d = jax.lax.axis_index(part_axis)
    lr = jax.lax.dynamic_slice_in_dim(seq_r, d * pl, pl, axis=0)
    li = jax.lax.dynamic_slice_in_dim(seq_i, d * pl, pl, axis=0)
    acc_r = jax.lax.psum(
        jnp.sum(lr * hr_shard - li * hi_shard, axis=0), part_axis
    )
    acc_i = jax.lax.psum(
        jnp.sum(lr * hi_shard + li * hr_shard, axis=0), part_axis
    )
    y_full = dft.inverse(acc_r[None, :], acc_i[None, :])[0]
    y = y_full[:T] + overlap
    return y, seq_r[1:], seq_i[1:], y_full[T:]
