"""Convolution reverb node (parity: GraphAudio.Core/Nodes/ConvolverNode.cs:10).

Setting ``buffer`` builds one partitioned-FFT convolver per IR channel
(ConvolverNode.cs:51-77). A 4-channel IR with ``enable_true_stereo`` becomes a
2-in/2-out True-Stereo matrix: outL = L*ir0 + R*ir2, outR = L*ir1 + R*ir3
(:127-144); otherwise N discrete channels with the input forced to the IR
channel count via Explicit mode (:73-76). The IR's sample rate must match the
context's (:48-49).
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.core.node import AudioNode, ChannelCountMode
from graphaudio_tpu.ops.convolve import (
    NUM_BINS,
    conv_superblock,
    conv_superblock_big,
    conv_superblock_big_sharded,
    conv_superblock_sub,
    prepare_ir,
    prepare_ir_big,
)

# Superblocks of >= this many frames partition the IR at big grain (2B-point
# factorized transforms) instead of 128-sample grain; same linear
# convolution, far less spectral-MAC traffic for long IRs.
_BIG_BLOCK_MIN = 1024

# Preferred sub-block grain for the big path: splitting a superblock of T
# frames into L = T/B sub-blocks batches the forward/inverse DFTs L-wide
# into one matmul each (probe: benchmarks.probe conv-subblock-dft).
_SUB_GRAIN_TARGET = 1024
_SUB_GRAIN_MIN = 512
# The dispatch in process() distinguishes the 128-quantum path from the big
# path by spectra width (bins == NUM_BINS means quantum grain); that holds
# only while no big grain can ever equal FRAMES_PER_BLOCK.
assert _SUB_GRAIN_MIN > FRAMES_PER_BLOCK, (
    "big-path grains must exceed the 128-frame quantum or the spectra-width "
    "dispatch in process() misroutes blocks"
)


def _pick_big_grain(T: int) -> int:
    """Largest multiple-of-128 divisor of T that is <= _SUB_GRAIN_TARGET;
    falls back to T (unsplit) if none >= _SUB_GRAIN_MIN exists."""
    b = min(_SUB_GRAIN_TARGET, T)
    b -= b % FRAMES_PER_BLOCK
    while b >= _SUB_GRAIN_MIN:
        if T % b == 0:
            return b
        b -= FRAMES_PER_BLOCK
    return T


class ConvolverNode(AudioNode):
    def __init__(self, context):
        super().__init__(context, input_count=1, output_count=1, name="Convolver")
        self._buffer = None
        # Raw IR channels; spectra are prepped lazily per grain so the same
        # buffer serves the 128-grain, sub-blocked, and part-sharded paths
        # (the grain depends on the mesh, which may be set after the buffer).
        self._ir_channels: Optional[List[np.ndarray]] = None
        self._prep_cache: dict = {}  # grain -> (H [K,P,bins], Hi)
        self._conv_inputs: List[int] = []  # input channel feeding convolver k
        self._is_true_stereo = False
        self._effective_output_channels = 0
        self.normalize = True  # parity: ConvolverNode.Normalize (:87)
        self.enable_true_stereo = True  # parity: EnableTrueStereo (:95)

    @property
    def buffer(self):
        return self._buffer

    @buffer.setter
    def buffer(self, value) -> None:
        if value is None:
            self._buffer = None
            self._ir_channels = None
            self._prep_cache = {}
            self._conv_inputs = []
            self._is_true_stereo = False
            self._effective_output_channels = 0
            self.inputs[0].set_channel_count_mode(ChannelCountMode.MAX)
            self._config_changed()
            return
        if not value.is_initialized:
            raise RuntimeError(
                "Impulse response buffer must be initialized before being "
                "assigned to the ConvolverNode."
            )
        if value.sample_rate != self.context.sample_rate:
            raise RuntimeError(
                "Impulse response buffer sample rate must match the audio "
                f"context sample rate. IR rate: {value.sample_rate}, context "
                f"rate: {self.context.sample_rate}."
            )
        channels = value.number_of_channels
        # Snapshot the IR channels (and the normalize flag, read at set time
        # like the reference, ConvolverNode.cs:51-77); spectra prep happens
        # lazily per grain in _prepped().
        self._ir_channels = [
            np.asarray(value.get_channel_data(i), np.float32)
            for i in range(channels)
        ]
        self._normalize_at_set = self.normalize
        self._prep_cache = {}
        self._buffer = value
        self._is_true_stereo = channels == 4 and self.enable_true_stereo
        if self._is_true_stereo:
            # Convolvers 0,1 read L; 2,3 read R (ConvolverNode.cs:137-143).
            self._conv_inputs = [0, 0, 1, 1]
            self._effective_output_channels = 2
            self.inputs[0].set_channel_count(2)
        else:
            self._conv_inputs = list(range(channels))
            self._effective_output_channels = channels
            self.inputs[0].set_channel_count(channels)
        self.inputs[0].set_channel_count_mode(ChannelCountMode.EXPLICIT)
        self._config_changed()

    # -- grain selection & lazy spectra prep ------------------------------------

    def _grain_for(self, mesh) -> int:
        """Partition grain for the current superblock geometry and mesh.

        0 = 128-sample quantum grain (short superblocks). Otherwise a
        big-path grain B <= T: the part-sharded path needs B == T (one
        spectrum per superblock so the delay line replicates cheaply), the
        single-device path sub-blocks to batch the DFTs into wider matmuls."""
        T = self.context.superblock * FRAMES_PER_BLOCK
        if T < _BIG_BLOCK_MIN:
            return 0
        if self.supports_part_sharding(mesh):
            return T
        return _pick_big_grain(T)

    def _prepped(self, grain: int):
        """(H, Hi) f32[K, P, bins] partition spectra at ``grain`` (cached)."""
        cached = self._prep_cache.get(grain)
        if cached is not None:
            return cached
        norm = getattr(self, "_normalize_at_set", self.normalize)
        prep = (
            (lambda ch: prepare_ir_big(ch, grain, norm))
            if grain
            else (lambda ch: prepare_ir(ch, norm))
        )
        prepared = [prep(ch) for ch in self._ir_channels]
        H = np.stack([p[0] for p in prepared])  # [K, P, bins] real
        Hi = np.stack([p[1] for p in prepared])  # [K, P, bins] imag
        # Bound the cache: only the current geometry's grain plus the
        # quantum grain can be live; a mesh toggling part-sharded <-> single
        # device must not keep every historical grain's spectra (megabytes
        # per grain for long IRs) resident.
        live = {0, grain, self._grain_for(getattr(self.context, "mesh", None))}
        for k in [k for k in self._prep_cache if k not in live]:
            del self._prep_cache[k]
        self._prep_cache[grain] = (H, Hi)
        return H, Hi

    def output_channel_counts(self, input_channels):
        if self._ir_channels is None:
            return [input_channels[0] if input_channels else 2]
        return [self._effective_output_channels]

    # -- multi-chip partition sharding -----------------------------------------
    #
    # The IR's partition axis splits over the mesh's 'part' axis: each device
    # MACs its own partitions against (replicated) past-input spectra and a
    # psum completes the accumulation — the distributed form of
    # PartitionedConvolver.cs:154-223. Proven standalone in
    # parallel/sharded.ShardedVoiceScene; this is the node-graph integration.

    # Partition axis of each stage const (graph.make_render_fn reads this
    # to place 'part' in the PartitionSpec): spectra are [K, P, bins].
    const_part_axes = {"conv_hr": 1, "conv_hi": 1}

    def supports_part_sharding(self, mesh) -> bool:
        return (
            self._ir_channels is not None
            and self.context.superblock * FRAMES_PER_BLOCK >= _BIG_BLOCK_MIN
            and mesh is not None
            and "part" in mesh.shape
            and int(mesh.shape["part"]) > 1
        )

    def _padded_parts(self, P: int, mesh) -> int:
        if not self.supports_part_sharding(mesh):
            return P
        n = int(mesh.shape["part"])
        return -(-P // n) * n

    def stage_consts(self, mesh) -> dict:
        """IR spectra as stage ARGUMENTS (program-cache reuse on IR swap;
        shardable over 'part'). Zero partitions pad the axis to the mesh's
        'part' size — their MAC contributions are exactly zero."""
        if self._ir_channels is None:
            return {}
        H, Hi = self._prepped(self._grain_for(mesh))
        K, P, bins = H.shape
        Pp = self._padded_parts(P, mesh)
        if Pp == P:
            return {"conv_hr": H, "conv_hi": Hi}
        # prepend zero partitions: rows are REVERSED (oldest first), so
        # padding goes before row 0 and the newest-input row stays last.
        pad = ((0, 0), (Pp - P, 0), (0, 0))
        return {"conv_hr": np.pad(H, pad), "conv_hi": np.pad(Hi, pad)}

    def init_state(self, info):
        if self._ir_channels is None:
            return {}
        mesh = getattr(self.context, "mesh", None)
        grain = self._grain_for(mesh)
        H, _ = self._prepped(grain)
        K, P, bins = H.shape
        if grain:
            P = self._padded_parts(P, mesh)
            return {
                "hist_r": np.zeros((K, P - 1, bins), np.float32),
                "hist_i": np.zeros((K, P - 1, bins), np.float32),
                "overlap": np.zeros((K, grain), np.float32),
            }
        return {
            "hist_r": np.zeros((K, P - 1, NUM_BINS), np.float32),
            "hist_i": np.zeros((K, P - 1, NUM_BINS), np.float32),
            "overlap": np.zeros((K, FRAMES_PER_BLOCK), np.float32),
        }

    def process(self, state, inputs, params, rc):
        x = inputs[0]  # [C, T]
        if self._ir_channels is None:
            # No IR: cleared output at the input channel count (:107-118).
            return state, [jnp.zeros_like(x)]

        S = rc.superblock
        T = x.shape[-1]
        sc = getattr(rc, "stage_consts", None) or {}
        part_axis = getattr(rc, "part_axis", None)
        if "conv_hr" in sc:
            # IR spectra as stage arguments (shardable; cache-reusable).
            # Under 'part' sharding these are this device's partition rows.
            hr = jnp.asarray(sc["conv_hr"])
            hi = jnp.asarray(sc["conv_hi"])
        else:
            # Closure fallback: reuse stage_consts() so grain AND partition
            # padding match init_state() exactly (both key off context.mesh;
            # diverging here would trace with mismatched hist/overlap shapes
            # under a part>1 mesh).
            c = self.stage_consts(getattr(self.context, "mesh", None))
            hr, hi = jnp.asarray(c["conv_hr"]), jnp.asarray(c["conv_hi"])
        grain = 0 if hr.shape[-1] == NUM_BINS else hr.shape[-1] - 1
        # Route input channels to convolver instances, then run all instances
        # as one vmapped batch.
        if grain:
            xs = jnp.stack([x[src] for src in self._conv_inputs])  # [K, T]
            if part_axis:
                conv = lambda *a: conv_superblock_big_sharded(  # noqa: E731
                    *a, part_axis=part_axis
                )
            elif grain == T:
                conv = conv_superblock_big
            else:
                conv = conv_superblock_sub
            y, new_hist_r, new_hist_i, new_overlap = jax.vmap(conv)(
                xs, hr, hi, state["hist_r"], state["hist_i"], state["overlap"]
            )
            # y: [K, T]
        else:
            xs = jnp.stack(
                [x[src].reshape(S, FRAMES_PER_BLOCK) for src in self._conv_inputs]
            )  # [K, S, 128]
            y, new_hist_r, new_hist_i, new_overlap = jax.vmap(conv_superblock)(
                xs, hr, hi, state["hist_r"], state["hist_i"], state["overlap"]
            )

        if self._is_true_stereo:
            out_l = y[0] + y[2]
            out_r = y[1] + y[3]
            out = jnp.stack([out_l, out_r])
        else:
            out = y

        new_state = {
            "hist_r": new_hist_r,
            "hist_i": new_hist_i,
            "overlap": new_overlap,
        }
        return new_state, [out.reshape(out.shape[0], rc.frames)]
