"""Sharded voice-bank renderer: voices x IR-partitions over a 2-D mesh.

A production spatial scene — N looping sources, per-voice gain and equal-power
pan, mixed into a shared partitioned-FFT reverb and master gain — expressed as
one ``shard_map``-ped render step over a ``Mesh`` with axes:

  * ``voice``: voice states/arenas sharded; local voices synthesize and
    pre-mix on-device, then one ``psum`` over NVLink yields the bus mix.
  * ``part``: the convolver's IR partition spectra shard along the partition
    axis; each device correlates its slice of the (replicated) spectral delay
    line with its local H, and a second ``psum`` completes the spectral MAC.

This is the multi-device equivalent of the reference's voice fan-in
(AudioNodeInput.cs:100-138) and of scaling long IRs beyond one chip
(PartitionedConvolver.cs:154-223). All shapes are static; the step jits once.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.ops.convolve import FFT_SIZE, NUM_BINS, prepare_ir, spectral_mac
from graphaudio_tpu.ops.fft import RealDft


def make_mesh(devices=None, voice_axis: int = 0, part_axis: int = 0) -> Mesh:
    """Factor the device list into a ('voice', 'part') mesh.

    With no explicit sizes, prefers a balanced 2-D factorization (e.g. 8
    devices -> 4x2) and falls back to all-voices when n is prime.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if voice_axis <= 0 and part_axis <= 0:
        # Balanced split: the largest divisor <= sqrt(n) becomes the part
        # axis (8 -> 4x2, 16 -> 4x4); prime n degenerates to all-voices.
        part_axis = 1
        for cand in range(2, int(np.sqrt(n)) + 1):
            if n % cand == 0:
                part_axis = cand
        voice_axis = n // part_axis
    elif voice_axis <= 0:
        voice_axis = n // part_axis
    elif part_axis <= 0:
        part_axis = n // voice_axis
    if voice_axis * part_axis != n:
        raise ValueError(f"{voice_axis}x{part_axis} != {n} devices")
    arr = np.array(devices).reshape(voice_axis, part_axis)
    return Mesh(arr, axis_names=("voice", "part"))


class ShardedVoiceScene:
    """A voice bank + shared conv-reverb renderer sharded over a mesh.

    Args:
      mesh: 2-D mesh with ('voice', 'part') axes.
      arenas: f32[V, L] per-voice mono source material (looped).
      ir: f32[ir_len] shared reverb impulse response (context rate).
      gains, pans: f32[V] per-voice mix controls.
      sample_rate, superblock: render geometry.

    V must divide by the 'voice' axis size; the IR partition count is padded
    to a multiple of the 'part' axis size.
    """

    def __init__(self, mesh: Mesh, arenas, ir, gains, pans,
                 sample_rate: int = 48000, superblock: int = 8,
                 master_gain: float = 0.5, normalize_ir: bool = True):
        self.mesh = mesh
        self.sample_rate = sample_rate
        self.superblock = superblock
        self.frames = superblock * FRAMES_PER_BLOCK
        self.master_gain = master_gain

        arenas = np.asarray(arenas, np.float32)
        self.V, self.L = arenas.shape
        nv = mesh.shape["voice"]
        npart = mesh.shape["part"]
        if self.V % nv:
            raise ValueError(f"voices {self.V} not divisible by voice axis {nv}")

        hr, hi = prepare_ir(np.asarray(ir, np.float32), normalize=normalize_ir)
        p_parts = hr.shape[0]
        pad = (-p_parts) % npart
        if pad:
            z = np.zeros((pad, NUM_BINS), np.float32)
            hr = np.concatenate([hr, z])
            hi = np.concatenate([hi, z])
        self.P = hr.shape[0]

        self.arenas = jnp.asarray(arenas)
        self.Hr = jnp.asarray(hr)
        self.Hi = jnp.asarray(hi)
        self.gains = jnp.asarray(np.asarray(gains, np.float32))
        self.pans = jnp.asarray(np.asarray(pans, np.float32))

        self._step = self._build_step()

    def init_state(self):
        return {
            "pos": jnp.zeros((self.V,), jnp.float64),
            # Per-channel spectral delay line, oldest first (replicated),
            # carried as split real/imag float32.
            "hist_r": jnp.zeros((2, self.P - 1, NUM_BINS), jnp.float32),
            "hist_i": jnp.zeros((2, self.P - 1, NUM_BINS), jnp.float32),
            "overlap": jnp.zeros((2, FRAMES_PER_BLOCK), jnp.float32),
        }

    def _build_step(self):
        mesh = self.mesh
        S, T, L = self.superblock, self.frames, self.L
        p_parts = self.P
        npart = mesh.shape["part"]
        p_local = p_parts // npart
        master = jnp.float32(self.master_gain)

        def voice_synth(arena, pos, gain, pan):
            """One voice: looped arena read + gain + equal-power pan -> [2, T]."""
            idx = (pos + jnp.arange(T, dtype=jnp.float64)) % L
            s = jnp.take(arena, idx.astype(jnp.int32)) * gain
            x = (pan + 1.0) * 0.5
            gl = jnp.cos(x * jnp.float32(math.pi / 2))
            gr = jnp.sin(x * jnp.float32(math.pi / 2))
            return jnp.stack([s * gl, s * gr])

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(
                P("voice", None),        # arenas [V, L]
                P("part", None),         # Hr [P, B]
                P("part", None),         # Hi [P, B]
                P("voice"),              # pos [V]
                P("voice"),              # gains
                P("voice"),              # pans
                P(),                     # hist_r [2, P-1, B] (replicated)
                P(),                     # hist_i
                P(),                     # overlap [2, 128] (replicated)
            ),
            out_specs=(P(), P(), P(), P("voice"), P()),
        )
        def step(arena_shard, hr_shard, hi_shard, pos_shard, gain_shard,
                 pan_shard, hist_r, hist_i, overlap):
            # ---- voice synthesis + local pre-mix, then NVLink psum ----
            voiced = jax.vmap(voice_synth)(arena_shard, pos_shard, gain_shard, pan_shard)
            local_mix = jnp.sum(voiced, axis=0)  # [2, T]
            mix = jax.lax.psum(local_mix, "voice")  # bus fan-in over NVLink

            # ---- partition-sharded spectral convolution ----
            dft = RealDft(FRAMES_PER_BLOCK, FFT_SIZE)
            xq = mix.reshape(2, S, FRAMES_PER_BLOCK)
            spec_r, spec_i = dft.forward(xq)  # [2, S, B] each
            seq_r = jnp.concatenate([hist_r, spec_r], axis=1)  # [2, P-1+S, B]
            seq_i = jnp.concatenate([hist_i, spec_i], axis=1)

            part_idx = jax.lax.axis_index("part")
            p0 = part_idx * p_local
            # Device d owns partitions [p0, p0+p_local); its correlation window
            # over the delay line is seq[P-1+s-p] for p in that range: a slice
            # of length S+p_local-1 starting at (P-1) - (p0 + p_local - 1).
            start = (p_parts - 1) - (p0 + p_local - 1)
            win_r = jax.lax.dynamic_slice_in_dim(seq_r, start, S + p_local - 1, axis=1)
            win_i = jax.lax.dynamic_slice_in_dim(seq_i, start, S + p_local - 1, axis=1)

            acc_r, acc_i = jax.vmap(
                lambda wr, wi: spectral_mac(wr, wi, hr_shard, hi_shard)
            )(win_r, win_i)  # [2, S, B] partial sums
            acc_r = jax.lax.psum(acc_r, "part")  # complete spectral MAC
            acc_i = jax.lax.psum(acc_i, "part")

            y_full = dft.inverse(acc_r, acc_i)  # [2, S, 256]
            first = y_full[..., :FRAMES_PER_BLOCK]
            second = y_full[..., FRAMES_PER_BLOCK:]
            prev = jnp.concatenate([overlap[:, None, :], second[:, :-1]], axis=1)
            wet = (first + prev).reshape(2, T) * master

            new_pos = (pos_shard + T) % L
            return wet, seq_r[:, S:], seq_i[:, S:], new_pos, second[:, -1]

        def wrapped(state, frame0=0):
            del frame0
            wet, hist_r, hist_i, new_pos, new_overlap = step(
                self.arenas, self.Hr, self.Hi, state["pos"], self.gains,
                self.pans, state["hist_r"], state["hist_i"], state["overlap"],
            )
            new_state = {
                "pos": new_pos,
                "hist_r": hist_r,
                "hist_i": hist_i,
                "overlap": new_overlap,
            }
            return new_state, wet

        return wrapped

    def render_step(self, state, frame0=0):
        """One superblock: returns (new_state, f32[2, T])."""
        return self._step(state, frame0)

    def jitted_step(self):
        return jax.jit(self._step)
