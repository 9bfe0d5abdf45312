"""3-D spatial panner: HRTF binaural rendering + closed-form direct path.

Parity target: GraphAudio.SteamAudio/Nodes/SpatialPannerNode.cs — 17 k-rate
params (:94-110), listener-relative direction in the listener basis
(:133-164), cone directivity (:166-204), distance attenuation with
Linear/Inverse/Exponential model override (:206-216, 263-284), occlusion with
3-band frequency-dependent transmission (:218-248), and HRTF rendering with
bilinear interpolation and a SpatialBlend 2D/3D crossfade (:250-260).

The reference delegates DSP to the closed-source Steam Audio (phonon) C++
library; here everything is closed-form JAX (direct path) plus an analytic
spherical-head HRTF (ops/hrtf.py) applied as per-quantum FIR matmuls.
The direct-path formulas are exactly the reference's; the HRIR set is a
documented substitute for phonon's measured HRTF.

All parameters are k-rate (one value per 128-frame quantum), matching the
reference (:119-131). Voices batch: many SpatialPannerNodes with the same
channel layout run as one vmapped stage.
"""

from __future__ import annotations

import enum
import math

import jax.numpy as jnp
import numpy as np

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.core.node import AudioNode, ChannelCountMode, ChannelInterpretation
from graphaudio_tpu.core.params import AutomationRate
from graphaudio_tpu.ops.hrtf import (
    build_hrir_grid,
    fir_freq_partitioned,
    fir_freq_per_block,
    hrir_grid_spectra,
    interp_hrir,
)
from graphaudio_tpu.ops.onepole import onepole_lowpass

_F32MAX = 3.4028235e38

# 3-band transmission crossover frequencies (phonon uses 800 Hz / 8 kHz).
XOVER_LOW_HZ = 800.0
XOVER_HIGH_HZ = 8000.0


class DistanceModelType(enum.Enum):
    """Parity: SpatialPannerNode.DistanceModelType (:42-47)."""

    LINEAR = "linear"
    INVERSE = "inverse"
    EXPONENTIAL = "exponential"


_hrir_cache = {}


def _hrir_grid(sample_rate: int) -> np.ndarray:
    grid = _hrir_cache.get(sample_rate)
    if grid is None:
        grid = build_hrir_grid(sample_rate)
        _hrir_cache[sample_rate] = grid
    return grid


class SpatialPannerNode(AudioNode):
    def __init__(self, context):
        super().__init__(context, input_count=1, output_count=1, name="SpatialPanner")
        self.inputs[0].set_channel_count(2)
        self.inputs[0].set_channel_count_mode(ChannelCountMode.CLAMPED_MAX)
        self.inputs[0].set_channel_interpretation(ChannelInterpretation.SPEAKERS)
        self._distance_model = DistanceModelType.INVERSE
        self._channels = 2
        # Measured-HRIR override (None = analytic spherical-head default).
        self._custom_hrir = None
        self._custom_hrir_uid = 0

        k = AutomationRate.K_RATE
        p = self.create_audio_param
        self.position_x = p("positionX", 0.0, -_F32MAX, _F32MAX, k)
        self.position_y = p("positionY", 0.0, -_F32MAX, _F32MAX, k)
        self.position_z = p("positionZ", 0.0, -_F32MAX, _F32MAX, k)
        self.orientation_x = p("orientationX", 1.0, -1.0, 1.0, k)
        self.orientation_y = p("orientationY", 0.0, -1.0, 1.0, k)
        self.orientation_z = p("orientationZ", 0.0, -1.0, 1.0, k)
        self.ref_distance = p("refDistance", 1.0, 0.0, _F32MAX, k)
        self.max_distance = p("maxDistance", 10000.0, 0.0, _F32MAX, k)
        self.rolloff_factor = p("rolloffFactor", 1.0, 0.0, _F32MAX, k)
        self.cone_inner_angle = p("coneInnerAngle", 360.0, 0.0, 360.0, k)
        self.cone_outer_angle = p("coneOuterAngle", 360.0, 0.0, 360.0, k)
        self.cone_outer_gain = p("coneOuterGain", 0.0, 0.0, 1.0, k)
        self.spatial_blend = p("spatialBlend", 1.0, 0.0, 1.0, k)
        self.occlusion = p("occlusion", 0.0, 0.0, 1.0, k)
        self.transmission_low = p("transmissionLow", 0.0, 0.0, 1.0, k)
        self.transmission_mid = p("transmissionMid", 0.0, 0.0, 1.0, k)
        self.transmission_high = p("transmissionHigh", 0.0, 0.0, 1.0, k)
        # Pristine occlusion compiles the band-split OUT of the kernel (all
        # three band gains are provably equal then); first touch recompiles
        # with the full 3-band crossover path.
        for prm in (self.occlusion, self.transmission_low,
                    self.transmission_mid, self.transmission_high):
            prm.notify_first_touch = True

    def _occlusion_active(self) -> bool:
        return any(
            prm.touched or prm.has_events() or prm._mod_outputs
            for prm in (self.occlusion, self.transmission_low,
                        self.transmission_mid, self.transmission_high)
        )

    @property
    def distance_model(self) -> DistanceModelType:
        return self._distance_model

    @distance_model.setter
    def distance_model(self, value: DistanceModelType) -> None:
        if value != self._distance_model:
            self._distance_model = value
            self._config_changed()  # formula baked into the kernel

    def output_channel_counts(self, input_channels):
        self._channels = input_channels[0] if input_channels else 2
        return [2]

    def load_hrir(self, source, n_azimuth=None, n_elevation=None,
                  length=None) -> None:
        """Use a MEASURED HRIR set (SOFA path, .npz path, or dict with
        ``hrir``/``azimuth_deg``/``elevation_deg``/``sample_rate``) instead
        of the analytic spherical-head model. The set is regridded onto the
        regular (elevation x azimuth) grid and flows through the same
        spectra + bilinear-interpolation pipeline.

        Parity: phonon's measured HRTF with bilinear interpolation
        (SpatialPannerNode.cs:250-260)."""
        from graphaudio_tpu.ops.hrtf import (
            N_AZIMUTH, N_ELEVATION, load_hrir_grid,
        )

        grid = load_hrir_grid(
            source, self.context.sample_rate,
            n_azimuth=n_azimuth or N_AZIMUTH,
            n_elevation=n_elevation or N_ELEVATION,
            length=length,
        )

        def do(ctx):
            self._custom_hrir = grid
            self._custom_hrir_uid += 1
            self._config_changed()

        self.context.execute_or_post(do)

    def clear_hrir(self) -> None:
        """Revert to the analytic spherical-head HRTF."""
        def do(ctx):
            self._custom_hrir = None
            self._custom_hrir_uid += 1
            self._config_changed()

        self.context.execute_or_post(do)

    def group_key(self, input_channels):
        # A per-node HRIR bakes node-specific constants into the kernel, so
        # such panners only group with themselves; panners sharing the
        # CONTEXT default (analytic or measured) batch together.
        if self.supports_part_sharding(getattr(self.context, "mesh", None)):
            # A long per-node HRIR under a 'part' mesh runs as a SINGLE
            # stage so its kernel-partition axis can shard over 'part'
            # (stage consts + psum, like the convolver). Nothing batches
            # away: a custom-HRIR panner only ever grouped with itself.
            return None
        if self._custom_hrir is not None:
            hrir_key = (self.node_id, self._custom_hrir_uid)
        elif self.context._default_hrir is not None:
            hrir_key = ("ctx-default", self.context._default_hrir_uid)
        else:
            hrir_key = None
        return ("spatial-panner", input_channels[0], self._distance_model,
                hrir_key, self._occlusion_active(), self._mod_signature())

    # -- multi-chip partition sharding -----------------------------------------
    #
    # A measured HRIR longer than 128 taps renders as uniform 128-tap
    # kernel PARTITIONS (fir_freq_partitioned). Under a mesh with a 'part'
    # axis, a per-node long-HRIR panner ships its grid spectra as stage
    # consts whose partition axis splits over 'part': each device MACs its
    # partitions against the replicated input-spectra timeline and a psum
    # completes the accumulation — the HRTF FIR's analogue of the
    # convolver's IR-partition sharding. Panners on the context-default
    # grid keep voice batching instead (their groups shard over 'voice').

    # Partition axis of each stage const (graph.make_render_fn reads this
    # to place 'part' in the PartitionSpec): spectra are [E, A, 2, P, B].
    const_part_axes = {"hrtf_sr": 3, "hrtf_si": 3}

    def supports_part_sharding(self, mesh) -> bool:
        from graphaudio_tpu.ops.hrtf import hrir_partition_count

        return (
            self._custom_hrir is not None
            and hrir_partition_count(self._custom_hrir.shape[-1]) > 1
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
        """Grid spectra as stage ARGUMENTS for the single-stage (part-
        shardable) path. The partition axis pads with ZERO kernel
        partitions to the mesh's 'part' size — a zero partition applied to
        an older input quantum contributes exactly zero."""
        from graphaudio_tpu.ops.hrtf import hrir_grid_spectra

        grid = self._active_grid(self.context.sample_rate)
        sr, si = hrir_grid_spectra(grid)  # [E, A, 2, P, B] (P > 1 here)
        P = sr.shape[-2]
        Pp = self._padded_parts(P, mesh)
        if Pp != P:
            pad = [(0, 0)] * 3 + [(0, Pp - P), (0, 0)]
            sr = np.pad(sr, pad)
            si = np.pad(si, pad)
        return {"hrtf_sr": sr, "hrtf_si": si}

    def _active_grid(self, sample_rate):
        """The HRIR grid this panner renders with (per-node custom >
        context default > analytic spherical head)."""
        if self._custom_hrir is not None:
            return self._custom_hrir
        if self.context._default_hrir is not None:
            return self.context._default_hrir
        return _hrir_grid(sample_rate)

    def init_state(self, info):
        c = self._channels
        from graphaudio_tpu.ops.hrtf import hrir_partition_count, hrtf_fft_size

        grid = self._active_grid(self.context.sample_rate)
        fft = hrtf_fft_size(grid.shape[-1])
        state = {
            # Overlap-add tail of the binaural render (frequency-domain
            # per-quantum HRIR filter; see ops/hrtf.fir_freq_per_block).
            "ola": np.zeros((2, fft - FRAMES_PER_BLOCK), np.float32),
            # One-pole crossover states for 3-band transmission, per channel.
            "xlow": np.zeros((c,), np.float32),
            "xhigh": np.zeros((c,), np.float32),
        }
        P = hrir_partition_count(grid.shape[-1])
        # Zero-padded partitions under a 'part' mesh lengthen the ring (the
        # partition loop reaches back Pp-1 quanta); their contributions are
        # exactly zero, so the padded and unpadded rings render identically.
        P = self._padded_parts(P, getattr(self.context, "mesh", None))
        if P > 1:
            # Partitioned-kernel history: packed input spectra plus the
            # source direction (from which the kernel is re-interpolated)
            # for the P-1 quanta preceding the superblock.
            state["hx"] = np.zeros((P - 1, fft + 2), np.float32)
            state["haz"] = np.zeros((P - 1,), np.float32)
            state["hel"] = np.zeros((P - 1,), np.float32)
        return state

    # -- direct path (closed-form, parity :133-284) ---------------------------

    def _direct_gains(self, params, listener, rc):
        """Per-block direction, blend, and 3 band gains. All f32[S]."""
        pb = lambda name: params[name].per_block()
        px, py, pz = pb("positionX"), pb("positionY"), pb("positionZ")
        lp = listener["listener_pos"]
        wd = jnp.stack([px - lp[0], py - lp[1], pz - lp[2]])  # [3, S] world
        distance = jnp.sqrt(wd[0] ** 2 + wd[1] ** 2 + wd[2] ** 2)

        near = distance <= 1e-4
        inv = jnp.where(near, 0.0, 1.0 / jnp.maximum(distance, 1e-9))
        wdn = wd * inv  # normalized world direction (zero when degenerate)

        right, up, ahead = (
            listener["listener_right"],
            listener["listener_up"],
            listener["listener_ahead"],
        )
        # Listener-space direction (SpatialPannerNode.cs:153-158); straight
        # ahead is (0, 0, -1) when degenerate (:162).
        dx = wdn[0] * right[0] + wdn[1] * right[1] + wdn[2] * right[2]
        dy = wdn[0] * up[0] + wdn[1] * up[1] + wdn[2] * up[2]
        dz = wdn[0] * ahead[0] + wdn[1] * ahead[1] + wdn[2] * ahead[2]
        dx = jnp.where(near, 0.0, dx)
        dy = jnp.where(near, 0.0, dy)
        dz = jnp.where(near, -1.0, dz)
        distance = jnp.where(near, 0.0, distance)

        # Cone directivity (:166-204).
        ox, oy, oz = pb("orientationX"), pb("orientationY"), pb("orientationZ")
        inner, outer = pb("coneInnerAngle"), pb("coneOuterAngle")
        outer_gain = pb("coneOuterGain")
        omag = jnp.sqrt(ox * ox + oy * oy + oz * oz)
        o_ok = omag > 1e-4
        oinv = jnp.where(o_ok, 1.0 / jnp.maximum(omag, 1e-9), 0.0)
        dot = jnp.clip(
            -(ox * wdn[0] + oy * wdn[1] + oz * wdn[2]) * oinv, -1.0, 1.0
        )
        angle = jnp.abs(jnp.arccos(dot) * (180.0 / math.pi))
        half_inner, half_outer = inner * 0.5, outer * 0.5
        t = (angle - half_inner) / jnp.maximum(half_outer - half_inner, 1e-6)
        directivity = jnp.where(
            angle <= half_inner,
            1.0,
            jnp.where(angle >= half_outer, outer_gain, 1.0 + t * (outer_gain - 1.0)),
        )
        cone_active = ((inner < 360.0) | (outer < 360.0)) & o_ok
        directivity = jnp.where(cone_active, directivity, 1.0)

        # Distance attenuation (:206-216, 263-284).
        ref, mx, rolloff = pb("refDistance"), pb("maxDistance"), pb("rolloffFactor")
        dc = jnp.clip(distance, ref, mx)
        if self._distance_model == DistanceModelType.LINEAR:
            atten = 1.0 - rolloff * (dc - ref) / jnp.maximum(mx - ref, 1e-9)
        elif self._distance_model == DistanceModelType.EXPONENTIAL:
            atten = jnp.power(jnp.maximum(dc / jnp.maximum(ref, 1e-9), 1e-9), -rolloff)
        else:  # inverse: phonon's InverseDistance model, minDistance = ref
            atten = jnp.where(distance <= ref, 1.0, ref / jnp.maximum(distance, 1e-9))
        atten = jnp.clip(atten, 0.0, 1.0)

        # Occlusion + 3-band transmission (:218-248). Documented semantics:
        # occlusion 0 = unoccluded, 1 = fully occluded; when occluded, each
        # band passes (1-occ) + occ*transmission[band].
        occ = pb("occlusion")
        tl, tm, th = (
            pb("transmissionLow"),
            pb("transmissionMid"),
            pb("transmissionHigh"),
        )
        any_trans = (tl > 0.0) | (tm > 0.0) | (th > 0.0)

        def band(tr):
            g_trans = (1.0 - occ) + occ * tr
            g_occl = 1.0 - occ
            return jnp.where(occ > 0.0, jnp.where(any_trans, g_trans, g_occl), 1.0)

        base = atten * directivity
        gains = (base * band(tl), base * band(tm), base * band(th))
        blend = pb("spatialBlend")
        return dx, dy, dz, gains, blend

    def _split_bands(self, x, state, rc):
        """3-band split via two one-pole lowpasses.

        Crossover frequencies are compile-time constants, so each lowpass is
        an exact blocked matmul (ops/onepole.py) rather than a per-sample
        scan — matmul work with no sequential dependency inside a block.
        """
        sr = rc.sample_rate

        def lp(sig, hist, hz):
            a = math.exp(-2.0 * math.pi * hz / sr)
            return onepole_lowpass(sig, a, hist)

        low, new_xlow = lp(x, state["xlow"], XOVER_LOW_HZ)
        lowmid, new_xhigh = lp(x, state["xhigh"], XOVER_HIGH_HZ)
        mid = lowmid - low
        high = x - lowmid
        return (low, mid, high), new_xlow, new_xhigh

    def process(self, state, inputs, params, rc):
        x = inputs[0]  # [C, T]
        C = x.shape[0]
        S = rc.superblock
        listener = rc.globals

        dx, dy, dz, (gl, gm, gh), blend = self._direct_gains(params, listener, rc)

        def expand(g):  # [S] -> [T]
            return jnp.repeat(g, FRAMES_PER_BLOCK, total_repeat_length=rc.frames)

        if self._occlusion_active():
            # Direct effect: per-band per-block gains (the reference applies
            # the DirectEffect in place on the input, :247-248).
            (low, mid, high), new_xlow, new_xhigh = self._split_bands(x, state, rc)
            direct = (
                low * expand(gl)[None] + mid * expand(gm)[None]
                + high * expand(gh)[None]
            )
        else:
            # Occlusion/transmission pristine: all band gains equal
            # attenuation*directivity, so the crossover split reduces to one
            # broadband gain — compiled out (first touch recompiles).
            direct = x * expand(gl)[None]
            new_xlow, new_xhigh = state["xlow"], state["xhigh"]

        # Binaural render: mono downmix -> per-quantum interpolated HRIR,
        # applied in the FREQUENCY domain (interpolating precomputed grid
        # spectra == spectrum of the interpolated HRIR, both linear).
        mono = jnp.mean(direct, axis=0).reshape(S, FRAMES_PER_BLOCK)
        azimuth = jnp.arctan2(dx, -dz)  # phonon convention: -z is ahead
        elevation = jnp.arcsin(jnp.clip(dy, -1.0, 1.0))
        sc = getattr(rc, "stage_consts", None) or {}
        part_axis = getattr(rc, "part_axis", None)
        if "hrtf_sr" in sc:
            # Single-stage path: spectra travel as stage arguments; under
            # 'part' sharding each device holds its local partition slab.
            sr_grid, si_grid = sc["hrtf_sr"], sc["hrtf_si"]
        else:
            grid_np = self._active_grid(rc.sample_rate)
            sr_grid, si_grid = hrir_grid_spectra(grid_np)
        new_state = {}
        if sr_grid.ndim == 5:
            # Measured kernel longer than one exact overlap-add transform:
            # uniformly partitioned per-quantum filter. The kernels of the
            # P-1 quanta preceding this superblock are re-interpolated from
            # the carried directions (2 scalars each) rather than carried
            # as spectra — one batched interp over P-1+S quanta. P here is
            # the GLOBAL (ring-sized) partition count; the spectra's own
            # partition axis may be a device-local shard.
            az_cat = jnp.concatenate([state["haz"], azimuth])
            el_cat = jnp.concatenate([state["hel"], elevation])
            hr = interp_hrir(jnp.asarray(sr_grid), az_cat, el_cat)
            hi = interp_hrir(jnp.asarray(si_grid), az_cat, el_cat)
            wet, new_ring, new_ola = fir_freq_partitioned(
                mono, hr, hi, state["hx"], state["ola"], part_axis=part_axis
            )
            new_state["hx"] = new_ring
            Pm1 = state["haz"].shape[0]  # = global P - 1
            new_state["haz"] = az_cat[-Pm1:]
            new_state["hel"] = el_cat[-Pm1:]
        else:
            hr = interp_hrir(jnp.asarray(sr_grid), azimuth, elevation)
            hi = interp_hrir(jnp.asarray(si_grid), azimuth, elevation)
            wet, new_ola = fir_freq_per_block(mono, hr, hi, state["ola"])
        wet = wet.reshape(2, rc.frames)

        # SpatialBlend crossfade (:250-260): 1 = fully spatialized.
        from graphaudio_tpu.core.mixing import adapt_channels

        dry = adapt_channels(direct, 2)
        b = expand(blend)[None]
        out = wet * b + dry * (1.0 - b)

        new_state.update(ola=new_ola, xlow=new_xlow, xhigh=new_xhigh)
        return new_state, [out]
