"""Source nodes: ConstantSource, Oscillator, AudioBufferSource.

All three are scheduled sources (parity: IAudioScheduledSourceNode.cs:8-25):
``start(when, offset, duration)`` is once-only, ``stop(when)`` is
first-stop-wins (a finite-duration start counts as the first stop — the
reference's ``_hasStopped`` guard), and an ``ended`` event fires when
playback finishes, after
which the node disposes itself (OscillatorNode.cs:163-172,
AudioBufferSourceNode.cs:378-389).

Design: the schedule (start/stop times) lives in the node's functional
state as float64 scalars; per-block and per-sample gating masks are computed
inside the jitted kernel, so voice start/stop is a state update — not a
recompile. Phase and playback positions are float64 carries, matching the
reference's double accumulators (OscillatorNode.cs:16,
AudioBufferSourceNode.cs:23).
"""

from __future__ import annotations

import enum
import math
from typing import Callable, List

import jax
import jax.numpy as jnp
import numpy as np

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.core.node import AudioNode
from graphaudio_tpu.core.params import AutomationRate

_HIGHEST = jax.lax.Precision.HIGHEST
from graphaudio_tpu.ops.resample import (
    canonical_bases,
    cr_weights,
    poly_matrix,
    split_positions,
)

_TWO_PI = 2.0 * math.pi
_INF = float("inf")


def _excl_cumsum(x):
    return jnp.cumsum(x) - x


class ScheduledSourceNode(AudioNode):
    """Shared scheduling machinery for one-shot sources."""

    wants_notify = True

    def __init__(self, context, output_count: int, name: str):
        super().__init__(context, input_count=0, output_count=output_count, name=name)
        self._has_started = False
        self._has_stopped = False
        self._ended_raised = False
        self._ended_callbacks: List[Callable] = []
        self._host_stop_time = _INF  # host mirror of the scheduled stop

    # -- events ---------------------------------------------------------------

    def on_ended(self, callback: Callable) -> None:
        """Subscribe to the ended event (parity: ``Ended`` event)."""
        self._ended_callbacks.append(callback)

    @property
    def is_playing(self) -> bool:
        return self._has_started and not self._ended_raised

    # -- scheduling (parity: OscillatorNode.Start/Stop :55-89) ------------------

    def _sched_state(self):
        return {
            "started": np.int32(0),
            "start_time": np.float64(_INF),
            "stop_time": np.float64(_INF),
        }

    def start(self, when: float = 0.0, offset: float = 0.0, duration: float = _INF):
        if self._has_started:
            raise RuntimeError(f"{self.name} can only be started once.")
        start_time = max(0.0, when)
        updates = {"started": 1, "start_time": start_time}
        # Subclass validation runs BEFORE any flag flips: a recoverable
        # error (e.g. start() before a buffer is set) must leave the node
        # startable once fixed, not poisoned by half-applied state.
        self._on_start(updates, offset, duration)
        self._has_started = True
        if math.isfinite(duration) and duration >= 0:
            self._has_stopped = True
            self._host_stop_time = start_time + duration
            updates["stop_time"] = self._host_stop_time

        def do(ctx):
            ctx.update_node_state(self, **updates)

        self.context.execute_or_post(do)
        return self

    def _on_start(self, updates: dict, offset: float, duration: float) -> None:
        """Subclass hook to add state updates at start time."""

    def stop(self, when: float = 0.0):
        # FIRST stop wins (parity: the reference's `if (_hasStopped) return`
        # guard, OscillatorNode.Stop :76-89): a later stop() is ignored, and
        # a finite-duration start() counts as the first stop. (The min() in
        # the reference's Stop is unreachable for the same reason — both
        # implementations keep the first scheduled stop time.)
        if self._has_stopped:
            return self
        self._has_stopped = True
        self._host_stop_time = min(self._host_stop_time, max(0.0, when))
        stop_time = self._host_stop_time

        def do(ctx):
            ctx.update_node_state(self, stop_time=stop_time)

        self.context.execute_or_post(do)
        return self

    # -- gating masks ---------------------------------------------------------

    @staticmethod
    def _active_mask(states, rc):
        """bool[..., S]: block plays (t1 > start and t0 < stop), gated on
        started. Broadcasts over any leading state dims — the same helper
        serves per-voice scalar states and a group's stacked [V] states
        (keeping the group kernels bit-identical to the per-voice paths)."""
        started = jnp.asarray(states["started"] > 0)
        return (
            started[..., None]
            & (rc.block_end_times
               > jnp.asarray(states["start_time"])[..., None])
            & (rc.block_times < jnp.asarray(states["stop_time"])[..., None])
        )

    def _block_active(self, state, rc):
        """[S] bool — per-voice view of _active_mask."""
        return self._active_mask(state, rc)

    def _sample_gate(self, state, rc):
        """[S, 128] bool: sample-accurate sub-block gate.

        Parity: OscillatorNode.cs:104-118 / ConstantSourceNode gating —
        startFrame = ceil((start-t0)*sr) when start falls inside the block,
        endFrame = floor((stop-t0)*sr) when stop falls inside the block.
        """
        active = self._block_active(state, rc)
        t0, t1 = rc.block_times, rc.block_end_times
        sr = jnp.float64(rc.sample_rate)
        start, stop = state["start_time"], state["stop_time"]
        start_f = jnp.where(
            (t0 < start) & (start < t1),
            jnp.clip(jnp.ceil((start - t0) * sr), 0, FRAMES_PER_BLOCK),
            0.0,
        )
        end_f = jnp.where(
            jnp.isfinite(stop) & (t0 < stop) & (stop < t1),
            jnp.clip(jnp.floor((stop - t0) * sr), 0, FRAMES_PER_BLOCK),
            float(FRAMES_PER_BLOCK),
        )
        # Per-block boundaries are small integers (exact in f32), so the
        # per-sample comparisons run in f32, not f64.
        i = jnp.arange(FRAMES_PER_BLOCK, dtype=jnp.float32)
        sf = start_f.astype(jnp.float32)
        ef = end_f.astype(jnp.float32)
        return active[:, None] & (i[None, :] >= sf[:, None]) & (
            i[None, :] < ef[:, None]
        )

    # -- host-side ended handling ------------------------------------------------

    def _device_may_end(self) -> bool:
        """True when the device kernel itself can shorten ``stop_time``
        (buffer exhaustion); such nodes must be polled after each render.
        Pure-schedule sources (oscillator, constant) only end at a host-
        scheduled stop."""
        return False

    def may_notify(self) -> bool:
        """Host-side screen: can this source possibly raise ``ended``?
        False for sources that never started, already ended, or can neither
        reach a finite scheduled stop nor self-stop on the device — the
        context then skips the post-render stop-time readback entirely."""
        if not self._has_started or self._ended_raised:
            return False
        return math.isfinite(self._host_stop_time) or self._device_may_end()

    def notify_rendered(self, state, end_time: float) -> None:
        if self._ended_raised or not self._has_started:
            return
        stop_time = float(np.asarray(jnp_to_np(state["stop_time"])))
        if math.isfinite(stop_time) and end_time >= stop_time:
            self._ended_raised = True
            for cb in self._ended_callbacks:
                try:
                    cb(self)
                except Exception:
                    pass
            # Self-dispose (parity: OscillatorNode.cs:163-172).
            self.dispose()


def jnp_to_np(x):
    return np.asarray(x)


class ConstantSourceNode(ScheduledSourceNode):
    """Emits the a-rate ``offset`` param (parity: ConstantSourceNode.cs:14).

    Typically used as a modulation source connected to other nodes' params.
    """

    def __init__(self, context):
        super().__init__(context, output_count=1, name="ConstantSource")
        self.offset = self.create_audio_param(
            "offset", 1.0, automation_rate=AutomationRate.A_RATE
        )

    def output_channel_counts(self, input_channels):
        return [1]

    def group_key(self, input_channels):
        return ("const-source", self._mod_signature())

    def init_state(self, info):
        return self._sched_state()

    def process(self, state, inputs, params, rc):
        gate = self._sample_gate(state, rc).reshape(-1)  # [T]
        vals = params["offset"].per_sample()
        out = jnp.where(gate, vals, 0.0)[None, :]
        return state, [out]


class OscillatorType(enum.Enum):
    """Parity: OscillatorNode.cs:208-214."""

    SINE = "sine"
    SQUARE = "square"
    SAWTOOTH = "sawtooth"
    TRIANGLE = "triangle"


class OscillatorNode(ScheduledSourceNode):
    """Periodic waveform generator (parity: OscillatorNode.cs:12).

    The reference accumulates a double phase per sample with a 2*pi wrap
    (:139-148). Here the phase is a float64 cumulative sum of the gated
    per-sample increments 2*pi*f/sr, wrapped with mod — identical within
    double rounding because increments never exceed pi (f <= Nyquist).
    """

    def __init__(self, context, type: OscillatorType = OscillatorType.SINE):
        super().__init__(context, output_count=1, name="Oscillator")
        self._type = type
        self.frequency = self.create_audio_param(
            "frequency",
            440.0,
            min_value=0.0,
            max_value=context.sample_rate / 2.0,
            automation_rate=AutomationRate.A_RATE,
        )
        # The phase accumulator INTEGRATES frequency values — 1-ulp noise
        # drifts audibly over seconds; linear curves evaluate in f64.
        self.frequency.exact_eval = True

    @property
    def type(self) -> OscillatorType:
        return self._type

    @type.setter
    def type(self, value: OscillatorType) -> None:
        if value != self._type:
            self._type = value
            self._config_changed()  # waveform is baked into the kernel

    def output_channel_counts(self, input_channels):
        return [1]

    def group_key(self, input_channels):
        return ("oscillator", self._type, self._mod_signature())

    def init_state(self, info):
        st = self._sched_state()
        st["phase"] = np.float64(0.0)
        return st

    def _on_start(self, updates, offset, duration):
        updates["phase"] = 0.0  # parity: OscillatorNode.cs:63

    def process(self, state, inputs, params, rc):
        # Phase accumulation uses f64 anchors once per 128-frame block and
        # f32 within the block: per-sample f64 costs far more than f32,
        # and f32 in-block phase error (~1e-7 rad) is far below
        # audibility while the f64 cross-block carry prevents drift.
        S = rc.superblock
        gate = self._sample_gate(state, rc)  # [S, 128]
        f = params["frequency"].per_sample().reshape(S, FRAMES_PER_BLOCK)
        inc = jnp.where(
            gate, jnp.float32(_TWO_PI / rc.sample_rate) * f, 0.0
        ).astype(jnp.float32)
        # Block phase sums in f64 (one f64 reduction per sample) so the
        # f32 increment's rounding bias cannot accumulate across blocks:
        # the f32 error is bounded by one block (~5e-7 rad), not the render.
        fgated = jnp.where(gate, f, 0.0).astype(jnp.float64)
        bsum = jnp.sum(fgated, axis=1) * (_TWO_PI / rc.sample_rate)  # [S]
        anchors = state["phase"] + jnp.concatenate(
            [jnp.zeros((1,), jnp.float64), jnp.cumsum(bsum)[:-1]]
        )
        anch32 = jnp.mod(anchors, _TWO_PI).astype(jnp.float32)  # [S]
        local = jnp.cumsum(inc, axis=1) - inc  # exclusive in-block cumsum
        phase = jnp.mod(
            anch32[:, None] + local, jnp.float32(_TWO_PI)
        ).reshape(-1)  # f32[T]

        t = self._type
        if t == OscillatorType.SINE:
            wave = jnp.sin(phase)
        elif t == OscillatorType.SQUARE:
            wave = jnp.where(phase < jnp.float32(math.pi), 1.0, -1.0)
        elif t == OscillatorType.SAWTOOTH:
            wave = 2.0 * (phase / jnp.float32(_TWO_PI)) - 1.0
        else:  # TRIANGLE
            u = phase / jnp.float32(_TWO_PI)
            wave = 4.0 * jnp.abs(u - jnp.floor(u + 0.5)) - 1.0

        out = jnp.where(gate.reshape(-1), wave, 0.0).astype(jnp.float32)[None, :]
        new_state = dict(state)
        new_state["phase"] = jnp.mod(state["phase"] + jnp.sum(bsum), _TWO_PI)
        return new_state, [out]


class AudioBufferSourceNode(ScheduledSourceNode):
    """Scheduled playback of a PlayableAudioBuffer.

    Parity: AudioBufferSourceNode.cs:13. Two kernels, selected statically:

    * **Unity-rate path** (buffer rate == context rate and ``playback_rate``
      never touched): exact block copies with loop wraparound and modulo
      overshoot (reference :186-235), including the reference's behavior of
      clearing the entire final block of a non-looping playback
      (``!hasMoreData || pos >= durationEnd`` after ``pos += 128``, :360-368).

    * **Resampling path**: the stateful CubicResampler loop (:236-358)
      reformulated as closed-form positions x_j = x_0 + j*rate with 4-tap
      Catmull-Rom gathers (see ops/resample.py). Known deviations from the
      reference, documented: (a) blocks where the effective rate happens to
      equal exactly 1.0 still use the resampler (the reference switches to the
      copy path, which plays one sample earlier); (b) the final partial block
      of a non-looping stream keeps its real samples (the reference sometimes
      clears it).

    Playback position and resample position are float64 (exact for any
    realistic buffer length).
    """

    def __init__(self, context):
        super().__init__(context, output_count=1, name="AudioBufferSource")
        self._buffer = None
        self._loop = False
        self._loop_start = 0.0
        self._loop_end = 0.0
        self.playback_rate = self.create_audio_param(
            "playbackRate",
            1.0,
            min_value=0.001,
            max_value=1000.0,
            automation_rate=AutomationRate.K_RATE,
        )
        # The resampler INTEGRATES this rate into positions, so its curve
        # must evaluate with the reference's exact f64 arithmetic.
        self.playback_rate.exact_eval = True
        # Pristine playbackRate enables the exact unity-rate kernel; first
        # touch recompiles into the general resampling kernel.
        self.playback_rate.notify_first_touch = True

    # -- buffer & loop configuration -------------------------------------------

    def _device_may_end(self) -> bool:
        # A non-looping buffer exhausts on device (kernel shortens
        # stop_time); a looping one can only end at a scheduled stop.
        return not self._loop

    @property
    def buffer(self):
        return self._buffer

    @buffer.setter
    def buffer(self, value) -> None:
        if self._has_started:
            raise RuntimeError("Cannot change buffer after playback started")
        self._buffer = value
        self._config_changed()  # sample data is baked into the kernel

    @property
    def loop(self) -> bool:
        return self._loop

    @loop.setter
    def loop(self, value: bool) -> None:
        if bool(value) != self._loop:
            self._loop = bool(value)
            self._config_changed()  # loop layout is baked into the sample region

    @property
    def loop_start(self) -> float:
        return self._loop_start

    @loop_start.setter
    def loop_start(self, value: float) -> None:
        self._loop_start = max(0.0, value)
        self._config_changed()

    @property
    def loop_end(self) -> float:
        return self._loop_end

    @loop_end.setter
    def loop_end(self, value: float) -> None:
        self._loop_end = max(0.0, value)
        self._config_changed()

    def output_channel_counts(self, input_channels):
        c = self._buffer.number_of_channels if self._buffer is not None else 1
        return [c]

    def loop_frames(self):
        """Static loop bounds in buffer frames (parity trunc semantics,
        AudioBufferSourceNode.cs:171-177)."""
        br = self._buffer.sample_rate
        L = self._buffer.length
        lsf = int(self._loop_start * br)
        lef = int(self._loop_end * br) if self._loop_end > 0 else L
        lef = min(lef, L)
        lsf = min(lsf, lef)
        return lsf, lef, lef - lsf

    def rate_bound(self) -> int:
        """Static pow2 upper bound on the effective resampling rate.

        Sizes the per-superblock read window; outgrowing it (a playbackRate
        scheduled above the compiled bound) triggers a recompile. An
        audio-rate modulation input has no static bound, so it gets 2x
        headroom over the scheduled maximum; the kernel clamps the evaluated
        rate to the compiled bound (graceful rate ceiling, not garbage
        reads) — see _process_resample.
        """
        if self._buffer is None or self._static_unity_rate_cfg():
            return 1
        mx = self.playback_rate.max_scheduled_value()
        if self.playback_rate._mod_outputs:
            mx = max(2.0 * mx, 2.0)
        eff = (self._buffer.sample_rate / self.context.sample_rate) * mx
        b = 1
        while b < eff:
            b *= 2
        return b

    def _static_unity_rate_cfg(self) -> bool:
        return (
            self._buffer is not None
            and self._buffer.sample_rate == self.context.sample_rate
            and not self.playback_rate.touched
            and not self.playback_rate._mod_outputs
        )

    def static_ratio(self):
        """(p, q) when the effective rate is a STATIC exact rational, else None.

        Covers the dominant game-audio case (constant sample-rate conversion,
        e.g. 44.1 kHz assets in a 48 kHz context -> 147/160): the playbackRate
        param has no automation events, no modulation input, and a value whose
        product with bufferRate/contextRate is exactly rational with a small
        denominator. Floats are dyadic rationals, so Fraction(value) is exact
        — a value like 1.1 yields an astronomically large q and correctly
        falls back to the general time-varying kernel.
        """
        pr = self.playback_rate
        if self._buffer is None or pr.has_events() or pr._mod_outputs:
            return None
        try:
            from fractions import Fraction

            f = Fraction(self._buffer.sample_rate, self.context.sample_rate)
            f = f * Fraction(float(pr.value))
        except (ValueError, ZeroDivisionError, OverflowError):
            return None
        p, q = f.numerator, f.denominator
        # H is [p+4, q]; cap its footprint (~4 MB) and reject degenerate rates.
        if p <= 0 or p * q > (1 << 20):
            return None
        return (int(p), int(q))

    def kernel_variant(self):
        """Static kernel selection: ("unity", aligned) exact copy path,
        ("poly", p, q) static polyphase matmul, or ("resample", bound)
        general time-varying path. Baked into group_key and the compiled
        program; the context recompiles when a node's variant changes
        (CompiledGraph.static_config_stale).

        ``aligned``: the playback position stays a multiple of 128 forever
        (start offset lands on a block boundary; loop length is a multiple
        of 128, which wraps preserve since the loop-start term cancels mod
        128) — window reads then reduce to pure row gathers with NO
        lane-shift matmul (measured ~1/3 of the unity stage's cost)."""
        if self._buffer is None:
            return ("none",)
        if self._static_unity_rate_cfg():
            pos0 = float(self._state_overrides.get("pos", 0.0)) \
                if hasattr(self, "_state_overrides") else 0.0
            aligned = pos0 % FRAMES_PER_BLOCK == 0.0
            if self._loop:
                _, _, llen = self.loop_frames()
                aligned = aligned and llen % FRAMES_PER_BLOCK == 0
            return ("unity", aligned)
        r = self.static_ratio()
        if r is not None:
            return ("poly",) + r
        return ("resample", self.rate_bound())

    @staticmethod
    def _poly_geometry(superblock: int, p: int, q: int):
        """Static shapes of the polyphase kernel: T outputs need ncan
        canonical chunks of p input samples (+ nb extra chunks so the
        overlapping length-M slabs can be built from static reshapes), read
        from a window of w samples starting up to front before the voice
        position (the phase-alignment shift m0 < p)."""
        T = superblock * FRAMES_PER_BLOCK
        ncan = (T + q - 1) // q + 1
        M = p + 4
        nb = -(-M // p)
        w = (ncan + nb) * p + 8
        front = p + 8
        return T, ncan, M, nb, w, front

    @classmethod
    def poly_window(cls, superblock: int, p: int, q: int):
        _, _, _, _, w, front = cls._poly_geometry(superblock, p, q)
        return w, front

    def build_region(self, w_max: int, front: int = 0):
        """Sample region for window-sliced playback: ``front`` zeros (the
        polyphase kernel's phase-alignment headroom), then the buffer,
        followed by either a zero pad (non-loop) or the loop content tiled
        twice-plus-a-window so any superblock's reads are LINEAR (wraps
        become reads into the periodic extension). geom["region_len"] is
        the extension length EXCLUDING front — kernels address extension
        coordinates and the window slice adds front.
        Returns (region f32[C, front+n], geom dict)."""
        data = self._buffer.data
        C, L = data.shape
        lsf, lef, llen = self.loop_frames()
        looping = self._loop and llen > 0
        if looping:
            n_ext = 2 * llen + w_max + 8
            reps = -(-n_ext // llen)
            tiled = np.tile(data[:, lsf:lef], (1, reps))[:, :n_ext]
            region = np.concatenate([data[:, :lsf], tiled], axis=1)
        else:
            pad = np.zeros((C, w_max + 8), np.float32)
            region = np.concatenate([data, pad], axis=1)
        ext_len = region.shape[1]
        if front:
            region = np.concatenate(
                [np.zeros((C, front), np.float32), region], axis=1
            )
        geom = {
            "length": np.float64(L),
            "rate": np.float64(self._buffer.sample_rate),
            "lsf": np.float64(lsf),
            "lef": np.float64(lef),
            "llen": np.float64(llen),
            "looping": np.bool_(looping),
            "loop_flag": np.bool_(self._loop),
            "region_len": np.int32(ext_len),
            "front": np.int32(front),
        }
        return np.ascontiguousarray(region), geom

    def group_key(self, input_channels):
        if self._buffer is None or self._params_modulated():
            return None
        # Voices with the same channel count and kernel variant (unity copy /
        # static polyphase ratio / general window bound) share one vmapped
        # stage over a packed sample arena.
        return ("buffer-source", self._buffer.number_of_channels,
                self.kernel_variant())

    # -- state --------------------------------------------------------------------

    def init_state(self, info):
        st = self._sched_state()
        st.update(
            offset=np.float64(0.0),
            duration=np.float64(_INF),
            pos=np.float64(0.0),
            x=np.float64(0.0),
            primed=np.int32(0),
        )
        return st

    def _on_start(self, updates, offset, duration):
        if self._buffer is None:
            raise RuntimeError("Cannot start without a buffer set")
        if not self._buffer.is_initialized:
            raise RuntimeError("Buffer is not initialized")
        off = max(0.0, offset)
        updates["offset"] = off
        updates["duration"] = duration if duration >= 0 else _INF
        # playbackPosition = offset * buffer rate (AudioBufferSourceNode.cs:96)
        updates["pos"] = float(int(off * self._buffer.sample_rate))
        updates["primed"] = 0

    # -- kernel -----------------------------------------------------------------
    #
    # Window-sliced playback: per superblock each voice issues ONE
    # dynamic_slice of size W from the packed arena, then reads taps with
    # small LOCAL indices. Loop wraps never appear per sample — the region's
    # periodic extension (build_region) makes every superblock's reads linear.

    def _static_unity_rate(self, rc) -> bool:
        return self._static_unity_rate_cfg()

    @staticmethod
    def _duration_end(state, buffer_rate, length):
        """Duration end frame (f64), parity :179-182. Pure elementwise —
        broadcasts over stacked [V] states for the group kernels."""
        de = jnp.where(
            jnp.isfinite(state["duration"]),
            jnp.trunc(state["offset"] * buffer_rate)
            + jnp.trunc(state["duration"] * buffer_rate),
            length,
        )
        return jnp.minimum(de, length)

    # Resample windows tile into overlapping HOP-strided rows so per-block
    # band extraction is a tiny row gather; interpolation is one batched
    # matmul against a 4-banded weight matrix instead of per-sample element
    # gathers.
    _HOP = 64

    @classmethod
    def _tile_len(cls, bound: int) -> int:
        need = FRAMES_PER_BLOCK * bound + cls._HOP + 8
        return -(-need // cls._HOP) * cls._HOP

    @classmethod
    def _window_w(cls, superblock: int, bound: int, unity: bool) -> int:
        t = superblock * FRAMES_PER_BLOCK
        if unity:
            return t + 16
        n_tiles = (t * bound) // cls._HOP + 3
        return (n_tiles - 1) * cls._HOP + cls._tile_len(bound)

    def _map_ext(self, p, geom):
        """Map an original-coordinate position into the region's periodic
        extension once per superblock; reads proceed linearly from there."""
        lsf, llen = geom["lsf"], geom["llen"]
        looping = geom["looping"]
        q = jnp.mod(p - lsf, jnp.maximum(llen, 1.0))
        return jnp.where(looping & (p >= lsf), lsf + llen + q, p)

    def process(self, state, inputs, params, rc):
        if self._buffer is None:
            return state, [jnp.zeros((1, rc.frames), jnp.float32)]
        variant = self.kernel_variant()
        if variant[0] == "poly":
            w, front = self.poly_window(rc.superblock, variant[1], variant[2])
        elif variant[0] == "unity":
            w, front = self._window_w(rc.superblock, 1, True), 0
        else:
            w, front = self._window_w(rc.superblock, self.rate_bound(), False), 0
        cache_key = (w, front, self._loop, self._loop_start, self._loop_end,
                     self._buffer.uid)
        if getattr(self, "_region_key", None) != cache_key:
            region, geom = self.build_region(w, front)
            self._region_key = cache_key
            self._region_cache = (region, geom)
        region, geom = self._region_cache
        geom = dict(geom)
        geom["off"] = np.int32(0)
        arena = jnp.asarray(region)
        if variant[0] == "unity":
            return self._process_unity(state, arena, geom, rc, w)
        if variant[0] == "poly":
            return self._process_poly(state, arena, geom, rc, w,
                                      variant[1], variant[2])
        return self._process_resample(
            state, arena, geom, params["playbackRate"].per_block(), rc, w
        )

    def _process_unity(self, state, arena, geom, rc, w: int):
        S = rc.superblock
        C = arena.shape[0]
        active = self._block_active(state, rc)  # [S]
        length = geom["length"]
        de = self._duration_end(state, geom["rate"], length)
        lef = geom["lef"]
        looping = geom["looping"]
        loop_flag = geom["loop_flag"]
        region_len = geom["region_len"]
        off = geom["off"]

        adv = jnp.where(active, float(FRAMES_PER_BLOCK), 0.0)
        pos_b = state["pos"] + _excl_cumsum(adv)  # [S] f64, original coords
        p0 = state["pos"]

        e0 = self._map_ext(p0, geom)
        start = jnp.clip(e0.astype(jnp.int32), 0, region_len - w)
        window = jax.lax.dynamic_slice(
            arena, (jnp.int32(0), off + geom["front"] + start), (C, w)
        )

        # Reads are linear from the window: active blocks within a superblock
        # form one contiguous run (start once / stop once), so block b's data
        # is the (b - first_active)-th static 128-frame chunk — a tiny row
        # gather instead of a per-sample gather.
        delta_b = (pos_b - p0).astype(jnp.int32)  # [S] = 128*(active before b)
        local0 = e0.astype(jnp.int32) - start
        blocks = window[:, :S * FRAMES_PER_BLOCK].reshape(
            C, S, FRAMES_PER_BLOCK
        )
        bidx = jnp.clip(delta_b // FRAMES_PER_BLOCK, 0, S - 1)
        samples = jnp.take(blocks, bidx, axis=1)
        # local0 is 0 except when the window was clamped at the region end
        # (positions past the buffer, masked below); a roll is unnecessary.
        del local0
        i = jnp.arange(FRAMES_PER_BLOCK, dtype=jnp.int32)

        # Validity in ORIGINAL coordinates (duration / degenerate loops).
        g = p0.astype(jnp.int32) + delta_b[:, None] + i[None, :]
        lef_i = lef.astype(jnp.int32)
        de_i = de.astype(jnp.int32)
        end_bound = jnp.where(loop_flag, jnp.minimum(lef_i, de_i), de_i)
        valid = jnp.where(looping, jnp.bool_(True), g < end_bound)
        out = jnp.where((active[:, None] & valid)[None], samples, 0.0)

        # Final-block clear + auto-stop (parity :360-368).
        pos_after = pos_b + FRAMES_PER_BLOCK
        any_valid = jnp.any(valid, axis=1)
        cleared = active & jnp.where(
            looping, ~any_valid, (pos_after >= de) | ~any_valid
        )
        out = jnp.where(cleared[None, :, None], 0.0, out)

        first_stop = jnp.min(jnp.where(cleared, rc.block_end_times, jnp.inf))
        new_stop = jnp.minimum(state["stop_time"], first_stop)

        lsf, llen = geom["lsf"], geom["llen"]
        new_pos = state["pos"] + jnp.sum(adv)
        new_pos = jnp.where(
            looping & (new_pos >= lef),
            lsf + jnp.mod(new_pos - lef, jnp.maximum(llen, 1.0)),
            new_pos,
        )

        new_state = dict(state)
        new_state["pos"] = new_pos
        new_state["stop_time"] = new_stop
        return new_state, [out.reshape(C, rc.frames)]

    @classmethod
    def resample_window_starts(cls, states, geom, w: int):
        """[V] absolute arena offsets of each voice's resample window —
        the same start `_process_resample` derives per voice, vectorized so
        the group can pre-fetch all windows gather-free."""
        x0 = jnp.where(states["primed"] > 0, states["x"], states["pos"] + 1.0)
        lsf, llen = geom["lsf"], geom["llen"]
        looping = geom["looping"]
        qmod = jnp.mod(x0 - lsf, jnp.maximum(llen, 1.0))
        e0 = jnp.where(looping & (x0 >= lsf), lsf + llen + qmod, x0)
        start = jnp.clip(
            jnp.floor(e0).astype(jnp.int32) - 1, 0,
            geom["region_len"].astype(jnp.int32) - w,
        )
        return geom["off"] + geom["front"] + start

    def _process_resample(self, state, arena, geom, playback_rate_pb, rc,
                          w: int, window=None):
        S = rc.superblock
        C = arena.shape[0]
        active = self._block_active(state, rc)  # [S]
        length = geom["length"]
        de = self._duration_end(state, geom["rate"], length)
        lef = geom["lef"]
        looping = geom["looping"]
        loop_flag = geom["loop_flag"]
        region_len = geom["region_len"]
        off = geom["off"]

        ratio = geom["rate"] / jnp.float64(rc.sample_rate)
        rate_b = ratio * playback_rate_pb.astype(jnp.float64)  # [S]
        # The compiled window admits effective rates up to this bound (the
        # inverse of _window_w's sizing; also sizes the tiles below).
        # Scheduled events above it recompile with a wider window
        # (rate_bound / static_config_stale); audio-rate MODULATION has no
        # static bound, so it clamps here instead — a graceful rate ceiling
        # rather than positions walking off the window into garbage reads.
        bound = max(1, (w - 16) // (S * FRAMES_PER_BLOCK))
        rate_b = jnp.minimum(rate_b, jnp.float64(bound))

        # Prime the resampler on first activity: the 4-sample warmup leaves the
        # first output at position pos+1 (CubicResampler.cs:31-38 + :52).
        x0 = jnp.where(state["primed"] > 0, state["x"], state["pos"] + 1.0)
        e0 = self._map_ext(x0, geom)
        start = jnp.clip(
            jnp.floor(e0).astype(jnp.int32) - 1, 0, region_len - w
        )
        if window is None:  # single-node path; groups pre-fetch gather-free
            window = jax.lax.dynamic_slice(
                arena, (jnp.int32(0), off + geom["front"] + start), (C, w)
            )

        adv = jnp.where(active, FRAMES_PER_BLOCK * rate_b, 0.0)
        du_b = _excl_cumsum(adv)  # [S] f64 offsets from x0
        ub = (e0 - start.astype(jnp.float64)) + du_b  # local block anchors
        base_l, frac = split_positions(ub, rate_b, FRAMES_PER_BLOCK)  # [S,128]

        # ---- banded interpolation matmul over static overlapping tiles ----
        hop = self._HOP
        tile = self._tile_len(bound)
        k_per = tile // hop
        n_tiles = (w - tile) // hop + 1
        n_chunks = (n_tiles - 1) + k_per
        chunks = window[:, : n_chunks * hop].reshape(C, n_chunks, hop)
        tiles = jnp.concatenate(
            [chunks[:, i : i + n_tiles] for i in range(k_per)], axis=2
        )  # [C, n_tiles, tile] — static shifted reshapes, no gather

        band_start = jnp.floor(ub).astype(jnp.int32) - 1  # [S]
        m_b = jnp.clip(band_start // hop, 0, n_tiles - 1)
        rows = jnp.take(tiles, m_b, axis=1)  # [C, S, tile] tiny row gather
        base_row = base_l - (m_b * hop)[:, None]  # [S, 128] in [1, tile-3]

        w0, w1, w2, w3 = cr_weights(frac)
        iota = jnp.arange(tile, dtype=jnp.int32)
        b = base_row[..., None]
        A = (
            w0[..., None] * (iota == b - 1)
            + w1[..., None] * (iota == b)
            + w2[..., None] * (iota == b + 1)
            + w3[..., None] * (iota == b + 2)
        )  # [S, 128, tile]
        out = jnp.einsum(
            "sft,cst->csf", A, rows, precision=jax.lax.Precision.HIGHEST
        )  # [C, S, 128]

        # Validity in ORIGINAL coordinates (the positions differ from local
        # ones by an integer shift; llen/lsf are integers so frac(e0)==frac(x0)).
        shift = jnp.round(x0 - e0).astype(jnp.int32) + start
        base_orig = base_l + shift
        lef_i = lef.astype(jnp.int32)
        de_i = de.astype(jnp.int32)
        end_bound = jnp.where(loop_flag, jnp.minimum(lef_i, de_i), de_i)
        valid = jnp.where(looping, jnp.bool_(True), base_orig + 2 <= end_bound - 1)
        # Consumed-position block gate (AudioBufferSourceNode.cs:270-272):
        # the reference's streaming resampler CONSUMES ahead of production
        # (4-sample warmup + floor(m*rate) by output m), so a block whose
        # consumed position has reached durationEnd plays silence even when
        # one interpolated output is still latent in the S-registers.
        p0 = state["pos"]
        consumed_b = p0 + 4.0 + jnp.floor((x0 + du_b) - p0 - 1.0)  # [S]
        valid = valid & (looping | (consumed_b < de))[:, None]
        gate = active[:, None] & valid
        out = jnp.where(gate[None], out, 0.0)

        # Whole-block clear when the consumed position CROSSES durationEnd
        # inside the block: the reference clears the entire output buffer —
        # including the valid samples it just rendered — whenever
        # `_playbackPosition >= durationEndFrame` after the block
        # (AudioBufferSourceNode.cs:360-368).
        consumed_after = p0 + 4.0 + jnp.floor(
            (x0 + du_b + 127.0 * rate_b) - p0 - 1.0
        )  # [S]
        cleared = active & ~looping & (consumed_after >= de)
        out = jnp.where(cleared[None, :, None], 0.0, out)

        # Auto-stop on starvation or duration-end clear (parity :360-368).
        starved = active & (~jnp.any(valid, axis=1) | cleared)
        first_stop = jnp.min(jnp.where(starved, rc.block_end_times, jnp.inf))
        new_stop = jnp.minimum(state["stop_time"], first_stop)

        lsf, llen = geom["lsf"], geom["llen"]
        new_x = x0 + jnp.sum(adv)
        new_x = jnp.where(
            looping & (new_x >= lef),
            lsf + jnp.mod(new_x - lef, jnp.maximum(llen, 1.0)),
            new_x,
        )

        new_state = dict(state)
        new_state["x"] = new_x
        new_state["primed"] = jnp.where(jnp.any(active), jnp.int32(1), state["primed"])
        new_state["stop_time"] = new_stop
        return new_state, [out.reshape(C, rc.frames)]

    def _process_poly(self, state, arena, geom, rc, w: int, p: int, q: int):
        """Static polyphase kernel for a constant rational rate p/q.

        The position stream x_j = x_0 + j*p/q lives on the 1/q grid, so the
        Catmull-Rom weights cycle with period q and are baked at COMPILE time
        into one [p+4, q] matrix (ops/resample.poly_matrix); the whole
        superblock's resample is then static reshapes + ONE matmul. A
        per-superblock phase shift j0 (the canonical output index whose
        position fraction matches x_0's) aligns the precomputed pattern with
        the live playback position via a dynamic slice of the output.

        Parity: CubicResampler.cs:26-63 semantics (same polynomial, same +1
        priming); replaces the per-step one-hot banded-matrix construction
        that dominated the flagship benchmark.
        """
        S = rc.superblock
        C = arena.shape[0]
        T, ncan, M, nb, w_expect, _front = self._poly_geometry(S, p, q)
        assert w == w_expect, (w, w_expect)
        active = self._block_active(state, rc)  # [S]
        length = geom["length"]
        de = self._duration_end(state, geom["rate"], length)
        lef = geom["lef"]
        looping = geom["looping"]
        loop_flag = geom["loop_flag"]
        region_len = geom["region_len"]
        off = geom["off"]
        front = geom["front"]

        x0 = jnp.where(state["primed"] > 0, state["x"], state["pos"] + 1.0)
        # Snap to the 1/q grid: every reachable position is an exact multiple
        # of 1/q, but f64 accumulation drifts ~1e-16/step off-grid; snapping
        # keeps the phase extraction below exact forever.
        x0 = jnp.round(x0 * q) / q
        e0 = self._map_ext(x0, geom)
        ef = jnp.floor(e0)
        A0 = ef.astype(jnp.int32)
        r0 = jnp.round((e0 - ef) * q).astype(jnp.int32)
        A0 = A0 + (r0 == q).astype(jnp.int32)  # frac rounded up to 1
        r0 = jnp.where(r0 == q, 0, r0)
        # Canonical phase: j0 solves j0*p = r0 (mod q) (p, q coprime).
        pinv = pow(p, -1, q) if q > 1 else 0
        j0 = (r0 * pinv) % q
        m0 = (j0 * p - r0) // q  # integer-sample lead of the canonical origin

        start = jnp.clip(A0 - m0 - 1, -(p + 8), region_len - w)
        window = jax.lax.dynamic_slice(
            arena, (jnp.int32(0), off + front + start), (C, w)
        )

        # Overlapping [ncan, p+4] slabs at stride p from static reshapes.
        wa = window[:, : (ncan + nb) * p].reshape(C, ncan + nb, p)
        parts = []
        covered = 0
        while covered < M:
            k = covered // p
            take = min(p, M - covered)
            parts.append(wa[:, k : k + ncan, :take])
            covered += take
        chunk = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=2)

        H = jnp.asarray(poly_matrix(p, q))  # [M, q] compile-time constant
        out_can = jnp.einsum(
            "cnm,mr->cnr", chunk, H, precision=jax.lax.Precision.HIGHEST
        ).reshape(C, ncan * q)
        out_sh = jax.lax.dynamic_slice(out_can, (jnp.int32(0), j0), (C, T))

        # Block placement: active blocks form one contiguous run, so block b
        # plays the (active-blocks-before-b)-th canonical 128-frame chunk.
        blocks = out_sh.reshape(C, S, FRAMES_PER_BLOCK)
        act = active.astype(jnp.int32)
        bidx = jnp.clip(jnp.cumsum(act) - act, 0, S - 1)
        samples = jnp.take(blocks, bidx, axis=1)  # [C, S, 128]

        # Validity in ORIGINAL coordinates via the static advance pattern:
        # floor(x_j) = floor(x_0) - m0 + base_can[j0 + j], all exact ints.
        base_can = jnp.asarray(canonical_bases(p, q, ncan * q))
        bc = jax.lax.dynamic_slice(base_can, (j0,), (T,))
        bcb = jnp.take(bc.reshape(S, FRAMES_PER_BLOCK), bidx, axis=0)
        O0 = jnp.floor(x0).astype(jnp.int32)
        base_orig = (O0 - m0) + bcb  # [S, 128]

        lef_i = lef.astype(jnp.int32)
        de_i = de.astype(jnp.int32)
        end_bound = jnp.where(loop_flag, jnp.minimum(lef_i, de_i), de_i)
        valid = jnp.where(looping, jnp.bool_(True), base_orig + 2 <= end_bound - 1)
        # Consumed-position block gate — see _process_resample; the advance
        # per active block is exactly 128*p/q on the 1/q grid.
        p0 = state["pos"]
        x_b = x0 + bidx.astype(jnp.float64) * (FRAMES_PER_BLOCK * p / q)
        consumed_b = p0 + 4.0 + jnp.floor(x_b - p0 - 1.0)  # [S]
        valid = valid & (looping | (consumed_b < de))[:, None]
        gate = active[:, None] & valid
        out = jnp.where(gate[None], samples, 0.0)

        # Whole-block clear at duration-end crossing (cs:360-368).
        consumed_after = p0 + 4.0 + jnp.floor(
            x_b + 127.0 * p / q - p0 - 1.0
        )
        cleared = active & ~looping & (consumed_after >= de)
        out = jnp.where(cleared[None, :, None], 0.0, out)

        # Auto-stop on starvation or duration-end clear (parity :360-368).
        starved = active & (~jnp.any(valid, axis=1) | cleared)
        first_stop = jnp.min(jnp.where(starved, rc.block_end_times, jnp.inf))
        new_stop = jnp.minimum(state["stop_time"], first_stop)

        lsf, llen = geom["lsf"], geom["llen"]
        # Exact advance: n_active*128*p is an exact f64 integer; one rounding
        # at the /q, then the grid snap below restores exactness.
        n_active = jnp.sum(active.astype(jnp.float64))
        new_x = x0 + (n_active * (FRAMES_PER_BLOCK * p)) / q
        new_x = jnp.where(
            looping & (new_x >= lef),
            lsf + jnp.mod(new_x - lef, jnp.maximum(llen, 1.0)),
            new_x,
        )
        new_x = jnp.round(new_x * q) / q

        new_state = dict(state)
        new_state["x"] = new_x
        new_state["primed"] = jnp.where(jnp.any(active), jnp.int32(1), state["primed"])
        new_state["stop_time"] = new_stop
        return new_state, [out.reshape(C, rc.frames)]

    # -- group-level kernels (all voices of a stage at once) -------------------
    #
    # The per-voice vmapped forms read through per-voice ELEMENT gathers
    # (window fetch, j0 output shift, canonical-base slice): batched dynamic
    # slices lower to per-element gathers. These group forms replace every
    # one of them:
    #   * window fetch  -> 128-sample ROW gather + an exact one-hot
    #     lane-shift matmul (one factor is 1.0, so the f32 operand is
    #     reconstructed exactly) — _gather_windows_group;
    #   * j0 shift      -> a one-hot column-rotation matmul over the q axis
    #     plus a row-carry select;
    #   * validity      -> a closed-form integer threshold per voice
    #     (floor(x_j) <= end-3  <=>  j < ceil(((end-2)*q - round(x0*q)) / p)).
    # Outputs are bit-identical to the per-voice paths.

    @staticmethod
    def _gather_windows_group(arena, abs_start, w: int):
        """Per-voice [C, w] windows at arbitrary offsets of a shared
        f32[C, W] arena (W a multiple of 128), with NO element gathers:
        a 128-sample row gather plus an exact one-hot lane-shift matmul.
        Returns f32[V, C, w]."""
        i32 = jnp.int32
        C, W = arena.shape
        nrows = w // FRAMES_PER_BLOCK + 2
        rows = arena.reshape(C, W // FRAMES_PER_BLOCK, FRAMES_PER_BLOCK)
        row0 = abs_start // FRAMES_PER_BLOCK
        delta = (abs_start % FRAMES_PER_BLOCK).astype(i32)
        ridx = row0[:, None] + jnp.arange(nrows, dtype=row0.dtype)[None, :]
        ridx = jnp.clip(ridx, 0, W // FRAMES_PER_BLOCK - 1)
        sel = jnp.take(rows, ridx, axis=1)  # [C, V, nrows, 128] row gather
        l_iota = jnp.arange(FRAMES_PER_BLOCK, dtype=i32)
        dlt = delta[:, None, None]
        sh_lo = (l_iota[:, None] == l_iota[None, :] + dlt).astype(jnp.float32)
        sh_hi = (
            l_iota[:, None] + FRAMES_PER_BLOCK == l_iota[None, :] + dlt
        ).astype(jnp.float32)  # [V, 128(src), 128(dst)]
        shifted = jnp.einsum(
            "cvns,vsd->vcnd", sel[:, :, :-1], sh_lo, precision=_HIGHEST
        ) + jnp.einsum(
            "cvns,vsd->vcnd", sel[:, :, 1:], sh_hi, precision=_HIGHEST
        )  # [V, C, nrows-1, 128]
        V = abs_start.shape[0]
        return shifted.reshape(V, C, (nrows - 1) * FRAMES_PER_BLOCK)[:, :, :w]

    @staticmethod
    def _gather_blocks_group(arena, abs_start, bidx):
        """Fused form of ``_gather_windows_group`` + the per-superblock block
        select: result[v, c, s] = arena[c, abs_start[v] + 128*bidx[v, s] :][:128]
        with NO element gathers and no intermediate window tensor — the block
        index folds into the row index ((a + 128*b)//128 == a//128 + b), so
        one row-gather pair + the lane-shift matmul produce the selected
        blocks directly. Returns f32[V, C, S, 128]."""
        i32 = jnp.int32
        C, W = arena.shape
        S = bidx.shape[1]
        rows = arena.reshape(C, W // FRAMES_PER_BLOCK, FRAMES_PER_BLOCK)
        row0 = abs_start // FRAMES_PER_BLOCK  # [V]
        delta = (abs_start % FRAMES_PER_BLOCK).astype(i32)
        nrows = W // FRAMES_PER_BLOCK
        ridx = jnp.clip(row0[:, None] + bidx.astype(row0.dtype), 0, nrows - 1)
        sel_lo = jnp.take(rows, ridx, axis=1)  # [C, V, S, 128]
        sel_hi = jnp.take(rows, jnp.clip(ridx + 1, 0, nrows - 1), axis=1)
        l_iota = jnp.arange(FRAMES_PER_BLOCK, dtype=i32)
        dlt = delta[:, None, None]
        sh_lo = (l_iota[:, None] == l_iota[None, :] + dlt).astype(jnp.float32)
        sh_hi = (
            l_iota[:, None] + FRAMES_PER_BLOCK == l_iota[None, :] + dlt
        ).astype(jnp.float32)  # [V, 128(src), 128(dst)]
        shifted = jnp.einsum(
            "cvns,vsd->vcnd", sel_lo, sh_lo, precision=_HIGHEST
        ) + jnp.einsum(
            "cvns,vsd->vcnd", sel_hi, sh_hi, precision=_HIGHEST
        )  # [V, C, S, 128]
        return shifted

    @classmethod
    def process_unity_group(cls, states, arena, geom, rc, w: int,
                            aligned: bool = False):
        """Group form of _process_unity (exact copy path): same semantics,
        bit-identical output, gathers replaced as described above.

        ``aligned``: every voice's position stays a multiple of 128 (see
        kernel_variant), so the window fetch is a pure 128-row gather —
        the lane-shift matmul (an exact identity at delta=0) is dropped,
        saving ~1/3 of this stage's measured cost. Requires the arena's
        per-voice offsets to be 128-aligned (the compiler pads regions)."""
        S = rc.superblock
        C = arena.shape[0]
        V = geom["off"].shape[0]
        i32 = jnp.int32

        active = cls._active_mask(states, rc)  # [V, S]
        length = geom["length"]
        rate = geom["rate"]
        de = cls._duration_end(states, rate, length)  # [V]
        lef = geom["lef"]
        lsf = geom["lsf"]
        llen = geom["llen"]
        looping = geom["looping"]
        loop_flag = geom["loop_flag"]
        region_len = geom["region_len"]
        off = geom["off"]
        front = geom["front"]

        adv = jnp.where(active, float(FRAMES_PER_BLOCK), 0.0)  # [V, S]
        pos_b = states["pos"][:, None] + (
            jnp.cumsum(adv, axis=1) - adv
        )  # [V, S] f64 exclusive cumsum
        p0 = states["pos"]
        delta_b = (pos_b - p0[:, None]).astype(i32)  # [V, S]
        bidx = jnp.clip(delta_b // FRAMES_PER_BLOCK, 0, S - 1)

        qmod = jnp.mod(p0 - lsf, jnp.maximum(llen, 1.0))
        e0 = jnp.where(looping & (p0 >= lsf), lsf + llen + qmod, p0)
        # The per-superblock block index composes into the row fetch itself
        # (rows[row0 + s][bidx[s]] == rows[row0 + bidx[s]]): ONE row gather
        # replaces the gather + take_along_axis pair.
        if aligned:
            # Positions and arena offsets are multiples of 128 by variant
            # contract; floor the end-clip to keep the start aligned (only
            # past-the-end voices clip, and their samples are masked).
            hi = (region_len.astype(i32) - w) // FRAMES_PER_BLOCK \
                * FRAMES_PER_BLOCK
            start = jnp.clip(e0.astype(i32), 0, hi)
            W = arena.shape[1]
            rows = arena.reshape(C, W // FRAMES_PER_BLOCK, FRAMES_PER_BLOCK)
            row0 = (off + front + start) // FRAMES_PER_BLOCK  # [V] exact
            ridx = jnp.clip(
                row0[:, None] + bidx.astype(row0.dtype),
                0, W // FRAMES_PER_BLOCK - 1,
            )
            samples = jnp.moveaxis(
                jnp.take(rows, ridx, axis=1), 0, 1
            )  # [V, C, S, 128] pure row gather
        else:
            samples = cls._gather_blocks_group(
                arena, off + front
                + jnp.clip(e0.astype(i32), 0, region_len.astype(i32) - w),
                bidx,
            )
        i = jnp.arange(FRAMES_PER_BLOCK, dtype=i32)

        g = (
            p0.astype(i32)[:, None, None]
            + delta_b[:, :, None]
            + i[None, None, :]
        )  # [V, S, 128] original-coordinate sample indices
        lef_i = lef.astype(i32)
        de_i = de.astype(i32)
        end_bound = jnp.where(loop_flag, jnp.minimum(lef_i, de_i), de_i)
        valid = jnp.where(
            looping[:, None, None], jnp.bool_(True),
            g < end_bound[:, None, None],
        )
        out = jnp.where((active[:, :, None] & valid)[:, None], samples, 0.0)

        pos_after = pos_b + FRAMES_PER_BLOCK  # [V, S]
        any_valid = jnp.any(valid, axis=2)
        cleared = active & jnp.where(
            looping[:, None], ~any_valid,
            (pos_after >= de[:, None]) | ~any_valid,
        )
        out = jnp.where(cleared[:, None, :, None], 0.0, out)

        first_stop = jnp.min(
            jnp.where(cleared, rc.block_end_times[None, :], jnp.inf), axis=1
        )
        new_stop = jnp.minimum(states["stop_time"], first_stop)

        new_pos = states["pos"] + jnp.sum(adv, axis=1)
        new_pos = jnp.where(
            looping & (new_pos >= lef),
            lsf + jnp.mod(new_pos - lef, jnp.maximum(llen, 1.0)),
            new_pos,
        )

        new_states = dict(states)
        new_states["pos"] = new_pos
        new_states["stop_time"] = new_stop
        return new_states, out.reshape(V, C, rc.frames)

    @classmethod
    def process_poly_group(cls, states, arena, geom, rc, w: int, p: int, q: int):
        """states: stacked pytree [V, ...]; arena f32[C, W] (W pow2-padded,
        multiple of 128); geom: dict of stacked [V] scalars + per-voice
        arena offsets. Returns (new_states, out f32[V, C, T])."""
        S = rc.superblock
        C = arena.shape[0]
        W = arena.shape[1]
        T, ncan, M, nb, w_e, _front = cls._poly_geometry(S, p, q)
        assert w == w_e, (w, w_e)
        V = geom["off"].shape[0]
        i32 = jnp.int32

        stop_time = states["stop_time"]
        active = cls._active_mask(states, rc)  # [V, S]
        length = geom["length"]  # [V] f64
        rate = geom["rate"]
        de = cls._duration_end(states, rate, length)  # [V]
        lef = geom["lef"]
        lsf = geom["lsf"]
        llen = geom["llen"]
        looping = geom["looping"]
        loop_flag = geom["loop_flag"]
        region_len = geom["region_len"]
        off = geom["off"]  # [V] i32
        front = geom["front"]  # [V] i32

        x0 = jnp.where(states["primed"] > 0, states["x"], states["pos"] + 1.0)
        x0 = jnp.round(x0 * q) / q
        # map into the periodic extension (loop wraps become linear reads)
        qmod = jnp.mod(x0 - lsf, jnp.maximum(llen, 1.0))
        e0 = jnp.where(looping & (x0 >= lsf), lsf + llen + qmod, x0)
        ef = jnp.floor(e0)
        A0 = ef.astype(i32)
        r0 = jnp.round((e0 - ef) * q).astype(i32)
        A0 = A0 + (r0 == q).astype(i32)
        r0 = jnp.where(r0 == q, 0, r0)
        pinv = pow(p, -1, q) if q > 1 else 0
        j0 = (r0 * pinv) % q  # [V]
        m0 = (j0 * p - r0) // q
        start = jnp.clip(A0 - m0 - 1, -(p + 8), region_len.astype(i32) - w)

        # ---- window fetch: row gather + exact one-hot lane shift ----------
        window = cls._gather_windows_group(arena, off + front + start, w)

        # ---- canonical polyphase: slabs + ONE merged matmul ----------------
        wa = window[:, :, : (ncan + nb) * p].reshape(V, C, ncan + nb, p)
        parts = []
        covered = 0
        while covered < M:
            k = covered // p
            take = min(p, M - covered)
            parts.append(wa[:, :, k : k + ncan, :take])
            covered += take
        chunk = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=3)
        H = jnp.asarray(poly_matrix(p, q))  # [M, q]
        out_can = jnp.dot(
            chunk.reshape(V * C * ncan, M), H, precision=_HIGHEST
        ).reshape(V, C, ncan, q)

        # ---- j0 shift: one-hot column rotation + row-carry select ----------
        k_iota = jnp.arange(q, dtype=i32)
        rk = (k_iota[None, :] + j0[:, None]) % q  # [V, q]
        P_rot = (k_iota[None, :, None] == rk[:, None, :]).astype(jnp.float32)
        base = jnp.einsum(
            "vcnq,vqk->vcnk", out_can, P_rot, precision=_HIGHEST
        )  # [V, C, ncan, q] columns permuted
        carry = (k_iota[None, :] + j0[:, None]) >= q  # [V, q]
        out_sh = jnp.where(
            carry[:, None, None, :], base[:, :, 1:, :], base[:, :, :-1, :]
        ).reshape(V, C, (ncan - 1) * q)[:, :, :T]

        # ---- block placement (contiguous active run) -----------------------
        act = active.astype(i32)
        bidx = jnp.clip(jnp.cumsum(act, axis=1) - act, 0, S - 1)  # [V, S]
        blocks = out_sh.reshape(V, C, S, FRAMES_PER_BLOCK)
        samples = jnp.take_along_axis(
            blocks, bidx[:, None, :, None], axis=2
        )  # [V, C, S, 128] row gather

        # ---- validity: integer thresholds (no per-sample position math) ----
        lef_i = lef.astype(i32)
        de_i = de.astype(i32)
        end_bound = jnp.where(loop_flag, jnp.minimum(lef_i, de_i), de_i)
        # floor(x_j) + 2 <= end - 1  <=>  j < ceil(((end-2)*q - X0q) / p)
        # with X0q = round(x0*q) (all exact integers in f64).
        x0q = jnp.round(x0 * q)
        num = (end_bound.astype(jnp.float64) - 2.0) * q - x0q
        jlim = jnp.floor((num + (p - 1)) / p)  # [V] f64 integer
        jpos = (
            bidx.astype(jnp.float32)[:, :, None] * FRAMES_PER_BLOCK
            + jnp.arange(FRAMES_PER_BLOCK, dtype=jnp.float32)[None, None, :]
        )  # [V, S, 128] (exact in f32: < 2^24)
        valid = jnp.where(
            looping[:, None, None],
            jnp.bool_(True),
            jpos < jlim.astype(jnp.float32)[:, None, None],
        )
        # consumed-position block gate (see _process_resample)
        p0 = states["pos"]
        x_b = x0[:, None] + bidx.astype(jnp.float64) * (FRAMES_PER_BLOCK * p / q)
        consumed_b = p0[:, None] + 4.0 + jnp.floor(x_b - p0[:, None] - 1.0)
        valid = valid & (looping[:, None] | (consumed_b < de[:, None]))[:, :, None]

        gate = active[:, :, None] & valid  # [V, S, 128]
        out = jnp.where(gate[:, None], samples, 0.0)

        # Whole-block clear when consumption crosses durationEnd inside the
        # block (AudioBufferSourceNode.cs:360-368; see _process_resample).
        consumed_after = p0[:, None] + 4.0 + jnp.floor(
            x_b + 127.0 * p / q - p0[:, None] - 1.0
        )  # [V, S]
        cleared = active & ~looping[:, None] & (consumed_after >= de[:, None])
        out = jnp.where(cleared[:, None, :, None], 0.0, out)

        starved = active & (~jnp.any(valid, axis=2) | cleared)  # [V, S]
        first_stop = jnp.min(
            jnp.where(starved, rc.block_end_times[None, :], jnp.inf), axis=1
        )
        new_stop = jnp.minimum(stop_time, first_stop)

        n_active = jnp.sum(active.astype(jnp.float64), axis=1)  # [V]
        new_x = x0 + (n_active * (FRAMES_PER_BLOCK * p)) / q
        new_x = jnp.where(
            looping & (new_x >= lef),
            lsf + jnp.mod(new_x - lef, jnp.maximum(llen, 1.0)),
            new_x,
        )
        new_x = jnp.round(new_x * q) / q

        new_states = dict(states)
        new_states["x"] = new_x
        new_states["primed"] = jnp.where(
            jnp.any(active, axis=1), jnp.int32(1), states["primed"]
        )
        new_states["stop_time"] = new_stop
        return new_states, out.reshape(V, C, rc.frames)
