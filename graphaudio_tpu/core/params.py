"""Host-side AudioParam: automation event timeline + modulation input.

Mirrors the public surface of GraphAudio.Core/AudioParam.cs: ``value`` set
cancels events (:34-49), ``set_value_at_time`` / ``linear_ramp_to_value_at_time``
/ ``exponential_ramp_to_value_at_time`` / ``set_target_at_time`` insert into a
sorted event list (:252-307, :333-352), ``cancel_scheduled_values`` drops
events at or after a time (:312-331). Evaluation happens on-device via
:mod:`graphaudio_tpu.ops.param_eval`; this class only maintains the host event
list and its encoded tensor form.

Any node output can connect to a param as an audio-rate modulation source
(a hidden mono Explicit input, AudioParam.cs:66-70); the graph compiler wires
the modulation signal and the engine adds it to the intrinsic curve then
clamps (AudioParam.cs:124-135).
"""

from __future__ import annotations

import bisect
import enum
import math

import numpy as np

from graphaudio_tpu.ops.param_eval import (
    EVT_SET_VALUE,
    EVT_LINEAR_RAMP,
    EVT_EXPONENTIAL_RAMP,
    EVT_SET_TARGET,
    encode_events,
)


class AutomationRate(enum.Enum):
    """Parity: AudioParam.cs:381-392."""

    A_RATE = "a-rate"  # computed every sample
    K_RATE = "k-rate"  # computed once per 128-frame block


class AudioParam:
    def __init__(
        self,
        owner,
        name: str,
        default_value: float,
        min_value: float,
        max_value: float,
        automation_rate: AutomationRate,
    ):
        self._owner = owner
        self._name = name
        self._default_value = float(default_value)
        self._min_value = float(min_value)
        self._max_value = float(max_value)
        self._automation_rate = automation_rate
        self._value = float(default_value)
        # Rate-integrating consumers (the cubic resampler's playbackRate)
        # accumulate 1-ulp value noise into position drift, so their curves
        # evaluate in full f64 absolute time; everything else takes the f32
        # fast path (per-sample f64 transcendentals cost far more than f32).
        self.exact_eval = False
        # Sorted list of (time, seq, type, value, time_constant). ``seq``
        # breaks ties so equal-time events keep insertion order, matching the
        # reference's stable binary-insert (AudioParam.cs:339-344).
        self._events: list = []
        self._seq = 0
        self._version = 0
        # When True, the first mutation of this param invalidates the compiled
        # topology. Nodes set this on params whose pristine state enables a
        # statically specialized kernel (e.g. AudioBufferSourceNode's
        # playbackRate selects the exact unity-rate copy path while untouched).
        self.notify_first_touch = False
        self._touched = False
        # When True, the first scheduled event invalidates the compiled
        # topology (nodes that compile a cheaper kernel for constant params,
        # e.g. BiQuadFilterNode's single-pass scan).
        self.notify_first_event = False
        self._had_events = False
        # Node outputs connected as audio-rate modulation sources. The hidden
        # input is mono Explicit (AudioParam.cs:68-70): the compiler downmixes
        # each source to 1 channel and sums.
        self._mod_outputs: list = []

    # -- identity -----------------------------------------------------------

    @property
    def name(self) -> str:
        return self._name

    @property
    def default_value(self) -> float:
        return self._default_value

    @property
    def min_value(self) -> float:
        return self._min_value

    @property
    def max_value(self) -> float:
        return self._max_value

    @property
    def automation_rate(self) -> AutomationRate:
        return self._automation_rate

    @property
    def version(self) -> int:
        """Bumped on every mutation; the context re-encodes on change."""
        return self._version

    # -- value / events -----------------------------------------------------

    @property
    def value(self) -> float:
        return self._value

    @property
    def touched(self) -> bool:
        return self._touched

    def _mark_touched(self) -> None:
        if not self._touched:
            self._touched = True
            if self.notify_first_touch and self._owner is not None:
                # _config_changed (not just _graph_changed): the touch flips
                # a STATIC kernel variant baked into the owner's compiled
                # program. Group stages re-key via group_key, but a
                # modulated owner compiles as a single stage whose program-
                # cache identity is the static fingerprint — without the
                # version bump the stale variant's cached program would be
                # reused.
                self._owner._config_changed()

    @value.setter
    def value(self, v: float) -> None:
        """Set the current value; cancels all scheduled events (AudioParam.cs:34-49)."""
        self._value = self._clamp(v)
        self._events.clear()
        self._version += 1
        self._mark_touched()

    def _clamp(self, v: float) -> float:
        return min(max(float(v), self._min_value), self._max_value)

    def _add_event(self, etype: int, time: float, value: float, tc: float = 1.0) -> None:
        entry = (float(time), self._seq, etype, float(value), float(tc))
        # Insert after all events with time <= new time, matching the
        # reference's binary insert (first position where new.Time <
        # existing.Time, AudioParam.cs:339-344).
        times = [e[0] for e in self._events]
        idx = bisect.bisect_right(times, float(time))
        self._events.insert(idx, entry)
        self._seq += 1
        self._version += 1
        self._mark_touched()
        if not self._had_events:
            self._had_events = True
            if self.notify_first_event and self._owner is not None:
                self._owner._config_changed()  # see _mark_touched

    def set_value_at_time(self, value: float, start_time: float) -> "AudioParam":
        """Parity: AudioParam.SetValueAtTime (:252-261). Value clamped at insert."""
        self._add_event(EVT_SET_VALUE, start_time, self._clamp(value))
        return self

    def linear_ramp_to_value_at_time(self, value: float, end_time: float) -> "AudioParam":
        """Parity: AudioParam.LinearRampToValueAtTime (:266-275)."""
        self._add_event(EVT_LINEAR_RAMP, end_time, self._clamp(value))
        return self

    def exponential_ramp_to_value_at_time(self, value: float, end_time: float) -> "AudioParam":
        """Parity: AudioParam.ExponentialRampToValueAtTime (:280-292).

        Raises if the clamped target is <= 0, as the reference does.
        """
        v = self._clamp(value)
        if v <= 0.0:
            raise ValueError("Exponential ramp target must be > 0")
        self._add_event(EVT_EXPONENTIAL_RAMP, end_time, v)
        return self

    def set_target_at_time(self, target: float, start_time: float, time_constant: float) -> "AudioParam":
        """Parity: AudioParam.SetTargetAtTime (:297-307)."""
        self._add_event(EVT_SET_TARGET, start_time, self._clamp(target), time_constant)
        return self

    def cancel_scheduled_values(self, cancel_time: float) -> "AudioParam":
        """Drop all events with time >= cancel_time (AudioParam.cs:312-331).

        The reference keeps the leading run of events strictly before
        cancel_time (it stops scanning at the first event >= cancel_time).
        """
        survivors = []
        for e in self._events:
            if e[0] < cancel_time:
                survivors.append(e)
            else:
                break
        if len(survivors) != len(self._events):
            self._events = survivors
            self._version += 1
        return self

    def value_at_time(self, t: float) -> float:
        """Host-side intrinsic curve value at time ``t`` (no modulation).

        Scalar mirror of ops/param_eval.eval_intrinsic — same branch order
        and f32 value rounding (parity: AudioParam.ComputeValueAtTime,
        AudioParam.cs:168-247). Used by host-staged consumers (stream-node
        feeds) that evaluate automation per render call rather than on
        device.
        """
        evs = self._events
        if not evs:
            return float(self._value)
        t = float(t)
        times = [e[0] for e in evs]
        idx = bisect.bisect_right(times, t)
        if idx == 0:
            return float(self._value)
        prev = evs[idx - 1]
        v0 = float(np.float32(prev[3]))
        if idx < len(evs):
            nxt = evs[idx]
            if nxt[2] in (EVT_LINEAR_RAMP, EVT_EXPONENTIAL_RAMP):
                t0, t1 = prev[0], nxt[0]
                v1 = float(np.float32(nxt[3]))
                denom = (t1 - t0) or 1.0
                u = min(max((t - t0) / denom, 0.0), 1.0)
                if nxt[2] == EVT_EXPONENTIAL_RAMP and v0 > 0.0 and v1 > 0.0:
                    return v0 * (v1 / v0) ** u
                return v0 + (v1 - v0) * u
        if prev[2] == EVT_SET_TARGET:
            # Decay from the boundary value before the SetTarget event
            # (SetTarget does not advance the boundary).
            bl = np.float32(self._value)
            for e in evs[: idx - 1]:
                if e[2] != EVT_SET_TARGET:
                    bl = np.float32(e[3])
            bl = float(bl)
            elapsed = t - prev[0]
            if elapsed <= 0.0:
                return bl
            tc = max(prev[4], 0.001)
            return v0 + (bl - v0) * math.exp(-elapsed / tc)
        return v0  # hold: SetValue / completed ramp

    # -- encoding for the device pass ----------------------------------------

    def has_events(self) -> bool:
        return bool(self._events)

    def max_scheduled_value(self) -> float:
        """Upper bound on the values this param can reach with the current
        base value and event list (values are clamped at insert)."""
        mx = self._value
        for e in self._events:
            mx = max(mx, e[3])
        return mx

    def encode(self, capacity: int) -> dict:
        """Encode current base value + events into fixed-shape numpy arrays."""
        events = [(e[2], e[0], e[3], e[4]) for e in self._events]
        return encode_events(self._value, events, capacity)

    def event_count(self) -> int:
        return len(self._events)

    def __repr__(self) -> str:
        return (
            f"AudioParam({self._name!r}, value={self._value}, "
            f"events={len(self._events)}, rate={self._automation_rate.value})"
        )
