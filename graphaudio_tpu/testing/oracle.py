"""Independent numpy oracle: a deliberately slow, literal implementation of the
reference's per-block pull semantics.

Provenance / attribution: this test oracle is a deliberate Python
transliteration of the algorithmic behavior of GraphAudio
(https://github.com/the-byte-bender/GraphAudio), which is licensed under the
Mozilla Public License 2.0 (https://mozilla.org/MPL/2.0/). Per-class citations
below name the C# sources each oracle class reproduces. The oracle's entire
purpose is to replicate the reference's semantics literally so the production
JAX renderer (which shares no code with either) can be validated against an
independent implementation; it is test-only code and is not part of the
rendering framework.

This module re-implements the C# reference (the-byte-bender/GraphAudio) in
numpy, block by block, with float32 arithmetic wherever the reference uses
``float`` and Python floats (f64) wherever it uses ``double``:

  * pull-model graph evaluation with per-block memoization
    (`AudioNode.cs:152-183`, `AudioNodeOutput.cs:75-78`),
  * channel count modes + the literal mixing matrix
    (`AudioNodeInput.cs:100-244`),
  * per-sample automation event walk (`AudioParam.cs:113-247`),
  * streaming CubicResampler state machine (`CubicResampler.cs:26-63`),
  * sequential biquad with the reference's threshold-gated coefficient
    updates (`BiQuadFilterNode.cs:110-143`),
  * uniform partitioned convolution with a frequency-domain delay line
    (`PartitionedConvolver.cs:104-223`).

It exists to catch shared-bug drift that self-referential goldens cannot:
the JAX renderer and this oracle share NO code, so agreement between them on
whole-graph configs validates both. It is intentionally unoptimized — do not
use it for anything but tests.
"""

from __future__ import annotations

import math

import numpy as np

FRAMES = 128

f32 = np.float32


# ---------------------------------------------------------------------------
# AudioParam (AudioParam.cs)
# ---------------------------------------------------------------------------

_SET_VALUE, _LINEAR, _EXPONENTIAL, _SET_TARGET = 0, 1, 2, 3


class OracleParam:
    def __init__(self, owner, default, min_value, max_value, a_rate):
        self.owner = owner
        self.default = f32(default)
        self.min = f32(min_value)
        self.max = f32(max_value)
        self.a_rate = a_rate
        self._value = f32(default)
        self._events = []  # (type, value f32, target f32, time, time_constant)
        self.input = OracleInput(owner, channel_count=1, mode="explicit")
        self.computed = np.zeros(FRAMES, f32)

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        # setting Value cancels all events (AudioParam.cs:34-49)
        self._value = f32(np.clip(f32(v), self.min, self.max))
        self._events = []

    # -- scheduling (times are doubles; values clamp to f32 range) ----------

    def _add_event(self, evt):
        # binary search, inserting AFTER equal times (AudioParam.cs:333-352)
        lo, hi = 0, len(self._events)
        while lo < hi:
            mid = (lo + hi) >> 1
            if evt[3] < self._events[mid][3]:
                hi = mid
            else:
                lo = mid + 1
        self._events.insert(lo, evt)

    def set_value_at_time(self, value, start_time):
        v = f32(np.clip(f32(value), self.min, self.max))
        self._add_event((_SET_VALUE, v, f32(0), float(start_time), 0.0))

    def linear_ramp_to_value_at_time(self, value, end_time):
        v = f32(np.clip(f32(value), self.min, self.max))
        self._add_event((_LINEAR, v, f32(0), float(end_time), 0.0))

    def exponential_ramp_to_value_at_time(self, value, end_time):
        v = f32(np.clip(f32(value), self.min, self.max))
        if v <= 0:
            raise ValueError("Exponential ramp target must be > 0")
        self._add_event((_EXPONENTIAL, v, f32(0), float(end_time), 0.0))

    def set_target_at_time(self, target, start_time, time_constant):
        t = f32(np.clip(f32(target), self.min, self.max))
        self._add_event((_SET_TARGET, f32(0), t, float(start_time),
                         float(time_constant)))

    def cancel_scheduled_values(self, cancel_time):
        survivors = 0
        for e in self._events:
            if e[3] < cancel_time:
                survivors += 1
            else:
                break
        self._events = self._events[:survivors]

    # -- evaluation (AudioParam.cs:93-247) -----------------------------------

    def _value_at_time(self, time):
        events = self._events
        if not events:
            return self._value
        value_at_boundary = self._value
        for i, evt in enumerate(events):
            etype, evalue, etarget, etime, etc = evt
            if time < etime:
                if i == 0:
                    return value_at_boundary
                ptype, pvalue, ptarget, ptime, ptc = events[i - 1]
                if etype == _LINEAR:
                    return _interp_linear(pvalue, ptime, evalue, etime, time)
                if etype == _EXPONENTIAL:
                    return _interp_exponential(pvalue, ptime, evalue, etime, time)
                if ptype == _SET_TARGET:
                    return _set_target(ptarget, ptime, ptc,
                                       value_at_boundary, time)
                return pvalue
            if etype in (_SET_VALUE, _LINEAR, _EXPONENTIAL):
                value_at_boundary = evalue
        etype, evalue, etarget, etime, etc = events[-1]
        if etype == _SET_TARGET:
            return _set_target(etarget, etime, etc, value_at_boundary, time)
        return evalue

    def compute_values(self, block_number, block_time, ctx):
        has_mod = bool(self.input.connections)
        if has_mod:
            self.input.pull(block_number, block_time, ctx)
        dt = 1.0 / ctx.sample_rate
        if self.a_rate:
            for i in range(FRAMES):
                iv = self._value_at_time(block_time + i * dt)
                if has_mod and self.input.buffer is not None \
                        and not self.input.silent:
                    m = self.input.buffer[0][i]
                    self.computed[i] = f32(np.clip(f32(iv + m),
                                                   self.min, self.max))
                else:
                    self.computed[i] = iv
        else:
            iv = self._value_at_time(block_time)
            if has_mod and self.input.buffer is not None \
                    and not self.input.silent:
                m = self.input.buffer[0][0]
                iv = f32(np.clip(f32(iv + m), self.min, self.max))
            self.computed[:] = iv
        return self.computed


def _interp_linear(v0, t0, v1, t1, t):
    u = (t - t0) / (t1 - t0)
    u = min(max(u, 0.0), 1.0)
    return f32(float(v0) + (float(v1) - float(v0)) * u)


def _interp_exponential(v0, t0, v1, t1, t):
    if v0 <= 0 or v1 <= 0:
        return _interp_linear(v0, t0, v1, t1, t)
    u = (t - t0) / (t1 - t0)
    u = min(max(u, 0.0), 1.0)
    return f32(float(v0) * math.pow(float(v1) / float(v0), u))


def _set_target(target, etime, time_constant, baseline, t):
    elapsed = t - etime
    if elapsed <= 0:
        return baseline
    tc = max(time_constant, 0.001)
    return f32(float(target)
               + (float(baseline) - float(target)) * math.exp(-elapsed / tc))


# ---------------------------------------------------------------------------
# Ports + mixing (AudioNodeInput.cs / AudioNodeOutput.cs)
# ---------------------------------------------------------------------------

class OracleOutput:
    def __init__(self, owner):
        self.owner = owner
        self.buffer = None  # np [C, 128] f32
        self.silent = True


class OracleInput:
    def __init__(self, owner, channel_count=2, mode="max",
                 interpretation="speakers"):
        self.owner = owner
        self.channel_count = channel_count
        self.mode = mode  # "max" | "clamped-max" | "explicit"
        self.interpretation = interpretation
        self.connections = []  # OracleOutput list, connect order
        self.buffer = None
        self.silent = True

    def _computed_channels(self):
        # reads the PREVIOUS block's output buffers (AudioNodeInput.cs:140-168)
        if self.mode == "explicit":
            return self.channel_count
        if self.mode == "clamped-max":
            mx = 0
            for out in self.connections:
                if out.buffer is not None:
                    mx = max(mx, out.buffer.shape[0])
            return min(self.channel_count if mx == 0 else mx,
                       self.channel_count)
        mx = self.channel_count
        for out in self.connections:
            if out.buffer is not None:
                mx = max(mx, out.buffer.shape[0])
        return mx

    def pull(self, block_number, block_time, ctx):
        if not self.connections:
            ch = self.channel_count
            self.buffer = np.zeros((ch, FRAMES), f32)
            self.silent = True
            return
        channels = self._computed_channels()
        self.buffer = np.zeros((channels, FRAMES), f32)
        self.silent = True
        for out in self.connections:
            out.owner.process_internal(block_number, block_time, ctx)
            if out.buffer is not None and not out.silent:
                _mix_buffer(out.buffer, self.buffer)
                self.silent = False


def _mix_buffer(src, dst):
    """Literal MixBuffer (AudioNodeInput.cs:182-244); f32 adds."""
    sc, dc = src.shape[0], dst.shape[0]
    if sc == dc:
        dst += src
    elif sc == 1 and dc > 1:
        dst += src[0][None, :]
    elif sc > 1 and dc == 1:
        scale = f32(1.0) / f32(math.sqrt(sc))
        s = src[0].copy()
        for ch in range(1, sc):
            s = (s + src[ch]).astype(f32)
        dst[0] += (s * scale).astype(f32)
    else:
        mn = min(sc, dc)
        dst[:mn] += src[:mn]


# ---------------------------------------------------------------------------
# Node base (AudioNode.cs:152-183)
# ---------------------------------------------------------------------------

class OracleNode:
    def __init__(self, ctx, n_inputs, n_outputs):
        self.ctx = ctx
        self.inputs = [OracleInput(self) for _ in range(n_inputs)]
        self.outputs = [OracleOutput(self) for _ in range(n_outputs)]
        self.params = []
        self._last_block = -1
        ctx.nodes.append(self)

    def _param(self, default, min_value, max_value, a_rate):
        p = OracleParam(self, default, min_value, max_value, a_rate)
        self.params.append(p)
        return p

    def connect(self, dst, output_index=0, input_index=0):
        out = self.outputs[output_index]
        inp = dst.inputs[input_index] if isinstance(dst, OracleNode) else dst.input
        if out not in inp.connections:
            inp.connections.append(out)
        return dst

    def process_internal(self, block_number, block_time, ctx):
        if self._last_block == block_number:
            return
        self._last_block = block_number
        for p in self.params:
            p.compute_values(block_number, block_time, ctx)
        for inp in self.inputs:
            inp.pull(block_number, block_time, ctx)
        self.process(block_time)

    def process(self, block_time):
        raise NotImplementedError

    def _set_output(self, idx, data, silent):
        self.outputs[idx].buffer = data
        self.outputs[idx].silent = silent


# ---------------------------------------------------------------------------
# CubicResampler (CubicResampler.cs)
# ---------------------------------------------------------------------------

class _CubicResampler:
    __slots__ = ("s0", "s1", "s2", "s3", "pos", "ready")

    def __init__(self):
        self.clear()

    def clear(self):
        self.s0 = self.s1 = self.s2 = self.s3 = f32(0)
        self.pos = 0.0
        self.ready = 0

    def _shift(self, sample):
        self.s0, self.s1, self.s2, self.s3 = self.s1, self.s2, self.s3, sample

    def process(self, inp, out, out_start, out_len, rate):
        """Literal Process (CubicResampler.cs:26-63). ``inp`` f32[N];
        writes into out[out_start : out_start+produced]. Returns
        (input_consumed, output_produced)."""
        in_pos = 0
        out_pos = 0
        n_in = len(inp)
        while self.ready < 4 and in_pos < n_in:
            self._shift(f32(inp[in_pos]))
            in_pos += 1
            self.ready += 1
        if self.ready < 4:
            return in_pos, out_pos
        half = f32(0.5)
        while out_pos < out_len:
            consume = int(self.pos)
            if in_pos + consume > n_in:
                break
            for _ in range(consume):
                self._shift(f32(inp[in_pos]))
                in_pos += 1
            self.pos -= consume
            t = f32(self.pos)
            s0, s1, s2, s3 = self.s0, self.s1, self.s2, self.s3
            # exact op order of CubicResampler.cs:52-57 in f32
            c3 = f32(half * (s3 - s0) + f32(1.5) * (s1 - s2))
            c2 = f32(s0 - f32(2.5) * s1 + f32(2.0) * s2 - half * s3)
            out[out_start + out_pos] = f32(s1 + t * f32(half * (s2 - s0)
                                                        + t * f32(c2 + t * c3)))
            out_pos += 1
            self.pos += rate
        return in_pos, out_pos


# ---------------------------------------------------------------------------
# Nodes
# ---------------------------------------------------------------------------

class OracleBufferSource(OracleNode):
    """AudioBufferSourceNode.cs, both the unity-rate copy path and the
    streaming CubicResampler path (:131-376)."""

    def __init__(self, ctx):
        super().__init__(ctx, 0, 1)
        self.playback_rate = self._param(1.0, 0.001, 1000.0, a_rate=False)
        self.buffer = None  # np [C, L] f32
        self.buffer_rate = None
        self.loop = False
        self.loop_start = 0.0
        self.loop_end = 0.0
        self._started = False
        self._stopped = False
        self._start_time = math.nan
        self._stop_time = math.nan
        self._offset = 0.0
        self._duration = math.inf
        self._pos = 0
        self._resamplers = None

    def set_buffer(self, data, sample_rate):
        self.buffer = np.asarray(data, f32)
        if self.buffer.ndim == 1:
            self.buffer = self.buffer[None, :]
        self.buffer_rate = float(sample_rate)

    def start(self, when=0.0, offset=0.0, duration=math.inf):
        self._started = True
        self._start_time = max(0.0, when)
        self._offset = max(0.0, offset)
        self._duration = duration
        self._pos = int(self._offset * self.buffer_rate)
        if self._resamplers is not None:
            for r in self._resamplers:
                r.clear()
        if not math.isinf(duration) and duration >= 0:
            self._stop_time = self._start_time + duration
            self._stopped = True

    def stop(self, when=0.0):
        if self._stopped:
            return
        at = max(0.0, when)
        self._stop_time = at if math.isnan(self._stop_time) \
            else min(self._stop_time, at)
        self._stopped = True

    def process(self, t0):
        t1 = t0 + FRAMES / self.ctx.sample_rate
        should_play = (self._started and t1 > self._start_time
                       and (math.isnan(self._stop_time)
                            or t0 < self._stop_time))
        if not should_play or self.buffer is None:
            self._set_output(0, np.zeros((1, FRAMES), f32), True)
            return

        channels, length = self.buffer.shape
        out = np.zeros((channels, FRAMES), f32)
        playback_rate = self.playback_rate.computed[0]
        ratio = self.buffer_rate / float(self.ctx.sample_rate)
        effective_rate = ratio * float(playback_rate)

        lsf = int(self.loop_start * self.buffer_rate)
        lef = int(self.loop_end * self.buffer_rate) if self.loop_end > 0 \
            else length
        lef = min(lef, length)
        lsf = min(lsf, lef)
        de = (int(self._offset * self.buffer_rate)
              + int(self._duration * self.buffer_rate)) \
            if self._duration < math.inf else length
        de = min(de, length)

        has_more = False
        if effective_rate == 1.0:
            for ch in range(channels):
                data = self.buffer[ch]
                pos = self._pos
                oi = 0
                while oi < FRAMES:
                    if self.loop and pos >= lef:
                        pos = lsf
                    if pos >= de and not self.loop:
                        break
                    end = lef if self.loop else min(de, length)
                    avail = min(end - pos, FRAMES - oi)
                    if avail <= 0:
                        break
                    out[ch, oi:oi + avail] = data[pos:pos + avail]
                    pos += avail
                    oi += avail
                    has_more = True
            self._pos += FRAMES
            if self.loop and self._pos >= lef:
                llen = lef - lsf
                if llen > 0:
                    self._pos = lsf + (self._pos - lef) % llen
        else:
            if self._resamplers is None or len(self._resamplers) != channels:
                self._resamplers = [_CubicResampler() for _ in range(channels)]
            total_consumed = 0
            for ch in range(channels):
                data = self.buffer[ch]
                pos = self._pos
                consumed_this = 0
                rs = self._resamplers[ch]
                oi = 0
                while oi < FRAMES:
                    if self.loop and pos >= lef:
                        pos = lsf
                    if pos >= de and not self.loop:
                        break
                    end = lef if self.loop else min(de, length)
                    avail = min(end - pos, length - pos)
                    if avail <= 0:
                        if self.loop and lef > lsf:
                            pos = lsf
                            consumed_this = pos - self._pos
                            continue
                        # Empty loop region (loop_start == loop_end): the
                        # reference's resample path livelocks here
                        # (AudioBufferSourceNode.cs:280-292 re-seats pos at
                        # loopStart and retries with available still 0); the
                        # oracle must not hang the test suite — emit silence.
                        break
                    if self.loop and pos + avail >= lef - 4:
                        # loop seam: stage wrap buffer (:297-314)
                        llen = lef - lsf
                        from_end = lef - pos
                        needed = min(FRAMES - oi + 4, 512)
                        wrap = np.empty(needed, f32)
                        copied = 0
                        i = 0
                        while i < from_end and copied < needed:
                            wrap[copied] = data[pos + i]
                            copied += 1
                            i += 1
                        i = 0
                        while copied < needed and i < llen:
                            wrap[copied] = data[lsf + i]
                            copied += 1
                            i += 1
                        ic, op = rs.process(wrap[:copied], out[ch], oi,
                                            FRAMES - oi, effective_rate)
                    else:
                        ic, op = rs.process(data[pos:pos + avail], out[ch],
                                            oi, FRAMES - oi, effective_rate)
                    if op > 0:
                        has_more = True
                    new_pos = pos + ic
                    if self.loop and new_pos >= lef:
                        new_pos = lsf + (new_pos - lef)
                    consumed_this += (new_pos - pos) if new_pos >= pos \
                        else (lef - pos + new_pos - lsf)
                    pos = new_pos
                    oi += op
                    if ic == 0 and op == 0:
                        break
                if ch == 0:
                    total_consumed = consumed_this
            self._pos += total_consumed
            if self.loop and self._pos >= lef:
                llen = lef - lsf
                if llen > 0:
                    self._pos = lsf + (self._pos - lef) % llen

        if not has_more or (not self.loop and self._pos >= de):
            out[:] = 0
            if math.isnan(self._stop_time):
                self._stop_time = t1
                self._stopped = True
            self._set_output(0, out, True)
        else:
            self._set_output(0, out, False)


class OracleConstantSource(OracleNode):
    """ConstantSourceNode.cs:76-142."""

    def __init__(self, ctx):
        super().__init__(ctx, 0, 1)
        self.offset = self._param(1.0, np.finfo(np.float32).min,
                                  np.finfo(np.float32).max, a_rate=True)
        self._started = False
        self._start_time = math.nan
        self._stop_time = math.nan

    def start(self, when=0.0):
        if self._started:
            return
        self._started = True
        self._start_time = max(0.0, when)

    def stop(self, when=0.0):
        # First-stop-wins guard (parity: the reference's `if (_hasStopped)
        # return`, OscillatorNode.Stop :76-89 — same rule on all sources).
        if getattr(self, "_stopped", False):
            return
        self._stopped = True
        at = max(0.0, when)
        self._stop_time = at if math.isnan(self._stop_time) \
            else min(self._stop_time, at)

    def process(self, t0):
        t1 = t0 + FRAMES / self.ctx.sample_rate
        sr = self.ctx.sample_rate
        start_frame, end_frame = 0, FRAMES
        should_play = (self._started and t1 > self._start_time
                       and (math.isnan(self._stop_time)
                            or t0 < self._stop_time))
        if should_play:
            if t0 < self._start_time < t1:
                start_frame = int(min(max(
                    math.ceil((self._start_time - t0) * sr), 0), FRAMES))
            if not math.isnan(self._stop_time) \
                    and t0 < self._stop_time < t1:
                end_frame = int(min(max(
                    math.floor((self._stop_time - t0) * sr), 0), FRAMES))
        out = np.zeros((1, FRAMES), f32)
        if not should_play:
            self._set_output(0, out, True)
            return
        if end_frame > start_frame:
            out[0, start_frame:end_frame] = \
                self.offset.computed[start_frame:end_frame]
        self._set_output(0, out, False)


class OracleGain(OracleNode):
    """GainNode.cs:29-61."""

    def __init__(self, ctx):
        super().__init__(ctx, 1, 1)
        self.gain = self._param(1.0, np.finfo(np.float32).min,
                                np.finfo(np.float32).max, a_rate=True)

    def process(self, t0):
        inp = self.inputs[0]
        if inp.silent:
            self._set_output(0, np.zeros_like(inp.buffer), True)
            return
        out = (inp.buffer * self.gain.computed[None, :]).astype(f32)
        self._set_output(0, out, False)


class OracleBiQuad(OracleNode):
    """BiQuadFilterNode.cs — sequential f32 IIR with the reference's
    threshold-gated coefficient updates (:110-143)."""

    TYPES = ("lowpass", "highpass", "bandpass", "notch", "allpass",
             "peaking", "lowshelf", "highshelf")

    def __init__(self, ctx, type="lowpass"):
        super().__init__(ctx, 1, 1)
        self.type = type
        self.frequency = self._param(1000.0, 1.0, ctx.sample_rate / 2.0, True)
        self.q = self._param(1.0, 0.001, 1000.0, True)
        self.gain = self._param(0.0, -60.0, 60.0, False)
        self._w1 = []
        self._w2 = []
        self._b = np.zeros(5, f32)  # b0 b1 b2 a1 a2
        self._dirty = True
        self._last_frequency = f32(1000.0)
        self._last_q = f32(1.0)
        self._update_coefficients(f32(1000.0), f32(1.0), f32(0.0))

    def _update_coefficients(self, frequency, q, gain):
        sr = f32(self.ctx.sample_rate)
        w0 = f32(f32(2.0) * f32(math.pi) * frequency / sr)
        cosw = f32(math.cos(w0))
        sinw = f32(math.sin(w0))
        alpha = f32(sinw / (f32(2.0) * q))
        one = f32(1.0)
        t = self.type
        if t == "lowpass":
            b0 = f32((one - cosw) / 2); b1 = f32(one - cosw); b2 = b0
            a0 = f32(one + alpha); a1 = f32(-2 * cosw); a2 = f32(one - alpha)
        elif t == "highpass":
            b0 = f32((one + cosw) / 2); b1 = f32(-(one + cosw)); b2 = b0
            a0 = f32(one + alpha); a1 = f32(-2 * cosw); a2 = f32(one - alpha)
        elif t == "bandpass":
            b0 = alpha; b1 = f32(0.0); b2 = f32(-alpha)
            a0 = f32(one + alpha); a1 = f32(-2 * cosw); a2 = f32(one - alpha)
        elif t == "notch":
            b0 = one; b1 = f32(-2 * cosw); b2 = one
            a0 = f32(one + alpha); a1 = f32(-2 * cosw); a2 = f32(one - alpha)
        elif t == "allpass":
            b0 = f32(one - alpha); b1 = f32(-2 * cosw); b2 = f32(one + alpha)
            a0 = f32(one + alpha); a1 = f32(-2 * cosw); a2 = f32(one - alpha)
        elif t == "peaking":
            A = f32(10.0 ** f32(gain / f32(40.0)))
            b0 = f32(one + alpha * A); b1 = f32(-2 * cosw)
            b2 = f32(one - alpha * A)
            a0 = f32(one + alpha / A); a1 = f32(-2 * cosw)
            a2 = f32(one - alpha / A)
        elif t == "lowshelf":
            A = f32(10.0 ** f32(gain / f32(40.0)))
            beta = f32(f32(math.sqrt(A)) / q)
            b0 = f32(A * ((A + 1) - (A - 1) * cosw + beta * sinw))
            b1 = f32(2 * A * ((A - 1) - (A + 1) * cosw))
            b2 = f32(A * ((A + 1) - (A - 1) * cosw - beta * sinw))
            a0 = f32((A + 1) + (A - 1) * cosw + beta * sinw)
            a1 = f32(-2 * ((A - 1) + (A + 1) * cosw))
            a2 = f32((A + 1) + (A - 1) * cosw - beta * sinw)
        elif t == "highshelf":
            A = f32(10.0 ** f32(gain / f32(40.0)))
            beta = f32(f32(math.sqrt(A)) / q)
            b0 = f32(A * ((A + 1) + (A - 1) * cosw + beta * sinw))
            b1 = f32(-2 * A * ((A - 1) + (A + 1) * cosw))
            b2 = f32(A * ((A + 1) + (A - 1) * cosw - beta * sinw))
            a0 = f32((A + 1) - (A - 1) * cosw + beta * sinw)
            a1 = f32(2 * ((A - 1) - (A + 1) * cosw))
            a2 = f32((A + 1) - (A - 1) * cosw - beta * sinw)
        else:
            b0, b1, b2 = one, f32(0.0), f32(0.0)
            a0, a1, a2 = one, f32(0.0), f32(0.0)
        self._b[:] = (f32(b0 / a0), f32(b1 / a0), f32(b2 / a0),
                      f32(a1 / a0), f32(a2 / a0))

    def process(self, t0):
        inp = self.inputs[0]
        channels = inp.buffer.shape[0]
        while len(self._w1) < channels:
            self._w1.append(f32(0.0))
            self._w2.append(f32(0.0))
        if inp.silent:
            self._set_output(0, np.zeros_like(inp.buffer), True)
            return
        freq = self.frequency.computed
        qv = self.q.computed
        gain_db = self.gain.computed[0]
        out = np.zeros_like(inp.buffer)
        b0, b1, b2, a1, a2 = self._b
        # Deliberate bug-compatibility with the reference
        # (BiQuadFilterNode.cs:110-113): used_gain seeds from the CURRENT
        # block's gain and _last_frequency/_last_q are never written back,
        # so a gain-only change recomputes coefficients only because the
        # per-block used_freq reset re-trips the frequency gate whenever
        # frequency != the ctor default. Do not "fix" — the oracle's job is
        # the reference's exact behavior.
        used_freq = self._last_frequency
        used_q = self._last_q
        used_gain = gain_db
        nyq = f32(self.ctx.sample_rate / 2.0)
        for ch in range(channels):
            x = inp.buffer[ch]
            w1, w2 = self._w1[ch], self._w2[ch]
            for i in range(FRAMES):
                fv = f32(min(max(freq[i], f32(1.0)), nyq))
                q = f32(max(f32(0.001), qv[i]))
                if (self._dirty or abs(fv - used_freq) > 0.001
                        or abs(q - used_q) > 0.0001
                        or abs(gain_db - used_gain) > 0.001):
                    self._update_coefficients(fv, q, gain_db)
                    used_freq, used_q, used_gain = fv, q, gain_db
                    self._dirty = False
                    b0, b1, b2, a1, a2 = self._b
                xi = x[i]
                w = f32(xi - a1 * w1 - a2 * w2)
                y = f32(b0 * w + b1 * w1 + b2 * w2)
                w2 = w1
                w1 = w
                out[ch, i] = y
            self._w1[ch], self._w2[ch] = w1, w2
        self._set_output(0, out, False)


class _OraclePartConv:
    """PartitionedConvolver.cs — f64 FFTs (FftFlat transforms doubles),
    f32 spectra, f32 spectral MAC, frequency-domain delay line."""

    def __init__(self, ir, normalize=True):
        ir = np.asarray(ir, f32)
        scale = f32(1.0)
        if normalize:
            sum_sq = float(np.sum(ir.astype(np.float64) ** 2))
            power = f32(math.sqrt(sum_sq / len(ir))) if len(ir) else f32(0)
            if not np.isfinite(power) or power < f32(0.000125):
                power = f32(0.000125)
            scale = f32((f32(1.0) / power) * f32(10.0 ** (-58.0 * 0.05)))
        n_part = max(1, -(-len(ir) // FRAMES))
        self.n_part = n_part
        self.hr = np.zeros((n_part, FRAMES + 1), f32)
        self.hi = np.zeros((n_part, FRAMES + 1), f32)
        for p in range(n_part):
            seg = ir[p * FRAMES:(p + 1) * FRAMES]
            t = np.zeros(2 * FRAMES, np.float64)
            t[:len(seg)] = (seg * scale).astype(f32)
            spec = np.fft.rfft(t)
            self.hr[p] = spec.real.astype(f32)
            self.hi[p] = spec.imag.astype(f32)
        self.dr = np.zeros((n_part, FRAMES + 1), f32)
        self.di = np.zeros((n_part, FRAMES + 1), f32)
        self.write = 0
        self.overlap = np.zeros(FRAMES, f32)

    def process(self, x):
        t = np.zeros(2 * FRAMES, np.float64)
        t[:FRAMES] = x
        spec = np.fft.rfft(t)
        self.dr[self.write] = spec.real.astype(f32)
        self.di[self.write] = spec.imag.astype(f32)
        # spectral MAC, f32 accumulate (:155-223)
        acc_r = np.zeros(FRAMES + 1, f32)
        acc_i = np.zeros(FRAMES + 1, f32)
        for p in range(self.n_part):
            dpos = self.write + p
            if dpos >= self.n_part:
                dpos -= self.n_part
            dr, di = self.dr[dpos], self.di[dpos]
            hr, hi = self.hr[p], self.hi[p]
            acc_r += (dr * hr - di * hi).astype(f32)
            acc_i += (dr * hi + di * hr).astype(f32)
        self.write -= 1
        if self.write < 0:
            self.write = self.n_part - 1
        y = np.fft.irfft(acc_r.astype(np.float64)
                         + 1j * acc_i.astype(np.float64), 2 * FRAMES)
        out = (y[:FRAMES].astype(f32) + self.overlap).astype(f32)
        self.overlap = y[FRAMES:].astype(f32)
        return out


class OracleConvolver(OracleNode):
    """ConvolverNode.cs:102-155 (incl. 4-channel true-stereo matrixing)."""

    def __init__(self, ctx, normalize=True, enable_true_stereo=True):
        super().__init__(ctx, 1, 1)
        self.normalize = normalize
        self.enable_true_stereo = enable_true_stereo
        self._convolvers = None
        self._true_stereo = False
        self._out_channels = 0

    def set_buffer(self, data, sample_rate):
        data = np.asarray(data, f32)
        if data.ndim == 1:
            data = data[None, :]
        if sample_rate != self.ctx.sample_rate:
            raise ValueError("IR sample rate must match context")
        self._convolvers = [_OraclePartConv(ch, self.normalize)
                            for ch in data]
        channels = data.shape[0]
        self._true_stereo = channels == 4 and self.enable_true_stereo
        self._out_channels = 2 if self._true_stereo else channels
        self.inputs[0].channel_count = 2 if self._true_stereo else channels
        self.inputs[0].mode = "explicit"

    def process(self, t0):
        inp = self.inputs[0]
        if self._convolvers is None:
            self._set_output(0, np.zeros_like(inp.buffer), True)
            return
        out = np.zeros((self._out_channels, FRAMES), f32)
        if self._true_stereo:
            c = self._convolvers
            ll = c[0].process(inp.buffer[0])
            rl = c[2].process(inp.buffer[1])
            out[0] = (ll + rl).astype(f32)
            lr = c[1].process(inp.buffer[0])
            rr = c[3].process(inp.buffer[1])
            out[1] = (lr + rr).astype(f32)
        else:
            for ch in range(self._out_channels):
                out[ch] = self._convolvers[ch].process(inp.buffer[ch])
        self._set_output(0, out, False)


class OracleStereoPanner(OracleNode):
    """StereoPannerNode.cs:36-153."""

    def __init__(self, ctx):
        super().__init__(ctx, 1, 1)
        self.inputs[0].channel_count = 2
        self.inputs[0].mode = "clamped-max"
        self.pan = self._param(0.0, -1.0, 1.0, a_rate=True)
        self._last_pan = f32(math.nan)
        self._gl = f32(0.5)
        self._gr = f32(0.5)

    def process(self, t0):
        inp = self.inputs[0]
        if inp.silent:
            self._set_output(0, np.zeros((2, FRAMES), f32), True)
            return
        pv = self.pan.computed
        out = np.zeros((2, FRAMES), f32)
        gl, gr, last = self._gl, self._gr, self._last_pan
        mono = inp.buffer.shape[0] == 1
        half_pi = f32(math.pi / 2.0)
        for i in range(FRAMES):
            pan = f32(min(max(pv[i], f32(-1.0)), f32(1.0)))
            if pan != last:
                if mono:
                    x = f32((pan + f32(1.0)) * f32(0.5))
                else:
                    x = f32(pan + f32(1.0)) if pan <= 0 else pan
                gl = f32(math.cos(x * half_pi))
                gr = f32(math.sin(x * half_pi))
                last = pan
            if mono:
                s = inp.buffer[0, i]
                out[0, i] = f32(s * gl)
                out[1, i] = f32(s * gr)
            else:
                il, ir = inp.buffer[0, i], inp.buffer[1, i]
                if pan <= 0:
                    out[0, i] = f32(il + ir * gl)
                    out[1, i] = f32(ir * gr)
                else:
                    out[0, i] = f32(il * gl)
                    out[1, i] = f32(ir + il * gr)
        self._gl, self._gr, self._last_pan = gl, gr, last
        self._set_output(0, out, False)


class _OracleDestination(OracleNode):
    def __init__(self, ctx):
        super().__init__(ctx, 1, 0)
        self.inputs[0].channel_count = 2
        self.buffer = None

    def process(self, t0):
        self.buffer = self.inputs[0].buffer


# ---------------------------------------------------------------------------
# Context (AudioContextBase.cs:52-81 + OfflineAudioContext.cs:77-101)
# ---------------------------------------------------------------------------

class OracleContext:
    def __init__(self, sample_rate=48000):
        self.sample_rate = int(sample_rate)
        self.nodes = []
        self.destination = None
        self._block = 0
        self._time = 0.0
        # Listener transform (SteamAudioContext.SetListener, :136-164):
        # right-handed basis with ahead = -forward.
        self.listener_pos = np.zeros(3)
        self.listener_right = np.array([1.0, 0.0, 0.0])
        self.listener_up = np.array([0.0, 1.0, 0.0])
        self.listener_ahead = np.array([0.0, 0.0, 1.0])
        self.destination = _OracleDestination(self)

    def set_listener(self, position, forward, up):
        position = np.asarray(position, np.float64)
        f = np.asarray(forward, np.float64)
        u = np.asarray(up, np.float64)
        f = f / max(np.linalg.norm(f), 1e-9)
        u = u / max(np.linalg.norm(u), 1e-9)
        right = np.cross(f, u)
        right /= max(np.linalg.norm(right), 1e-9)
        true_up = np.cross(right, f)
        self.listener_pos = position
        self.listener_right = right
        self.listener_up = true_up
        self.listener_ahead = -f

    def process_block(self):
        self._block += 1
        self.destination.process_internal(self._block, self._time, self)
        self._time += FRAMES / self.sample_rate
        return self.destination.buffer

    def render(self, frames):
        out = None
        written = 0
        while written < frames:
            blk = self.process_block()
            if out is None:
                out = np.zeros((blk.shape[0], frames), f32)
            n = min(FRAMES, frames - written)
            out[:, written:written + n] = blk[:, :n]
            written += n
        return out


class OracleOscillator(OracleNode):
    """OscillatorNode.cs:87-196 — f64 phase accumulation, sub-block
    start/stop gating, four waveforms."""

    def __init__(self, ctx, type="sine"):
        super().__init__(ctx, 0, 1)
        self.type = type
        self.frequency = self._param(440.0, 0.0, ctx.sample_rate / 2.0, True)
        self._started = False
        self._stopped = False
        self._start_time = math.nan
        self._stop_time = math.nan
        self._phase = 0.0

    def start(self, when=0.0, duration=math.nan):
        if self._started:
            return
        self._started = True
        self._start_time = max(0.0, when)
        if not math.isnan(duration) and duration >= 0:
            self._stop_time = self._start_time + duration
            self._stopped = True

    def stop(self, when=0.0):
        if self._stopped:  # first-stop-wins (OscillatorNode.Stop :76-89)
            return
        at = max(0.0, when)
        self._stop_time = at if math.isnan(self._stop_time) \
            else min(self._stop_time, at)
        self._stopped = True

    def _sample(self, phase):
        t = self.type
        if t == "sine":
            return f32(math.sin(phase))
        if t == "square":
            return f32(1.0) if phase < math.pi else f32(-1.0)
        if t == "sawtooth":
            return f32(2.0 * (phase / (2.0 * math.pi)) - 1.0)
        if t == "triangle":
            u = phase / (2.0 * math.pi)
            return f32(4.0 * abs(u - math.floor(u + 0.5)) - 1.0)
        return f32(0.0)

    def process(self, t0):
        sr = self.ctx.sample_rate
        t1 = t0 + FRAMES / sr
        start_frame, end_frame = 0, FRAMES
        should_play = (self._started and t1 > self._start_time
                       and (math.isnan(self._stop_time)
                            or t0 < self._stop_time))
        if should_play:
            if t0 < self._start_time < t1:
                start_frame = int(min(max(
                    math.ceil((self._start_time - t0) * sr), 0), FRAMES))
            if not math.isnan(self._stop_time) \
                    and t0 < self._stop_time < t1:
                end_frame = int(min(max(
                    math.floor((self._stop_time - t0) * sr), 0), FRAMES))
        out = np.zeros((1, FRAMES), f32)
        if not should_play:
            self._set_output(0, out, True)
            return
        freq = self.frequency.computed
        for i in range(start_frame, end_frame):
            out[0, i] = self._sample(self._phase)
            self._phase += (2.0 * math.pi * float(freq[i])) / sr
            if self._phase >= 2.0 * math.pi:
                self._phase -= 2.0 * math.pi
        self._set_output(0, out, False)


class OracleDelay(OracleNode):
    """DelayNode.cs — per-sample integer delay reads from a circular
    buffer, read-before-write, zero for delay <= 0."""

    def __init__(self, ctx, max_delay_time=1.0):
        super().__init__(ctx, 1, 1)
        self._max = int(max_delay_time * ctx.sample_rate)
        self.delay_time = self._param(0.0, 0.0, max_delay_time, a_rate=True)
        self._rings = []
        self._wpos = 0

    def process(self, t0):
        inp = self.inputs[0]
        channels = inp.buffer.shape[0]
        while len(self._rings) < channels:
            self._rings.append(np.zeros(self._max, f32))
        d = self.delay_time.computed
        out = np.zeros((channels, FRAMES), f32)
        has_audio = False
        silent = inp.silent
        wpos0 = self._wpos
        for ch in range(channels):
            ring = self._rings[ch]
            w = wpos0
            for i in range(FRAMES):
                ds = int(f32(d[i]) * self.ctx.sample_rate)
                ds = min(max(ds, 0), self._max)
                if ds <= 0 or ds > self._max:
                    out[ch, i] = 0.0
                else:
                    out[ch, i] = ring[(w - ds) % self._max]
                ring[w] = 0.0 if silent else inp.buffer[ch, i]
                w = (w + 1) % self._max
                if out[ch, i] != 0:
                    has_audio = True
        self._wpos = (wpos0 + FRAMES) % self._max
        self._set_output(0, out, not has_audio)


class OracleChannelSplitter(OracleNode):
    """ChannelSplitterNode.cs — 1 input -> N mono outputs."""

    def __init__(self, ctx, n_outputs=2):
        super().__init__(ctx, 1, n_outputs)

    def process(self, t0):
        inp = self.inputs[0]
        for i in range(len(self.outputs)):
            out = np.zeros((1, FRAMES), f32)
            if not inp.silent and i < inp.buffer.shape[0]:
                out[0] = inp.buffer[i]
                self._set_output(i, out, False)
            else:
                self._set_output(i, out, True)


class OracleChannelMerger(OracleNode):
    """ChannelMergerNode.cs — N mono inputs -> one N-channel output
    (channel 0 of each input)."""

    def __init__(self, ctx, n_inputs=2):
        super().__init__(ctx, n_inputs, 1)
        for inp in self.inputs:
            inp.channel_count = 1
            inp.mode = "explicit"

    def process(self, t0):
        n = len(self.inputs)
        out = np.zeros((n, FRAMES), f32)
        has_audio = False
        for i, inp in enumerate(self.inputs):
            if not inp.silent:
                out[i] = inp.buffer[0]
                has_audio = True
        self._set_output(0, out, not has_audio)


# ---------------------------------------------------------------------------
# SpatialPannerNode (GraphAudio.SteamAudio/Nodes/SpatialPannerNode.cs:94-284)
# ---------------------------------------------------------------------------

class OracleSpatialPanner(OracleNode):
    """Closed-form direct path + binaural HRIR render, implemented literally.

    Mirrors SpatialPannerNode.cs: 17 k-rate params (:94-110),
    listener-relative direction in the listener basis (:133-164), cone
    directivity (:166-204), distance attenuation with the
    Linear/Inverse/Exponential model override (:206-216, 263-284), occlusion
    with 3-band frequency-dependent transmission (:218-248), HRTF render
    with bilinear interpolation and the SpatialBlend 2D/3D crossfade
    (:250-260).

    The HRIR grid (f32[E, A, 2, L] — the model's data table, supplied by the
    caller) is shared with the production node; everything DOWNSTREAM of the
    table — bilinear interpolation, per-block overlap-add convolution, the
    3-band one-pole crossover split, gain math, and state carry — is an
    independent per-block numpy reimplementation (time-domain convolution
    here vs the production node's frequency-domain form; equal by linearity
    of DFT and interpolation).
    """

    XOVER_LOW_HZ = 800.0
    XOVER_HIGH_HZ = 8000.0

    def __init__(self, ctx, hrir_grid, distance_model="inverse"):
        super().__init__(ctx, 1, 1)
        self.inputs[0].channel_count = 2
        self.inputs[0].mode = "clamped-max"
        self.grid = np.asarray(hrir_grid, np.float64)  # [E, A, 2, L]
        self.distance_model = distance_model
        FMAX = 3.4028235e38
        P = lambda d, lo, hi: self._param(d, lo, hi, a_rate=False)  # noqa: E731
        self.position_x = P(0.0, -FMAX, FMAX)
        self.position_y = P(0.0, -FMAX, FMAX)
        self.position_z = P(0.0, -FMAX, FMAX)
        self.orientation_x = P(1.0, -1.0, 1.0)
        self.orientation_y = P(0.0, -1.0, 1.0)
        self.orientation_z = P(0.0, -1.0, 1.0)
        self.ref_distance = P(1.0, 0.0, FMAX)
        self.max_distance = P(10000.0, 0.0, FMAX)
        self.rolloff_factor = P(1.0, 0.0, FMAX)
        self.cone_inner_angle = P(360.0, 0.0, 360.0)
        self.cone_outer_angle = P(360.0, 0.0, 360.0)
        self.cone_outer_gain = P(0.0, 0.0, 1.0)
        self.spatial_blend = P(1.0, 0.0, 1.0)
        self.occlusion = P(0.0, 0.0, 1.0)
        self.transmission_low = P(0.0, 0.0, 1.0)
        self.transmission_mid = P(0.0, 0.0, 1.0)
        self.transmission_high = P(0.0, 0.0, 1.0)
        self._ola = np.zeros((2, FRAMES))
        self._xlow = None  # per-channel crossover states, sized on first use
        self._xhigh = None

    def _direct_gains(self):
        k = lambda p: float(p.computed[0])  # noqa: E731
        ctx = self.ctx
        lp = ctx.listener_pos
        wd = np.array([
            k(self.position_x) - lp[0],
            k(self.position_y) - lp[1],
            k(self.position_z) - lp[2],
        ])
        distance = float(np.sqrt(np.sum(wd * wd)))
        if distance <= 1e-4:
            dx, dy, dz = 0.0, 0.0, -1.0
            distance = 0.0
            wdn = np.zeros(3)
        else:
            wdn = wd / distance
            dx = float(np.dot(wdn, ctx.listener_right))
            dy = float(np.dot(wdn, ctx.listener_up))
            dz = float(np.dot(wdn, ctx.listener_ahead))

        # Cone directivity (:166-204).
        o = np.array([
            k(self.orientation_x), k(self.orientation_y),
            k(self.orientation_z),
        ])
        inner = k(self.cone_inner_angle)
        outer = k(self.cone_outer_angle)
        outer_gain = k(self.cone_outer_gain)
        omag = float(np.sqrt(np.sum(o * o)))
        directivity = 1.0
        if (inner < 360.0 or outer < 360.0) and omag > 1e-4:
            dot = min(max(-float(np.dot(o, wdn)) / max(omag, 1e-9), -1.0), 1.0)
            angle = abs(math.degrees(math.acos(dot)))
            half_inner, half_outer = inner * 0.5, outer * 0.5
            if angle <= half_inner:
                directivity = 1.0
            elif angle >= half_outer:
                directivity = outer_gain
            else:
                t = (angle - half_inner) / max(half_outer - half_inner, 1e-6)
                directivity = 1.0 + t * (outer_gain - 1.0)

        # Distance attenuation (:206-216, 263-284).
        ref = k(self.ref_distance)
        mx = k(self.max_distance)
        rolloff = k(self.rolloff_factor)
        dc = min(max(distance, ref), mx)
        if self.distance_model == "linear":
            atten = 1.0 - rolloff * (dc - ref) / max(mx - ref, 1e-9)
        elif self.distance_model == "exponential":
            atten = max(dc / max(ref, 1e-9), 1e-9) ** (-rolloff)
        else:  # inverse
            atten = 1.0 if distance <= ref else ref / max(distance, 1e-9)
        atten = min(max(atten, 0.0), 1.0)

        # Occlusion + 3-band transmission (:218-248).
        occ = k(self.occlusion)
        tl = k(self.transmission_low)
        tm = k(self.transmission_mid)
        th = k(self.transmission_high)
        any_trans = tl > 0.0 or tm > 0.0 or th > 0.0

        def band(tr):
            if occ <= 0.0:
                return 1.0
            if any_trans:
                return (1.0 - occ) + occ * tr
            return 1.0 - occ

        base = atten * directivity
        gains = (base * band(tl), base * band(tm), base * band(th))
        return dx, dy, dz, gains, k(self.spatial_blend)

    def _interp_hrir(self, azimuth, elevation):
        E, A, _, L = self.grid.shape
        az = math.fmod(azimuth, 2 * math.pi)
        if az < 0:
            az += 2 * math.pi
        azf = az / (2 * math.pi) * A
        elf = (elevation + math.pi / 2) / math.pi * (E - 1)
        a0 = int(math.floor(azf)) % A
        a1 = (a0 + 1) % A
        fa = azf - math.floor(azf)
        e0 = min(max(int(math.floor(elf)), 0), E - 1)
        e1 = min(e0 + 1, E - 1)
        fe = elf - math.floor(elf)
        return (
            self.grid[e0, a0] * ((1 - fa) * (1 - fe))
            + self.grid[e0, a1] * (fa * (1 - fe))
            + self.grid[e1, a0] * ((1 - fa) * fe)
            + self.grid[e1, a1] * (fa * fe)
        )  # [2, L]

    def process(self, t0):
        inp = self.inputs[0]
        x = inp.buffer.astype(np.float64)  # [C, 128]
        C = x.shape[0]
        if self._xlow is None or self._xlow.shape[0] != C:
            self._xlow = np.zeros(C)
            self._xhigh = np.zeros(C)

        dx, dy, dz, (gl, gm, gh), blend = self._direct_gains()

        # 3-band split: two sequential one-pole lowpasses
        # (y[n] = a*y[n-1] + (1-a)*x[n]), crossovers at 800 Hz / 8 kHz.
        sr = self.ctx.sample_rate
        a_lo = math.exp(-2.0 * math.pi * self.XOVER_LOW_HZ / sr)
        a_hi = math.exp(-2.0 * math.pi * self.XOVER_HIGH_HZ / sr)
        low = np.zeros_like(x)
        lowmid = np.zeros_like(x)
        for c in range(C):
            yl, yh = self._xlow[c], self._xhigh[c]
            for i in range(FRAMES):
                yl = a_lo * yl + (1.0 - a_lo) * x[c, i]
                yh = a_hi * yh + (1.0 - a_hi) * x[c, i]
                low[c, i] = yl
                lowmid[c, i] = yh
            self._xlow[c], self._xhigh[c] = yl, yh
        mid = lowmid - low
        high = x - lowmid
        direct = low * gl + mid * gm + high * gh  # [C, 128]

        # Binaural render: mono mean -> interpolated HRIR -> overlap-add.
        mono = np.mean(direct, axis=0)  # [128]
        azimuth = math.atan2(dx, -dz)
        elevation = math.asin(min(max(dy, -1.0), 1.0))
        h = self._interp_hrir(azimuth, elevation)  # [2, L]
        # OLA carry sized for the kernel: L - 1 tail samples may span
        # several future blocks (the renderer's partitioned path supports
        # measured kernels up to 1024 taps).
        tail_len = max(h.shape[-1] - 1, FRAMES)
        if self._ola.shape[-1] < tail_len:
            self._ola = np.pad(
                self._ola, ((0, 0), (0, tail_len - self._ola.shape[-1]))
            )
        wet = np.zeros((2, FRAMES))
        new_ola = np.zeros((2, self._ola.shape[-1]))
        new_ola[:, : new_ola.shape[-1] - FRAMES] = self._ola[:, FRAMES:]
        for ear in range(2):
            full = np.convolve(mono, h[ear])  # [128 + L - 1]
            wet[ear] = full[:FRAMES] + self._ola[ear, :FRAMES]
            tail = full[FRAMES:]
            new_ola[ear, : tail.shape[0]] += tail
        self._ola = new_ola

        # SpatialBlend crossfade; dry up-mixes mono -> stereo by broadcast.
        dry = np.broadcast_to(direct[0], (2, FRAMES)) if C == 1 else direct[:2]
        out = wet * blend + dry * (1.0 - blend)
        self._set_output(0, out.astype(f32), False)
