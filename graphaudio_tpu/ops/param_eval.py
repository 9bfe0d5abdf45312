"""Vectorized AudioParam automation-curve evaluation.

The reference evaluates each a-rate parameter by walking its sorted event list
once per sample (GraphAudio.Core/AudioParam.cs:113-141, 168-247) — 128
sequential event walks per block. Here the event list is encoded host-side
into fixed-shape tensors (padded to a static capacity) and the value at all T
sample times is computed in one vectorized pass: a ``searchsorted`` locates
each sample's surrounding events, then the four curve types (SetValue /
LinearRamp / ExponentialRamp / SetTarget) are evaluated with ``where`` masks.

Event semantics mirror AudioParam.ComputeValueAtTime exactly:
  * the "boundary value" before event ``i`` is the value of the last
    non-SetTarget event before ``i`` (or the param's base value) — precomputed
    host-side as ``boundary[i]`` so the device pass is pure gathers;
  * a LinearRamp/ExponentialRamp event at time t1 interpolates from the
    previous event (value v0 at t0) for t in (t0, t1) (AudioParam.cs:219-237);
  * a SetTarget event at t0 decays from the boundary value toward its target
    with time constant max(tc, 0.001) (AudioParam.cs:239-247);
  * past the last event the final value holds (or the SetTarget decay
    continues) (AudioParam.cs:208-216).

Times are float64 (the reference uses doubles for its clock); values float32.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Event type codes (parity: AudioParam.cs:369-375).
EVT_SET_VALUE = 0
EVT_LINEAR_RAMP = 1
EVT_EXPONENTIAL_RAMP = 2
EVT_SET_TARGET = 3

_INF = np.float64(np.inf)


def encode_events(base_value, events, capacity):
    """Encode a sorted host-side event list into fixed-shape arrays.

    Args:
      base_value: the param's current base value (reference ``_value``),
        used when no events apply.
      events: sequence of (type, time, value, time_constant) tuples sorted by
        time (the host AudioParam maintains sort order on insert, mirroring
        AudioParam.AddEvent:333-352).
      capacity: static padded event capacity (>= len(events)).

    Returns a dict of numpy arrays (uploaded as jit arguments):
      times f64[capacity] (padded +inf), values f32, tcs f64,
      types i32, boundary f32[capacity+1], n i32 scalar, base f32 scalar.
    """
    n = len(events)
    if n > capacity:
        raise ValueError(f"event count {n} exceeds capacity {capacity}")
    times = np.full((capacity,), _INF, dtype=np.float64)
    values = np.zeros((capacity,), dtype=np.float32)
    tcs = np.full((capacity,), 1.0, dtype=np.float64)
    types = np.zeros((capacity,), dtype=np.int32)
    boundary = np.full((capacity + 1,), np.float32(base_value), dtype=np.float32)

    b = np.float32(base_value)
    for i, (etype, etime, evalue, etc) in enumerate(events):
        times[i] = etime
        values[i] = evalue
        tcs[i] = etc
        types[i] = etype
        boundary[i] = b
        if etype != EVT_SET_TARGET:
            b = np.float32(evalue)
    boundary[n:] = b

    return {
        "times": times,
        "values": values,
        "tcs": tcs,
        "types": types,
        "boundary": boundary,
        "n": np.int32(n),
        "base": np.float32(base_value),
    }


def eval_intrinsic(enc, t):
    """Evaluate the intrinsic (pre-modulation) param curve at sample times.

    Args:
      enc: encoded event dict (see encode_events; values may be jnp arrays).
      t: f64[T] sample times.

    Returns f32[T] intrinsic values.

    Parity: AudioParam.ComputeValueAtTime (AudioParam.cs:168-247).
    """
    times = enc["times"]
    values = enc["values"]
    tcs = enc["tcs"]
    types = enc["types"]
    boundary = enc["boundary"]
    n = enc["n"]
    base = enc["base"]

    if times.shape[0] == 0:
        # Capacity 0 = statically event-free (the graph encodes untouched
        # params with zero capacity; scheduling the first event grows the
        # capacity, changing argument shapes and re-tracing). The curve is
        # the base value everywhere — skip the whole selection machinery.
        return jnp.broadcast_to(jnp.asarray(base, jnp.float32), t.shape)

    # idx = number of events with event.time <= t  (first future event index).
    # The reference walks events while `t >= evt.Time` (AudioParam.cs:181).
    idx = jnp.searchsorted(times, t, side="right").astype(jnp.int32)
    idx = jnp.minimum(idx, n)  # padded +inf never matches, but clamp for safety

    prev = jnp.maximum(idx - 1, 0)
    has_prev = idx > 0
    has_next = idx < n

    next_type = jnp.where(has_next, types[jnp.minimum(idx, times.shape[0] - 1)], -1)
    prev_type = types[prev]

    t0 = times[prev]
    v0 = values[prev].astype(jnp.float64)
    t1 = times[jnp.minimum(idx, times.shape[0] - 1)]
    v1 = values[jnp.minimum(idx, times.shape[0] - 1)].astype(jnp.float64)

    # Linear interpolation (AudioParam.cs:219-225): u clamped to [0,1].
    # (t0/t1 may be the +inf padding on paths masked out below; sanitize to
    # keep the arithmetic warning-free.)
    t0s = jnp.where(jnp.isfinite(t0), t0, 0.0)
    t1s = jnp.where(jnp.isfinite(t1), t1, t0s + 1.0)
    denom = t1s - t0s
    safe_denom = jnp.where(denom == 0.0, 1.0, denom)
    u = jnp.clip((t - t0s) / safe_denom, 0.0, 1.0)
    lin = v0 + (v1 - v0) * u

    # Exponential interpolation (AudioParam.cs:227-237): falls back to linear
    # when either endpoint is <= 0.
    exp_ok = (v0 > 0.0) & (v1 > 0.0)
    safe_v0 = jnp.where(exp_ok, v0, 1.0)
    safe_v1 = jnp.where(exp_ok, v1, 1.0)
    expv = safe_v0 * jnp.power(safe_v1 / safe_v0, u)
    exp_val = jnp.where(exp_ok, expv, lin)

    # SetTarget decay from the boundary value (AudioParam.cs:239-247).
    bl = boundary[idx].astype(jnp.float64)  # boundary before event idx
    elapsed = t - t0s
    tc = jnp.maximum(tcs[prev], 0.001)
    tgt = values[prev].astype(jnp.float64)  # SetTarget stores target in value slot
    decay = tgt + (bl - tgt) * jnp.exp(-jnp.maximum(elapsed, 0.0) / tc)
    settarget_val = jnp.where(elapsed <= 0.0, bl, decay)

    # Hold previous event's value (SetValue / completed ramps).
    hold = v0

    # Selection mirrors the reference's branch order: a pending Linear/Exp ramp
    # interpolates; else a previous SetTarget decays; else hold; before the
    # first event, the base boundary value applies.
    val = jnp.where(
        has_next & (next_type == EVT_LINEAR_RAMP),
        lin,
        jnp.where(
            has_next & (next_type == EVT_EXPONENTIAL_RAMP),
            exp_val,
            jnp.where(prev_type == EVT_SET_TARGET, settarget_val, hold),
        ),
    )
    val = jnp.where(has_prev, val, base.astype(jnp.float64))
    # No events at all -> base value (AudioParam.cs:173-174).
    val = jnp.where(n > 0, val, base.astype(jnp.float64))
    return val.astype(jnp.float32)


def eval_intrinsic_blocked(enc, block_times, n_per_block, sample_dt,
                           exact: bool = False):
    """``eval_intrinsic`` restructured for the device: f64 anchors, f32
    samples.

    float64 math costs far more than f32 on accelerators, and per-sample
    curve math in f64 grows with voice count. The reference's double clock only matters for
    ABSOLUTE times; deltas within a 128-frame block are tiny. So: compute
    each event time RELATIVE to its block start in f64 once per block
    ([S, capacity] values), round to f32, and do all per-sample selection
    and curve math ([S, n, capacity] / [S, n]) in f32.

    Accuracy: the relative times are exact to f32 rounding of (time - t0),
    so curve VALUES match the f64 path to ~1e-7 relative — below the f32
    arithmetic the reference itself uses for values. The only observable
    deviation is a potential one-sample snap of an event boundary when the
    event time is not exactly representable, identical in kind to the
    reference's own f64->sample-index rounding.

    Args:
      enc: encoded event dict (see encode_events).
      block_times: f64[S] absolute start time of each 128-frame block.
      n_per_block: samples per block (128 for a-rate, 1 for k-rate).
      sample_dt: f64 scalar seconds per sample.

    Returns f32[S * n_per_block] intrinsic values.

    Parity: AudioParam.ComputeValueAtTime (AudioParam.cs:168-247).
    """
    if enc["times"].shape[0] == 0:
        # Statically event-free (capacity 0, see eval_intrinsic): constant
        # base value. One broadcast instead of [S, n, cap] selection math —
        # untouched params (most gains, most spatial-panner params) cost
        # nothing per step.
        S = block_times.shape[0]
        return jnp.broadcast_to(
            jnp.asarray(enc["base"], jnp.float32), (S * n_per_block,)
        )
    if exact and n_per_block == 1:
        # EXACT k-rate (opt-in via AudioParam.exact_eval; playbackRate):
        # evaluate the curve in FULL f64 absolute time — the reference's
        # InterpolateLinear/Exponential do all math in doubles and round
        # once (AudioParam.cs:219-237), and a 1-ulp f32 difference here is
        # INTEGRATED into position drift by the resampler. The cost is S
        # scalars per step; non-integrating params keep the f32 fast path
        # (f64 pow/exp are costly, and a spatial panner has 17 k-rate
        # params).
        return eval_intrinsic(enc, block_times)

    times = enc["times"]  # f64[cap]
    values = enc["values"]  # f32[cap]
    tcs = enc["tcs"]  # f64[cap]
    types = enc["types"]  # i32[cap]
    boundary = enc["boundary"]  # f32[cap+1]
    n = enc["n"]
    base = enc["base"]
    S = block_times.shape[0]
    cap = times.shape[0]

    # Per-block f64 -> f32 relative event times (+inf padding -> large
    # finite so all f32 arithmetic below stays NaN-free).
    rel = jnp.clip(
        times[None, :] - block_times[:, None], -3.0e38, 3.0e38
    ).astype(jnp.float32)  # [S, cap]
    io = (
        jnp.arange(n_per_block, dtype=jnp.float64) * sample_dt
    ).astype(jnp.float32)  # [n]

    # idx = number of events with event.time <= t (reference walks while
    # `t >= evt.Time`, AudioParam.cs:181). The comparison runs in f64
    # ABSOLUTE time: event times routinely coincide with sample instants
    # (e.g. setValueAtTime at k/8 s), and classifying the boundary sample
    # through f32 relative coordinates snaps it the wrong way. f64 compares
    # are cheap (no multiplies); only the curve VALUE math stays f32.
    ts = block_times[:, None] + (
        jnp.arange(n_per_block, dtype=jnp.float64) * sample_dt
    )[None, :]  # [S, n] f64, exactly blockTime + i*deltaTime
    ge = ts[:, :, None] >= times[None, None, :]  # [S, n, cap]
    idx = jnp.minimum(jnp.sum(ge, axis=-1).astype(jnp.int32), n)  # [S, n]
    prev = jnp.maximum(idx - 1, 0)
    nxt = jnp.minimum(idx, cap - 1)
    has_prev = idx > 0
    has_next = idx < n

    # Event-field lookup via one-hot reductions, NOT jnp.take: capacity is
    # small, so a masked sum over it is cheap elementwise work (whether a
    # native gather is faster on a GPU is ROADMAP S3).
    k_iota = jnp.arange(cap, dtype=jnp.int32)
    oh_prev = (prev[..., None] == k_iota).astype(jnp.float32)  # [S, n, cap]
    oh_nxt = (nxt[..., None] == k_iota).astype(jnp.float32)

    def by_prev(vec):  # f32[cap] -> f32[S, n]
        return jnp.sum(oh_prev * vec, axis=-1)

    def by_nxt(vec):
        return jnp.sum(oh_nxt * vec, axis=-1)

    t0r = jnp.sum(oh_prev * rel[:, None, :], axis=-1)  # [S, n]
    t1r = jnp.sum(oh_nxt * rel[:, None, :], axis=-1)
    v0 = by_prev(values)
    v1 = by_nxt(values)
    next_is_lin = by_nxt((types == EVT_LINEAR_RAMP).astype(jnp.float32)) > 0.5
    next_is_exp = (
        by_nxt((types == EVT_EXPONENTIAL_RAMP).astype(jnp.float32)) > 0.5
    )
    prev_is_tgt = by_prev((types == EVT_SET_TARGET).astype(jnp.float32)) > 0.5

    # Linear interpolation (AudioParam.cs:219-225): u clamped to [0,1].
    denom = t1r - t0r
    safe_denom = jnp.where(denom == 0.0, 1.0, denom)
    u = jnp.clip((io[None, :] - t0r) / safe_denom, 0.0, 1.0)
    lin = v0 + (v1 - v0) * u
    if exact:
        # EXACT a-rate linear ramps in f64 (AudioParam.cs:219-225 does all
        # math in doubles, rounding once): consumers like the delay line's
        # integer truncation or the oscillator's phase integral amplify a
        # 1-ulp f32 value difference into full-sample errors. Only mul/add
        # (cheap even in f64); exponential/setTarget keep the f32 path —
        # f64 pow/exp are prohibitively slow and those curves on
        # exact-flagged params are rare (documented in PARITY.md).
        k64 = jnp.arange(cap, dtype=jnp.int32)
        ohp = (prev[..., None] == k64).astype(jnp.float64)
        ohn = (nxt[..., None] == k64).astype(jnp.float64)
        times_f = jnp.where(jnp.isfinite(times), times, 0.0)  # inf*0 = NaN
        t0a = jnp.sum(ohp * times_f, axis=-1)  # absolute f64 event times
        t1a = jnp.sum(ohn * times_f, axis=-1)
        v0a = jnp.sum(ohp * values.astype(jnp.float64), axis=-1)
        v1a = jnp.sum(ohn * values.astype(jnp.float64), axis=-1)
        den = t1a - t0a
        den = jnp.where(den == 0.0, 1.0, den)
        u64 = jnp.clip((ts - t0a) / den, 0.0, 1.0)
        lin = (v0a + (v1a - v0a) * u64).astype(jnp.float32)

    # Exponential interpolation (AudioParam.cs:227-237); falls back to
    # linear when either endpoint is <= 0.
    exp_ok = (v0 > 0.0) & (v1 > 0.0)
    safe_v0 = jnp.where(exp_ok, v0, 1.0)
    safe_v1 = jnp.where(exp_ok, v1, 1.0)
    expv = safe_v0 * jnp.power(safe_v1 / safe_v0, u)
    exp_val = jnp.where(exp_ok, expv, lin)

    # SetTarget decay from the boundary value (AudioParam.cs:239-247).
    k1_iota = jnp.arange(cap + 1, dtype=jnp.int32)
    oh_idx = (jnp.minimum(idx, cap)[..., None] == k1_iota).astype(jnp.float32)
    bl = jnp.sum(oh_idx * boundary, axis=-1)  # f32[S, n]
    elapsed = io[None, :] - t0r
    tc = jnp.maximum(by_prev(tcs.astype(jnp.float32)), 0.001)
    decay = v0 + (bl - v0) * jnp.exp(-jnp.maximum(elapsed, 0.0) / tc)
    settarget_val = jnp.where(elapsed <= 0.0, bl, decay)

    val = jnp.where(
        has_next & next_is_lin,
        lin,
        jnp.where(
            has_next & next_is_exp,
            exp_val,
            jnp.where(prev_is_tgt, settarget_val, v0),
        ),
    )
    val = jnp.where(has_prev, val, base)
    val = jnp.where(n > 0, val, base)
    return val.reshape(-1).astype(jnp.float32)


def apply_modulation(intrinsic, modulation, min_value, max_value):
    """Add an audio-rate modulation signal and clamp.

    Parity: AudioParam.ComputeARate (AudioParam.cs:124-135) — the modulation
    input's channel 0 is added to the intrinsic value, then clamped to the
    param's [min, max]. Without modulation the intrinsic value is NOT clamped
    (event values were clamped at insertion time).
    """
    return jnp.clip(intrinsic + modulation, min_value, max_value)
