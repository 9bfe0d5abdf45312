"""Biquad IIR filtering: RBJ coefficients + parallel linear scan.

The reference runs a per-sample transposed direct-form II recurrence
(GraphAudio.Core/Nodes/BiQuadFilterNode.cs:136-141):

    w  = x - a1*w1 - a2*w2
    y  = b0*w + b1*w1 + b2*w2
    w2 = w1; w1 = w

A sequential per-sample loop leaves a wide device idle; the two-tap state makes this a
linear recurrence s_t = A_t s_{t-1} + u_t with 2x2 companion matrices

    A_t = [[-a1_t, -a2_t], [1, 0]],   u_t = [x_t, 0],   s_t = [w_t, w_{t-1}]

solved in log2(T) passes with ``lax.associative_scan`` over affine pairs —
fully vectorized across channels (and across batched voices when vmapped).

Coefficients follow the RBJ cookbook formulas verbatim from
BiQuadFilterNode.UpdateCoefficients (:149-258), evaluated per sample from the
a-rate frequency/Q params (the reference's recompute-on-threshold cache,
:126-134, is a CPU optimization — computing every sample is strictly more
accurate and cheap elementwise work).
"""

from __future__ import annotations

import jax
import math
import jax.numpy as jnp

FILTER_TYPES = (
    "lowpass",
    "highpass",
    "bandpass",
    "notch",
    "allpass",
    "peaking",
    "lowshelf",
    "highshelf",
)


def rbj_coefficients(filter_type: str, freq, q, gain_db, sample_rate: float):
    """Normalized biquad coefficients (b0, b1, b2, a1, a2), each f32[T].

    Parity: BiQuadFilterNode.UpdateCoefficients (:149-258), float32 math.
    """
    f = freq.astype(jnp.float32)
    q = q.astype(jnp.float32)
    g = jnp.asarray(gain_db, jnp.float32)
    w0 = jnp.float32(2.0 * jnp.pi) * f / jnp.float32(sample_rate)
    cosw = jnp.cos(w0)
    sinw = jnp.sin(w0)
    alpha = sinw / (2.0 * q)

    if filter_type == "lowpass":
        b0 = (1.0 - cosw) / 2.0
        b1 = 1.0 - cosw
        b2 = (1.0 - cosw) / 2.0
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "highpass":
        b0 = (1.0 + cosw) / 2.0
        b1 = -(1.0 + cosw)
        b2 = (1.0 + cosw) / 2.0
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "bandpass":
        b0 = alpha
        b1 = jnp.zeros_like(alpha)
        b2 = -alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "notch":
        b0 = jnp.ones_like(alpha)
        b1 = -2.0 * cosw
        b2 = jnp.ones_like(alpha)
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "allpass":
        b0 = 1.0 - alpha
        b1 = -2.0 * cosw
        b2 = 1.0 + alpha
        a0 = 1.0 + alpha
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha
    elif filter_type == "peaking":
        A = jnp.power(jnp.float32(10.0), g / 40.0)
        b0 = 1.0 + alpha * A
        b1 = -2.0 * cosw
        b2 = 1.0 - alpha * A
        a0 = 1.0 + alpha / A
        a1 = -2.0 * cosw
        a2 = 1.0 - alpha / A
    elif filter_type == "lowshelf":
        A = jnp.power(jnp.float32(10.0), g / 40.0)
        beta = jnp.sqrt(A) / q
        b0 = A * ((A + 1.0) - (A - 1.0) * cosw + beta * sinw)
        b1 = 2.0 * A * ((A - 1.0) - (A + 1.0) * cosw)
        b2 = A * ((A + 1.0) - (A - 1.0) * cosw - beta * sinw)
        a0 = (A + 1.0) + (A - 1.0) * cosw + beta * sinw
        a1 = -2.0 * ((A - 1.0) + (A + 1.0) * cosw)
        a2 = (A + 1.0) + (A - 1.0) * cosw - beta * sinw
    elif filter_type == "highshelf":
        A = jnp.power(jnp.float32(10.0), g / 40.0)
        beta = jnp.sqrt(A) / q
        b0 = A * ((A + 1.0) + (A - 1.0) * cosw + beta * sinw)
        b1 = -2.0 * A * ((A - 1.0) + (A + 1.0) * cosw)
        b2 = A * ((A + 1.0) + (A - 1.0) * cosw - beta * sinw)
        a0 = (A + 1.0) - (A - 1.0) * cosw + beta * sinw
        a1 = 2.0 * ((A - 1.0) - (A + 1.0) * cosw)
        a2 = (A + 1.0) - (A - 1.0) * cosw - beta * sinw
    else:
        raise ValueError(f"unknown filter type {filter_type!r}")

    inv_a0 = 1.0 / a0
    return (b0 * inv_a0, b1 * inv_a0, b2 * inv_a0, a1 * inv_a0, a2 * inv_a0)


#: index order of the one-hot type selector (matches FilterType declaration)
FILTER_TYPES = (
    "lowpass", "highpass", "bandpass", "notch",
    "allpass", "peaking", "lowshelf", "highshelf",
)


def rbj_coefficients_dyn(type_onehot, freq, q, gain_db, sample_rate: float):
    """RBJ coefficients with the filter type as DATA: all eight variants
    are computed and the one-hot selects via a pure jnp.where chain —
    bit-identical to the static branch for the selected type (selection,
    no arithmetic). This lets biquads of DIFFERENT types share one vmapped
    kernel, so mixed-type serial EQ cascades chain-fuse into a single
    software-pipelined stage (graph.py _fuse_chains) instead of one
    sequential kernel per type. The 8x coefficient math is elementwise
    work, small next to the recurrence solve it unblocks fusing.

    type_onehot: f32[8] per FILTER_TYPES order.
    """
    out = rbj_coefficients(FILTER_TYPES[0], freq, q, gain_db, sample_rate)
    for k in range(1, len(FILTER_TYPES)):
        sel = type_onehot[k] > 0.5
        cand = rbj_coefficients(
            FILTER_TYPES[k], freq, q, gain_db, sample_rate
        )
        out = tuple(jnp.where(sel, n, o) for o, n in zip(out, cand))
    return out


def _first_order_scan(p, u, s_init):
    """Solve s_t = p_t * s_{t-1} + u_t in parallel (complex64).

    p: c64[T] (broadcast over channels), u: c64[C, T], s_init: c64[C].
    Returns s: c64[C, T]. The operator is a scalar multiply with |p| <= 1 for
    stable filters — a *normal* operator, so the parallel scan is perfectly
    conditioned (unlike companion-matrix products, whose ~Q^2 transient growth
    amplifies f32 rounding catastrophically for high-Q resonators).

    Layout: TWO-LEVEL scan with time tiled onto the 128-lane axis — a flat
    scan over [C, T] pays 2*log2(T) passes over the FULL sequence (traffic-
    bound once T >= 4096); tiling to [C, S, 128] pays 2*log2(128) full-
    sequence passes plus a scan over the tiny [C, S] block-total operators,
    ~4x less memory traffic at T = 16384. With few samples per superblock
    the extra level only adds dispatches; at the large superblocks config 3
    runs at, it saves traffic.

    A per-lane sequential kernel (128 literal recurrence steps per block,
    state in registers) is the alternative to the inner level's
    2*log2(128) passes; it is to be timed against this scan on the GPU
    (ROADMAP S4).
    """
    C, T = u.shape
    B = 128 if T % 128 == 0 and T > 128 else T
    S = T // B
    pc = jnp.broadcast_to(p[None, :], (C, T)).reshape(C, S, B)
    u3 = u.reshape(C, S, B)
    cp, cb = _hs_prefix(pc, u3, axis=2)
    if S == 1:
        return (cp * s_init[:, None, None] + cb).reshape(C, T)
    # Block-total affine ops -> tiny scan over the superblock axis.
    bp, bb = _hs_prefix(cp[:, :, -1], cb[:, :, -1], axis=1)
    # [C, S]: state at each block's END given s_init
    carry = jnp.concatenate(
        [s_init[:, None], bp[:, :-1] * s_init[:, None] + bb[:, :-1]], axis=1
    )  # [C, S] carry INTO each block
    return (cp * carry[:, :, None] + cb).reshape(C, T)


def _hs_prefix(p, b, axis):
    """Inclusive prefix composition of affine ops (p, b) by Hillis-Steele
    shift-and-combine doubling: log2(n) rounds, each ONE fused
    shift+multiply-add over the whole array.

    lax.associative_scan's work-efficient decomposition lowers to ~3x the
    kernel count per round (odd/even slicing, interleaving); where passes
    are latency-bound the round COUNT is the cost, so the doubling form
    trades O(T log T) extra multiply-adds for one fused pass per round
    (probe: benchmarks.probe biquad-scan-rounds). Same recurrence algebra,
    f32 products in a different association order (relerr ~6e-7 vs the
    scan — well inside the 1e-5 parity budget)."""
    n = p.shape[axis]
    k = 1
    while k < n:
        pad = [(0, 0)] * p.ndim
        pad[axis] = (k, 0)
        sl = [slice(None)] * p.ndim
        sl[axis] = slice(0, n - k)
        ps = jnp.pad(p[tuple(sl)], pad, constant_values=1.0)
        bs = jnp.pad(b[tuple(sl)], pad, constant_values=0.0)
        # compose: (shifted earlier prefix) then (current): s = p*(ps*s+bs)+b
        p, b = p * ps, p * bs + b
        k *= 2
    return p, b


def _pair_scan(p1, p2, x, v_init, w_init):
    """Solve the CASCADE  v_t = p1_t v_{t-1} + x_t ;  w_t = p2_t w_{t-1} + v_t
    with ONE associative scan over triangular 2x2 affine operators.

    Each step is [v,w] <- [[p1,0],[p1,p2]]@[v,w] + [x,x]; products of
    triangular operators stay triangular, so the scan carries 5 sequences
    (a,b,d = matrix, e,f = offset), halving the scan PASSES vs two chained
    scalar scans at ~1.75x the per-pass work.

    Kept for cross-validation: where the scans are work-bound, not
    launch-bound (T >= 4096), fewer but fatter passes lose, so the
    production path keeps the two scalar scans.

    Conditioning: unlike the companion-matrix form (whose entries grow ~Q^2
    with heavy cancellation), the triangular factorization keeps the
    diagonal as pole products (|.| <= 1) and the off-diagonal as the
    physical v->w resonant transfer — every carried quantity is bounded by
    a real transfer gain, so f32 relative error stays ~eps*sqrt(log T).
    Agreement with the chained scalar scans is ~1e-7 relative (tested).

    p1, p2: c64[T]; x: c64[C,T]. Returns (v, w) c64[C,T].
    """
    a = p1[None, :]
    b = p1[None, :]
    d = p2[None, :]
    e = x
    f = x

    def comb(lhs, rhs):
        a1, b1, d1, e1, f1 = lhs
        a2, b2, d2, e2, f2 = rhs
        return (
            a2 * a1,
            b2 * a1 + d2 * b1,
            d2 * d1,
            a2 * e1 + e2,
            b2 * e1 + d2 * f1 + f2,
        )

    a, b, d, e, f = jax.lax.associative_scan(comb, (a, b, d, e, f), axis=1)
    v = a * v_init[:, None] + e
    w = b * v_init[:, None] + d * w_init[:, None] + f
    return v, w


def _make_first_order_matmul(p):
    """Build the blocked-matmul solver for s_t = p_t s_{t-1} + u_t (exact,
    TIME-VARYING poles) and return ``solve(u, s_init) -> s``.

    The associative scan solves this in 2*log2(T) launch-bound passes of tiny
    elementwise work; a 4-biquad cascade pays 16 of them per step. This
    form replaces each solve with a handful of matmuls whose kernels depend
    only on the POLES:

      within block b (128 samples):  s_n = sum_{k<=n} K_b[n,k] u_k + A_b[n] c_b
        with  K_b[n,k] = prod_{k<sigma<=n} p_sigma = exp(L_n - L_k) (log-polar),
      across blocks:  c_b = sum_{j<b} W[b,j] t_j + (prod_{i<b} G_i) s_init,
        W[b,j] = prod_{j<i<b} G_i,  G_i = block-total pole product,
        t_j = within-block tail — the SAME exp-of-cumsum-differences trick
        one level up, so no sequential dependency survives anywhere.

    Numerics: log-magnitude/phase cumulate in f64 (tiny [T] tensors) and
    difference before casting to f32, so every kernel entry is exp/cos/sin of
    a SMALL argument; magnitudes clamp at exp(0) (stable filters) and logs at
    -18 (taps below 1.5e-8 of their input cannot affect f32 audio). Matmuls
    run at HIGHEST precision. Agreement with the associative scan is ~1e-6
    relative (vs the ~1e-7 of exact f32 products) — inside the 1e-5 parity
    budget.

    Separating the build from the solve lets the correction pass (same poles,
    corrected input) reuse the kernel matrices for free.
    """
    (T,) = p.shape
    B = 128
    S = T // B
    two_pi = 2.0 * math.pi
    hp = jax.lax.Precision.HIGHEST

    pr, pi_ = jnp.real(p), jnp.imag(p)
    r2 = pr * pr + pi_ * pi_
    logr = jnp.maximum(0.5 * jnp.log(jnp.maximum(r2, 1e-36)), -18.0)
    th = jnp.arctan2(pi_, pr)

    Lc = jnp.cumsum(logr.astype(jnp.float64)).reshape(S, B)
    Tc = jnp.cumsum(th.astype(jnp.float64)).reshape(S, B)
    anchorL = jnp.concatenate([jnp.zeros((1,), jnp.float64), Lc[:-1, -1]])
    anchorT = jnp.concatenate([jnp.zeros((1,), jnp.float64), Tc[:-1, -1]])
    Lb = (Lc - anchorL[:, None]).astype(jnp.float32)  # [S,B] local inclusive
    thm = jnp.mod(Tc, two_pi).astype(jnp.float32)  # cos/sin are mod-invariant
    anchorTm = jnp.mod(anchorT, two_pi).astype(jnp.float32)

    # Within-block kernel K[s,n,k] (lower-triangular; diagonal = 1).
    dL = jnp.minimum(Lb[:, :, None] - Lb[:, None, :], 0.0)
    n_iota = jnp.arange(B, dtype=jnp.int32)
    mask = (n_iota[:, None] >= n_iota[None, :]).astype(jnp.float32)
    mag = jnp.exp(dL) * mask
    dTh = thm[:, :, None] - thm[:, None, :]
    Kr = mag * jnp.cos(dTh)
    Ki = mag * jnp.sin(dTh)

    # Block-level carry solve pieces.
    g64 = Lc[:, -1]  # [S] global cumulative log-magnitude at block ends
    t64 = Tc[:, -1]
    gprev = jnp.concatenate([jnp.zeros((1,), jnp.float64), g64[:-1]])
    tprev_m = jnp.mod(
        jnp.concatenate([jnp.zeros((1,), jnp.float64), t64[:-1]]), two_pi
    ).astype(jnp.float32)
    t64_m = jnp.mod(t64, two_pi).astype(jnp.float32)
    s_iota = jnp.arange(S, dtype=jnp.int32)
    maskW = (s_iota[:, None] - 1 >= s_iota[None, :]).astype(jnp.float32)
    dW = jnp.minimum(gprev[:, None] - g64[None, :], 0.0).astype(jnp.float32)
    magW = jnp.exp(dW) * maskW
    dPw = tprev_m[:, None] - t64_m[None, :]
    Wr = magW * jnp.cos(dPw)
    Wi = magW * jnp.sin(dPw)
    init_mag = jnp.exp(jnp.minimum(gprev, 0.0).astype(jnp.float32))  # [S]
    inr = init_mag * jnp.cos(tprev_m)
    ini = init_mag * jnp.sin(tprev_m)

    # Pole powers from block start (carry propagation into the block).
    Am = jnp.exp(jnp.minimum(Lb, 0.0))
    dPa = thm - anchorTm[:, None]
    Ar = Am * jnp.cos(dPa)
    Ai = Am * jnp.sin(dPa)

    def solve(u, s_init):
        C = u.shape[0]
        ub = u.reshape(C, S, B)
        ur, ui = jnp.real(ub), jnp.imag(ub)

        def km(Kc, v):
            return jnp.einsum("snk,csk->csn", Kc, v, precision=hp)

        sr = km(Kr, ur) - km(Ki, ui)
        si = km(Kr, ui) + km(Ki, ur)
        tr, ti = sr[:, :, -1], si[:, :, -1]  # [C,S] block tails sans carry

        def wm(Wc, v):
            return jnp.einsum("sj,cj->cs", Wc, v, precision=hp)

        cr = wm(Wr, tr) - wm(Wi, ti)
        ci = wm(Wr, ti) + wm(Wi, tr)
        s0r, s0i = jnp.real(s_init)[:, None], jnp.imag(s_init)[:, None]
        cr = cr + inr[None, :] * s0r - ini[None, :] * s0i
        ci = ci + inr[None, :] * s0i + ini[None, :] * s0r
        outr = sr + Ar[None] * cr[..., None] - Ai[None] * ci[..., None]
        outi = si + Ar[None] * ci[..., None] + Ai[None] * cr[..., None]
        return jax.lax.complex(outr, outi).reshape(C, -1)

    return solve


def _first_order_const(p, u, s_init):
    """``_first_order_scan`` for a CONSTANT (traced c64 scalar) operator.

    s_t = p * s_{t-1} + u_t has the closed form
        s_t = p^(t+1) s_init + sum_{k<=t} p^(t-k) u_k
    so each 128-sample block is one matmul against a decay matrix built at
    runtime from the scalar pole (p^d = |p|^d e^{i d arg p}, elementwise over
    a static delta grid), and the block-to-block carry is a second tiny
    matmul over the superblock axis. Replaces the log-depth associative scan
    on the constant-coefficient path: less compile-time program, pure
    matmul work at run time. Exact to f32 rounding.

    p: c64 scalar, u: c64[C, T], s_init: c64[C] -> s: c64[C, T].
    """
    C, T = u.shape
    B = 128
    S = T // B
    logr = 0.5 * jnp.log(jnp.maximum(jnp.real(p) ** 2 + jnp.imag(p) ** 2, 1e-38))
    th = jnp.arctan2(jnp.imag(p), jnp.real(p))

    def pole_pow(d, mask, lr, t):
        """(re, im) of p^d * mask for an integer grid d (f32 arrays)."""
        mag = jnp.exp(d * lr) * mask
        return mag * jnp.cos(d * t), mag * jnp.sin(d * t)

    hp = jax.lax.Precision.HIGHEST

    def cmatmul(spec, ar, ai, br, bi):
        rr = jnp.einsum(spec, ar, br, precision=hp) - jnp.einsum(
            spec, ai, bi, precision=hp
        )
        ri = jnp.einsum(spec, ar, bi, precision=hp) + jnp.einsum(
            spec, ai, br, precision=hp
        )
        return rr, ri

    n = jnp.arange(B, dtype=jnp.float32)
    d = n[:, None] - n[None, :]
    Mr, Mi = pole_pow(jnp.maximum(d, 0.0), (d >= 0).astype(jnp.float32), logr, th)
    ub = u.reshape(C, S, B)
    pr, pi = cmatmul("nk,csk->csn", Mr, Mi, jnp.real(ub), jnp.imag(ub))
    last_r, last_i = pr[:, :, -1], pi[:, :, -1]  # [C, S] block tails sans carry

    b = jnp.arange(S, dtype=jnp.float32)
    e = b[:, None] - 1.0 - b[None, :]
    lr128, th128 = B * logr, B * th
    Wr, Wi = pole_pow(jnp.maximum(e, 0.0), (e >= 0).astype(jnp.float32), lr128, th128)
    tr, ti = cmatmul("bj,cj->cb", Wr, Wi, last_r, last_i)
    powr, powi = pole_pow(b, jnp.float32(1.0), lr128, th128)  # (p^128)^b
    s0r, s0i = jnp.real(s_init)[:, None], jnp.imag(s_init)[:, None]
    cr = powr[None, :] * s0r - powi[None, :] * s0i + tr  # [C, S]
    ci = powr[None, :] * s0i + powi[None, :] * s0r + ti
    ar, ai = pole_pow(n + 1.0, jnp.float32(1.0), logr, th)  # p^(n+1)
    sr = pr + ar[None, None, :] * cr[:, :, None] - ai[None, None, :] * ci[:, :, None]
    si = pi + ar[None, None, :] * ci[:, :, None] + ai[None, None, :] * cr[:, :, None]
    return jax.lax.complex(sr, si).reshape(C, T)


def biquad_apply(x, coeffs, w1, w2, time_varying: bool = False,
                 constant: bool = False, tv_method: str = "scan"):
    """Filter [C, T] samples through a (possibly time-varying) biquad.

    Args:
      x: f32[C, T] input.
      coeffs: (b0, b1, b2, a1, a2), each f32[T] (broadcast across channels,
        like the reference where coefficients are channel-independent).
      w1, w2: f32[C] carried filter state (transposed DF2: w_{-1}, w_{-2}).
      time_varying: compile the correction pass for automated coefficients.
      constant: caller guarantees the coefficients are the same at every
        sample; replaces the associative scans with the blocked-matmul
        closed form (_first_order_const) — exact, and much cheaper to
        compile and run. Mutually exclusive with ``time_varying``.
      tv_method: "scan" (default) uses the associative scans; "matmul"
        solves the time-varying recurrences with blocked kernel matmuls
        built once from the poles and shared with the correction pass
        (_make_first_order_matmul). Its f64 cumsums and per-solve matmul
        launches cost more than the scan's log-depth passes at large T,
        and the scan's step cost is nearly independent of T, so larger
        superblocks amortize it; kept for cross-validation and for small-T
        regimes (e.g. realtime superblocks) where the block count is tiny.

    Returns (y f32[C, T], new_w1 f32[C], new_w2 f32[C]).

    Method: factor the denominator 1 + a1 z^-1 + a2 z^-2 into complex poles
    p1, p2 and run two first-order complex parallel scans in cascade:

        v_t = p1_t v_{t-1} + x_t
        w_t = p2_t w_{t-1} + v_t

    Each scan's operator is a scalar with |p| <= 1 (normal), so the parallel
    scan is perfectly conditioned — unlike a companion-matrix scan whose ~Q^2
    transient growth destroys f32 precision for high-Q resonators.

    Composition yields w_t = -(p1_t+p2_t) w_{t-1} - p1_t p2_{t-1} w_{t-2} + x_t:
    exact for constant coefficients; for time-varying ones the a2 term lags one
    sample in p2. With ``time_varying`` a second fixed-point pass injects the
    correction  -p1_t (p2_t - p2_{t-1}) w_{t-2}  computed from the first pass,
    leaving an O(dp^2) residual (negligible for any audio-rate automation).
    """
    b0, b1, b2, a1, a2 = coeffs
    C, T = x.shape

    a1c = a1.astype(jnp.complex64)
    a2c = a2.astype(jnp.complex64)
    disc = jnp.sqrt(a1c * a1c - 4.0 * a2c)
    p1 = 0.5 * (-a1c + disc)  # [T]
    p2 = 0.5 * (-a1c - disc)

    xt = x.astype(jnp.complex64)  # [C, T] — time on the lane axis

    # Initial conditions: w_{-1} = W1, w_{-2} = W2; v_{-1} = W1 - p2_0 * W2.
    w_init = w1.astype(jnp.complex64)
    v_init = w_init - p2[0] * w2.astype(jnp.complex64)

    if not constant and tv_method == "matmul":
        solve1 = _make_first_order_matmul(p1)
        solve2 = _make_first_order_matmul(p2)
    else:
        solve1 = solve2 = None

    def run(inp):
        if constant:
            # Constant poles: blocked-matmul closed form (exact), far
            # cheaper to compile and run than the associative scans.
            v = _first_order_const(p1[0], inp, v_init)
            w = _first_order_const(p2[0], v, w_init)
        elif solve1 is not None:
            v = solve1(inp, v_init)  # [C, T]
            w = solve2(v, w_init)
        else:
            v = _first_order_scan(p1, inp, v_init)  # [C, T]
            w = _first_order_scan(p2, v, w_init)  # [C, T]
        w_t = jnp.real(w)
        w_tm1 = jnp.concatenate(
            [jnp.broadcast_to(w1[:, None], (C, 1)), w_t[:, :-1]], axis=1
        )
        w_tm2 = jnp.concatenate(
            [jnp.broadcast_to(w2[:, None], (C, 1)), w_tm1[:, :-1]], axis=1
        )
        return w_t, w_tm1, w_tm2

    w_t, w_tm1, w_tm2 = run(xt)

    if time_varying:
        # p2 at the previous sample (p2_{-1} := p2_0 -> zero correction at t=0).
        p2_prev = jnp.concatenate([p2[:1], p2[:-1]])
        corr = -(p1 * (p2 - p2_prev))[None, :] * w_tm2.astype(jnp.complex64)
        w_t, w_tm1, w_tm2 = run(xt + corr)

    y = b0[None, :] * w_t + b1[None, :] * w_tm1 + b2[None, :] * w_tm2
    return y, w_t[:, -1], w_tm1[:, -1]
