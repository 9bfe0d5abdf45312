"""Real DFT as matmuls.

The partitioned convolver's 256-point transforms run as a matmul-form DFT:
a [S,128] x [128,129] contraction per superblock, batched across
quanta/voices, with no complex dtypes. Whether ``jnp.fft`` (cuFFT on a GPU)
beats these is an open measurement (ROADMAP S2).

All spectra are carried as split real/imag float32 pairs; matmuls run at
``Precision.HIGHEST`` (true float32: a lower precision, such as TF32 on a
GPU's tensor cores with its 10-bit mantissa, breaks the 1e-5 oracle budget
on DFT outputs; tests/test_precision.py enforces HIGHEST).

Parity note: replaces the reference's vendored Ooura rdft
(GraphAudio.Core/FftFlat/RealFourierTransform.cs:62-131) — forward real
transform to 129 bins and 2/N-scaled inverse.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST


def rfft_basis(n_in: int, fft_size: int):
    """DFT basis for the first ``n_in`` (nonzero) samples of an ``fft_size``
    transform. Returns (Cr, Ci): f32[n_in, fft_size//2+1]."""
    bins = fft_size // 2 + 1
    k = np.arange(n_in, dtype=np.float64)[:, None]
    b = np.arange(bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * k * b / fft_size
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def irfft_basis(fft_size: int):
    """Inverse real DFT basis. Returns (Br, Bi): f32[fft_size//2+1, fft_size]
    such that y = R @ Br + I @ Bi reconstructs the irfft."""
    bins = fft_size // 2 + 1
    b = np.arange(bins, dtype=np.float64)[:, None]
    n = np.arange(fft_size, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * b * n / fft_size
    w = np.full((bins, 1), 2.0)
    w[0] = 1.0
    if fft_size % 2 == 0:
        w[-1] = 1.0
    br = (w * np.cos(ang) / fft_size).astype(np.float32)
    bi = (-w * np.sin(ang) / fft_size).astype(np.float32)
    return br, bi


class RealDft:
    """Cached matmul-DFT for one (n_in, fft_size) geometry."""

    _cache = {}

    def __new__(cls, n_in: int, fft_size: int):
        key = (n_in, fft_size)
        inst = cls._cache.get(key)
        if inst is None:
            inst = super().__new__(cls)
            inst.n_in = n_in
            inst.fft_size = fft_size
            cr, ci = rfft_basis(n_in, fft_size)
            br, bi = irfft_basis(fft_size)
            inst._cr, inst._ci = cr, ci
            inst._br, inst._bi = br, bi
            cls._cache[key] = inst
        return inst

    def forward(self, x):
        """x: f32[..., n_in] (implicitly zero-padded to fft_size).
        Returns (R, I): f32[..., bins]."""
        cr = jnp.asarray(self._cr)
        ci = jnp.asarray(self._ci)
        r = jnp.matmul(x, cr, precision=_HIGHEST)
        i = jnp.matmul(x, ci, precision=_HIGHEST)
        return r, i

    def inverse(self, r, i):
        """Returns f32[..., fft_size]."""
        br = jnp.asarray(self._br)
        bi = jnp.asarray(self._bi)
        return jnp.matmul(r, br, precision=_HIGHEST) + jnp.matmul(
            i, bi, precision=_HIGHEST
        )

    # Packed forms: ONE matmul per direction against the concatenated
    # [real | imag] basis instead of two half-width matmuls: same MACs,
    # half the matmul launches (probe: benchmarks.probe
    # hrtf-stage-breakdown). The concatenations are of compile-time
    # constants, so XLA folds them — no runtime cost.

    def forward_packed(self, x):
        """x: f32[..., n_in] -> f32[..., 2*bins] packed [R | I]."""
        cf = jnp.concatenate(
            [jnp.asarray(self._cr), jnp.asarray(self._ci)], axis=1
        )
        return jnp.matmul(x, cf, precision=_HIGHEST)

    def inverse_packed(self, ri):
        """ri: f32[..., 2*bins] packed [R | I] -> f32[..., fft_size]."""
        bf = jnp.concatenate(
            [jnp.asarray(self._br), jnp.asarray(self._bi)], axis=0
        )
        return jnp.matmul(ri, bf, precision=_HIGHEST)


# ---- factorized (Cooley-Tukey) DFT for LARGE transforms ----------------------
#
# The matmul-DFT above is ideal at 256 points, but an N-point dense basis
# costs O(N^2) memory reads — at the superblock-sized transforms the partitioned
# convolver wants (N = 8192+) that's >100 MB per step. The classic 4-step
# factorization N = n1*n2 turns one N-point DFT into n2 DFTs of n1 (one
# batched matmul), a twiddle multiply, and n1 DFTs of n2 (another matmul):
# all matmul work with O(n1^2 + n2^2 + N) constants. Real transforms use
# the standard even/odd packing into an N/2 complex FFT plus an untangle
# pass. Everything is split re/im float32 (no complex dtypes).


def _split_factors(n: int):
    """n = n1 * n2 with both factors <= 128 where possible."""
    best = None
    f = 1
    while f * f <= n:
        if n % f == 0:
            a, b = f, n // f
            if best is None or max(a, b) < max(best):
                best = (a, b)
        f += 1
    return best


class ComplexDft:
    """Factorized complex DFT of size n (n = n1*n2), split re/im f32."""

    _cache = {}

    def __new__(cls, n: int, inverse: bool = False):
        key = (n, inverse)
        inst = cls._cache.get(key)
        if inst is not None:
            return inst
        inst = super().__new__(cls)
        inst.n = n
        n1, n2 = _split_factors(n)
        inst.n1, inst.n2 = n1, n2
        sign = 2.0 if inverse else -2.0
        k1 = np.arange(n1, dtype=np.float64)
        k2 = np.arange(n2, dtype=np.float64)
        a1 = sign * np.pi * k1[:, None] * k1[None, :] / n1
        a2 = sign * np.pi * k2[:, None] * k2[None, :] / n2
        inst._w1r = np.cos(a1).astype(np.float32)
        inst._w1i = np.sin(a1).astype(np.float32)
        inst._w2r = np.cos(a2).astype(np.float32)
        inst._w2i = np.sin(a2).astype(np.float32)
        tw = sign * np.pi * k1[:, None] * k2[None, :] / n
        inst._twr = np.cos(tw).astype(np.float32)
        inst._twi = np.sin(tw).astype(np.float32)
        # Augmented-real stage bases: a complex contraction C = A @ W equals
        # ONE real matmul [Ar | Ai] @ [[Wr, Wi], [-Wi, Wr]] — same MACs as
        # the 4-real-matmul form but 1/4 the op count and a full 2*n-wide
        # contraction. At the convolver's batch-1 superblock transforms the
        # op count, not the FLOPs, sets the cost.
        inst._w1a = np.block(
            [[inst._w1r, inst._w1i], [-inst._w1i, inst._w1r]]
        ).astype(np.float32)
        inst._w2a = np.block(
            [[inst._w2r, inst._w2i], [-inst._w2i, inst._w2r]]
        ).astype(np.float32)
        inst._inverse = inverse
        cls._cache[key] = inst
        return inst

    def __call__(self, xr, xi):
        """xr, xi: f32[..., n] -> (Xr, Xi) f32[..., n].

        Decimation-in-time over the n2 axis: x[j1*n2 + j2]; output index
        k = k2*n1 + k1.
        """
        n1, n2 = self.n1, self.n2
        lead = xr.shape[:-1]
        xr = xr.reshape(lead + (n1, n2))
        xi = xi.reshape(lead + (n1, n2))
        w1a = jnp.asarray(self._w1a)
        w2a = jnp.asarray(self._w2a)
        twr = jnp.asarray(self._twr)
        twi = jnp.asarray(self._twi)

        # Stage 1: DFT over the j1 axis (length n1) for each j2 column —
        # j1 transposed last, re/im packed, ONE augmented-real matmul
        # (w1 is symmetric, so the contraction-side transpose is free).
        p = jnp.concatenate(
            [jnp.swapaxes(xr, -1, -2), jnp.swapaxes(xi, -1, -2)], axis=-1
        )  # [.., n2, 2*n1]
        y = jnp.matmul(p, w1a, precision=_HIGHEST)
        yr = jnp.swapaxes(y[..., :n1], -1, -2)  # [.., n1, n2]
        yi = jnp.swapaxes(y[..., n1:], -1, -2)
        # Twiddle: * exp(sign*2pi*i*k1*j2/n)
        zr = yr * twr - yi * twi
        zi = yr * twi + yi * twr
        # Stage 2: DFT over the j2 axis (length n2) for each k1 row.
        q = jnp.concatenate([zr, zi], axis=-1)  # [.., n1, 2*n2]
        v = jnp.matmul(q, w2a, precision=_HIGHEST)
        # Output layout: [k1, k2] -> flat index k2*n1 + k1.
        out_r = jnp.swapaxes(v[..., :n2], -1, -2).reshape(lead + (self.n,))
        out_i = jnp.swapaxes(v[..., n2:], -1, -2).reshape(lead + (self.n,))
        if self._inverse:
            out_r = out_r / self.n
            out_i = out_i / self.n
        return out_r, out_i


class BigRealDft:
    """Real DFT of size N (N = 2*block, even) via an N/2 complex FFT.

    forward(x[..., n_in]) -> (R, I) f32[..., N/2+1]  (x zero-padded to N)
    inverse(R, I) -> f32[..., N]
    """

    _cache = {}

    def __new__(cls, n_in: int, fft_size: int):
        key = (n_in, fft_size)
        inst = cls._cache.get(key)
        if inst is not None:
            return inst
        assert fft_size % 2 == 0
        inst = super().__new__(cls)
        inst.n_in = n_in
        inst.N = fft_size
        h = fft_size // 2
        inst.h = h
        k = np.arange(h + 1, dtype=np.float64)
        a = -2.0 * np.pi * k / fft_size
        inst._er = np.cos(a).astype(np.float32)
        inst._ei = np.sin(a).astype(np.float32)
        cls._cache[key] = inst
        return inst

    def forward(self, x):
        h, N = self.h, self.N
        lead = x.shape[:-1]
        pad = 2 * h - x.shape[-1]
        if pad > 0:
            x = jnp.concatenate(
                [x, jnp.zeros(lead + (pad,), x.dtype)], axis=-1
            )
        z = x.reshape(lead + (h, 2))
        zr, zi = z[..., 0], z[..., 1]  # pack even/odd
        Zr, Zi = ComplexDft(h)(zr, zi)
        # Untangle: X[k] = (Z[k]+conj(Z[h-k]))/2 - i/2 e^{-2pi ik/N}(Z[k]-conj(Z[h-k]))
        # Z[(-k) % h] for k=0..h is [Z0, Z_{h-1}, .., Z_1, Z0]: a flip plus
        # two 1-wide concats. jnp.flip lowers to a plain reverse, where the
        # equivalent general `take` lowers to a gather (probe:
        # benchmarks.probe conv-dft-chain; the flip variant is bit-exact).
        Zkr = jnp.concatenate([Zr, Zr[..., :1]], axis=-1)
        Zki = jnp.concatenate([Zi, Zi[..., :1]], axis=-1)
        Zmr = jnp.concatenate(
            [Zr[..., :1], jnp.flip(Zr[..., 1:], axis=-1), Zr[..., :1]], axis=-1)
        Zmi = jnp.concatenate(
            [Zi[..., :1], jnp.flip(Zi[..., 1:], axis=-1), Zi[..., :1]], axis=-1)
        ar = 0.5 * (Zkr + Zmr)
        ai = 0.5 * (Zki - Zmi)
        br = 0.5 * (Zki + Zmi)
        bi = -0.5 * (Zkr - Zmr)
        er = jnp.asarray(self._er)
        ei = jnp.asarray(self._ei)
        Xr = ar + br * er - bi * ei
        Xi = ai + br * ei + bi * er
        return Xr, Xi

    def inverse(self, R, I):
        """Inverse real DFT: (R, I) f32[..., N/2+1] -> f32[..., N]."""
        h, N = self.h, self.N
        er = jnp.asarray(self._er)
        ei = jnp.asarray(self._ei)
        # Repack into the h-point complex spectrum of the packed signal:
        # Z[k] = A[k] + i e^{+2pi ik/N} B[k],  A = (X[k]+conj(X[h-k]))/2, ...
        # X[h-k] for k in [0, h) is [X_h, X_{h-1}, .., X_1]: a pure flip of
        # the tail (same reverse-beats-gather note as forward()).
        Rk, Ik = R[..., :h], I[..., :h]
        Rm = jnp.flip(R[..., 1:], axis=-1)
        Im = jnp.flip(I[..., 1:], axis=-1)
        # Z[k] = A + i D e^{+2pi ik/N}, A = (X[k]+conj(X[h-k]))/2,
        # D = (X[k]-conj(X[h-k]))/2 (verified against the packed fft).
        ar = 0.5 * (Rk + Rm)
        ai = 0.5 * (Ik - Im)
        dr = 0.5 * (Rk - Rm)
        di = 0.5 * (Ik + Im)
        # stored (er, ei) has angle -2pi k/N; e^{+} = (er, -ei)
        err_ = jnp.asarray(self._er)[..., :h]
        eii_ = jnp.asarray(self._ei)[..., :h]
        Zr = ar - (di * err_ - dr * eii_)
        Zi = ai + (dr * err_ + di * eii_)
        zr, zi = ComplexDft(h, inverse=True)(Zr, Zi)
        lead = zr.shape[:-1]
        out = jnp.stack([zr, zi], axis=-1).reshape(lead + (N,))
        return out
