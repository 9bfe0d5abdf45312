"""Binaural HRTF rendering without Steam Audio.

The reference spatializes via the closed-source phonon library
(GraphAudio.SteamAudio/Nodes/SpatialPannerNode.cs:250-260: HRTF render with
bilinear interpolation + SpatialBlend crossfade). Here we replace the
measured HRTF with an analytic **spherical-head model** (Brown & Duda '98):

  * ITD: Woodworth's formula  tau(theta) = (a/c) * (theta + sin theta)
    baked into each HRIR as a fractional delay;
  * ILD / head shadow: the one-pole/one-zero spherical-head shadow filter
    H(w) = (1 + j alpha w / (2 w0)) / (1 + j w / (2 w0)),  w0 = c/a,
    with alpha(theta) interpolating [alpha_min, 2] by incidence angle;
  * a raised-cosine pinna-less elevation attenuation.

HRIRs are precomputed on an (elevation x azimuth) grid (host numpy), and at
render time the 4 neighbouring HRIRs are bilinearly interpolated per render
quantum (k-rate, matching the reference's per-block params) and applied as a
per-block FIR via batched matmuls.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK

SPEED_OF_SOUND = 343.0
HEAD_RADIUS = 0.0875

HRIR_LENGTH = 64
N_AZIMUTH = 24  # full circle, 15 degree steps
N_ELEVATION = 7  # -90..90, 30 degree steps

_HIGHEST = jax.lax.Precision.HIGHEST


def _sphere_shadow_ir(theta_inc: float, sample_rate: int, length: int) -> np.ndarray:
    """Impulse response of the Brown-Duda spherical head-shadow filter for a
    source at incidence angle ``theta_inc`` from the ear axis (radians)."""
    w0 = SPEED_OF_SOUND / HEAD_RADIUS  # rad/s
    alpha_min = 0.1
    theta_min = np.deg2rad(150.0)
    alpha = (1.0 + alpha_min / 2.0) + (1.0 - alpha_min / 2.0) * np.cos(
        theta_inc / theta_min * np.pi
    )
    # Bilinear transform of H(s) = (alpha s + w0) / (s + w0).
    fs = float(sample_rate)
    k = 2.0 * fs
    b0 = (alpha * k + w0) / (k + w0)
    b1 = (w0 - alpha * k) / (k + w0)
    a1 = (w0 - k) / (k + w0)
    # IIR -> truncated IR.
    ir = np.zeros(length)
    x = np.zeros(length)
    x[0] = 1.0
    y1 = 0.0
    x1 = 0.0
    for n in range(length):
        y = b0 * x[n] + b1 * x1 - a1 * y1
        ir[n] = y
        x1 = x[n]
        y1 = y
    return ir


def _fractional_delay(ir: np.ndarray, delay: float, length: int) -> np.ndarray:
    """Apply a (possibly fractional) delay with linear interpolation."""
    out = np.zeros(length)
    d_int = int(np.floor(delay))
    frac = delay - d_int
    for n in range(length):
        src = n - d_int
        if 0 <= src < length:
            out[n] += ir[src] * (1.0 - frac)
        if 0 <= src - 1 < length:
            out[n] += ir[src - 1] * frac
    return out


def build_hrir_grid(sample_rate: int,
                    n_azimuth: int = N_AZIMUTH,
                    n_elevation: int = N_ELEVATION,
                    length: int = HRIR_LENGTH) -> np.ndarray:
    """Precompute the HRIR grid: f32[n_elevation, n_azimuth, 2, length].

    Grid coordinates: azimuth in [0, 2pi) measured clockwise from straight
    ahead toward the right ear; elevation in [-pi/2, pi/2].
    """
    grid = np.zeros((n_elevation, n_azimuth, 2, length), np.float32)
    a_c = HEAD_RADIUS / SPEED_OF_SOUND
    # Headroom for the near ear's negative ITD lead (up to a/c seconds).
    base_delay = float(np.ceil(a_c * sample_rate)) + 2.0
    for ei in range(n_elevation):
        el = -np.pi / 2 + np.pi * ei / (n_elevation - 1)
        for ai in range(n_azimuth):
            az = 2 * np.pi * ai / n_azimuth
            # Unit direction: x right, y up, z ahead.
            x = np.cos(el) * np.sin(az)
            y = np.sin(el)
            z = np.cos(el) * np.cos(az)
            for ear, ear_x in ((0, -1.0), (1, 1.0)):  # 0 = left, 1 = right
                # Incidence angle between direction and this ear's axis.
                cos_inc = np.clip(ear_x * x, -1.0, 1.0)
                theta_inc = np.arccos(cos_inc)
                # Woodworth ITD relative to head centre.
                if theta_inc <= np.pi / 2:
                    tau = -a_c * np.cos(theta_inc)
                else:
                    tau = a_c * (theta_inc - np.pi / 2)
                delay = base_delay + tau * sample_rate
                ir = _sphere_shadow_ir(theta_inc, sample_rate, length)
                # Pinna elevation cue (Spagnol/Satarzadeh-style structural
                # approximation): one negative concha reflection whose delay
                # shrinks as the source rises, sweeping the first pinna
                # notch from ~6 kHz (below) to ~11 kHz (above) — the
                # dominant monaural elevation cue a bare spherical head
                # lacks. Applied per ear before the ITD delay.
                notch_hz = 6000.0 + 5000.0 * (el + np.pi / 2) / np.pi
                tau_pinna = sample_rate / (2.0 * notch_hz)  # samples
                # positive reflection -> comb nulls at odd multiples of
                # 1/(2*tau); normalized to unity DC gain
                rho = 0.4 * np.cos(el)
                ir = (ir + rho * _fractional_delay(ir, tau_pinna, length)) \
                    / (1.0 + rho)
                # Gentle elevation rolloff stands in for torso shadowing.
                elev_gain = 1.0 - 0.15 * (1.0 - np.cos(el))
                grid[ei, ai, ear] = (
                    _fractional_delay(ir, delay, length) * elev_gain
                ).astype(np.float32)
    return grid


def interp_hrir(grid, azimuth, elevation):
    """Bilinear HRIR interpolation (parity: IPL.HrtfInterpolation.Bilinear,
    SpatialPannerNode.cs:255).

    grid: f32[E, A, *rest] (jnp) — e.g. [E, A, 2, L] time-domain kernels or
    [E, A, 2, P, B] partitioned spectra; azimuth f32[S] in radians (any
    range); elevation f32[S] in [-pi/2, pi/2]. Returns f32[S, *rest].
    """
    E, A = grid.shape[:2]
    rest = grid.shape[2:]
    az = jnp.mod(azimuth, 2 * jnp.pi) / (2 * jnp.pi) * A  # [0, A)
    el = (elevation + jnp.pi / 2) / jnp.pi * (E - 1)  # [0, E-1]

    a0 = jnp.floor(az).astype(jnp.int32) % A
    a1 = (a0 + 1) % A
    fa = (az - jnp.floor(az)).astype(jnp.float32)
    e0 = jnp.clip(jnp.floor(el).astype(jnp.int32), 0, E - 1)
    e1 = jnp.clip(e0 + 1, 0, E - 1)
    fe = (el - jnp.floor(el)).astype(jnp.float32)

    # One-hot bilinear weights -> ONE small matmul against the flattened
    # grid (E*A rows) in place of 4 dynamic row gathers per quantum; the
    # gather form is ROADMAP S3. Splitting into 4 DEFAULT-precision {0,1}
    # SELECTION matmuls + f32 elementwise weights is NOT exact: the grid
    # values themselves round inside a reduced-precision matmul, unlike the
    # f32 one-hot SHIFT matmuls in sources.py whose data rides the f32
    # accumulator (probe: benchmarks.probe hrir-interp-selection).
    iota = jnp.arange(E * A, dtype=jnp.int32)

    def oh(e, a, wgt):  # [S] -> [S, E*A]
        return (iota[None, :] == (e * A + a)[:, None]) * wgt[:, None]

    W = (
        oh(e0, a0, (1 - fa) * (1 - fe))
        + oh(e0, a1, fa * (1 - fe))
        + oh(e1, a0, (1 - fa) * fe)
        + oh(e1, a1, fa * fe)
    )  # [S, E*A]
    out = jnp.einsum(
        "sg,gm->sm", W, grid.reshape(E * A, -1), precision=_HIGHEST
    )
    return out.reshape((-1,) + rest)


_spectra_cache = {}


# Longest measured HRIR the renderer accepts: 8 uniform 128-tap partitions.
MAX_HRIR_LENGTH = 8 * FRAMES_PER_BLOCK


def hrtf_fft_size(hrir_length: int) -> int:
    """Transform size for the per-quantum HRIR filter: the overlap-add of a
    128-frame quantum with an L-tap kernel needs fft >= 128 + L - 1, so the
    default 64-tap grids ride a 192-pt transform (25% fewer forward-DFT and
    44% fewer inverse-DFT MACs than 256-pt, exactly) and only
    measured sets longer than 64 taps pay for 256. Kernels longer than 128
    taps keep the 256-pt transform and split into uniform 128-tap
    PARTITIONS (fir_freq_partitioned)."""
    return 192 if hrir_length <= 64 else 2 * FRAMES_PER_BLOCK


def hrir_partition_count(hrir_length: int) -> int:
    """Number of uniform kernel partitions the per-quantum filter uses for
    an L-tap HRIR: 1 while a single overlap-add transform is exact
    (L <= fft - 127), else ceil(L / 128) 128-tap partitions on the 256-pt
    transform."""
    fft = hrtf_fft_size(hrir_length)
    chunk = fft - FRAMES_PER_BLOCK
    if hrir_length <= chunk:
        return 1
    return -(-hrir_length // FRAMES_PER_BLOCK)


def hrir_grid_spectra(grid):
    """Per-node kernel spectra of an HRIR grid: (Sr, Si) f32[E, A, 2, B]
    (B = hrtf_fft_size(L)//2 + 1) while L fits one exact overlap-add
    transform, or f32[E, A, 2, P, B] partitioned spectra (P uniform 128-tap
    partitions, 256-pt transforms) for longer measured kernels.

    Since bilinear interpolation is linear and the DFT is linear, the
    spectrum of the interpolated HRIR equals the interpolation of these
    per-node spectra — so frequency-domain rendering is EXACT vs the
    time-domain FIR (to DFT roundoff)."""
    # Keyed on id(grid) but the cache HOLDS the grid, so the id can never be
    # recycled while the entry lives (ids of collected objects are reused).
    # Bounded FIFO: apps that cycle measured HRIR sets (load_hrir per
    # panner) must not pin every past grid forever.
    key = id(grid)
    entry = _spectra_cache.get(key)
    if entry is None or entry[0] is not grid:
        g = np.asarray(grid, dtype=np.float64)  # [E, A, 2, L]
        L = g.shape[-1]
        fft = hrtf_fft_size(L)
        P = hrir_partition_count(L)
        if P > 1:
            # Uniform 128-tap partitions, each zero-padded to 256:
            # h = sum_p delay(h_p, p * 128).
            pad = P * FRAMES_PER_BLOCK - L
            g = np.pad(g, [(0, 0)] * (g.ndim - 1) + [(0, pad)])
            g = g.reshape(g.shape[:-1] + (P, FRAMES_PER_BLOCK))
        padded = np.zeros(g.shape[:-1] + (fft,))
        padded[..., : g.shape[-1]] = g
        spec = np.fft.rfft(padded, axis=-1)  # [E, A, 2(, P), bins]
        entry = (
            grid,
            spec.real.astype(np.float32),
            spec.imag.astype(np.float32),
        )
        while len(_spectra_cache) >= 8:
            _spectra_cache.pop(next(iter(_spectra_cache)))
        _spectra_cache[key] = entry
    return entry[1], entry[2]


def fir_freq_per_block(x, hr, hi, overlap):
    """Per-quantum stereo HRIR filter in the frequency domain.

    x: f32[S, 128] mono quanta; hr, hi: f32[S, 2, B] per-quantum kernel
    spectra (B = fft//2 + 1, fft = hrtf_fft_size(L)); overlap:
    f32[2, fft - 128] carried tail of the previous quantum.
    Returns (y f32[2, S, 128], overlap' f32[2, fft - 128]).

    Equivalent to the im2col FIR (HRIR length <= fft - 127 so the
    overlap-add is exact) but with NO [S, 128, L] window materialization —
    the im2col buffer's memory traffic dominates the spatializer once
    voices are batched. Everything here is DFT matmuls + tiny elementwise
    MACs, at HIGHEST precision: the 1e-5 oracle budget rules out a lower
    one (probe: benchmarks.probe hrtf-dft-precision).
    """
    from graphaudio_tpu.ops.fft import RealDft

    bins = hr.shape[-1]
    fft = 2 * (bins - 1)
    tail = fft - FRAMES_PER_BLOCK  # 64 for 192-pt, 128 for 256-pt
    dft = RealDft(FRAMES_PER_BLOCK, fft)
    f = dft.forward_packed(x)  # [S, 2B] = [R | I]
    xr, xi = f[:, :bins], f[:, bins:]
    # Complex multiply per ear: Y = X * H.
    yr = xr[:, None, :] * hr - xi[:, None, :] * hi  # [S, 2, B]
    yi = xr[:, None, :] * hi + xi[:, None, :] * hr
    S = x.shape[0]
    y_full = dft.inverse_packed(
        jnp.concatenate(
            [yr.reshape(S * 2, bins), yi.reshape(S * 2, bins)], axis=1
        )
    ).reshape(S, 2, fft)
    first = y_full[..., :FRAMES_PER_BLOCK]  # [S, 2, 128]
    second = y_full[..., FRAMES_PER_BLOCK:]  # [S, 2, tail]
    prev = jnp.concatenate([overlap[None], second[:-1]], axis=0)
    if tail < FRAMES_PER_BLOCK:
        prev = jnp.pad(prev, ((0, 0), (0, 0), (0, FRAMES_PER_BLOCK - tail)))
    y = first + prev  # [S, 2, 128]
    return jnp.moveaxis(y, 1, 0), second[-1]


def fir_freq_partitioned(x, hr_cat, hi_cat, ring_x, overlap, part_axis=None):
    """Per-quantum stereo HRIR filter for kernels LONGER than one exact
    overlap-add transform (L > 128): uniformly partitioned convolution with
    a time-varying kernel.

    x: f32[S, 128] mono quanta; hr_cat, hi_cat: f32[P-1+S, 2, P, B]
    partitioned kernel spectra AT EVERY QUANTUM of the concatenated
    timeline (the P-1 quanta preceding this superblock, then this
    superblock's S); ring_x: f32[P-1, 2B] packed input spectra of the
    preceding P-1 quanta (oldest first); overlap: f32[2, 128] carried tail.

    Returns (y f32[2, S, 128], ring_x' f32[P-1, 2B], overlap' f32[2, 128]).

    Semantics match the single-partition path and the oracle
    (testing/oracle.py SpatialPanner.process): each INPUT quantum u is
    convolved with the kernel interpolated at u — partition p of that
    kernel lands on output quantum u+p — so a static kernel renders
    EXACTLY as one long FIR (to DFT roundoff), and a moving source updates
    the kernel per input block like the reference's per-block HRTF render
    (SpatialPannerNode.cs:250-260).

    ``part_axis``: when running inside ``shard_map`` with the kernel
    PARTITION axis sharded over that mesh axis, hr_cat/hi_cat carry only
    this device's P_local partitions (of the padded global P = ring rows
    + 1); each device MACs its own partitions against the (replicated)
    input-spectra timeline at its global offsets and a psum completes the
    spectral accumulation — the distributed form of the static loop below,
    mirroring the convolver's 'part' sharding.
    """
    from graphaudio_tpu.ops.fft import RealDft

    bins = hr_cat.shape[-1]
    P_local = hr_cat.shape[-2]
    # Global partition count is carried by the ring's STATIC shape (the
    # ring/timeline are replicated; only the kernel axis shards).
    P = ring_x.shape[0] + 1
    fft = 2 * (bins - 1)
    S = x.shape[0]
    dft = RealDft(FRAMES_PER_BLOCK, fft)
    f = dft.forward_packed(x)  # [S, 2B]
    xcat = jnp.concatenate([ring_x, f], axis=0)  # [P-1+S, 2B]
    yr = jnp.zeros((S, 2, bins), x.dtype)
    yi = jnp.zeros((S, 2, bins), x.dtype)
    if part_axis is None:
        p_base = 0
    else:
        # This device's partitions are the contiguous global block
        # [idx*P_local, (idx+1)*P_local) — PartitionSpec block layout.
        p_base = jax.lax.axis_index(part_axis) * P_local
    # Unroll over the LOCAL partitions (P <= 8 globally): output quantum s
    # accumulates X[s-p] * H_p[s-p] — both the input spectrum and the kernel
    # are indexed at the INPUT time. Offsets are static single-device and
    # traced (dynamic slices) under 'part' sharding.
    for pl in range(P_local):
        if part_axis is None:
            start = P - 1 - pl
            xs = jax.lax.slice_in_dim(xcat, start, start + S, axis=0)
            hrp = jax.lax.slice_in_dim(
                hr_cat, start, start + S, axis=0
            )[:, :, pl]  # [S, 2, B]
            hip = jax.lax.slice_in_dim(
                hi_cat, start, start + S, axis=0
            )[:, :, pl]
        else:
            start = (P - 1) - (p_base + pl)  # in [0, P-1]: never clamps
            xs = jax.lax.dynamic_slice_in_dim(xcat, start, S, axis=0)
            hrp = jax.lax.dynamic_slice_in_dim(
                hr_cat, start, S, axis=0
            )[:, :, pl]
            hip = jax.lax.dynamic_slice_in_dim(
                hi_cat, start, S, axis=0
            )[:, :, pl]
        xr_, xi_ = xs[:, :bins], xs[:, bins:]
        yr = yr + xr_[:, None, :] * hrp - xi_[:, None, :] * hip
        yi = yi + xr_[:, None, :] * hip + xi_[:, None, :] * hrp
    if part_axis is not None:
        yr = jax.lax.psum(yr, part_axis)
        yi = jax.lax.psum(yi, part_axis)
    y_full = dft.inverse_packed(
        jnp.concatenate(
            [yr.reshape(S * 2, bins), yi.reshape(S * 2, bins)], axis=1
        )
    ).reshape(S, 2, fft)
    first = y_full[..., :FRAMES_PER_BLOCK]  # [S, 2, 128]
    second = y_full[..., FRAMES_PER_BLOCK:]  # [S, 2, 128]
    prev = jnp.concatenate([overlap[None], second[:-1]], axis=0)
    y = first + prev  # [S, 2, 128]
    new_ring = xcat[-(P - 1):] if P > 1 else ring_x
    return jnp.moveaxis(y, 1, 0), new_ring, second[-1]


NUM_SPEC_BINS = FRAMES_PER_BLOCK + 1  # bins of the (max) 256-pt transform


def fir_per_block(x, h, history):
    """Apply a per-quantum FIR to a mono signal.

    x: f32[S, 128] input quanta; h: f32[S, 2, L] per-quantum stereo kernels;
    history: f32[L-1] input samples preceding this superblock.

    Returns (y f32[2, S, 128], new_history f32[L-1]).

    Implementation: im2col windows + one batched matmul
    (out[s, i, ear] = sum_k w[s, i, k] h[s, ear, k]).
    """
    S, F = x.shape
    L = h.shape[-1]
    flat = jnp.concatenate([history, x.reshape(-1)])  # [L-1 + S*F]
    # windows[s, i, k] = x[s*F + i - k] = flat[(L-1) + s*F + i - k].
    # Built from L STATIC shifted slices (k is a compile-time constant per
    # slice) in place of one big dynamic per-element gather.
    base = L - 1
    w = jnp.stack(
        [flat[base - k : base - k + S * F] for k in range(L)], axis=-1
    ).reshape(S, F, L)
    y = jnp.einsum("sfk,sek->esf", w, h, precision=_HIGHEST)
    return y, flat[-(L - 1):]


# ---- measured-HRIR import (SOFA / npz) ---------------------------------------
#
# The reference uses phonon's measured HRTF dataset with bilinear
# interpolation (SpatialPannerNode.cs:250-260). load_hrir_grid regrids any
# measured HRIR set onto the same regular (elevation x azimuth) grid the
# analytic model populates, so the entire downstream pipeline — per-node
# spectra, bilinear interp_hrir, frequency-domain OLA — is shared.

def _regrid_hrirs(hrirs, az_rad, el_rad, sample_rate, source_rate,
                  n_azimuth, n_elevation, length):
    """Fit scattered measured HRIRs onto the regular grid.

    hrirs: f64[M, 2, N]; az_rad[M] (this module's convention: clockwise from
    straight ahead toward the RIGHT ear); el_rad[M] in [-pi/2, pi/2].
    Each grid node takes the inverse-distance-weighted mean of the 3 nearest
    measurement directions (exact at measurement directions).
    """
    hrirs = np.asarray(hrirs, np.float64)
    if hrirs.ndim != 3 or hrirs.shape[1] != 2:
        raise ValueError(f"expected HRIRs [M, 2, N], got {hrirs.shape}")
    if length is not None and not (1 <= length <= MAX_HRIR_LENGTH):
        # Kernels past 128 taps render via uniform 128-tap partitions
        # (fir_freq_partitioned); the partition unroll is bounded at 8.
        raise ValueError(
            f"HRIR length must be in [1, {MAX_HRIR_LENGTH}]; got {length}"
        )
    if int(source_rate) != int(sample_rate):
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(int(sample_rate), int(source_rate))
        hrirs = resample_poly(
            hrirs, int(sample_rate) // g, int(source_rate) // g, axis=-1
        )
    if length is None:
        # Default keeps the full measured response up to two partitions
        # (most public sets are 200-512 taps at 44.1/48 kHz); explicit
        # ``length`` trades taps for per-quantum MACs either way.
        length = min(hrirs.shape[-1], 2 * FRAMES_PER_BLOCK)
    if hrirs.shape[-1] >= length:
        hrirs = hrirs[..., :length]
    else:
        pad = length - hrirs.shape[-1]
        hrirs = np.pad(hrirs, ((0, 0), (0, 0), (0, pad)))

    # Unit direction per measurement (x right, y up, z ahead — the grid's
    # basis, see build_hrir_grid).
    mx = np.cos(el_rad) * np.sin(az_rad)
    my = np.sin(el_rad)
    mz = np.cos(el_rad) * np.cos(az_rad)
    mdir = np.stack([mx, my, mz], axis=1)  # [M, 3]

    grid = np.zeros((n_elevation, n_azimuth, 2, length), np.float32)
    for ei in range(n_elevation):
        el = -np.pi / 2 + np.pi * ei / (n_elevation - 1)
        for ai in range(n_azimuth):
            az = 2 * np.pi * ai / n_azimuth
            gdir = np.array([
                np.cos(el) * np.sin(az),
                np.sin(el),
                np.cos(el) * np.cos(az),
            ])
            ang = np.arccos(np.clip(mdir @ gdir, -1.0, 1.0))  # [M]
            k = min(3, len(ang))
            nearest = np.argpartition(ang, k - 1)[:k]
            d = ang[nearest]
            if d.min() < 1e-6:
                w = (d < 1e-6).astype(np.float64)
            else:
                w = 1.0 / d
            w /= w.sum()
            grid[ei, ai] = np.tensordot(w, hrirs[nearest], axes=1).astype(
                np.float32
            )
    return grid


def load_hrir_grid(source, sample_rate,
                   n_azimuth: int = N_AZIMUTH,
                   n_elevation: int = N_ELEVATION,
                   length: int | None = None) -> np.ndarray:
    """Load a MEASURED HRIR set onto the regular (elevation x azimuth) grid.

    Accepts:
      * a SOFA file path (AES69 HDF5: ``Data.IR`` [M, 2, N],
        ``SourcePosition`` [M, 3] spherical degrees with azimuth
        counterclockwise from ahead, ``Data.SamplingRate``);
      * an ``.npz`` path or dict with ``hrir`` f32[M, 2, N],
        ``azimuth_deg`` [M] (SOFA convention, counterclockwise),
        ``elevation_deg`` [M], ``sample_rate`` scalar.

    IRs are rate-converted to ``sample_rate`` (polyphase), truncated/padded
    to ``length`` (default: min(N, 256); up to MAX_HRIR_LENGTH=1024 — the
    renderer splits kernels past 128 taps into uniform 128-tap partitions,
    see fir_freq_partitioned), and regridded by inverse-distance weighting
    of the 3 nearest measurement directions.
    Returns f32[n_elevation, n_azimuth, 2, length].

    Parity: the measured-HRTF path of phonon (SpatialPannerNode.cs:250-260);
    the analytic spherical-head grid remains the default.
    """
    if isinstance(source, dict) or hasattr(source, "files"):
        data = source
    else:
        path = str(source)
        if path.endswith(".npz"):
            data = np.load(path)
        else:
            import h5py

            with h5py.File(path, "r") as f:
                ir = np.asarray(f["Data.IR"])  # [M, R, N]
                pos = np.asarray(f["SourcePosition"])  # [M, 3]
                sr = float(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
            if ir.ndim != 3 or ir.shape[1] != 2:
                raise ValueError(
                    f"SOFA Data.IR must be [M, 2, N]; got {ir.shape}"
                )
            az_sofa = np.deg2rad(pos[:, 0])
            el = np.deg2rad(pos[:, 1])
            # SOFA azimuth is counterclockwise (90 = left); the grid's is
            # clockwise (90 = right).
            return _regrid_hrirs(ir, -az_sofa, el, sample_rate, sr,
                                 n_azimuth, n_elevation, length)
    ir = np.asarray(data["hrir"])
    az_sofa = np.deg2rad(np.asarray(data["azimuth_deg"], np.float64))
    el = np.deg2rad(np.asarray(data["elevation_deg"], np.float64))
    sr = float(np.asarray(data["sample_rate"]).reshape(-1)[0])
    return _regrid_hrirs(ir, -az_sofa, el, sample_rate, sr,
                         n_azimuth, n_elevation, length)
