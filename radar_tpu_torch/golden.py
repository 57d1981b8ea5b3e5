"""Float64 NumPy golden model: the port's copy of the parts of
``radar_tpu.golden`` that the port and ``chip_smoke.py`` use.

The reference-parity range pipeline (its butterfly FFT, base frame,
FindAbsMax and per-frame detection, the truth of ``cli verify``),
windows, the TDM virtual cube, the MTI filter, the range-Doppler map,
the CA, GO/SO and OS CFAR detectors with their Erlang-matched alphas,
and the object-level stages (TDM compensation, velocity disambiguation,
calibration and its estimate from a reflector at a known angle,
keystone, the angle FFT, the planar scan, Capon, the cluster labels and
the clutter map), and the scene products
(micro-Doppler, the range-azimuth and angle-Doppler maps, MUSIC,
ego-motion and the two-radar yaw fit), copied as they are;
``tests/test_torch_constants.py`` holds each copy's output equal to the
original's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.io.capture import decode_shorts


# --------------------------------------------------------------------------
# Reference-parity FFT (bit-for-bit twin of cudaBenchMarking.cpp:61-105)
# --------------------------------------------------------------------------

def reverse_bits(num: int, bits: int) -> int:
    rev = 0
    for i in range(bits):
        if num & (1 << i):
            rev |= 1 << (bits - 1 - i)
    return rev


def bit_reversal_permutation(n: int) -> np.ndarray:
    bits = int(math.log2(n))
    return np.array([reverse_bits(i, bits) for i in range(n)], dtype=np.int64)


def butterfly_fft(x: np.ndarray) -> np.ndarray:
    """Iterative radix-2 DIT FFT with the reference's twiddle recurrence.

    Vectorized over butterflies within a stage but numerically identical to
    the scalar loop at cudaBenchMarking.cpp:89-104 (same accumulation of the
    recurrent twiddle ``omega *= e^{-2pi i/step}``).
    """
    x = np.asarray(x, dtype=np.complex128).copy()
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError("size must be a power of two")
    x = x[..., bit_reversal_permutation(n)]
    step = 2
    while step <= n:
        half = step // 2
        theta = -2.0 * np.pi / step
        twiddle = complex(math.cos(theta), math.sin(theta))
        # reproduce the recurrence omega_{j+1} = omega_j * twiddle
        omega = np.empty(half, dtype=np.complex128)
        w = 1.0 + 0.0j
        for j in range(half):
            omega[j] = w
            w *= twiddle
        v = x.reshape(x.shape[:-1] + (n // step, step))
        lo = v[..., :half]
        hi = v[..., half:]
        wn = omega * hi
        v[..., half:] = lo - wn
        v[..., :half] = lo + wn
        step <<= 1
    return x


# --------------------------------------------------------------------------
# Reference-parity single-target range pipeline
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RangeDetection:
    """Per-frame result of the parity pipeline."""

    peak_bin: int        # argmax over the scan window of the extended FFT
    rescaled_bin: int    # peak_bin * rx_samples // fft_size (int division)
    distance_m: float    # reference formula (acceleration.cu:523)
    peak_magnitude: float


def base_frame_rx0(
    frame0_shorts: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """Frame 0's RX0 slice (chirps*samples complex), the clutter reference
    (cudaBenchMarking.cpp:242-250)."""
    cube = decode_shorts(frame0_shorts, cfg)
    return cube[0].reshape(cfg.rx_samples)


def fft_input(
    frame_shorts: np.ndarray,
    base_rx0: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Decode -> rx0 -> subtract base -> zero-pad to fft_size
    (cudaBenchMarking.cpp:273-285)."""
    cube = decode_shorts(frame_shorts, cfg)
    rx0 = cube[0].reshape(cfg.rx_samples)
    out = np.zeros(cfg.fft_size, dtype=np.complex128)
    out[: cfg.rx_samples] = rx0 - base_rx0
    return out


def find_abs_max(x: np.ndarray, size: int) -> int:
    """First index of the max magnitude over [0, size).

    Mirrors FindAbsMax's strict ``>`` comparison (cudaBenchMarking.cpp:199)
    — ties resolve to the lowest index.
    """
    return int(np.argmax(np.abs(x[:size])))


def detect_frame(
    frame_shorts: np.ndarray,
    base_rx0: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    use_reference_fft: bool = False,
) -> RangeDetection:
    """Run the full parity pipeline on one frame of int16 data."""
    spec_in = fft_input(frame_shorts, base_rx0, cfg)
    spec = butterfly_fft(spec_in) if use_reference_fft else np.fft.fft(spec_in)
    peak = find_abs_max(spec, cfg.scan_bins)
    rescaled = cfg.rescale_peak_bin(peak)
    return RangeDetection(
        peak_bin=peak,
        rescaled_bin=rescaled,
        distance_m=cfg.bin_to_distance(rescaled),
        peak_magnitude=float(np.abs(spec[peak])),
    )


def detect_capture(
    frames_shorts: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    use_reference_fft: bool = False,
) -> list[RangeDetection]:
    """Frame-0-as-base streaming loop over a whole capture
    (cudaBenchMarking.cpp:261-310).  Returns detections for frames 1..N-1."""
    base = base_frame_rx0(frames_shorts[0], cfg)
    return [
        detect_frame(f, base, cfg, use_reference_fft) for f in frames_shorts[1:]
    ]


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (matches jnp/scipy 'periodic' convention)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


# periodic cosine-sum window coefficients (a0 - a1 cos + a2 cos2 - a3 cos3)
_WINDOW_COEFS = {
    "hann": (0.5, 0.5, 0.0, 0.0),
    "hamming": (0.54, 0.46, 0.0, 0.0),
    "blackman": (0.42, 0.5, 0.08, 0.0),
    "blackmanharris": (0.35875, 0.48829, 0.14128, 0.01168),
    "rect": (1.0, 0.0, 0.0, 0.0),
}


def window_fn(n: int, kind: str = "hann") -> np.ndarray:
    """Periodic window of the named kind (float64).

    The kinds trade main-lobe width for sidelobe level — the knob a
    radar engineer turns against strong-target sidelobes masking weak
    ones: hann (-31 dB first sidelobe), hamming (-43), blackman (-58),
    blackmanharris (4-term, -92), rect (none; max resolution).  All
    periodic (2*pi*k/n) to match :func:`hann_window`'s convention, so
    ``window_fn(n, 'hann') == hann_window(n)`` exactly.
    """
    try:
        a0, a1, a2, a3 = _WINDOW_COEFS[kind]
    except KeyError:
        raise ValueError(
            f"window kind must be one of {sorted(_WINDOW_COEFS)}, "
            f"got {kind!r}"
        ) from None
    t = 2.0 * np.pi * np.arange(n) / n
    return a0 - a1 * np.cos(t) + a2 * np.cos(2 * t) - a3 * np.cos(3 * t)


def virtual_cube(cube: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG) -> np.ndarray:
    """TDM-MIMO de-multiplex: physical cube -> virtual-array cube.

    Args:
      cube: complex (..., rx, chirps, samples); chirp c fired by
        tx = c % num_tx.

    Returns:
      complex (..., num_tx*num_rx, chirps_per_tx, samples) with virtual
      element v = tx*num_rx + rx.
    """
    x = np.asarray(cube)
    if cfg.num_tx == 1:
        return x
    parts = [x[..., :, tx::cfg.num_tx, :] for tx in range(cfg.num_tx)]
    return np.concatenate(parts, axis=-3)


def range_doppler_map(
    cube: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool | str = True,
) -> np.ndarray:
    """Range-Doppler map per (virtual) RX channel.

    Args:
      cube: complex (..., rx, chirps, samples) — chirps may be
        chirps_per_tx for a virtual cube; clutter already handled by the
        caller (subtract base frame or mean over chirps).
      window: False for none; True for the config default convention
        (cfg.window_kind); a kind string from :func:`window_fn`.

    Returns:
      complex (..., rx, doppler_fft_size, range_fft_size) — Doppler axis
      fftshifted so zero velocity is centered.
    """
    x = np.asarray(cube, dtype=np.complex128)
    if window:
        kind = cfg.window_kind if window is True else window
        x = x * window_fn(x.shape[-1], kind)
        x = x * window_fn(x.shape[-2], kind)[:, None]
    rng = np.fft.fft(x, n=cfg.range_fft_size, axis=-1)
    dopp = np.fft.fft(rng, n=cfg.doppler_fft_size, axis=-2)
    return np.fft.fftshift(dopp, axes=-2)


def ca_cfar_alpha_integrated(n_train: int, pfa: float, n_pulses: int) -> float:
    """CA-CFAR threshold ratio t for N-pulse NON-COHERENTLY INTEGRATED
    maps (float64 golden twin of ``ops.cfar.cfar_alpha`` at
    ``n_pulses > 1``): cells Erlang-N, training sum Gamma(n*N),

        Pfa(t) = sum_{k=0}^{N-1} C(nN+k-1, k) t^k / (1+t)^{nN+k},

    solved by bisection; threshold = t * training_sum.  Reduces to the
    exponential closed form ``t = pfa^{-1/n} - 1`` at N = 1."""
    from math import exp, lgamma, log, log1p

    if n_pulses <= 1:
        return pfa ** (-1.0 / n_train) - 1.0
    nn = n_train * n_pulses

    def pfa_of(t: float) -> float:
        lt, l1t = log(t), log1p(t)
        return sum(
            exp(lgamma(nn + k) - lgamma(k + 1) - lgamma(nn)
                + k * lt - (nn + k) * l1t)
            for k in range(n_pulses)
        )

    lo, hi = 1e-9, 10.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if pfa_of(mid) > pfa:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def ca_cfar_2d(
    power: np.ndarray,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    range_mode: str = "reflect",
    n_pulses: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """2D cell-averaging CFAR on a power map.

    Args:
      power: (..., doppler, range) non-negative power.
      guard/train: half-window guard and training cell counts per axis.
      pfa: false alarm probability -> threshold alpha = N*(pfa^{-1/N}-1).
      range_mode: edge handling on the range axis — 'reflect' (default;
        range is not circular, so a strong target near bin 0 must not
        inflate the noise estimate at the far edge) or 'wrap'.
      n_pulses: non-coherent integration depth the map was summed over
        (> 1 switches to the Erlang-matched alpha,
        :func:`ca_cfar_alpha_integrated`).

    Returns:
      (detections bool map, threshold map).  The Doppler axis always uses
      wrap-around padding (it is circular after fftshift); the TPU XLA,
      Pallas, and native C++ twins implement the identical convention.
    """
    gd, gr = guard
    td, tr = train
    wd, wr = gd + td, gr + tr
    n_train = (2 * wd + 1) * (2 * wr + 1) - (2 * gd + 1) * (2 * gr + 1)
    alpha = n_train * ca_cfar_alpha_integrated(n_train, pfa, n_pulses)

    def window_sum(p: np.ndarray, hd: int, hr: int) -> np.ndarray:
        lead = [(0, 0)] * (p.ndim - 2)
        padded = np.pad(p, lead + [(hd, hd), (0, 0)], mode="wrap")
        padded = np.pad(
            padded, lead + [(0, 0), (hr, hr)], mode=range_mode
        )
        out = np.zeros_like(p)
        for dd in range(2 * hd + 1):
            for dr in range(2 * hr + 1):
                out = out + padded[
                    ...,
                    dd : dd + p.shape[-2],
                    dr : dr + p.shape[-1],
                ]
        return out

    total = window_sum(power, wd, wr)
    inner = window_sum(power, gd, gr)
    noise = (total - inner) / n_train
    threshold = alpha * noise
    return power > threshold, threshold


def go_so_cfar_alpha(
    n_half: int, pfa: float, kind: str, n_pulses: int = 1
) -> float:
    """GO/SO-CFAR scale factor for exponential (square-law) noise.

    Exact false-alarm rates for greatest-of / smallest-of cell averaging
    with ``n_half`` training cells per half and threshold ``t * S_half``
    (t applied to the half-window SUM) [Gandhi & Kassam 1988]:

      Pfa_SO(t) = 2 * sum_{k=0}^{n-1} C(n-1+k, k) * (2+t)^-(n+k)
      Pfa_GO(t) = 2 * (1+t)^-n - Pfa_SO(t)

    ``n_pulses = N > 1`` (non-coherently integrated maps): the cell is
    Erlang-N and each half-sum Gamma(M), M = n_half*N; the same
    conditioning argument generalizes to the double sum

      P(X > t Sa, Sb > Sa)
        = sum_{k<N} sum_{j<M} G(M+k+j)/(G(M) k! j!) t^k (2+t)^-(M+k+j)
      Pfa_SO = 2 * that;  Pfa_GO = 2 * Pfa_half(t) - Pfa_SO

    with ``Pfa_half`` the CA series over Gamma(M) training
    (:func:`ca_cfar_alpha_integrated`'s integrand) — at N = 1 both
    reduce to the Gandhi-Kassam forms above (the N = 1 code path is
    kept verbatim for bit-compatibility).

    Both are monotone decreasing in t; solved by bisection in log space
    (log-gamma binomials, no scipy).  Returns t.
    """
    import math

    if n_pulses > 1:
        return _go_so_alpha_integrated(n_half, pfa, kind, n_pulses)
    n = n_half
    log_binom = [
        math.lgamma(n + k) - math.lgamma(k + 1) - math.lgamma(n)
        for k in range(n)
    ]

    def pfa_of(t: float) -> float:
        l2t = math.log(2.0 + t)
        # log-sum-exp over k of [log C(n-1+k,k) - (n+k) log(2+t)]
        terms = [log_binom[k] - (n + k) * l2t for k in range(n)]
        mx = max(terms)
        so = 2.0 * math.exp(mx) * sum(math.exp(x - mx) for x in terms)
        if kind == "so":
            return so
        return 2.0 * (1.0 + t) ** (-n) - so

    lo, hi = 1e-9, 1e9
    for _ in range(200):
        mid = math.sqrt(lo * hi)  # geometric: t spans many decades
        if pfa_of(mid) > pfa:  # Pfa decreases as t grows
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def _go_so_alpha_integrated(
    n_half: int, pfa: float, kind: str, n_pulses: int
) -> float:
    """Erlang-matched GO/SO alpha (see :func:`go_so_cfar_alpha`)."""
    import math

    n_p, m = n_pulses, n_half * n_pulses
    lg_m = math.lgamma(m)
    # log coefficient table for the SO double sum
    lco = [
        [math.lgamma(m + k + j) - lg_m - math.lgamma(k + 1)
         - math.lgamma(j + 1) for j in range(m)]
        for k in range(n_p)
    ]
    lbin_half = [
        math.lgamma(m + k) - math.lgamma(k + 1) - lg_m
        for k in range(n_p)
    ]

    def pfa_of(t: float) -> float:
        lt, l2t, l1t = math.log(t), math.log(2.0 + t), math.log(1.0 + t)
        terms = [
            lco[k][j] + k * lt - (m + k + j) * l2t
            for k in range(n_p) for j in range(m)
        ]
        mx = max(terms)
        so = 2.0 * math.exp(mx) * sum(math.exp(x - mx) for x in terms)
        if kind == "so":
            return so
        half = sum(
            math.exp(lbin_half[k] + k * lt - (m + k) * l1t)
            for k in range(n_p)
        )
        return 2.0 * half - so

    lo, hi = 1e-9, 1e9
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if pfa_of(mid) > pfa:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def go_so_cfar_2d(
    power: np.ndarray,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    kind: str = "go",
    range_mode: str = "reflect",
    n_pulses: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """2D greatest-of (GOCA) / smallest-of (SOCA) cell-averaging CFAR.

    The training ring is split into a range-LEADING half (cells with
    range offset dr > 0) and a range-LAGGING half (dr < 0); the dr == 0
    Doppler column is excluded so the halves are symmetric with
    ``n_half = (2*wd+1)*wr - (2*gd+1)*gr`` cells each.  The noise
    statistic is max (GO) or min (SO) of the two half-window sums:
    GO resists clutter edges crossing the window in range; SO resists a
    second target sitting in one half (the CA masking problem).  Same
    edge conventions as :func:`ca_cfar_2d` (Doppler wraps, range per
    ``range_mode``); threshold = t * S_half with t from
    :func:`go_so_cfar_alpha`.

    The reference has no CFAR at all (argmax detector,
    acceleration.cu:522); this extends the framework's
    CFAR family alongside CA and OS.
    """
    gd, gr = guard
    td, tr = train
    wd, wr = gd + td, gr + tr
    lead_pad = [(0, 0)] * (power.ndim - 2)
    padded = np.pad(power, lead_pad + [(wd, wd), (0, 0)], mode="wrap")
    padded = np.pad(padded, lead_pad + [(0, 0), (wr, wr)], mode=range_mode)
    d_sz, r_sz = power.shape[-2], power.shape[-1]

    def half_sum(sign: int) -> np.ndarray:
        out = np.zeros_like(power)
        for dd in range(-wd, wd + 1):
            for dr in range(1, wr + 1):
                if abs(dd) <= gd and dr <= gr:
                    continue  # guard region
                out = out + padded[
                    ...,
                    wd + dd : wd + dd + d_sz,
                    wr + sign * dr : wr + sign * dr + r_sz,
                ]
        return out

    n_half = (2 * wd + 1) * wr - (2 * gd + 1) * gr
    t = go_so_cfar_alpha(n_half, pfa, kind, n_pulses)
    s_lead = half_sum(+1)
    s_lag = half_sum(-1)
    noise = np.maximum(s_lead, s_lag) if kind == "go" else np.minimum(
        s_lead, s_lag
    )
    threshold = t * noise
    return power > threshold, threshold


def os_cfar_alpha(
    n_train: int, k: int, pfa: float, n_pulses: int = 1
) -> float:
    """OS-CFAR scale factor for exponential (square-law) noise.

    Pfa(alpha) = k * C(N, k) * B(alpha + N - k + 1, k)  [Rohling 1983],
    solved for alpha by bisection using log-gamma (no scipy dependency).

    ``n_pulses = N_p > 1`` (non-coherently integrated maps): cells are
    Erlang-N_p, whose integer shape keeps everything closed-form — the
    order-statistic density uses the Erlang CDF
    ``F(y) = 1 - e^-y sum_{i<N_p} y^i/i!`` and the exceedance
    ``Q(N_p, a y)``, and

      Pfa(a) = k C(n,k) INT_0^inf Q(N_p, a y) F^{k-1} (1-F)^{n-k} f(y) dy

    is a smooth 1D integral evaluated by the trapezoid rule on a dense
    grid (config-time constant; MC-validated).  Reduces to Rohling's
    Beta form at N_p = 1, where the legacy code path is kept verbatim
    for bit-compatibility.
    """
    import math

    if n_pulses > 1:
        return _os_alpha_integrated(n_train, k, pfa, n_pulses)

    log_k_choose = (
        math.log(k)
        + math.lgamma(n_train + 1)
        - math.lgamma(k + 1)
        - math.lgamma(n_train - k + 1)
    )

    def log_pfa(alpha: float) -> float:
        # log B(alpha + N - k + 1, k) = lgamma(a) + lgamma(k) - lgamma(a+k)
        a = alpha + n_train - k + 1
        return log_k_choose + math.lgamma(a) + math.lgamma(k) - math.lgamma(a + k)

    target = math.log(pfa)
    lo, hi = 1e-6, 1e6
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if log_pfa(mid) > target:  # Pfa decreases as alpha grows
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _os_alpha_integrated(
    n_train: int, k: int, pfa: float, n_pulses: int
) -> float:
    """Erlang-matched OS alpha (see :func:`os_cfar_alpha`)."""
    import math

    n, n_p = n_train, n_pulses
    # dense grid over the order statistic's support: Y_(k) concentrates
    # around the F^{-1}(k/n) quantile of Gamma(n_p); the Gamma tail is
    # e^-y, so [0, n_p + 40 + 8*sqrt(n_p)] covers it past double precision
    y = np.linspace(1e-9, n_p + 40.0 + 8.0 * math.sqrt(n_p), 20001)
    pows = np.stack([y**i / math.factorial(i) for i in range(n_p)])
    ccdf = np.exp(-y) * pows.sum(axis=0)            # 1 - F(y), Erlang
    cdf = 1.0 - ccdf
    log_f = (n_p - 1) * np.log(y) - y - math.lgamma(n_p)  # Gamma(n_p) pdf
    log_c = (math.log(k) + math.lgamma(n + 1) - math.lgamma(k + 1)
             - math.lgamma(n - k + 1))
    # order-statistic density of Y_(k), in log space for the extremes
    with np.errstate(divide="ignore"):
        log_dens = (log_c + (k - 1) * np.log(np.maximum(cdf, 1e-300))
                    + (n - k) * np.log(np.maximum(ccdf, 1e-300)) + log_f)
    dens = np.exp(log_dens)

    def pfa_of(alpha: float) -> float:
        ay = alpha * y
        q = np.exp(-ay) * np.stack(
            [ay**i / math.factorial(i) for i in range(n_p)]
        ).sum(axis=0)                               # Q(n_p, alpha*y)
        trapz = getattr(np, "trapezoid", np.trapz)
        return float(trapz(q * dens, y))

    lo, hi = 1e-6, 1e6
    for _ in range(100):
        mid = math.sqrt(lo * hi)
        if pfa_of(mid) > pfa:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def os_cfar_2d(
    power: np.ndarray,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    k_frac: float = 0.75,
    range_mode: str = "reflect",
    stride: int = 1,
    n_pulses: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """2D ordered-statistic CFAR: threshold = alpha_os * k-th smallest
    training cell.  Robust to clutter edges and multiple targets inside
    the training ring, where CA-CFAR's mean is biased (the classic CA
    masking problem).  Same window geometry and edge conventions as
    :func:`ca_cfar_2d` (Doppler wraps, range per ``range_mode``).
    ``stride`` keeps every stride-th ring cell (deterministic order) and
    recomputes alpha for the decimated count — the sort dominates the
    cost, and the twins decimate identically.
    """
    gd, gr = guard
    td, tr = train
    wd, wr = gd + td, gr + tr
    lead = [(0, 0)] * (power.ndim - 2)
    padded = np.pad(power, lead + [(wd, wd), (0, 0)], mode="wrap")
    padded = np.pad(padded, lead + [(0, 0), (wr, wr)], mode=range_mode)

    d_sz, r_sz = power.shape[-2], power.shape[-1]
    ring = []
    m = 0
    for dd in range(-wd, wd + 1):
        for dr in range(-wr, wr + 1):
            if abs(dd) <= gd and abs(dr) <= gr:
                continue  # guard region (incl. the cell under test)
            if m % stride == 0:
                ring.append(
                    padded[..., wd + dd : wd + dd + d_sz,
                           wr + dr : wr + dr + r_sz]
                )
            m += 1
    cells = np.stack(ring, axis=-1)
    n_train = cells.shape[-1]
    # half-away-from-zero (not Python's banker's round): matches the C++
    # twin's llround so k is identical across implementations
    k = max(1, min(n_train, int(np.floor(k_frac * n_train + 0.5))))
    kth = np.sort(cells, axis=-1)[..., k - 1]
    alpha = os_cfar_alpha(n_train, k, pfa, n_pulses)
    threshold = alpha * kth
    return power > threshold, threshold


def mti_filter(
    x: np.ndarray, order: int = 2, axis: int = -2, stride: int = 1
) -> np.ndarray:
    """Circular pulse-canceller MTI along slow time (float64 golden).

    ``order=2``: ``y[c] = x[c] - x[c-stride]``; ``order=3``:
    ``y[c] = x[c] - 2 x[c-stride] + x[c-2*stride]``, circular over the
    CPI.  ``stride`` pairs same-TX chirps on a TDM-interleaved chirp
    axis (``num_tx``) and is 1 on a demuxed per-TX axis — the same
    linear map either way, so the device paths may apply it wherever the
    pipeline is linear (raw cube, range planes, the Doppler constant)
    and still match this time-domain definition to fp tolerance.

    Defines the semantics of ``RadarConfig.clutter_mode='mti2'/'mti3'``;
    torch twin: ``ops.preproc.mti_clutter_removal``.
    """
    if order not in (2, 3):
        raise ValueError(f"MTI order must be 2 or 3, got {order}")
    x = np.asarray(x, dtype=np.complex128)
    prev = np.roll(x, stride, axis=axis)
    if order == 2:
        return x - prev
    return x - 2.0 * prev + np.roll(x, 2 * stride, axis=axis)


# --------------------------------------------------------------------------
# Object-level detection: TDM velocity, keystone, angle refinement,
# clusters and the clutter map (copied from radar_tpu.golden)
# --------------------------------------------------------------------------

def mimo_doppler_compensate(
    snaps: np.ndarray, doppler_bin: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """Remove the TDM time-offset phase from virtual-array snapshots.

    TX ``tx``'s chirps lag TX0's by ``tx * Tr``; a target with Doppler
    frequency fd therefore adds phase 2*pi*fd*tx*Tr to that TX's virtual
    elements, which would bias the angle estimate.  ``doppler_bin`` is the
    fftshifted Doppler index of the detection.

    Args:
      snaps: complex (..., num_virtual_rx); doppler_bin: int (...).
    """
    if cfg.num_tx == 1:
        return np.asarray(snaps)
    d = cfg.doppler_fft_size
    fd = (np.asarray(doppler_bin) - d // 2) / (d * cfg.slow_time_interval_s)
    tx_idx = np.arange(cfg.num_virtual_rx) // cfg.num_rx
    phase = -2.0 * np.pi * fd[..., None] * tx_idx * cfg.chirp_interval_s
    return snaps * np.exp(1j * phase)


def apply_rx_cal(
    x: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG, axis: int = -1
) -> np.ndarray:
    """Multiply the per-virtual-channel calibration correction
    (``cfg.rx_cal``) along ``axis``.  Identity when no calibration is
    configured.  The correction is diagonal and constant, so it commutes
    with the TDM phase compensation and with the disambiguation
    hypothesis ramps — apply it once, wherever snapshots are formed.

    Args:
      x: complex (..., V on ``axis``, ...) snapshots or virtual cube.
    """
    cal = cfg.rx_cal_vector()
    if cal is None:
        return np.asarray(x)
    x = np.asarray(x)
    shape = [1] * x.ndim
    shape[axis] = -1
    return x * cal.reshape(shape)


def estimate_rx_cal(
    snaps: np.ndarray,
    azimuth_deg: float = 0.0,
    elevation_deg: float = 0.0,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> np.ndarray:
    """Estimate the per-channel calibration correction from snapshots of
    a single target at a KNOWN angle (the standard corner-reflector
    calibration: park a strong reflector at boresight, record, solve).

    The measured channel-v response of a lone target with unit signal s_n
    is ``s_{n,v} = g_v * a_v(theta) * s_n`` where g_v is the unknown
    hardware gain/phase of the chain and a_v the ideal steering phase.
    The least-squares relative response vs channel 0 is
    ``h_v = sum_n s_{n,v} conj(s_{n,0}) / sum_n |s_{n,0}|^2
         = (g_v a_v) / (g_0 a_0)``,
    so the correction ``c_v = (a_v / a_0) / h_v`` makes the calibrated
    snapshots ``c_v s_{n,v} = g_0 a_v s_n / a_0`` — an ideally matched
    array up to one common complex scalar (irrelevant to every angle
    estimator).  c_0 == 1 by construction.

    Args:
      snaps: complex (N, V) TDM-compensated virtual snapshots of the
        calibration target across N frames (gather at the detection
        cell, ``mimo_doppler_compensate`` applied — for the standard
        STATIC calibration target the compensation is identity anyway).
      azimuth_deg / elevation_deg: the target's true angle.

    Returns:
      complex128 (V,) correction vector for ``cfg.rx_cal``.
    """
    snaps = np.asarray(snaps, dtype=np.complex128)
    if snaps.ndim == 1:
        snaps = snaps[None, :]
    pos = cfg.virtual_positions_wl()                      # (V, 2)
    sin_az = np.sin(np.deg2rad(azimuth_deg))
    cos_el = np.cos(np.deg2rad(elevation_deg))
    sin_el = np.sin(np.deg2rad(elevation_deg))
    a = np.exp(2j * np.pi * (pos[:, 0] * sin_az * cos_el + pos[:, 1] * sin_el))
    ref = snaps[:, :1]
    h = (snaps * np.conj(ref)).sum(axis=0) / (np.abs(ref) ** 2).sum()
    return (a / a[0]) / h


def disambiguate_velocity(
    snaps: np.ndarray,
    doppler_bin: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TDM Doppler-ambiguity hypothesis test (float64 golden).

    TDM-MIMO divides the unambiguous Doppler span by ``num_tx`` (each
    TX fires every ``num_tx * Tr``), so a fast target wraps in the
    Doppler map AND receives the wrong TDM compensation — which
    decoheres the virtual array.  That decoherence is the signal: the
    true Doppler is ``fd_meas + h / Ts`` for one of ``num_tx``
    hypotheses h (compensation phases differ by ``e^{-j 2 pi h t /
    num_tx}`` on TX t's elements), and only the correct h yields a
    coherent steering vector across the full virtual array.  Scoring
    each hypothesis by its peak angle-spectrum power recovers the full
    single-TX span ``[-lambda/(4 Tr), +lambda/(4 Tr))`` — for the
    2-TX default geometry, 15.2 m/s instead of 7.6.

    Args:
      snaps: complex (..., num_virtual_rx) UNCOMPENSATED virtual-array
        snapshots at the detected cells.
      doppler_bin: int (...) fftshifted Doppler index per snapshot.

    Returns:
      (velocity_mps, hypothesis, snaps_compensated): float64 (...) true
      radial velocity, int (...) winning hypothesis in [0, num_tx), and
      the winner's compensated snapshots (..., V) for angle estimation.
    """
    snaps = np.asarray(snaps, np.complex128)
    d = cfg.doppler_fft_size
    ts = cfg.slow_time_interval_s
    fd = (np.asarray(doppler_bin) - d // 2) / (d * ts)
    tx_idx = np.arange(cfg.num_virtual_rx) // cfg.num_rx
    best_score = np.full(fd.shape, -np.inf)
    best_h = np.zeros(fd.shape, np.int64)
    best_fd = np.array(fd, np.float64)
    best_snaps = np.array(snaps)
    for h in range(cfg.num_tx):
        fd_h = fd + h / ts
        phase = -2.0 * np.pi * fd_h[..., None] * tx_idx * cfg.chirp_interval_s
        comp = snaps * np.exp(1j * phase)
        spec = angle_fft(comp, cfg.num_angle_bins, cfg)
        score = np.max(np.abs(spec) ** 2, axis=-1)
        take = score > best_score
        best_score = np.where(take, score, best_score)
        best_h = np.where(take, h, best_h)
        best_fd = np.where(take, fd_h, best_fd)
        best_snaps = np.where(take[..., None], comp, best_snaps)
    # wrap the extended Doppler into the symmetric single-TX span
    lim = 1.0 / (2.0 * cfg.chirp_interval_s)
    best_fd = np.mod(best_fd + lim, 2.0 * lim) - lim
    return best_fd * (cfg.wavelength_m / 2.0), best_h, best_snaps


def keystone_transform(
    cube: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """f64 keystone transform on a VIRTUALIZED cube (..., V, D, N).

    Bit-twin of ops.keystone.keystone_cube (see that module for the
    derivation): per fast-time sample n, re-evaluate each stream's
    slow-time inverse DFT at positions scaled by
    ``alpha_n = f_c / (f_c + S*t_n)`` (TDM streams get the fractional
    ``(alpha_n - 1)*tx/num_tx`` offset), removing the range-Doppler
    coupling term ``(f_c + S*t_n) * v * t_m`` exactly for unambiguous
    velocities.  The reference has no motion compensation
    (one uncorrected range FFT per frame, acceleration.cu:522).
    """
    x = np.asarray(cube, np.complex128)
    if x.shape[-3] != cfg.num_virtual_rx:
        raise ValueError(
            f"keystone_transform wants a virtualized cube with "
            f"{cfg.num_virtual_rx} channels, got {x.shape[-3]}"
        )
    d, n_s = x.shape[-2], x.shape[-1]
    t_n = np.arange(n_s, dtype=np.float64) / cfg.sample_rate_hz
    alpha = cfg.carrier_hz / (cfg.carrier_hz + cfg.slope_hz_per_s * t_n)
    k = np.arange(d)
    k_signed = np.where(k < (d + 1) // 2, k, k - d).astype(np.float64)
    m = np.arange(d, dtype=np.float64)
    lead = x.shape[:-3]
    xv = x.reshape((-1, cfg.num_tx, cfg.num_rx, d, n_s))
    spec = np.fft.fft(xv, axis=-2)
    out = np.empty_like(xv)
    for tx in range(cfg.num_tx):
        pos = (alpha[:, None] * m[None, :]
               + (alpha - 1.0)[:, None] * (tx / cfg.num_tx))  # (N, D)
        kmat = np.exp(2j * np.pi / d
                      * pos[:, :, None] * k_signed[None, None, :]) / d
        out[:, tx] = np.einsum("nmk,brkn->brmn", kmat, spec[:, tx])
    return out.reshape(lead + (cfg.num_virtual_rx, d, n_s))


def angle_fft(
    rx_snapshot: np.ndarray, num_bins: int, cfg: RadarConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """Angle spectrum via zero-padded FFT across the (virtual) RX axis.

    Args:
      rx_snapshot: complex (..., num_virtual_rx) values at a detected
        (range, doppler) cell.

    Returns:
      (..., num_bins) magnitude spectrum, fftshifted so bin k maps to
      sin(theta) = (k - num_bins/2) / (num_bins * rx_spacing_wavelengths).
    """
    spec = np.fft.fft(rx_snapshot, n=num_bins, axis=-1)
    return np.fft.fftshift(spec, axes=-1)


def parabolic_bin_offset(
    p_minus: np.ndarray, p_center: np.ndarray, p_plus: np.ndarray
) -> np.ndarray:
    """Sub-bin peak offset in [-0.5, 0.5] from three log-power samples.

    Classic 3-point parabolic (quadratic) interpolation on dB values —
    for windowed spectra the log-domain fit is far more accurate than the
    linear-power fit.  Flat neighborhoods return 0; NOTE a neighbor equal
    to the center (e.g. an edge-clamped gather) collapses the parabola to
    ±0.5, so callers must mask edge cells themselves (the pipeline zeroes
    the offset at range-map edges).
    """
    eps = 1e-30
    lm = np.log(np.maximum(p_minus, eps))
    lc = np.log(np.maximum(p_center, eps))
    lp = np.log(np.maximum(p_plus, eps))
    denom = lm - 2.0 * lc + lp
    offset = np.where(
        np.abs(denom) > 1e-12, 0.5 * (lm - lp) / np.where(denom == 0, 1, denom), 0.0
    )
    return np.clip(offset, -0.5, 0.5)


def angle_fft_azimuth(
    rx_snapshot: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> float:
    """Interpolated angle-FFT azimuth (float64 twin of the pipeline's
    aoa_from_snapshots): argmax of the fftshifted angle spectrum, 3-point
    log-parabolic sub-bin offset (wrapping neighbors — the spectrum spans
    the full sin-space period), interpolation in sin(theta), then arcsin.
    """
    n = cfg.num_angle_bins
    spec = np.abs(angle_fft(rx_snapshot, n, cfg)) ** 2
    b = int(np.argmax(spec))
    off = float(parabolic_bin_offset(
        spec[(b - 1) % n], spec[b], spec[(b + 1) % n]
    ))
    sin_theta = (b + off - n // 2) / (n * cfg.rx_spacing_wavelengths)
    return float(np.rad2deg(np.arcsin(np.clip(sin_theta, -1.0, 1.0))))


def aoa_2d(
    snapshot: np.ndarray, cfg: RadarConfig = DEFAULT_CONFIG
) -> tuple[float, float]:
    """Joint (azimuth, elevation) from one virtual-array snapshot via a
    matched-filter scan over the planar steering grid.

    Steering for element at (x, z) wavelengths (x: azimuth axis, z: up):
    a_v = exp(j 2 pi (x sin(az) cos(el) + z sin(el))).

    Args:
      snapshot: complex (num_virtual_rx,) cell values (TDM-compensated).

    Returns:
      (azimuth_deg, elevation_deg) at the grid argmax.
    """
    pos = cfg.virtual_positions_wl()  # (V, 2)
    az = np.linspace(*cfg.angle_grid_deg[:2], int(cfg.angle_grid_deg[2]))
    el = np.linspace(
        *cfg.elevation_grid_deg[:2], int(cfg.elevation_grid_deg[2])
    )
    saz, cel = np.sin(np.deg2rad(az)), np.cos(np.deg2rad(el))
    sel = np.sin(np.deg2rad(el))
    phase = 2 * np.pi * (
        pos[None, None, :, 0] * saz[:, None, None] * cel[None, :, None]
        + pos[None, None, :, 1] * sel[None, :, None]
    )  # (n_az, n_el, V)
    spec = np.exp(-1j * phase) @ snapshot  # (n_az, n_el)
    i, j = np.unravel_index(np.argmax(np.abs(spec)), spec.shape)
    return float(az[i]), float(el[j])


def capon_spectrum(
    snapshots: np.ndarray,
    cfg: RadarConfig = DEFAULT_CONFIG,
    diagonal_loading: float = 1e-3,
) -> tuple[np.ndarray, np.ndarray]:
    """Capon (MVDR) angle spectrum from multiple snapshots of the RX array.

    Args:
      snapshots: complex (..., num_snapshots, n_rx) — e.g. the chirp axis
        at a detected range bin.

    Returns:
      (angles_deg, spectrum) with spectrum shape (..., n_angles):
      P(theta) = 1 / (a^H R^{-1} a).
    """
    x = np.asarray(snapshots, dtype=np.complex128)
    n_rx = x.shape[-1]
    n_snap = x.shape[-2]
    r = np.einsum("...si,...sj->...ij", x, x.conj()) / n_snap
    tr = np.trace(r, axis1=-2, axis2=-1).real / n_rx
    r = r + (diagonal_loading * tr)[..., None, None] * np.eye(n_rx)
    r_inv = np.linalg.inv(r)

    lo, hi, n = cfg.angle_grid_deg
    angles = np.linspace(lo, hi, int(n))
    k = 2.0 * np.pi * cfg.rx_spacing_wavelengths
    steering = np.exp(
        1j * k * np.sin(np.deg2rad(angles))[:, None] * np.arange(n_rx)[None, :]
    )  # (n_angles, n_rx)
    denom = np.einsum(
        "ai,...ij,aj->...a", steering.conj(), r_inv, steering
    ).real
    return angles, 1.0 / np.maximum(denom, 1e-30)


def cluster_hits(hits: np.ndarray) -> np.ndarray:
    """Connected-component labels of a CFAR hit map (float64-free but
    exact by construction): 8-connectivity, Doppler (axis -2) wraps,
    range (axis -1) does not.

    Twin of ``ops.cluster.label_hits``; both label each component with
    its minimum flat cell index (d * R + r), so the arrays compare
    bit-for-bit.  Plain BFS — this is the irregular CPU formulation the
    TPU path replaces with vectorized min-label propagation.

    Args:
      hits: bool (..., D, R).

    Returns:
      int32 labels, same shape; -1 for non-hit cells.
    """
    hits = np.asarray(hits, bool)
    lead = hits.shape[:-2]
    d_sz, r_sz = hits.shape[-2], hits.shape[-1]
    flat = hits.reshape((-1, d_sz, r_sz))
    out = np.full(flat.shape, -1, np.int32)
    for b in range(flat.shape[0]):
        h = flat[b]
        seen = np.zeros_like(h)
        for d0 in range(d_sz):
            for r0 in range(r_sz):
                if not h[d0, r0] or seen[d0, r0]:
                    continue
                comp = [(d0, r0)]
                seen[d0, r0] = True
                q = [(d0, r0)]
                while q:
                    d, r = q.pop()
                    for dd in (-1, 0, 1):
                        for dr in (-1, 0, 1):
                            nd = (d + dd) % d_sz  # Doppler wraps
                            nr = r + dr
                            if not 0 <= nr < r_sz:
                                continue  # range does not
                            if h[nd, nr] and not seen[nd, nr]:
                                seen[nd, nr] = True
                                comp.append((nd, nr))
                                q.append((nd, nr))
                label = min(d * r_sz + r for d, r in comp)
                for d, r in comp:
                    out[b, d, r] = label
    return out.reshape(lead + (d_sz, r_sz))


def clutter_map_alpha(
    pfa: float, beta: float, block: int = 1, n_pulses: int = 1
) -> float:
    """Clutter-map (Nitzberg) CFAR threshold multiplier (float64 golden).

    Per-cell recursive background updated once per BLOCK of frames with
    the block mean, ``m <- (1-beta) m + beta mean(block)``, decision
    ``p > alpha * m`` against the pre-update map.

    ``n_pulses = 1`` (exponential cells): the background is a weighted
    sum of past exponentials with each block contributing ``block``
    terms of weight ``beta (1-beta)^i / block``, so

        Pfa(alpha) = prod_{i>=0} (1 + alpha beta (1-beta)^i / s)^{-s}

    with s = block (the exponential MGF per term; block=1 recovers the
    classic per-frame Nitzberg product).

    ``n_pulses = N > 1`` (RX-summed / non-coherently integrated maps,
    the Erlang match every spatial kind already has): the cell under
    test is Gamma(N, 1) and each map update's block mean is
    Gamma(N*block, 1)/block, so with ``w_i = beta (1-beta)^i / block``
    and ``s = N * block``

        M(t)       = prod_i (1 - t w_i)^{-s}          (background MGF)
        Pfa(alpha) = sum_{k=0}^{N-1} alpha^k/k! * M^(k)(-alpha)

    (condition the Gamma survival series on the background and push the
    expectation through term by term: E[m^k e^{-alpha m}] is the k-th
    MGF derivative at -alpha).  The derivatives come from the
    log-derivative recursion ``M^(k) = sum_j C(k-1,j) M^(j) L^(k-j)``
    with ``L^(r)(-a) = s (r-1)! sum_i w_i^r/(1+a w_i)^r``, carried as
    ratios ``R_k = M^(k)/M`` (all positive) so the whole evaluation
    stays in log space.  Monotone in alpha; solved by bisection with
    the product truncated once the remaining weights are negligible.
    MC-validated at the design rate for N in {1, 2, 4} (tests).
    """
    import math
    from math import log1p

    if not 0.0 < beta < 1.0:
        raise ValueError(f"beta must be in (0, 1), got {beta}")
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if n_pulses < 1:
        raise ValueError(f"n_pulses must be >= 1, got {n_pulses}")
    n_terms = 1
    while beta * (1.0 - beta) ** n_terms > 1e-14 and n_terms < 100000:
        n_terms += 1
    w = [beta * (1.0 - beta) ** i / block for i in range(n_terms)]
    s = float(block) * n_pulses

    def log_pfa(alpha: float) -> float:
        logm = -s * sum(log1p(alpha * wi) for wi in w)
        if n_pulses == 1:
            return logm
        lr = [0.0] * n_pulses  # lr[r] = L^(r)(-alpha), r = 1..N-1
        for r in range(1, n_pulses):
            lr[r] = (s * math.factorial(r - 1)
                     * sum(wi**r / (1.0 + alpha * wi) ** r for wi in w))
        ratio = [1.0]  # R_k = M^(k)(-alpha) / M(-alpha)
        for k in range(1, n_pulses):
            ratio.append(sum(math.comb(k - 1, j) * ratio[j] * lr[k - j]
                             for j in range(k)))
        series = sum(alpha**k / math.factorial(k) * ratio[k]
                     for k in range(n_pulses))
        return logm + math.log(series)

    lo, hi = 1e-6, 1e9
    target = math.log(pfa)
    for _ in range(200):
        mid = math.sqrt(lo * hi)
        if log_pfa(mid) > target:
            lo = mid
        else:
            hi = mid
    return math.sqrt(lo * hi)


def clutter_map_cfar(
    power: np.ndarray,
    pfa: float,
    beta: float = 0.25,
    m0: np.ndarray | None = None,
    block: int = 16,
    n_pulses: int = 1,
) -> tuple[np.ndarray, np.ndarray]:
    """Clutter-map CFAR over a frame sequence (float64 golden).

    Each cell keeps its OWN recursive background estimate, so the
    detector adapts exactly to spatially varying clutter floors that a
    spatial training window averages wrongly (rain/ground patches,
    floor steps).  The map updates once per BLOCK of frames with the
    block mean — the scan-cadence discipline classic clutter maps use:
    at per-CPI frame rates a per-frame EMA absorbs even a moving target
    (measured: a 3 m/s target dwells ~16 frames in one 0.39 m range
    cell and vanished after ONE frame at beta=0.25), so choose
    ``block >= cell_size / (v_min * frame_interval)``.  Decisions
    compare against the PRE-update map (no self-masking within a
    block).  With no ``m0`` the first block seeds the map (its mean)
    and emits no hits (warmup); the trailing partial block detects
    normally and folds into the final map with the same beta.

    Args:
      power: (frames, doppler, range) non-negative power.
      m0: optional (doppler, range) initial background (a previous
        call's returned map — the serving path carries it).

    Returns:
      (hits bool (frames, d, r), m_out (d, r) final background).
    """
    p = np.asarray(power, np.float64)
    alpha = clutter_map_alpha(pfa, beta, block, n_pulses)
    hits = np.zeros(p.shape, bool)
    start = 0
    if m0 is None:
        m = p[:block].mean(axis=0)
        start = min(block, p.shape[0])
    else:
        m = np.asarray(m0, np.float64).copy()
    f = start
    while f < p.shape[0]:
        blk = p[f : f + block]
        hits[f : f + block] = blk > alpha * m
        m = (1.0 - beta) * m + beta * blk.mean(axis=0)
        f += block
    return hits, m


# --------------------------------------------------------------------------
# Scene products: micro-Doppler, the range-azimuth and angle-Doppler maps,
# MUSIC, and ego-motion (copied from radar_tpu.golden)
# --------------------------------------------------------------------------

def micro_doppler(
    frames_shorts: np.ndarray,
    base_cube: np.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    range_bin: int = 0,
    win_frames: int = 8,
    hop_frames: int = 1,
    n_fft: int | None = None,
    window: bool | str = True,
) -> np.ndarray:
    """Micro-Doppler spectrogram: slow-time STFT at one range gate.

    Per frame: windowed range DFT per chirp, clutter removal (base
    range-plane subtraction, or per-frame chirp mean when ``base_cube``
    is None), gate at ``range_bin``, keep the TX0 chirps (uniform PRI =
    ``cfg.slow_time_interval_s`` under TDM), average over RX.  The
    gated series is then short-time-Fourier-transformed with a
    ``win_frames * chirps_per_tx``-sample window hopped by
    ``hop_frames`` frames.

    Returns:
      float64 (n_windows, n_fft) power, Doppler axis fftshifted (zero
      velocity centered); n_fft defaults to the window length.
    """
    kind = cfg.window_kind if window is True else window
    cube = decode_shorts(frames_shorts, cfg)   # (n, rx, chirps, samples)
    x = np.asarray(cube, np.complex128)
    if kind:
        x = x * window_fn(cfg.num_samples, kind)
    rng = np.fft.fft(x, n=cfg.range_fft_size, axis=-1)
    if base_cube is not None:
        b = np.asarray(base_cube, np.complex128)
        if kind:
            b = b * window_fn(cfg.num_samples, kind)
        rng = rng - np.fft.fft(b, n=cfg.range_fft_size, axis=-1)
    else:
        rng = rng - rng.mean(axis=-2, keepdims=True)
    g = rng[..., range_bin]                    # (n, rx, chirps)
    g = g[..., 0 :: cfg.num_tx]                # TX0 chirps: uniform PRI
    series = g.mean(axis=-2).reshape(-1)       # RX mean -> (n * Kc,)

    kc = cfg.chirps_per_tx
    length = win_frames * kc
    hop = hop_frames * kc
    if n_fft is None:
        n_fft = length
    if n_fft < length:
        raise ValueError(
            f"n_fft ({n_fft}) must be >= the window length ({length}): "
            "the STFT zero-pads, it does not truncate windowed segments"
        )
    if len(series) < length:
        raise ValueError(
            f"capture too short: {len(series)} slow-time samples < "
            f"window {length} ({win_frames} frames x {kc})"
        )
    n_win = (len(series) - length) // hop + 1
    w = window_fn(length, kind) if kind else np.ones(length)
    spec = np.empty((n_win, n_fft))
    for i in range(n_win):
        seg = series[i * hop : i * hop + length] * w
        s = np.fft.fftshift(np.fft.fft(seg, n=n_fft))
        spec[i] = (s.real * s.real + s.imag * s.imag)
    return spec


def micro_doppler_velocity_axis(
    n_fft: int, cfg: RadarConfig = DEFAULT_CONFIG
) -> np.ndarray:
    """Radial velocity (m/s) per fftshifted spectrogram bin."""
    fd = (np.arange(n_fft) - n_fft // 2) / (n_fft * cfg.slow_time_interval_s)
    return fd * cfg.wavelength_m / 2.0


def _compensated_rd_map(frames_shorts, base_cube, cfg, window):
    """(..., V', D, R) complex RD planes, clutter-removed and
    per-Doppler-row TDM-compensated (shared by the range-azimuth maps)."""
    cube = decode_shorts(frames_shorts, cfg)
    if base_cube is not None:
        cube = cube - np.asarray(base_cube, np.complex128)
    else:
        cube = cube - cube.mean(axis=-2, keepdims=True)
    rd = range_doppler_map(virtual_cube(cube, cfg), cfg, window)
    rd = apply_rx_cal(rd, cfg, axis=-3)
    # apply the per-detection TDM compensation to every Doppler row at
    # once — same helper, broadcast doppler_bin
    d = cfg.doppler_fft_size
    return np.moveaxis(
        mimo_doppler_compensate(
            np.moveaxis(rd, -3, -1), np.arange(d)[:, None], cfg
        ),
        -1, -3,
    )


def range_azimuth_capon_map(
    frames_shorts: np.ndarray,
    base_cube: np.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool | str = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Capon/MVDR range-azimuth map: per range bin, the D
    TDM-compensated Doppler rows are the snapshots for the MVDR
    spectrum over the virtual array.

    Returns:
      (angles_deg (n_angles,), power (..., n_angles, range_fft)).
    """
    rd = _compensated_rd_map(frames_shorts, base_cube, cfg, window)
    x = np.swapaxes(np.moveaxis(rd, -1, -3), -1, -2)    # (..., R, D, V')
    angles, p = capon_spectrum(x, cfg)
    return angles, np.swapaxes(p, -1, -2)


def range_azimuth_map(
    frames_shorts: np.ndarray,
    base_cube: np.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    window: bool | str = True,
) -> np.ndarray:
    """Range-azimuth power map: beamform EVERY RD cell, integrate Doppler.

    Per frame: RD planes per virtual element (TDM demux), per-Doppler-row
    MIMO time-offset compensation, zero-padded angle DFT across the
    virtual elements at every (doppler, range) cell, then noncoherent
    integration over Doppler.

    Returns:
      float64 (..., num_angle_bins, range_fft): angle axis fftshifted
      (map bins to degrees with :func:`angle_bin_to_deg`).
    """
    rd = _compensated_rd_map(frames_shorts, base_cube, cfg, window)
    a = cfg.num_angle_bins
    v = min(cfg.num_virtual_rx, a)
    w = np.exp(-2j * np.pi * np.outer(np.arange(v), np.arange(a)) / a)
    w = np.fft.fftshift(w, axes=-1)                    # (v, A)
    s = np.einsum("va,...vdr->...adr", w, rd[..., :v, :, :])
    return (s.real * s.real + s.imag * s.imag).sum(axis=-2)


def angle_doppler_map(
    frames_shorts: np.ndarray,
    base_cube: np.ndarray | None,
    cfg: RadarConfig = DEFAULT_CONFIG,
    range_bin: int | None = None,
    window: bool | str = True,
) -> tuple[np.ndarray, int]:
    """Angle-Doppler power map at one range gate: at a range gate,
    beamform each Doppler bin's virtual-array snapshot, so movers
    separate by both their radial velocity and their bearing.
    Per-Doppler-row TDM compensation and calibration as in
    :func:`range_azimuth_map`.

    Args:
      range_bin: gate, or None for the strongest gate (argmax of total
        RD power over the range axis).

    Returns:
      (power float64 (..., doppler_fft, num_angle_bins), gate used);
      angle axis fftshifted (:func:`angle_bin_to_deg`).
    """
    rd = _compensated_rd_map(frames_shorts, base_cube, cfg, window)
    if range_bin is None:
        p_r = (rd.real**2 + rd.imag**2).sum(
            axis=tuple(range(rd.ndim - 1))
        )
        range_bin = int(np.argmax(p_r))
    a = cfg.num_angle_bins
    v = min(cfg.num_virtual_rx, a)
    snap = np.moveaxis(rd[..., :v, :, range_bin], -2, -1)  # (..., D, v)
    spec = angle_fft(snap, a, cfg)
    return (spec.real**2 + spec.imag**2), range_bin


def angle_bin_to_deg(bin_idx: np.ndarray, num_bins: int, cfg: RadarConfig) -> np.ndarray:
    sin_theta = (np.asarray(bin_idx) - num_bins // 2) / (
        num_bins * cfg.rx_spacing_wavelengths
    )
    return np.rad2deg(np.arcsin(np.clip(sin_theta, -1.0, 1.0)))


def music_spectrum(
    snapshots: np.ndarray,
    num_sources: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
) -> tuple[np.ndarray, np.ndarray]:
    """MUSIC pseudospectrum from RX-array snapshots.

    Eigendecompose the spatial covariance, project steering vectors onto
    the noise subspace: P(theta) = 1 / ||E_n^H a(theta)||^2.

    Args:
      snapshots: complex (..., n_snapshots, n_rx).
      num_sources: assumed signal-subspace dimension (< n_rx).

    Returns:
      (angles_deg (n_angles,), pseudospectrum (..., n_angles)).
    """
    x = np.asarray(snapshots, dtype=np.complex128)
    n_rx = x.shape[-1]
    if not 0 < num_sources < n_rx:
        raise ValueError(f"num_sources must be in (0, {n_rx})")
    r = np.einsum("...si,...sj->...ij", x, x.conj()) / x.shape[-2]
    # eigh returns ascending eigenvalues: noise subspace = first n_rx - M
    _, vecs = np.linalg.eigh(r)
    noise = vecs[..., :, : n_rx - num_sources]  # (..., n_rx, n_noise)

    lo, hi, n = cfg.angle_grid_deg
    angles = np.linspace(lo, hi, int(n))
    k = 2.0 * np.pi * cfg.rx_spacing_wavelengths
    steering = np.exp(
        1j * k * np.sin(np.deg2rad(angles))[:, None] * np.arange(n_rx)[None, :]
    )  # (n_angles, n_rx)
    # proj[..., a, i] = (E_n^H a(theta))_i = sum_j conj(E_n[j, i]) a_j
    proj = np.einsum(
        "...ij,aj->...ai", np.swapaxes(noise, -2, -1).conj(), steering
    )
    denom = np.sum(np.abs(proj) ** 2, axis=-1)
    return angles, 1.0 / np.maximum(denom, 1e-30)


def estimate_ego_motion(
    azimuth_deg: np.ndarray,
    radial_velocity: np.ndarray,
    valid: np.ndarray | None = None,
    n_iters: int = 5,
    inlier_mps: float = 0.5,
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Instantaneous platform (ego) velocity from one frame's detections
    (float64 golden).

    Every STATIC scatterer at azimuth ``az`` seen from a platform moving
    with velocity ``(vx lateral, vy forward)`` has radial velocity
    ``vr = -(vx sin az + vy cos az)``: the static world lies on one
    sinusoid whose two coefficients are the ego velocity.  Solved by
    iteratively reweighted least squares with CAUCHY weights
    ``w = 1 / (1 + (resid / inlier_mps)^2)`` (a hard gate after the
    mover-contaminated initial fit can shed every static point); the
    final static/moving label is the hard gate ``|resid| <= inlier_mps``
    on the converged fit.

    Args:
      azimuth_deg: (K,) detection azimuths.
      radial_velocity: (K,) measured radial velocities (positive =
        receding).
      valid: optional (K,) bool mask of usable detections.
      n_iters: IRLS refinement iterations.
      inlier_mps: residual gate for the static-scatterer set.

    Returns:
      (v, is_static, ok): ``v`` float64 (2,) = (vx, vy); ``is_static``
      bool (K,); ``ok`` False when the fit is degenerate (fewer than 3
      inliers, or the normal matrix singular) — then ``v`` is zero and
      ``is_static`` all False.
    """
    az = np.deg2rad(np.asarray(azimuth_deg, np.float64))
    vr = np.asarray(radial_velocity, np.float64)
    a = np.stack([np.sin(az), np.cos(az)], axis=-1)  # (K, 2)
    b = -vr
    base = (np.ones(vr.shape, bool) if valid is None
            else np.asarray(valid, bool))
    w = base.astype(np.float64)
    v = np.zeros(2)
    resid = b.copy()
    for _ in range(max(1, int(n_iters))):
        aw = a * w[:, None]
        ata = aw.T @ a  # (2, 2)
        det = ata[0, 0] * ata[1, 1] - ata[0, 1] * ata[1, 0]
        if base.sum() < 3 or det < 1e-9:
            return np.zeros(2), np.zeros(vr.shape, bool), False
        v = np.linalg.solve(ata, aw.T @ b)
        resid = b - a @ v
        # Cauchy reweight over the BASE set (soft: a detection shed by
        # the mover-contaminated initial fit re-enters as the fit lands)
        w = base / (1.0 + (resid / inlier_mps) ** 2)
    is_static = (np.abs(resid) <= inlier_mps) & base
    if is_static.sum() < 3:
        return np.zeros(2), np.zeros(vr.shape, bool), False
    return v, is_static, True


def mount_rotation(yaw_deg: float) -> np.ndarray:
    """(2, 2) sensor->body rotation for a sensor whose boresight points
    at body azimuth ``yaw_deg`` (positive toward +x, x lateral-right /
    y forward).  Sensor-frame (0, 1) maps to body (sin yaw, cos yaw)."""
    t = np.deg2rad(float(yaw_deg))
    return np.array([[np.cos(t), np.sin(t)], [-np.sin(t), np.cos(t)]])


def estimate_ego_motion_yaw(
    sensor_velocities: np.ndarray,
    mounts: np.ndarray,
) -> tuple[np.ndarray, float, bool]:
    """Platform (vx, vy, yaw rate) from MULTIPLE radars' ego fits.

    With radars mounted at different body positions, each sensor's
    translational velocity picks up the lever-arm term
    ``omega x r_k``:

        R(yaw_k) @ v_k_sensor = v_body + omega * perp(r_k),
        perp(r) = (-r_y, r_x)

    — 2 equations per sensor on the 3 unknowns ``(vx, vy, omega)``,
    solved by least squares (rank-deficient for equal positions, then
    ``ok`` is False).

    Args:
      sensor_velocities: (S, 2) per-sensor ``(vx, vy)`` SENSOR-frame
        fits from :func:`estimate_ego_motion`.
      mounts: (S, 3) per-sensor body pose ``(x_m, y_m, yaw_deg)``.

    Returns:
      (v_body (2,), omega_rad_s, ok); zeros and False when fewer than
      two sensors or the lever-arm geometry is degenerate.
    """
    vs = np.asarray(sensor_velocities, np.float64).reshape(-1, 2)
    ms = np.asarray(mounts, np.float64).reshape(-1, 3)
    if vs.shape[0] != ms.shape[0] or vs.shape[0] < 2:
        return np.zeros(2), 0.0, False
    rows, rhs = [], []
    for (vx, vy), (mx, my, yaw) in zip(vs, ms):
        rows.append([1.0, 0.0, -my])
        rows.append([0.0, 1.0, mx])
        rhs.extend(mount_rotation(yaw) @ (vx, vy))
    a = np.asarray(rows)
    b = np.asarray(rhs)
    if np.linalg.matrix_rank(a) < 3:
        return np.zeros(2), 0.0, False
    p, *_ = np.linalg.lstsq(a, b, rcond=None)
    return p[:2], float(p[2]), True


def ego_compensated_velocity(
    azimuth_deg: np.ndarray,
    radial_velocity: np.ndarray,
    v_ego: np.ndarray,
) -> np.ndarray:
    """Ground-frame radial velocity: measured vr plus the ego
    projection ``vx sin az + vy cos az`` (zero for static scatterers
    when ``v_ego`` is the :func:`estimate_ego_motion` fit)."""
    az = np.deg2rad(np.asarray(azimuth_deg, np.float64))
    v = np.asarray(v_ego, np.float64)
    return (np.asarray(radial_velocity, np.float64)
            + v[..., 0] * np.sin(az) + v[..., 1] * np.cos(az))
