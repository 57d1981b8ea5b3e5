"""Float64 NumPy golden model: the port's copy of the parts of
``radar_tpu.golden`` that the port and ``chip_smoke.py`` use.

The reference-parity range pipeline (its butterfly FFT, base frame,
FindAbsMax and per-frame detection, the truth of ``cli verify``),
windows, the TDM virtual cube, the MTI filter, the range-Doppler map and
the CA, GO/SO and OS CFAR detectors with their Erlang-matched alphas,
copied as they are; ``tests/test_torch_constants.py`` holds each
copy's output equal to the original's.  The rest of the golden model
(Capon, MUSIC, clusters, ego-motion) comes with the slices that need
it.
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
