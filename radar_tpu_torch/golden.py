"""Float64 NumPy golden model: the port's copy of the parts of
``radar_tpu.golden`` that the port and ``chip_smoke.py`` use.

Windows, the TDM virtual cube, the range-Doppler map and the CA, GO/SO
and OS CFAR detectors with their Erlang-matched alphas, copied as they
are; ``tests/test_torch_constants.py`` holds each copy's output equal to
the original's.  The rest of the golden model (Capon, MUSIC, clusters,
ego-motion) comes with the slices that need it.
"""

from __future__ import annotations

import numpy as np

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig


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
