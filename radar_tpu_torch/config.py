"""Radar system configuration (the port's copy of ``radar_tpu.config``).

One frozen dataclass holds every parameter of the radar and of the
processing pipeline; the defaults reproduce the reference constants.
The port keeps its own copy so that it imports nothing of the JAX
package; ``tests/test_torch_constants.py`` holds the fields, defaults,
checks and derived properties equal to the original's, and
``convert.config_from_jax`` builds this class from the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

LIGHT_SPEED = 3.0e8  # reference acceleration.cu:14 / cudaBenchMarking.cpp:7


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (reference acceleration.cu:39-49)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """All parameters of the FMCW radar and its processing pipeline.

    Defaults mirror the reference (acceleration.cu:7-15,
    cudaBenchMarking.cpp:10-22): TI 77 GHz FMCW, 100 samples/chirp,
    128 chirps/frame, 4 RX, 1 TX, Fs = 2 MHz, slope 5.987e12 Hz/s.
    """

    # --- waveform / array geometry -------------------------------------
    carrier_hz: float = 77.0e9          # F0, cudaBenchMarking.cpp:10
    slope_hz_per_s: float = 5.987e12    # mu,  cudaBenchMarking.cpp:11
    sample_rate_hz: float = 2.0e6       # Fs,  cudaBenchMarking.cpp:13
    chirp_interval_s: float = 64e-6     # Tr,  cudaBenchMarking.cpp:16
    num_samples: int = 100              # SampleSize, acceleration.cu:8
    num_chirps: int = 128               # ChirpSize,  acceleration.cu:9
    num_rx: int = 4                     # RxSize,     acceleration.cu:11
    num_tx: int = 1                     # numTx,      cudaBenchMarking.cpp:21
    # RX spacing in wavelengths; 0.5 == lambda/2 (cudaBenchMarking.cpp:19)
    rx_spacing_wavelengths: float = 0.5

    # --- pipeline parameters -------------------------------------------
    # Fraction of the range FFT scanned for the peak
    # (floor(0.4 * extendSize) bins, acceleration.cu:522)
    scan_fraction: float = 0.4
    # CA-CFAR parameters (extension; the reference has only argmax)
    cfar_guard: Tuple[int, int] = (2, 2)      # (doppler, range) guard cells
    cfar_train: Tuple[int, int] = (4, 8)      # (doppler, range) training cells
    cfar_pfa: float = 1e-4                    # false-alarm rate -> threshold
    # Range-axis edge handling for the CFAR training window: 'reflect'
    # (physical: range is not circular, mirror the edge cells) or 'wrap'.
    # Doppler always wraps (circular after fftshift).
    cfar_range_mode: str = "reflect"
    # TOP-edge range bins excluded from detection (hits masked before
    # top-K).  The range DFT's leakage is CIRCULAR while real ranges are
    # not: a strong near-range target's window sidelobes wrap through DC
    # into the last ~window-width bins, where the 'reflect' training
    # ring never sees the peak — so those cells cross the (correctly
    # calibrated) threshold PERSISTENTLY, frame after frame, and confirm
    # ghost tracks (surfaced in round 5 when the Erlang-matched default
    # alpha removed the ~2x threshold slack that had been hiding them:
    # measured -69 dB wrapped sidelobes at 12 circular bins from a
    # 77 dB-SNR target).  The reference sidesteps the whole region by
    # scanning only ``floor(0.4 * extendSize)`` bins
    # (acceleration.cu:522); this guard is the targeted form.  None =
    # auto = 2 * (cfar_guard[1] + cfar_train[1]) bins (covers wrapped
    # sidelobes above the noise floor for ~80 dB-SNR targets at the
    # default Hann window); 0 disables (full-span detection).
    range_edge_guard: int | None = None
    # Detector family: 'ca' (cell-averaging), 'os' (ordered-statistic —
    # robust to clutter edges / multiple targets in the training ring),
    # 'goca' (greatest-of CA: resists clutter edges crossing the window
    # in range) or 'soca' (smallest-of CA: resists a second target
    # sitting in one half of the training window).
    cfar_kind: str = "ca"
    # OS-CFAR order statistic as a fraction of the training-cell count
    # (k = round(frac * N); 0.75 is the standard choice).
    cfar_os_k_frac: float = 0.75
    # OS-CFAR training-ring decimation: keep every stride-th training cell
    # (deterministic ring order).  Alpha is recomputed for the decimated
    # cell count so Pfa holds, at a fraction-of-a-dB detection loss.
    # With the Pallas rank-selection kernel (ops/pallas/oscfar_kernel.py)
    # the EXACT stride-1 mode runs the full ring at 12,000+ fps for the
    # CFAR stage on v5e, so decimation is now an accuracy/latency knob
    # rather than a necessity (the XLA gather+sort fallback still pays
    # ~118 fps full-pipeline at stride 1).
    cfar_os_stride: int = 1
    # Non-coherent integration depth the CFAR alpha is solved for:
    # 1 = exponential cells (the closed form); N > 1 = Erlang-N summed
    # cells (``RDPipeline.detect_integrated`` multiplies this by its
    # group size so the threshold harvests the integration gain instead
    # of sitting a deterministic single-pulse alpha above the N-scaled
    # noise mean).  The per-frame RD power map is ITSELF a non-coherent
    # sum over the num_tx*num_rx virtual channels, so the default is
    # ``None`` = auto = ``num_tx * num_rx``: the Erlang-matched detector
    # whose realized Pfa lands ON the configured rate (measured
    # 0.9-1.5x across seeds).  The historical exponential-cell
    # convention (``cfar_n_pulses = 1``) is measurably mis-calibrated
    # for this pipeline — 0 realized false alarms where 1e-4 designs
    # ~52 on target-free noise, and correspondingly depressed Pd at the
    # SNR knee — and is kept only as an explicit opt-in (see
    # MIGRATION.md).  Applies to EVERY kind: 'ca' (closed-form series),
    # 'goca'/'soca' (Gandhi-Kassam double sum) and 'os' (numerical
    # order-statistic integral over the integer-shape Erlang CDF) — all
    # MC-validated at the design rate.  Consumers read the resolved
    # value via ``cfar_pulses_effective``.
    cfar_n_pulses: int | None = None
    # Window applied on both FFT axes before the range/Doppler DFTs:
    # trades main-lobe width for sidelobe level (strong-target sidelobes
    # masking weak targets).  'hann' (-31 dB, the default and the only
    # kind the native C++ reference-parity twin implements), 'hamming'
    # (-43), 'blackman' (-58), 'blackmanharris' (-92), 'rect' (none).
    window_kind: str = "hann"
    # MXU matmul precision for the DFT paths.  'high' (default): 3 bf16
    # MXU passes, ~8e-6 relative vs float64 golden — two orders inside the
    # 1e-3 BASELINE gate at ~12% less cost than full f32.  'highest':
    # f32-exact 6-pass, ~8e-8.  'default': the TPU's single bf16 pass,
    # ~9e-4 (rides the gate) for the max-throughput mode.
    dft_precision: str = "high"
    # Slow-time clutter removal applied by the RD detection pipelines
    # (every rd_impl; the f64 truth for the MTI modes is
    # golden.mti_filter, which parity tests apply to the decoded cube —
    # golden's scene-analysis helpers (azmap/micro-Doppler) and their
    # jnp twins keep their own base-or-mean convention):
    #   'auto' — base-frame range-plane subtraction when a base cube is
    #            supplied (the reference's convention,
    #            cudaBenchMarking.cpp:277-280), else mean-over-chirps;
    #   'base' — require the base cube (error without one);
    #   'mean' — per-frame mean over chirps even when a base exists;
    #   'mti2'/'mti3' — two/three-pulse circular MTI canceller along
    #            slow time (y[c] = x[c] - x[c-T], T = num_tx so the
    #            difference pairs same-TX chirps; 'mti3' double-notches:
    #            x[c] - 2x[c-T] + x[c-2T]).  Removes static clutter
    #            from a SINGLE frame — no empty-scene base capture
    #            needed — with the deepest rejection of the three modes
    #            (the notch is exactly zero at DC per CPI, not just at
    #            the scene average).  Ignores any supplied base cube.
    clutter_mode: str = "auto"
    # Angle processing
    num_angle_bins: int = 64                  # angle-FFT size
    angle_grid_deg: Tuple[float, float, int] = (-90.0, 90.0, 181)  # Capon scan
    # TX antenna positions in wavelengths as ((azimuth, elevation), ...)
    # per TX.  None = azimuth-only ULA: TX t at (t * num_rx * spacing, 0),
    # giving the classic contiguous 1D virtual array.  An elevated TX
    # (nonzero second coordinate) makes the virtual array planar and
    # enables elevation estimation (ops.aoa.aoa_2d_from_snapshots).
    tx_positions_wl: Tuple[Tuple[float, float], ...] | None = None
    elevation_grid_deg: Tuple[float, float, int] = (-30.0, 30.0, 61)
    # Per-channel complex calibration CORRECTION, multiplied onto every
    # virtual-array snapshot before any angle estimator (and onto the
    # virtual cube in the scene-level range-azimuth maps).  Hardware RX
    # chains have per-channel gain/phase imbalances that decohere the
    # array and bias every angle estimate; ``cli calibrate`` estimates
    # this vector from a capture of a single boresight target
    # (golden.estimate_rx_cal) and ``--cal cal.json`` applies it.
    # Length num_rx (tiled across TX blocks) or num_virtual_rx.
    # None = identity (an ideally matched array).
    rx_cal: Tuple[complex, ...] | None = None

    def rx_cal_vector(self):
        """Per-VIRTUAL-channel complex128 correction (V,), or None.

        A length-num_rx vector describes the physical RX chains and is
        tiled across the TX blocks (TDM reuses the same receivers for
        every TX); a length-num_virtual_rx vector is taken verbatim
        (covers per-TX phase offsets too).
        """
        if self.rx_cal is None:
            return None
        import numpy as np

        cal = np.asarray(self.rx_cal, dtype=np.complex128)
        if cal.shape == (self.num_rx,):
            cal = np.tile(cal, self.num_tx)
        return cal

    def __post_init__(self):
        """Validate enum-like and count fields: an invalid value must fail
        HERE, not produce three silently different detectors across the
        golden/XLA/C++ twins (e.g. a negative cfar_os_stride means three
        different Python-slice/modulo/clamp interpretations)."""
        def _check(name, value, allowed):
            if value not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, got {value!r}")

        _check("cfar_kind", self.cfar_kind, ("ca", "os", "goca", "soca"))
        _check("window_kind", self.window_kind,
               ("hann", "hamming", "blackman", "blackmanharris", "rect"))
        _check("cfar_range_mode", self.cfar_range_mode, ("reflect", "wrap"))
        _check("dft_precision", self.dft_precision,
               ("high", "highest", "default"))
        _check("clutter_mode", self.clutter_mode,
               ("auto", "base", "mean", "mti2", "mti3"))
        if not isinstance(self.cfar_os_stride, int) or self.cfar_os_stride < 1:
            raise ValueError(
                f"cfar_os_stride must be a positive int, got {self.cfar_os_stride!r}"
            )
        if self.range_edge_guard is not None and (
            not isinstance(self.range_edge_guard, int)
            or self.range_edge_guard < 0
        ):
            raise ValueError(
                f"range_edge_guard must be a non-negative int or None "
                f"(auto), got {self.range_edge_guard!r}"
            )
        if self.cfar_n_pulses is not None and (
            not isinstance(self.cfar_n_pulses, int) or self.cfar_n_pulses < 1
        ):
            raise ValueError(
                f"cfar_n_pulses must be a positive int or None (auto = "
                f"num_tx * num_rx), got {self.cfar_n_pulses!r}"
            )
        if not 0.0 < self.cfar_os_k_frac <= 1.0:
            raise ValueError(
                f"cfar_os_k_frac must be in (0, 1], got {self.cfar_os_k_frac!r}"
            )
        if self.rx_cal is not None and len(self.rx_cal) not in (
            self.num_rx, self.num_tx * self.num_rx
        ):
            raise ValueError(
                f"rx_cal must have num_rx ({self.num_rx}) or num_virtual_rx "
                f"({self.num_tx * self.num_rx}) entries, got {len(self.rx_cal)}"
            )

    def effective_clutter(self, has_base: bool) -> str:
        """Resolve ``clutter_mode`` to a concrete mode for one call.

        'auto' keeps the historical convention (base subtraction when a
        base cube is present, mean-over-chirps otherwise); the explicit
        modes apply regardless of whether a base was supplied, except
        'base' which demands one.
        """
        mode = self.clutter_mode
        if mode == "auto":
            return "base" if has_base else "mean"
        if mode == "base" and not has_base:
            raise ValueError(
                "clutter_mode='base' requires a base cube (an empty-scene "
                "frame-0 capture); use 'mean' or 'mti2'/'mti3' for "
                "base-free clutter removal"
            )
        return mode

    # ---- derived sizes --------------------------------------------------
    @property
    def samples_per_frame(self) -> int:
        """Complex samples per frame = chirps * rx * samples."""
        return self.num_chirps * self.num_rx * self.num_samples

    @property
    def shorts_per_frame(self) -> int:
        """int16 values per frame on disk (I and Q for every sample)."""
        return self.samples_per_frame * 2

    @property
    def bytes_per_frame(self) -> int:
        return self.shorts_per_frame * 2

    @property
    def rx_samples(self) -> int:
        """Samples in one RX channel's frame slice (chirps * samples)."""
        return self.num_chirps * self.num_samples

    @property
    def fft_size(self) -> int:
        """Range-FFT size = nextPow2(chirps * samples) (acceleration.cu:465)."""
        return next_pow2(self.rx_samples)

    @property
    def scan_bins(self) -> int:
        """floor(scan_fraction * fft_size) bins scanned for the peak."""
        return int(math.floor(self.scan_fraction * self.fft_size))

    @property
    def extended_sample_rate_hz(self) -> float:
        """Fs_extend = Fs * fft_size / rx_samples (acceleration.cu:521)."""
        return self.sample_rate_hz * self.fft_size / self.rx_samples

    @property
    def wavelength_m(self) -> float:
        return LIGHT_SPEED / self.carrier_hz

    @property
    def num_virtual_rx(self) -> int:
        """TDM-MIMO virtual array size = num_tx * num_rx."""
        return self.num_tx * self.num_rx

    @property
    def range_edge_guard_effective(self) -> int:
        """Resolved top-edge detection guard in range bins (see the
        ``range_edge_guard`` field comment), clamped so at least one
        range bin stays detectable."""
        g = self.range_edge_guard
        if g is None:
            g = 2 * (self.cfar_guard[1] + self.cfar_train[1])
        return min(g, self.range_fft_size - 1)

    @property
    def cfar_pulses_effective(self) -> int:
        """Resolved CFAR integration depth: ``cfar_n_pulses`` if set,
        else ``num_virtual_rx`` — the Erlang order that matches the
        per-frame RD power map's non-coherent sum over virtual channels
        (see the ``cfar_n_pulses`` field comment).  Every alpha consumer
        (golden/XLA/Pallas/C++ twins' callers) reads this, never the raw
        field."""
        if self.cfar_n_pulses is not None:
            return self.cfar_n_pulses
        return self.num_virtual_rx

    @property
    def chirps_per_tx(self) -> int:
        """Chirps each TX fires per frame (TDM: TXs alternate chirps)."""
        if self.num_chirps % self.num_tx:
            raise ValueError("num_chirps must be a multiple of num_tx")
        return self.num_chirps // self.num_tx

    def virtual_positions_wl(self):
        """(num_virtual_rx, 2) float64 (azimuth, elevation) positions in
        wavelengths: element v = tx*num_rx + rx sits at
        rx_position + tx_position (TDM-MIMO convolution of apertures)."""
        import numpy as np

        if self.tx_positions_wl is None:
            tx_pos = [
                (t * self.num_rx * self.rx_spacing_wavelengths, 0.0)
                for t in range(self.num_tx)
            ]
        else:
            if len(self.tx_positions_wl) != self.num_tx:
                raise ValueError("tx_positions_wl must have num_tx entries")
            tx_pos = list(self.tx_positions_wl)
        pos = np.zeros((self.num_virtual_rx, 2))
        for t in range(self.num_tx):
            for r in range(self.num_rx):
                pos[t * self.num_rx + r, 0] = (
                    r * self.rx_spacing_wavelengths + tx_pos[t][0]
                )
                pos[t * self.num_rx + r, 1] = tx_pos[t][1]
        return pos

    @property
    def has_elevation(self) -> bool:
        """True when any TX is elevated (planar virtual array)."""
        return self.tx_positions_wl is not None and any(
            p[1] != 0.0 for p in self.tx_positions_wl
        )

    @property
    def slow_time_interval_s(self) -> float:
        """Slow-time sample spacing per TX = num_tx * chirp_interval."""
        return self.num_tx * self.chirp_interval_s

    @property
    def range_fft_size(self) -> int:
        """Per-chirp range FFT size for the range-Doppler path."""
        return next_pow2(self.num_samples)

    @property
    def doppler_fft_size(self) -> int:
        """Doppler FFT size over one TX's chirp sequence."""
        return next_pow2(self.chirps_per_tx)

    @property
    def max_range_m(self) -> float:
        """Max range of the scan window (~20.04 m for the defaults)."""
        return self.bin_to_physical_distance(self.scan_bins)

    # ---- reference distance math ----------------------------------------
    def rescale_peak_bin(self, peak_bin: int) -> int:
        """Quantize an extended-FFT bin to the pre-pad grid.

        INTEGER division, exactly as the reference computes
        ``maxDisIdx = argmax * (ChirpSize*SampleSize) / extendedSize``
        (acceleration.cu:522, cudaBenchMarking.cpp:302).
        """
        return (peak_bin * self.rx_samples) // self.fft_size

    def bin_to_distance(self, rescaled_bin: int) -> float:
        """Reference distance formula (acceleration.cu:523).

        dis = c * ((idx / fft_size) * Fs_extend) / (2 * mu).

        Algebraically ``rescale(b)/fft_size * Fs_extend == b * Fs/fft_size``
        up to the integer-division quantization of the rescale, so this is
        the physically-correct range with the peak snapped to the pre-pad
        frequency grid.  Reproduced bit-for-bit for parity.
        """
        freq = (rescaled_bin / self.fft_size) * self.extended_sample_rate_hz
        return LIGHT_SPEED * freq / (2.0 * self.slope_hz_per_s)

    def bin_to_physical_distance(self, peak_bin: int) -> float:
        """Unquantized range for an extended-FFT peak bin.

        A zero-padded FFT keeps the sample rate: bin width = Fs/fft_size.
        """
        freq = peak_bin * self.sample_rate_hz / self.fft_size
        return LIGHT_SPEED * freq / (2.0 * self.slope_hz_per_s)

    def distance_to_beat_hz(self, range_m: float) -> float:
        """Beat frequency of a point target at ``range_m``."""
        return 2.0 * self.slope_hz_per_s * range_m / LIGHT_SPEED

    # Doppler
    @property
    def doppler_resolution_hz(self) -> float:
        return 1.0 / (self.num_chirps * self.chirp_interval_s)

    def velocity_to_doppler_hz(self, v_mps: float) -> float:
        return 2.0 * v_mps / self.wavelength_m


DEFAULT_CONFIG = RadarConfig()
