"""The mega ops: raw int16 frames -> compact detection tensors (kernel
1), or -> power and CFAR threshold maps (kernel 2).

Port of ``radar_tpu/ops/pallas/megakernel.py``:

* the detect op (``_mega_detect_kernel``, entry
  ``detections_from_shorts_pallas``): range DFT -> clutter removal ->
  TDM demux -> Doppler DFT -> power -> CA / GOCA / SOCA CFAR -> top-K ->
  neighbour samples -> AoA snapshots;
* the maps op (``_mega_kernel``, entries ``power_from_shorts_pallas``
  and ``power_cfar_from_shorts_pallas``): the same front end up to the
  power map, plus, in its with-CFAR form, the CA / GOCA / SOCA
  threshold map (OS-CFAR, as in the JAX package, runs on the power maps
  through ``ops/cuda/oscfar.py``);
* ``snapshots_from_shorts``, the maps path's AoA snapshots recomputed
  from the raw frames at the detected cells (the JAX package leaves it
  to XLA): on the card one launch of ``ops/cuda/snapshots.py``'s maps
  snapshots kernel, or with ``exact=True`` its float64 range rows in a
  kernel of their own and the rest in plain PyTorch; on the CPU plain
  PyTorch.

Each op has a ``*_cuda`` wrapper that launches the CUDA kernel
(``csrc/megakernel.cu``; design and bounds are noted there) and counts
its launches (the counters ``launches.detect`` for the detect op and
``launches.maps`` for the maps op, ``utils.spans``), a ``*_reference``
plain PyTorch version built from the stage modules (``ops/fuseddft.py``, ``ops/cfar.py``), and a
dispatcher that chooses by tensor device only: CPU tensors get the
plain version, CUDA tensors the kernel.  There is no fallback from a
kernel to its plain version.

The kernels' two DFT stages run at the tier of ``cfg.dft_precision``
(:func:`dft_passes`, the JAX package's tiers in TF32 instead of bf16):
'highest' in plain f32 on the CUDA cores; 'high' as three split-TF32
passes on the tensor cores (hi*lo + lo*hi + hi*hi, each product to
about 2^-21); 'default' as one pass (hi*hi, about 2^-11).  At those two
tiers the range stage, shared by kernels 1, 2 and 8, is an f32 FFT
(``csrc/range_fft.cu``) wherever :func:`range_fft_taken` says so, which
keeps both tiers' promises at a fraction of the products' work; its
launches are counted in ``launches.range_fft``, and
:func:`range_fft_reference` is its plain version.  Clutter 'mean' adds
one pass after the range stage, ``chirp_mean_kernel``, counted in
``launches.chirp_mean`` (:func:`count_chirp_mean`).  The plain versions
compute in f32 at every tier; ``ops/tf32.py`` emulates the tensor-core
products for the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from radar_tpu_torch.config import DEFAULT_CONFIG, RadarConfig
from radar_tpu_torch.golden import window_fn
from radar_tpu_torch.ops.cells import gather_snapshots, neighbour_samples
from radar_tpu_torch.ops.cfar import cfar_detect
from radar_tpu_torch.ops.cuda import layout
from radar_tpu_torch.ops.cuda._launch import (
    F32,
    I32,
    I64,
    PTR,
    check,
    check_aligned,
    declare,
    launch,
    ptr,
    require_cuda,
    selection_buffers,
    traced,
)
from radar_tpu_torch.ops.cuda.cfar import threshold_args, threshold_smem
from radar_tpu_torch.ops.cuda.snapshots import (
    maps_snapshots_cuda,
    snapshot_rows,
)
from radar_tpu_torch.ops.cuda.topk import top_k_sorted
from radar_tpu_torch.ops.dftmat import _dft_factors, dft_matrix
from radar_tpu_torch.ops.fuseddft import (
    _interleaved_range_factors,
    base_raw_interleave,
    doppler_from_range_planes,
    fused_range_planes,
    interleaved_range_matrices,
)
from radar_tpu_torch.ops.preproc import declutter_planes, mti_clutter_removal
from radar_tpu_torch.ops.window import resolve_window
from radar_tpu_torch.utils import spans

K_MAX = 128         # the TPU kernel's selection width (_K_LANE); kept as the gate

# cfg.dft_precision -> the kernels' ``passes`` argument: 0 the SIMT f32
# kernels, else the tensor-core kernels with that many TF32 passes
_PASSES = {"highest": 0, "high": 3, "default": 1}


def dft_passes(cfg: RadarConfig) -> int:
    """The kernel mode of ``cfg.dft_precision``: 0 for 'highest' (the
    SIMT f32 kernels), 3 for 'high' and 1 for 'default' (split-TF32
    passes on the tensor cores).  Raises for any other tier."""
    try:
        return _PASSES[cfg.dft_precision]
    except KeyError:
        raise ValueError(
            f"dft_precision must be one of {tuple(_PASSES)}, not "
            f"{cfg.dft_precision!r}") from None


# the FFT range kernel's largest R (csrc/range_fft.cu kFftMaxLog2): a
# row's team of R / 16 threads fits one warp
RANGE_FFT_MAX = 512


def range_fft_taken(cfg: RadarConfig) -> bool:
    """Whether the range stage of kernels 1, 2 and 8 runs as the f32 FFT
    kernel (``csrc/range_fft.cu``): at the tensor-core tiers ('high',
    'default') where R is at most :data:`RANGE_FFT_MAX`.  'highest'
    keeps the f32 product ``range_gemm_kernel``, which reproduces the
    JAX package's HIGHEST; longer rows keep ``range_tc_kernel``.  The
    one place the choice is made: the wrappers pass it to the C entries
    as their ``range_fft`` argument."""
    return dft_passes(cfg) != 0 and cfg.range_fft_size <= RANGE_FFT_MAX


def range_fft_tables(cfg: RadarConfig) -> tuple[np.ndarray, np.ndarray]:
    """The FFT range kernel's tables, f32: the window (S,), ``a2[i_col(t),
    0]`` of :func:`mega_constants` bit for bit (the f32 taps of
    ``resolve_window``'s kind), and the twiddles (R, 2), ``exp(-2 pi i n
    / R)`` in float64 rounded once, as (re, im) pairs."""
    window = window_fn(cfg.num_samples, resolve_window(True, cfg))
    r_size = cfg.range_fft_size
    tw = np.exp(-2j * np.pi * np.arange(r_size) / r_size)
    return (window.astype(np.float32),
            np.ascontiguousarray(np.stack([tw.real, tw.imag], axis=-1),
                                 np.float32))


def range_fft_reference(shorts: torch.Tensor, base_cube, cfg: RadarConfig,
                        window: bool = True):
    """The plain version of the FFT range kernel, on any device: raw
    int16 frames (..., shorts_per_frame) -> range planes (re, im), each
    f32 (..., C, V, R).  The I/Q decode of the ``(I0, I1, Q0, Q1)``
    interleave, the raw-space base subtracted in f32, the window, then
    ``torch.fft.fft`` zero-padded to R; the clutter modes as
    :func:`radar_tpu_torch.ops.fuseddft.fused_range_planes` (the kernel
    leaves 'mean' to ``chirp_mean_kernel`` and MTI to its callers)."""
    mode = cfg.effective_clutter(base_cube is not None)
    c, v, s = cfg.num_chirps, cfg.num_rx, cfg.num_samples
    raw = shorts.reshape(shorts.shape[:-1] + (c, v, 2 * s)).to(torch.float32)
    if mode == "base":
        raw = raw - base_raw_interleave(base_cube)
    t = torch.arange(s, device=raw.device)
    i_col = 4 * (t // 2) + (t % 2)
    w = torch.as_tensor(window_fn(s, resolve_window(window, cfg))
                        if window else np.ones(s), dtype=torch.float32,
                        device=raw.device)
    x = torch.complex(raw[..., i_col] * w, raw[..., i_col + 2] * w)
    z = torch.fft.fft(x, n=cfg.range_fft_size, dim=-1)
    if mode == "base":
        return z.real, z.imag
    return declutter_planes(z.real, z.imag, mode, cfg.num_tx)


def _mti_matrix(kc: int, order: int) -> np.ndarray:
    """(kc, kc) float64 circulant canceller M with ``y = M @ x`` the
    circular two/three-pulse MTI over a demuxed per-TX chirp axis
    (golden.mti_filter at stride 1): M = I - R (order 2) or I - 2R + R^2
    (order 3), R the one-step delay.  NumPy copy of
    ``radar_tpu.ops.pallas.megakernel._mti_matrix``."""
    eye = np.eye(kc)
    r1 = np.roll(eye, -1, axis=1)   # r1[c, c-1] = 1
    if order == 2:
        return eye - r1
    return eye - 2.0 * r1 + np.roll(eye, -2, axis=1)


def doppler_lhs(ft_re: np.ndarray, ft_im: np.ndarray) -> np.ndarray:
    """The packed Doppler constant of the tensor-core Doppler stage,
    (16 ceil(D / 8), 2 Kc8) f32 with Kc8 = Kc rounded up to 8, from the
    (Kc, D) ``ft_re`` / ``ft_im``: rows in groups of 16, first the Re
    rows ``[Fr | -Fi]`` of Doppler bins d..d+7, then their Im rows ``[Fi
    | Fr]``, so that one product with the stacked planes ``[Zr; Zi]``
    gives Re and Im of each cell in rows g and g + 8 of an m16 tile.  Each
    half is zero-padded to Kc8 columns, padded rows are zero.  Entries
    are ``ft_re`` / ``ft_im`` values or their negations, bit for bit."""
    kc, d = ft_re.shape
    kc8 = -(-kc // 8) * 8
    lhs = np.zeros((-(-d // 8) * 16, 2 * kc8), np.float32)
    bins = np.arange(d)
    re_rows = bins // 8 * 16 + bins % 8
    lhs[re_rows, :kc] = ft_re.T
    lhs[re_rows, kc8:kc8 + kc] = -ft_im.T
    lhs[re_rows + 8, :kc] = ft_im.T
    lhs[re_rows + 8, kc8:kc8 + kc] = ft_re.T
    return lhs


def tf32_split(x: np.ndarray) -> np.ndarray:
    """``(2,) + x.shape`` f32, ``[hi; lo]``: the TF32 split of the
    tensor-core tiers, done once on the host for their constants.  hi =
    rna(x), lo = rna(x - hi), with rna the rounding of
    ``cvt.rna.tf32.f32`` (to nearest, ties away from zero, 10 explicit
    mantissa bits): half of the 13 dropped bits added to the
    sign-magnitude pattern, then the dropped bits cleared.  For finite
    x; ``ops/tf32.split_tf32`` is the same split in torch, held equal to
    it bit for bit by the tests."""
    def rna(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    x = np.asarray(x, np.float32)
    hi = rna(x)
    return np.stack([hi, rna(x - hi)])


# the tensor-core kernels' operand tile, rows x K (csrc/megakernel.cu
# kTcBM x kTcBK)
GMMA_ROWS, GMMA_DEPTH = 128, 16


def gmma_tiles(x: np.ndarray) -> np.ndarray:
    """(R, K) f32 -> (ceil(R / 128), ceil(K / 16), 128 * 16): ``x``
    zero-padded and cut into the 128 x 16 K-major operand tiles of the
    tensor-core kernels, each in wgmma's interleaved order without
    swizzle (``csrc/megakernel.cu`` ``gmma_off``): element (r, k) of a
    tile at ((r // 8) * 4 + k // 4) * 32 + (r % 8) * 4 + k % 4, i.e. 8 x 4
    core matrices of 128 contiguous bytes."""
    rows, depth = x.shape
    nr, nk = -(-rows // GMMA_ROWS), -(-depth // GMMA_DEPTH)
    padded = np.zeros((nr * GMMA_ROWS, nk * GMMA_DEPTH), np.float32)
    padded[:rows, :depth] = x
    t = padded.reshape(nr, GMMA_ROWS // 8, 8, nk, GMMA_DEPTH // 4, 4)
    return np.ascontiguousarray(t.transpose(0, 3, 1, 4, 2, 5)).reshape(
        nr, nk, GMMA_ROWS * GMMA_DEPTH)


def mega_constants(cfg: RadarConfig = DEFAULT_CONFIG) -> dict[str, torch.Tensor]:
    """Host-built constants of the detect op, as CPU f32 tensors:

    * ``a2`` (2S, 2R): the windowed range DFT over the raw interleave,
      ``[A_re^T | A_im^T]`` so one product gives ``[zr | zi]``;
    * ``ft_re``, ``ft_im`` (Kc, D): the windowed, fftshifted Doppler DFT,
      transposed so the kernel stages its rows with 16-byte loads.  For
      ``clutter_mode`` 'mti2' / 'mti3' the canceller is folded into it,
      ``F diag(w) M``, in complex128 before the f32 cast (as the JAX
      ``_plan`` does): the kernels then run with no base and no chirp
      mean, and the snapshots, Doppler-domain values of the same
      transform, come out filtered too;
    * ``a2_split`` and ``dop_l``, the constants of the tensor-core
      tiers: :func:`tf32_split` ([hi; lo]) of ``a2`` and of
      :func:`doppler_lhs` of ``ft_re`` / ``ft_im``, each half cut by
      :func:`gmma_tiles` (``a2`` transposed, K-major): (2, ceil(2R /
      128), ceil(2S / 16), 2048) and (2, ceil(16 ceil(D / 8) / 128),
      ceil(2 Kc8 / 16), 2048);
    * ``range_window`` (S,) and ``range_twiddles`` (R, 2), the tables of
      the FFT range kernel (:func:`range_fft_tables`).
    """
    window = resolve_window(True, cfg)
    a_re, a_im = _interleaved_range_factors(cfg.num_samples,
                                            cfg.range_fft_size, window)
    f_dop = np.asarray(_dft_factors(cfg.chirps_per_tx, cfg.doppler_fft_size,
                                    window, True), np.complex128)
    if cfg.clutter_mode in ("mti2", "mti3"):
        f_dop = f_dop @ _mti_matrix(cfg.chirps_per_tx,
                                    int(cfg.clutter_mode[-1]))
    ft_re = np.ascontiguousarray(f_dop.real.T.astype(np.float32))
    ft_im = np.ascontiguousarray(f_dop.imag.T.astype(np.float32))
    a2 = np.ascontiguousarray(np.concatenate([a_re.T, a_im.T], axis=1),
                              np.float32)
    range_window, range_twiddles = range_fft_tables(cfg)
    return {
        "a2": torch.from_numpy(a2),
        "a2_split": torch.from_numpy(
            np.stack([gmma_tiles(h.T) for h in tf32_split(a2)])),
        "ft_re": torch.from_numpy(ft_re),
        "ft_im": torch.from_numpy(ft_im),
        "dop_l": torch.from_numpy(np.stack(
            [gmma_tiles(h) for h in tf32_split(doppler_lhs(ft_re, ft_im))])),
        "range_window": torch.from_numpy(range_window),
        "range_twiddles": torch.from_numpy(range_twiddles),
    }


def detections_from_shorts(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    k: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    consts: dict[str, torch.Tensor] | None = None,
):
    """Raw int16 frames -> (top_idx, top_val, nbr, num_hits, snaps).

    Returns:
      top_idx  int32     (..., K) flat D*R cell index, lax.top_k order
        (exhausted slots hold the untaken indices in ascending order);
      top_val  float32   (..., K) detection power, -inf where exhausted;
      nbr      float32   (..., K, 5) power at [centre, range-1, range+1,
        doppler-1, doppler+1] (range clamped, Doppler wrapped);
      num_hits int32     (...,) CFAR hit count;
      snaps    complex64 (..., K, TX*V) virtual-RX snapshots, before
        MIMO compensation.

    CPU tensors take the plain version; CUDA tensors the kernel.
    """
    if shorts.device.type == "cpu":
        return detections_from_shorts_reference(shorts, base_cube, k, cfg)
    return detections_from_shorts_cuda(shorts, base_cube, k, cfg, consts)


def detections_from_shorts_reference(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    k: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
):
    """The plain PyTorch version of the kernel, on any device: the same
    six outputs from the maps (fused range + Doppler planes, the
    strip-form CA / GO / SO CFAR of ``cfg.cfar_kind``, stable-sort top-K,
    gathers)."""
    x = shorts.reshape(-1, cfg.shorts_per_frame)
    dr, di = doppler_from_range_planes(*fused_range_planes(x, base_cube, cfg),
                                       cfg)
    power = (dr * dr + di * di).sum(dim=-3)            # (B, D, R)
    return detections_from_maps(power, dr, di, k, cfg, shorts.shape[:-1])


def detections_from_maps(power, dr, di, k: int, cfg: RadarConfig,
                         lead=None):
    """The detect op's six outputs from power maps (B, D, R) and the RD
    planes (B, TX*V, D, R) that the snapshots are gathered from: the
    strip-form CFAR of ``cfg.cfar_kind``, the range-edge guard,
    stable-sort top-K and the gathers; lead dims ``lead`` (default
    (B,))."""
    lead = (len(power),) if lead is None else tuple(lead)
    hits = power > _threshold_reference(power, cfg)
    r_size = cfg.range_fft_size
    r_idx = torch.arange(r_size, device=power.device)
    hits = hits & (r_idx < r_size - cfg.range_edge_guard_effective)
    num_hits = hits.sum(dim=(-2, -1)).to(torch.int32)
    masked = torch.where(hits, power, float("-inf"))
    top_val, top_idx = top_k_sorted(masked.reshape(len(power), -1), k)
    nbr = neighbour_samples(power, top_idx, top_idx // r_size,
                            top_idx % r_size)
    snaps = torch.complex(gather_snapshots(dr, top_idx),
                          gather_snapshots(di, top_idx))
    return (top_idx.reshape(lead + (k,)), top_val.reshape(lead + (k,)),
            nbr.reshape(lead + (k, 5)), num_hits.reshape(lead),
            snaps.reshape(lead + snaps.shape[-2:]))


def _tiles_shape(rows: int, depth: int) -> tuple:
    """Shape of a split constant cut by :func:`gmma_tiles`."""
    return (2, -(-rows // GMMA_ROWS), -(-depth // GMMA_DEPTH),
            GMMA_ROWS * GMMA_DEPTH)


def check_range_consts(consts, cfg: RadarConfig, dev) -> None:
    """The range stage's constants in ``consts``: ``a2`` (2S, 2R),
    ``a2_split``, ``range_window`` (S,) and ``range_twiddles`` (R, 2)
    (:func:`mega_constants`), f32 on ``dev``, 16-byte aligned (the
    kernels read them in 16-byte chunks)."""
    s2, r2 = 2 * cfg.num_samples, 2 * cfg.range_fft_size
    check("a2", consts["a2"], torch.float32, (s2, r2), dev)
    check("a2_split", consts["a2_split"], torch.float32,
          _tiles_shape(r2, s2), dev)
    check("range_window", consts["range_window"], torch.float32,
          (cfg.num_samples,), dev)
    check("range_twiddles", consts["range_twiddles"], torch.float32,
          (cfg.range_fft_size, 2), dev)
    for name in ("a2", "a2_split", "range_window", "range_twiddles"):
        check_aligned(name, consts[name])


def range_stage_args(consts, cfg: RadarConfig) -> tuple:
    """The range stage's arguments of the three C entries, in order: the
    pointers ``a2``, ``a2_split``, ``range_window``, ``range_twiddles``
    (after the base), and the flag ``range_fft`` (after ``passes``), of
    :func:`range_fft_taken`."""
    return ([ptr(consts[n]) for n in ("a2", "a2_split", "range_window",
                                      "range_twiddles")],
            int(range_fft_taken(cfg)))


def count_range_fft(cfg: RadarConfig, n_frames: int) -> None:
    """Count one launch of the FFT range kernel (``launches.range_fft``)
    where an entry's call over ``n_frames`` frames ran it."""
    if n_frames and range_fft_taken(cfg):
        spans.count("launches.range_fft")


def count_chirp_mean(mode: str, n_frames: int) -> None:
    """Count one launch of ``chirp_mean_kernel`` (``launches.chirp_mean``)
    where an entry's call over ``n_frames`` frames ran it: clutter
    ``mode`` 'mean', whose pass follows the range stage of kernels 1, 2
    and 8."""
    if n_frames and mode == "mean":
        spans.count("launches.chirp_mean")


def _front_end_args(shorts, base_cube, cfg: RadarConfig, consts, what):
    """Checks shared by the two mega kernels' wrappers; returns (frames
    (B, shorts_per_frame), base in the raw interleave or None, consts,
    clutter mode).  ``consts`` must be ``mega_constants(cfg)``'s (under
    MTI the folded Doppler constant; RDPipeline's buffers are)."""
    require_cuda(shorts, what, f"{what}_reference")
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    if s2 % 8 or r_size % 4 or d_size % 4:
        raise NotImplementedError(
            f"the mega kernels stage rows with 16-byte loads: num_samples "
            f"({cfg.num_samples}), range_fft_size ({r_size}) and "
            f"doppler_fft_size ({d_size}) must be multiples of 4"
        )
    mode = cfg.effective_clutter(base_cube is not None)
    dev = shorts.device
    x = shorts.reshape(-1, cfg.shorts_per_frame)
    check("shorts", x, torch.int16, (x.shape[0], cfg.shorts_per_frame), dev)
    check_aligned("shorts", x)
    if consts is None:
        consts = {n: t.to(dev) for n, t in mega_constants(cfg).items()}
    check_range_consts(consts, cfg, dev)
    for name in ("ft_re", "ft_im"):
        check(name, consts[name], torch.float32,
              (cfg.chirps_per_tx, d_size), dev)
    check("dop_l", consts["dop_l"], torch.float32,
          _tiles_shape(-(-d_size // 8) * 16,
                       2 * (-(-cfg.chirps_per_tx // 8) * 8)), dev)
    check_aligned("dop_l", consts["dop_l"])
    base_raw = None
    if mode == "base":
        check("base_cube", base_cube, torch.complex64,
              (v, c, cfg.num_samples), dev, contiguous=False)
        base_raw = base_raw_interleave(base_cube).reshape(c * v, s2)
    return x, base_raw, consts, mode, dft_passes(cfg)


def _detect_gate(cfg: RadarConfig, k: int, n_frames: int = 1) -> int:
    """Raise NotImplementedError where the detect kernel does not take
    ``k`` or the geometry (its band block's shared memory); returns the
    scratch words of ``n_frames`` frames."""
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    if not 1 <= k <= min(K_MAX, d_size * r_size):
        raise NotImplementedError(
            f"max_detections {k} outside the detect kernel's 1..{K_MAX}; "
            "RDPipeline takes the maps path there"
        )
    smem, words = layout.detect_layout(
        d_size, r_size, cfg.cfar_guard[0] + cfg.cfar_train[0],
        cfg.cfar_guard[1] + cfg.cfar_train[1], k, n_frames)
    layout.check_smem("detect kernel", smem, d_size, r_size)
    return words


declare("radar_mega_detect",
        [PTR] * 13         # raw, base_raw, a2, a2s, window, twiddles,
                           # ft_re, ft_im, dop_l, z, power, tickets, work
        + [I64]            # work words
        + [PTR] * 5        # top_idx, top_val, nbr, num_hits, snaps
        + [I32] * 18       # geometry, clutter, passes, range_fft, CFAR
                           # kind and window integers
        + [F32])           # coef


@traced("detect")
def detections_from_shorts_cuda(
    shorts: torch.Tensor,
    base_cube: torch.Tensor | None,
    k: int,
    cfg: RadarConfig = DEFAULT_CONFIG,
    consts: dict[str, torch.Tensor] | None = None,
):
    """:func:`detections_from_shorts` through the CUDA kernel.  Raises
    for a tensor that is not on a CUDA device, for a geometry the kernel
    does not take, when the build fails and when a launch fails."""
    kind = _map_kind(cfg)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    d_size, r_size, tx = cfg.doppler_fft_size, cfg.range_fft_size, cfg.num_tx
    x, base_raw, consts, mode, passes = _front_end_args(
        shorts, base_cube, cfg, consts, "detections_from_shorts")
    dev = shorts.device
    lead = shorts.shape[:-1]
    b = x.shape[0]
    words = _detect_gate(cfg, k, b)
    kind_id, range_wrap, gd, gr, wd, wr, coef = threshold_args(cfg, kind)

    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty((b * c * v, 2 * r_size), **f32)
    power = torch.empty((b, d_size, r_size), **f32)
    top_idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    top_val = torch.empty((b, k), **f32)
    nbr = torch.empty((b, k, 5), **f32)
    num_hits = torch.empty((b,), dtype=torch.int32, device=dev)
    snaps = torch.empty((b, k, tx * v, 2), **f32)
    tickets, work = selection_buffers(dev, b, words)
    range_ptrs, range_fft = range_stage_args(consts, cfg)

    launch("radar_mega_detect", dev,
           ptr(x), ptr(base_raw), *range_ptrs,
           ptr(consts["ft_re"]), ptr(consts["ft_im"]), ptr(consts["dop_l"]),
           ptr(z), ptr(power), ptr(tickets), ptr(work), words,
           ptr(top_idx), ptr(top_val), ptr(nbr),
           ptr(num_hits), ptr(snaps),
           b, c, v, tx, s2, r_size, d_size, k, int(mode == "mean"), passes,
           range_fft, kind_id, range_wrap, gd, gr, wd, wr,
           r_size - cfg.range_edge_guard_effective, coef)
    spans.count("launches.detect")
    count_range_fft(cfg, b)
    count_chirp_mean(mode, b)
    return (top_idx.reshape(lead + (k,)), top_val.reshape(lead + (k,)),
            nbr.reshape(lead + (k, 5)), num_hits.reshape(lead),
            torch.view_as_complex(snaps).reshape(lead + (k, tx * v)))


# ---------------------------------------------------------------------------
# the maps op (kernel 2)


def power_from_shorts(shorts, base_cube, cfg: RadarConfig = DEFAULT_CONFIG,
                      consts=None) -> torch.Tensor:
    """Raw int16 frames (..., shorts_per_frame) -> power maps f32
    (..., D, R), Doppler fftshifted, summed over the virtual channels.
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if shorts.device.type == "cpu":
        return power_from_shorts_reference(shorts, base_cube, cfg)
    return power_from_shorts_cuda(shorts, base_cube, cfg, consts)


def power_cfar_from_shorts(shorts, base_cube,
                           cfg: RadarConfig = DEFAULT_CONFIG, consts=None):
    """(power, threshold) f32 (..., D, R): :func:`power_from_shorts`
    plus the CFAR threshold of ``cfg.cfar_kind`` ('ca', 'goca' or
    'soca'); hits are ``power > threshold``.  CPU tensors take the plain
    version; CUDA tensors the kernel."""
    if shorts.device.type == "cpu":
        return power_cfar_from_shorts_reference(shorts, base_cube, cfg)
    return power_cfar_from_shorts_cuda(shorts, base_cube, cfg, consts)


def power_from_shorts_reference(shorts, base_cube,
                                cfg: RadarConfig = DEFAULT_CONFIG):
    """The plain version of the maps op's power map, on any device."""
    dr, di = doppler_from_range_planes(
        *fused_range_planes(shorts, base_cube, cfg), cfg)
    return (dr * dr + di * di).sum(dim=-3)


def power_cfar_from_shorts_reference(shorts, base_cube,
                                     cfg: RadarConfig = DEFAULT_CONFIG):
    """The plain version of the maps op's with-CFAR form, on any
    device: the power map and the strip-form CA / GO / SO threshold."""
    power = power_from_shorts_reference(shorts, base_cube, cfg)
    return power, _threshold_reference(power, cfg)


def _map_kind(cfg: RadarConfig) -> str:
    """``cfg.cfar_kind`` where the mega ops compute its threshold
    (ca / goca / soca); raises for 'os', as the JAX kernels do: OS-CFAR
    runs on the maps op's power maps (``ops/cuda/oscfar.py``)."""
    if cfg.cfar_kind not in ("ca", "goca", "soca"):
        raise ValueError(
            f"the mega ops' CFAR takes ca/goca/soca, not {cfg.cfar_kind!r} "
            "(OS runs on the power maps: RDPipeline takes the maps path)"
        )
    return cfg.cfar_kind


def _threshold_reference(power: torch.Tensor, cfg: RadarConfig):
    """The plain CA / GO / SO threshold map of ``cfg.cfar_kind``."""
    _map_kind(cfg)
    return cfar_detect(power, cfg, "xla")[1]


def power_from_shorts_cuda(shorts, base_cube,
                           cfg: RadarConfig = DEFAULT_CONFIG, consts=None):
    """:func:`power_from_shorts` through the CUDA kernel."""
    return _maps_cuda(shorts, base_cube, cfg, consts, with_cfar=False)


def power_cfar_from_shorts_cuda(shorts, base_cube,
                                cfg: RadarConfig = DEFAULT_CONFIG,
                                consts=None):
    """:func:`power_cfar_from_shorts` through the CUDA kernel."""
    return _maps_cuda(shorts, base_cube, cfg, consts, with_cfar=True)


declare("radar_mega_maps",
        [PTR] * 12         # raw, base_raw, a2, a2s, window, twiddles,
                           # ft_re, ft_im, dop_l, z, power, thresh
        + [I32] * 16       # geometry, clutter, passes, range_fft, CFAR
                           # kind and window
        + [F32])           # coef


@traced("maps")
def _maps_cuda(shorts, base_cube, cfg, consts, with_cfar):
    """The maps kernel: raises for a tensor that is not on a CUDA
    device, for a geometry it does not take, when the build fails and
    when a launch fails."""
    kind = _map_kind(cfg) if with_cfar else "ca"
    d_size, r_size = cfg.doppler_fft_size, cfg.range_fft_size
    if with_cfar:
        layout.check_smem("maps kernel's CFAR",
                          threshold_smem(d_size, r_size, cfg), d_size, r_size)
    x, base_raw, consts, mode, passes = _front_end_args(
        shorts, base_cube, cfg, consts, "power_from_shorts")
    dev = shorts.device
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    b = x.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    z = torch.empty((b * c * v, 2 * r_size), **f32)
    power = torch.empty((b, d_size, r_size), **f32)
    thresh = torch.empty((b, d_size, r_size), **f32) if with_cfar else None
    range_ptrs, range_fft = range_stage_args(consts, cfg)
    launch("radar_mega_maps", dev,
           ptr(x), ptr(base_raw), *range_ptrs,
           ptr(consts["ft_re"]), ptr(consts["ft_im"]), ptr(consts["dop_l"]),
           ptr(z), ptr(power), ptr(thresh), b, c, v, cfg.num_tx, s2, r_size,
           d_size, int(mode == "mean"), passes, range_fft,
           *threshold_args(cfg, kind))
    spans.count("launches.maps")
    count_range_fft(cfg, b)
    count_chirp_mean(mode, b)
    shape = shorts.shape[:-1] + (d_size, r_size)
    if not with_cfar:
        return power.reshape(shape)
    return power.reshape(shape), thresh.reshape(shape)


def snapshots_from_shorts(shorts, base_cube, top_idx,
                          cfg: RadarConfig = DEFAULT_CONFIG,
                          window=True, exact: bool = False) -> torch.Tensor:
    """Per-detection virtual-RX snapshots recomputed from the raw frames
    (port of the JAX function of this name; on CUDA tensors with
    ``exact=False`` one launch of the maps snapshots kernel, with
    ``exact=True`` the float64 range rows through the snapshot rows
    kernel, both ``ops/cuda/snapshots.py``; plain PyTorch on the CPU and
    around the rows kernel):

        snap[b, k, t*V + v] = sum_kc F_dop[d_k, kc] * rng[b, kc, t, v, r_k]

    where rng is the clutter-removed range plane at the detected range
    bin: K gathered range-DFT rows contracted with the raw frames, then
    clutter removal ('base', 'mean', or the MTI canceller along the
    chirps, which commutes with gathering at a range bin), the TDM demux
    and K gathered Doppler-DFT rows.  The base is subtracted in raw space, as on every
    range path of the port.

    Args:
      shorts: int16 (..., shorts_per_frame); top_idx: int (..., K) flat
        D*R cell index.
      exact: run the range-row products in float64 (the int16 frames
        convert exactly), so no TF32 switch reaches them: the angle
        refiners, which the JAX package holds at HIGHEST, ask for it.

    Returns:
      complex64 (..., K, TX*V), in the order of gathering from
      ``fused_rd_planes``, before MIMO compensation.
    """
    if exact or shorts.device.type != "cuda":
        return snapshots_from_shorts_reference(shorts, base_cube, top_idx,
                                               cfg, window, exact)
    mode = cfg.effective_clutter(base_cube is not None)
    window = resolve_window(window, cfg)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    k = top_idx.shape[-1]
    frames = shorts.reshape(-1, c, v, s2)
    if (frames.stride()[1:] != (v * s2, s2, 1) or frames.stride(0) % 8
            or frames.data_ptr() % 16):
        frames = frames.contiguous()
    if top_idx.dtype not in (torch.int32, torch.int64):
        top_idx = top_idx.to(torch.int64)
    snaps = maps_snapshots_cuda(
        frames,
        base_cube.to(torch.complex64).contiguous() if mode == "base"
        else None,
        top_idx.reshape(frames.shape[0], k).contiguous(),
        *interleaved_range_matrices(cfg.num_samples, cfg.range_fft_size,
                                    window, shorts.device),
        dft_matrix(cfg.chirps_per_tx, cfg.doppler_fft_size, window, True,
                   shorts.device),
        cfg.num_tx, mode)
    return snaps.reshape(shorts.shape[:-1] + (k, cfg.num_virtual_rx))


def snapshots_from_shorts_reference(shorts, base_cube, top_idx,
                                    cfg: RadarConfig = DEFAULT_CONFIG,
                                    window=True,
                                    exact: bool = False) -> torch.Tensor:
    """The plain version of :func:`snapshots_from_shorts`, on any
    device: the range rows in float32 (``exact=False``) or float64
    (``ops/cuda/snapshots.snapshot_rows``, on the card the rows kernel),
    then the clutter step, the TDM demux and the Doppler-row products in
    float32 torch."""
    mode = cfg.effective_clutter(base_cube is not None)
    window = resolve_window(window, cfg)
    c, v, s2 = cfg.num_chirps, cfg.num_rx, 2 * cfg.num_samples
    kc, tx, r_size = cfg.chirps_per_tx, cfg.num_tx, cfg.range_fft_size
    lead = shorts.shape[:-1]
    k = top_idx.shape[-1]
    raw = shorts.reshape(-1, c * v, s2)
    base_raw = (base_raw_interleave(base_cube).reshape(c * v, s2)
                if mode == "base" else None)
    top_idx = top_idx.reshape(-1, k).to(torch.int64)
    d_bin = top_idx // r_size
    # range planes at the detected bins: (B, K, C*V); in float64 on the
    # card one launch of the snapshots kernel (ops/cuda/snapshots.py)
    g_re, g_im = snapshot_rows(raw, base_raw, top_idx,
                               *interleaved_range_matrices(
                                   cfg.num_samples, r_size, window,
                                   raw.device), exact=exact)
    b = raw.shape[0]
    g_re = g_re.reshape(b, k, c, v)
    g_im = g_im.reshape(b, k, c, v)
    if mode == "mean":
        g_re = g_re - g_re.mean(dim=2, keepdim=True)
        g_im = g_im - g_im.mean(dim=2, keepdim=True)
    elif mode != "base":
        order = int(mode[-1])
        g_re = mti_clutter_removal(g_re, order, axis=2, stride=tx)
        g_im = mti_clutter_removal(g_im, order, axis=2, stride=tx)
    # TDM demux (chirp = kc*TX + tx), then the detection's Doppler row
    g_re = g_re.reshape(b, k, kc, tx * v)
    g_im = g_im.reshape(b, k, kc, tx * v)
    f_dop = dft_matrix(kc, cfg.doppler_fft_size, window, True, raw.device)
    fr = f_dop.real[d_bin][..., None]                  # (B, K, Kc, 1)
    fi = f_dop.imag[d_bin][..., None]
    sr = (fr * g_re - fi * g_im).sum(dim=-2)
    si = (fr * g_im + fi * g_re).sum(dim=-2)
    return torch.complex(sr, si).reshape(lead + (k, tx * v))
