"""The split-TF32 tiers of the port's front end (``dft_precision`` 'high'
and 'default'), on the CPU: the CUDA kernels run only on a GPU, where
``chip_smoke.py`` holds them against the plain versions.

* ``ops/tf32.py``: ``tf32_round`` rounds to nearest with ties away from
  zero (``cvt.rna.tf32.f32``); every int16 splits exactly into hi + lo.
* The packed Doppler constant of the tensor-core Doppler stage is
  ``mega_constants``'s ``ft_re`` / ``ft_im`` rearranged bit for bit; the
  host's NumPy split (``megakernel.tf32_split``) equals ``split_tf32``;
  ``gmma_tiles`` cuts a matrix into wgmma's K-major tiles and pads with
  zeros; the split constants the kernels read (``a2_split``, ``dop_l``)
  are ``split_tf32`` of the original constants, bit for bit, so cut.
* The emulated tiers (``testing.tier_planes`` / ``tier_power``, the
  kernels' products exactly in f32): at the default geometry the 3-pass
  power map is within 1e-5 of the float64 golden relative to each map's
  peak (at most 4.2e-7 measured), the 1-pass map within 1e-3 (at most
  3.2e-4);
  the 3-pass detection sets equal the JAX package's 'high' pipeline's
  and, on several geometries and clutter modes, the f32 plain version's.
* ``dft_passes`` maps each tier to its kernel mode; each C entry of
  ``csrc/`` is declared by its wrapper with its C signature's types.
"""

import ctypes
import importlib
import pkgutil
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from radar_tpu.config import RadarConfig as JaxConfig  # noqa: E402
from radar_tpu.io.synthetic import SceneTarget, synthesize_capture  # noqa: E402
from radar_tpu.models import rd_pipeline as jax_rd  # noqa: E402
from radar_tpu_torch import _build  # noqa: E402
from radar_tpu_torch.config import RadarConfig  # noqa: E402
from radar_tpu_torch.convert import config_from_jax, result_to_numpy  # noqa: E402
from radar_tpu_torch.models.rd_pipeline import (  # noqa: E402
    RDPipeline,
    assemble_result_from_kernel,
)
from radar_tpu_torch.ops import cuda as cuda_ops  # noqa: E402
from radar_tpu_torch.ops.cuda._launch import (  # noqa: E402
    F32,
    I32,
    I64,
    PTR,
    SIGNATURES,
)
from radar_tpu_torch.ops.cuda.megakernel import (  # noqa: E402
    detections_from_shorts_reference,
    dft_passes,
    doppler_lhs,
    GMMA_DEPTH,
    gmma_tiles,
    mega_constants,
    power_from_shorts_reference,
    tf32_split,
)
from radar_tpu_torch.ops.tf32 import (  # noqa: E402
    split_matmul,
    split_tf32,
    tf32_round,
)
from radar_tpu_torch.testing import (  # noqa: E402
    TIER_UNIT,
    compare,
    golden_power,
    maps_check,
    run_detect,
    tier_detections,
    tier_planes,
    tier_power,
)

TARGETS = [
    SceneTarget(range_m=3.0, velocity_mps=2.0, azimuth_deg=20.0,
                amplitude=2500.0),
    SceneTarget(range_m=8.0, velocity_mps=-4.0, azimuth_deg=-35.0,
                amplitude=1500.0),
]
LOW13 = 0x1FFF


def bits(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def f32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32))


# -- tf32_round, split_tf32 -------------------------------------------------

@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),           # tie: away (RNE: 1.0)
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),     # ... from zero, both signs
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),           # just under the tie
    (1.0 + 2.0 ** -11 + 2.0 ** -23, 1.0 + 2.0 ** -10),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),        # tie above an odd value
    (2.0 - 2.0 ** -11, 2.0),                         # the carry into the exponent
    (-(2.0 - 2.0 ** -11), -2.0),
    (2.0 ** -130, 2.0 ** -130),                      # a subnormal on the grid
    (2.0 ** -149, 0.0),                              # rounds to zero
    (0.0, 0.0),
    (65535.0, 65536.0),                              # 16 bits: one too many
    (2047.0, 2047.0),                                # 11 bits: exact
])
def test_tf32_round_ties_and_boundaries(x, want):
    got = tf32_round(f32([x]))
    assert got.item() == np.float32(want)
    assert bits(got)[0] & LOW13 == 0


def test_tf32_round_specials_and_sign_of_zero():
    x = f32([np.inf, -np.inf, np.nan, -0.0])
    got = tf32_round(x)
    assert got[0].item() == np.inf and got[1].item() == -np.inf
    assert np.isnan(got[2].item())
    assert bits(got)[3] == 0x80000000                # -0 stays -0


def test_tf32_round_is_nearest_on_random_values():
    """hi keeps its low 13 bits zero, lies within half a TF32 ulp
    (2^-11 relative) and is one of the two grid values around x."""
    rng = np.random.default_rng(0)
    x = f32(rng.standard_normal(4096) * 10.0 ** rng.uniform(-20, 20, 4096))
    hi = tf32_round(x)
    assert not (bits(hi) & LOW13).any()
    xd, hd = x.double(), hi.double()
    assert ((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all()
    down = torch.from_numpy((bits(x) & ~LOW13).astype(np.uint32)
                            .view(np.int32)).view(torch.float32).double()
    step = 2.0 ** (torch.floor(torch.log2(xd.abs())) - 10)
    up = down + torch.sign(xd) * step
    assert ((hd == down) | (hd == up)).all()


def test_split_tf32_residual_bound():
    rng = np.random.default_rng(1)
    x = f32(rng.standard_normal(4096) * 1e3)
    hi, lo = split_tf32(x)
    assert not (bits(hi) & LOW13).any() and not (bits(lo) & LOW13).any()
    assert torch.equal(x - hi, (x.double() - hi.double()).float())  # exact
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


def test_every_int16_splits_exactly():
    """11 + 11 significant bits cover the 16 of every int16: hi + lo is
    the value itself for all 65,536 of them."""
    x = torch.arange(-32768, 32768, dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert not (bits(hi) & LOW13).any() and not (bits(lo) & LOW13).any()
    np.testing.assert_array_equal(hi.double().numpy() + lo.double().numpy(),
                                  x.double().numpy())


@pytest.mark.parametrize("passes", [1, 3])
def test_split_matmul_products_are_exact(passes):
    """On operands already on the TF32 grid with few bits, every product
    and sum is exact, so the emulation equals the float64 product."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(-64, 64, (16, 24)).astype(np.float32))
    a = torch.from_numpy(rng.integers(-64, 64, (24, 8)).astype(np.float32))
    np.testing.assert_array_equal(split_matmul(x, a, passes).double().numpy(),
                                  x.double().numpy() @ a.double().numpy())


def test_split_matmul_refuses_other_pass_counts():
    with pytest.raises(ValueError, match="passes 1 or 3"):
        split_matmul(torch.ones(2, 2), torch.ones(2, 2), 2)


# -- the host constants -----------------------------------------------------

CONST_CASES = {
    "base": dict(),
    "mean": dict(clutter_mode="mean"),
    "mti2": dict(clutter_mode="mti2"),
    "mti3": dict(clutter_mode="mti3"),
    "tx2-kc20": dict(num_samples=48, num_chirps=40, num_rx=2, num_tx=2),
}


@pytest.mark.parametrize("case", sorted(CONST_CASES))
def test_packed_doppler_constant_is_ft_bit_for_bit(case):
    """doppler_lhs's Re rows are [Fr | -Fi] and its Im rows [Fi | Fr] of
    the same Doppler bins, each half zero-padded to Kc8 columns and the
    rows to 16 ceil(D / 8): values of ft_re / ft_im, bit for bit."""
    cfg = RadarConfig(**CONST_CASES[case])
    c = mega_constants(cfg)
    fr, fi = c["ft_re"].numpy(), c["ft_im"].numpy()
    lhs = doppler_lhs(fr, fi)
    kc, d = fr.shape
    kc8 = -(-kc // 8) * 8
    assert lhs.shape == (-(-d // 8) * 16, 2 * kc8) and lhs.dtype == np.float32
    rows = np.arange(d) // 8 * 16 + np.arange(d) % 8
    for got, want in ((lhs[rows, :kc], fr.T), (lhs[rows, kc8:kc8 + kc], -fi.T),
                      (lhs[rows + 8, :kc], fi.T),
                      (lhs[rows + 8, kc8:kc8 + kc], fr.T)):
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    used = np.zeros(lhs.shape, bool)
    used[np.r_[rows, rows + 8][:, None],
         np.r_[np.arange(kc), kc8 + np.arange(kc)][None, :]] = True
    assert not lhs[~used].any()


def untile(t: np.ndarray, rows: int, depth: int) -> np.ndarray:
    """The (rows, depth) matrix of gmma_tiles' output ``t``, read from the
    layout the kernels assume (csrc/megakernel.cu gmma_off, with kK =
    GMMA_DEPTH): element (r, k) of tile (r // 128, k // kK) at
    ((r % 128 // 8) * (kK // 4) + k % kK // 4) * 32 + r % 8 * 4 + k % 4."""
    kk = GMMA_DEPTH
    r, k = np.arange(rows)[:, None], np.arange(depth)[None, :]
    off = (r % 128 // 8 * (kk // 4) + k % kk // 4) * 32 + r % 8 * 4 + k % 4
    return t[r // 128, k // kk, off]


def test_host_tile_depth_is_the_kernels():
    """gmma_tiles cuts the constants as deep as the kernels' K tile."""
    text = (Path(_build.CSRC_DIR) / "megakernel.cu").read_text()
    bm, bk = re.search(r"kTcBM = (\d+), kTcBN = \d+, kTcBK = (\d+);",
                       text).groups()
    assert (int(bm), int(bk)) == (128, GMMA_DEPTH)


@pytest.mark.parametrize("shape", [(20, 40), (128, 32), (256, 200),
                                   (129, 33)])
def test_gmma_tiles_layout_and_padding(shape):
    """Each element lands where the kernels' gmma_off reads it, and
    everything else in the tiles is zero padding."""
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    t = gmma_tiles(x)
    assert t.shape == (-(-shape[0] // 128), -(-shape[1] // GMMA_DEPTH),
                       128 * GMMA_DEPTH)
    np.testing.assert_array_equal(untile(t, *shape), x)
    assert np.count_nonzero(t) == np.count_nonzero(x)


@pytest.mark.parametrize("case", sorted(CONST_CASES))
def test_host_split_constants_equal_split_of_originals(case):
    """The split constants the kernels read: a2_split is split_tf32 of
    a2 (transposed, K-major), and dop_l (hi, lo) is the packed form of
    split_tf32 of mega_constants' ft_re / ft_im (rna is symmetric, so
    negation commutes with it), both cut by gmma_tiles, bit for bit up
    to the sign of zero; a2's split carries it to 2^-22."""
    cfg = RadarConfig(**CONST_CASES[case])
    c = mega_constants(cfg)
    for name in ("a2_split", "dop_l"):
        assert c[name].dtype == torch.float32 and c[name].is_contiguous()
    s2, r2 = c["a2"].shape
    ah, al = split_tf32(c["a2"])
    for got, want in zip(c["a2_split"].numpy(), (ah, al)):
        np.testing.assert_array_equal(untile(got, r2, s2).view(np.int32),
                                      want.numpy().T.view(np.int32))
    frh, frl = split_tf32(c["ft_re"])
    fih, fil = split_tf32(c["ft_im"])
    for got, (r, i) in zip(c["dop_l"].numpy(), ((frh, fih), (frl, fil))):
        want = doppler_lhs(r.numpy(), i.numpy())
        # + 0: lo of a value on the grid is +0, negated after the split -0
        np.testing.assert_array_equal(
            (untile(got, *want.shape) + 0).view(np.int32),
            (want + 0).view(np.int32))
    err = (c["a2"].double() - ah.double() - al.double()).abs()
    assert (err <= 2.0 ** -22 * c["a2"].double().abs()).all()


def test_host_tf32_split_equals_split_tf32():
    """megakernel.tf32_split (NumPy, the host's) and ops/tf32.split_tf32
    (torch) give the same bits on ties, carries, subnormals, zeros of
    both signs and random values over 40 decades."""
    rng = np.random.default_rng(3)
    crafted = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 2.0 - 2.0 ** -11,
               1.0 + 3 * 2.0 ** -11, 2.0 ** -130, 2.0 ** -149, 0.0, -0.0,
               65535.0, -32768.0]
    x = np.concatenate([np.float32(crafted),
                        (rng.standard_normal(4096)
                         * 10.0 ** rng.uniform(-20, 20, 4096))]
                       ).astype(np.float32)
    got = tf32_split(x)
    want = torch.stack(split_tf32(torch.from_numpy(x))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# -- the emulated tiers -----------------------------------------------------

def frames_and_base(cfg, n, seed, base_mode=True):
    cap = synthesize_capture(TARGETS, n + 1, cfg, noise_std=5.0, seed=seed)
    base = (RDPipeline(config_from_jax(cfg), 16, device="cpu")
            .prepare_base(cap[0]) if base_mode else None)
    return cap, torch.from_numpy(cap[1:]), base


@pytest.mark.parametrize("clutter", ["base", "mean"])
@pytest.mark.parametrize("passes,bound", [(3, 1e-5), (1, 1e-3)])
def test_emulated_power_against_golden(passes, bound, clutter):
    """Two frames at the default geometry: the tier's power map within
    ``bound`` of the float64 golden relative to each map's peak (on
    these seeds, base / mean clutter: 3 passes 1.9e-7 / 4.2e-7, 1 pass
    3.2e-4 / 2.7e-4)."""
    cfg = JaxConfig(clutter_mode="auto" if clutter == "base" else "mean")
    cap, frames, base = frames_and_base(cfg, 2, seed=5,
                                        base_mode=clutter == "base")
    tcfg = config_from_jax(cfg)
    consts = mega_constants(tcfg)
    power = tier_power(tier_planes(frames, base, tcfg, consts, passes), tcfg,
                       consts, passes)[0].double().numpy()
    want = golden_power(cap, tcfg, 1)
    peak = want.reshape(len(want), -1).max(-1)[:, None, None]
    assert (np.abs(power - want) / peak).max() <= bound


def test_emulated_high_sets_equal_jax_high():
    """Three frames: the emulated 3-pass detect op gives the detection
    sets of the JAX package's RDPipeline at dft_precision='high' (its
    bf16 3-pass mega kernel, in interpret mode)."""
    cfg = JaxConfig(dft_precision="high")
    shorts = synthesize_capture(TARGETS, 4, cfg, noise_std=5.0, seed=21)
    jp = jax_rd.RDPipeline(cfg, max_detections=16, rd_impl="mega-interpret")
    jbase = jp.prepare_base(jnp.asarray(shorts[0]))
    want = jax.tree.map(np.asarray, jp.detect(jnp.asarray(shorts[1:]), jbase))

    tcfg = config_from_jax(cfg)
    base = RDPipeline(tcfg, 16, device="cpu").prepare_base(shorts[0])
    out = tier_detections(torch.from_numpy(shorts[1:]), base, 16, tcfg,
                          mega_constants(tcfg), 3)
    got = result_to_numpy(assemble_result_from_kernel(*out, tcfg))
    for f in range(len(shorts) - 1):
        sg = set(zip(got["doppler_bin"][f][got["valid"][f]].tolist(),
                     got["range_bin"][f][got["valid"][f]].tolist()))
        sw = set(zip(want.doppler_bin[f][want.valid[f]].tolist(),
                     want.range_bin[f][want.valid[f]].tolist()))
        assert sg == sw and sg, f"frame {f}"


HIGH_CASES = {
    "base": (dict(), True),
    "mean": (dict(clutter_mode="mean"), False),
    "mti2": (dict(clutter_mode="mti2"), False),
    "tdm-mean": (dict(num_samples=64, num_chirps=64, num_rx=2, num_tx=2),
                 False),
    "kc20-base": (dict(num_samples=48, num_chirps=40, num_rx=2, num_tx=2),
                  True),
}


@pytest.mark.parametrize("case", sorted(HIGH_CASES))
def test_emulated_high_against_the_f32_plain_version(case):
    """The 3-pass products against the f32 plain version on 8 frames:
    0 flips under ``compare`` with the tier's floor (unit 2^-21), and
    power maps within ``maps_check`` at that unit."""
    overrides, base_mode = HIGH_CASES[case]
    cfg = JaxConfig(**overrides)
    _, frames, base = frames_and_base(cfg, 8, seed=7, base_mode=base_mode)
    tcfg = config_from_jax(cfg)
    consts = mega_constants(tcfg)
    got = run_detect(lambda x, b, k, c: tier_detections(x, b, k, c, consts, 3),
                     frames, base, 16, tcfg)
    want = run_detect(detections_from_shorts_reference, frames, base, 16, tcfg)
    flips, _ = compare(got, want, tcfg, max_flips=0, f32_floor=True,
                       unit=TIER_UNIT["high"])
    assert flips == 0 and want["valid"].any()
    power = tier_power(tier_planes(frames, base, tcfg, consts, 3), tcfg,
                       consts, 3)[0]
    maps_check(case, power, power_from_shorts_reference(frames, base, tcfg),
               unit=TIER_UNIT["high"])


# -- the tier mapping and the C entries -------------------------------------

@pytest.mark.parametrize("tier,passes", [("highest", 0), ("high", 3),
                                         ("default", 1)])
def test_dft_passes_maps_each_tier(tier, passes):
    assert dft_passes(RadarConfig(dft_precision=tier)) == passes


def test_dft_passes_refuses_an_unknown_tier():
    with pytest.raises(ValueError, match="dft_precision"):
        dft_passes(types.SimpleNamespace(dft_precision="bf16"))


def test_default_config_runs_the_three_pass_tier():
    assert dft_passes(RadarConfig()) == 3


def c_entries() -> dict[str, tuple[str, list[str]]]:
    """The exported C functions of csrc/*.cu: name -> (return type,
    parameter types)."""
    entries = {}
    for src in sorted(_build.CSRC_DIR.glob("*.cu")):
        for m in re.finditer(r"^(int|const char\*) (radar_\w+)\(([^)]*)\)",
                             src.read_text(), re.M):
            entries[m.group(2)] = (m.group(1), [
                " ".join(p.split()[:-1]) for p in m.group(3).split(",")
                if p.strip()])
    return entries


C_ENTRIES = c_entries()
INTERNAL = {"radar_detect_stage": "megakernel.cu"}   # stage -> its caller


def _ctype(c_type: str):
    if c_type == "const char*":
        return ctypes.c_char_p
    if c_type.endswith("*"):
        return PTR
    return {"int": I32, "long long": I64, "float": F32}[c_type]


@pytest.mark.parametrize("name", sorted(C_ENTRIES))
def test_entry_argtypes_match_the_c_signature(name):
    """Each C entry of csrc/*.cu is declared by the ``ops/cuda`` wrapper
    that launches it, with the ctypes type of each C parameter in order
    (a missing or wrong one would pass garbage); the one entry that no
    wrapper declares, ``INTERNAL``, is a stage that another csrc/ file
    calls."""
    for mod in pkgutil.iter_modules(cuda_ops.__path__):
        importlib.import_module(f"{cuda_ops.__name__}.{mod.name}")
    restype, params = C_ENTRIES[name]
    if name in INTERNAL:
        assert name not in SIGNATURES
        assert f"return {name}(" in (
            _build.CSRC_DIR / INTERNAL[name]).read_text()
        return
    assert name in SIGNATURES, f"no ops/cuda wrapper declares {name}"
    argtypes, declared_restype = SIGNATURES[name]
    assert argtypes == [_ctype(p) for p in params]
    assert declared_restype is _ctype(restype)


def test_megakernel_entries_take_the_tier():
    """The three entries of csrc/megakernel.cu carry ``int passes``."""
    text = (Path(_build.CSRC_DIR) / "megakernel.cu").read_text()
    for name in ("radar_mega_detect", "radar_mega_maps", "radar_fused_range"):
        sig = re.search(rf"^int {name}\(([^)]*)\)", text, re.M).group(1)
        assert "int passes" in sig, name
