"""TF32 rounding and the split products of the tensor-core DFT tiers.

The CUDA front end of kernels 1, 2 and 8 (``csrc/megakernel.cu``) runs
its two DFT products on Hopper's tensor cores in TF32 for
``cfg.dft_precision`` 'high' and 'default'.  TF32 keeps 10 explicit
mantissa bits, so an f32 operand x is carried as

    hi = rna(x)        (|x - hi| <= 2^-11 |x|)
    lo = rna(x - hi)   (|x - hi - lo| <= 2^-22 |x|)

with ``rna`` round to nearest, ties away from zero (``cvt.rna.tf32.f32``).
'high' sums three passes, hi*lo + lo*hi and then hi*hi; the dropped
lo*lo term is at most 2^-22 of the product, so each product is carried
to about 2^-21.  'default' keeps hi*hi alone (about 2^-11).

These functions emulate that arithmetic in f32 for the tests and
``chip_smoke.py``: a product of two TF32 values (11 + 11 significant
bits) is exact in f32, so the emulation differs from the tensor cores
only in the order of the sums.  The main path never calls them.

:func:`tf32_off` pins the other way: the plain products of the scene
products (``ops/aoa``, ``ops/mdoppler``) run under it, so no global
TF32 switch changes their bits.
"""

from __future__ import annotations

import contextlib

import torch

PASSES = (1, 3)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 explicit mantissa bits), to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32`` does: the low 13
    bits of the result are zero.  Infinities and NaN pass through."""
    x = x.to(torch.float32)
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    # sign-magnitude: adding half of the dropped range to the bit pattern
    # rounds the magnitude half up, i.e. ties away from zero
    rounded = ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded.reshape(x.shape), x)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both TF32 values in f32: hi = rna(x), lo = rna(x - hi).
    ``x - hi`` is exact in f32; hi + lo is within 2^-22 |x| of x, and
    equal to x when x has at most 22 significant bits (every int16)."""
    x = x.to(torch.float32)
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_matmul(x: torch.Tensor, a: torch.Tensor, passes: int) -> torch.Tensor:
    """``x @ a`` as the tensor-core tiers compute it, emulated in f32:
    1 pass, hi(x) @ hi(a); 3 passes, (hi(x) @ lo(a) + lo(x) @ hi(a)) +
    hi(x) @ hi(a), the small terms first.  Each product of TF32 values
    is exact in f32; only the order of the sums differs from the card."""
    if passes not in PASSES:
        raise ValueError(f"split_matmul takes passes 1 or 3, not {passes!r}")
    xh, xl = split_tf32(x)
    ah, al = split_tf32(a)
    big = xh @ ah
    if passes == 1:
        return big
    return (xh @ al + xl @ ah) + big


@contextlib.contextmanager
def tf32_off():
    """Pin ``torch.backends.cuda.matmul.allow_tf32`` off for the block
    (or the decorated function) and restore the caller's setting after:
    the f32 products inside then run as f32 SGEMM, with the same bits
    whatever the caller chose.  The flag is process-wide, so a thread
    that multiplies meanwhile sees it off too."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
