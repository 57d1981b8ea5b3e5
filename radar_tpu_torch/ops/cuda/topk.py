"""Top-K of flattened masked maps: kernel 3.

Port of ``radar_tpu/ops/pallas/topk_kernel.py`` (``_kernel``, entry
``topk_pallas``): the K largest entries of each row in ``lax.top_k``
order — values descending, ties to the lowest index, and once the
finite entries run out, the untaken indices in ascending order with
value -inf.

* :func:`topk_cuda` launches the CUDA kernel (``csrc/topk.cu``; design
  and bounds are noted there) and counts its launches in the counter
  ``launches.topk`` (``utils.spans``): a two-level selection, each
  chunk of 2,048 cells of a row ordered by one block, the chunks' lists merged by the row's last
  block, the selection of kernel 1 (``csrc/select_common.cuh``).
* :func:`top_k_sorted` is its plain version (a stable descending sort).

``models.rd_pipeline.topk_cells`` picks between them; there is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from radar_tpu_torch.ops.cuda import layout
from radar_tpu_torch.ops.cuda._launch import (
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
)
from radar_tpu_torch.utils import spans


def top_k_sorted(flat: torch.Tensor, k: int):
    """``lax.top_k`` order on the last axis: values descending, ties to
    the LOWEST index, so exhausted (-inf) slots hold the untaken indices
    in ascending order.  ``torch.topk`` does not promise that order; a
    stable descending sort does.  Returns (values, int32 indices)."""
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


declare("radar_topk", [PTR] * 5      # x, val, idx, tickets, work
        + [I64]                      # work words
        + [I32] * 3)                 # rows, n, k


def topk_cuda(flat: torch.Tensor, k: int):
    """:func:`top_k_sorted` through the CUDA kernel, for f32 (..., N).
    Entries equal to the f32 minimum read as -inf (the kernel's
    sentinel); masked power maps never hold one.  Raises for a tensor
    that is not on a CUDA device, for K outside 1..N, when the build
    fails and when the launch fails."""
    require_cuda(flat, "top-K", "top_k_sorted")
    n = flat.shape[-1]
    if not 1 <= k <= n:
        raise NotImplementedError(
            f"top-{k} of {n} cells is outside the top-K kernel's range "
            "(1 <= K <= N)"
        )
    lead = flat.shape[:-1]
    x = flat.reshape(-1, n)
    check("flat", x, torch.float32, (x.shape[0], n), flat.device)
    check_aligned("flat", x)
    vals = torch.empty((x.shape[0], k), dtype=torch.float32,
                       device=flat.device)
    idx = torch.empty((x.shape[0], k), dtype=torch.int32, device=flat.device)
    words = layout.topk_work_words(x.shape[0], n, k)
    tickets, work = selection_buffers(flat.device, x.shape[0], words)
    launch("radar_topk", flat.device, ptr(x), ptr(vals), ptr(idx),
           ptr(tickets), ptr(work), words, x.shape[0], n, k)
    spans.count("launches.topk")
    return vals.reshape(lead + (k,)), idx.reshape(lead + (k,))
