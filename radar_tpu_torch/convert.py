"""State carried across from the JAX package.

The pipelines have no weights; the only state is the base frame.  These
helpers let both packages run on the same base and compare results as
NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def base_from_numpy(base, device="cpu") -> torch.Tensor:
    """The JAX ``RDPipeline.prepare_base`` output (complex64 (V, C, S),
    as a NumPy array) as the port's base tensor on ``device``."""
    arr = np.asarray(base)
    if arr.ndim != 3 or not np.iscomplexobj(arr):
        raise ValueError(
            f"expected a complex (rx, chirps, samples) base cube, got "
            f"{arr.dtype} {arr.shape}"
        )
    return torch.from_numpy(arr.astype(np.complex64)).to(device)


def result_to_numpy(res) -> dict[str, np.ndarray]:
    """An ``RDResult`` (or any NamedTuple of tensors) as a dict of NumPy
    arrays keyed by field name."""
    return {name: getattr(res, name).detach().cpu().numpy()
            for name in res._fields}
