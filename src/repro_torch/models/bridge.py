"""Bridge from the JAX package's parameters to the port's.

The JAX package's parameter pytree, with its leaves turned into numpy arrays
(``np.asarray`` per leaf), becomes the same nested dicts and lists of torch
tensors: one ``torch.from_numpy`` per leaf, shapes unchanged, the leading
``repeats`` dim kept.  This module imports nothing of the JAX package; the
caller converts the leaves.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.quant import tree_map


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Nested dicts/lists of arrays -> the same tree of tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_numpy: no CUDA device is available")
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)
