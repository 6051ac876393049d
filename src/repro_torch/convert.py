"""Carry the JAX package's params into the port.

The reference's params come from threefry draws, which torch cannot replay,
so a test that compares the two packages on the same weights initialises
them in JAX, pulls them to the host (``jax.device_get``: a tree of numpy
arrays) and converts them here.  This module imports neither jax nor
``repro``: it only sees numpy.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _leaf(a, device):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(t: Any, *, device="cpu") -> Any:
    """Numpy tree (nested dicts/lists, the reference's layout and key
    paths) -> the same tree of torch tensors on ``device``."""
    return tree.tree_map(lambda a: _leaf(a, device), t)
