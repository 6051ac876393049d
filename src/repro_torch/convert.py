"""Carry the JAX package's params into the port.

The reference's params are ``jax.random.truncated_normal`` draws:
``core/prng.py`` replays their threefry bits but not the inverse-erf
transform of them, so a test that compares the two packages on the same
weights initialises them in JAX, pulls them to the host
(``jax.device_get``: a tree of numpy arrays) and converts them here.  The trained benchmark models the reference
cached under ``results/bench_models/*.pkl`` are such numpy trees already
(:func:`load_params_pickle`).  Expert banks (layers, E, d_in, d_out), an
untied ``lm_head``, zamba2's ``shared`` block and ``lora_*`` adapters, and
the recurrent mixers' leaves (Mamba2's ``A_log``, ``dt_bias``, ``D`` and
``conv``, sLSTM's recurrent ``r``), whisper's ``frame_proj``,
``pos_embed``, ``enc_stages`` and ``enc_norm`` (layernorm ``scale`` and
``bias``) and pixtral's ``vit_proj`` carry across like every other leaf:
the tree's key paths are the reference's.  This module imports
neither jax nor ``repro``: it only sees numpy.
"""
from __future__ import annotations

from typing import Any

import pathlib
import pickle

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


def load_params_pickle(path, *, device="cpu") -> Any:
    """A params tree the repository pickled as plain numpy (the reference's
    ``results/bench_models/<name>.pkl``) -> torch tensors on ``device``.
    Unpickling runs code, so only the repository's own files go here."""
    with open(pathlib.Path(path), "rb") as f:
        return params_from_numpy(pickle.load(f), device=device)
