"""Mask trees -> compressed formats.  Port of ``repro.sparse.pack``.

The mask, not a top-k recomputation, is the source of truth: export ties
are broken by the dual V (``core.mirror.export_masks``), so positions come
from the mask and ``to_dense() == W * mask`` holds exactly.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.sparse.formats import BitMask, SparseTensor, _pack_idx2


def nm_positions(mask: torch.Tensor, *, m: int = 4,
                 n: int = 2) -> torch.Tensor:
    """2:4 keep-mask (..., K, N) -> kept in-group positions (..., K/2, N)
    int8, ascending within each group.  Requires exactly ``n`` kept entries
    per contiguous group of ``m`` along the second-to-last dim."""
    *lead, k, cols = mask.shape
    if k % m:
        raise ValueError(f"K={k} is not a multiple of {m}")
    g = mask.reshape(*lead, k // m, m, cols)
    r = torch.arange(m, dtype=torch.int8, device=mask.device)[:, None]
    # kept entries sort to the front (their position), dropped sort to m
    key = torch.where(g, r, torch.tensor(m, dtype=torch.int8,
                                         device=mask.device))
    pos = torch.sort(key, dim=-2).values[..., :n, :]
    return pos.reshape(*lead, (k // m) * n, cols).to(torch.int8)


def pack_nm(w: torch.Tensor, mask: torch.Tensor, *, idx_bits: int = 8,
            dtype: torch.dtype | None = None) -> SparseTensor:
    """Dense weight + 2:4 keep-mask -> SparseTensor.

    dtype: storage dtype of the kept values (the serving compute dtype);
    default keeps ``w.dtype``.  ``idx_bits=2`` packs positions 4 per byte.
    """
    *lead, k, cols = w.shape
    idx = nm_positions(mask)
    g = w.reshape(*lead, k // 4, 4, cols)
    gi = idx.reshape(*lead, k // 4, 2, cols).long()
    vals = torch.gather(g, -2, gi).reshape(*lead, k // 2, cols)
    if dtype is not None:
        vals = vals.to(dtype)
    if idx_bits == 2:
        return SparseTensor(vals, _pack_idx2(idx), idx_bits=2)
    return SparseTensor(vals, idx, idx_bits=8)


def pack_mask_tree(masks: Any) -> Any:
    """Boolean mask tree -> ``BitMask`` tree (None leaves stay None)."""
    return tree.tree_map(lambda m: None if m is None else BitMask.pack(m),
                         masks)


def unpack_mask_tree(packed: Any) -> Any:
    """``BitMask`` tree -> boolean mask tree (None leaves stay None)."""
    return tree.tree_map(
        lambda b: b.to_dense() if isinstance(b, BitMask) else None, packed)
