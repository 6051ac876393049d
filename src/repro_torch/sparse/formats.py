"""Compressed weight format: ``SparseTensor``, the 2:4 layout ``nm_matmul``
executes.

Port of ``repro.sparse.formats`` (the unstructured ``BitMask`` storage
format and the tensor-parallel tags are not ported yet).  For a dense
kernel (..., K, N) pruned 2:4 along K it stores ``vals`` (..., K/2, N) in
the serving compute dtype plus the in-group positions, either int8
(``idx_bits=8``: (..., K/2, N)) or packed 4 per byte (``idx_bits=2``:
(..., ceil(K/8), N) uint8, zero-padded to the byte boundary when
K % 8 != 0).  Leading dims pass through: a stacked layer kernel keeps its
"layers" axis, and :meth:`SparseTensor.select` slices one layer out.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                         unpack_idx2 as _unpack_idx2)


def _pack_idx2(idx: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) int8 (values 0..3) -> (..., ceil(K/8), N) uint8.

    Position rows are zero-padded to the byte boundary when K % 8 != 0; the
    pad codes decode to position 0 and ``SparseTensor.unpacked_idx`` slices
    them off again.
    """
    *lead, rows, n = idx.shape
    pad = -rows % 4
    if pad:
        idx = torch.cat([idx, idx.new_zeros((*lead, pad, n))], dim=-2)
        rows += pad
    g = idx.to(torch.uint8).reshape(*lead, rows // 4, 4, n)
    out = torch.zeros(g.shape[:-2] + (n,), dtype=torch.uint8,
                      device=idx.device)
    for j in range(4):
        out = out | (g[..., j, :] << (2 * j))
    return out


class SparseTensor:
    """2:4-compressed weight standing in for a dense (..., K, N) kernel."""

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor,
                 idx_bits: int = 8):
        if idx_bits not in (2, 8):
            raise ValueError(f"idx_bits must be 2 or 8, got {idx_bits}")
        self.vals = vals
        self.idx = idx
        self.idx_bits = idx_bits

    @property
    def shape(self) -> tuple[int, ...]:
        *lead, half_k, n = self.vals.shape
        return (*lead, half_k * 2, n)

    @property
    def ndim(self) -> int:
        return self.vals.dim()

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def nbytes(self) -> int:
        return (self.vals.numel() * self.vals.element_size()
                + self.idx.numel() * self.idx.element_size())

    @property
    def layout(self) -> str:
        """Storage layout tag for the index plane."""
        return LAYOUT_PACKED2 if self.idx_bits == 2 else LAYOUT_INT8

    @property
    def kernel_layout(self) -> str:
        """Layout the matmul kernel streams: packed storage is kernel-native
        only when K % 8 == 0; a padded plane unpacks to int8 at dispatch."""
        if self.idx_bits == 2 and self.shape[-2] % 8 == 0:
            return LAYOUT_PACKED2
        return LAYOUT_INT8

    def select(self, i: int) -> "SparseTensor":
        """Leading-axis slice (one layer of a stacked kernel), as views."""
        return SparseTensor(self.vals[i], self.idx[i], self.idx_bits)

    def to(self, *args, **kwargs) -> "SparseTensor":
        return SparseTensor(self.vals.to(*args, **kwargs),
                            self.idx.to(*args, **kwargs), self.idx_bits)

    def unpacked_idx(self) -> torch.Tensor:
        """int8 (..., K/2, N) positions regardless of storage packing."""
        if self.idx_bits != 2:
            return self.idx
        half_k = self.vals.shape[-2]
        return _unpack_idx2(self.idx)[..., :half_k, :]

    def to_dense(self) -> torch.Tensor:
        """Decompress to the dense (..., K, N) tensor (masked positions 0)."""
        vals, idx = self.vals, self.unpacked_idx()
        *lead, half_k, n = vals.shape
        g = half_k // 2
        v = vals.reshape(*lead, g, 2, n)
        p = idx.reshape(*lead, g, 2, n).long()
        r = torch.arange(4, device=vals.device)[:, None]
        dense = torch.zeros((*lead, g, 4, n), dtype=vals.dtype,
                            device=vals.device)
        for j in range(2):
            dense = dense + torch.where(p[..., j:j + 1, :] == r,
                                        v[..., j:j + 1, :], 0)
        return dense.reshape(*lead, g * 4, n)

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, dtype={self.dtype}, "
                f"idx_bits={self.idx_bits})")
