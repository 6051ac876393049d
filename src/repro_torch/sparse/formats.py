"""Compressed weight format: ``SparseTensor``, the 2:4 layout ``nm_matmul``
executes.

Port of ``repro.sparse.formats``, with ``BitMask``, the unstructured
keep-mask storage, 8 masks per byte.  For a dense
kernel (..., K, N) pruned 2:4 along K it stores ``vals`` (..., K/2, N) in
the serving compute dtype plus the in-group positions, either int8
(``idx_bits=8``: (..., K/2, N)) or packed 4 per byte (``idx_bits=2``:
(..., ceil(K/8), N) uint8, zero-padded to the byte boundary when
K % 8 != 0).  Leading dims pass through: a stacked layer kernel keeps its
"layers" axis, and :meth:`SparseTensor.select` slices one layer out; an
MoE expert bank keeps its expert axis, (E, K/2, N) per layer, which
``nm_matmul_expert`` consumes as is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
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
    """2:4-compressed weight standing in for a dense (..., K, N) kernel.

    ``shard`` is the optional tensor-parallel tag stamped by
    ``dist.sharding.tag_compressed``: ``(site, *dim_entries)`` where
    ``site`` labels the projection group ("mlp" / "attn" / "moe" /
    "dense") and ``dim_entries`` name the mesh axes of the leaf's
    *executed* dense dims - ``(k, n)`` for a 2-D kernel, ``(e, k, n)`` for
    an expert bank (a stacked leaf's leading "layers" axis is excluded, so
    :meth:`select` keeps the tag as it is).  Each entry is None, a
    mesh-axis name, or a tuple of names.  A non-None K entry routes
    dispatch through the K-sharded wrappers in ``kernels/shard.py``.

    ``block`` (the port's placement, ``dist.sharding.place_params``): the
    spec of the components' dims when ``vals`` and ``idx`` are one rank's
    blocks of the leaf, None when they are the whole leaf.  ``shape`` is
    then the block's.  Both survive :meth:`select` (which drops the
    block's first entry with the layer axis), :meth:`to` and the port's
    tree flatten and unflatten (a SparseTensor is one leaf there).
    """

    def __init__(self, vals: torch.Tensor, idx: torch.Tensor,
                 idx_bits: int = 8, shard: tuple | None = None,
                 block: tuple | None = None):
        if idx_bits not in (2, 8):
            raise ValueError(f"idx_bits must be 2 or 8, got {idx_bits}")
        self.vals = vals
        self.idx = idx
        self.idx_bits = idx_bits
        self.shard = None if shard is None else tuple(shard)
        self.block = None if block is None else tuple(block)

    def with_shard(self, shard: tuple | None) -> "SparseTensor":
        """Same components, new tensor-parallel tag."""
        return SparseTensor(self.vals, self.idx, idx_bits=self.idx_bits,
                            shard=shard, block=self.block)

    @property
    def shard_site(self) -> str | None:
        return None if self.shard is None else self.shard[0]

    @property
    def k_shard(self):
        """Mesh axes of the contraction dim, or None (replicated K)."""
        return None if self.shard is None else self.shard[-2]

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
        return SparseTensor(self.vals[i], self.idx[i], self.idx_bits,
                            shard=self.shard,
                            block=None if self.block is None
                            else self.block[1:])

    def to(self, *args, **kwargs) -> "SparseTensor":
        return SparseTensor(self.vals.to(*args, **kwargs),
                            self.idx.to(*args, **kwargs), self.idx_bits,
                            shard=self.shard, block=self.block)

    def unpacked_idx(self) -> torch.Tensor:
        """int8 (..., K/2, N) positions regardless of storage packing."""
        if self.idx_bits != 2:
            return self.idx
        half_k = self.vals.shape[-2]
        return _unpack_idx2(self.idx)[..., :half_k, :]

    def to_dense(self) -> torch.Tensor:
        """Decompress to the dense (..., K, N) tensor (masked positions 0)."""
        return ref.decompress_24(self.vals, self.unpacked_idx())

    def __repr__(self):
        tag = f", shard={self.shard}" if self.shard is not None else ""
        return (f"SparseTensor(shape={self.shape}, dtype={self.dtype}, "
                f"idx_bits={self.idx_bits}{tag})")


class BitMask:
    """Boolean mask packed 8 per byte: a flat uint8 buffer and the shape.

    Little-endian within a byte (mask entry 8 i + j is bit j of byte i), the
    flat mask zero-padded to a multiple of 8: the reference's bytes, bit
    for bit."""

    def __init__(self, bits: torch.Tensor, shape: tuple[int, ...]):
        self.bits = bits
        self.shape = tuple(shape)

    @property
    def nbytes(self) -> int:
        return self.bits.numel()

    @classmethod
    def pack(cls, mask: torch.Tensor) -> "BitMask":
        flat = mask.reshape(-1).to(torch.uint8)
        pad = -flat.numel() % 8
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        weights = torch.ones(8, dtype=torch.uint8, device=flat.device) << \
            torch.arange(8, dtype=torch.uint8, device=flat.device)
        return cls((flat.reshape(-1, 8) * weights).sum(
            dim=-1, dtype=torch.uint8), tuple(mask.shape))

    def to_dense(self) -> torch.Tensor:
        n = torch.Size(self.shape).numel()
        shifts = torch.arange(8, dtype=torch.uint8, device=self.bits.device)
        flat = ((self.bits[:, None] >> shifts) & 1).reshape(-1)[:n]
        return flat.to(torch.bool).reshape(self.shape)

    def __repr__(self):
        return f"BitMask(shape={self.shape}, nbytes={self.nbytes})"


def sparse_leaves(t) -> list[SparseTensor]:
    """Every ``SparseTensor`` leaf of a tree, in flatten order."""
    from repro_torch import tree
    return [x for x in tree.leaves(t) if isinstance(x, SparseTensor)]
