"""Plain PyTorch versions of the ported kernels.

The CPU path of every kernel wrapper, and what ``chip_smoke.py`` holds each
CUDA kernel against on the card.  They repeat ``repro.kernels.ref`` op for
op, so on the CPU they agree with the JAX package exactly on integer
outputs.
"""
from __future__ import annotations

import torch


# --- nm_spmm ---------------------------------------------------------------

def compress_24(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense (K, N) (assumed or forced 2:4 along K) -> (vals, idx).

    Keeps the top-2 |w| per contiguous group of 4 along K, positions
    ascending.  The sort is stable, as ``jnp.argsort`` is, so ties keep the
    reference's choice.
    """
    K, N = w.shape
    if K % 4:
        raise ValueError(f"K={K} is not a multiple of 4")
    g = w.reshape(K // 4, 4, N)
    order = torch.argsort(-g.abs(), dim=1, stable=True)[:, :2]
    idx = torch.sort(order, dim=1).values
    vals = torch.gather(g, 1, idx)
    return vals.reshape(K // 2, N), idx.to(torch.int8).reshape(K // 2, N)


def decompress_24(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., K/2, N) vals + int8 positions -> dense (..., K, N), zeros
    elsewhere.  Leading dims (experts, layers) pass through."""
    *lead, half_k, N = vals.shape
    g = half_k // 2
    v = vals.reshape(*lead, g, 2, N)
    p = idx.reshape(*lead, g, 2, N).long()
    r = torch.arange(4, device=vals.device)[:, None]
    dense = torch.zeros((*lead, g, 4, N), dtype=vals.dtype,
                        device=vals.device)
    for j in range(2):
        dense = dense + torch.where(p[..., j:j + 1, :] == r,
                                    v[..., j:j + 1, :], 0)
    return dense.reshape(*lead, g * 4, N)


def nm_matmul_ref(x: torch.Tensor, vals: torch.Tensor,
                  idx: torch.Tensor) -> torch.Tensor:
    w = decompress_24(vals, idx)
    return (x @ w.to(x.dtype)).to(x.dtype)


# --- nm mask ---------------------------------------------------------------

def nm_mask_ref(s: torch.Tensor, n: int = 2, m: int = 4) -> torch.Tensor:
    """Top-n |s| per contiguous group of m along axis 0 (ties -> lower index).

    Rank-based: element i is kept iff fewer than n elements beat it, where
    "beats" = strictly greater, or equal with a lower position.
    """
    K, N = s.shape
    g = s.float().abs().reshape(K // m, m, N)
    gi = g[:, :, None, :]
    gj = g[:, None, :, :]
    pos = torch.arange(m, device=s.device)
    j_earlier = pos[None, None, :, None] < pos[None, :, None, None]
    rank = ((gj > gi) | ((gj == gi) & j_earlier)).sum(dim=2)
    return (rank < n).reshape(K, N)
