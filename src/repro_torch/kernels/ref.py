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


# --- saliency_fuse ---------------------------------------------------------

def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root, as ``jnp.sqrt`` and CUDA's
    ``sqrtf`` give it.  torch's vectorised CPU ``sqrt`` is off by an ulp in
    about 0.5% of f32 inputs; the f64 root rounded to f32 is exact."""
    return torch.sqrt(x.double()).float()


def saliency_step_ref(w, a, gamma, v, *, v_lr: float, lam: float,
                      rowsum=None, colsum=None, s_div=None):
    """One fused local-metric + dual + prox step (f32 math).

    w, gamma, v: (..., K, N); a: (..., K) input-feature norms, or None for
    magnitude; rowsum (..., K, 1) and colsum (..., 1, N) for the RIA family.

    S = |w| * a[..., None]                        (wanda; a = ||X_j||_2)
    or S = |w|                                    (magnitude; a is None)
    or, when rowsum/colsum are given (RIA family):
    S = (|w|/rowsum + |w|/colsum) * sqrt(a)[..., None]
    then S = S / s_div when the search normalises the scores (s_div is the
    device scalar med + 1e-12 of ``normalize_scores``).
    V' = v - v_lr * (gamma - S);  Gamma' = soft(V', lam).
    """
    wf = w.float().abs()
    if rowsum is not None:
        af = a.float()
        s = (wf / (rowsum.float() + 1e-12) + wf / (colsum.float() + 1e-12)) \
            * sqrt_f32(torch.clamp_min(af, 1e-12))[..., None]
    elif a is not None:
        s = wf * a.float()[..., None]
    else:
        s = wf
    if s_div is not None:
        s = s / s_div
    v_new = v.float() - v_lr * (gamma.float() - s)
    gamma_new = torch.copysign(torch.clamp_min(v_new.abs() - lam, 0.0), v_new)
    return v_new, gamma_new


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


def prox24_ref(w: torch.Tensor, lam: float, *, iters: int = 12,
               damping: float = 0.7) -> torch.Tensor:
    """The plain version of the ``prox24`` kernel: ``core.prox.prox_nm24``
    on a 2-D (K, N) input, as the reference's oracle is."""
    from repro_torch.core.prox import prox_nm24
    return prox_nm24(w, lam, iters=iters, damping=damping)
