"""Mask export: keep-masks at any sparsity from saliency trees.

Port of ``repro.core.masks``:

* ``global_threshold``   - exact: one global sort/quantile of |score|.
* ``threshold_bisect``   - bisection on P(|s| <= tau) using only sums.
* ``unstructured_masks`` - scope = global | layer | row.
* ``nm_masks``           - N:M top-N along the input (reduction) dim; the
  2:4 case runs through the ``nm_mask24`` kernel on the card.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.dist import sharding
from repro_torch.kernels import ref
from repro_torch.kernels.nm_prox import nm_mask24


def _flat_abs(score_tree: Any) -> torch.Tensor:
    return torch.cat([x.float().abs().reshape(-1)
                      for x in tree.leaves(score_tree) if x is not None])


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (linear method) in its f32 arithmetic.

    ``torch.quantile`` refuses inputs over 2**24 elements, and a full-width
    score tree holds ~1e9.
    """
    a = torch.sort(a.reshape(-1)).values
    n = torch.tensor(float(a.numel()), dtype=torch.float32)
    qq = torch.tensor(q, dtype=torch.float32) * (n - 1)
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = 1 - hw
    lo = int(torch.clamp(low, 0, n - 1))
    hi = int(torch.clamp(high, 0, n - 1))
    return a[lo] * lw.to(a.device) + a[hi] * hw.to(a.device)


def global_threshold(score_tree: Any, sparsity: float) -> torch.Tensor:
    """Exact tau: |score| < tau is pruned; keeps the top (1-sparsity)."""
    return _quantile(_flat_abs(score_tree), sparsity)


def threshold_bisect(score_tree: Any, sparsity: float, *, iters: int = 40,
                     hi: float | None = None) -> torch.Tensor:
    """tau by bisection on P(|s| <= tau): sums only, no global sort."""
    leaves = [x.float().abs() for x in tree.leaves(score_tree)
              if x is not None]
    total = sum(x.numel() for x in leaves)
    dev = leaves[0].device
    hi_t = (sum(x.max() for x in leaves) if hi is None
            else torch.tensor(hi, dtype=torch.float32, device=dev))
    lo_t = torch.zeros((), dtype=torch.float32, device=dev)
    for _ in range(iters):
        mid = 0.5 * (lo_t + hi_t)
        frac = sum((x <= mid).sum() for x in leaves) / total
        below = frac < sparsity
        lo_t, hi_t = torch.where(below, mid, lo_t), torch.where(below, hi_t,
                                                                mid)
    return 0.5 * (lo_t + hi_t)


def unstructured_masks(score_tree: Any, sparsity: float, *,
                       scope: str = "global", exact: bool = True,
                       mesh=None) -> Any:
    """Boolean keep-masks matching score_tree (None leaves stay None).

    scope: 'global' (one budget, UniPruning), 'layer' (per-tensor budget),
    'row' (per-output-column budget along d_in - Wanda's comparison group).
    ``mesh`` (global scope only): a leaf may be this rank's block
    (``dist.sharding.DenseBlock``); the threshold comes from every leaf
    gathered whole, so it is the single process's bit for bit, and each
    block is masked by it.
    """
    if scope == "global":
        whole = score_tree if mesh is None else tree.tree_map(
            lambda s: None if s is None else sharding.whole(s, mesh),
            score_tree)
        tau = (global_threshold(whole, sparsity) if exact
               else threshold_bisect(whole, sparsity))
        del whole
        return tree.tree_map(
            lambda s: None if s is None else (
                sharding.DenseBlock(s.data.abs() >= tau, s.spec)
                if isinstance(s, sharding.DenseBlock) else s.abs() >= tau),
            score_tree)
    if mesh is not None:
        raise NotImplementedError(f"scope {scope!r} on a mesh: only the "
                                  "global threshold takes blocks")

    def layer_mask(s):
        if s is None:
            return None
        return s.abs() >= _quantile(s.float().abs(), sparsity)

    def row_mask(s):
        if s is None:
            return None
        a = s.float().abs()
        k = max(1, int(round(s.shape[-2] * (1.0 - sparsity))))
        kth = -torch.sort(-a, dim=-2).values[..., k - 1:k, :]
        return a >= kth

    if scope not in ("layer", "row"):
        raise ValueError(f"unknown mask scope {scope!r}")
    return tree.tree_map(layer_mask if scope == "layer" else row_mask,
                         score_tree)


def nm_masks(score_tree: Any, n: int = 2, m: int = 4) -> Any:
    """Keep the top-n of every m contiguous entries along the input dim.

    Rank-based with the reference's tie-break (earlier position wins).  A
    leaf (*lead, d_in, d_out) is ranked as its (prod(lead)*d_in, d_out)
    view: with d_in % m == 0 no group crosses a leading index.  2:4 goes
    through ``nm_mask24`` (the CUDA kernel for CUDA tensors); other N:M
    patterns have no kernel and take the plain ranking.  A
    ``dist.sharding.DenseBlock`` leaf (a rank's block, whole groups along
    d_in: ``dist.sharding.search_specs``) gives its block's masks.
    """
    def leaf(s):
        if s is None:
            return None
        if isinstance(s, sharding.DenseBlock):   # this rank's block
            return sharding.DenseBlock(leaf(s.data), s.spec)
        d_in, d_out = s.shape[-2:]
        if d_in % m:
            raise ValueError(f"d_in={d_in} is not a multiple of m={m}")
        flat = s.reshape(-1, d_out)
        if (n, m) == (2, 4):
            keep = nm_mask24(flat.contiguous())
        else:
            keep = ref.nm_mask_ref(flat, n, m)
        return keep.reshape(s.shape)

    return tree.tree_map(leaf, score_tree)


def apply_masks(params: Any, masks: Any) -> Any:
    """W0 * M, with None masks passing weights through untouched (a
    ``dist.sharding.DenseBlock`` leaf and its mask block: the block's)."""
    def leaf(w, m):
        if m is None:
            return w
        if isinstance(m, sharding.DenseBlock):
            return sharding.DenseBlock(w.data * m.data.to(w.dtype), w.spec)
        return w * m.to(w.dtype)

    return tree.tree_map(leaf, params, masks)


def sparsity_of(masks: Any) -> float:
    """The fraction of masked-out entries over every non-None mask leaf
    (the kept count summed on the device, read once)."""
    tot = 0
    kept = None
    for m in tree.leaves(masks):
        if m is None:
            continue
        tot += m.numel()
        k = m.sum(dtype=torch.int64)
        kept = k if kept is None else kept + k
    return 1.0 - (0 if kept is None else int(kept)) / max(tot, 1)
