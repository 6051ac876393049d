"""Local saliency metrics S(W, X).  Port of ``repro.core.metrics``.

All metrics operate on a kernel W of shape (*lead, d_in, d_out) with
optional activation stats a of shape (*lead, d_in) = per-input-feature L2
norm over the calibration set.  When a is None they degrade to their
weight-only form (magnitude).

  magnitude : |W|                                     (Zhu & Gupta 2017)
  wanda     : |W| * a[..., None]                      (Sun et al. 2024)
  ria       : (|W|/rowsum + |W|/colsum) * a^0.5       (Zhang et al. 2024)
  stochria  : RIA with subsampled row/col sums        (Yi & Richtarik 2025)

They are differentiable in W (abs subgradient), which the mirror-descent
alignment term relies on.  The f32 arithmetic is the reference's, op for op.

Randomness: ``key`` is a threefry key, the reference's (``core.prng``:
the pair of uint32 words ``jax.random.key_data`` gives), and
``metric_tree`` gives leaf i the key ``fold_in(key, i)``.  stochria splits
it and draws its Bernoulli row and column weights as the reference does,
bit for bit, on the device of the kernel, so the card and the CPU draw the
same masks.
"""
from __future__ import annotations

from functools import partial
from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import prng
from repro_torch.kernels.ref import sqrt_f32

METRICS = ("magnitude", "wanda", "ria", "stochria")


def magnitude(w: torch.Tensor, a=None, *, key=None) -> torch.Tensor:
    return w.float().abs()


def wanda(w: torch.Tensor, a=None, *, key=None) -> torch.Tensor:
    s = w.float().abs()
    if a is not None:
        s = s * a[..., None]
    return s


def ria_sums(w, row_w=None, col_w=None):
    """RIA's normalisers of |w|: rowsum over d_out for each input row,
    colsum over d_in per output column (keepdim), or their subsampled
    estimates over the row_w (d_out,) / col_w (d_in, 1) weights."""
    aw = w.float().abs()
    if row_w is None:
        return aw.sum(dim=-1, keepdim=True), aw.sum(dim=-2, keepdim=True)
    return ((aw * row_w).sum(dim=-1, keepdim=True) / row_w.mean(),
            (aw * col_w).sum(dim=-2, keepdim=True) / col_w.mean())


def _ria_core(w, a, row_w=None, col_w=None, eps=1e-12):
    aw = w.float().abs()
    rowsum, colsum = ria_sums(w, row_w, col_w)
    s = aw / (rowsum + eps) + aw / (colsum + eps)
    if a is not None:
        s = s * sqrt_f32(torch.clamp_min(a, 1e-12))[..., None]
    return s


def ria(w: torch.Tensor, a=None, *, key=None) -> torch.Tensor:
    return _ria_core(w, a)


def stoch_weights(key: prng.Key, shape: tuple[int, ...], frac: float,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """stochria's Bernoulli(frac) row weights (d_out,) and column weights
    (d_in, 1) for a (..., d_in, d_out) kernel, f32 on ``device``: the
    reference's ``split`` of ``key`` and its two ``bernoulli`` draws."""
    k1, k2 = prng.split(key)
    row_w = prng.bernoulli(k1, frac, shape[-1:], device).float()
    col_w = prng.bernoulli(k2, frac, shape[-2:-1], device).float()
    return row_w, col_w[:, None]


def stochria(w: torch.Tensor, a=None, *, key=None,
             frac: float = 0.9) -> torch.Tensor:
    """RIA with Bernoulli-subsampled row/col sums (stochastic normalizers)."""
    if key is None:
        return _ria_core(w, a)
    row_w, col_w = stoch_weights(key, tuple(w.shape), frac, w.device)
    return _ria_core(w, a, row_w=row_w, col_w=col_w)


def get_metric(name: str, stoch_frac: float = 0.9):
    if name == "magnitude":
        return magnitude
    if name == "wanda":
        return wanda
    if name == "ria":
        return ria
    if name == "stochria":
        return partial(stochria, frac=stoch_frac)
    raise ValueError(f"unknown metric {name!r}; options: {METRICS}")


def median_element(s: torch.Tensor) -> torch.Tensor:
    """``sort(s.flatten())[s.numel() // 2]``, exactly, as a device scalar.

    The largest n - n // 2 entries are sorted[n // 2:], so their minimum is
    that element: a multi-block radix selection (``torch.topk``) instead of
    a full sort, and no host sync.  (``torch.kthvalue`` gives one thread
    block to a whole slice on the card, far slower at 268M entries.)
    """
    flat = s.detach().reshape(-1)
    n = flat.numel()
    return torch.topk(flat, n - n // 2, sorted=False).values.min()


def normalize_scores(s: torch.Tensor, how: str) -> torch.Tensor:
    """Per-tensor scale normalization: makes saliency cross-layer comparable
    so one global budget can redistribute sparsity across layers.  The
    normaliser is a constant (detached, as ``stop_gradient`` in JAX)."""
    if how == "none":
        return s
    if how == "mean":
        return s / (s.detach().mean() + 1e-12)
    if how == "median":
        return s / (median_element(s) + 1e-12)
    raise ValueError(how)


def metric_tree(name: str, params: Any, stats: Any, prunable: Any,
                key: prng.Key | None = None, stoch_frac: float = 0.9,
                norm: str = "none") -> Any:
    """Apply the metric leafwise over prunable kernels; None elsewhere.

    ``stats`` and ``prunable`` must mirror the params structure (a stats
    tree of None leaves for the weight-only metric).  Leaf i (in flatten
    order over all leaves) draws from ``fold_in(key, i)``.
    """
    fn = get_metric(name, stoch_frac)
    flat = tree.flatten_with_path(params)
    flat_stats = tree.leaves(stats)
    flat_pr = tree.leaves(prunable)
    if len(flat_stats) != len(flat) or len(flat_pr) != len(flat):
        raise ValueError(
            f"metric_tree leaf mismatch: params={len(flat)} "
            f"stats={len(flat_stats)} prunable={len(flat_pr)} leaves - the "
            "stats/prunable trees must mirror the params structure")
    out = {}
    for i, ((path, w), a, pr) in enumerate(zip(flat, flat_stats, flat_pr)):
        if pr:
            k = None if key is None else prng.fold_in(key, i)
            out[path] = normalize_scores(fn(w, a, key=k), norm)
    return tree.map_with_path(lambda path, _: out.get(path), params)
