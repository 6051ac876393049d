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


def ria_sums_block(w, lay, row_w=None, col_w=None):
    """:func:`ria_sums` of the whole leaf, on this rank's block ``w``
    (``lay`` its ``dist.sharding.LeafLayout``): the block's partial sums
    summed over the ranks that split the summed dim; ``row_w`` / ``col_w``
    are the whole leaf's weights (their mean is the whole vector's)."""
    aw = w.float().abs()
    if row_w is None:
        return (lay.sum_n(aw.sum(dim=-1, keepdim=True)),
                lay.sum_k(aw.sum(dim=-2, keepdim=True)))
    rb, cb = lay.slice(row_w, -1), lay.slice(col_w, -2)
    return (lay.sum_n((aw * rb).sum(dim=-1, keepdim=True)) / row_w.mean(),
            lay.sum_k((aw * cb).sum(dim=-2, keepdim=True)) / col_w.mean())


def _ria_core(w, a, row_w=None, col_w=None, eps=1e-12, lay=None):
    aw = w.float().abs()
    rowsum, colsum = (ria_sums(w, row_w, col_w) if lay is None else
                      ria_sums_block(w, lay, row_w, col_w))
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


def block_metric(name: str, w: torch.Tensor, a, *, key, lay,
                 stoch_frac: float = 0.9) -> torch.Tensor:
    """S of this rank's block ``w`` of a leaf (``a`` its stats block,
    ``lay`` its ``dist.sharding.LeafLayout``), equal to the whole leaf's S
    on the block: RIA's row and column sums are the whole leaf's, and
    stochria draws the whole leaf's weights (the key's, as
    :func:`stochria` draws them) and takes the block's slices."""
    if name in ("magnitude", "wanda"):
        return get_metric(name)(w, a)
    if name not in ("ria", "stochria"):
        raise ValueError(f"unknown metric {name!r}; options: {METRICS}")
    weights = ()
    if name == "stochria" and key is not None:
        weights = stoch_weights(key, lay.whole_shape(w), stoch_frac,
                                w.device)
    return _ria_core(w, a, *weights, lay=lay)


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


def normalize_scores(s: torch.Tensor, how: str, lay=None) -> torch.Tensor:
    """Per-tensor scale normalization: makes saliency cross-layer comparable
    so one global budget can redistribute sparsity across layers.  The
    normaliser is a constant (detached, as ``stop_gradient`` in JAX).
    ``lay``: ``s`` is this rank's block of the leaf
    (``dist.sharding.LeafLayout``), normalised by the whole leaf's
    :func:`score_divisor`."""
    if how == "none":
        return s
    if lay is not None:
        return s / score_divisor(s, how, lay)
    if how == "mean":
        return s / (s.detach().mean() + 1e-12)
    if how == "median":
        return s / (median_element(s) + 1e-12)
    raise ValueError(how)


def score_divisor(s: torch.Tensor, how: str, lay) -> torch.Tensor:
    """The whole leaf's normaliser (+ 1e-12) from this rank's block ``s``:
    the median of the leaf's scores (``LeafLayout.median``: exact, without
    gathering them), or their sum over the leaf's ranks over its element
    count."""
    if how == "median":
        return lay.median(s) + 1e-12
    if how == "mean":
        n = torch.full((), float(lay.numel(s)), dtype=torch.float32,
                       device=s.device)
        return lay.total(s.detach().sum()) / n + 1e-12
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
