"""Local saliency metrics S(W, X).  Port of ``repro.core.metrics``.

Only the weight-only ``magnitude`` metric is ported so far: it is what the
one-shot ``baseline_masks`` path needs.  The activation-aware metrics
(wanda, ria, stochria) and score normalisation come with calibration.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree

METRICS = ("magnitude",)


def magnitude(w: torch.Tensor, a=None) -> torch.Tensor:
    return w.float().abs()


def get_metric(name: str):
    if name == "magnitude":
        return magnitude
    raise ValueError(f"metric {name!r} is not ported yet; options: "
                     f"{METRICS}")


def metric_tree(name: str, params: Any, stats: Any, prunable: Any) -> Any:
    """Apply the metric leafwise over prunable kernels; None elsewhere.

    ``stats`` and ``prunable`` must mirror the params structure (a stats
    tree of None leaves for the weight-only metric).
    """
    fn = get_metric(name)
    leaves = tree.leaves(params)
    flat_stats = tree.leaves(stats)
    flat_pr = tree.leaves(prunable)
    if len(flat_stats) != len(leaves) or len(flat_pr) != len(leaves):
        raise ValueError(
            f"metric_tree leaf mismatch: params={len(leaves)} "
            f"stats={len(flat_stats)} prunable={len(flat_pr)} leaves - the "
            "stats/prunable trees must mirror the params structure")
    return tree.tree_map(lambda w, a, pr: fn(w, a) if pr else None,
                         params, stats, prunable)
