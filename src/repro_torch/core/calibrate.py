"""One-shot local-metric masks.  Port of ``repro.core.calibrate``'s
``baseline_masks``; the calibration drivers (stats, mirror-descent search)
come with calibration."""
from __future__ import annotations

from typing import Any

from repro_torch.core import masks as masks_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core.prunable import prunable_map


def baseline_masks(method: str, params0: Any, stats: Any, sparsity: float,
                   *, mode: str = "unstructured", scope: str = "row",
                   nm: tuple[int, int] = (2, 4)) -> Any:
    """Local-metric one-shot baselines (no search stage)."""
    prunable = prunable_map(params0)
    S = metrics_mod.metric_tree(method, params0, stats, prunable)
    if mode == "nm":
        return masks_mod.nm_masks(S, *nm)
    if method == "magnitude" and scope == "row":
        scope = "layer"  # magnitude baseline is layer-wise in the paper
    return masks_mod.unstructured_masks(S, sparsity, scope=scope)
