"""Mask export from the mirror-descent state.  Port of
``repro.core.mirror.export_masks``; the search itself comes with
calibration."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.core import masks as masks_mod


def _absmax(leaves: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([x.abs().max() for x in leaves]).max()


def export_masks(pcfg, Gamma: Any, sparsity: float, *, V: Any = None,
                 exact: bool = True) -> Any:
    """One-shot mask extraction from the final Gamma (any sparsity level).

    Soft-thresholded-to-zero entries tie at |Gamma| = 0; the dual V keeps
    their sub-threshold saliency, so it breaks ties at an epsilon scale
    that cannot reorder any nonzero Gamma entries.  The arithmetic is the
    reference's, op for op in f32, so the masks are bit-identical.
    """
    scores = Gamma
    if V is not None:
        gl = [g for g in tree.leaves(Gamma) if g is not None]
        vl = [v for v in tree.leaves(V) if v is not None]
        dev = (gl or vl)[0].device
        gmax = (_absmax(gl) if gl
                else torch.tensor(0.0, dtype=torch.float32, device=dev))
        vmax = (_absmax(vl) if vl
                else torch.tensor(1.0, dtype=torch.float32, device=dev))
        vsafe = torch.clamp_min(vmax, 1e-30)
        eps = torch.where(gmax > 0,
                          1e-6 * torch.clamp_min(gmax, 1e-30) / vsafe,
                          1.0 / vsafe)
        scores = tree.tree_map(
            lambda g, v: None if g is None else g.abs() + eps * v.abs(),
            Gamma, V)
    if pcfg.mode == "nm":
        return masks_mod.nm_masks(scores, pcfg.nm_n, pcfg.nm_m)
    return masks_mod.unstructured_masks(scores, sparsity, scope="global",
                                        exact=exact)
