"""Which parameters UniPruning prunes.  Port of ``repro.core.prunable``.

Every 2-D+ projection kernel, excluding embeddings, routers, convs, norms,
positional tables and small adapters.  Expert banks (E, d_in, d_out) are
included, their leading expert dim treated as batch.
"""
from __future__ import annotations

from typing import Any

from repro_torch import tree

EXCLUDE_SUBSTRINGS = (
    "embed", "lm_head", "router", "conv", "pos_embed", "vit_proj",
    "frame_proj", "lora_", "['r']",  # sLSTM recurrent gate kernel: kept dense
)


def is_prunable_path(pathstr: str, leaf: Any) -> bool:
    if not hasattr(leaf, "ndim") or leaf.ndim < 2:
        return False
    if "kernel" not in pathstr:
        return False
    return not any(s in pathstr for s in EXCLUDE_SUBSTRINGS)


def prunable_map(params: Any) -> Any:
    """Tree of bools (True = prunable) matching params."""
    return tree.map_with_path(is_prunable_path, params)
