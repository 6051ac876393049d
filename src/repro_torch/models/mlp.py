"""Feed-forward block: the gated MLP of llama (silu) and gemma (gelu).
Port of ``repro.models.mlp`` (the ungated variant comes with its
family)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tape as _tape
from repro_torch.models import common as cm
from repro_torch.models.common import Builder
from repro_torch.sparse.formats import SparseTensor

PyTree = Any


def mlp_init(b: Builder, d_model: int, d_ff: int) -> PyTree:
    return {
        "up": cm.dense_init(b, d_model, d_ff, ("embed", "mlp")),
        "gate": cm.dense_init(b, d_model, d_ff, ("embed", "mlp")),
        "down": cm.dense_init(b, d_ff, d_model, ("mlp", "embed")),
    }


def mlp_apply(p: PyTree, x: torch.Tensor, *, act: str = "silu"
              ) -> torch.Tensor:
    """Gated MLP: down(act(gate(x)) * up(x)), act silu or gelu
    (``common.act``).  A compressed up/gate pair runs as two kernel
    launches over the same x (``sparse_dense2``)."""
    if _both_sparse(p["up"], p["gate"]):
        from repro_torch.sparse.apply import sparse_dense2
        h, g = sparse_dense2(p["up"]["kernel"], p["gate"]["kernel"], x)
    else:
        h = cm.dense(p["up"], x)
        g = cm.dense(p["gate"], x)
    a = cm.act(g, act)
    tape_x = None
    if isinstance(_tape.current_tape(), _tape.JitTape):
        # the jitted reference's stats pass fuses this product into the
        # down projection's sum of squares and keeps it in f32 there
        # (XLA's excess precision): give the tape the unrounded product
        # (the eager tape, as the reference's, sees the bf16 product)
        tape_x = a.float() * h.float()
    return cm.dense(p["down"], a * h, tape_x=tape_x)


def _both_sparse(a: PyTree, b: PyTree) -> bool:
    return (isinstance(a["kernel"], SparseTensor)
            and isinstance(b["kernel"], SparseTensor)
            and a["kernel"].idx_bits == b["kernel"].idx_bits)
