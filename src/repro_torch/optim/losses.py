"""Task loss.  Port of ``repro.optim.losses.lm_loss`` (perplexity eval
comes with the benchmarks)."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def lm_loss(cfg: ModelConfig, params: Any, batch: dict, *,
            aux_weight: float = 0.01):
    """Next-token cross entropy over f32 log-softmax.  batch["tokens"]:
    (B, S); optional batch["mask"]: (B, S) loss weights.  Returns
    (loss, {"nll", "aux"}), device scalars."""
    logits, aux, _ = M.forward(cfg, params, batch)
    tokens = M._tokens(params, batch["tokens"])
    targets = tokens[:, 1:]
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    w = batch.get("mask")
    w = (torch.ones_like(nll) if w is None
         else torch.as_tensor(w, device=nll.device)[:, 1:].float())
    token_nll = (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)
    loss = token_nll + aux_weight * aux
    return loss, {"nll": token_nll, "aux": aux}
