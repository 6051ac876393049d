"""Task loss and perplexity evaluation.  Port of ``repro.optim.losses``."""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def lm_loss(cfg: ModelConfig, params: Any, batch: dict, *,
            remat: bool = False, aux_weight: float = 0.01,
            unroll: bool = False):
    """Next-token cross entropy over f32 log-softmax.  batch["tokens"]:
    (B, S); optional batch["mask"]: (B, S) loss weights; a vision batch's
    image-prefix positions take no loss.  Returns
    (loss, {"nll", "aux"}), device scalars.  ``remat``: recompute each
    layer in the backward; ``unroll``: the eager stats tape's pass (both
    ``models.model.forward``)."""
    logits, aux, _ = M.forward(cfg, params, batch, remat=remat,
                               unroll=unroll)
    tokens = M._tokens(params, batch["tokens"])
    if cfg.vit_dim and "patches" in batch:  # the image prefix: no loss
        logits = logits[:, -tokens.shape[1]:]
    targets = tokens[:, 1:]
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    w = batch.get("mask")
    w = (torch.ones_like(nll) if w is None
         else torch.as_tensor(w, device=nll.device)[:, 1:].float())
    token_nll = (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)
    loss = token_nll + aux_weight * aux
    return loss, {"nll": token_nll, "aux": aux}


def _device(params: Any) -> torch.device:
    return params["embed"]["table"].device


@torch.no_grad()
def eval_nll(cfg: ModelConfig, params: Any, batches: list[dict]
             ) -> tuple[torch.Tensor, int]:
    """(sum over batches of the batch's mean NLL times its target count, as
    an f32 device scalar; the target count).  Batches already on the
    params' device run without a host sync."""
    dev = _device(params)
    tot_nll = torch.zeros((), dtype=torch.float32, device=dev)
    tot_tok = 0
    for b in batches:
        n = (b["tokens"].shape[1] - 1) * b["tokens"].shape[0]
        tot_nll = tot_nll + lm_loss(cfg, params, b)[1]["nll"] * n
        tot_tok += n
    return tot_nll, tot_tok


def eval_ppl(cfg: ModelConfig, params: Any, batches: list[dict]) -> float:
    """Perplexity over a list of batches (held-out synthetic corpus): exp
    of the token-weighted mean NLL, clamped at 30.

    The batches go to the device first; the weighted NLL then accumulates
    as a device scalar (:func:`eval_nll`) and is read exactly once, at the
    end, as the reference's does (REPRO001).  Dense, masked-dense and
    2:4-compressed (``SparseTensor``) params all run through the forward.
    """
    dev = _device(params)
    staged = [{k: torch.as_tensor(v, device=dev) for k, v in b.items()}
              for b in batches]
    tot_nll, tot_tok = eval_nll(cfg, params, staged)
    return math.exp(min(float(tot_nll) / max(tot_tok, 1), 30.0))
