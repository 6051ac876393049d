"""Step functions.  Port of ``repro.launch.steps``'s makers:

  train   -> :func:`make_train_step` (fwd + bwd + AdamW, gradient
             accumulation over microbatches, remat)
  prefill -> :func:`make_prefill` (fwd, fills KV caches, last-token logits)
  decode  -> :func:`make_decode` (1 token against a cache)
  search  -> :func:`make_search_step` (the UniPruning mirror-descent step)

A step takes and returns the reference's values; where the reference's
launcher donates the params and optimizer state to a jitted step, the
train step here updates them in place.  The reference's
``ShapeDtypeStruct`` input specs (``token_specs``, ``cache_specs``,
``input_specs``) serve its static analysis and come with ROADMAP A item 8.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.optim.losses import lm_loss

PyTree = Any


def cache_capacity(cfg: ModelConfig, cell: ShapeCell) -> int:
    return cell.seq_len // 2 if cfg.is_encoder_decoder else cell.seq_len


def choose_accum(cfg: ModelConfig, cell: ShapeCell, dp: int,
                 target_per_device: int = 1) -> int:
    """Grad-accum factor so each device sees ~target_per_device rows/micro."""
    per_dev = max(cell.global_batch // dp, 1)
    accum = max(per_dev // target_per_device, 1)
    while cell.global_batch % (accum * dp) != 0 and accum > 1:
        accum -= 1
    return accum


def make_train_step(cfg: ModelConfig, ocfg: opt.AdamWConfig, *,
                    accum: int = 1, remat: bool = True,
                    cast_bf16: bool = False):
    """``train_step(params, ostate, batch) -> (params, ostate, {"loss",
    "grad_norm", "lr"})``, the reference's step:

    * the batch (numpy or tensors, moved to the params' device) splits
      along its rows into ``accum`` microbatches, the reference's reshape
      to (accum, B / accum, ...);
    * with ``cast_bf16`` every f32 leaf of two or more dims is cast to bf16
      once, before the microbatch loop, and the gradients are taken with
      respect to those bf16 copies, as the reference's are;
    * each microbatch's gradient is added in f32 (the first one is the
      accumulator: 0 + g == g), the sum divided by ``accum``, then
      :func:`~repro_torch.optim.optimizers.adamw_update` updates params and
      ``ostate`` in place;
    * ``loss`` is the mean of the microbatch losses.

    Metrics are device scalars: the step reads nothing back to the host.
    """
    def train_step(params, ostate, batch):
        dev = tree.device_of(params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        rows = batch["tokens"].shape[0]
        if rows % accum:
            raise ValueError(f"accum={accum} must divide the batch's "
                             f"{rows} rows")
        m = rows // accum
        leaves = [
            (p.to(torch.bfloat16) if cast_bf16 and p.dtype == torch.float32
             and p.dim() >= 2 else p).detach().requires_grad_(True)
            for p in tree.leaves(params)]
        compute = tree.unflatten_like(params, leaves)
        acc, losses = None, []
        for j in range(accum):
            mb = {k: v[j * m:(j + 1) * m] for k, v in batch.items()}
            with torch.enable_grad():
                loss, _ = lm_loss(cfg, compute, mb, remat=remat)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros(x.shape, dtype=torch.float32, device=dev)
                     if g is None else g.float()
                     for x, g in zip(leaves, grads)]
            acc = grads if acc is None else [a + g for a, g in
                                             zip(acc, grads)]
            losses.append(loss.detach())
        del compute, leaves
        div = torch.full((), float(accum), dtype=torch.float32, device=dev)
        g = tree.unflatten_like(params, [a / div for a in acc]
                                if accum > 1 else acc)
        params, ostate, om = opt.adamw_update(ocfg, g, ostate, params)
        return params, ostate, {"loss": torch.stack(losses).mean(), **om}

    return train_step


def make_prefill(cfg: ModelConfig, cell: ShapeCell):
    cap = cache_capacity(cfg, cell)

    def serve_prefill(params, batch):
        return M.prefill(cfg, params, batch, cache_capacity=cap)

    return serve_prefill


def make_decode(cfg: ModelConfig, cell: ShapeCell, *, seq_sharded: bool):
    """The decode step.  ``seq_sharded`` lays the KV sequence over the
    reference's mesh; one card holds it whole, so True raises until
    tensor parallelism lands (ROADMAP A item 7)."""
    if seq_sharded:
        raise NotImplementedError(
            "seq_sharded decode lays the KV cache over several cards: not "
            "ported yet (ROADMAP A item 7)")

    def serve_step(params, token, caches, t):
        return M.decode_step(cfg, params, token, caches, t)

    return serve_step


def make_search_step(cfg: ModelConfig, pcfg, *, remat: bool = True):
    """UniPruning mirror-descent step (the paper's workload); updates the
    search state in place (``core.mirror.search_step``)."""
    from repro_torch.core import mirror

    def loss_fn(W, batch):
        return lm_loss(cfg, W, batch, remat=remat)

    def search_step(state, batch, stats, prunable):
        return mirror.search_step(pcfg, loss_fn, state, batch, stats,
                                  prunable)

    return search_step
