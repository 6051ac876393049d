"""Step functions.  Port of ``repro.launch.steps``'s makers:

  train   -> :func:`make_train_step` (fwd + bwd + AdamW, gradient
             accumulation over microbatches, remat)
  prefill -> :func:`make_prefill` (fwd, fills KV caches, last-token logits)
  decode  -> :func:`make_decode` (1 token against a cache)
  search  -> :func:`make_search_step` (the UniPruning mirror-descent step)

A step takes and returns the reference's values; where the reference's
launcher donates the params and optimizer state to a jitted step, the
train step here updates them in place.  Under ``rules`` (one process a
rank, ``dist.axes.use_rules``) the train step's params and AdamW state
are each rank's blocks (``models.model.init_params(rules=)``,
``optim.optimizers.adamw_init``), for llama and mixtral.

The input specs of a (config, shape cell) - :func:`token_specs`,
:func:`cache_specs`, :func:`input_specs` - are the reference's
``ShapeDtypeStruct`` stand-ins as tensors on the ``meta`` device: shapes
and dtypes, no storage.  The audio and vision frontends are stubs: the
specs carry their precomputed ``frames`` / ``patches`` embeddings, and
whisper splits a cell's sequence as encoder S/2 + decoder S/2.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.dist.axes import use_rules
from repro_torch.dist.sharding import block_data, like_block
from repro_torch.kernels.shard import whole_weights
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt
from repro_torch.optim.losses import lm_loss

PyTree = Any


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    B, S = cell.global_batch, cell.seq_len
    if cfg.is_encoder_decoder:
        return {"tokens": _spec((B, S // 2), torch.int32),
                "frames": _spec((B, S // 2, cfg.d_model), torch.bfloat16)}
    if cfg.vit_dim:
        return {"tokens": _spec((B, S - cfg.num_image_tokens), torch.int32),
                "patches": _spec((B, cfg.num_image_tokens, cfg.vit_dim),
                                 torch.bfloat16)}
    return {"tokens": _spec((B, S), torch.int32)}


def cache_capacity(cfg: ModelConfig, cell: ShapeCell) -> int:
    return cell.seq_len // 2 if cfg.is_encoder_decoder else cell.seq_len


def cache_specs(cfg: ModelConfig, cell: ShapeCell) -> list:
    """The decode caches of the cell (``models.model.init_caches``) on the
    meta device."""
    enc_len = cell.seq_len // 2 if cfg.is_encoder_decoder else 0
    return M.init_caches(cfg, cell.global_batch, cache_capacity(cfg, cell),
                         device="meta", enc_len=enc_len)


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Every input of the cell's step function but the weights and the
    optimizer state."""
    if cell.kind in ("train", "prefill"):
        return {"batch": token_specs(cfg, cell)}
    return {"token": _spec((cell.global_batch,), torch.int32),
            "caches": cache_specs(cfg, cell),
            "t": _spec((), torch.int32)}


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
                    cast_bf16: bool = False, rules=None):
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

    ``rules``: the params and ``ostate`` are this rank's blocks (a leaf the
    mesh shards a ``dist.sharding.DenseBlock``, the others whole), every
    rank runs the whole batch (activations replicated, ROADMAP R26) with
    each block gathered whole, as its bf16 cast, where the model uses it
    (``kernels.shard.whole_weights``), and keeps its block of each
    gradient; the AdamW update runs on the blocks and the global norm is
    the whole tree's (``optim.optimizers``).  The ranks compute one
    process's step bit for bit (ROADMAP R28).  llama and mixtral only
    (``models.model.check_tp_supported``).
    """
    if rules is not None:
        M.check_tp_supported(cfg, "tensor-parallel training")
    mesh = None if rules is None else rules.mesh

    def train_step(params, ostate, batch):
        dev = tree.device_of(params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        rows = batch["tokens"].shape[0]
        if rows % accum:
            raise ValueError(f"accum={accum} must divide the batch's "
                             f"{rows} rows")
        m = rows // accum
        flat = tree.leaves(params)
        leaves = [
            (p.to(torch.bfloat16) if cast_bf16 and p.dtype == torch.float32
             and p.dim() >= 2 else p).detach().requires_grad_(True)
            for p in map(block_data, flat)]
        compute = tree.unflatten_like(params, [
            like_block(p, x) for p, x in zip(flat, leaves)])
        acc, losses = None, []
        for j in range(accum):
            mb = {k: v[j * m:(j + 1) * m] for k, v in batch.items()}
            with torch.enable_grad(), use_rules(rules), (
                    whole_weights() if rules is not None
                    else contextlib.nullcontext()):
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
        g = tree.unflatten_like(params, [
            like_block(p, a / div if accum > 1 else a)
            for p, a in zip(flat, acc)])
        params, ostate, om = opt.adamw_update(ocfg, g, ostate, params,
                                              mesh=mesh)
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
