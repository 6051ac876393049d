"""Per-layer-kind blocks.  Port of ``repro.models.blocks`` for the ``attn``
kind (pre-norm attention + gated MLP, the llama block); every other kind
raises until its family is ported.

Every block kind exposes:
  block_init(kind, b, cfg)                          -> params
  block_apply_full(kind, cfg, p, x, ctx)            -> (x, cache|None)
  block_init_cache(kind, cfg, batch, capacity, ...) -> cache entry
  block_apply_decode(kind, cfg, p, x, cache, t)     -> (x, cache)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.common import Builder
from repro_torch.models.mlp import mlp_apply, mlp_init

PyTree = Any
KINDS = ("attn",)


@dataclasses.dataclass
class Ctx:
    """Per-call context for full (prefill) passes."""
    positions: torch.Tensor              # (B, S)
    cache_capacity: int = 0              # 0 -> no cache output


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  f"(ported: {KINDS})")


def _norm_init(b: Builder, cfg: ModelConfig) -> PyTree:
    return cm.rmsnorm_init(b, cfg.d_model)


def _norm(cfg: ModelConfig, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    return cm.rmsnorm(p, x, eps=cfg.norm_eps)


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                use_rope=cfg.use_rope, scale=cfg.attn_scale or None)


def block_init(kind: str, b: Builder, cfg: ModelConfig) -> PyTree:
    _check_kind(kind)
    return {
        "ln1": _norm_init(b, cfg),
        "attn": attn.attn_init(b, d_model=cfg.d_model,
                               num_heads=cfg.num_heads,
                               num_kv=cfg.num_kv_heads,
                               head_dim=cfg.head_dim),
        "ln2": _norm_init(b, cfg),
        "mlp": mlp_init(b, cfg.d_model, cfg.d_ff),
    }


def block_apply_full(kind: str, cfg: ModelConfig, p: PyTree,
                     x: torch.Tensor, ctx: Ctx):
    _check_kind(kind)
    a, cache = attn.attn_apply_full(
        p["attn"], _norm(cfg, p["ln1"], x), positions=ctx.positions,
        cache_capacity=ctx.cache_capacity, **_attn_kwargs(cfg))
    x = x + a
    return x + mlp_apply(p["mlp"], _norm(cfg, p["ln2"], x), act=cfg.act), cache


def block_init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                     *, device, lead: tuple = ()) -> PyTree:
    _check_kind(kind)
    return attn.make_kv_cache(batch, capacity, cfg.num_kv_heads,
                              cfg.head_dim, device=device, lead=lead)


def block_apply_decode(kind: str, cfg: ModelConfig, p: PyTree,
                       x: torch.Tensor, cache: PyTree, t: torch.Tensor):
    _check_kind(kind)
    a, cache = attn.attn_apply_decode(
        p["attn"], _norm(cfg, p["ln1"], x), cache, t, **_attn_kwargs(cfg))
    x = x + a
    return x + mlp_apply(p["mlp"], _norm(cfg, p["ln2"], x), act=cfg.act), cache
