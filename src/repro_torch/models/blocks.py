"""Per-layer-kind blocks.  Port of ``repro.models.blocks`` for the
transformer kinds: ``attn`` (pre-norm attention + gated MLP, the llama
block), ``local`` (the same over a sliding window), ``moe`` and
``moe_local`` (attention, global or windowed, + the MoE FFN); every other
kind raises until its family is ported.

Every block kind exposes:
  block_init(kind, b, cfg)                          -> params
  block_apply_full(kind, cfg, p, x, ctx)            -> (x, aux, cache|None)
  block_init_cache(kind, cfg, batch, capacity, ...) -> cache entry
  block_apply_decode(kind, cfg, p, x, cache, t, kv_shards=None)
                                                    -> (x, cache)

aux is the MoE load-balance loss (None for the MLP kinds).  Windowed kinds
keep a KV ring of min(capacity, sliding_window) slots (:func:`cache_length`);
``kv_shards`` picks the decode attention path (``attention.decode_attend``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Builder
from repro_torch.models.mlp import mlp_apply, mlp_init

PyTree = Any
KINDS = ("attn", "local", "moe", "moe_local")
_LOCAL = ("local", "moe_local")


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


def _residual_norm(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                   a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + a, norm(x + a)), both in x.dtype; the norm takes the sum in f32,
    not rounded first.

    The compiled reference fuses the residual add into the norm, and XLA
    (``xla_allow_excess_precision``, on by default) keeps the sum in f32
    there, while the residual stream itself carries the bf16-rounded sum.
    Rounding the sum before the norm differs from it by an ulp here and
    there, enough to flip a near-tied MoE routing decision.  One f32 sum
    serves both (a bf16 add rounds the same f32 sum).
    """
    s = x.float() + a
    return s.to(x.dtype), _norm(cfg, p, s).to(x.dtype)


def _attn_kwargs(cfg: ModelConfig, *, local: bool) -> dict:
    theta = cfg.rope_theta
    if local and cfg.local_rope_theta:
        theta = cfg.local_rope_theta
    return dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_theta=theta,
                use_rope=cfg.use_rope,
                window=cfg.sliding_window if local else 0,
                scale=cfg.attn_scale or None)


def block_init(kind: str, b: Builder, cfg: ModelConfig) -> PyTree:
    _check_kind(kind)
    p = {
        "ln1": _norm_init(b, cfg),
        "attn": attn.attn_init(b, d_model=cfg.d_model,
                               num_heads=cfg.num_heads,
                               num_kv=cfg.num_kv_heads,
                               head_dim=cfg.head_dim),
        "ln2": _norm_init(b, cfg),
    }
    if kind in ("moe", "moe_local"):
        p["moe"] = moe_mod.moe_init(
            b, d_model=cfg.d_model, d_ff=cfg.moe_d_ff or cfg.d_ff,
            num_experts=cfg.num_experts,
            # the reference's rule; it only names the banks' axes here
            expert_sharded=cfg.num_experts % 16 == 0)
    else:
        p["mlp"] = mlp_init(b, cfg.d_model, cfg.d_ff)
    return p


def _ffn_apply(cfg: ModelConfig, p: PyTree, x: torch.Tensor):
    if "moe" in p:
        return moe_mod.moe_apply(
            p["moe"], x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act)
    return mlp_apply(p["mlp"], x, act=cfg.act), None


def block_apply_full(kind: str, cfg: ModelConfig, p: PyTree,
                     x: torch.Tensor, ctx: Ctx):
    _check_kind(kind)
    a, cache = attn.attn_apply_full(
        p["attn"], _norm(cfg, p["ln1"], x), positions=ctx.positions,
        cache_capacity=ctx.cache_capacity,
        **_attn_kwargs(cfg, local=kind in _LOCAL))
    h, n = _residual_norm(cfg, p["ln2"], x, a)
    f, aux = _ffn_apply(cfg, p, n)
    return h + f, aux, cache


def cache_length(kind: str, cfg: ModelConfig, capacity: int) -> int:
    """Slots of a ``kind`` layer's KV ring at ``capacity``."""
    _check_kind(kind)
    if kind in _LOCAL and cfg.sliding_window:
        return min(capacity, cfg.sliding_window)
    return capacity


def block_init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                     *, device, lead: tuple = ()) -> PyTree:
    return attn.make_kv_cache(batch, cache_length(kind, cfg, capacity),
                              cfg.num_kv_heads, cfg.head_dim, device=device,
                              lead=lead)


def block_apply_decode(kind: str, cfg: ModelConfig, p: PyTree,
                       x: torch.Tensor, cache: PyTree, t: torch.Tensor, *,
                       kv_shards: int | None = None):
    _check_kind(kind)
    a, cache = attn.attn_apply_decode(
        p["attn"], _norm(cfg, p["ln1"], x), cache, t, kv_shards=kv_shards,
        **_attn_kwargs(cfg, local=kind in _LOCAL))
    h, n = _residual_norm(cfg, p["ln2"], x, a)
    f, _ = _ffn_apply(cfg, p, n)
    return h + f, cache


# kinds with a parallel verify path: full-capacity attention rings
VERIFY_KINDS = ("attn", "moe")


def block_apply_verify(kind: str, cfg: ModelConfig, p: PyTree,
                       x: torch.Tensor, cache: PyTree, t: torch.Tensor):
    """Teacher-forced S-token decode (speculative verify): one pass over S
    fed tokens per row, write-then-attend against the slot's ring
    (``attention.attn_apply_verify``).  Only full-ring attention kinds
    have it: windowed rings can wrap mid-chunk and recurrent state cannot
    roll back."""
    if kind in ("mla_dense", "mla_moe"):
        raise ValueError(f"kind {kind!r}: MLA verify is not ported yet "
                         "(ROADMAP A item 4)")
    if kind not in VERIFY_KINDS:
        raise ValueError(f"kind {kind!r} has no parallel verify path "
                         "(spec decode gates on SPEC_SAFE_KINDS)")
    kw = _attn_kwargs(cfg, local=False)
    del kw["window"]
    a, cache = attn.attn_apply_verify(p["attn"], _norm(cfg, p["ln1"], x),
                                      cache, t, **kw)
    h, n = _residual_norm(cfg, p["ln2"], x, a)
    f, _ = _ffn_apply(cfg, p, n)
    return h + f, cache
