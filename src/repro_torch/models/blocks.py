"""Per-layer-kind blocks.  Port of ``repro.models.blocks``: the
transformer kinds ``attn`` (pre-norm attention + gated MLP, the llama
block), ``local`` (the same over a sliding window), ``moe`` and
``moe_local`` (attention, global or windowed, + the MoE FFN), with gemma's
sandwich norms (``post_ln1`` / ``post_ln2`` on the attention and FFN
outputs) where the config sets ``sandwich_norm``; deepseek's ``mla_dense``
and ``mla_moe`` (multi-head latent attention + the gated MLP or the MoE FFN
with its shared experts), whose cache is the latent ring ``{"ckv",
"krope"}``; and the recurrent kinds: zamba2's ``mamba`` (a pre-norm Mamba2
mixer, ``models/ssm.py``) and ``mamba_shared`` (the same, then the model's
ONE weight-shared attention + MLP block with this layer's LoRA deltas on
q, k and v), and xlstm's ``mlstm`` and ``slstm`` (``models/xlstm.py``);
whisper's ``enc`` (the llama block with non-causal self-attention, the
encoder's kind) and ``dec`` (causal self-attention with no rope, then
cross-attention on ``ln_cross`` over the encoder output, then the gated
MLP).  The norm is the config's (``rmsnorm`` or ``layernorm``).  Any
other kind raises.

Every block kind exposes:
  block_init(kind, b, cfg)                          -> params
  block_apply_full(kind, cfg, p, x, ctx, shared=None)
                                                    -> (x, aux, cache|None)
  block_init_cache(kind, cfg, batch, capacity, ...) -> cache entry
  block_apply_decode(kind, cfg, p, x, cache, t, kv_shards=None,
                     shared=None)                   -> (x, cache)

aux is the MoE load-balance loss (None for the other kinds).  Windowed
kinds keep a KV ring of min(capacity, sliding_window) slots
(:func:`cache_length`); ``kv_shards`` picks the decode attention path
(``attention.decode_attend``) of the GQA kinds and of the shared block.
MLA decode has one path, plain torch as the reference's (no
decode-attention kernel): ``serve.engine`` refuses ``kv_shards`` for it,
and a direct call with ``kv_shards`` set raises too.  The recurrent kinds'
caches are their states (``{"mamba": {"h", "conv"}}`` plus the shared
block's ``"kv"`` ring; mLSTM's ``{"C", "n", "m", "conv"}``; sLSTM's ``{"c",
"n", "m", "h"}``), updated in place by decode.  A ``dec`` layer's cache is
its self-attention ring ``"kv"`` and the encoder output's K/V in bf16,
``"cross_k"`` / ``"cross_v"`` (B, Se, K, D), written at prefill and read
whole at every decode step (``kv_shards`` takes both: the cross step is
``attention.decode_attend`` over the Se slots with every one valid).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import Builder
from repro_torch.models.mlp import mlp_apply, mlp_init

PyTree = Any
KINDS = ("attn", "local", "moe", "moe_local", "mla_dense", "mla_moe",
         "mamba", "mamba_shared", "mlstm", "slstm", "enc", "dec")
_LOCAL = ("local", "moe_local")
MLA_KINDS = ("mla_dense", "mla_moe")
# kinds whose cache is a recurrent state (the shared block's ring aside)
RECURRENT_KINDS = ("mamba", "mamba_shared", "mlstm", "slstm")


@dataclasses.dataclass
class Ctx:
    """Per-call context for full (prefill) passes."""
    positions: torch.Tensor              # (B, S)
    cache_capacity: int = 0              # 0 -> no cache output
    encoder_out: torch.Tensor | None = None   # whisper's cross-attention


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(f"layer kind {kind!r} is not ported yet "
                                  f"(ported: {KINDS})")


def _norm_init(b: Builder, cfg: ModelConfig) -> PyTree:
    if cfg.norm == "layernorm":
        return cm.layernorm_init(b, cfg.d_model)
    return cm.rmsnorm_init(b, cfg.d_model)


def _norm(cfg: ModelConfig, p: PyTree, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return cm.layernorm(p, x, eps=cfg.norm_eps)
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


def _post_norm(cfg: ModelConfig, p: PyTree, name: str,
               a: torch.Tensor) -> torch.Tensor:
    """A sandwich norm of a block output (``post_ln1`` after attention,
    ``post_ln2`` after the FFN) where the config has them, rounded to a's
    dtype: the compiled reference keeps this rounding (unlike the sum
    after it, see :func:`_residual_norm`; an unrounded norm output puts
    many outputs of the layer an ulp off the reference's)."""
    if not cfg.sandwich_norm:
        return a
    return _norm(cfg, p[name], a)


def _attn_kwargs(cfg: ModelConfig, *, local: bool) -> dict:
    theta = cfg.rope_theta
    if local and cfg.local_rope_theta:
        theta = cfg.local_rope_theta
    return dict(num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                head_dim=cfg.head_dim, rope_theta=theta,
                use_rope=cfg.use_rope,
                window=cfg.sliding_window if local else 0,
                attn_softcap=cfg.attn_softcap,
                scale=cfg.attn_scale or None)


def _mla_kwargs(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, kv_lora=cfg.kv_lora,
                nope_dim=cfg.qk_nope_dim, rope_dim=cfg.qk_rope_dim,
                v_dim=cfg.v_head_dim, rope_theta=cfg.rope_theta)


def _attn_block_init(kind: str, b: Builder, cfg: ModelConfig) -> PyTree:
    if kind in MLA_KINDS:
        return attn.mla_init(b, d_model=cfg.d_model, num_heads=cfg.num_heads,
                             kv_lora=cfg.kv_lora, nope_dim=cfg.qk_nope_dim,
                             rope_dim=cfg.qk_rope_dim, v_dim=cfg.v_head_dim)
    return attn.attn_init(b, d_model=cfg.d_model, num_heads=cfg.num_heads,
                          num_kv=cfg.num_kv_heads, head_dim=cfg.head_dim,
                          qk_norm=cfg.qk_norm)


def block_init(kind: str, b: Builder, cfg: ModelConfig) -> PyTree:
    _check_kind(kind)
    if kind in RECURRENT_KINDS:
        return _recurrent_init(kind, b, cfg)
    p = {
        "ln1": _norm_init(b, cfg),
        "attn": _attn_block_init(kind, b, cfg),
        "ln2": _norm_init(b, cfg),
    }
    if kind in ("moe", "moe_local", "mla_moe"):
        # mla_moe: the reference takes moe_d_ff as it is (no d_ff fallback)
        p["moe"] = moe_mod.moe_init(
            b, d_model=cfg.d_model,
            d_ff=cfg.moe_d_ff if kind == "mla_moe" else
            cfg.moe_d_ff or cfg.d_ff,
            num_experts=cfg.num_experts, num_shared=cfg.num_shared_experts,
            # the reference's rule; it only names the banks' axes here
            expert_sharded=cfg.num_experts % 16 == 0)
    else:
        p["mlp"] = mlp_init(b, cfg.d_model, cfg.d_ff)
    if cfg.sandwich_norm:
        p["post_ln1"] = _norm_init(b, cfg)
        p["post_ln2"] = _norm_init(b, cfg)
    if kind == "dec":
        p["ln_cross"] = _norm_init(b, cfg)
        p["cross"] = attn.attn_init(b, d_model=cfg.d_model,
                                    num_heads=cfg.num_heads,
                                    num_kv=cfg.num_kv_heads,
                                    head_dim=cfg.head_dim)
    return p


def _ffn_apply(cfg: ModelConfig, p: PyTree, x: torch.Tensor):
    if "moe" in p:
        return moe_mod.moe_apply(
            p["moe"], x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            act=cfg.act)
    return mlp_apply(p["mlp"], x, act=cfg.act), None


def _block_tail(cfg: ModelConfig, p: PyTree, x: torch.Tensor,
                a: torch.Tensor):
    """Everything after the attention output ``a``: the residual add into
    the second norm, the FFN, its residual add; the sandwich norms around
    both where the config has them.  Returns (x, aux)."""
    h, n = _residual_norm(cfg, p["ln2"], x, _post_norm(cfg, p, "post_ln1",
                                                        a))
    f, aux = _ffn_apply(cfg, p, n)
    return h + _post_norm(cfg, p, "post_ln2", f), aux


def block_apply_full(kind: str, cfg: ModelConfig, p: PyTree,
                     x: torch.Tensor, ctx: Ctx, shared: PyTree = None):
    """``shared``: the model's shared block (``params["shared"]``), which
    a ``mamba_shared`` layer runs after its mixer."""
    _check_kind(kind)
    if kind in RECURRENT_KINDS:
        return _recurrent_full(kind, cfg, p, x, ctx, shared)
    if kind == "dec":
        return _dec_full(cfg, p, x, ctx)
    h = _norm(cfg, p["ln1"], x)
    if kind in MLA_KINDS:
        a, cache = attn.mla_apply_full(
            p["attn"], h, positions=ctx.positions,
            cache_capacity=ctx.cache_capacity, **_mla_kwargs(cfg))
    else:
        a, cache = attn.attn_apply_full(
            p["attn"], h, positions=ctx.positions,
            causal=kind != "enc", cache_capacity=ctx.cache_capacity,
            **_attn_kwargs(cfg, local=kind in _LOCAL))
    x, aux = _block_tail(cfg, p, x, a)
    return x, aux, cache


def cache_length(kind: str, cfg: ModelConfig, capacity: int) -> int | None:
    """Slots of a ``kind`` layer's KV ring at ``capacity`` (None: a
    recurrent kind with no ring; ``mamba_shared``'s shared attention keeps
    a full one)."""
    _check_kind(kind)
    if kind in ("mamba", "mlstm", "slstm"):
        return None
    if kind in _LOCAL and cfg.sliding_window:
        return min(capacity, cfg.sliding_window)
    return capacity


def block_init_cache(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                     *, device, lead: tuple = (), enc_len: int = 0) -> PyTree:
    """``enc_len``: a ``dec`` layer's cross-attention slots (the encoder's
    length)."""
    if kind == "enc":
        raise ValueError("an encoder layer keeps no cache")
    if kind == "dec":
        kv = attn.make_kv_cache(batch, capacity, cfg.num_kv_heads,
                                cfg.head_dim, device=device, lead=lead)
        shape = (*lead, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
        return {"kv": kv,
                "cross_k": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device),
                "cross_v": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)}
    if kind in RECURRENT_KINDS:
        return _recurrent_cache(kind, cfg, batch, capacity, device=device,
                                lead=lead)
    if kind in MLA_KINDS:
        return attn.make_mla_cache(batch, capacity, cfg.kv_lora,
                                   cfg.qk_rope_dim, device=device, lead=lead)
    return attn.make_kv_cache(batch, cache_length(kind, cfg, capacity),
                              cfg.num_kv_heads, cfg.head_dim, device=device,
                              lead=lead)


def block_apply_decode(kind: str, cfg: ModelConfig, p: PyTree,
                       x: torch.Tensor, cache: PyTree, t: torch.Tensor, *,
                       kv_shards: int | None = None, shared: PyTree = None):
    _check_kind(kind)
    if kind in RECURRENT_KINDS:
        return _recurrent_decode(kind, cfg, p, x, cache, t, kv_shards,
                                 shared)
    if kind == "dec":
        return _dec_decode(cfg, p, x, cache, t, kv_shards)
    h = _norm(cfg, p["ln1"], x)
    if kind in MLA_KINDS:
        if kv_shards is not None:
            raise ValueError(f"kind {kind!r}: MLA decode has no decode-"
                             f"attention kernel path (kv_shards={kv_shards}"
                             "); it runs plain, as the reference's")
        a, cache = attn.mla_apply_decode(p["attn"], h, cache, t,
                                         **_mla_kwargs(cfg))
    else:
        a, cache = attn.attn_apply_decode(
            p["attn"], h, cache, t, kv_shards=kv_shards,
            **_attn_kwargs(cfg, local=kind in _LOCAL))
    x, _ = _block_tail(cfg, p, x, a)
    return x, cache


# kinds with a parallel verify path: full-capacity attention rings
VERIFY_KINDS = ("attn", "moe", "mla_dense", "mla_moe")


def block_apply_verify(kind: str, cfg: ModelConfig, p: PyTree,
                       x: torch.Tensor, cache: PyTree, t: torch.Tensor):
    """Teacher-forced S-token decode (speculative verify): one pass over S
    fed tokens per row, write-then-attend against the slot's ring
    (``attention.attn_apply_verify``, ``attention.mla_apply_verify``).
    Only full-ring attention kinds have it: windowed rings can wrap
    mid-chunk and recurrent state cannot roll back."""
    if kind not in VERIFY_KINDS:
        raise ValueError(f"kind {kind!r} has no parallel verify path "
                         "(spec decode gates on SPEC_SAFE_KINDS)")
    h = _norm(cfg, p["ln1"], x)
    if kind in MLA_KINDS:
        a, cache = attn.mla_apply_verify(p["attn"], h, cache, t,
                                         **_mla_kwargs(cfg))
    else:
        kw = _attn_kwargs(cfg, local=False)
        del kw["window"]
        a, cache = attn.attn_apply_verify(p["attn"], h, cache, t, **kw)
    x, _ = _block_tail(cfg, p, x, a)
    return x, cache


# ---------------------------------------------------------------------------
# recurrent kinds: mamba (+ zamba2's shared attention with LoRA), xLSTM
# ---------------------------------------------------------------------------

def _lora_init(b: Builder, d_in: int, d_out: int, rank: int) -> PyTree:
    return {"a": b.param((d_in, rank), ("embed", "lora"),
                         scale=d_in ** -0.5),
            "b": b.param((rank, d_out), ("lora", "qkv"), init="zeros")}


def _lora_apply(p: PyTree, x: torch.Tensor) -> torch.Tensor:
    """(x @ a) @ b in x's dtype: plain matmuls (``lora_`` leaves are not
    prunable, so the stats tape never sees them)."""
    return (x @ p["a"].to(x.dtype)) @ p["b"].to(x.dtype)


def shared_block_init(b: Builder, cfg: ModelConfig) -> PyTree:
    """The weight-shared attention + MLP block (one copy a model)."""
    return {
        "ln1": _norm_init(b, cfg),
        "attn": attn.attn_init(b, d_model=cfg.d_model,
                               num_heads=cfg.num_heads,
                               num_kv=cfg.num_kv_heads,
                               head_dim=cfg.head_dim),
        "ln2": _norm_init(b, cfg),
        "mlp": mlp_init(b, cfg.d_model, cfg.d_ff),
    }


def _recurrent_init(kind: str, b: Builder, cfg: ModelConfig) -> PyTree:
    p = {"ln": _norm_init(b, cfg)}
    if kind in ("mamba", "mamba_shared"):
        p["mamba"] = ssm_mod.mamba2_init(
            b, d_model=cfg.d_model, d_inner=cfg.d_inner,
            d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim)
    if kind == "mamba_shared":
        r = cfg.lora_rank or 32
        kv = cfg.num_kv_heads * cfg.head_dim
        p["lora_q"] = _lora_init(b, cfg.d_model,
                                 cfg.num_heads * cfg.head_dim, r)
        p["lora_k"] = _lora_init(b, cfg.d_model, kv, r)
        p["lora_v"] = _lora_init(b, cfg.d_model, kv, r)
    if kind == "mlstm":
        p["mlstm"] = xlstm_mod.mlstm_init(b, d_model=cfg.d_model,
                                          num_heads=cfg.lstm_heads,
                                          proj_factor=cfg.lstm_proj_factor)
    if kind == "slstm":
        p["slstm"] = xlstm_mod.slstm_init(b, d_model=cfg.d_model,
                                          num_heads=cfg.lstm_heads)
    return p


def _qkv_delta(p: PyTree, h: torch.Tensor):
    """This layer's LoRA deltas of the shared attention's q, k and v."""
    return tuple(_lora_apply(p[f"lora_{n}"], h) for n in "qkv")


def _ssm_kwargs(cfg: ModelConfig) -> dict:
    return dict(d_inner=cfg.d_inner, d_state=cfg.ssm_state,
                head_dim=cfg.ssm_head_dim)


def _shared_tail(cfg: ModelConfig, p: PyTree, shared: PyTree,
                 x: torch.Tensor, y: torch.Tensor, attend):
    """x + y, then the shared block on it: attention with this layer's
    LoRA deltas (``attend(h, qkv_delta) -> (a, kv)``), then the MLP; each
    residual sum enters its norm in f32 (:func:`_residual_norm`)."""
    if shared is None:
        raise ValueError("a mamba_shared layer needs the model's shared "
                         "block")
    x, h = _residual_norm(cfg, shared["ln1"], x, y)
    a, kv = attend(h, _qkv_delta(p, h))
    x, n = _residual_norm(cfg, shared["ln2"], x, a)
    return x.float() + mlp_apply(shared["mlp"], n, act=cfg.act), kv


def _stream(cfg: ModelConfig, p: PyTree, x: torch.Tensor):
    """(the residual stream in bf16, its pre-norm) at a recurrent block's
    start.  x may be the previous block's f32 sum, unrounded: within one
    layer of the jitted reference each block's closing ``x + y`` fuses
    into the next block's norm, which takes the sum in f32 (R6); the
    stream carries its bf16 rounding.  Recurrent blocks return that
    unrounded sum, and the layer loop rounds x at each layer's end (the
    reference's scan carry)."""
    return x.to(cm.COMPUTE_DTYPE), _norm(cfg, p["ln"], x).to(
        cm.COMPUTE_DTYPE)


def _recurrent_full(kind, cfg, p, x, ctx: Ctx, shared):
    want_state = ctx.cache_capacity > 0
    x, h = _stream(cfg, p, x)
    if kind == "mlstm":
        y, st = xlstm_mod.mlstm_apply_full(
            p["mlstm"], h, num_heads=cfg.lstm_heads, return_state=want_state)
        return x.float() + y, None, st
    if kind == "slstm":
        y, st = xlstm_mod.slstm_apply(
            p["slstm"], h, None, num_heads=cfg.lstm_heads,
            return_state=want_state)
        return x.float() + y, None, st
    y, st = ssm_mod.mamba2_apply_full(p["mamba"], h, chunk=cfg.ssm_chunk,
                                      return_state=want_state,
                                      **_ssm_kwargs(cfg))
    cache = {"mamba": st} if want_state else None
    if kind == "mamba":
        return x.float() + y, None, cache

    def attend(hs, delta):
        return attn.attn_apply_full(
            shared["attn"], hs, positions=ctx.positions,
            cache_capacity=ctx.cache_capacity, qkv_delta=delta,
            **_attn_kwargs(cfg, local=False))
    x, kv = _shared_tail(cfg, p, shared, x, y, attend)
    if cache is not None:
        cache["kv"] = kv
    return x, None, cache


def _recurrent_cache(kind, cfg, batch, capacity, *, device, lead):
    if kind == "mlstm":
        return xlstm_mod.mlstm_init_state(
            batch, d_inner=int(cfg.d_model * cfg.lstm_proj_factor),
            num_heads=cfg.lstm_heads, device=device, lead=lead)
    if kind == "slstm":
        return xlstm_mod.slstm_init_state(
            batch, d_model=cfg.d_model, num_heads=cfg.lstm_heads,
            device=device, lead=lead)
    c = {"mamba": ssm_mod.mamba2_init_state(batch, device=device, lead=lead,
                                            **_ssm_kwargs(cfg))}
    if kind == "mamba_shared":
        c["kv"] = attn.make_kv_cache(batch, capacity, cfg.num_kv_heads,
                                     cfg.head_dim, device=device, lead=lead)
    return c


def _recurrent_decode(kind, cfg, p, x, cache, t, kv_shards, shared):
    """One token of a recurrent kind; its state (and the shared block's
    ring) updated in place.  ``kv_shards`` reaches the shared attention
    only.  x and the result: as :func:`_stream`."""
    x, h = _stream(cfg, p, x)
    if kind == "mlstm":
        y, _ = xlstm_mod.mlstm_apply_decode(p["mlstm"], h, cache,
                                            num_heads=cfg.lstm_heads)
        return x.float() + y, cache
    if kind == "slstm":
        y, _ = xlstm_mod.slstm_apply(p["slstm"], h, cache,
                                     num_heads=cfg.lstm_heads)
        return x.float() + y, cache
    y, _ = ssm_mod.mamba2_apply_decode(p["mamba"], h, cache["mamba"],
                                       **_ssm_kwargs(cfg))
    if kind == "mamba":
        return x.float() + y, cache

    def attend(hs, delta):
        return attn.attn_apply_decode(
            shared["attn"], hs, cache["kv"], t, kv_shards=kv_shards,
            qkv_delta=delta, **_attn_kwargs(cfg, local=False))
    x, _ = _shared_tail(cfg, p, shared, x, y, attend)
    return x, cache


# ---------------------------------------------------------------------------
# whisper's decoder kind: self-attention, cross-attention, gated MLP
# ---------------------------------------------------------------------------

def _dec_full(cfg: ModelConfig, p: PyTree, x: torch.Tensor, ctx: Ctx):
    """A ``dec`` layer over the prompt: causal self-attention (the
    config's ``use_rope``: none for whisper), then cross-attention of
    ``ln_cross(x)`` over K/V projected from ``ctx.encoder_out`` (no rope,
    not causal), then the MLP on ``ln2``; each residual sum enters its
    norm in f32 (:func:`_residual_norm`).  Its cache: the self ring and
    the cross K/V in bf16."""
    kw = _attn_kwargs(cfg, local=False)
    a, kv = attn.attn_apply_full(p["attn"], _norm(cfg, p["ln1"], x),
                                 positions=ctx.positions,
                                 cache_capacity=ctx.cache_capacity, **kw)
    x, h = _residual_norm(cfg, p["ln_cross"], x, a)
    enc = ctx.encoder_out
    if enc is None:
        raise ValueError("a dec layer needs the encoder output "
                         "(Ctx.encoder_out)")
    B, Se, _ = enc.shape
    k = cm.dense(p["cross"]["wk"], enc).reshape(B, Se, cfg.num_kv_heads,
                                                cfg.head_dim)
    v = cm.dense(p["cross"]["wv"], enc).reshape(B, Se, cfg.num_kv_heads,
                                                cfg.head_dim)
    c, _ = attn.attn_apply_full(p["cross"], h, positions=ctx.positions,
                                causal=False, kv_override=(k, v),
                                **dict(kw, use_rope=False))
    x, n = _residual_norm(cfg, p["ln2"], x, c)
    x = x + mlp_apply(p["mlp"], n, act=cfg.act)
    cache = None
    if kv is not None:
        cache = {"kv": kv, "cross_k": k.to(torch.bfloat16),
                 "cross_v": v.to(torch.bfloat16)}
    return x, None, cache


def _dec_decode(cfg: ModelConfig, p: PyTree, x: torch.Tensor, cache: PyTree,
                t: torch.Tensor, kv_shards):
    """One token of a ``dec`` layer: the self step writes its ring slot in
    place; the cross step attends over every one of the cache's Se
    encoder slots (kpos = arange(Se), t = Se), through ``kv_shards``'s
    path as the self ring does (S must divide Se too, or it raises)."""
    a, _ = attn.attn_apply_decode(p["attn"], _norm(cfg, p["ln1"], x),
                                  cache["kv"], t, kv_shards=kv_shards,
                                  **_attn_kwargs(cfg, local=False))
    x, h = _residual_norm(cfg, p["ln_cross"], x, a)
    B = x.shape[0]
    H, D = cfg.num_heads, cfg.head_dim
    q = cm.dense(p["cross"]["wq"], h).reshape(B, H, D)
    Se = cache["cross_k"].shape[1]
    kpos = torch.arange(Se, device=x.device)
    t_cross = torch.full((), Se, dtype=torch.int32, device=x.device)
    o = attn.decode_attend(q, cache["cross_k"], cache["cross_v"], kpos,
                           t_cross, kv_shards=kv_shards)
    c = cm.dense(p["cross"]["wo"], o.reshape(B, 1, H * D))
    x, n = _residual_norm(cfg, p["ln2"], x, c)
    return x + mlp_apply(p["mlp"], n, act=cfg.act), cache
