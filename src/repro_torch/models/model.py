"""Top-level language model.  Port of ``repro.models.model``.

The layer stack is partitioned into stages, (pattern, repeats) pairs, as in
the reference; per-layer parameters are stacked on a leading "layers" axis
(``wq`` is (layers, d_model, heads * head_dim)), so bank leaves, masks and
``SparseTensor``s pair one-to-one with the reference's.  A Python loop over
the layers slices ``[l]`` where the reference runs ``lax.scan``.

Only the dense decoder families with global attention (llama) are ported:
:func:`check_supported` names what is missing for any other config.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models import common as cm
from repro_torch.models.blocks import Ctx
from repro_torch.models.common import Builder
from repro_torch.sparse.formats import SparseTensor

PyTree = Any


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config features this package does not port yet."""
    missing = [name for name, on in (
        ("layer kinds other than attn", set(cfg.layer_kinds) - {"attn"}),
        ("sliding_window", cfg.sliding_window),
        ("attn_softcap", cfg.attn_softcap),
        ("final_softcap", cfg.final_softcap),
        ("qk_norm", cfg.qk_norm),
        ("sandwich_norm", cfg.sandwich_norm),
        ("untied embeddings", not cfg.tie_embeddings),
        ("scale_embed", cfg.scale_embed),
        ("norm other than rmsnorm", cfg.norm != "rmsnorm"),
        ("encoder-decoder", cfg.is_encoder_decoder),
        ("vision input", cfg.vit_dim),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {', '.join(missing)}")


def make_stages(cfg: ModelConfig):
    """Compress the layer-kind sequence into (pattern, repeats) stages."""
    L, pat = cfg.num_layers, cfg.pattern
    stages = []
    if cfg.pattern_prefix:
        stages.append((tuple(cfg.pattern_prefix), 1))
        L -= len(cfg.pattern_prefix)
    p = len(pat)
    if L // p:
        stages.append((tuple(pat), L // p))
    if L % p:
        stages.append((tuple(pat[:L % p]), 1))
    return stages


def _build(cfg: ModelConfig, b: Builder) -> PyTree:
    check_supported(cfg)
    p: dict[str, Any] = {"embed": cm.embed_init(b, cfg.vocab_size,
                                                cfg.d_model)}
    p["stages"] = [
        {str(j): blk.block_init(kind, b.stacked(repeats), cfg)
         for j, kind in enumerate(pattern)}
        for pattern, repeats in make_stages(cfg)]
    p["final_norm"] = blk._norm_init(b, cfg)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> PyTree:
    """Fan-in truncated-normal init from ``torch.Generator(device)`` seeded
    with ``seed``, on the card unless ``device`` names another.  (The
    reference's threefry draws cannot be replayed in torch: to reproduce
    its params, convert them with ``repro_torch.convert``.)"""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return _build(cfg, Builder("init", g, device))


def param_axes(cfg: ModelConfig) -> PyTree:
    """Tree (same structure as params) of '|'-joined logical axis strings."""
    return _build(cfg, Builder("axes"))


def param_shapes(cfg: ModelConfig) -> PyTree:
    """Tree (same structure as params) of parameter shapes; allocates
    nothing."""
    return _build(cfg, Builder("shape"))


def serving_params(params: PyTree) -> PyTree:
    """The tree with its embedding table and dense kernels cast to the
    compute dtype once.  The forward casts them to bf16 on every call, as
    the reference does; casting ahead gives the same values without
    re-reading the f32 copies each step.  Norm scales stay f32."""
    def leaf(path: str, x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and (path.endswith("['kernel']")
                     or path.endswith("['table']"))):
            return x.to(cm.COMPUTE_DTYPE)
        return x
    return tree.map_with_path(leaf, params)


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree.tree_map(
        lambda a: a.select(i) if isinstance(a, SparseTensor) else a[i],
        stacked)


def _stack(layers: list[PyTree]) -> PyTree:
    return tree.tree_map(lambda *xs: torch.stack(xs), *layers)


def _tokens(params: PyTree, tokens) -> torch.Tensor:
    dev = params["embed"]["table"].device
    return torch.as_tensor(tokens, device=dev).long()


def _trunk(cfg: ModelConfig, params: PyTree, tokens, cache_capacity: int):
    """Embed + every layer: (hidden states before the final norm, caches)."""
    tokens = _tokens(params, tokens)
    x = cm.embed_lookup(params["embed"], tokens)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)
    ctx = Ctx(positions=pos, cache_capacity=cache_capacity)
    caches = []
    for (pattern, repeats), sp in zip(make_stages(cfg), params["stages"],
                                      strict=True):
        per_layer = []
        for i in range(repeats):
            lp = _layer(sp, i)
            out = {}
            for j, kind in enumerate(pattern):
                x, out[str(j)] = blk.block_apply_full(kind, cfg, lp[str(j)],
                                                      x, ctx)
            per_layer.append(out)
        caches.append(_stack(per_layer) if cache_capacity else None)
    return x, caches


def forward(cfg: ModelConfig, params: PyTree, batch: dict, *,
            cache_capacity: int = 0):
    """Full forward. Returns (logits fp32 (B, S, V), aux, caches); aux, the
    MoE load-balancing loss in the reference, is 0 for these dense
    models."""
    x, caches = _trunk(cfg, params, batch["tokens"], cache_capacity)
    x = blk._norm(cfg, params["final_norm"], x)
    logits = cm.unembed(params["embed"], x)
    return logits, torch.zeros((), device=logits.device), caches


def init_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                device) -> list:
    return [{str(j): blk.block_init_cache(k, cfg, batch, capacity,
                                          device=device, lead=(repeats,))
             for j, k in enumerate(pattern)}
            for pattern, repeats in make_stages(cfg)]


def prefill(cfg: ModelConfig, params: PyTree, batch: dict, *,
            cache_capacity: int):
    """Process a prompt, fill KV caches, return last-position logits.

    Only the last position goes through the final norm and unembedding
    (both are row-wise, so the values are the reference's)."""
    x, caches = _trunk(cfg, params, batch["tokens"], cache_capacity)
    x = blk._norm(cfg, params["final_norm"], x[:, -1:])
    return cm.unembed(params["embed"], x)[:, 0], caches


def decode_step(cfg: ModelConfig, params: PyTree, token, caches: list, t):
    """One decode step.  token: (B,) ints; t: position, a scalar (the whole
    batch in lockstep) or (B,) per-row positions (the serve engine's fused
    decode).  Writes each row's ring slot of ``caches`` in place and
    returns (logits (B, V) f32, caches)."""
    token = _tokens(params, token)
    x = cm.embed_lookup(params["embed"], token[:, None])
    B = x.shape[0]
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    if t.dim() == 0:
        t = t.expand(B)
    for (pattern, repeats), sp, cache in zip(make_stages(cfg),
                                             params["stages"], caches,
                                             strict=True):
        for i in range(repeats):
            lp, lc = _layer(sp, i), _layer(cache, i)
            for j, kind in enumerate(pattern):
                x, _ = blk.block_apply_decode(kind, cfg, lp[str(j)], x,
                                              lc[str(j)], t)
    x = blk._norm(cfg, params["final_norm"], x)
    return cm.unembed(params["embed"], x)[:, 0], caches
