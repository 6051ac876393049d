"""Top-level language model.  Port of ``repro.models.model``.

The layer stack is partitioned into stages, (pattern, repeats) pairs, as in
the reference; per-layer parameters are stacked on a leading "layers" axis
(``wq`` is (layers, d_model, heads * head_dim)), so bank leaves, masks and
``SparseTensor``s pair one-to-one with the reference's.  A Python loop over
the layers slices ``[l]`` where the reference runs ``lax.scan``.

Ported: the decoder families built from the ``attn``, ``local``, ``moe``
and ``moe_local`` kinds (llama, mixtral, yi, gemma2, gemma3), tied or
untied embeddings, gemma's scaled embeddings, attention and final logit
softcaps, sandwich norms, QK-norm and gelu; :func:`check_supported` names
what is missing for any other config.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

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
        (f"layer kinds other than {', '.join(blk.KINDS)}",
         set(cfg.layer_kinds) - set(blk.KINDS)),
        ("shared experts", cfg.num_shared_experts),
        ("norm other than rmsnorm", cfg.norm != "rmsnorm"),
        ("activation other than silu or gelu",
         cfg.act not in ("silu", "gelu")),
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
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_init(b, cfg.d_model, cfg.vocab_size,
                                     ("embed", "vocab"))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> PyTree:
    """Fan-in truncated-normal init from ``torch.Generator(device)`` seeded
    with ``seed``, on the card unless ``device`` names another.  (These are
    not the reference's params: ``core/prng.py`` replays its threefry bits,
    but not ``jax.random.truncated_normal``'s inverse-erf transform of
    them, so a test that needs the reference's params converts them with
    ``repro_torch.convert``.)"""
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
    """The tree with its embedding table and dense kernels (expert banks
    and ``lm_head`` included) cast to the compute dtype once.  The forward
    casts them to bf16 on every call, as the reference does; casting ahead
    gives the same values without re-reading the f32 copies each step.
    Norm scales and the MoE router stay f32: the reference computes the
    router logits in f32."""
    def leaf(path: str, x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and "['router']" not in path
                and (path.endswith("['kernel']")
                     or path.endswith("['table']"))):
            return x.to(cm.COMPUTE_DTYPE)
        return x
    return tree.map_with_path(leaf, params)


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree.tree_map(
        lambda a: a.select(i) if isinstance(a, SparseTensor) else a[i],
        stacked)


def _unstack(stacked: PyTree, repeats: int) -> list[PyTree]:
    """Every layer's slice of a stage's stacked params.  ``unbind`` gives
    all the views of a leaf at once, so under autograd one node stacks the
    layers' gradients (indexing each layer would add a zero-filled
    full-size gradient per layer)."""
    cols = tree.tree_map(
        lambda a: tuple(a.select(i) for i in range(repeats))
        if isinstance(a, SparseTensor) else a.unbind(0), stacked)
    return [tree.tree_map(lambda c: c[i], cols) for i in range(repeats)]


def _stack(layers: list[PyTree]) -> PyTree:
    return tree.tree_map(lambda *xs: torch.stack(xs), *layers)


def _tokens(params: PyTree, tokens) -> torch.Tensor:
    dev = params["embed"]["table"].device
    return torch.as_tensor(tokens, device=dev).long()


def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor
           ) -> torch.Tensor:
    """The bf16 embeddings of ``tokens``, times sqrt(d_model) where the
    config scales them (gemma)."""
    x = cm.embed_lookup(params["embed"], tokens)
    return cm.scale_embed(x, cfg.d_model) if cfg.scale_embed else x


def _layer_apply(cfg: ModelConfig, pattern, lp: PyTree, x: torch.Tensor,
                 ctx: Ctx):
    """One layer of a stage: its blocks in order.  Returns (x, the layer's
    MoE aux loss or None, {block: cache})."""
    aux_total, out = None, {}
    for j, kind in enumerate(pattern):
        x, aux, out[str(j)] = blk.block_apply_full(kind, cfg, lp[str(j)], x,
                                                   ctx)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total, out


def _trunk(cfg: ModelConfig, params: PyTree, tokens, cache_capacity: int,
           unroll: bool = False, remat: bool = False):
    """Embed + every layer: (hidden states before the final norm, summed
    MoE aux loss, caches).  ``unroll``: register every layer's sliced
    params, under its stage's path and its layer index, with the eager
    stats tape if one records (the reference's unrolled tape pass).
    ``remat``: each layer runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint`` of its scanned layer body): the backward
    keeps only the layer's input and recomputes the rest, with the same
    ops, so the gradients are the ones without it."""
    tape = None
    if unroll:
        from repro_torch.core import tape as tape_mod
        tape = tape_mod.current_tape()
        if tape is not None:      # unstacked leaves
            tape.register_layer(params, "", -1)
    tokens = _tokens(params, tokens)
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)
    ctx = Ctx(positions=pos, cache_capacity=cache_capacity)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for s, ((pattern, repeats), sp) in enumerate(zip(
            make_stages(cfg), params["stages"], strict=True)):
        per_layer = []
        for i, lp in enumerate(_unstack(sp, repeats)):
            if tape is not None:
                tape.register_layer(lp, f"['stages'][{s}]", i)
            if remat:
                x, aux, out = checkpoint(_layer_apply, cfg, pattern, lp, x,
                                         ctx, use_reentrant=False)
            else:
                x, aux, out = _layer_apply(cfg, pattern, lp, x, ctx)
            if aux is not None:
                aux_total = aux_total + aux
            per_layer.append(out)
        caches.append(_stack(per_layer) if cache_capacity else None)
    return x, aux_total, caches


def _unembed(cfg: ModelConfig, params: PyTree, x: torch.Tensor):
    """Logits (f32): the tied table, or the ``lm_head`` dense kernel, then
    the final softcap where the config has one (gemma2)."""
    if cfg.tie_embeddings:
        logits = cm.unembed(params["embed"], x)
    else:
        logits = cm.dense(params["lm_head"], x).float()
    return cm.softcap(logits, cfg.final_softcap)


def forward(cfg: ModelConfig, params: PyTree, batch: dict, *,
            remat: bool = False, cache_capacity: int = 0,
            unroll: bool = False):
    """Full forward. Returns (logits fp32 (B, S, V), aux, caches); aux is
    the MoE load-balancing loss summed over layers (0 without MoE).
    ``remat``: recompute each layer in the backward (:func:`_trunk`); off
    when ``cache_capacity`` is set, as in the reference.  ``unroll``: the
    eager stats tape's pass (:func:`_trunk`)."""
    x, aux, caches = _trunk(cfg, params, batch["tokens"], cache_capacity,
                            unroll, remat=remat and not cache_capacity)
    x = blk._norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), aux, caches


def stats_sumsq(cfg: ModelConfig, params: PyTree, batch: dict) -> PyTree:
    """One calibration batch -> per-input-feature activation sum of squares
    (f32), as a tree matching ``params``.

    Each layer's sliced params are registered with a
    :class:`~repro_torch.core.tape.JitTape` while its blocks run, and each
    kernel's sums are stacked back along the layer axis, as the reference's
    scanned pass returns them.  Covers every kernel inside the layer
    stacks, MoE expert banks with their routed-row rescale included
    (``models.moe.moe_apply``); leaves the pass does not project through
    (embeddings, heads, routers, norms) come back None.  Accumulate over
    batches and sqrt to get ||X_j||_2.
    """
    from repro_torch.core import tape as tape_mod
    tokens = _tokens(params, batch["tokens"])
    x = _embed(cfg, params, tokens)
    B, S, _ = x.shape
    ctx = Ctx(positions=torch.arange(S, device=x.device).expand(B, S))
    by_path: dict[str, torch.Tensor] = {}
    for s, ((pattern, repeats), sp) in enumerate(zip(
            make_stages(cfg), params["stages"], strict=True)):
        per_layer = []
        for lp in _unstack(sp, repeats):
            t = tape_mod.JitTape()
            t.register_layer(lp, "", 0)
            with tape_mod.recording(t):
                for j, kind in enumerate(pattern):
                    x, _, _ = blk.block_apply_full(kind, cfg, lp[str(j)], x,
                                                   ctx)
            per_layer.append(t.stats(0))
        for path in per_layer[0]:
            by_path[f"['stages'][{s}]" + path] = torch.stack(
                [ss[path] for ss in per_layer])
    return tree.map_with_path(lambda path, _: by_path.get(path), params)


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
    x, _, caches = _trunk(cfg, params, batch["tokens"], cache_capacity)
    x = blk._norm(cfg, params["final_norm"], x[:, -1:])
    return _unembed(cfg, params, x)[:, 0], caches


def cache_lengths(cfg: ModelConfig, capacity: int) -> set[int]:
    """The distinct KV ring lengths of ``cfg``'s layers at ``capacity``."""
    return {blk.cache_length(k, cfg, capacity) for k in cfg.layer_kinds}


def decode_step(cfg: ModelConfig, params: PyTree, token, caches: list, t, *,
                kv_shards: int | None = None):
    """One decode step.  token: (B,) ints; t: position, a scalar (the whole
    batch in lockstep) or (B,) per-row positions (the serve engine's fused
    decode).  Writes each row's ring slot of ``caches`` in place and
    returns (logits (B, V) f32, caches).  ``kv_shards``: the decode
    attention path of every layer (``attention.decode_attend``): None
    replicated, 1 ``flash_decode``, S >= 2 S capacity shards."""
    token = _tokens(params, token)
    x = _embed(cfg, params, token[:, None])
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
                                              lc[str(j)], t,
                                              kv_shards=kv_shards)
    x = blk._norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x)[:, 0], caches


def verify_step(cfg: ModelConfig, params: PyTree, tokens, caches: list, t):
    """Teacher-forced S-token decode in one batched pass (spec verify).

    tokens: (B, S) ints, S fed tokens per row; t: (B,) per-row start
    positions.  Column i's logits continue the fed prefix
    ``tokens[:, :i + 1]``, as feeding the same tokens through
    :func:`decode_step` one at a time would, but the layer ops run once
    for all S positions.  Writes the S ring rows of every row of
    ``caches`` in place; the caller guarantees max(t) + S <= capacity (no
    ring wrap).  Returns (logits (B, S, V) f32, caches)."""
    tokens = _tokens(params, tokens)
    x = _embed(cfg, params, tokens)
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    for (pattern, repeats), sp, cache in zip(make_stages(cfg),
                                             params["stages"], caches,
                                             strict=True):
        for i in range(repeats):
            lp, lc = _layer(sp, i), _layer(cache, i)
            for j, kind in enumerate(pattern):
                x, _ = blk.block_apply_verify(kind, cfg, lp[str(j)], x,
                                              lc[str(j)], t)
    x = blk._norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), caches
