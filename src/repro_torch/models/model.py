"""Top-level language model.  Port of ``repro.models.model``.

The layer stack is partitioned into stages, (pattern, repeats) pairs, as in
the reference; per-layer parameters are stacked on a leading "layers" axis
(``wq`` is (layers, d_model, heads * head_dim)), so bank leaves, masks and
``SparseTensor``s pair one-to-one with the reference's.  A Python loop over
the layers slices ``[l]`` where the reference runs ``lax.scan``.

Ported: the decoder families built from the ``attn``, ``local``, ``moe``,
``moe_local``, ``mla_dense`` and ``mla_moe`` kinds (llama, mixtral, yi,
gemma2, gemma3, deepseek-v2-lite with its ``pattern_prefix`` stage and
shared experts) and the recurrent ones (zamba2's ``mamba`` and
``mamba_shared`` with the model's one shared attention block,
``params["shared"]``; xlstm's ``mlstm`` and ``slstm``), whisper's
encoder-decoder (``frame_proj`` and sinusoidal positions into the ``enc``
stages and ``enc_norm``; ``pos_embed`` on the ``dec`` stages, whose
cross-attention reads the encoder output) and pixtral's vision prefix
(``vit_proj`` of the batch's ``patches`` before the text embeddings),
tied or untied embeddings, gemma's scaled embeddings, attention and final
logit softcaps, sandwich norms, QK-norm, layernorm and gelu: every
family of the reference.  :func:`check_supported` names what a config
asks for beyond that.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist.axes import current_rules, use_rules
from repro_torch.dist.sharding import DenseBlock, place_leaf
from repro_torch.kernels import shard as ksh
from repro_torch.models import blocks as blk
from repro_torch.models import common as cm
from repro_torch.models.blocks import Ctx
from repro_torch.models.common import Builder
from repro_torch.sparse.formats import SparseTensor

PyTree = Any
POS_EMBED_ROWS = 32768       # the decoder's learned positions (whisper)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for config features this package does not port yet."""
    missing = [name for name, on in (
        (f"layer kinds other than {', '.join(blk.KINDS)}",
         set(cfg.layer_kinds) - set(blk.KINDS)),
        ("norm other than rmsnorm or layernorm",
         cfg.norm not in ("rmsnorm", "layernorm")),
        ("activation other than silu or gelu",
         cfg.act not in ("silu", "gelu")),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported: {', '.join(missing)}")


# the families served and calibrated under rules (tensor parallelism across
# ranks); the other eight wait for ROADMAP A item 3
TP_FAMILIES = ("llama", "mixtral")


def check_tp_supported(cfg: ModelConfig,
                       what: str = "tensor-parallel serving") -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a family the port
    serves (or, ``what``, calibrates) under rules: no family drops quietly
    to a replicated model."""
    if not cfg.name.startswith(TP_FAMILIES):
        raise NotImplementedError(
            f"{cfg.name}: {what} (rules) is ported for "
            f"{' and '.join(TP_FAMILIES)} only; the other families wait for "
            "ROADMAP A item 3")


def make_stages(cfg: ModelConfig, num_layers: int | None = None,
                pattern: tuple[str, ...] | None = None):
    """Compress the layer-kind sequence into (pattern, repeats) stages;
    ``num_layers`` and ``pattern`` name another stack than the decoder's
    (whisper's encoder: ``encoder_layers`` of ``("enc",)``)."""
    L = cfg.num_layers if num_layers is None else num_layers
    pat = cfg.pattern if pattern is None else pattern
    stages = []
    if pattern is None and cfg.pattern_prefix:
        stages.append((tuple(cfg.pattern_prefix), 1))
        L -= len(cfg.pattern_prefix)
    p = len(pat)
    if L // p:
        stages.append((tuple(pat), L // p))
    if L % p:
        stages.append((tuple(pat[:L % p]), 1))
    return stages


def encoder_stages(cfg: ModelConfig):
    """Whisper's encoder stack as stages (none without an encoder)."""
    return make_stages(cfg, cfg.encoder_layers, ("enc",)) \
        if cfg.is_encoder_decoder else []


def _stages_init(b: Builder, cfg: ModelConfig, stages) -> list:
    return [{str(j): blk.block_init(kind, b.stacked(repeats), cfg)
             for j, kind in enumerate(pattern)}
            for pattern, repeats in stages]


def _build(cfg: ModelConfig, b: Builder) -> PyTree:
    check_supported(cfg)
    p: dict[str, Any] = {"embed": cm.embed_init(b, cfg.vocab_size,
                                                cfg.d_model)}
    if cfg.vit_dim:
        p["vit_proj"] = cm.dense_init(b, cfg.vit_dim, cfg.d_model,
                                      (None, "embed"))
    if cfg.is_encoder_decoder:
        p["frame_proj"] = cm.dense_init(b, cfg.d_model, cfg.d_model,
                                        ("embed", "embed"))
        p["pos_embed"] = b.param((POS_EMBED_ROWS, cfg.d_model),
                                 (None, "embed"), scale=0.02)
        p["enc_stages"] = _stages_init(b, cfg, encoder_stages(cfg))
        p["enc_norm"] = blk._norm_init(b, cfg)
    p["stages"] = _stages_init(b, cfg, make_stages(cfg))
    if "mamba_shared" in cfg.layer_kinds:
        p["shared"] = blk.shared_block_init(b, cfg)
    p["final_norm"] = blk._norm_init(b, cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_init(b, cfg.d_model, cfg.vocab_size,
                                     ("embed", "vocab"))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None, rules=None) -> PyTree:
    """Fan-in truncated-normal init from ``torch.Generator(device)`` seeded
    with ``seed``, on the card unless ``device`` names another: each
    :func:`param_specs` leaf drawn in turn.  (These are not the
    reference's params: ``core/prng.py`` replays its threefry bits, but
    not ``jax.random.truncated_normal``'s inverse-erf transform of them,
    so a test that needs the reference's params converts them with
    ``repro_torch.convert``.)

    ``rules``: this rank's blocks of the same params
    (``dist.sharding.place_leaf``, the specs ``params_sharding`` gives),
    each leaf replaced by its block as soon as it is drawn, so the whole
    f32 tree is never held."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return _from_specs(cfg, lambda spec: spec.draw(g, device), rules)


def empty_params(cfg: ModelConfig, *, device=None, rules=None) -> PyTree:
    """Uninitialised leaves of :func:`init_params`' shapes, dtypes and,
    under ``rules``, blocks: a template to restore a checkpoint into,
    with no values drawn."""
    device = resolve_device(device)
    return _from_specs(cfg, lambda spec: torch.empty(
        spec.shape, dtype=spec.dtype, device=device), rules)


def _from_specs(cfg: ModelConfig, make, rules) -> PyTree:
    """``make(spec)`` over :func:`param_specs` in the tree's insertion
    order (the order ``Builder`` draws in), each leaf placed under
    ``rules`` before the next is made."""
    specs = param_specs(cfg)
    if rules is None:
        return tree.tree_map(make, specs)
    axes = dict(tree.flatten_with_path(param_axes(cfg)))
    return tree.map_with_path(
        lambda path, spec: place_leaf(path, axes[path], make(spec), rules),
        specs)


def param_axes(cfg: ModelConfig) -> PyTree:
    """Tree (same structure as params) of '|'-joined logical axis strings."""
    return _build(cfg, Builder("axes"))


def param_shapes(cfg: ModelConfig) -> PyTree:
    """Tree (same structure as params) of parameter shapes; allocates
    nothing."""
    return _build(cfg, Builder("shape"))


def param_specs(cfg: ModelConfig) -> PyTree:
    """Tree (same structure as params) of ``common.ParamSpec``: what
    :func:`init_params` draws, drawn by the caller leaf by leaf, a
    stacked leaf layer by layer (``ParamSpec.draw(index=(i,))``).
    Drawn in the tree's insertion order from one generator, they are
    ``init_params``' values."""
    return _build(cfg, Builder("spec"))


# kernels the reference reads in f32: the MoE router (f32 logits), MLA's
# w_uk / w_uv, which its absorbed decode reads dense in f32
# (``attention.mla_apply_decode``), and sLSTM's recurrent ``r``
_F32_KERNELS = ("['router']", "['w_uk']", "['w_uv']", "['r']")


def serving_params(params: PyTree) -> PyTree:
    """The tree with its embedding table and dense kernels (expert banks
    and ``lm_head`` included) cast to the compute dtype once.  The forward
    casts them to bf16 on every call, as the reference does; casting ahead
    gives the same values without re-reading the f32 copies each step.
    Norm scales and the kernels the reference reads in f32 (``_F32_KERNELS``)
    stay as they are."""
    def leaf(path: str, x):
        if (isinstance(x, torch.Tensor) and x.is_floating_point()
                and not any(k in path for k in _F32_KERNELS)
                and (path.endswith("['kernel']")
                     or path.endswith("['table']"))):
            return x.to(cm.COMPUTE_DTYPE)
        return x
    return tree.map_with_path(leaf, params)


def _layer(stacked: PyTree, i: int) -> PyTree:
    return tree.tree_map(
        lambda a: a.select(i) if isinstance(a, (SparseTensor, DenseBlock))
        else a[i], stacked)


def _unstack(stacked: PyTree, repeats: int) -> list[PyTree]:
    """Every layer's slice of a stage's stacked params.  ``unbind`` gives
    all the views of a leaf at once, so under autograd one node stacks the
    layers' gradients (indexing each layer would add a zero-filled
    full-size gradient per layer)."""
    cols = tree.tree_map(
        lambda a: tuple(a.select(i) for i in range(repeats))
        if isinstance(a, SparseTensor) else
        tuple(DenseBlock(d, a.spec[1:]) for d in a.data.unbind(0))
        if isinstance(a, DenseBlock) else a.unbind(0),
        stacked)
    return [tree.tree_map(lambda c: c[i], cols) for i in range(repeats)]


def _stack(layers: list[PyTree]) -> PyTree:
    return tree.tree_map(lambda *xs: torch.stack(xs), *layers)


def _tokens(params: PyTree, tokens) -> torch.Tensor:
    dev = params["embed"]["table"].device
    return torch.as_tensor(tokens, device=dev).long()


def _features(params: PyTree, a) -> torch.Tensor:
    """A batch's ``frames`` / ``patches`` (numpy or a tensor, any float
    dtype) on the params' device, cast to the compute dtype as the
    reference casts them."""
    dev = params["embed"]["table"].device
    return torch.as_tensor(a, device=dev).to(cm.COMPUTE_DTYPE)


def _embed(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor
           ) -> torch.Tensor:
    """The bf16 embeddings of ``tokens``, times sqrt(d_model) where the
    config scales them (gemma)."""
    x = cm.embed_lookup(params["embed"], tokens)
    return cm.scale_embed(x, cfg.d_model) if cfg.scale_embed else x


def _embed_inputs(cfg: ModelConfig, params: PyTree, batch: dict
                  ) -> torch.Tensor:
    """The embedded token rows, after pixtral's image prefix where the
    batch has ``patches``: ``vit_proj`` of the (B, N, vit_dim) patch
    embeddings, concatenated before the text, (B, N + S, d)."""
    x = _embed(cfg, params, _tokens(params, batch["tokens"]))
    if cfg.vit_dim and "patches" in batch:
        img = cm.dense(params["vit_proj"],
                       _features(params, batch["patches"]))
        x = torch.cat([img, x], dim=1)
    return x


def _stage_stats(cfg: ModelConfig, pattern, sp, repeats: int,
                 x: torch.Tensor, ctx: Ctx, shared, by_path: dict,
                 prefix: str) -> torch.Tensor:
    """One stage of the stats pass: each layer's sliced params registered
    with a :class:`~repro_torch.core.tape.JitTape` (the shared block
    with it, at index -1) while its blocks run; each kernel's sums stacked
    back along the layer axis under ``prefix`` + its path in ``by_path``,
    the shared block's summed over its invocations.  Returns x."""
    from repro_torch.core import tape as tape_mod
    per_layer = []
    for lp in _unstack(sp, repeats):
        t = tape_mod.JitTape()
        t.register_layer(lp, "", 0)
        if shared is not None:
            t.register_layer(shared, "", -1)
        with tape_mod.recording(t):
            for j, kind in enumerate(pattern):
                x, _, _ = blk.block_apply_full(kind, cfg, lp[str(j)], x,
                                               ctx, shared)
        x = x.to(cm.COMPUTE_DTYPE)
        per_layer.append(t.stats(0))
        for path, ss in t.stats(-1).items():
            key = "['shared']" + path
            by_path[key] = ss if key not in by_path else by_path[key] + ss
    for path in per_layer[0]:
        by_path[prefix + path] = torch.stack([ss[path] for ss in per_layer])
    return x


def _run_encoder(cfg: ModelConfig, params: PyTree, frames, *,
                 tape=None, stats: dict | None = None) -> torch.Tensor:
    """Whisper's encoder: ``frame_proj`` of the (B, Se, d) frame
    embeddings plus the sinusoidal positions, the ``enc`` stages (not
    causal), ``enc_norm``.  ``tape``: the eager stats tape, each layer
    registered under its ``['enc_stages'][s]`` path; ``stats``: the jit
    stats pass's dict, which gains the encoder's stacked sums."""
    x = cm.dense(params["frame_proj"], _features(params, frames))
    B, S, _ = x.shape
    pe = cm.sinusoidal_positions(S, cfg.d_model)
    x = x + torch.from_numpy(pe).to(x.device, x.dtype)
    ctx = Ctx(positions=torch.arange(S, device=x.device).expand(B, S))
    trace = ksh.trace_sites()
    for s, ((pattern, repeats), sp) in enumerate(zip(
            encoder_stages(cfg), params["enc_stages"], strict=True)):
        prefix = f"['enc_stages'][{s}]"
        if stats is not None:
            x = _stage_stats(cfg, pattern, sp, repeats, x, ctx, None, stats,
                             prefix)
            continue
        for i, lp in enumerate(_unstack(sp, repeats)):
            ksh.mark_site(trace, ("enc", s), i)
            if tape is not None:
                tape.register_layer(lp, prefix, i)
            x, _, _ = _layer_apply(cfg, pattern, lp, x, ctx)
    ksh.mark_site(trace, None)
    return blk._norm(cfg, params["enc_norm"], x)


def _decoder_inputs(cfg: ModelConfig, params: PyTree, batch: dict, *,
                    tape=None, stats: dict | None = None):
    """(the embedded inputs, the encoder output or None): for an
    encoder-decoder model the encoder runs on ``batch["frames"]`` and the
    decoder's rows take ``pos_embed[:S]``."""
    x = _embed_inputs(cfg, params, batch)
    if not cfg.is_encoder_decoder:
        return x, None
    enc = _run_encoder(cfg, params, batch["frames"], tape=tape, stats=stats)
    pe = params["pos_embed"][:x.shape[1]].to(x.dtype)
    return x + pe[None], enc


def _layer_apply(cfg: ModelConfig, pattern, lp: PyTree, x: torch.Tensor,
                 ctx: Ctx, shared: PyTree = None):
    """One layer of a stage: its blocks in order (``shared``: the model's
    shared block).  Returns (x, the layer's MoE aux loss or None, {block:
    cache})."""
    aux_total, out = None, {}
    for j, kind in enumerate(pattern):
        x, aux, out[str(j)] = blk.block_apply_full(kind, cfg, lp[str(j)], x,
                                                   ctx, shared)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x.to(cm.COMPUTE_DTYPE), aux_total, out


@contextlib.contextmanager
def _as_in_forward(rules, whole: bool):
    with use_rules(rules), (ksh.whole_weights() if whole
                            else contextlib.nullcontext()):
        yield


def _remat_context():
    """``checkpoint``'s context_fn: the layer's recomputation runs under
    the rules and ``kernels.shard.whole_weights`` state of its forward.
    Both are thread-local, and on the card the backward (so the
    recomputation) runs on autograd's device thread, where neither is
    set."""
    return contextlib.nullcontext(), _as_in_forward(current_rules(),
                                                   ksh.weights_whole())


def _trunk(cfg: ModelConfig, params: PyTree, batch: dict,
           cache_capacity: int, unroll: bool = False, remat: bool = False):
    """Embed (and the encoder, or the image prefix) + every decoder layer:
    (hidden states before the final norm, summed MoE aux loss, caches).
    The encoder never runs under remat, as in the reference.
    ``unroll``: register every layer's sliced params, under its stage's
    path and its layer index, with the eager stats tape if one records
    (the reference's unrolled tape pass).
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
    x, enc = _decoder_inputs(cfg, params, batch, tape=tape)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device).expand(B, S)
    ctx = Ctx(positions=pos, cache_capacity=cache_capacity, encoder_out=enc)
    shared = params.get("shared")
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    trace = ksh.trace_sites()
    for s, ((pattern, repeats), sp) in enumerate(zip(
            make_stages(cfg), params["stages"], strict=True)):
        per_layer = []
        for i, lp in enumerate(_unstack(sp, repeats)):
            ksh.mark_site(trace, (s,), i)
            if tape is not None:
                tape.register_layer(lp, f"['stages'][{s}]", i)
            if remat:
                x, aux, out = checkpoint(_layer_apply, cfg, pattern, lp, x,
                                         ctx, shared, use_reentrant=False,
                                         context_fn=_remat_context)
            else:
                x, aux, out = _layer_apply(cfg, pattern, lp, x, ctx, shared)
            if aux is not None:
                aux_total = aux_total + aux
            per_layer.append(out)
        caches.append(_stack(per_layer) if cache_capacity else None)
    ksh.mark_site(trace, None)
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
    x, aux, caches = _trunk(cfg, params, batch, cache_capacity, unroll,
                            remat=remat and not cache_capacity)
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
    (``models.moe.moe_apply``), and the shared block's (registered with
    each layer's tape at index -1, as the reference's scan body does, and
    summed over every invocation under ``['shared']`` paths); leaves the
    pass does not project through (embeddings, heads, routers, norms, the
    LoRA adapters, the frame and patch projections) come back None.
    Whisper's encoder stages come first, under ``['enc_stages'][s]``
    paths.  Accumulate over batches and sqrt to get ||X_j||_2.
    """
    by_path: dict[str, torch.Tensor] = {}
    x, enc = _decoder_inputs(cfg, params, batch, stats=by_path)
    B, S, _ = x.shape
    ctx = Ctx(positions=torch.arange(S, device=x.device).expand(B, S),
              encoder_out=enc)
    shared = params.get("shared")
    for s, ((pattern, repeats), sp) in enumerate(zip(
            make_stages(cfg), params["stages"], strict=True)):
        x = _stage_stats(cfg, pattern, sp, repeats, x, ctx, shared, by_path,
                         f"['stages'][{s}]")
    return tree.map_with_path(lambda path, _: by_path.get(path), params)


def init_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                device, enc_len: int = 0) -> list:
    """Zeroed caches; ``enc_len``: the cross-attention slots of a ``dec``
    layer (the encoder's length)."""
    return [{str(j): blk.block_init_cache(k, cfg, batch, capacity,
                                          device=device, lead=(repeats,),
                                          enc_len=enc_len)
             for j, k in enumerate(pattern)}
            for pattern, repeats in make_stages(cfg)]


def prefill(cfg: ModelConfig, params: PyTree, batch: dict, *,
            cache_capacity: int):
    """Process a prompt, fill KV caches, return last-position logits.

    Only the last position goes through the final norm and unembedding
    (both are row-wise, so the values are the reference's)."""
    x, _, caches = _trunk(cfg, params, batch, cache_capacity)
    x = blk._norm(cfg, params["final_norm"], x[:, -1:])
    return _unembed(cfg, params, x)[:, 0], caches


def state_leaves(cfg: ModelConfig, caches: list) -> list[torch.Tensor]:
    """The recurrent-state tensors of ``caches`` (Mamba's ``h`` and
    ``conv``, the xLSTM states), every kind's but the KV rings: what a
    decode step changes other than by writing a ring slot, so running a
    step twice is not running it once."""
    out = []
    for (pattern, _), stage in zip(make_stages(cfg), caches, strict=True):
        for j, kind in enumerate(pattern):
            if kind in blk.RECURRENT_KINDS:
                c = stage[str(j)]
                out += tree.leaves(c["mamba"] if "mamba" in c else c)
    return out


def cache_lengths(cfg: ModelConfig, capacity: int,
                  enc_len: int = 0) -> set[int]:
    """The distinct ring lengths of ``cfg``'s layers at ``capacity``: KV
    rings (the shared block's too) and MLA's latent rings alike, and a
    ``dec`` layer's ``enc_len`` cross slots when given; empty for a model
    with no attention (xlstm)."""
    out = {n for n in (blk.cache_length(k, cfg, capacity)
                       for k in cfg.layer_kinds) if n is not None}
    if enc_len and "dec" in cfg.layer_kinds:
        out.add(enc_len)
    return out


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
    if cfg.is_encoder_decoder:      # each row's learned position
        x = x + params["pos_embed"][t.long()][:, None].to(x.dtype)
    # an engine surface's trace counts each (stage, pattern position) once,
    # as the reference's scanned layer body is traced once (ksh.mark_site)
    trace = ksh.trace_sites()
    shared = params.get("shared")
    for si, ((pattern, repeats), sp, cache) in enumerate(zip(
            make_stages(cfg), params["stages"], caches, strict=True)):
        for i in range(repeats):
            lp, lc = _layer(sp, i), _layer(cache, i)
            for j, kind in enumerate(pattern):
                ksh.mark_site(trace, (si, j), i)
                x, _ = blk.block_apply_decode(kind, cfg, lp[str(j)], x,
                                              lc[str(j)], t,
                                              kv_shards=kv_shards,
                                              shared=shared)
            x = x.to(cm.COMPUTE_DTYPE)      # the layer's end (blocks.py
                                            # _stream)
    ksh.mark_site(trace, None)
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
    ring wrap).  Returns (logits (B, S, V) f32, caches).  An
    encoder-decoder model raises, as the reference asserts."""
    if cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name}: spec verify is decoder-only")
    tokens = _tokens(params, tokens)
    x = _embed(cfg, params, tokens)
    t = torch.as_tensor(t, dtype=torch.int32, device=x.device)
    trace = ksh.trace_sites()
    for si, ((pattern, repeats), sp, cache) in enumerate(zip(
            make_stages(cfg), params["stages"], caches, strict=True)):
        for i in range(repeats):
            lp, lc = _layer(sp, i), _layer(cache, i)
            for j, kind in enumerate(pattern):
                ksh.mark_site(trace, (si, j), i)
                x, _ = blk.block_apply_verify(kind, cfg, lp[str(j)], x,
                                              lc[str(j)], t)
    ksh.mark_site(trace, None)
    x = blk._norm(cfg, params["final_norm"], x)
    return _unembed(cfg, params, x), caches
