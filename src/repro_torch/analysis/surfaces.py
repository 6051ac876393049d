"""Registered hot paths for the op auditor and the contract checks.

Port of ``repro.analysis.surfaces``.  A *surface* is one hot step function
plus concrete smoke arguments to call it with: the ``ServeEngine`` step
functions (decode, bucketed prefill, the slot write, the spec verifier)
and the calibration search chunk.  Each is built the way serving and
calibration build it - sparse bf16 params through
``sparse.apply.sparsify_params``, the engine's ``EngineFns`` and its
``serving_params`` cast, ``core.mirror.search_step`` over a chunk of
calibration batches with the state updated in place (the port's donation)
- so the audited op stream IS the served one.

Smoke configs keep the calls cheap (the auditor runs them on the ``meta``
device: seconds); the static facts the contracts gate on (collectives per
site, zero host syncs, no silent f32 upcasts, the kernels called per site,
the arguments updated in place) are scale-free.  The surfaces are built
on the card unless ``device`` names another device; a mesh
(``mesh_shape``) waits for tensor parallelism (ROADMAP A item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Surface", "serve_surfaces", "search_surface", "all_surfaces",
           "no_mesh"]


@dataclasses.dataclass
class Surface:
    """One auditable entry point with its arguments.

    policy: "serve" surfaces must have ZERO large bf16->f32 upcasts;
    "train" surfaces legitimately upcast in the backward pass (weight
    gradients in f32), so their count is pinned by the golden instead of
    forced to zero.  ``donate_argnums``: the arguments the reference's jit
    donates (the port updates them in place)."""
    name: str
    fn: Callable
    args: tuple
    donate_argnums: tuple = ()
    policy: str = "serve"


def no_mesh(mesh_shape) -> None:
    """Raise unless ``mesh_shape`` is None (one card)."""
    if mesh_shape is not None:
        raise NotImplementedError(
            f"mesh_shape={tuple(mesh_shape)}: the port's static analysis "
            "runs on one card; a mesh waits for tensor parallelism (ROADMAP "
            "A item 7)")


def _sparse_smoke(arch: str, *, device, idx_bits: int = 2):
    """Smoke config + 2:4-sparse bf16 compressed params (magnitude masks,
    the serving tests' setup)."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import masks as masks_mod
    from repro_torch.core import metrics as metrics_mod
    from repro_torch.core.prunable import prunable_map
    from repro_torch.models import model as M
    from repro_torch.sparse import apply as apply_mod
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0, device=device)
    pr = prunable_map(params)
    scores = metrics_mod.metric_tree(
        "magnitude", params, tree.tree_map(lambda _: None, pr), pr)
    masks = masks_mod.nm_masks(scores)
    sparse = apply_mod.sparsify_params(
        params, masks, axes=M.param_axes(cfg), idx_bits=idx_bits,
        dtype=torch.bfloat16)
    return cfg, sparse


def verify_fn(cfg) -> Callable:
    """The engine's k-token verify pass as the reference jits it:
    ``(params, toks (B, k), caches, pos (B,)) -> (argmax (B, k) int32,
    caches)``."""
    from repro_torch.models import model as M

    def verify(p, toks, caches, t):
        logits, caches = M.verify_step(cfg, p, toks, caches, t)
        return logits.argmax(-1).to(torch.int32), caches
    return verify


def serve_surfaces(arch: str = "llama3.2-1b", *,
                   mesh_shape: tuple | None = None, sparse: bool = True,
                   slots: int = 2, capacity: int = 32,
                   prefill_bucket: int = 8, spec_k: int = 4, device=None,
                   kv_shards: int | None = None,
                   params=None) -> list[Surface]:
    """decode / prefill_<bucket> / write_slot / verify_<k> for one smoke
    engine.

    ``verify_<k>`` registers only for archs whose layer kinds support spec
    mode (``serve.spec.SPEC_SAFE_KINDS``, no sliding window), the gate the
    decoder enforces.  The decode surface stays at index 0 (the zoo and
    the planner key off it).  ``kv_shards``: the engine's decode attention
    path.  ``params``: the engine's params as built (by default the smoke
    config's, 2:4 compressed with ``sparse``), before its serving cast.
    """
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.spec import SPEC_SAFE_KINDS
    no_mesh(mesh_shape)
    device = resolve_device(device)
    from repro_torch.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    if params is None and sparse:
        params = _sparse_smoke(arch, device=device)[1]
    elif params is None:
        params = M.init_params(cfg, 0, device=device)
    eng = ServeEngine(cfg, params, slots=slots, capacity=capacity,
                      device=device, kv_shards=kv_shards)
    ints = dict(dtype=torch.int32, device=device)
    toks = torch.zeros((slots,), **ints)
    pos = torch.zeros((slots,), **ints)
    ptoks = torch.zeros((1, prefill_bucket), **ints)
    fns = eng.fns
    out = [
        Surface("decode", fns.decode, (eng.params, toks, eng.caches, pos)),
        Surface(f"prefill_{prefill_bucket}", fns.prefill,
                (eng.params, ptoks)),
        Surface("write_slot", fns.write_slot,
                (eng.caches, fns.blank_row(), 0)),
    ]
    if set(cfg.layer_kinds) <= SPEC_SAFE_KINDS and not cfg.sliding_window:
        vtoks = torch.zeros((slots, spec_k), **ints)
        out.append(Surface(f"verify_{spec_k}", verify_fn(cfg),
                           (eng.params, vtoks, eng.caches, pos)))
    return out


def _chunk(pcfg, loss_fn: Callable, stats, prunable, state,
           stacked: dict):
    from repro_torch.core import mirror
    ms = []
    for j in range(next(iter(stacked.values())).shape[0]):
        state, m = mirror.search_step(
            pcfg, loss_fn, state, {k: v[j] for k, v in stacked.items()},
            stats, prunable)
        ms.append(m)
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}


def chunk_fn(pcfg, loss_fn: Callable, stats, prunable) -> Callable:
    """The search chunk: ``(state, stacked batches) -> (state, metrics
    stacked over the chunk)``, ``core.mirror.search_step`` once per batch
    (the reference's ``make_chunk_fn`` scans it), the state updated in
    place.  A ``functools.partial``, so the auditor moves the stats it
    binds to the audit's device with the arguments."""
    from functools import partial
    return partial(_chunk, pcfg, loss_fn, stats, prunable)


def search_surface(arch: str = "llama3.2-1b", *, chunk: int = 2,
                   batch: int = 2, seq: int = 32, metric: str = "wanda",
                   device=None) -> Surface:
    """The calibration search chunk over ``chunk`` calibration batches,
    its state updated in place (the reference donates it)."""
    from functools import partial

    from repro_torch.configs.base import PruneConfig, get_smoke_config
    from repro_torch.core import calibrate, mirror
    from repro_torch.core.prunable import prunable_map
    from repro_torch.data.synthetic import batches_for
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    from repro_torch.optim.losses import lm_loss
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0, device=device)
    batches = batches_for(cfg, n=chunk, batch=batch, seq=seq, split="calib")
    pcfg = PruneConfig(local_metric=metric, steps=chunk, scan_chunk=chunk)
    stats = calibrate.collect_stats(cfg, params, batches, pcfg=pcfg)
    prunable = prunable_map(params)
    state = mirror.init_search(params, calibrate.SEARCH_SEED)
    stacked = {k: torch.stack([torch.as_tensor(b[k], device=device)
                               for b in batches]) for k in batches[0]}
    fn = chunk_fn(pcfg, partial(lm_loss, cfg), stats, prunable)
    return Surface("search_chunk", fn, (state, stacked), donate_argnums=(0,),
                   policy="train")


def all_surfaces(arch: str = "llama3.2-1b", *,
                 mesh_shape: tuple | None = None,
                 include_search: bool | None = None, device=None,
                 kv_shards: int | None = None) -> list[Surface]:
    """The full registry for one arch: the serve surfaces, then (by
    default) the search chunk."""
    out = serve_surfaces(arch, mesh_shape=mesh_shape, device=device,
                         kv_shards=kv_shards)
    if include_search is None or include_search:
        out.append(search_surface(arch, device=device))
    return out
