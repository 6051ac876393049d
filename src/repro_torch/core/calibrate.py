"""End-to-end UniPruning calibration pipeline.  Port of
``repro.core.calibrate``.

collect_stats    - activation stats over the calibration set (Algorithm 1,
                   line 1): impl="jit", ``models.model.stats_sumsq`` per
                   batch, summed, square-rooted; impl="tape", the eager
                   ``StatsTape`` oracle.
stats_parity     - the aggregate criterion between the two.
run_search       - N mirror-descent steps (lines 3-12), one
                   ``mirror.search_step`` per step with the state updated in
                   place.
unipruning_prune - stats -> search -> Gamma -> masks(W0) at any requested
                   sparsity levels (one search, many budgets).
baseline_masks   - one-shot local-metric baselines sharing the same stats
                   and mask machinery.

Process-level entry point: ``repro_torch.launch.calibrate`` runs stats ->
search once and writes a ``sparse.bank.MaskBank`` artifact.  The reference
runs the search as jitted ``lax.scan`` chunks of ``pcfg.scan_chunk`` steps;
eager torch has no such dispatch, and the chunking does not change the
result (the reference's own test holds scanned against eager), so
``scan_chunk`` is kept in the config only for the bank's ``pcfg``.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Callable, Iterable

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core import masks as masks_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import mirror
from repro_torch.core.prunable import prunable_map
from repro_torch.optim.losses import lm_loss

PyTree = Any
SEARCH_SEED = 17      # the reference's jax.random.key(17)


def _device_batch(b: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


@torch.no_grad()
def collect_stats(cfg: ModelConfig, params: PyTree, batches: Iterable[dict],
                  *, impl: str = "jit",
                  pcfg: PruneConfig | None = None) -> PyTree:
    """Per-input-feature ||X_j||_2 over the calibration set.

    impl="jit": ``models.model.stats_sumsq`` per batch (f32 sums of squares
    on the device, summed over batches, then square-rooted).  impl="tape":
    the eager oracle, the unrolled forward under a ``tape.StatsTape`` (f64
    sums on the host).  pcfg: when given, only the first
    ``pcfg.stats_batches`` batches feed the pass.
    """
    from repro_torch.core import tape as tape_mod
    from repro_torch.models import model as M
    batches = list(batches)
    if pcfg is not None:
        batches = batches[:pcfg.stats_batches]
    if not batches:
        raise ValueError("collect_stats needs at least one calibration batch")
    dev = tree.device_of(params)
    if impl == "tape":
        t = tape_mod.StatsTape()
        with tape_mod.recording(t):
            for b in batches:
                lm_loss(cfg, params, _device_batch(b, dev), unroll=True)
        return tape_mod.resolve_stats(t, params)
    if impl != "jit":
        raise ValueError(f"unknown stats impl {impl!r}; options: jit, tape")
    acc = None
    for b in batches:
        ss = M.stats_sumsq(cfg, params, _device_batch(b, dev))
        acc = ss if acc is None else tree.tree_map(
            lambda a, s: None if a is None else a + s, acc, ss)
    return tree.tree_map(lambda a: None if a is None else torch.sqrt(a), acc)


def stats_parity(tape_stats: PyTree, jit_stats: PyTree, prunable: PyTree,
                 *, tol: float = 5e-2) -> tuple[float, bool, int]:
    """(worst per-prunable-leaf relative Frobenius error, pass flag, leaves
    checked): the reference's criterion between the jitted pass and the
    tape oracle.  Aggregate, not elementwise, on purpose: the two passes
    may route a near-tied MoE token to different experts, moving single
    rows between expert stats; the norm bounds that noise and still
    catches a dropped per-expert rescale (whole rows off by ~2x)."""
    worst, checked = 0.0, 0
    for t, j, p in zip(tree.leaves(tape_stats), tree.leaves(jit_stats),
                       tree.leaves(prunable), strict=True):
        if not p:
            continue
        if t is None:
            raise ValueError("the tape missed a prunable leaf")
        if j is None:
            raise ValueError("the jitted pass missed a prunable leaf")
        if t.shape != j.shape:
            raise ValueError(f"stats shapes differ: {tuple(t.shape)} vs "
                             f"{tuple(j.shape)}")
        t, j = t.detach().double(), j.detach().double()
        worst = max(worst, float(torch.linalg.vector_norm(t - j) / (
            torch.linalg.vector_norm(t) + 1e-12)))
        checked += 1
    return worst, bool(worst <= tol) and checked > 0, checked


def run_search(cfg: ModelConfig, pcfg: PruneConfig, params0: PyTree,
               batches: list[dict], stats: PyTree, *,
               log_every: int = 0, loss_fn: Callable | None = None,
               seed: int = SEARCH_SEED):
    """Returns (final state, history): ``pcfg.steps`` steps over the
    batches in turn; history holds every ``log_every``-th step's metrics,
    read from the device once, after the last step."""
    prunable = prunable_map(params0)
    loss_fn = loss_fn or partial(lm_loss, cfg)
    state = mirror.init_search(params0, seed)
    dev = tree.device_of(params0)
    batches = [_device_batch(b, dev) for b in batches]
    logged = []
    for n in range(pcfg.steps):
        state, m = mirror.search_step(pcfg, loss_fn, state,
                                      batches[n % len(batches)], stats,
                                      prunable)
        if log_every and n % log_every == 0:
            logged.append(m)
    history = [{k: float(v) for k, v in m.items()} for m in logged]
    return state, history


def unipruning_prune(cfg: ModelConfig, pcfg: PruneConfig, params0: PyTree,
                     calib_batches: list[dict],
                     sparsities: Iterable[float] = (0.5,),
                     loss_fn: Callable | None = None, *,
                     stats_impl: str = "jit"):
    """Full pipeline.  Returns ({sparsity: pruned_params}, state, history)."""
    stats = collect_stats(cfg, params0, calib_batches, pcfg=pcfg,
                          impl=stats_impl)
    state, history = run_search(cfg, pcfg, params0, calib_batches, stats,
                                log_every=10, loss_fn=loss_fn)
    out = {}
    for s in sparsities:
        masks = mirror.export_masks(pcfg, state.Gamma, s, V=state.V)
        out[s] = masks_mod.apply_masks(params0, masks)
    return out, state, history


def baseline_masks(method: str, params0: Any, stats: Any, sparsity: float,
                   *, mode: str = "unstructured", scope: str = "row",
                   nm: tuple[int, int] = (2, 4), key=None) -> Any:
    """Local-metric one-shot baselines (no search stage); ``key``, a
    ``core.prng`` key, draws stochria's subsets."""
    prunable = prunable_map(params0)
    S = metrics_mod.metric_tree(method, params0, stats, prunable, key=key)
    if mode == "nm":
        return masks_mod.nm_masks(S, *nm)
    if method == "magnitude" and scope == "row":
        scope = "layer"  # magnitude baseline is layer-wise in the paper
    return masks_mod.unstructured_masks(S, sparsity, scope=scope)
