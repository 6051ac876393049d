"""End-to-end UniPruning calibration pipeline.  Port of
``repro.core.calibrate``.

collect_stats    - activation stats over the calibration set (Algorithm 1,
                   line 1): impl="jit", ``models.model.stats_sumsq`` per
                   batch, summed, square-rooted; impl="tape", the eager
                   ``StatsTape`` oracle.
stats_parity     - the aggregate criterion between the two.
run_search       - N mirror-descent steps (lines 3-12), one
                   ``mirror.search_step`` per step with the state updated in
                   place, grouped into the reference's chunks for the
                   flight recorder's per-chunk trace.
unipruning_prune - stats -> search -> Gamma -> masks(W0) at any requested
                   sparsity levels (one search, many budgets).
baseline_masks   - one-shot local-metric baselines sharing the same stats
                   and mask machinery.

Process-level entry point: ``repro_torch.launch.calibrate`` runs stats ->
search once and writes a ``sparse.bank.MaskBank`` artifact.

``rules`` (``dist.axes.ShardingRules`` over a ``launch.mesh.Mesh`` of
ranks; llama and mixtral, ``models.model.check_tp_supported``): the stats
pass runs on each rank's parameter blocks with the whole batch
(activations are replicated) and keeps each kernel's stats block; the
search state lives as each rank's W / Gamma / V blocks
(``dist.sharding.place_state``, on ``dist.sharding.search_specs``) for the
whole search, and the masks come out as blocks.  The model runs with each
kernel gathered whole where it is used (``kernels.shard.whole_weights``):
every rank computes the single process's activations, loss and task
gradient bit for bit and keeps its block of the gradient, and the
per-leaf step runs on the blocks (``core.mirror``).  The serving path's
K-partial sums would change bf16 roundings, which the attention
amplifies (ROADMAP R27).  Every rank calls with the same arguments.
``rules=None`` is the single-process path, unchanged.

The reference runs the search as jitted ``lax.scan`` chunks of ``pcfg.scan_chunk`` steps;
eager torch has no such dispatch, and the chunking does not change the
result (the reference's own test holds scanned against eager).  The port
steps eagerly in the same chunks, so its flight-recorder events are the
reference's: a ``calibrate.search_chunk`` span and log (the chunk's loss,
align, mask_churn, gamma_entropy and sparsity series) per chunk, or a
``calibrate.search_step`` span per step with ``scan_chunk <= 1``, and the
recompile sentinel's ``search_chunk`` / ``search_step`` notes.
"""
from __future__ import annotations

import contextlib
from functools import partial
from typing import Any, Callable, Iterable

import torch

from repro_torch import obs, tree
from repro_torch.analysis import recompile
from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core import masks as masks_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import mirror
from repro_torch.core.prunable import prunable_map
from repro_torch.dist import sharding
from repro_torch.dist.axes import use_rules
from repro_torch.kernels.shard import whole_weights
from repro_torch.optim.losses import lm_loss

PyTree = Any
SEARCH_SEED = 17      # the reference's jax.random.key(17)


def _device_batch(b: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _ranked(cfg: ModelConfig, params: PyTree, rules, quiet: bool):
    """(the search specs, the params placed by them) under ``rules``."""
    from repro_torch.models import model as M
    M.check_tp_supported(cfg, "calibration")
    specs = sharding.search_specs(M.param_axes(cfg), params, rules,
                                  quiet=quiet)
    return specs, sharding.place_by(params, specs, rules)


@torch.no_grad()
def collect_stats(cfg: ModelConfig, params: PyTree, batches: Iterable[dict],
                  *, impl: str = "jit", pcfg: PruneConfig | None = None,
                  rules=None) -> PyTree:
    """Per-input-feature ||X_j||_2 over the calibration set.

    impl="jit": ``models.model.stats_sumsq`` per batch (f32 sums of squares
    on the device, summed over batches, then square-rooted).  impl="tape":
    the eager oracle, the unrolled forward under a ``tape.StatsTape`` (f64
    sums on the host).  pcfg: when given, only the first
    ``pcfg.stats_batches`` batches feed the pass.  ``rules``: the pass
    runs on this rank's parameter blocks and returns each stats leaf as
    the block of its W leaf along K (module docstring).
    """
    if rules is not None:
        specs, placed = _ranked(cfg, params, rules, quiet=True)
        with use_rules(rules), whole_weights():
            whole = collect_stats(cfg, placed, batches, impl=impl, pcfg=pcfg)
        return sharding.place_stats(whole, specs, rules)
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


# series the flight recorder traces per chunk (convergence is the paper's
# whole argument for global feedback: the trajectory must be observable
# without re-running the search)
_TRACE = ("loss", "align", "mask_churn", "gamma_entropy")


def _trace_chunk(ms: list[dict], start: int) -> list[dict]:
    """One chunk's per-step metrics read to the host in one copy, logged as
    the reference logs a chunk (``calibrate.search_chunk``), with the
    steps counter and the three gauges; returns the steps' host metrics."""
    keys = list(ms[0])
    host = torch.stack([torch.stack([m[k].detach().double() for k in keys])
                        for m in ms]).cpu().tolist()
    rows = [dict(zip(keys, r)) for r in host]
    sparsity = [1.0 - r["gamma_nonzero_frac"] for r in rows]
    obs.log("calibrate.search_chunk", start=start, steps=len(ms),
            sparsity=sparsity,
            **{k: [r[k] for r in rows] for k in _TRACE if k in keys})
    obs.inc("calibrate.search_steps", len(ms))
    obs.set_gauge("calibrate.gamma_entropy", rows[-1]["gamma_entropy"])
    obs.set_gauge("calibrate.mask_churn", rows[-1]["mask_churn"])
    obs.set_gauge("calibrate.sparsity", sparsity[-1])
    return rows


def run_search(cfg: ModelConfig, pcfg: PruneConfig, params0: PyTree,
               batches: list[dict], stats: PyTree, *,
               log_every: int = 0, loss_fn: Callable | None = None,
               seed: int = SEARCH_SEED, rules=None):
    """Returns (final state, history): ``pcfg.steps`` steps over the
    batches in turn; history holds every ``log_every``-th step's metrics.

    The steps run in the reference's chunks of ``pcfg.scan_chunk`` (<= 1:
    one step a chunk, traced as ``calibrate.search_step`` spans).  With the flight recorder on, each
    chunk's metrics are read to the host once, after the chunk, for its
    trace and its history rows; with it off nothing is read until the
    last step, when the logged steps' metrics are.

    ``rules``: the state is this rank's blocks for the whole search
    (``dist.sharding.place_state``; whole ``stats`` are placed too) and
    the steps run under the rules; the history is the whole trees'."""
    prunable = prunable_map(params0)
    loss_fn = loss_fn or partial(lm_loss, cfg)
    if rules is None:
        state = mirror.init_search(params0, seed)
    else:
        from repro_torch.models import model as M
        M.check_tp_supported(cfg, "calibration")
        specs = sharding.search_specs(M.param_axes(cfg), params0, rules)
        state = sharding.place_state(M.param_axes(cfg), params0, rules,
                                     seed=seed, specs=specs)
        stats = sharding.place_stats(stats, specs, rules)
    dev = tree.device_of(params0)
    batches = [_device_batch(b, dev) for b in batches]
    chunk = max(int(pcfg.scan_chunk), 0)
    logged = []     # the logged steps' metrics: host rows or device values
    n = 0
    while n < pcfg.steps:
        c = 1 if chunk <= 1 else min(chunk, pcfg.steps - n)
        chunk_batches = [batches[(n + j) % len(batches)] for j in range(c)]
        if chunk <= 1:
            recompile.note("search_step", (state, chunk_batches[0]))
            sp = obs.span("calibrate.search_step", step=n)
        else:
            recompile.note("search_chunk", (state, chunk_batches))
            sp = obs.span("calibrate.search_chunk", start=n, steps=c)
        ms = []
        with sp, use_rules(rules), (whole_weights() if rules is not None
                                    else contextlib.nullcontext()):
            for b in chunk_batches:
                state, m = mirror.search_step(pcfg, loss_fn, state, b, stats,
                                              prunable)
                ms.append(m)
            sp.fence(ms)
        rows = _trace_chunk(ms, n) if obs.enabled() else ms
        if log_every:
            logged += [r for j, r in enumerate(rows)
                       if (n + j) % log_every == 0]
        n += c
    history = [{k: float(v) for k, v in m.items()} for m in logged]
    return state, history


def unipruning_prune(cfg: ModelConfig, pcfg: PruneConfig, params0: PyTree,
                     calib_batches: list[dict],
                     sparsities: Iterable[float] = (0.5,),
                     loss_fn: Callable | None = None, *,
                     stats_impl: str = "jit", rules=None):
    """Full pipeline.  Returns ({sparsity: pruned_params}, state, history);
    ``rules``: the pruned params, the state and the masks as each rank's
    blocks."""
    stats = collect_stats(cfg, params0, calib_batches, pcfg=pcfg,
                          impl=stats_impl, rules=rules)
    state, history = run_search(cfg, pcfg, params0, calib_batches, stats,
                                log_every=10, loss_fn=loss_fn, rules=rules)
    params = params0 if rules is None else _ranked(cfg, params0, rules,
                                                    quiet=True)[1]
    out = {}
    for s in sparsities:
        masks = mirror.export_masks(pcfg, state.Gamma, s, V=state.V,
                                    rules=rules)
        out[s] = masks_mod.apply_masks(params, masks)
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
