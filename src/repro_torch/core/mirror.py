"""UniPruning mirror-descent search (paper Algorithm 1, Eqs. 5-7) and mask
export.  Port of ``repro.core.mirror``.

State: an f32 copy W of the pretrained weights, the saliency variable Gamma
and its dual V (both only on prunable leaves).  Per step:

  g_task = grad_W L_task(W^n)
  g_align= rho * grad_W 0.5||Gamma - S(W)||^2
  W     <- W - kappa*alpha*(g_task + g_align)
  W     <- Prox_{R_{2:4}}(W)                          [N:M mode only]
  S      = S(W, X)                                    local metric
  V     <- V - alpha*rho*(Gamma - S)
  Gamma <- soft_threshold(V, lam)                     prox of lam*L1

The pretrained W0 is never written; masks come from Gamma and are applied to
W0 (``core/masks.py``).  The last three lines run as one pass per prunable
leaf, the hand-written ``saliency_fused_step`` on the card (its plain
version on the CPU), and the prox as ``prox24``: the kernels compute the
reference's functions op for op.  Where JAX returns new trees, this search
updates W, Gamma and V in place, leaf by leaf, and takes the alignment
gradient one leaf at a time, so no second copy of a full tree is held.

:func:`no_mirror_step` is the paper's Eq. 8 ablation: the direct
objective, without Gamma, V or mirror descent.

**Under rules** (``dist.axes.use_rules``, one process a rank; the state
placed by ``dist.sharding.place_state``) a sharded leaf of W, Gamma, V and
the stats is this rank's ``DenseBlock``.  The task gradient comes from
the model run on each weight gathered whole where it is used
(``kernels.shard.whole_weights``: each rank keeps its block of it), and
each block runs the same per-leaf step, ``saliency_fused_step`` and
``prox24`` included, on the block, with what the whole leaf decides:
RIA's row and column sums and stochria's draws (``metrics.block_metric``),
the median or mean normaliser (``metrics.score_divisor``), the
observables summed over the leaf's ranks, and the masks' global
magnitudes and threshold (:func:`export_masks`).  A replicated leaf runs
whole on every rank and counts once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import tree
from repro_torch.configs.base import PruneConfig
from repro_torch.core import masks as masks_mod
from repro_torch.core import metrics as metrics_mod
from repro_torch.core import prng
from repro_torch.core.prunable import prunable_map
from repro_torch.dist.axes import current_rules
from repro_torch.dist.sharding import DenseBlock, LeafLayout
from repro_torch.dist.sharding import block_data as _data
from repro_torch.dist.sharding import like_block as _like
from repro_torch.kernels.nm_prox import prox24
from repro_torch.kernels.saliency_fuse import saliency_fused_step

PyTree = Any


@dataclasses.dataclass
class SearchState:
    W: PyTree          # f32 copy of the full params tree
    Gamma: PyTree      # saliency variable (prunable leaves, else None)
    V: PyTree          # dual variable (prunable leaves, else None)
    step: int
    rng: prng.Key      # the reference's threefry key, as (hi, lo) words


def init_search(params0: PyTree, seed: int) -> SearchState:
    """The search's start from params0, its key ``jax.random.key(seed)``'s
    (``prng.key``)."""
    pr = prunable_map(params0)
    zeros = lambda w, p: (torch.zeros(w.shape, dtype=torch.float32,
                                      device=w.device) if p else None)
    return SearchState(
        # a copy, never an alias: the search writes W in place
        W=tree.tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                        params0),
        Gamma=tree.tree_map(zeros, params0, pr),
        V=tree.tree_map(zeros, params0, pr),
        step=0, rng=prng.key(seed))


def _scalar(x: float, device) -> torch.Tensor:
    """An f32 device scalar, made without a host-to-device copy."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _leaf_score(pcfg: PruneConfig, w, a, key, lay=None):
    """S(w) of one leaf, normalised (the reference's metric_tree leaf);
    ``lay``: ``w`` is this rank's block of the leaf."""
    if lay is not None:
        return metrics_mod.normalize_scores(metrics_mod.block_metric(
            pcfg.local_metric, w, a, key=key, lay=lay,
            stoch_frac=pcfg.stoch_frac), pcfg.score_norm, lay)
    fn = metrics_mod.get_metric(pcfg.local_metric, pcfg.stoch_frac)
    return metrics_mod.normalize_scores(fn(w, a, key=key), pcfg.score_norm)


def _align_leaf(pcfg: PruneConfig, w, gamma, a, key, lay=None):
    """One leaf's term of 0.5*rho*sum ||Gamma - S(W)||_F^2: (its
    sum ||Gamma - S||^2, the W-gradient of 0.5*rho times it).  ``lay``:
    this rank's block's part of the sum, and the gradient of the sum over
    the ranks' parts (RIA's sums carry the other blocks' terms)."""
    with torch.enable_grad():
        wg = w.detach().requires_grad_(True)
        sq = torch.sum(torch.square(gamma - _leaf_score(pcfg, wg, a, key,
                                                        lay)))
        grad, = torch.autograd.grad((0.5 * pcfg.rho) * sq, wg)
    return sq.detach(), grad


def _leaf_key(pcfg: PruneConfig, key, i: int):
    """Leaf i's key, ``fold_in(key, i)`` as the reference's metric_tree
    draws it; only stochria reads a key, so the others get None."""
    if pcfg.local_metric != "stochria" or key is None:
        return None
    return prng.fold_in(key, i)


def _align_value_and_grad(pcfg: PruneConfig, W, Gamma, stats, prunable,
                          key: prng.Key | None):
    """0.5*rho*sum_leaves ||Gamma - S(W)||_F^2 and its W-gradient (zeros on
    leaves that are not prunable)."""
    flat_w = tree.leaves(W)
    acc = _scalar(0.0, flat_w[0].device)
    grads = []
    for i, (w, g, a, p) in enumerate(zip(
            flat_w, tree.leaves(Gamma), tree.leaves(stats),
            tree.leaves(prunable), strict=True)):
        if p:
            sq, ga = _align_leaf(pcfg, w, g, a, _leaf_key(pcfg, key, i))
            acc = acc + sq
            grads.append(ga)
        else:
            grads.append(torch.zeros_like(w))
    return 0.5 * pcfg.rho * acc, tree.unflatten_like(W, grads)


def _task_value_and_grad(pcfg: PruneConfig, loss_fn: Callable, W: PyTree,
                         batch: dict):
    """((loss, metrics), grad), optionally accumulated over microbatches.

    grad_accum > 1 splits the batch dim into microbatch slices and runs the
    backward once per slice, so peak activation memory is that of one
    microbatch while the averaged gradient matches the full batch.
    """
    accum = max(1, int(pcfg.grad_accum))
    flat = tree.leaves(W)
    leaves = [_data(w).detach().requires_grad_(True) for w in flat]
    Wg = tree.unflatten_like(W, [_like(w, x) for w, x in zip(flat, leaves)])

    def one(b):
        with torch.enable_grad():
            loss, metrics = loss_fn(Wg, b)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(w) if g is None else g
                 for w, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    if accum == 1:
        loss, metrics, grads = one(batch)
        return (loss, metrics), tree.unflatten_like(W, grads)
    rows = batch["tokens"].shape[0]
    if rows % accum:
        raise ValueError(f"grad_accum={accum} must divide the calibration "
                         f"batch dim {rows}")
    m = rows // accum
    tot = None
    for j in range(accum):
        part = one({k: v[j * m:(j + 1) * m] for k, v in batch.items()})
        tot = part if tot is None else (
            tot[0] + part[0], {k: tot[1][k] + part[1][k] for k in tot[1]},
            [x + y for x, y in zip(tot[2], part[2])])
    div = lambda x: x / _scalar(float(accum), x.device)
    return ((div(tot[0]), {k: div(v) for k, v in tot[1].items()}),
            tree.unflatten_like(W, [div(g) for g in tot[2]]))


def _fused_leaf(pcfg: PruneConfig, w, gamma, v, a, key, lay=None) -> None:
    """V, Gamma <- the fused metric + dual + prox step, in place (``lay``:
    on this rank's block of the leaf, with the whole leaf's divisor and
    RIA sums)."""
    lead = w.shape[:-2]
    K, N = w.shape[-2:]
    R = K * (lead.numel() if lead else 1)
    metric = pcfg.local_metric
    if metric == "wanda" and a is None:
        metric = "magnitude"          # wanda without stats is |W|
    ria = metric in ("ria", "stochria")
    if ria and a is None:
        a = torch.ones(w.shape[:-1], dtype=torch.float32, device=w.device)
    s_div = None
    if pcfg.score_norm != "none" and lay is not None:
        raw = metrics_mod.block_metric(pcfg.local_metric, w, a, key=key,
                                       lay=lay, stoch_frac=pcfg.stoch_frac)
        s_div = metrics_mod.score_divisor(raw, pcfg.score_norm, lay)
        del raw
    elif pcfg.score_norm != "none":
        raw = metrics_mod.get_metric(pcfg.local_metric, pcfg.stoch_frac)(
            w, a, key=key)
        s_div = (metrics_mod.median_element(raw) if pcfg.score_norm ==
                 "median" else raw.mean()) + 1e-12
        del raw
    rowsum = colsum = None
    if ria:   # the RIA normalisers, with stochria's draws for this step
        weights = (metrics_mod.stoch_weights(
            key, tuple(w.shape) if lay is None else lay.whole_shape(w),
            pcfg.stoch_frac, w.device)
                   if pcfg.local_metric == "stochria" else ())
        rowsum, colsum = (
            metrics_mod.ria_sums(w.reshape(-1, K, N), *weights)
            if lay is None else metrics_mod.ria_sums_block(w, lay, *weights))
        rowsum, colsum = rowsum.reshape(R), colsum.reshape(-1, N)
    saliency_fused_step(
        w.reshape(R, N), None if a is None else a.reshape(R),
        gamma.reshape(R, N), v.reshape(R, N), metric=metric,
        v_lr=pcfg.v_lr, lam=pcfg.lam, rowsum=rowsum, colsum=colsum,
        s_div=s_div, inplace=True)


def _observables(sq, gamma, was_nz) -> torch.Tensor:
    """One block's (||Gamma - S||^2, nonzeros, flips, sum |Gamma|,
    sum |Gamma| log |Gamma|), f64 to be summed over the leaf's ranks."""
    now_nz = gamma != 0
    ab = gamma.abs()
    pos = ab > 0
    return torch.stack([
        sq.double(), now_nz.sum().double(),
        (was_nz != now_nz).sum().double(), ab.sum().double(),
        torch.where(pos, ab * torch.log(torch.where(pos, ab, 1.0)),
                    0.0).sum().double()])


@torch.no_grad()
def search_step(pcfg: PruneConfig, loss_fn: Callable, state: SearchState,
                batch: dict, stats: PyTree, prunable: PyTree):
    """One mirror-descent iteration, updating ``state`` in place.
    loss_fn(W, batch) -> (loss, metrics).  Returns (state, metrics): device
    scalars, read by the caller when it wants them."""
    key = (prng.fold_in(state.rng, state.step)
           if pcfg.local_metric == "stochria" else None)
    (loss, loss_metrics), g_task = _task_value_and_grad(
        pcfg, loss_fn, state.W, batch)
    flat_w = tree.leaves(state.W)
    dev = flat_w[0].device
    rules = current_rules()
    klr = pcfg.kappa * pcfg.lr
    acc = _scalar(0.0, dev)
    nz, flips, absum, abslogsum = (_scalar(0.0, dev) for _ in range(4))
    tot = 0
    for i, (w, gt, gamma, v, a, p) in enumerate(zip(
            flat_w, tree.leaves(g_task), tree.leaves(state.Gamma),
            tree.leaves(state.V), tree.leaves(stats), tree.leaves(prunable),
            strict=True)):
        lay = None
        if isinstance(w, DenseBlock):     # this rank's block of the leaf
            lay = LeafLayout(w.spec, rules.mesh, w.data.dim())
            w, gamma, v, a = w.data, _data(gamma), _data(v), _data(a)
        if not p:
            w.sub_(klr * gt)              # its alignment gradient is zero
            continue
        k_i = _leaf_key(pcfg, key, i)
        sq, ga = _align_leaf(pcfg, w, gamma, a, k_i, lay)
        if lay is None:
            acc = acc + sq
        w.sub_(klr * (gt + ga))
        del ga
        if pcfg.mode == "nm" and w.shape[-2] % 4 == 0:
            w2 = w.view(-1, w.shape[-1])
            prox24(w2, lam=pcfg.nm_prox_weight, out=w2)
        was_nz = gamma != 0
        _fused_leaf(pcfg, w, gamma, v, a, k_i, lay)
        if lay is not None:   # the whole leaf's observables
            # the leaf's totals, added as the single process adds a
            # leaf's (the counts as integers, the sums as f32)
            part = lay.total(_observables(sq, gamma, was_nz))
            acc = acc + part[0].float()
            nz += part[1].long()
            flips += part[2].long()
            absum += part[3].float()
            abslogsum += part[4].float()
            tot += lay.numel(gamma)
            del was_nz, part
            continue
        # convergence observables (reference: search_step's loop)
        now_nz = gamma != 0
        nz += now_nz.sum()
        flips += (was_nz != now_nz).sum()
        del was_nz, now_nz
        ab = gamma.abs()
        absum += ab.sum()
        pos = ab > 0
        abslogsum += torch.where(pos, ab * torch.log(torch.where(
            pos, ab, 1.0)), 0.0).sum()
        tot += gamma.numel()
        del ab, pos
    g_task = None
    z = torch.clamp_min(absum, 1e-30)
    entropy = torch.where(absum > 0, torch.log(z) - abslogsum / z, 0.0)
    entropy = entropy / torch.log(_scalar(float(max(tot, 2)), dev))
    state.step += 1
    frac = lambda x: x / _scalar(float(max(tot, 1)), dev)
    metrics = {"loss": loss, "align": 0.5 * pcfg.rho * acc,
               "gamma_nonzero_frac": frac(nz), "mask_churn": frac(flips),
               "gamma_entropy": entropy, **loss_metrics}
    return state, metrics


@torch.no_grad()
def no_mirror_step(pcfg: PruneConfig, loss_fn: Callable, W: PyTree,
                   batch: dict, stats: PyTree, prunable: PyTree,
                   rng: prng.Key, step: int, *, l2: float):
    """The ablation (paper Eq. 8 / Table 5): the direct objective, without
    the saliency variable or mirror descent,

        L_task(W) + rho/2 ||S(W)||^2 + l2 ||W||^2,

    one gradient step W <- W - kappa*alpha*grad.  S is
    ``metric_tree(pcfg.local_metric, W, stats, prunable, key=fold_in(rng,
    step))`` unnormalised, differentiated through wanda, ria and stochria
    (stochria's subsets are constants of the step).  Each prunable leaf's
    regulariser is differentiated on its own after the task gradient, so no
    graph over every leaf's scores is held at once.  Updates W in place
    (pass a copy) and returns (W, the objective's value)."""
    key = prng.fold_in(rng, int(step))
    (loss, _), g_task = _task_value_and_grad(pcfg, loss_fn, W, batch)
    metric = metrics_mod.get_metric(pcfg.local_metric, pcfg.stoch_frac)
    klr = pcfg.kappa * pcfg.lr
    reg = _scalar(0.0, loss.device)
    for i, (w, gt, a, p) in enumerate(zip(
            tree.leaves(W), tree.leaves(g_task), tree.leaves(stats),
            tree.leaves(prunable), strict=True)):
        if p:
            with torch.enable_grad():
                wg = w.detach().requires_grad_(True)
                s = metric(wg, a, key=prng.fold_in(key, i))
                part = (0.5 * pcfg.rho * torch.sum(torch.square(s))
                        + l2 * torch.sum(torch.square(wg)))
                g, = torch.autograd.grad(part, wg)
            reg = reg + part.detach()
            gt = gt + g
            del s, g
        w.sub_(klr * gt)
    return W, loss + reg


def _absmax(leaves: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([x.abs().max() for x in leaves]).max()


def export_masks(pcfg, Gamma: Any, sparsity: float, *, V: Any = None,
                 exact: bool = True, rules=None) -> Any:
    """One-shot mask extraction from the final Gamma (any sparsity level).

    Soft-thresholded-to-zero entries tie at |Gamma| = 0; the dual V keeps
    their sub-threshold saliency, so it breaks ties at an epsilon scale
    that cannot reorder any nonzero Gamma entries.  The arithmetic is the
    reference's, op for op in f32, so the masks are bit-identical.

    ``rules``: Gamma and V hold this rank's blocks (``DenseBlock``); the
    largest magnitudes are the whole trees' (an all-reduce MAX), the 2:4
    masks come from ``nm_mask24`` on each block, the global threshold
    from every leaf's scores gathered, and each mask leaf is the rank's
    block.
    """
    scores = Gamma
    if V is not None:
        gl = [_data(g) for g in tree.leaves(Gamma) if g is not None]
        vl = [_data(v) for v in tree.leaves(V) if v is not None]
        dev = (gl or vl)[0].device
        gmax = (_absmax(gl) if gl
                else torch.tensor(0.0, dtype=torch.float32, device=dev))
        vmax = (_absmax(vl) if vl
                else torch.tensor(1.0, dtype=torch.float32, device=dev))
        if rules is not None:   # the whole trees' (MAX is idempotent)
            every = tuple(rules.mesh.axis_names)
            gmax = rules.mesh.all_reduce(gmax, every, "max")
            vmax = rules.mesh.all_reduce(vmax, every, "max")
        vsafe = torch.clamp_min(vmax, 1e-30)
        eps = torch.where(gmax > 0,
                          1e-6 * torch.clamp_min(gmax, 1e-30) / vsafe,
                          1.0 / vsafe)
        scores = tree.tree_map(
            lambda g, v: None if g is None else _like(
                g, _data(g).abs() + eps * _data(v).abs()), Gamma, V)
    if pcfg.mode == "nm":
        return masks_mod.nm_masks(scores, pcfg.nm_n, pcfg.nm_m)
    return masks_mod.unstructured_masks(
        scores, sparsity, scope="global", exact=exact,
        mesh=None if rules is None else rules.mesh)
