"""Optimizers.  Port of ``repro.optim.optimizers``: AdamW with global-norm
clipping and a warmup-cosine schedule, and SGD.

The reference returns new trees and its launcher donates the old ones to
the step.  Here :func:`adamw_update` and :func:`sgd_update` write the
parameters and the moments in place (the same tensors, updated), so a step
holds one copy of each: a caller that wants the old values keeps a copy
(``CheckpointManager.save_async`` copies to the host before it returns).

Masters, moments and the schedule are f32, ``count`` an int32 scalar on
the parameters' device.  Every op rounds to f32 on its own, in the
reference's order; a scalar that divides is a device tensor (a CUDA tensor
divided by a Python float is multiplied by its reciprocal instead), and
the CPU's square root is the correctly rounded one (``kernels.ref``).

**On a mesh** (``launch.steps.make_train_step(rules=)``) a parameter the
mesh shards is this rank's ``dist.sharding.DenseBlock``, and so are its
gradient, ``mu`` and ``nu`` (the reference's ZeRO: the moments take
their parameter's spec); ``count`` is replicated.  The update is
elementwise and runs on each block.  The global norm is the one
cross-rank step: each sharded gradient is gathered whole on one rank in
turn and its sum of squares taken as one process takes it, so every rank
gets one process's norm bit for bit (ROADMAP R28).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree
from repro_torch.dist.sharding import DenseBlock, block_data, like_block
from repro_torch.kernels.ref import sqrt_f32

PyTree = Any


@dataclasses.dataclass
class AdamWState:
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _scalar(x: float, device) -> torch.Tensor:
    """An f32 device scalar (a divisor on the card must be a tensor)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x) if x.is_cuda else sqrt_f32(x)


def warmup_cosine(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a device scalar, or an int for the
    CPU): linear warmup, then cosine decay to ``min_lr_frac``, in f32."""
    step = torch.as_tensor(step).float()
    dev = step.device
    warm = step / _scalar(max(cfg.warmup_steps, 1), dev)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _scalar(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float().contiguous()))


def global_norm(t: PyTree, mesh=None) -> torch.Tensor:
    """sqrt of the sum over leaves (in jax's flatten order, one f32 sum of
    squares each, over the leaf's contiguous copy) of the squares: a device
    scalar.  ``DenseBlock`` leaves (their blocks over ``mesh``): each is
    gathered whole on one rank in turn (round robin), which takes its sum
    as one process takes it; one all-reduce of those sums (each with
    zeros from the other ranks: exact) gives every rank all of them, and
    every rank adds the leaves in order."""
    xs = [x for x in tree.leaves(t) if x is not None]
    blocks = [x for x in xs if isinstance(x, DenseBlock)]
    if blocks:
        sums = torch.zeros(len(blocks), dtype=torch.float32,
                           device=blocks[0].device)
        for i, x in enumerate(blocks):
            w = mesh.gather_whole(x.data, x.spec, dst=i % mesh.size)
            if w is not None:
                sums[i] = _square_sum(w)
            del w
        sums = mesh.all_reduce(sums, mesh.axis_names).unbind(0)
    tot, k = None, 0
    for x in xs:
        if isinstance(x, DenseBlock):
            s, k = sums[k], k + 1
        else:
            s = _square_sum(x)
        tot = s if tot is None else tot + s
    return _sqrt(tot)


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.minimum(_scalar(1.0, g.device),
                         _scalar(max_norm, g.device)
                         / torch.clamp_min(g, 1e-12))


def clip_by_global_norm(t: PyTree, max_norm: float):
    """(the tree scaled to global norm <= max_norm, its global norm); a new
    tree."""
    g = global_norm(t)
    scale = _clip_scale(g, max_norm)
    return tree.tree_map(lambda x: None if x is None else x * scale, t), g


def adamw_init(params: PyTree) -> AdamWState:
    """Zero moments (a ``DenseBlock`` parameter's: zero blocks of its
    spec) and a zero count."""
    z = lambda: tree.tree_map(
        lambda p: like_block(p, torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)), params)
    return AdamWState(mu=z(), nu=z(), count=torch.zeros(
        (), dtype=torch.int32, device=tree.device_of(params)))


def adamw_update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
                 params: PyTree, mesh=None):
    """One AdamW step: params, ``state.mu`` and ``state.nu`` updated in
    place, ``state.count`` advanced.  ``grads`` are consumed: f32 leaves
    are clipped in place.  ``mesh``: the mesh of the ``DenseBlock``
    leaves (each rank's blocks; module docstring).  Returns (params,
    state, {"grad_norm", "lr"}), device scalars."""
    gs = [like_block(g, block_data(g).float()) for g in tree.leaves(grads)]
    gnorm = global_norm(gs, mesh)
    gs = [block_data(g) for g in gs]
    if cfg.clip_norm:
        scale = _clip_scale(gnorm, cfg.clip_norm)
        for g in gs:
            g.mul_(scale)
    count = state.count + 1
    lr = warmup_cosine(cfg, count)
    c = count.float()
    bc1 = 1 - torch.pow(_scalar(cfg.b1, c.device), c)
    bc2 = 1 - torch.pow(_scalar(cfg.b2, c.device), c)
    for p, m, v, g in zip(tree.leaves(params), tree.leaves(state.mu),
                          tree.leaves(state.nu), gs, strict=True):
        p, m, v = block_data(p), block_data(m), block_data(v)
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        step = (m / bc1) / (_sqrt(v / bc2) + cfg.eps)
        p.copy_(p - lr * (step + cfg.weight_decay * p))
    state.count = count
    return params, state, {"grad_norm": gnorm, "lr": lr}


def sgd_update(lr: float, grads: PyTree, params: PyTree) -> PyTree:
    """p <- p - lr * g, in place; returns params."""
    for p, g in zip(tree.leaves(params), tree.leaves(grads), strict=True):
        p.copy_(p - lr * g)
    return params
