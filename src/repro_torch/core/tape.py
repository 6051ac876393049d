"""Activation-statistics tapes.  Port of ``repro.core.tape``.

UniPruning's local metrics S(W, X) need, per prunable projection, the L2
norm of each *input feature* over the calibration set (Wanda's ||X_j||_2).
While a tape is installed (:func:`recording`), ``models.common.dense``
hands it every kernel and its input, and ``models.moe.moe_apply`` hands it
the expert banks with their dispatch buffers; the tape keeps, for each
registered kernel, the f32 sum of squares of the input over every axis but
the leading (layer, expert) and feature axes.  Under rules a kernel is
this rank's ``DenseBlock`` and its input is whole (activations are
replicated), so each kernel's sums are the whole leaf's on every rank
(``core.calibrate.collect_stats`` then keeps the rank's block).

Two tapes, as in the reference:

* :class:`JitTape` - the production pass (``models.model.stats_sumsq``,
  ``core.calibrate.collect_stats(impl="jit")``): the sums stay f32 device
  tensors, and the model stacks each layer's back along the layer axis.
* :class:`StatsTape` - the eager oracle (``collect_stats(impl="tape")``):
  ``models.model.forward(..., unroll=True)`` registers each layer's sliced
  params under (path, layer index), and the tape accumulates f64 sums on
  the host; :func:`resolve_stats` re-stacks the layers.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import numpy as np
import torch

from repro_torch import tree

_local = threading.local()


def _sumsq(kernel, x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of x over every axis but the kernel's leading
    (expert) axes and the feature axis."""
    nlead = len(kernel.shape) - 2
    axes = tuple(range(nlead, x.dim() - 1))
    return torch.square(x.float()).sum(dim=axes)


def _lead(scale, ndim: int):
    """A per-leading-entry scale broadcast over the stat's trailing dims."""
    return scale.reshape(tuple(scale.shape) + (1,) * (ndim - scale.ndim))


class StatsTape:
    """The eager oracle: f64 host sums keyed by (path, layer index)."""

    def __init__(self):
        # id(kernel) -> (pathstr, layer_idx)
        self.registry: dict[int, tuple[str, int]] = {}
        # (pathstr, layer_idx) -> f64 sum of squares, shape kernel.shape[:-1]
        self.sumsq: dict[tuple[str, int], np.ndarray] = {}

    def register_layer(self, t: Any, prefix: str, layer_idx: int) -> None:
        from repro_torch.dist.sharding import DenseBlock
        for path, leaf in tree.flatten_with_path(t):
            if isinstance(leaf, (torch.Tensor, DenseBlock)):
                self.registry[id(leaf)] = (prefix + path, layer_idx)

    def record(self, kernel: torch.Tensor, x: torch.Tensor, *, count=None,
               ref_count=None) -> None:
        """Accumulate stats with shape kernel.shape[:-1].

        count / ref_count: the rows that really contributed, per leading
        (expert) entry, and the token count of the pass.  MoE dispatch
        buffers are capacity-padded with zero rows, so the caller passes
        the per-expert routed-row counts and the batch's token count T, and
        the sum of squares is rescaled by ref_count / max(count, 1): the
        resolved norm then reads as the RMS over the routed rows scaled to
        the T tokens a dense FFN sees.  Experts that got no rows stay 0.
        """
        key = self.registry.get(id(kernel))
        if key is None:
            return
        # f32 sums on the device, as the reference's, then f64 on the host
        ss = _sumsq(kernel, x).detach().cpu().numpy().astype(np.float64)
        if count is not None:
            c = torch.as_tensor(count).detach().cpu().numpy().astype(
                np.float64)
            ss = ss * _lead(float(ref_count) / np.maximum(c, 1.0), ss.ndim)
        prev = self.sumsq.get(key)
        self.sumsq[key] = ss if prev is None else prev + ss


class JitTape(StatsTape):
    """The production pass's tape: f32 device sums, returned per layer."""

    def __init__(self):
        super().__init__()
        self.out: dict[tuple[str, int], torch.Tensor] = {}

    def record(self, kernel: torch.Tensor, x: torch.Tensor, *, count=None,
               ref_count=None) -> None:
        key = self.registry.get(id(kernel))
        if key is None:
            return
        ss = _sumsq(kernel, x)
        if count is not None:
            c = torch.as_tensor(count, device=ss.device).float()
            ref = torch.full((), float(ref_count), dtype=torch.float32,
                             device=ss.device)
            ss = ss * _lead(ref / torch.clamp_min(c, 1.0), ss.dim())
        prev = self.out.get(key)
        self.out[key] = ss if prev is None else prev + ss

    def stats(self, layer_idx: int) -> dict[str, torch.Tensor]:
        """{pathstr: sumsq} for keys registered under ``layer_idx``."""
        return {p: v for (p, li), v in self.out.items() if li == layer_idx}


def current_tape() -> StatsTape | None:
    return getattr(_local, "tape", None)


@contextlib.contextmanager
def recording(tape: StatsTape):
    prev = current_tape()
    _local.tape = tape
    try:
        yield tape
    finally:
        _local.tape = prev


def resolve_stats(tape: StatsTape, params: Any) -> Any:
    """A stats tree matching ``params``: for every kernel the tape saw, the
    per-input-feature norm sqrt(sum of squares) over the calibration set,
    shape kernel.shape[:-1], f32 on the params' device; stacked leaves get
    their layer axis back.  Leaves the tape never saw give None."""
    by_path: dict[str, dict[int, np.ndarray]] = {}
    for (path, layer_idx), ss in tape.sumsq.items():
        by_path.setdefault(path, {})[layer_idx] = ss
    dev = tree.device_of(params)

    def leaf(path: str, _):
        rec = by_path.get(path)
        if rec is None:
            return None
        idxs = sorted(rec)
        arrs = [np.sqrt(rec[i]) for i in idxs]
        a = arrs[0] if idxs == [-1] else np.stack(arrs, axis=0)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return tree.map_with_path(leaf, params)
