"""Activation-statistics tape.  Port of ``repro.core.tape`` (the
:class:`JitTape` semantics; the eager f64 ``StatsTape`` oracle is not
ported).

UniPruning's local metrics S(W, X) need, per prunable projection, the L2
norm of each *input feature* over the calibration set (Wanda's ||X_j||_2).
While a tape is installed (:func:`recording`), ``models.common.dense``
hands it every kernel and its input; the tape keeps, for each registered
kernel, the f32 sum of squares of the input over every axis but the
feature axis.  ``models.model.stats_sumsq`` registers each layer's sliced
params under (path, layer index) and stacks the per-layer sums back along
the layer axis.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

from repro_torch import tree

_local = threading.local()


class JitTape:
    def __init__(self):
        # id(kernel) -> (pathstr, layer_idx)
        self.registry: dict[int, tuple[str, int]] = {}
        # (pathstr, layer_idx) -> f32 sum of squares, shape kernel.shape[:-1]
        self.out: dict[tuple[str, int], torch.Tensor] = {}

    def register_layer(self, t: Any, prefix: str, layer_idx: int) -> None:
        for path, leaf in tree.flatten_with_path(t):
            if isinstance(leaf, torch.Tensor):
                self.registry[id(leaf)] = (prefix + path, layer_idx)

    def record(self, kernel: torch.Tensor, x: torch.Tensor) -> None:
        key = self.registry.get(id(kernel))
        if key is None:
            return
        nlead = kernel.dim() - 2
        axes = tuple(range(nlead, x.dim() - 1))
        ss = torch.square(x.float()).sum(dim=axes)
        prev = self.out.get(key)
        self.out[key] = ss if prev is None else prev + ss

    def stats(self, layer_idx: int) -> dict[str, torch.Tensor]:
        """{pathstr: sumsq} for keys registered under ``layer_idx``."""
        return {p: v for (p, li), v in self.out.items() if li == layer_idx}


def current_tape() -> JitTape | None:
    return getattr(_local, "tape", None)


@contextlib.contextmanager
def recording(tape: JitTape):
    prev = current_tape()
    _local.tape = tape
    try:
        yield tape
    finally:
        _local.tape = prev
