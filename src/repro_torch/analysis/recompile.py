"""Recompile sentinel: catch silent growth of the compiled-entry caches on
the serving and calibration hot paths.  Port of
``repro.analysis.recompile``.

The reference's jax.jit retraces whenever the abstract signature of a call
changes - a new shape, a flipped dtype, a different tree structure, or an
unhashed static argument - and each retrace is a multi-second stall.  The
port's counterparts are a new CUDA graph capture of a surface and, on the
eager paths, a call whose signature the surface has not seen.

``note(surface, args)`` hashes the *abstract* signature (tree structure +
per-tensor (shape, dtype), repr for every other leaf) of each dispatch and
keeps the set of distinct signatures per surface.  Crossing the surface's
budget raises ``RecompileBudgetError`` with both the budget and the newest
signature, and every new signature updates the ``analysis.recompiles`` obs
gauge (labelled by surface) so the flight recorder shows cache growth next
to latency.

Disabled by default: ``note`` is a single bool check on the hot path.
Enable around tests/benches with::

    from repro_torch.analysis import recompile
    recompile.enable(budgets={"decode": 1}, default_budget=4)
    ... run ...
    assert recompile.counts()["decode"] == 1
    recompile.disable()

Instrumented surfaces: ServeEngine decode / prefill_<bucket> / write_slot
(serve/engine.py), the speculative draft_<k> / verify_<k> (serve/spec.py)
and the calibration search_chunk / search_step (core/calibrate.py).
"""
from __future__ import annotations

import contextlib

import dataclasses
import threading
from typing import Any, Hashable

from repro_torch import obs

__all__ = ["enable", "disable", "enabled", "reset", "note", "counts",
           "signature", "RecompileBudgetError"]


class RecompileBudgetError(RuntimeError):
    """A surface exceeded its budget of distinct compile signatures."""


_lock = threading.Lock()
_enabled = False
_default_budget = 4
_budgets: dict[str, int] = {}
_seen: dict[str, dict[Hashable, int]] = {}  # surface -> {sig: first_seen_idx}


def enabled() -> bool:
    return _enabled


def enable(budgets: dict[str, int] | None = None, *,
           default_budget: int = 4) -> None:
    """Arm the sentinel. ``budgets`` maps surface name -> max distinct
    signatures; unlisted surfaces get ``default_budget``."""
    global _enabled, _default_budget
    with _lock:
        _budgets.clear()
        _budgets.update(budgets or {})
        _default_budget = int(default_budget)
        _seen.clear()
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextlib.contextmanager
def paused():
    """The sentinel off for the block, its budgets and signatures kept (a
    rank other than 0 of a launcher over ranks)."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev


def reset() -> None:
    """Forget all recorded signatures (budgets stay armed)."""
    with _lock:
        _seen.clear()


def counts() -> dict[str, int]:
    """Distinct signatures seen per surface since enable()/reset()."""
    with _lock:
        return {k: len(v) for k, v in _seen.items()}


def _flatten(x: Any, path: str, out: list, data: bool = False) -> None:
    """(path, leaf signature) pairs of a nested dict / list / tuple /
    dataclass tree.  The path names each container's kind and key, so two
    trees share a signature only if their structures are equal; an empty
    container is a marker of its own.  ``data``: inside a dataclass
    (``SearchState``), whose Python scalars (step, key words) the
    reference's registered dataclass holds as arrays: signed by type, not
    by value."""
    if isinstance(x, dict):
        if not x:
            out.append((path, "{}"))
        for k in sorted(x):
            _flatten(x[k], f"{path}[{k!r}]", out, data)
    elif isinstance(x, (list, tuple)):
        if not x:
            out.append((path, "()" if isinstance(x, tuple) else "[]"))
        fmt = "({})" if isinstance(x, tuple) else "[{}]"
        for i, v in enumerate(x):
            _flatten(v, path + fmt.format(i), out, data)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _flatten(getattr(x, f.name), f"{path}.{f.name}", out, True)
    elif data and isinstance(x, (bool, int, float)):
        out.append((path, ((), type(x).__name__)))
    elif hasattr(x, "vals") and hasattr(x, "idx"):   # SparseTensor
        out.append((path, ("sparse", getattr(x, "idx_bits", None),
                           tuple(x.vals.shape), str(x.vals.dtype),
                           tuple(x.idx.shape), str(x.idx.dtype))))
    elif hasattr(x, "shape") and hasattr(x, "dtype"):
        out.append((path, (tuple(x.shape), str(x.dtype))))
    else:
        out.append((path, ("static", repr(x))))


def signature(args: Any) -> Hashable:
    """Abstract signature of a call: the tree structure + (shape, dtype) per
    tensor or array leaf, ``repr`` for everything else (what the
    reference's jit keys its cache on, closely enough to count retraces)."""
    out: list = []
    _flatten(args, "", out)
    return (tuple(p for p, _ in out), tuple(s for _, s in out))


def note(surface: str, args: Any) -> bool:
    """Record one dispatch. Returns True iff the signature is new for this
    surface. Raises RecompileBudgetError past the surface's budget."""
    if not _enabled:
        return False
    sig = signature(args)
    with _lock:
        surf = _seen.setdefault(surface, {})
        if sig in surf:
            return False
        surf[sig] = len(surf)
        n = len(surf)
        budget = _budgets.get(surface, _default_budget)
    obs.set_gauge("analysis.recompiles", float(n), surface=surface)
    if n > budget:
        raise RecompileBudgetError(
            f"surface {surface!r} reached {n} distinct compile signatures "
            f"(budget {budget}); newest: {sig[1]!r}")
    return True
