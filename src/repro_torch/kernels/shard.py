"""Decode attention over a capacity-sharded KV cache, on one card.

Port of the decode half of ``repro.kernels.shard`` (``shard.py:261-338``:
``kv_shard_axes`` and ``decode_attend_sharded``).  In the reference the
capacity axis of every KV cache is sharded over the mesh's ``model`` axis
(``m = mesh.shape["model"]``) and each device runs ``flash_decode_partial``
on its shard before one pmax and one psum combine the shards.  Here the
``m`` shards are a grid axis of one ``flash_decode_partial`` launch and the
combine is a kernel of its own (``kernels/flash_decode.py``); the
arithmetic is the reference's.

Two differences, both deliberate: the reference takes the sharded branch
only for B > 1 (its cache layout on the mesh); one card has no such
layout, so B = 1 shards too.  And where the reference replicates a cache
whose capacity ``m`` does not divide, the port raises
(:func:`check_kv_shards`): ``kv_shards`` asks for this path, and it never
falls back quietly to the replicated one.

Collective accounting follows the reference's: each capacity-sharded
attention counts ``dist.psum`` 2 (the combine's max and sum over the
shards: the reference's exact-mimic branch, 1 pmax + psums, counts 2) and
``dist.psum_bytes`` its per-device payload at ``site="attn_kv"``.  The
reference counts at trace time, once per scanned call site of a compiled
trace; the port counts once per traced call of an engine surface (a CUDA
graph capture, or an eager call whose signature the surface has not seen:
:func:`surface_call`), at each (stage, pattern position) of the layer
stack (:func:`trace_sites`).  A call outside any engine surface is the
reference's eager call: it counts every time and observes
``dist.collective_ms``.

The K-sharded projection wrappers and the multi-card form (ranks, NCCL)
wait for the tensor-parallel slice (ROADMAP A13), which reuses these
kernels.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

from repro_torch import obs
from repro_torch.kernels import observe
from repro_torch.kernels.flash_decode import (combine_partials,
                                              flash_decode_partial)
from repro_torch.kernels.ref import NEG_INF

_tls = threading.local()


class _Trace:
    """One traced call of an engine surface: the call sites whose
    collectives it has counted, the site the layer loop is at and the
    layer of its stage (None outside the layer loops)."""

    __slots__ = ("seen", "at", "layer")

    def __init__(self):
        self.seen: set = set()
        self.at = None
        self.layer = None


_QUIET = object()    # a surface call that is not its surface's trace


@contextlib.contextmanager
def surface_call(traced: bool):
    """Around one call of an engine surface (``EngineFns._call``):
    ``traced`` says it is the surface's trace, the call whose collectives
    the reference's trace-time counters count; any other call counts
    nothing and times nothing."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = _Trace() if traced else _QUIET
    try:
        yield
    finally:
        _tls.trace = prev


def trace_sites():
    """The active trace, for the layer loop to mark its call site
    (:func:`mark_site`), or None."""
    tr = getattr(_tls, "trace", None)
    return tr if isinstance(tr, _Trace) else None


def mark_site(trace, at, layer=None) -> None:
    """Mark where the layer loop is: ``at`` the call site ((stage, pattern
    position), or None outside the loops), ``layer`` the layer of its
    stage.  A scanned layer body is traced once, so a trace-time count
    counts a site once (``dist.psum``) and ``analysis.audit`` counts a
    kernel call per site at a stage's first layer."""
    if trace is not None:
        trace.at, trace.layer = at, layer


def _count(site: str, payload_bytes: int, n_psum: int = 1) -> bool:
    """Collective accounting (``shard.py:90-95`` of the reference); returns
    whether the call is eager (outside any engine surface)."""
    tr = getattr(_tls, "trace", None)
    if tr is _QUIET:
        return False
    if tr is not None:
        if tr.at in tr.seen:
            return False
        tr.seen.add(tr.at)
    ob = observe.observer()
    if ob is not None:
        ob.collective("psum", site, n_psum)
    obs.inc("dist.psum", n_psum, site=site)
    obs.inc("dist.psum_bytes", payload_bytes, site=site)
    return tr is None


def check_kv_shards(kv_shards, cache_lengths, kinds=()) -> None:
    """Raise ``ValueError`` unless ``kv_shards`` is None or an integer
    >= 1 that divides every cache length (a layer's ring: the capacity, or
    min(capacity, window) for a sliding-window layer), and there is one
    (an xlstm model has no ring).  Any set value
    raises for a model with MLA layers (``kinds``: its layer kinds): the
    reference's MLA decode is plain ``jnp`` with no decode-attention
    kernel (``attention.py:557-622``), so ``kv_shards`` would silently
    change nothing there."""
    if kv_shards is None:
        return
    mla = sorted({k for k in kinds if k.startswith("mla")})
    if mla:
        raise ValueError(f"kv_shards={kv_shards!r}: MLA layers ({mla}) have "
                         "no decode-attention kernel path; serve them with "
                         "kv_shards=None")
    if isinstance(kv_shards, bool) or not isinstance(kv_shards, int) \
            or kv_shards < 1:
        raise ValueError(f"kv_shards must be None or an integer >= 1, got "
                         f"{kv_shards!r}")
    if not cache_lengths:
        raise ValueError(f"kv_shards={kv_shards!r}: the model has no "
                         "attention layer (no KV ring) for a decode-"
                         "attention path to run on; serve it with "
                         "kv_shards=None")
    bad = sorted(c for c in set(cache_lengths) if c % kv_shards)
    if bad:
        raise ValueError(f"kv_shards={kv_shards} does not divide the KV "
                         f"cache length(s) {bad}: the capacity shards must "
                         "be equal")


def decode_attend_sharded(qg: torch.Tensor, cache_k: torch.Tensor,
                          cache_v: torch.Tensor, ok: torch.Tensor, *,
                          shards: int, scale: float) -> torch.Tensor:
    """Partial-softmax decode attention over ``shards`` capacity shards.

    qg (B,K,G,D); cache_k/v (B,C,K,D); ok (B,C) valid-slot mask (position
    and window, built by the caller as the replicated path builds it).
    The bias is ``where(ok, 0, -1e30)`` in f32 (``shard.py:324``); each
    shard's (acc, m, l) comes from :func:`flash_decode_partial` (which
    raises unless ``shards`` divides C), and
    :func:`combine_partials` takes the max over shards, rescales, sums in
    shard order and normalises: (B,K,G,Dv) in qg's dtype.
    """
    B, Kh, G, _ = qg.shape
    eager = _count("attn_kv", B * Kh * G * (1 + cache_v.shape[-1]) * 4,
                   n_psum=2)
    # no clock and no metric inside a CUDA graph capture
    timed = eager and obs.enabled() and not (
        qg.is_cuda and torch.cuda.is_current_stream_capturing())
    t0 = time.perf_counter() if timed else None
    bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    acc, m, l = flash_decode_partial(qg, cache_k, cache_v, bias,
                                     scale=scale, shards=shards)
    out = combine_partials(acc, m, l, qg.dtype)
    if timed:
        obs.core.block_until_ready(out)
        obs.observe("dist.collective_ms", (time.perf_counter() - t0) * 1e3,
                    site="attn_kv")
    return out
