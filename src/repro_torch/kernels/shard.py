"""Tensor-parallel execution over the ranks of a mesh, and decode attention
over a capacity-sharded KV cache on one card.  Port of
``repro.kernels.shard``.

**Across ranks** (rules installed, ``dist.axes.use_rules``; one process a
rank, ``launch.mesh.Mesh``).  Activations are replicated on every rank and
each rank stores only its block of every weight (``dist.sharding.
place_params``).  A compressed leaf whose tag shards its contraction dim
K (``SparseTensor.shard``, ``dist.sharding.tag_compressed``) runs through
:func:`nm_dense_sharded` / :func:`nm_dense2_sharded` /
:func:`nm_moe_sharded` / :func:`nm_moe2_sharded`: each slices x's K to the
rank's block, runs the ported kernel on its local (K_loc/2, N_loc) vals
and index plane into a *float32 partial*, and makes ONE all-reduce over
the K axes' process group per projection group - the gated MLP's up/gate
pair and the MoE up/gate banks put both partials in one flat buffer, the
reference's variadic psum - then one cast back to the activation dtype,
then an all-gather over the N (and expert) axes where those are sharded
too.  A leaf sharded along N or E only (untagged: K whole) computes its
local columns and gathers them (:func:`nm_gathered`); a dense leaf held as
a block (``dist.sharding.DenseBlock``) sums its K-partials or gathers its
columns (:func:`dense_sharded`) or is gathered whole where it is used
(:func:`gathered`).  Those gathers and sums are what GSPMD inserts in the
reference: they count nothing.

:func:`decode_attend_sharded` with ``axes``: the cache's capacity is
sharded over "model" (``kv_shard_axes``).  On the CPU it is the
reference's interpret-mode exact mimic (``shard.py:297-312``): local
scores, an all-reduce MAX, exp, an all-reduce SUM of l, ``(p / l)`` cast
to the cache dtype, an f32 PV partial, an all-reduce SUM.  On the card
each rank runs ``flash_decode_partial`` on its shard, then an all-reduce
MAX of m and one all-reduce SUM of ``(l corr, acc corr)``; the combine
kernel normalises (its one shard carries the global max, so its rescale
is exp(0) = 1).  Each counts ``dist.psum`` 2, as the reference's (R17).

**On one card** (``kv_shards``, no rules).  The decode half of the
reference on a mesh whose ``model`` axis has ``m = kv_shards`` devices:
the ``m`` shards are a grid axis of one ``flash_decode_partial`` launch
and the combine is a kernel of its own.  Two differences, both
deliberate: the reference takes the sharded branch only for B > 1 (its
cache layout on the mesh); one card has no such layout, so B = 1 shards
too.  And where the reference replicates a cache whose capacity ``m``
does not divide, the port raises (:func:`check_kv_shards`): ``kv_shards``
asks for this path, and it never falls back quietly to the replicated
one.  ``kv_shards`` and rules together raise (``serve.engine``).

Collective accounting follows the reference's (``_count``: sites mlp /
attn / moe / attn_kv, ``dist.psum`` and ``dist.psum_bytes`` with its
payload formulas).  The reference counts at trace time, once per traced
call of each wrapper in a scanned layer body; the port counts once per
traced call of an engine surface (a CUDA graph capture, or an eager call
whose signature the surface has not seen: :func:`surface_call`), at each
(stage, pattern position) of the layer stack (:func:`mark_site`) and each
collective's place in it.  A call outside any engine surface is the
reference's eager call: it counts every time and observes
``dist.collective_ms``.

**The calibration under rules** (``core.calibrate``, ``core.mirror``)
runs the model with each dense block gathered whole where it is used
(:func:`whole_weights`), so every rank computes one process's activations
and task gradient bit for bit, and keeps its block of the gradient
(:func:`gather_ranks`); RIA's row and column sums over a block's ranks are
differentiable sums of per-rank terms (:func:`sum_terms`).

``REPRO_FORCE_REPLICATED=1`` disables every K-sharded path (tags are not
stamped, caches stay whole) - the escape hatch when a mesh or collective
bug needs bisecting.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

from repro_torch import obs
from repro_torch.dist.axes import current_rules
from repro_torch.kernels import observe
from repro_torch.kernels.flash_decode import (combine_partials,
                                              flash_decode_partial)
from repro_torch.kernels.nm_spmm import (LAYOUT_PACKED2, infer_layout,
                                         nm_matmul, nm_matmul_expert)
from repro_torch.kernels.ref import NEG_INF

_tls = threading.local()
FORCE_REPLICATED_ENV = "REPRO_FORCE_REPLICATED"


def replicated_forced() -> bool:
    """Env escape hatch: force the replicated fallback everywhere."""
    return os.environ.get(FORCE_REPLICATED_ENV, "") not in ("", "0")


def _ax_tuple(entry) -> tuple[str, ...]:
    """Spec entry (None | name | tuple of names) -> tuple of mesh axes."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, entry) -> int:
    n = 1
    for a in _ax_tuple(entry):
        n *= mesh.shape[a]
    return n


def k_sharded(st) -> bool:
    """Does this leaf's tag route through the K-sharded wrappers here?
    True when the leaf carries a non-None K entry AND rules are
    installed."""
    if replicated_forced():
        return False
    if getattr(st, "shard", None) is None or st.k_shard is None:
        return False
    return current_rules() is not None


def pair_k_sharded(st_a, st_b) -> bool:
    """Can a gate/up pair share one deferred all-reduce? (same K axes)"""
    return (k_sharded(st_a) and k_sharded(st_b)
            and st_a.shard[-2] == st_b.shard[-2]
            and st_a.vals.shape[-2] == st_b.vals.shape[-2])


class _Trace:
    """One traced call of an engine surface: the collectives it has
    counted, keyed by (site, place in the site), the site the layer loop
    is at, the layer of its stage (None outside the layer loops) and the
    collectives counted at the current visit of the site."""

    __slots__ = ("seen", "at", "layer", "n")

    def __init__(self):
        self.seen: set = set()
        self.at = None
        self.layer = None
        self.n = 0


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
    counts each collective of a site once (``dist.psum``) and
    ``analysis.audit`` counts a kernel call per site at a stage's first
    layer."""
    if trace is not None:
        trace.at, trace.layer, trace.n = at, layer, 0


def _count(site: str, payload_bytes: int, n_psum: int = 1) -> bool:
    """Collective accounting (``shard.py:90-95`` of the reference); returns
    whether the call is eager (outside any engine surface)."""
    tr = getattr(_tls, "trace", None)
    if tr is _QUIET:
        return False
    if tr is not None:
        key = (tr.at, tr.n)
        tr.n += 1
        if key in tr.seen:
            return False
        tr.seen.add(key)
    ob = observe.observer()
    if ob is not None:
        ob.collective("psum", site, n_psum)
    obs.inc("dist.psum", n_psum, site=site)
    obs.inc("dist.psum_bytes", payload_bytes, site=site)
    return tr is None


def _timed(site: str, eager: bool, fn, *args):
    """``fn(*args)``, observed as ``dist.collective_ms`` on an eager call
    (no clock inside a CUDA graph capture)."""
    if not (eager and obs.enabled()) or (
            args[0].is_cuda and torch.cuda.is_current_stream_capturing()):
        return fn(*args)
    t0 = time.perf_counter()
    out = fn(*args)
    obs.core.block_until_ready(out)
    obs.observe("dist.collective_ms", (time.perf_counter() - t0) * 1e3,
                site=site)
    return out


# ---------------------------------------------------------------------------
# Across ranks: the K-sharded projections
# ---------------------------------------------------------------------------

def _mesh():
    rules = current_rules()
    if rules is None:
        raise RuntimeError("a sharded leaf runs under installed rules "
                           "(dist.axes.use_rules)")
    return rules.mesh


def _block(x: torch.Tensor, entry, mesh, dim: int) -> torch.Tensor:
    """This rank's block of a replicated activation along ``dim``."""
    n = axes_size(mesh, entry)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(entry) * size, size).contiguous()


# ---------------------------------------------------------------------------
# Across ranks, under autograd (the calibration search)
# ---------------------------------------------------------------------------
#
# The search differentiates two kinds of loss through cross-rank
# collectives, and they need different backwards:
#
# * the task loss is replicated: every rank computes the same ``lm_loss``
#   from replicated activations, through each kernel gathered whole
#   (:func:`whole_weights`), so every rank holds the whole gradient of a
#   gathered tensor and keeps its block of it (:class:`_Gather`);
# * the alignment term is a sum of per-rank terms (each rank's block of
#   0.5 rho ||Gamma - S||^2), and RIA's row and column sums are sums over
#   ranks: the gradient of such a sum is the sum of the ranks' gradients,
#   an all-reduce (:class:`_Sum`).
#
# Either wrong backward still runs, with other gradients.

def grad_on(*ts: torch.Tensor) -> bool:
    """Does autograd record a graph through ``ts`` here?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Sum(torch.autograd.Function):
    """All-reduce SUM over ``entry`` of per-rank terms of a loss that is
    the sum of the ranks' losses; backward an all-reduce SUM of the
    gradients."""

    @staticmethod
    def forward(ctx, t, mesh, entry):
        ctx.mesh, ctx.entry = mesh, entry
        return mesh.all_reduce(t.clone(), entry)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.entry), None, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``entry`` under a replicated loss;
    backward this rank's block of the (whole, replicated) gradient."""

    @staticmethod
    def forward(ctx, t, mesh, entry, dim):
        ctx.mesh, ctx.entry, ctx.dim = mesh, entry, dim
        return mesh.all_gather(t, entry, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.entry, ctx.mesh, ctx.dim), None, None, None


def sum_terms(t: torch.Tensor, mesh, entry) -> torch.Tensor:
    """``t`` summed over the ranks along ``entry`` (every rank the same
    bits), each rank's ``t`` a term of a loss summed over the ranks
    (:class:`_Sum` under autograd; outside it the all-reduce runs in
    place)."""
    if axes_size(mesh, entry) == 1:
        return t
    if grad_on(t):
        return _Sum.apply(t, mesh, entry)
    return mesh.all_reduce(t, entry)


def gather_ranks(t: torch.Tensor, mesh, entry, dim: int) -> torch.Tensor:
    """The ranks' blocks along ``entry`` concatenated along ``dim``,
    differentiable under autograd (a replicated loss: :class:`_Gather`)."""
    if axes_size(mesh, entry) == 1:
        return t
    if grad_on(t):
        return _Gather.apply(t, mesh, entry, dim)
    return mesh.all_gather(t, entry, dim)


@contextlib.contextmanager
def whole_weights():
    """While open, a dense leaf held as a block (``DenseBlock``) is
    gathered whole where the model uses it (:func:`gathered`, its bf16
    cast: the bits the model computes with) and used as one process uses
    it, so every rank computes the single process's
    activations and gradients bit for bit (the calibration's stats pass
    and search, ``core.calibrate``); outside, the serving path's K-partial
    sums and column gathers run (:func:`dense_sharded`)."""
    prev = getattr(_tls, "whole", False)
    _tls.whole = True
    try:
        yield
    finally:
        _tls.whole = prev


def weights_whole() -> bool:
    """Is :func:`whole_weights` open?"""
    return getattr(_tls, "whole", False)


def _plane(st) -> torch.Tensor:
    """The index plane as the kernel streams it."""
    return st.idx if st.kernel_layout == LAYOUT_PACKED2 \
        else st.unpacked_idx()


def _local_nm(x, vals, idx, expert: bool = False,
              out_dtype=torch.float32):
    """One rank's kernel call on shard-local operands -> an f32 partial
    (the layout from the local shapes: the vals / idx row ratio does not
    change under K sharding, ``nm_spmm.infer_layout``)."""
    layout = infer_layout(2 * vals.shape[-2], tuple(idx.shape))
    kernel = nm_matmul_expert if expert else nm_matmul
    return kernel(x, vals, idx, layout=layout, out_dtype=out_dtype)


def _sum_flat(parts: list[torch.Tensor], entry, mesh) -> list[torch.Tensor]:
    """One all-reduce SUM of several f32 partials through one flat buffer
    (the reference's variadic psum)."""
    if len(parts) == 1:
        return [mesh.all_reduce(parts[0], entry)]
    buf = mesh.all_reduce(torch.cat([p.reshape(-1) for p in parts]), entry)
    out, i = [], 0
    for p in parts:
        out.append(buf[i:i + p.numel()].view(p.shape))
        i += p.numel()
    return out


def nm_dense_sharded(st, x2: torch.Tensor, *, site: str) -> torch.Tensor:
    """x2 (M, K) @ a K-sharded compressed (K, N) leaf, given as this rank's
    block -> (M, N); one all-reduce."""
    return nm_dense2_sharded(st, None, x2, site=site)[0]


def nm_dense2_sharded(st_a, st_b, x2: torch.Tensor, *, site: str):
    """A pair sharing K (the gated MLP's up + gate; ``st_b`` None: one
    leaf): two local kernels, ONE all-reduce over the pair."""
    mesh = _mesh()
    sts = [st for st in (st_a, st_b) if st is not None]
    k_e = st_a.shard[-2]
    out_dt = x2.dtype
    M = x2.shape[0]
    eager = _count(site, sum(M * st.vals.shape[-1] for st in sts) * 4)

    def run(x2):
        xl = _block(x2, k_e, mesh, -1)
        with observe.kernel_pair() if len(sts) == 2 \
                else contextlib.nullcontext():
            ys = [_local_nm(xl, st.vals.to(out_dt), _plane(st))
                  for st in sts]
        ys = _sum_flat(ys, k_e, mesh)
        return [mesh.all_gather(y.to(out_dt), st.shard[-1], -1)
                for y, st in zip(ys, sts)]

    return _timed(site, eager, run, x2)


def nm_moe_sharded(st, x3: torch.Tensor, *, site: str = "moe"
                   ) -> torch.Tensor:
    """x3 (E, M, K) @ a K-sharded expert bank (E, K, N), given as this
    rank's block -> (E, M, N): one ``nm_matmul_expert`` call for every
    local expert and one all-reduce for the whole bank."""
    return nm_moe2_sharded(st, None, x3, site=site)[0]


def nm_moe2_sharded(st_up, st_gate, x3: torch.Tensor, *, site: str = "moe"):
    """The up + gate expert banks (``st_gate`` None: one bank): two local
    expert-grid kernels, one all-reduce across the pair and the grid."""
    mesh = _mesh()
    sts = [st for st in (st_up, st_gate) if st is not None]
    e_e, k_e = st_up.shard[-3], st_up.shard[-2]
    out_dt = x3.dtype
    M = x3.shape[1]
    eager = _count(site, sum(st.vals.shape[0] * M * st.vals.shape[-1]
                             for st in sts) * 4)

    def run(x3):
        xl = _block(_block(x3, e_e, mesh, 0), k_e, mesh, -1)
        with observe.kernel_pair() if len(sts) == 2 \
                else contextlib.nullcontext():
            ys = [_local_nm(xl, st.vals.to(out_dt), _plane(st), expert=True)
                  for st in sts]
        ys = _sum_flat(ys, k_e, mesh)
        return [mesh.all_gather(mesh.all_gather(y.to(out_dt), st.shard[-1],
                                                -1), e_e, 0)
                for y, st in zip(ys, sts)]

    return _timed(site, eager, run, x3)


def nm_gathered(st, x: torch.Tensor, *, expert: bool = False
                ) -> torch.Tensor:
    """x (M, K) or (E, M, K) @ a compressed leaf whose block splits N (or
    the experts) but not K (untagged): the local columns through the
    kernel, then gathered; counts nothing (GSPMD's gather in the
    reference)."""
    mesh = _mesh()
    e_e = st.block[0] if expert else None
    n_e = st.block[-1]
    y = _local_nm(_block(x, e_e, mesh, 0), st.vals.to(x.dtype), _plane(st),
                  expert=expert, out_dtype=x.dtype)
    return mesh.all_gather(mesh.all_gather(y, n_e, -1), e_e, 0)


def dense_sharded(w, x: torch.Tensor, *, expert: bool = False
                  ) -> torch.Tensor:
    """x (..., K) @ a dense kernel held as a block (``DenseBlock``; an
    expert bank (E, K, N) against x (E, M, K) with ``expert``) -> the
    result in x's and the kernel's promoted dtype: a K-split block sums f32
    partials over its K axes, then the result is gathered over the N (and
    expert) axes."""
    mesh = _mesh()
    e_e = w.spec[0] if expert else None
    k_e, n_e = w.spec[-2], w.spec[-1]
    dtype = torch.promote_types(x.dtype, w.dtype)
    x = _block(_block(x, e_e, mesh, 0), k_e, mesh, -1)
    if axes_size(mesh, k_e) > 1:
        y = mesh.all_reduce(x.float() @ w.data.float(), k_e).to(dtype)
    else:
        y = x.to(dtype) @ w.data.to(dtype)
    return mesh.all_gather(mesh.all_gather(y, n_e, -1), e_e, 0)


def lookup_sharded(w, ids: torch.Tensor, dtype: torch.dtype
                   ) -> torch.Tensor:
    """Rows ``ids`` of a (vocab, d) table held as a block (``DenseBlock``),
    in ``dtype``: each rank looks up the ids in its vocab block (zero rows
    for the others), a sum over the vocab axes (exact: one term is not
    zero), then a gather over the d axes."""
    mesh = _mesh()
    v_e, d_e = w.spec
    rows = w.data.shape[0]
    local = ids - (mesh.index(v_e) * rows if axes_size(mesh, v_e) > 1
                   else 0)
    mine = (local >= 0) & (local < rows)
    out = torch.where(mine[..., None], w.data[local.clamp(0, rows - 1)]
                      .to(dtype), 0)
    if axes_size(mesh, v_e) > 1:
        out = mesh.all_reduce(out.float(), v_e).to(dtype)
    return mesh.all_gather(out, d_e, -1)


def gathered(w) -> torch.Tensor:
    """The whole leaf of a ``DenseBlock``: its blocks gathered along every
    sharded dim (a small leaf used whole: the MoE router; every leaf under
    :func:`whole_weights`); differentiable, each rank's gradient its
    block's."""
    mesh = _mesh()
    t = w.data
    for dim, e in enumerate(w.spec):
        t = gather_ranks(t, mesh, e, dim)
    return t


# ---------------------------------------------------------------------------
# Decode attention over a capacity-sharded KV cache
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def serving_capacity(capacity: int):
    """The engine's cache capacity for the duration of the block: under
    rules a decode step needs it to place a capacity-sharded ring's block
    in the whole ring (:func:`ring_layout`)."""
    prev = getattr(_tls, "capacity", None)
    _tls.capacity = capacity
    try:
        yield
    finally:
        _tls.capacity = prev


def kv_shard_axes(B: int, C: int, rules=None) -> tuple[str, ...]:
    """Mesh axes of the decode-KV capacity dim, () when the sharded path is
    off (``rules``: the installed ones by default): "model" in the mesh,
    m = its size > 1, B > 1 and C % m == 0, as the reference's."""
    rules = current_rules() if rules is None else rules
    if rules is None or replicated_forced():
        return ()
    mesh = rules.mesh
    if "model" not in mesh.axis_names:
        return ()
    m = mesh.shape["model"]
    if m <= 1 or B <= 1 or C % m:
        return ()
    return ("model",)


def ring_layout(B: int, n: int, window: int = 0):
    """(axes, C, offset) of a decode ring whose block on this rank holds
    ``n`` slots of the whole ring's C, from slot ``offset``; None when the
    ring is whole (no rules, or ``kv_shard_axes`` off)."""
    rules = current_rules()
    if rules is None:
        return None
    cap = getattr(_tls, "capacity", None)
    if cap is None:
        raise RuntimeError("a decode step under rules needs the cache "
                           "capacity (kernels.shard.serving_capacity; the "
                           "engine sets it)")
    C = min(cap, window) if window else cap
    axes = kv_shard_axes(B, C, rules)
    if not axes:
        if n != C:
            raise ValueError(f"a whole ring of {C} slots holds {n}")
        return None
    m = axes_size(rules.mesh, axes)
    if n * m != C:
        raise ValueError(f"a ring of {C} slots over {m} ranks holds {n} "
                         "slots a rank")
    return axes, C, rules.mesh.index(axes) * n


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
                          scale: float, shards: int | None = None,
                          axes: tuple[str, ...] | None = None,
                          exact: bool | None = None) -> torch.Tensor:
    """Partial-softmax decode attention over capacity shards.

    qg (B,K,G,D); cache_k/v (B,C,K,D); ok (B,C) valid-slot mask (position
    and window, built by the caller as the replicated path builds it).
    The bias is ``where(ok, 0, -1e30)`` in f32 (``shard.py:324``).

    ``shards`` (one card): the ``shards`` shards' (acc, m, l) from one
    :func:`flash_decode_partial` launch (which raises unless ``shards``
    divides C), and :func:`combine_partials` takes the max over shards,
    rescales, sums in shard order and normalises.

    ``axes`` (across ranks, rules installed): cache_k/v and ok are this
    rank's capacity block, the shards the ranks along ``axes``; ``exact``
    (default: on the CPU) is the reference's exact mimic, else the flash
    partial and the combine across ranks (module docstring).

    Either way: (B,K,G,Dv) in qg's dtype, every rank the same bits.
    """
    if (shards is None) == (axes is None):
        raise ValueError("decode_attend_sharded takes shards (one card) or "
                         "axes (across ranks)")
    B, Kh, G, _ = qg.shape
    eager = _count("attn_kv", B * Kh * G * (1 + cache_v.shape[-1]) * 4,
                   n_psum=2)
    if axes is None:
        def run(qg, cache_k, cache_v, ok):
            bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
            acc, m, l = flash_decode_partial(qg, cache_k, cache_v, bias,
                                             scale=scale, shards=shards)
            return combine_partials(acc, m, l, qg.dtype)
    elif (not qg.is_cuda) if exact is None else exact:
        mesh = _mesh()

        def run(qg, cache_k, cache_v, ok):
            with observe.f32_accumulation():
                s = torch.einsum("bkgd,bckd->bkgc", qg.float(),
                                 cache_k.float()) * scale
            s = torch.where(ok[:, None, None, :], s, NEG_INF)
            m = mesh.all_reduce(s.amax(dim=-1, keepdim=True), axes, "max")
            p = torch.exp(s - m)
            l = mesh.all_reduce(p.sum(dim=-1, keepdim=True), axes)
            with observe.f32_accumulation():
                o = torch.einsum("bkgc,bckd->bkgd",
                                 (p / l).to(cache_v.dtype).float(),
                                 cache_v.float())
            return mesh.all_reduce(o, axes).to(qg.dtype)
    else:
        mesh = _mesh()

        def run(qg, cache_k, cache_v, ok):
            bias = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
            acc, m, l = flash_decode_partial(qg, cache_k, cache_v, bias,
                                             scale=scale, shards=1)
            mg = mesh.all_reduce(m.clone(), axes, "max")
            corr = torch.exp(m - mg)
            l, acc = _sum_flat([l * corr, acc * corr], axes, mesh)
            return combine_partials(acc, mg, l, qg.dtype)

    return _timed("attn_kv", eager, run, qg, cache_k, cache_v, ok)
