"""Op-stream auditor: the static trace contracts of the hot paths.

Port of ``repro.analysis.jaxpr_audit``.  The port has no jaxpr: what it
audits is the op stream of ONE call of a surface, recorded below autograd
by a ``TorchDispatchMode`` (:class:`OpRecorder`).  That works on the CPU,
on the card (an eager call, or the call a CUDA graph captures) and on the
``meta`` device, where nothing is computed and nothing is allocated:
:func:`audit_fn` moves a surface's arguments there by default, so a
full-width surface is audited in seconds on any host.

From the stream it extracts what the reference's walk extracts:

* the op histogram (``primitives``, by aten op name) and the op count;
* host syncs (``host_callbacks``): a scalar read of a device tensor
  (``aten._local_scalar_dense``: ``.item()``, ``bool()``, ``int()``), a
  copy from the device to the host, and an op whose output shape depends
  on the data (``nonzero``, ``masked_select``, ``unique``, boolean
  indexing).  The surface's device is its first tensor argument's; a
  surface audited on the CPU has no device to sync with, so host syncs
  are counted on ``meta`` or CUDA surfaces only (a host scalar made and
  read inside a step, as ``models.common._rounded`` does, is no sync);
* collectives per call site (``collectives``, ``psums_by_site``): what
  ``kernels.shard``'s accounting counts under the surface's trace
  (``surface_call``), at each (stage, pattern position) once, as the
  reference's trace-time counters do; ``{}`` on one card unless
  ``kv_shards`` >= 2 stands in for a mesh's capacity shards;
* large bf16 / f16 -> f32 / f64 upcasts (``large_f32_upcasts``), at the
  reference's size threshold (2**14 elements): an explicit cast, a copy
  into a wider tensor, or an op whose wider output promotes a large half
  input.  The f32 copies a product reads to accumulate in f32
  (``kernels.observe.f32_accumulation``: the reference's
  ``preferred_element_type``) are listed under ``upcasts`` as
  accumulators and not counted, as the reference exempts its K-partial
  accumulators;
* ``arg_bytes`` / ``out_bytes`` of the tensors in the arguments and the
  result (a ``SparseTensor``'s vals and index plane, a ``SearchState``'s
  trees) and the ``dtypes`` the stream touches;
* donation: ``donated_in_place``, the argument tensors the call updates in
  place (their version counters move), the port's form of a donated
  buffer;
* the hand-written kernel calls by name, the reference's ``pallas_call``
  eqns, seen at the kernels' entry points (``kernels.observe``; on the CPU
  or on meta they reach their plain versions, whose ops stay hidden, as a
  launch is one op), counted two ways: per call (``kernel_launches``, what
  the card launches) and once per scanned call site
  (``kernel_calls``: a call inside a layer stack counts at the stack's
  first layer only, as the reference's scanned layer body is traced
  once - the convention R17 applies to ``dist.psum``), and the pairs of
  calls over one input (``kernel_pairs``), which the reference's CPU route
  makes as one call (``AuditReport.reference_calls``).

The recorder also keeps each storage's lifetime and each kernel call's
launch configuration for ``analysis.memplan``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import weakref
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import observe
from repro_torch.kernels import shard as ksh
from repro_torch.sparse.formats import BitMask, SparseTensor

__all__ = ["AuditReport", "KernelCall", "OpRecorder", "audit_fn", "record",
           "tensors", "tree_bytes", "to_device", "fn_to_device",
           "UPCAST_NUMEL"]

UPCAST_NUMEL = 1 << 14      # the reference's "large" upcast threshold
_HALF = (torch.bfloat16, torch.float16)
_WIDE = (torch.float32, torch.float64)
_aten = torch.ops.aten
# ops whose output shape depends on the data: the host must read a count
_DATA_SHAPED = {"nonzero", "masked_select", "_unique2", "unique_dim",
                "unique_consecutive", "unique_dim_consecutive",
                "repeat_interleave"}


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _walk(x, out: list) -> None:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, SparseTensor):
        out.extend((x.vals, x.idx))
    elif isinstance(x, BitMask):
        out.append(x.bits)
    elif isinstance(x, dict):
        for k in sorted(x):
            _walk(x[k], out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _walk(v, out)
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            _walk(getattr(x, f.name), out)


def tensors(obj) -> list[torch.Tensor]:
    """Every tensor in a nested argument: dicts (sorted keys, as trees
    flatten), lists, tuples, dataclasses (a ``SearchState``), a
    ``SparseTensor``'s vals and index plane, a ``BitMask``'s bytes.  (No
    closure: a recursive closure would be a reference cycle holding the
    tensors until the garbage collector runs, and the planner reads
    their deaths.)"""
    out: list[torch.Tensor] = []
    _walk(obj, out)
    return out


def tree_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in tensors(obj))


def to_device(obj, device):
    """``obj`` with every tensor (and SparseTensor / BitMask) moved to
    ``device``; containers and dataclasses rebuilt, anything else kept."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, SparseTensor):
        return obj.to(device)
    if isinstance(obj, BitMask):
        return BitMask(obj.bits.to(device), obj.shape)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [to_device(v, device) for v in obj]
    if isinstance(obj, tuple):
        return tuple(to_device(v, device) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


@dataclasses.dataclass
class AuditReport:
    """Everything the recorder extracts from one call of a surface."""
    surface: str
    n_ops: int = 0
    primitives: dict = dataclasses.field(default_factory=dict)
    host_callbacks: list = dataclasses.field(default_factory=list)
    collectives: dict = dataclasses.field(default_factory=dict)
    psums_by_site: dict = dataclasses.field(default_factory=dict)
    upcasts: list = dataclasses.field(default_factory=list)
    large_f32_upcasts: int = 0
    dtypes: list = dataclasses.field(default_factory=list)
    arg_bytes: int = 0
    out_bytes: int = 0
    donated_in_place: int = 0
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    kernel_launches: dict = dataclasses.field(default_factory=dict)
    kernel_pairs: int = 0
    device: str = "?"

    @property
    def reference_calls(self) -> int:
        """The per-site kernel calls as the reference's CPU route makes
        them, the route its goldens were written on: a pair over one input
        (``kernels.observe.kernel_pair``) is one call there."""
        return sum(self.kernel_calls.values()) - self.kernel_pairs

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class KernelCall:
    """One hand-written kernel call as the recorder saw it: its name, the
    op index, the shapes and dtypes of its tensor operands in order, its
    other arguments (``positional``, ``kwargs``), the keywords that held
    tensors, and whether it counts at its site."""
    name: str
    op: int
    shapes: list
    dtypes: list
    positional: list
    kwargs: dict
    tensor_kwargs: list
    per_site: bool


def _bump(d: dict, key, n: int = 1) -> None:
    d[key] = d.get(key, 0) + n


class OpRecorder(TorchDispatchMode):
    """Records one call's op stream (see the module docstring); also the
    kernel observer of ``kernels.observe``.  ``device``: the surface's
    device type, whose tensors a host read syncs with (``"cpu"``: none).
    ``track_memory``: keep each storage made during the call, its bytes
    and the op indices it lived between (``spans``): a storage dies with
    the last observed tensor on it (a weakref callback; autograd's saved
    tensors keep theirs alive)."""

    def __init__(self, surface: str = "?", *, device: str = "meta",
                 upcast_numel: int = UPCAST_NUMEL,
                 track_memory: bool = False):
        super().__init__()
        self.rep = AuditReport(surface=surface, device=device)
        self.device = device
        self.upcast_numel = upcast_numel
        self.track_memory = track_memory
        self.kernels: list[KernelCall] = []
        self._dtypes: set[str] = set()
        self._in_kernel = 0
        self._accum = 0
        self.n = 0                       # ops recorded so far
        # storage key -> its live record [key, nbytes, first op, last op or
        # None, refs]; refs: the observed tensors on it still alive
        self.storages: dict[int, list] = {}
        self.spans: list[list] = []          # every record, live or freed
        self._refs: dict[int, weakref.ref] = {}
        self.arg_keys: set[int] = set()

    # -- kernels.observe hooks ----------------------------------------------

    def kernel_call(self, name: str, fn: Callable, args: tuple,
                    kwargs: dict):
        trace = ksh.trace_sites()
        per_site = trace is None or getattr(trace, "layer", None) in (None,
                                                                     0)
        ins = tensors((args, kwargs))
        self._in_kernel += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._in_kernel -= 1
        kc = KernelCall(name, self.n, [list(t.shape) for t in ins],
                        [_dtype_name(t.dtype) for t in ins],
                        [a for a in args if not tensors(a)],
                        {k: v for k, v in kwargs.items() if not tensors(v)},
                        sorted(k for k, v in kwargs.items() if tensors(v)),
                        per_site)
        self.kernels.append(kc)
        _bump(self.rep.kernel_launches, name)
        if per_site:
            _bump(self.rep.kernel_calls, name)
        _bump(self.rep.primitives, f"kernel:{name}")
        for t in ins + tensors(out):
            self._dtypes.add(_dtype_name(t.dtype))
        self._note_outputs(tensors(out))
        self.n += 1
        self.rep.n_ops += 1
        return out

    @contextlib.contextmanager
    def accumulation(self):
        self._accum += 1
        try:
            yield
        finally:
            self._accum -= 1

    @contextlib.contextmanager
    def pair(self):
        trace = ksh.trace_sites()
        if trace is None or getattr(trace, "layer", None) in (None, 0):
            self.rep.kernel_pairs += 1
        yield

    def collective(self, kind: str, site: str, n: int) -> None:
        _bump(self.rep.collectives, kind, n)
        _bump(self.rep.psums_by_site, site, n)

    # -- storage lifetimes ----------------------------------------------------

    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _died(self, rec: list, ref) -> None:
        """A weakref callback: one observed tensor on ``rec``'s storage is
        gone; with the last, the storage is freed before op ``self.n``."""
        self._refs.pop(id(ref), None)
        rec[4] -= 1
        if rec[4] == 0:
            rec[3] = self.n
            if self.storages.get(rec[0]) is rec:
                del self.storages[rec[0]]

    def _note_outputs(self, outs: list[torch.Tensor]) -> None:
        """Track the storages under an op's outputs: a new one from here,
        a known one (a view, an in-place update) one more reference."""
        if not self.track_memory:
            return
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self.arg_keys:
                continue
            rec = self.storages.get(k)
            if rec is None:
                rec = [k, st.nbytes(), self.n, None, 0]
                self.storages[k] = rec
                self.spans.append(rec)
            rec[4] += 1
            r = weakref.ref(t, functools.partial(self._died, rec))
            self._refs[id(r)] = r

    def note_args(self, args) -> None:
        for t in tensors(args):
            self.arg_keys.add(self._key(t))

    # -- the dispatch hook -----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._in_kernel:
            return func(*args, **kwargs)
        name = func.overloadpacket.__name__
        rep = self.rep
        rep.n_ops += 1
        _bump(rep.primitives, name)
        ins = tensors((args, kwargs))
        on_dev = self.device != "cpu"
        out = None
        if func is _aten._local_scalar_dense.default:
            t = args[0]
            if on_dev and t.device.type != "cpu":
                rep.host_callbacks.append({"op": name, "kind": "scalar_read",
                                           "shape": list(t.shape)})
                if t.device.type == "meta":
                    out = False if t.dtype == torch.bool else 0
        elif name in ("_to_copy", "copy_") and on_dev:
            src = args[1] if name == "copy_" else args[0]
            dst_dev = (args[0].device if name == "copy_" else
                       torch.device(kwargs.get("device") or src.device))
            if src.device.type != "cpu" and dst_dev.type == "cpu":
                rep.host_callbacks.append({"op": name, "kind": "to_host",
                                           "shape": list(src.shape)})
                if src.device.type == "meta":
                    out = (args[0] if name == "copy_" else torch.zeros(
                        src.shape, dtype=kwargs.get("dtype") or src.dtype))
        elif (name in _DATA_SHAPED or (name == "index" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] or ())))) and on_dev and ins and \
                ins[0].device.type != "cpu":
            rep.host_callbacks.append({"op": name, "kind": "data_shape",
                                       "shape": list(ins[0].shape)})
            if ins[0].device.type == "meta":
                out = _upper_bound(name, args)
        if out is None:
            out = func(*args, **kwargs)
        outs = tensors(out)
        self._upcasts(name, args, ins, outs)
        for t in ins + outs:
            self._dtypes.add(_dtype_name(t.dtype))
        self._note_outputs(outs)
        self.n += 1
        return out

    def _upcasts(self, name, args, ins, outs) -> None:
        src = None
        if name == "_to_copy" and outs and ins[0].dtype in _HALF \
                and outs[0].dtype in _WIDE:
            src = ins[0]
        elif name == "copy_" and len(ins) >= 2 and ins[1].dtype in _HALF \
                and ins[0].dtype in _WIDE:
            src = ins[1]
        elif outs and outs[0].dtype in _WIDE and name not in (
                "_to_copy", "copy_"):
            half = [t for t in ins if t.dtype in _HALF]
            src = max(half, key=torch.Tensor.numel) if half else None
        if src is None or src.numel() < self.upcast_numel:
            return
        accum = self._accum > 0
        self.rep.upcasts.append({
            "op": name, "from": _dtype_name(src.dtype),
            "to": _dtype_name(outs[0].dtype if name != "copy_"
                              else ins[0].dtype),
            "numel": src.numel(), "accum": accum})
        if not accum:
            self.rep.large_f32_upcasts += 1

    # -- result ----------------------------------------------------------------

    def finish(self, args, out) -> AuditReport:
        rep = self.rep
        rep.arg_bytes = tree_bytes(args)
        rep.out_bytes = tree_bytes(out)
        for t in tensors(args):
            self._dtypes.add(_dtype_name(t.dtype))
        rep.dtypes = sorted(self._dtypes)
        rep.primitives = dict(sorted(rep.primitives.items()))
        rep.kernel_calls = dict(sorted(rep.kernel_calls.items()))
        rep.kernel_launches = dict(sorted(rep.kernel_launches.items()))
        rep.collectives = dict(sorted(rep.collectives.items()))
        rep.psums_by_site = dict(sorted(rep.psums_by_site.items()))
        return rep


def _upper_bound(name: str, args):
    """A meta stand-in for a data-shaped op's result, at the largest size
    it can take (the audit goes on past the sync it has recorded)."""
    x = args[0]
    meta = dict(device="meta")
    if name == "nonzero":
        return torch.empty((x.numel(), x.dim()), dtype=torch.long, **meta)
    if name == "masked_select":
        return torch.empty((x.numel(),), dtype=x.dtype, **meta)
    if name == "index":                  # x[mask], one boolean index
        mask = next(i for i in args[1] if i is not None)
        return torch.empty((mask.numel(), *x.shape[mask.dim():]),
                           dtype=x.dtype, **meta)
    if name == "_unique2":
        return (torch.empty((x.numel(),), dtype=x.dtype, **meta),
                torch.empty(x.shape, dtype=torch.long, **meta),
                torch.empty((x.numel(),), dtype=torch.long, **meta))
    raise NotImplementedError(f"audit: {name} on the meta device has a "
                              "data-dependent shape; audit on the CPU")


def _device_of(args) -> str:
    ts = tensors(args)
    return ts[0].device.type if ts else "cpu"


def record(fn: Callable, *args, surface: str = "?",
           upcast_numel: int = UPCAST_NUMEL, track_memory: bool = False):
    """Run ``fn(*args)`` once under an :class:`OpRecorder`, as the trace of
    an engine surface (``kernels.shard.surface_call``).  Returns (the
    recorder with its finished report, fn's result)."""
    rec = OpRecorder(surface, device=_device_of(args),
                     upcast_numel=upcast_numel, track_memory=track_memory)
    rec.note_args(args)
    versions = [t._version for t in tensors(args)]
    with observe.observing(rec), ksh.surface_call(True), rec:
        out = fn(*args)
    rec.finish(args, out)
    rec.rep.donated_in_place = sum(
        t._version != v for t, v in zip(tensors(args), versions,
                                        strict=True))
    return rec, out


def fn_to_device(fn: Callable, device) -> Callable:
    """``fn`` with the tensors a ``functools.partial`` binds moved to
    ``device`` (a surface's closed-over constants: the search chunk's
    stats); any other callable as it is."""
    if isinstance(fn, functools.partial):
        return functools.partial(fn_to_device(fn.func, device),
                                 *to_device(fn.args, device),
                                 **to_device(fn.keywords, device))
    return fn


def audit_fn(fn: Callable, *args, surface: str = "?",
             upcast_numel: int = UPCAST_NUMEL,
             device: str | None = "meta") -> AuditReport:
    """Record one call of ``fn(*args)`` and audit it.  ``device``: where
    the call runs; ``"meta"`` (the default) moves the arguments (and a
    partial's bound tensors) there, so nothing is computed; None runs them
    where they lie (the CPU, or the card)."""
    if device is not None:
        fn, args = fn_to_device(fn, device), to_device(args, device)
    rec, _ = record(fn, *args, surface=surface, upcast_numel=upcast_numel)
    return rec.rep
