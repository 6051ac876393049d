"""Flight-recorder core: global switch, spans, timers, structured logs.
Port of ``repro.obs.core``.

Everything funnels through one process-global :class:`_ObsState`:

* ``span(name, **attrs)`` - timing context for a hot-path unit of work.
  When telemetry is DISABLED it returns a single shared no-op object
  (``obs.span(a) is obs.span(b)``): no allocation, no clock read, no event
  - the instrumented code path is the uninstrumented one plus a bool
  check.  When enabled, the span records wall + monotonic time, its parent
  (thread-local stack -> nested parenting), and emits a JSONL event at
  exit.  ``sp.fence(x)`` registers a tree of tensors whose devices are
  synchronised before the exit clock read, so queued CUDA work is charged
  to the span that launched it instead of whoever syncs next.  CPU tensors
  need no fence, and nothing is synchronised while a stream captures a
  CUDA graph (a synchronisation there would end the capture).

* ``timer(name, **attrs)`` - like ``span`` but ALWAYS measures (and still
  only emits when enabled).  For stage timings that feed artifacts/meta
  regardless of telemetry (e.g. ``launch.calibrate`` stats/search
  seconds): the fencing must hold even with the recorder off.

* ``log(event, **fields)`` - structured log record into the same JSONL
  stream as spans.  ``warn="..."`` additionally raises a stdlib warning
  (always, enabled or not), so warning semantics - pytest.warns,
  -W error - are preserved while the structured copy lands in the trace.

Metric writes (``inc`` / ``set_gauge`` / ``observe``) delegate to
``registry.Registry`` and are no-ops while disabled.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
import warnings
from collections import deque

import torch

from repro_torch.obs.export import JsonlSink
from repro_torch.obs.registry import Registry


class _ObsState:
    def __init__(self):
        self.enabled = False
        self.registry = Registry()
        self.sink: JsonlSink | None = None
        # in-memory tail of the event stream (tests, summaries) - kept even
        # when a JSONL sink is attached
        self.events: deque[dict] = deque(maxlen=4096)
        self.span_ids = itertools.count(1)


STATE = _ObsState()
_tls = threading.local()


def _span_stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def enabled() -> bool:
    return STATE.enabled


def configure(*, enabled: bool = True, trace_dir=None,
              buffer_events: int = 4096) -> None:
    """Turn the recorder on (and optionally attach a JSONL trace sink).

    Metrics and buffered events accumulated so far are kept; use
    :func:`reset` for a clean slate.
    """
    STATE.enabled = enabled
    STATE.events = deque(STATE.events, maxlen=buffer_events)
    if trace_dir is not None:
        if STATE.sink is not None and \
                str(STATE.sink.dir) != str(trace_dir):
            STATE.sink.close()
            STATE.sink = None
        if STATE.sink is None:
            STATE.sink = JsonlSink(trace_dir)


def disable() -> None:
    STATE.enabled = False
    if STATE.sink is not None:
        STATE.sink.flush()


def reset() -> None:
    """Tests/benches: drop every metric, event, and the trace sink."""
    STATE.enabled = False
    STATE.registry.reset()
    STATE.events.clear()
    if STATE.sink is not None:
        STATE.sink.close()
        STATE.sink = None
    _span_stack().clear()


def flush() -> None:
    if STATE.sink is not None:
        STATE.sink.flush()


def trace_path():
    return None if STATE.sink is None else STATE.sink.path


def emit(event: dict) -> None:
    """Stamp + route one event (buffer always, sink when attached)."""
    event.setdefault("ts", time.time())
    STATE.events.append(event)
    if STATE.sink is not None:
        STATE.sink.write(event)


def events() -> list[dict]:
    return list(STATE.events)


# -- fencing -----------------------------------------------------------------


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of every tensor in ``tree``: dicts, lists, tuples,
    dataclasses (``SearchState``), objects with ``vals`` / ``idx``
    planes (``SparseTensor``) and rank blocks (``DenseBlock``) are
    walked."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    elif hasattr(tree, "vals") and hasattr(tree, "idx"):
        _cuda_devices((tree.vals, tree.idx), out)
    elif hasattr(tree, "spec") and isinstance(getattr(tree, "data", None),
                                              torch.Tensor):
        _cuda_devices(tree.data, out)       # dist.sharding.DenseBlock
    return out


def block_until_ready(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree`` (the
    counterpart of ``jax.block_until_ready``).  CPU tensors need nothing;
    while the current stream captures a CUDA graph nothing waits."""
    devices = _cuda_devices(tree, set())
    if devices and not torch.cuda.is_current_stream_capturing():
        for d in devices:
            torch.cuda.synchronize(d)


# -- spans -------------------------------------------------------------------


class Span:
    """Measuring span; emits a JSONL event at exit when the recorder is on."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "depth",
                 "seconds", "_t0", "_wall0", "_fence")

    def __init__(self, name: str, fence=None, attrs: dict | None = None):
        self.name = name
        self.attrs = attrs or {}
        self.span_id = next(STATE.span_ids)
        self.parent_id = None
        self.depth = 0
        self.seconds: float | None = None
        self._fence = fence

    def fence(self, tree) -> None:
        """Tree of tensors to wait for before the exit clock read."""
        self._fence = tree

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        stack = _span_stack()
        if stack:
            self.parent_id = stack[-1].span_id
            self.depth = len(stack)
        stack.append(self)
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._fence is not None:
            block_until_ready(self._fence)
        self.seconds = time.perf_counter() - self._t0
        stack = _span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # exited out of order: drop self, keep others
            stack.remove(self)
        if STATE.enabled:
            emit({"ts": self._wall0, "kind": "span", "name": self.name,
                  "dur_ms": self.seconds * 1e3, "span_id": self.span_id,
                  "parent_id": self.parent_id, "depth": self.depth,
                  "ok": exc_type is None,
                  **({"attrs": self.attrs} if self.attrs else {})})
        return False


class _NoopSpan:
    """Shared disabled-path span: every method is a constant no-op."""

    __slots__ = ()
    seconds = None
    span_id = parent_id = None
    depth = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, tree):
        pass

    def set(self, **attrs):
        pass


NOOP_SPAN = _NoopSpan()


def span(name: str, fence=None, **attrs):
    """Hot-path span: a real measuring span when enabled, THE no-op
    singleton otherwise."""
    if not STATE.enabled:
        return NOOP_SPAN
    return Span(name, fence, attrs)


def timer(name: str, fence=None, **attrs) -> Span:
    """Always-measuring span (stage timings that outlive the recorder)."""
    return Span(name, fence, attrs)


# -- structured log ----------------------------------------------------------


def log(event: str, *, level: str = "info", warn: str | None = None,
        warn_category: type = UserWarning, **fields) -> None:
    """One structured record into the trace stream.

    ``warn=`` additionally raises ``warnings.warn(warn, warn_category)``
    whether or not the recorder is enabled - callers that would call
    ``warnings.warn`` directly route here and keep their stdlib-warning
    contract (filters, pytest.warns) intact.
    """
    if STATE.enabled:
        emit({"kind": "log", "event": event, "level": level, **fields})
    if warn is not None:
        warnings.warn(warn, warn_category, stacklevel=3)


# -- metrics -----------------------------------------------------------------


def inc(name: str, value: float = 1.0, **labels) -> None:
    if STATE.enabled:
        STATE.registry.inc(name, value, labels)


def set_gauge(name: str, value: float, **labels) -> None:
    if STATE.enabled:
        STATE.registry.set_gauge(name, value, labels)


def observe(name: str, value: float, **labels) -> None:
    if STATE.enabled:
        STATE.registry.observe(name, value, labels)


def declare_hist(name: str, edges) -> None:
    STATE.registry.declare_hist(name, edges)


def counter_value(name: str, **labels) -> float:
    return STATE.registry.counter_value(name, labels)


def gauge_value(name: str, **labels) -> float | None:
    return STATE.registry.gauge_value(name, labels)


def percentile(name: str, q: float, **labels) -> float | None:
    return STATE.registry.percentile(name, q, labels)


def expose() -> str:
    """Prometheus-style text snapshot of the whole registry."""
    return STATE.registry.expose()


def summary() -> dict:
    """JSON-ready registry snapshot."""
    return STATE.registry.summary()
