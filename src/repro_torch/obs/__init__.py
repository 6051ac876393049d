"""Flight recorder: unified tracing + metrics across calibration, serving,
and the fleet.  Port of ``repro.obs``: the same names, labels, events and
files, so a trace of the port reads like the reference's.

Three faces, one package that needs only torch and the standard library:

* **spans** - ``obs.span("prefill", slot=s)`` context managers with CUDA
  fencing at exit (``sp.fence(outputs)`` synchronises the devices that
  hold them), thread-local nested parenting, and a shared no-op singleton
  on the disabled path (zero allocation, zero clock reads).
* **metrics** - a process-local registry of counters, gauges, and
  fixed-bucket histograms (``obs.inc`` / ``obs.set_gauge`` /
  ``obs.observe``; read back via ``obs.percentile`` / ``obs.summary``).
* **exporters** - a JSONL event log under ``--trace-dir``
  (``obs.configure(trace_dir=...)``), a Prometheus-style text snapshot
  via ``obs.expose()``, and ``obs.summary()``.

Disabled (the default) every call is a cheap bool check; nothing is
recorded and no event is written, so the serving/calibration hot paths
run the uninstrumented sequence of launches.  Enable with
``obs.configure()`` (optionally ``trace_dir=``), snapshot with
``obs.summary()`` / ``obs.expose()``, and wipe with ``obs.reset()``.
"""
from repro_torch.obs.core import (NOOP_SPAN, Span, configure, counter_value,
                                  declare_hist, disable, emit, enabled,
                                  events, expose, flush, gauge_value, inc,
                                  log, observe, percentile, reset, set_gauge,
                                  span, summary, timer, trace_path)
from repro_torch.obs.export import JsonlSink, read_jsonl
from repro_torch.obs.registry import DEFAULT_MS_BUCKETS, Histogram, Registry

__all__ = [
    "NOOP_SPAN", "Span", "configure", "counter_value", "declare_hist",
    "disable", "emit", "enabled", "events", "expose", "flush",
    "gauge_value", "inc", "log", "observe", "percentile", "reset",
    "set_gauge", "span", "summary", "timer", "trace_path",
    "JsonlSink", "read_jsonl",
    "DEFAULT_MS_BUCKETS", "Histogram", "Registry",
]
