"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.
Port of ``repro.obs.registry``.

Pure Python + stdlib: no torch, no numpy.  Metrics are keyed by
``(name, sorted label items)``; a histogram's buckets are fixed at first
use (declare non-default edges up front with :func:`Registry.declare_hist`),
so ``observe`` is a bisect + two adds on the hot path.

Bucket semantics follow the Prometheus ``le`` convention: bucket ``i``
counts observations ``v <= edges[i]`` (and ``> edges[i-1]``); one implicit
overflow bucket catches everything above the last edge.  Percentiles are
estimated by linear interpolation inside the winning bucket, clamped to the
observed min/max so tiny sample counts never extrapolate past real data.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Iterable, Mapping

# default histogram edges, in milliseconds: spans sub-0.1ms python overhead
# through multi-second calibration stages
DEFAULT_MS_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                      100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0)

MetricKey = tuple[str, tuple[tuple[str, Any], ...]]


def metric_key(name: str, labels: Mapping[str, Any] | None) -> MetricKey:
    if not labels:
        return (name, ())
    return (name, tuple(sorted((k, v) for k, v in labels.items())))


def _render_labels(items: Iterable[tuple[str, Any]]) -> str:
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}" if body else ""


def _prom_name(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


class Histogram:
    """Fixed-bucket histogram with exact sum/count/min/max."""

    __slots__ = ("edges", "counts", "sum", "count", "min", "max")

    def __init__(self, edges: Iterable[float] = DEFAULT_MS_BUCKETS):
        self.edges = tuple(sorted(float(e) for e in edges))
        assert self.edges, "histogram needs at least one bucket edge"
        self.counts = [0] * (len(self.edges) + 1)  # +1: overflow bucket
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def percentile(self, q: float) -> float | None:
        """Bucket-interpolated q-th percentile (q in [0, 100])."""
        if self.count == 0:
            return None
        target = (q / 100.0) * self.count
        seen = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                lo = self.edges[i - 1] if i > 0 else min(self.min, self.edges[0])
                hi = self.edges[i] if i < len(self.edges) else self.max
                frac = (target - seen) / c
                est = lo + (hi - lo) * max(0.0, min(1.0, frac))
                return max(self.min, min(self.max, est))
            seen += c
        return self.max

    def snapshot(self) -> dict:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "p50": self.percentile(50), "p95": self.percentile(95),
                "p99": self.percentile(99),
                "buckets": {("+Inf" if i == len(self.edges)
                             else repr(self.edges[i])): c
                            for i, c in enumerate(self.counts)}}


class Registry:
    """Thread-safe process-local metric store."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[MetricKey, float] = {}
        self.gauges: dict[MetricKey, float] = {}
        self.hists: dict[MetricKey, Histogram] = {}
        self._hist_edges: dict[str, tuple[float, ...]] = {}

    # -- writes --------------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, labels=None) -> None:
        k = metric_key(name, labels)
        with self._lock:
            self.counters[k] = self.counters.get(k, 0.0) + value

    def set_gauge(self, name: str, value: float, labels=None) -> None:
        self.gauges[metric_key(name, labels)] = float(value)

    def declare_hist(self, name: str, edges: Iterable[float]) -> None:
        """Pin non-default bucket edges for every series of ``name``.

        Must run before the first ``observe`` of that name (an existing
        series keeps its edges - changing them mid-flight would corrupt
        the counts).
        """
        self._hist_edges[name] = tuple(sorted(float(e) for e in edges))

    def observe(self, name: str, value: float, labels=None) -> None:
        k = metric_key(name, labels)
        h = self.hists.get(k)
        if h is None:
            with self._lock:
                h = self.hists.setdefault(
                    k, Histogram(self._hist_edges.get(name,
                                                      DEFAULT_MS_BUCKETS)))
        h.observe(value)

    # -- reads ---------------------------------------------------------------

    def counter_value(self, name: str, labels=None) -> float:
        return self.counters.get(metric_key(name, labels), 0.0)

    def gauge_value(self, name: str, labels=None) -> float | None:
        return self.gauges.get(metric_key(name, labels))

    def hist(self, name: str, labels=None) -> Histogram | None:
        return self.hists.get(metric_key(name, labels))

    def percentile(self, name: str, q: float, labels=None) -> float | None:
        h = self.hist(name, labels)
        return None if h is None else h.percentile(q)

    def summary(self) -> dict:
        """JSON-ready snapshot (merged into BENCH_*.json artifacts)."""
        def render(d):
            return {n + _render_labels(items): v
                    for (n, items), v in sorted(d.items())}
        return {"counters": render(self.counters),
                "gauges": render(self.gauges),
                "histograms": {n + _render_labels(items): h.snapshot()
                               for (n, items), h in sorted(self.hists.items())}}

    def expose(self) -> str:
        """Prometheus text-exposition snapshot of every metric."""
        lines: list[str] = []
        for (n, items), v in sorted(self.counters.items()):
            lines.append(f"# TYPE {_prom_name(n)} counter")
            lines.append(f"{_prom_name(n)}{_render_labels(items)} {v:g}")
        for (n, items), v in sorted(self.gauges.items()):
            lines.append(f"# TYPE {_prom_name(n)} gauge")
            lines.append(f"{_prom_name(n)}{_render_labels(items)} {v:g}")
        for (n, items), h in sorted(self.hists.items()):
            pn = _prom_name(n)
            lines.append(f"# TYPE {pn} histogram")
            cum = 0
            for i, c in enumerate(h.counts):
                cum += c
                le = "+Inf" if i == len(h.edges) else f"{h.edges[i]:g}"
                lab = _render_labels(tuple(items) + (("le", le),))
                lines.append(f"{pn}_bucket{lab} {cum}")
            lab = _render_labels(items)
            lines.append(f"{pn}_sum{lab} {h.sum:g}")
            lines.append(f"{pn}_count{lab} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()
            self._hist_edges.clear()
