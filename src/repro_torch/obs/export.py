"""Event exporters: JSONL trace sink + trace readback.  Port of
``repro.obs.export``; the schema and the file are the reference's.

One event = one JSON object on one line.  Shared schema across every
producer (spans, structured logs, metric points):

  {"ts": <unix seconds, float>, "kind": "span" | "log", ...}

span events add  name, dur_ms, span_id, parent_id (or null), depth, attrs
log events add   event, level, plus arbitrary structured fields

Writes are line-buffered through one file handle; ``flush()`` pushes
buffered lines to disk (and runs automatically at interpreter exit), so a
crash loses at most the current buffer, never corrupts earlier lines.
"""
from __future__ import annotations

import atexit
import io
import json
import pathlib
import threading
from typing import Any, Iterator


def _default(o: Any):
    """Best-effort JSON for numpy/torch scalars and arrays."""
    item = getattr(o, "item", None)
    if callable(item) and getattr(o, "ndim", 1) == 0:
        return item()
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        return tolist()
    return repr(o)


class JsonlSink:
    """Append-only events.jsonl writer under a trace directory."""

    def __init__(self, trace_dir):
        self.dir = pathlib.Path(trace_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "events.jsonl"
        self._fh: io.TextIOBase | None = None
        self._lock = threading.Lock()
        atexit.register(self.flush)

    def write(self, event: dict) -> None:
        line = json.dumps(event, default=_default)
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", buffering=1024 * 64)
            self._fh.write(line + "\n")

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


def read_jsonl(path) -> Iterator[dict]:
    """Yield events from a trace file (skips partially-written last line)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                return  # partial trailing line (writer mid-flush): stop
