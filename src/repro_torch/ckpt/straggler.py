"""Straggler / failure detection + elastic recovery planning.  The port's
own copy of ``repro.ckpt.straggler``: pure Python, the same policy (its
checks raise ``ValueError`` where the reference asserts).

At real scale every host reports a heartbeat per step; this module holds the
launcher-side policy, fully unit-testable without hardware:

* HeartbeatMonitor: per-host last-seen step/time, EWMA of step durations.
  A host is a STRAGGLER when its step time exceeds `straggler_factor` x the
  fleet median, and FAILED when silent for `timeout_s`.
* plan_recovery(): given the surviving hosts, pick the largest valid
  (data, model) mesh (model axis preserved - TP groups must stay intact;
  data axis shrinks to the largest divisor), map hosts to it, and rescale
  gradient accumulation so the GLOBAL batch is unchanged.
* The training loop reacts by restoring the latest checkpoint onto the new
  mesh and skipping the data cursor forward - no replayed or dropped
  batches.  (This package trains on one card; restoring onto a mesh comes
  with tensor parallelism, ROADMAP A item 7.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable


@dataclasses.dataclass
class HostState:
    host_id: int
    last_step: int = -1
    last_beat: float = 0.0
    ewma_step_s: float = 0.0


class HeartbeatMonitor:
    def __init__(self, num_hosts: int, *, timeout_s: float = 300.0,
                 straggler_factor: float = 2.0, ewma: float = 0.7):
        self.hosts = {h: HostState(h) for h in range(num_hosts)}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.ewma = ewma

    def beat(self, host_id: int, step: int, *, now: float | None = None,
             step_s: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        h = self.hosts[host_id]
        if step_s is not None:
            h.ewma_step_s = (self.ewma * h.ewma_step_s +
                             (1 - self.ewma) * step_s
                             if h.ewma_step_s else step_s)
        h.last_step = step
        h.last_beat = now

    def failed(self, *, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h.host_id for h in self.hosts.values()
                if h.last_beat and now - h.last_beat > self.timeout_s]

    def stragglers(self) -> list[int]:
        times = sorted(h.ewma_step_s for h in self.hosts.values()
                       if h.ewma_step_s)
        if not times:
            return []
        median = times[len(times) // 2]
        return [h.host_id for h in self.hosts.values()
                if h.ewma_step_s > self.straggler_factor * median]

    def healthy(self, *, now: float | None = None) -> list[int]:
        bad = set(self.failed(now=now)) | set(self.stragglers())
        return [h for h in self.hosts if h not in bad]


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    mesh_shape: tuple[int, ...]          # (data, model) or (pod, data, model)
    hosts: tuple[int, ...]               # surviving hosts, mesh order
    accum_scale: int                     # multiply grad-accum by this
    dropped_hosts: tuple[int, ...]


def plan_recovery(surviving: Iterable[int], *, hosts_total: int,
                  old_mesh: tuple[int, ...], model_axis: int,
                  chips_per_host: int = 4) -> RecoveryPlan:
    """Largest valid mesh from survivors; TP (model) groups preserved."""
    surviving = sorted(surviving)
    old_chips = 1
    for d in old_mesh:
        old_chips *= d
    chips = len(surviving) * chips_per_host
    if chips < model_axis:
        raise ValueError("not enough chips for one TP group")
    data_axis = chips // model_axis
    # data axis must divide the old data axis product so the global batch
    # factorizes into an integer accumulation rescale
    old_data = old_chips // model_axis
    while data_axis > 0 and old_data % data_axis != 0:
        data_axis -= 1
    if data_axis <= 0:
        raise ValueError(f"no data axis divides the old one ({old_data})")
    used_hosts = (data_axis * model_axis) // chips_per_host
    dropped = tuple(h for h in range(hosts_total) if h not in surviving)
    return RecoveryPlan(
        mesh_shape=(data_axis, model_axis),
        hosts=tuple(surviving[:used_hosts]),
        accum_scale=old_data // data_axis,
        dropped_hosts=dropped)
