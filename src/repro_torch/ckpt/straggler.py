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
  batches: :func:`recovered_mesh` lays the plan's mesh over the
  survivors' ranks (a subgroup of the ranks running, the others idle; or
  a smaller spawn's), and :func:`resume` restores the latest checkpoint
  onto it with the accumulation scaled by ``accum_scale``, so the global
  batch is unchanged, and the cursor at the checkpoint's ``next_step``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Iterable


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


def recovered_mesh(plan: RecoveryPlan):
    """The plan's (data, model) mesh over the surviving hosts' ranks: the
    plan keeps whole hosts, so a host holds prod(mesh_shape) / len(hosts)
    chips, and host h ranks h * chips ... + chips - 1, the plan's hosts
    in mesh order.  Every rank of the default process group makes it; one
    outside it gets ``member`` False (``launch.mesh.Mesh``)."""
    from repro_torch.launch.mesh import Mesh
    if not plan.hosts:
        raise ValueError(f"{plan}: the plan keeps no whole host")
    chips = math.prod(plan.mesh_shape) // len(plan.hosts)
    ranks = [h * chips + c for h in plan.hosts for c in range(chips)]
    return Mesh(plan.mesh_shape, ("data", "model"), ranks=ranks)


@dataclasses.dataclass
class Resumed:
    """Where training goes on after a recovery, on one rank of the new
    mesh: its rules, its blocks of the params and the AdamW state, the
    accumulation and the data cursor's index."""
    rules: Any
    params: Any
    ostate: Any
    accum: int
    next_step: int


def resume(plan: RecoveryPlan, mgr, cfg, *, accum: int,
           device=None) -> Resumed | None:
    """Restore ``mgr``'s latest checkpoint onto the recovered mesh
    (:func:`recovered_mesh`) under the production rules: each rank's
    blocks of the params and of the AdamW state, ``accum * accum_scale``
    microbatches a step (the global batch unchanged) and the cursor at the
    checkpoint's ``next_step``.  None on a rank outside the mesh."""
    from repro_torch.dist.sharding import make_production_rules
    from repro_torch.models import model as M
    from repro_torch.optim.optimizers import adamw_init
    mesh = recovered_mesh(plan)
    if not mesh.member:
        return None
    rules = make_production_rules(mesh)
    template = M.empty_params(cfg, device=device, rules=rules)
    (params, ostate), meta = mgr.restore((template, adamw_init(template)),
                                         rules=rules)
    return Resumed(rules=rules, params=params, ostate=ostate,
                   accum=accum * plan.accum_scale,
                   next_step=meta["next_step"])
