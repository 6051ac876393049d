"""Meshes over the ranks of the default process group.  Port of
``repro.launch.mesh``.

Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2, data=16,
model=16) = 512 ranks; the pod axis is pure data/FSDP parallelism.

A :class:`Mesh` names the axes of a grid of ranks and maps rank r to its
coordinates row-major over ``shape`` (the last axis fastest), the order in
which ``jax.make_mesh`` lays a host's devices out.  It holds one process
group per set of axes that a collective reduces or gathers over (every
non-empty subset of its axes, ``("model",)``, ``("data",)``, ``("data",
"model")`` and with ``pod`` their combinations with it), made once by
every rank in the same order.  Made where no process group is
initialised, a mesh only lays out blocks (``dist.sharding.local_block``):
planning and tests in one process, and any collective on it over more
than one rank raises.

A mesh may hold only some ranks of the default group (``ranks``: the
survivors' mesh of ``ckpt.straggler.recovered_mesh``): every rank of the
group still makes it, as ``torch.distributed.new_group`` asks, and a rank
outside it has no place in it (``member`` False, ``rank`` None) and
stands idle while the mesh's ranks work.
"""
from __future__ import annotations

import itertools
import math
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist.ranks import pick_backend
from repro_torch.dist.sharding import make_production_rules
from repro_torch.kernels.shard import _ax_tuple, axes_size


class Mesh:
    """``shape`` ranks along ``axis_names``; this process is ``rank``
    (the default group's rank, or 0 without one).  ``ranks``: the default
    group's ranks that make the mesh, in mesh order (default: all of
    them); ``rank`` is then this process's place among them."""

    def __init__(self, shape, axis_names, *, rank: int | None = None,
                 ranks=None):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} differ in length")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        self.ranks = tuple(range(self.size) if ranks is None else ranks)
        if len(self.ranks) != self.size:
            raise ValueError(f"{len(self.ranks)} ranks {self.ranks} for a "
                             f"mesh of {self.size}")
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
            rank = (self.ranks.index(rank) if rank in self.ranks
                    else None if ranks is not None else rank)
        if rank is not None and not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.member = rank is not None
        self._whole_group = ranks is None
        self.coords = (dict(zip(axis_names, self.coords_of(rank)))
                       if self.member else None)
        self._groups: dict[frozenset, tuple] = {}
        if dist.is_initialized():
            self._make_groups()

    def coords_of(self, rank: int) -> tuple[int, ...]:
        """Rank -> its coordinate along each axis (row-major)."""
        out = []
        for n in reversed(self.shape.values()):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def _make_groups(self) -> None:
        world = dist.get_world_size()
        if (world != self.size if self._whole_group
                else not set(self.ranks) <= set(range(world))):
            raise ValueError(f"a mesh of {self.size} ranks "
                             f"{dict(self.shape)} needs a default process "
                             f"group of {self.size}, not {world}")
        if self.size == 1:
            return
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                # ranks agreeing on every other axis form one group; every
                # rank makes every group, in the same order
                by_rest: dict[tuple, list[int]] = {}
                for r in range(self.size):
                    c = dict(zip(self.axis_names, self.coords_of(r)))
                    rest = tuple(c[a] for a in self.axis_names
                                 if a not in axes)
                    by_rest.setdefault(rest, []).append(r)
                for members in by_rest.values():
                    # a group's ranks in the default group's order: the
                    # order of its collectives' parts
                    members.sort(key=lambda r: self.ranks[r])
                    g = dist.new_group([self.ranks[r] for r in members])
                    if self.rank in members:
                        self._groups[frozenset(axes)] = (g, members)

    # -- layout ----------------------------------------------------------------

    def index(self, entry, rank: int | None = None) -> int:
        """The block index of ``rank`` (this rank by default) along a spec
        entry: its coordinates over the entry's axes, row-major in the
        entry's order (the first axis most significant)."""
        c = (self.coords if rank is None else
             dict(zip(self.axis_names, self.coords_of(rank))))
        i = 0
        for a in _ax_tuple(entry):
            i = i * self.shape[a] + c[a]
        return i

    # -- collectives -----------------------------------------------------------

    def _group(self, entry):
        key = frozenset(_ax_tuple(entry))
        if key not in self._groups:
            raise RuntimeError(f"no process group over {sorted(key)}: the "
                               "mesh was made where no process group is "
                               "initialised")
        return self._groups[key]

    def all_reduce(self, t: torch.Tensor, entry,
                   op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` in place over the ranks along ``entry`` (``op`` sum
        or max); every rank of the group gets the same bits."""
        if axes_size(self, entry) == 1:
            return t
        g, _ = self._group(entry)
        dist.all_reduce(t, {"sum": dist.ReduceOp.SUM,
                            "max": dist.ReduceOp.MAX}[op], group=g)
        return t

    def gather_whole(self, t: torch.Tensor, spec, dst: int = 0):
        """The whole tensor whose blocks under ``spec`` (one entry a dim)
        the ranks hold, on mesh rank ``dst``; None on every other rank.
        One gather over the ranks of ``dst``'s group along the spec's
        axes (a rank outside that group takes no part): only ``dst``
        holds the whole, and a block replicated along another axis is
        sent once."""
        entries = tuple(spec) + (None,) * (t.dim() - len(spec))
        used = {a for e in entries for a in _ax_tuple(e)}
        axes = tuple(a for a in self.axis_names
                     if a in used and self.shape[a] > 1)
        mine = self.rank == dst
        if not axes:
            return t if mine else None
        at = dict(zip(self.axis_names, self.coords_of(dst)))
        if any(self.coords[a] != at[a] for a in self.axis_names
               if a not in axes):
            return None
        g, members = self._group(axes)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in members] if mine else None
        dist.gather(t, parts, dst=self.ranks[dst], group=g)
        if not mine:
            return None
        out = torch.empty(tuple(d * axes_size(self, e) for d, e in
                                zip(t.shape, entries)),
                          dtype=t.dtype, device=t.device)
        for part, r in zip(parts, members):
            view = out
            for dim, e in enumerate(entries):
                if axes_size(self, e) > 1:
                    view = view.narrow(dim, self.index(e, r) * t.shape[dim],
                                       t.shape[dim])
            view.copy_(part)
        return out

    def barrier(self) -> None:
        """Wait until every rank of the mesh is here."""
        if self.size > 1:
            dist.barrier(group=self._group(self.axis_names)[0])

    def all_gather(self, t: torch.Tensor, entry, dim: int) -> torch.Tensor:
        """The ranks' blocks along ``entry`` concatenated along ``dim`` in
        block-index order: the whole dim a spec entry shards."""
        if axes_size(self, entry) == 1:
            return t
        g, members = self._group(entry)
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in members]
        dist.all_gather(parts, t, group=g)
        order = sorted(range(len(members)),
                       key=lambda i: self.index(entry, members[i]))
        return torch.cat([parts[i] for i in order], dim=dim)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh over the default process group, which must hold
    256 ranks (512 with ``multi_pod``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} "
                         f"needs {math.prod(shape)} ranks, the default "
                         f"process group has {world}")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """(world // model, model) over ("data", "model"): every rank of the
    default process group (one without it)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} ranks of "
                         "the default process group"
                         + ("" if dist.is_initialized() else
                            " (there is none: one rank)"))
    return Mesh((n // model, model), ("data", "model"))


def host_rules(device_arg, model: int = 1):
    """(production rules over :func:`make_host_mesh` with ``model`` ranks
    along "model", the rank's device, whether the process group was made
    here) for the launchers (calibrate's ``--mesh host``, train's
    ``--model-axis``): the caller's default group, else ``torchrun``'s
    environment's (``env://``), else none (one rank; ``model`` > 1 then
    raises ``ValueError``).  The device is ``device_arg``, else
    ``cuda:{LOCAL_RANK}`` under ``torchrun``, else the card."""
    made = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        kind = "cpu" if device_arg == "cpu" else "cuda"
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(pick_backend(kind, world, None),
                                init_method="env://")
        made = True
    if device_arg is None and dist.is_initialized():
        device_arg = f"cuda:{os.environ.get('LOCAL_RANK', 0)}" \
            if "LOCAL_RANK" in os.environ else None
    return (make_production_rules(make_host_mesh(model)),
            resolve_device(device_arg), made)
