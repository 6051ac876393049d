"""Start one process a rank, run a function in each, and collect the
results.

:func:`run_ranks` spawns ``world`` processes (``multiprocessing``'s spawn
method: a fresh interpreter each), joined into one default process group
over a ``file://`` store in a directory of its own.  Rank r runs on
``cuda:{r % device_count}`` or on the CPU, with torch's CPU ops on one
thread (``world`` ranks beside other processes would otherwise
oversubscribe the cores).  The backend is NCCL on CUDA with one rank a
card, gloo on the CPU; gloo on CUDA (several ranks on one card: NCCL
refuses two ranks on one GPU) only when the caller asks for it with
``backend="gloo"``.  Joining the group and every collective after it wait
at most ``timeout`` seconds, and the whole run at most ``deadline``: a
rank that raises, dies or overruns fails the run with its traceback, and
every rank still running is killed.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist


class RankError(RuntimeError):
    """A rank raised, died or overran its deadline."""


def pick_backend(device: str, world: int, backend: str | None) -> str:
    """The process group's backend (see the module docstring)."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', got {device!r}")
    if backend is not None:
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if backend == "nccl" and device == "cpu":
            raise ValueError("NCCL runs on CUDA devices only")
        return backend
    if device == "cpu":
        return "gloo"
    cards = torch.cuda.device_count()
    if world > cards:
        raise ValueError(f"{world} ranks on {cards} card(s): NCCL takes one "
                         "rank a card; pass backend='gloo' to run several "
                         "ranks on one card over the host")
    return "nccl"


def _entry(fn, rank, world, store, device, backend, timeout, args, out):
    try:
        torch.set_num_threads(1)
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
        dist.init_process_group(
            backend, init_method="file://" + store, rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:   # noqa: BLE001 - reported to the parent, re-raised
        out.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable, world: int, *, args: tuple = (),
              device: str = "cpu", backend: str | None = None,
              timeout: float = 120.0, deadline: float = 900.0) -> list[Any]:
    """``fn(rank, world, device, *args)`` in ``world`` processes; returns
    each rank's result, in rank order.  ``fn`` and ``args`` are pickled (a
    module-level function, picklable arguments), and so is each result
    (keep it on the host)."""
    backend = pick_backend(device, world, backend)
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(fn, r, world, os.path.join(tmp, "store"),
                               device, backend, timeout, args, out))
             for r in range(world)]
    results: dict[int, Any] = {}
    failed: dict[int, str] = {}
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline
        while len(results) + len(failed) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                if failed:
                    break
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"rank(s) {dead} died (exit codes "
                                    f"{[procs[r].exitcode for r in dead]})"
                                    " without a result") from None
                if time.monotonic() > end:
                    late = sorted(set(range(world)) - set(results))
                    raise RankError(f"ranks {late} overran the "
                                    f"{deadline:.0f} s deadline") from None
                continue
            if ok:
                results[rank] = value
            else:
                # the first failure often takes its peers down with it:
                # gather theirs for a moment, and report them all
                failed[rank] = value
                end = min(end, time.monotonic() + 2.0)
        if failed:
            raise RankError("\n".join(f"rank {r} failed:\n{failed[r]}"
                                      for r in sorted(failed)))
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
        return [results[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
