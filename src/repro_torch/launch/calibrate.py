"""Calibration entry point: stats -> mirror-descent search -> MaskBank.

Port of ``repro.launch.calibrate``.  Serving consumes the MaskBank artifact
this writes and never re-runs the search: calibrate once, re-threshold to
masks at any budget, in any process.  The bank is the reference's format:
``repro.sparse.bank.MaskBank.load`` reads it, and this package reads the
reference's.

  PYTHONPATH=src python -m repro_torch.launch.calibrate --arch llama3.2-1b \
      --smoke --out /tmp/bank --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --sparse-artifact /tmp/bank --device cpu

``--arch`` takes every config module of ``repro_torch.configs``:
``llama3.2-1b``, ``mixtral-8x22b``, ``yi-6b``, ``gemma2-2b``, ``gemma3-1b``,
``deepseek-v2-lite-16b``, ``zamba2-7b``, ``xlstm-125m`` (its smoke config
with ``--mode unstructured``: its ff_down is 85 deep there).

Runs on the card; ``--device cpu`` runs the plain CPU path.  Stage seconds
come from ``obs.timer``s (``calibrate.stats``, ``calibrate.search``,
``calibrate.save_bank``): host clocks around work fenced on the stage's
outputs, recorded in the bank's meta whether or not the flight recorder
is on.  ``--stats-impl tape`` takes the stats from the eager ``StatsTape``
oracle instead of the production pass (recorded as the bank's
``stats_impl``).  ``--trace-dir D`` turns the flight recorder on and
writes ``D/events.jsonl`` (the stage timers, the per-chunk search series,
``calibrate.done``) and ``D/metrics.prom``; ``--xprof-dir X`` writes a
``torch.profiler`` Chrome trace (CPU and, on the card, CUDA activities)
into X, each stage under a ``record_function`` of its name.

``--mesh host`` (the reference's): the stats and the search state shard
over the host mesh, ``launch.mesh.make_host_mesh()``'s (world, 1) over
("data", "model") of the default process group, with
``dist.sharding.make_production_rules`` (llama and mixtral).  Every rank
runs this launcher with the same arguments: the group is the caller's
(ranks already joined, as ``dist.ranks.run_ranks`` joins them) or made
here from ``torchrun``'s environment, each rank on ``cuda:{LOCAL_RANK}``
(or the CPU with ``--device cpu``) with ``dist.ranks.pick_backend``'s
backend.  Rank 0 alone gathers and writes the bank, prints, and runs the
flight recorder and the recompile sentinel; without a process group the
mesh is one rank.  On the CPU, 4 ranks:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.calibrate \
      --arch llama3.2-1b --smoke --out /tmp/bank --mesh host --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
from typing import Any

import torch

from repro_torch import obs, tree
from repro_torch.configs.base import PruneConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import host_rules

PyTree = Any


def stage_annotation(name: str, annotate: bool):
    """``torch.profiler.record_function(name)`` while ``--xprof-dir``
    profiles (the reference's ``StepTraceAnnotation``), else nothing."""
    if not annotate:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiling(xprof_dir, device: torch.device):
    """``torch.profiler`` over the block when ``xprof_dir`` is set (CPU
    activities, and CUDA on the card), its Chrome trace written into
    ``xprof_dir`` when the block ends, the profiler stopped either way."""
    if not xprof_dir:
        yield
        return
    import pathlib

    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(xprof_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"wrote profiler trace -> {out / 'trace.json'}")


def write_metrics(trace_dir) -> None:
    """``metrics.prom`` (``obs.expose()``) beside the flushed
    ``events.jsonl`` in ``trace_dir``."""
    import pathlib
    prom = pathlib.Path(trace_dir) / "metrics.prom"
    prom.write_text(obs.expose())
    obs.flush()
    print(f"wrote trace -> {obs.trace_path()} and {prom}")


def params_fingerprint(params: PyTree) -> str:
    """Order-stable crc32 of the weights a bank was calibrated against."""
    from repro_torch.sparse.bank import _tree_checksum
    return _tree_checksum(params)


def calibrate_to_bank(out_dir, *, cfg, pcfg: PruneConfig, params: PyTree,
                      calib: list[dict], arch: str, smoke: bool,
                      stats_impl: str = "jit", log_every: int = 0,
                      loss_fn=None, extra: dict | None = None,
                      xprof: bool = False, rules=None):
    """Run the full calibration once and write the MaskBank artifact.

    Returns the in-memory :class:`~repro_torch.sparse.bank.MaskBank`
    backed by the artifact just written to ``out_dir``; its meta records
    the stage seconds (``obs.timer``s, fenced on each stage's outputs)
    and the search history.  ``xprof``: each stage under a
    ``record_function`` of its name, for an active profiler.  ``rules``:
    every rank calls; stats and search run sharded, and rank 0 writes the
    bank and gets it (the other ranks None: ``MaskBank.save``)."""
    from repro_torch.core import calibrate
    from repro_torch.sparse.bank import MaskBank
    with stage_annotation("calibrate.stats", xprof), \
            obs.timer("calibrate.stats", arch=arch,
                      stats_impl=stats_impl) as t_stats:
        stats = calibrate.collect_stats(cfg, params, calib, pcfg=pcfg,
                                        impl=stats_impl, rules=rules)
        t_stats.fence(stats)
    with stage_annotation("calibrate.search", xprof), \
            obs.timer("calibrate.search", arch=arch,
                      steps=pcfg.steps) as t_search:
        state, history = calibrate.run_search(cfg, pcfg, params, calib,
                                              stats, log_every=log_every,
                                              loss_fn=loss_fn, rules=rules)
        t_search.fence(state)
    meta = {"params_fingerprint": params_fingerprint(params),
            "stats_impl": stats_impl,
            "stats_seconds": t_stats.seconds,
            "search_seconds": t_search.seconds,
            "history": history, **(extra or {})}
    with obs.timer("calibrate.save_bank", arch=arch) as t_save:
        bank = MaskBank.save(out_dir, arch=arch, smoke=smoke, state=state,
                             stats=stats, pcfg=pcfg, cfg=cfg, extra=meta,
                             rules=rules)
    obs.log("calibrate.done", arch=arch, out_dir=str(out_dir),
            stats_seconds=t_stats.seconds, search_seconds=t_search.seconds,
            save_seconds=t_save.seconds)
    return bank


def ensure_bank(out_dir, *, cfg, pcfg: PruneConfig, params: PyTree,
                calib: list[dict], arch: str, smoke: bool, **kw):
    """Load the bank at ``out_dir`` if it matches (same PruneConfig, same
    weights fingerprint); otherwise calibrate and (re)write it."""
    from repro_torch.sparse.bank import MaskBank
    try:
        bank = MaskBank.load(out_dir, cfg=cfg, device=tree.device_of(params))
        if (bank.meta.get("pcfg") == dataclasses.asdict(pcfg)
                and bank.meta.get("params_fingerprint")
                == params_fingerprint(params)):
            return bank
    except (FileNotFoundError, ValueError, KeyError):
        pass  # absent/stale/corrupt bank: calibrate and rewrite
    return calibrate_to_bank(out_dir, cfg=cfg, pcfg=pcfg, params=params,
                             calib=calib, arch=arch, smoke=smoke, **kw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", required=True, help="mask-bank artifact dir")
    ap.add_argument("--metric", default="wanda",
                    choices=["magnitude", "wanda", "ria", "stochria"])
    ap.add_argument("--mode", default="nm",
                    choices=["nm", "unstructured"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--stats-batches", type=int, default=4)
    ap.add_argument("--scan-chunk", type=int, default=8,
                    help="search steps per chunk of the flight recorder's "
                         "trace (the reference's steps per jitted dispatch; "
                         "<= 1: a span per step); the result is the same")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per search step (gradient "
                         "accumulation over batch-dim slices)")
    ap.add_argument("--stats-impl", default="jit", choices=["jit", "tape"],
                    help="jit: the production stats pass; tape: the eager "
                         "StatsTape oracle")
    ap.add_argument("--calib-n", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default=None, choices=[None, "host"],
                    help="'host': shard stats + search state over the "
                         "host mesh of the default process group's ranks "
                         "via dist.sharding rules")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain CPU path)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable the flight recorder and write the JSONL "
                         "event trace (spans, per-chunk search series) + "
                         "a metrics.prom snapshot here")
    ap.add_argument("--xprof-dir", default=None,
                    help="write a torch.profiler Chrome trace here, with a "
                         "record_function mark per pipeline stage")
    args = ap.parse_args(argv)

    rules, made = None, False
    if args.mesh == "host":
        rules, device, made = host_rules(args.device)
    else:
        device = resolve_device(args.device)
    try:
        _run(args, device, rules)
    finally:
        if made:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, device, rules) -> None:
    """The launcher's work on this rank (rank 0 alone records, writes and
    prints)."""
    from repro_torch.analysis import recompile
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import model as M
    lead = rules is None or rules.mesh.rank == 0
    if args.trace_dir and lead:
        obs.configure(trace_dir=args.trace_dir)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(cfg, 0, device=device)
    calib = batches_for(cfg, n=args.calib_n, batch=args.batch, seq=args.seq,
                        split="calib")
    pcfg = PruneConfig(local_metric=args.metric, mode=args.mode,
                       steps=args.steps, stats_batches=args.stats_batches,
                       scan_chunk=args.scan_chunk,
                       grad_accum=args.grad_accum)
    # the sentinel counts rank 0's dispatches only
    with (contextlib.nullcontext() if lead else recompile.paused()), \
            profiling(args.xprof_dir if lead else None, device):
        bank = calibrate_to_bank(args.out, cfg=cfg, pcfg=pcfg, params=params,
                                 calib=calib, arch=args.arch,
                                 smoke=args.smoke,
                                 stats_impl=args.stats_impl,
                                 log_every=args.log_every,
                                 xprof=bool(args.xprof_dir) and lead,
                                 rules=rules)
    if not lead:
        return
    n_pr = sum(g.numel() for g in tree.leaves(bank.Gamma) if g is not None)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"calibrated {args.arch}{' (smoke)' if args.smoke else ''}: "
          f"{pcfg.steps} search steps over {n_pr / 1e6:.2f}M prunable params "
          f"(stats {bank.meta['stats_seconds']:.1f}s via "
          f"{args.stats_impl}, search "
          f"{bank.meta['search_seconds']:.1f}s, "
          f"{pcfg.steps / max(bank.meta['search_seconds'], 1e-9):.2f} "
          f"steps/s)")
    print(f"saved mask bank -> {args.out}")
    if args.trace_dir:
        write_metrics(args.trace_dir)


if __name__ == "__main__":
    main()
