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
``llama3.2-1b``, ``mixtral-8x22b``, ``yi-6b``, ``gemma2-2b``, ``gemma3-1b``.

Runs on the card; ``--device cpu`` runs the plain CPU path.  Stage seconds
are host clocks around work fenced with ``torch.cuda.synchronize``.
``--stats-impl tape`` takes the stats from the eager ``StatsTape`` oracle
instead of the production pass (recorded as the bank's ``stats_impl``).
The reference's ``--mesh``, ``--trace-dir`` and ``--xprof-dir`` come with
the multi-card and observability slices.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import torch

from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_config, get_smoke_config
from repro_torch.device import resolve_device

PyTree = Any


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def params_fingerprint(params: PyTree) -> str:
    """Order-stable crc32 of the weights a bank was calibrated against."""
    from repro_torch.sparse.bank import _tree_checksum
    return _tree_checksum(params)


def calibrate_to_bank(out_dir, *, cfg, pcfg: PruneConfig, params: PyTree,
                      calib: list[dict], arch: str, smoke: bool,
                      stats_impl: str = "jit", log_every: int = 0,
                      loss_fn=None, extra: dict | None = None):
    """Run the full calibration once and write the MaskBank artifact.

    Returns the in-memory :class:`~repro_torch.sparse.bank.MaskBank`
    backed by the artifact just written to ``out_dir``; its meta records
    the stage seconds and the search history."""
    from repro_torch.core import calibrate
    from repro_torch.sparse.bank import MaskBank
    device = tree.device_of(params)
    _sync(device)
    t0 = time.perf_counter()
    stats = calibrate.collect_stats(cfg, params, calib, pcfg=pcfg,
                                    impl=stats_impl)
    _sync(device)
    t_stats = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, history = calibrate.run_search(cfg, pcfg, params, calib, stats,
                                          log_every=log_every,
                                          loss_fn=loss_fn)
    _sync(device)
    t_search = time.perf_counter() - t0
    meta = {"params_fingerprint": params_fingerprint(params),
            "stats_impl": stats_impl,
            "stats_seconds": t_stats,
            "search_seconds": t_search,
            "history": history, **(extra or {})}
    return MaskBank.save(out_dir, arch=arch, smoke=smoke, state=state,
                         stats=stats, pcfg=pcfg, cfg=cfg, extra=meta)


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
                    help="kept in the bank's PruneConfig (the reference's "
                         "steps per jitted dispatch); no effect here")
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain CPU path)")
    args = ap.parse_args(argv)

    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import model as M
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(cfg, 0, device=device)
    calib = batches_for(cfg, n=args.calib_n, batch=args.batch, seq=args.seq,
                        split="calib")
    pcfg = PruneConfig(local_metric=args.metric, mode=args.mode,
                       steps=args.steps, stats_batches=args.stats_batches,
                       scan_chunk=args.scan_chunk,
                       grad_accum=args.grad_accum)
    bank = calibrate_to_bank(args.out, cfg=cfg, pcfg=pcfg, params=params,
                             calib=calib, arch=args.arch, smoke=args.smoke,
                             stats_impl=args.stats_impl,
                             log_every=args.log_every)
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


if __name__ == "__main__":
    main()
