"""Training launcher.  Port of ``repro.launch.train``.

Trains with AdamW (remat on, as the reference's launcher sets it) on the
synthetic corpus, logs ``step N loss ... gnorm ... (...s)``, checkpoints
``(params, AdamWState)`` atomically every --ckpt-every steps and at the
end, and resumes (weights, optimizer state, data cursor) from
--ckpt-dir's latest checkpoint.  The checkpoints are the reference's
format: either package resumes the other's.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --steps 20 --batch 8 --seq 256 --ckpt-dir build/run1 \
      --device cpu

Runs on the card; ``--device cpu`` runs on the CPU.  The params come from
``models.model.init_params`` seed 0 (``torch.Generator``), not the
reference's threefry init.  The training path launches no hand-written
kernel, so nothing is built.  ``--model-axis`` other than 1 (tensor
parallelism over several cards) raises: ROADMAP A item 7.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import DataCursor, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import optimizers as opt


def main(argv=None) -> dict:
    """Run the launcher; also returns ``{"params", "ostate", "log"}`` for
    callers in Python: the final state and, per logged step, ``(step,
    loss, grad_norm, seconds since the loop started)`` as printed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs on "
                         "the CPU)")
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        raise NotImplementedError(
            f"--model-axis {args.model_axis}: tensor parallelism over "
            "several cards is not ported yet (ROADMAP A item 7)")

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1))
    params = M.init_params(cfg, 0, device=device)
    ostate = opt.adamw_init(params)
    step_fn = make_train_step(cfg, ocfg, accum=args.accum, remat=True)

    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    try:
        if mgr and mgr.latest_step() is not None:
            (params, ostate), meta = mgr.restore((params, ostate))
            start = meta["next_step"]
            print(f"resumed at step {start}")

        loader = ShardedLoader(cfg, global_batch=args.batch, seq=args.seq,
                               cursor=DataCursor(index=start))
        log, metrics = [], None
        t0 = time.time()
        for step in range(start, args.steps):
            params, ostate, metrics = step_fn(params, ostate, next(loader))
            if step % args.log_every == 0:
                # the log line is the one host read: the progress heartbeat
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                log.append((step, loss, gnorm, time.time() - t0))
                print(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                      f"({log[-1][3]:.1f}s)", flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, (params, ostate),
                               metadata={"next_step": step + 1})
        if mgr:
            mgr.save(args.steps, (params, ostate),
                     metadata={"next_step": args.steps})
    finally:
        if mgr:
            mgr.close()
    print("done:", float(metrics["loss"]) if metrics else None)
    return {"params": params, "ostate": ostate, "log": log}


if __name__ == "__main__":
    main()
