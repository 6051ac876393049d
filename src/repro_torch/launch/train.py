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
kernel, so nothing is built.

Over ranks (llama and mixtral): ``--model-axis m`` trains on the host mesh
(world / m, m) of the caller's default process group or ``torchrun``'s
(``env://``), under the production rules, as the reference's launcher
does: each rank holds its blocks of the params and of the AdamW state
and reads the whole global batch, rank 0 alone prints and writes the
checkpoints, and every rank restores its blocks from them.  The ranks
log one process's losses bit for bit.  On the card each rank takes
``cuda:{LOCAL_RANK}``; ``--device cpu`` runs gloo ranks on the CPU:

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-1b --smoke --model-axis 4 --steps 4 --batch 2 \
      --seq 32 --log-every 1 --device cpu

Without a process group, ``--model-axis`` > 1 raises ``ValueError``.
"""
from __future__ import annotations

import argparse
import os
import time

import torch.distributed as dist

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import DataCursor, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import host_rules
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

    # the reference builds its host mesh always; one process without a
    # group keeps the single-process path
    rules, made = None, False
    if (args.model_axis != 1 or dist.is_initialized()
            or "WORLD_SIZE" in os.environ):
        rules, device, made = host_rules(args.device, model=args.model_axis)
    else:
        device = resolve_device(args.device)
    try:
        return _run(args, device, rules)
    finally:
        if made:
            dist.destroy_process_group()


def _run(args, device, rules) -> dict:
    """The launcher's work on this rank (rank 0 alone prints and writes)."""
    lead = rules is None or rules.mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 10, 1))
    step_fn = make_train_step(cfg, ocfg, accum=args.accum, remat=True,
                              rules=rules)
    params = M.init_params(cfg, 0, device=device, rules=rules)
    ostate = opt.adamw_init(params)

    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    try:
        if mgr and mgr.latest_step() is not None:
            (params, ostate), meta = mgr.restore((params, ostate),
                                                 rules=rules)
            start = meta["next_step"]
            say(f"resumed at step {start}")

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
                say(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                    f"({log[-1][3]:.1f}s)", flush=True)
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, (params, ostate),
                               metadata={"next_step": step + 1}, rules=rules)
        if mgr:
            mgr.save(args.steps, (params, ostate),
                     metadata={"next_step": args.steps}, rules=rules)
    finally:
        if mgr:
            mgr.close()
    say("done:", float(metrics["loss"]) if metrics else None)
    return {"params": params, "ostate": ostate, "log": log}


if __name__ == "__main__":
    main()
