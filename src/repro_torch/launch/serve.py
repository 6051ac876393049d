"""Batched serving driver: prefill a batch of prompts, then decode tokens.

Port of ``repro.launch.serve``:

* dense: random weights from ``torch.Generator`` seed 0;
* ``--sparse [--save-artifact DIR]``: calibrate 2:4 (wanda, 30 steps)
  through ``launch.calibrate.calibrate_to_bank`` and serve the bank's
  masks masked-dense; the bank goes to a temporary directory, removed once
  the masks are out, unless ``--save-artifact`` pins it;
* ``--sparse-artifact DIR [--sparsity S]``: load the mask bank,
  re-threshold to masks in one shot, and serve 2:4-compressed weights
  through the ``nm_matmul`` kernel (``--weight-format masked`` serves the
  same masks masked-dense, for A/B checks; ``--idx-bits 8`` stores the
  int8 index plane);
* ``--sparse-artifact DIR --fleet 0.0,0.5,2:4 [--ab W,W,W | --spec
  draft:2:4,verify:0.0,k:4] [--slots N]``: N budgets from the one bank
  behind one router (``serve.fleet.SparsityFleet``), tagged round-robin,
  A/B weighted or self-speculative, and its report;
* ``--temperature T``: decode step i samples ``categorical(key(100 + i),
  logits / T)`` (``core.prng``, jax's stream) instead of the argmax; the
  prefill's token stays the argmax, as the reference's;
* ``--trace-dir D``: the flight recorder on, ``D/events.jsonl`` (the
  ``launch.prefill`` / ``launch.decode`` timers, a ``serve.decode_step``
  span a step; the engines' and fleet's series with ``--fleet``) and
  ``D/metrics.prom`` written at exit; ``--xprof-dir X``: a
  ``torch.profiler`` Chrome trace (CPU and, on the card, CUDA
  activities) in X, the prefill under ``record_function("prefill")`` and
  each decode step under ``record_function("decode")`` with its step
  number.

Runs on the card; ``--device cpu`` runs the plain CPU path.  Any ported
arch serves: ``llama3.2-1b``, ``mixtral-8x22b`` (MoE, sliding window),
``yi-6b``, ``gemma2-2b`` (softcaps, sandwich norms), ``gemma3-1b``
(QK-norm, 5:1 local:global), ``deepseek-v2-lite-16b`` (MLA, 64 routed
experts top-6 and 2 shared, a dense first layer), ``zamba2-7b`` (Mamba2
layers and one weight-shared attention block with per-layer LoRA) and
``xlstm-125m`` (mLSTM / sLSTM, no attention), ``whisper-small``
(encoder-decoder: the batch's stub ``frames`` through the encoder, the
decoder's cross-attention over it) and ``pixtral-12b`` (the batch's stub
``patches`` as a ``num_image_tokens`` prefix before the prompt).
Whisper has no engine, fleet or spec path, as in the reference:
``--fleet`` refuses it.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --sparse-artifact results/bank/llama3.2-1b --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --sparse --save-artifact /tmp/bank --temperature 0.8 \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --smoke --sparse --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --sparse-artifact results/bank/llama3.2-1b \
      --fleet 0.0,0.5,2:4 --spec draft:2:4,verify:0.0,k:4 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import batches_for
from repro_torch.device import resolve_device
from repro_torch.launch.calibrate import profiling, write_metrics
from repro_torch.models import model as M


def _step_annotation(name: str, step: int, annotate: bool):
    """``record_function(name)`` with the step number while
    ``--xprof-dir`` profiles (the reference's ``StepTraceAnnotation``),
    else nothing."""
    if not annotate:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name, str(step))


def _calibrate_sparse(cfg, args, params):
    """2:4 UniPruning through the ``launch.calibrate`` entry point: the
    calibration always lands as a MaskBank artifact (a temporary directory
    unless ``--save-artifact`` pins it) and serving takes the bank's masks,
    masked-dense."""
    import tempfile

    from repro_torch.configs.base import PruneConfig
    from repro_torch.core import masks as masks_mod
    from repro_torch.launch import calibrate as launch_cal
    tmp = None
    if args.save_artifact:
        out = args.save_artifact
    else:   # a transient artifact, removed once the masks are out
        tmp = tempfile.TemporaryDirectory(prefix="mask-bank-")
        out = tmp.name + "/bank"
    try:
        calib = batches_for(cfg, n=8, batch=4, seq=args.prompt_len,
                            split="calib")
        pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=30)
        bank = launch_cal.calibrate_to_bank(
            out, cfg=cfg, pcfg=pcfg, params=params, calib=calib,
            arch=args.arch, smoke=args.smoke)
        if args.save_artifact:
            print(f"saved mask bank -> {out}")
        print("serving 2:4-pruned weights (masked-dense, bank-backed "
              "calibration)")
        return masks_mod.apply_masks(params, bank.masks_at())
    finally:
        if tmp is not None:
            tmp.cleanup()


def _next_tokens(logits: torch.Tensor, temperature: float, i: int
                 ) -> torch.Tensor:
    """Decode step i's tokens: the argmax, or with a temperature the
    reference's ``jax.random.categorical(jax.random.key(100 + i),
    logits / T)``."""
    if temperature <= 0:
        return logits.argmax(dim=-1)
    from repro_torch.core import prng
    # a device divisor: a CUDA tensor divided by a Python float is
    # multiplied by its reciprocal, which is not the reference's division
    t = torch.full((), temperature, dtype=logits.dtype, device=logits.device)
    return prng.categorical(prng.key(100 + i), logits / t)


def generate(cfg, params, batch, gen: int, *, temperature: float = 0.0,
             xprof: bool = False, kv_shards: int | None = None):
    """Prefill a batch of (B, P) prompts (a dict with ``tokens``, and
    whisper's ``frames`` or pixtral's ``patches``; or the token tensor
    alone), then decode ``gen - 1`` steps at a capacity of P + gen plus
    the image prefix's tokens, each step at position P + its index past
    that prefix, as the reference's loop: (tokens (B, gen) on the host,
    prefill seconds, decode seconds).  The prefill's token is the argmax;
    each decode step's is :func:`_next_tokens`'s.  ``kv_shards``: the
    decode attention path (``models.model.decode_step``; whisper's cross
    slots are the encoder's length, which it must divide too).  The
    stages are ``obs.timer``s (``launch.prefill``, ``launch.decode``)
    fenced on their outputs, each decode step a ``serve.decode_step``
    span and a ``serve.decode_step_ms`` observation; ``xprof``: each under
    a ``record_function``."""
    device = params["embed"]["table"].device
    if not isinstance(batch, dict):
        batch = {"tokens": batch}
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    B, P = batch["tokens"].shape
    offset = cfg.num_image_tokens if "patches" in batch else 0
    capacity = P + gen + offset
    if kv_shards is not None:
        from repro_torch.kernels.shard import check_kv_shards
        enc_len = batch["frames"].shape[1] if "frames" in batch else 0
        check_kv_shards(kv_shards, M.cache_lengths(cfg, capacity, enc_len),
                        cfg.layer_kinds)
    with torch.inference_mode():
        # work still queued for the weights is not the prefill's
        obs.core.block_until_ready(params)
        with _step_annotation("prefill", 0, xprof), \
                obs.timer("launch.prefill", batch=B, prompt_len=P) as tp:
            logits, caches = M.prefill(cfg, params, batch,
                                       cache_capacity=capacity)
            tok = logits.argmax(dim=-1)
            tp.fence((tok, caches))
        out = [tok.cpu()]
        with obs.timer("launch.decode", steps=gen - 1) as td:
            for i in range(gen - 1):
                sp = obs.span("serve.decode_step")
                with sp, _step_annotation("decode", i + 1, xprof):
                    logits, caches = M.decode_step(cfg, params, tok, caches,
                                                   P + offset + i,
                                                   kv_shards=kv_shards)
                    tok = _next_tokens(logits, temperature, i)
                    out.append(tok.cpu())   # host copy: the step's sync
                if sp.seconds is not None:
                    obs.observe("serve.decode_step_ms", sp.seconds * 1e3)
            td.fence(tok)
    return torch.stack(out, dim=1), tp.seconds, td.seconds


def _load_sparse(args, params, device):
    """Bank-backed sparse params: one-shot re-threshold, no calibration."""
    from repro_torch.sparse.apply import compressed_report
    from repro_torch.sparse.bank import MaskBank
    bank = MaskBank.load(args.sparse_artifact, device=device)
    # only the N:M pattern has a compressed execution format
    compressed = (args.weight_format == "compressed"
                  and bank.pcfg.mode == "nm" and args.sparsity is None)
    if args.weight_format == "compressed" and not compressed:
        print("note: unstructured budget -> masked-dense serving "
              "(2:4-compressed execution needs the bank's N:M pattern)")
    sparse, masks = bank.sparse_params(params, sparsity=args.sparsity,
                                       compressed=compressed,
                                       idx_bits=args.idx_bits,
                                       with_masks=True)
    if compressed:
        rep = compressed_report(sparse, masks)
        n_comp = sum(not l["fallback"] for l in rep["layers"])
        print(f"serving from bank {args.sparse_artifact}: "
              f"{n_comp} kernels 2:4-compressed "
              f"({args.idx_bits}-bit index storage, "
              f"{rep['kernel_native_packed']} kernel-native packed planes, "
              f"{rep['fallback_leaves']} masked-dense fallbacks), "
              f"{rep['bytes_compressed'] / 1e6:.2f} MB vs "
              f"{rep['bytes_dense_bf16'] / 1e6:.2f} MB dense bf16 "
              f"(ratio {rep['ratio']:.3f})")
    else:
        print(f"serving from bank {args.sparse_artifact} (masked-dense)")
    return bank.cfg, sparse


def _serve_fleet(args, params, device) -> None:
    """N budgets from one bank behind one router; prints the report."""
    from repro_torch.serve.fleet import SparsityFleet
    budgets = [b for b in args.fleet.split(",") if b]
    capacity = args.prompt_len + args.gen + 1
    fleet = SparsityFleet.from_artifact(
        args.sparse_artifact, params, budgets, slots=args.slots,
        capacity=capacity, idx_bits=args.idx_bits, spec=args.spec,
        device=device)
    batch = batches_for(fleet.cfg, n=1, batch=args.batch,
                        seq=args.prompt_len, split="valid")[0]
    prompts = [np.asarray(batch["tokens"][i]) for i in range(args.batch)]
    names = list(fleet.engines)
    if args.spec:
        rids = [fleet.submit(p, args.gen, spec=True) for p in prompts]
        print(f"self-speculative decoding: {args.spec}")
    elif args.ab:
        weights = [float(w) for w in args.ab.split(",")]
        if len(weights) != len(names):
            raise SystemExit(f"--ab needs {len(names)} weights (one per "
                             f"--fleet budget), got {len(weights)}")
        ab = dict(zip(names, weights))
        rids = [fleet.submit(p, args.gen, ab=ab) for p in prompts]
        print(f"A/B split over {names} with weights {weights}")
    else:
        rids = [fleet.submit(p, args.gen, budget=names[i % len(names)])
                for i, p in enumerate(prompts)]
        print(f"tagged round-robin over {names}")
    t0 = time.perf_counter()
    out = fleet.run()
    dt = time.perf_counter() - t0
    rep = fleet.report()
    print(f"fleet served {len(out)} requests x {args.gen} tokens from "
          f"{args.sparse_artifact} in {dt:.2f}s "
          f"(reference: {rep['reference']})")
    for name, r in rep["budgets"].items():
        agree = r["token_agreement_vs_reference"]
        p50, p95 = r["decode_ms_p50"], r["decode_ms_p95"]
        print(f"  {name:>6}: slots {r['slots']}, {r['requests']} reqs, "
              f"{(r['tok_s'] or 0):8.1f} tok/s, "
              f"byte ratio {r['weight_bytes_ratio']:.4f} "
              f"({r['compressed_kernels']} compressed, "
              f"{r['fallback_leaves']} masked-dense), "
              f"shared dense leaves {r['shared_dense_leaves']}"
              + (f", agreement vs ref {agree:.3f}" if agree is not None
                 else "")
              + (f", decode p50/p95 {p50:.2f}/{p95:.2f} ms"
                 if p50 is not None else ""))
    spec = rep["spec"]
    if spec is not None:
        print(f"  spec: {spec['draft']} drafts -> {spec['verify']} "
              f"verifies, k={spec['k']}, "
              f"accept rate {(spec['accept_rate'] or 0):.3f} "
              f"(EMA {spec['accept_ema']:.3f}), "
              f"{(spec['accepted_tokens_per_round'] or 0):.2f} tokens/round "
              f"over {spec['rounds']} rounds, "
              f"{spec['rollbacks']} rollbacks, "
              f"{(spec['tok_s'] or 0):.1f} tok/s")
    print("sample continuation:", out[rids[0]][:16])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--sparse", action="store_true",
                    help="prune 2:4 with UniPruning before serving")
    ap.add_argument("--save-artifact", default=None,
                    help="with --sparse: persist the mask bank here")
    ap.add_argument("--sparse-artifact", default=None,
                    help="serve from a saved mask bank (no calibration)")
    ap.add_argument("--sparsity", type=float, default=None,
                    help="unstructured budget for bank re-threshold "
                         "(default: the bank's calibrated N:M pattern)")
    ap.add_argument("--weight-format", default="compressed",
                    choices=["compressed", "masked"],
                    help="bank serving: 2:4-compressed kernels vs W0*M")
    ap.add_argument("--idx-bits", type=int, default=2, choices=[2, 8],
                    help="compressed index layout: 2 = packed 4-per-byte "
                         "(kernel-native), 8 = int8 plane")
    ap.add_argument("--fleet", default=None,
                    help="with --sparse-artifact: comma-separated budgets "
                         "served concurrently from the one bank behind one "
                         "router, e.g. 0.0,0.5,2:4")
    ap.add_argument("--ab", default=None,
                    help="with --fleet: comma-separated traffic weights "
                         "aligned with the --fleet budgets (default: "
                         "tagged round-robin)")
    ap.add_argument("--spec", default=None,
                    help="with --fleet: self-speculative decoding, e.g. "
                         "draft:2:4,verify:0.0,k:4 (the draft member "
                         "proposes k tokens a round, the verify member "
                         "checks them in one teacher-forced pass; its "
                         "stream is the verifier's own)")
    ap.add_argument("--slots", type=int, default=None,
                    help="fleet decode-slot pool partitioned across "
                         "budgets (default: 2 per budget)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample decode tokens at this temperature "
                         "(0: greedy)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain CPU path)")
    ap.add_argument("--trace-dir", default=None,
                    help="enable the flight recorder and write the JSONL "
                         "event trace + a metrics.prom snapshot here")
    ap.add_argument("--xprof-dir", default=None,
                    help="write a torch.profiler Chrome trace here, with "
                         "record_function marks per prefill/decode step")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.trace_dir:
        obs.configure(trace_dir=args.trace_dir)
    try:
        with profiling(args.xprof_dir, device):
            _serve(args, device)
    finally:
        if args.trace_dir:
            write_metrics(args.trace_dir)


def _serve(args, device) -> None:
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encoder_decoder and args.gen <= 0:
        raise SystemExit("an encoder-decoder model needs --gen > 0")
    params = M.init_params(cfg, 0, device=device)
    if args.spec and not args.fleet:
        raise SystemExit("--spec rides the fleet router: pass --fleet with "
                         "the draft and verify budgets")
    if args.fleet:
        if not args.sparse_artifact:
            raise SystemExit("--fleet serves from a saved mask bank: "
                             "pass --sparse-artifact DIR")
        _serve_fleet(args, params, device)
        return
    if args.sparse_artifact:
        cfg, params = _load_sparse(args, params, device)
    elif args.sparse:
        params = _calibrate_sparse(cfg, args, params)
    params = M.serving_params(params)

    B, P = args.batch, args.prompt_len
    batch = batches_for(cfg, n=1, batch=B, seq=P, split="valid")[0]
    gen, t_prefill, t_decode = generate(cfg, params, batch, args.gen,
                                        temperature=args.temperature,
                                        xprof=bool(args.xprof_dir))
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"prefill {B}x{P} in {t_prefill:.3f}s; "
          f"decoded {args.gen - 1} steps in {t_decode:.3f}s "
          f"({B * (args.gen - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample continuation:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
