"""Batched serving driver: prefill a batch of prompts, then decode tokens.

Port of ``repro.launch.serve`` for the dense path and bank-backed sparse
serving (``--sparse`` calibration, ``--fleet`` and ``--spec`` come with
their slices):

* dense: random weights from ``torch.Generator`` seed 0;
* ``--sparse-artifact DIR [--sparsity S]``: load the mask bank,
  re-threshold to masks in one shot, and serve 2:4-compressed weights
  through the ``nm_matmul`` kernel (``--weight-format masked`` serves the
  same masks masked-dense, for A/B checks; ``--idx-bits 8`` stores the
  int8 index plane).

Runs on the card; ``--device cpu`` runs the plain CPU path.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --sparse-artifact results/bank/llama3.2-1b --gen 16
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import batches_for
from repro_torch.device import resolve_device
from repro_torch.models import model as M


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain CPU path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = M.init_params(cfg, 0, device=device)
    if args.sparse_artifact:
        cfg, params = _load_sparse(args, params, device)
    params = M.serving_params(params)

    B, P = args.batch, args.prompt_len
    toks = torch.from_numpy(batches_for(cfg, n=1, batch=B, seq=P,
                                        split="valid")[0]["tokens"])
    capacity = P + args.gen
    with torch.inference_mode():
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = M.prefill(cfg, params, {"tokens": toks.to(device)},
                                   cache_capacity=capacity)
        tok = logits.argmax(dim=-1)
        out = [tok.cpu()]
        t_prefill = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(args.gen - 1):
            logits, caches = M.decode_step(cfg, params, tok, caches, P + i)
            tok = logits.argmax(dim=-1)
            out.append(tok.cpu())   # host copy: the step's sync point
        t_decode = time.perf_counter() - t0
    gen = torch.stack(out, dim=1)
    print(f"device {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(f"prefill {B}x{P} in {t_prefill:.3f}s; "
          f"decoded {args.gen - 1} steps in {t_decode:.3f}s "
          f"({B * (args.gen - 1) / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample continuation:", gen[0][:16].tolist())


if __name__ == "__main__":
    main()
