#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device   - the card's name and power limit; TF32 and reduced-precision
              bf16 reductions off for the plain reference paths.
2. build    - the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a).
3. kernels  - each kernel against its plain PyTorch version on the card at
              the main path's shapes, with its device time (CUDA graph of
              back-to-back launches over enough weight copies to defeat the
              50 MB L2), the plain version's, one PyTorch library call's,
              and the least time the card could take (bytes or operations).
4. serve    - the main path at full width: llama3.2-1b (16 layers, d 2048)
              from random weights (``torch.Generator`` seed 0), 2:4 masks by
              ``baseline_masks("magnitude", mode="nm")`` through nm_mask24,
              packed2 compression, ``ServeEngine(slots=4)`` serving 6
              requests of 32-128 prompt tokens x 16 new tokens; launch counts
              asserted; then compressed vs masked-dense logits.
5. bank     - the committed mask bank at smoke width through
              ``MaskBank.load`` and ``ServeEngine.from_artifact``, card
              against CPU.
6. summary  - a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
              line last.

It imports nothing of jax or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # f32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20
# logits: both paths round every activation and the logits to bf16 in
# different summation orders; allow 8 units in the last place of bf16 at the
# scale of the largest logit (the CPU parity tests need <= 4 at 4 layers)
LOGIT_ULPS_FULL = 8
LOGIT_ULPS_SMOKE = 4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float, ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def device_ms(torch, fn, n_calls: int) -> float:
    """Median device time of one ``fn(i)`` call: ``n_calls`` calls captured
    back to back in a CUDA graph, the graph replayed 20 times between CUDA
    events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_calls):      # warm-up: handles, allocator pools
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / n_calls)
    del graph
    return statistics.median(times)


def logit_err(torch, got, want, ulps: int):
    err = float((got.float() - want.float()).abs().max())
    tol = ulps * 2 ** -8 * float(want.float().abs().max())
    return err, tol


# ---------------------------------------------------------------------------
# Phase 3: the kernels against their plain versions
# ---------------------------------------------------------------------------

DECODE_SHAPES = {"wq": (2048, 2048), "wk": (2048, 512), "wv": (2048, 512),
                 "wo": (2048, 2048), "up": (2048, 8192),
                 "gate": (2048, 8192), "down": (8192, 2048)}


def phase_nm_matmul(torch, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                             nm_matmul, nm_matmul_plain)
    from repro_torch.sparse.formats import _pack_idx2
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    rows, max_err = [], 0.0
    for K, N in sorted(set(DECODE_SHAPES.values())):
        w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
        vals, idx = ref.compress_24(w)
        vals = vals.to(torch.bfloat16)
        dense = ref.decompress_24(vals, idx)
        for layout in (LAYOUT_PACKED2, LAYOUT_INT8):
            plane = _pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
            w_bytes = vals.numel() * 2 + plane.numel()
            copies = max(1, -(-2 * L2_BYTES // w_bytes))
            vs = [vals.clone() for _ in range(copies)]
            ps = [plane.clone() for _ in range(copies)]
            ds = [dense.clone() for _ in range(max(1, -(-2 * L2_BYTES
                                                        // (K * N * 2))))]
            for M in (1, 4, 16, 64):
                x = torch.randn((M, K), generator=g, device=dev).to(
                    torch.bfloat16)
                got = nm_matmul(x, vals, plane, layout=layout)
                want = nm_matmul_plain(x, vals, plane, layout=layout)
                got32 = nm_matmul(x, vals, plane, layout=layout,
                                  out_dtype=torch.float32)
                want32 = nm_matmul_plain(x, vals, plane, layout=layout,
                                         out_dtype=torch.float32)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(torch.allclose(got.float(), want.float(), rtol=2e-2,
                                     atol=2e-2),
                      f"nm_matmul {layout} M={M} K={K} N={N}: bf16 max err "
                      f"{err} over rtol=atol=2e-2")
                check(torch.allclose(got32, want32, rtol=1e-4, atol=1e-4),
                      f"nm_matmul {layout} M={M} K={K} N={N}: f32 out "
                      "disagrees with plain at rtol=atol=1e-4")
                max_err = max(max_err, err)
                ms = device_ms(torch, lambda i: nm_matmul(
                    x, vs[i], ps[i], layout=layout), copies)
                plain = device_ms(torch, lambda i: nm_matmul_plain(
                    x, vs[i], ps[i], layout=layout), copies)
                lib = device_ms(torch, lambda i: torch.matmul(
                    x, ds[i % len(ds)]), len(ds))
                b_ms, b_by = bound(M * K * 2 + w_bytes + M * N * 2,
                                   M * N * K, BF16_OPS_PER_S)
                row = {"layout": layout, "M": M, "K": K, "N": N,
                       "max_abs_err": err, "ms": ms, "plain_ms": plain,
                       "library_ms": lib, "bound_ms": b_ms,
                       "bound_by": b_by}
                rows.append(row)
                print(f"  nm_matmul {layout:7s} M={M:3d} K={K:5d} N={N:5d}"
                      f"  err {err:.3e}  kernel {ms * 1e3:9.2f} us"
                      f"  plain {plain * 1e3:9.2f} us"
                      f"  torch.matmul(dense) {lib * 1e3:8.2f} us"
                      f"  bound {b_ms * 1e3:7.2f} us ({b_by})"
                      f"  {b_ms / ms:6.1%} of bound")
            del vs, ps, ds
    layer = [r for r in rows if r["M"] == 4 and r["layout"] == LAYOUT_PACKED2]
    per = {(r["K"], r["N"]): r for r in layer}
    tot = {k: sum(per[kn][k] for kn in DECODE_SHAPES.values())
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"max_abs_err": max_err, **tot, "bound_by": "bytes"
            if all(per[kn]["bound_by"] == "bytes"
                   for kn in DECODE_SHAPES.values()) else "operations"}


def phase_nm_mask24(torch, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_prox import nm_mask24
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    R, N = 16 * 2048, 8192
    s = torch.randn((R, N), generator=g, device=dev)
    # forced ties: integer-valued rows, signed zeros, |s| ties across sign
    s[: R // 2] = torch.randint(-2, 3, (R // 2, N), generator=g,
                                device=dev).float()
    s[0::16] = -0.0
    s[1::16] = 0.0
    s[2::8] = s[3::8].abs()
    got = nm_mask24(s)
    want = ref.nm_mask_ref(s)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    check(mism == 0, f"nm_mask24 differs from its plain version in {mism} "
          "entries")
    ms = device_ms(torch, lambda i: nm_mask24(s), 3)
    plain = device_ms(torch, lambda i: ref.nm_mask_ref(s), 1)
    b_ms, b_by = bound(R * N * 5, 4 * R * N, F32_OPS_PER_S)
    print(f"  nm_mask24 f32 ({R}, {N})  mismatches 0  kernel {ms:.4f} ms"
          f"  plain {plain:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
          f"  {b_ms / ms:.1%} of bound")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}


# ---------------------------------------------------------------------------
# Phase 4: full-width serving through the kernels
# ---------------------------------------------------------------------------

def phase_serve(torch, dev, card: str) -> dict:
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.core.masks import apply_masks
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse.apply import compressed_report, sparsify_params

    cfg = get_config("llama3.2-1b")
    torch.cuda.reset_peak_memory_stats()
    params0 = M.init_params(cfg, 0, device=dev)
    n_params = sum(x.numel() for x in tree.leaves(params0))
    print(f"  llama3.2-1b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n_params} params")
    stats = tree.tree_map(lambda _: None, params0)
    prompt_lens = [32, 128, 48, 96, 64, 80]
    batch = batches_for(cfg, n=1, batch=len(prompt_lens), seq=128,
                        split="valid")[0]["tokens"]
    prompts = [batch[i, :n] for i, n in enumerate(prompt_lens)]
    max_tokens = 16

    # -- the main path, counted ---------------------------------------------
    nm_matmul.launches = nm_mask24.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = baseline_masks("magnitude", params0, stats, 0.5, mode="nm")
    sparse = sparsify_params(params0, masks, axes=M.param_axes(cfg),
                             idx_bits=2, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    eng = ServeEngine(cfg, sparse, slots=4, capacity=256, device=dev)
    rids = [eng.submit(p, max_tokens) for p in prompts]
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {"nm_matmul": nm_matmul.launches,
                "nm_mask24": nm_mask24.launches}
    # -----------------------------------------------------------------------
    print(f"  main path launches: {launches} over {eng.prefill_calls} "
          f"prefills + {eng.decode_steps} decode steps")
    check(all(len(out[r]) == max_tokens for r in rids),
          f"requests finished with {[len(out[r]) for r in rids]} tokens")
    check(launches["nm_mask24"] == 7,
          f"nm_mask24 launched {launches['nm_mask24']} times, want 7")
    # one launch per prunable projection (wq wk wv wo up gate down) per
    # layer, per prefill forward and per decode step
    want = 7 * cfg.num_layers * (eng.decode_steps + eng.prefill_calls)
    check(launches["nm_matmul"] == want,
          f"nm_matmul launched {launches['nm_matmul']} times, want {want}")
    rep = compressed_report(sparse, masks)
    check(rep["fallback_leaves"] == 0 and rep["kernel_native_packed"] == 7,
          f"compression: {rep['fallback_leaves']} fallbacks")
    print(f"  2:4 export + packing {t_export:.2f} s; compressed weights "
          f"{rep['bytes_compressed'] / 1e9:.3f} GB vs "
          f"{rep['bytes_dense_bf16'] / 1e9:.3f} GB dense bf16 "
          f"(ratio {rep['ratio']:.4f})")
    n_tok = len(rids) * max_tokens
    print(f"  engine: {len(rids)} requests x {max_tokens} tokens in "
          f"{t_serve:.3f} s (first run, cold) = {n_tok / t_serve:.1f} tok/s")

    # -- steady-state timings (host clock around synchronised work) ---------
    with torch.inference_mode():
        rids = [eng.submit(p, max_tokens) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        toks = torch.from_numpy(batch[:1]).to(dev)
        pre = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.prefill(cfg, eng.params, {"tokens": toks}, cache_capacity=256)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        caches = M.init_caches(cfg, 4, 256, device=dev)
        tok = torch.from_numpy(batch[:4, 0]).to(dev)
        steps = []
        for i in range(24):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = M.decode_step(cfg, eng.params, tok, caches, i)
            tok = logits.argmax(-1)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        # the step's device work alone: one decode step captured in a CUDA
        # graph and replayed, so no host launch gap sits between kernels
        t_dev = torch.full((4,), 30, dtype=torch.int32, device=dev)
        step_dev_ms = device_ms(torch, lambda i: M.decode_step(
            cfg, eng.params, tok, caches, t_dev), 1)
    step_ms = statistics.median(steps[4:]) * 1e3
    prefill_ms = statistics.median(pre) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{card}] prefill 1x128 {prefill_ms:.2f} ms; decode "
          f"{step_ms:.2f} ms/step at 4 slots = {4e3 / step_ms:.1f} tok/s; "
          f"engine (warm) {n_tok / t_warm:.1f} tok/s; max memory allocated "
          f"{peak / 2 ** 30:.2f} GiB")
    print(f"  decode step device time under a CUDA graph {step_dev_ms:.3f} ms"
          f" = {step_dev_ms / step_ms:.1%} of the eager step (the rest is "
          "host time between launches)")

    # -- compressed vs plain masked-dense, same fed tokens ------------------
    masked = M.serving_params(apply_masks(params0, masks))
    del masks
    prompt = torch.from_numpy(batches_for(cfg, n=1, batch=4, seq=64,
                                          split="valid", start=1)[0]
                              ["tokens"]).to(dev)
    with torch.inference_mode():
        lc, cc = M.prefill(cfg, eng.params, {"tokens": prompt},
                           cache_capacity=96)
        lm, cm_ = M.prefill(cfg, masked, {"tokens": prompt},
                            cache_capacity=96)
        pairs = [(lc, lm)]
        for i in range(8):
            tok = lm.argmax(-1)
            lc, cc = M.decode_step(cfg, eng.params, tok, cc, 64 + i)
            lm, cm_ = M.decode_step(cfg, masked, tok, cm_, 64 + i)
            pairs.append((lc, lm))
    worst, agree = 0.0, 0
    for got, want_l in pairs:
        err, tol = logit_err(torch, got, want_l, LOGIT_ULPS_FULL)
        check(bool(torch.isfinite(got).all()), "non-finite logits")
        check(err <= tol, f"compressed vs masked-dense logits: max err "
              f"{err} over {tol} ({LOGIT_ULPS_FULL} bf16 ulps of the max)")
        worst = max(worst, err / tol)
        agree += int((got.argmax(-1) == want_l.argmax(-1)).sum())
    total = len(pairs) * pairs[0][0].shape[0]
    print(f"  compressed vs masked-dense (prefill + 8 decode steps, 4 rows): "
          f"worst err {worst:.2f} of tolerance; greedy token agreement "
          f"{agree}/{total}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the committed bank, card against CPU
# ---------------------------------------------------------------------------

def phase_bank(torch, dev) -> None:
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse.bank import MaskBank

    bank_dir = ROOT / "results" / "bank" / "llama3.2-1b"
    cfg = get_smoke_config("llama3.2-1b")
    params0 = M.init_params(cfg, 0, device="cpu")
    on_card = MaskBank.load(bank_dir, device=dev).masks_at(nm=(2, 4))
    on_cpu = MaskBank.load(bank_dir, device="cpu").masks_at(nm=(2, 4))
    for (path, a), (_, b) in zip(tree.flatten_with_path(on_card),
                                 tree.flatten_with_path(on_cpu), strict=True):
        check((a is None) == (b is None)
              and (a is None or torch.equal(a.cpu(), b)),
              f"bank masks differ between card and CPU at {path}")
    nm_matmul.launches = nm_mask24.launches = 0
    engines = [ServeEngine.from_artifact(bank_dir, params0, slots=2,
                                         capacity=64, device=d)
               for d in (dev, "cpu")]
    toks = batches_for(cfg, n=1, batch=3, seq=40, split="valid")[0]["tokens"]
    reqs = [(toks[0, :9], 6), (toks[1, :40], 3), (toks[2, :17], 8)]
    streams = []
    for eng in engines:
        rids = [eng.submit(p, m) for p, m in reqs]
        res = eng.run()
        streams.append([res[r] for r in rids])
    launches = {"nm_matmul": nm_matmul.launches,
                "nm_mask24": nm_mask24.launches}
    per_forward = 7 * cfg.num_layers     # wq wk wv wo up gate down
    check(launches["nm_mask24"] == 7 and launches["nm_matmul"] == per_forward
          * (engines[0].decode_steps + engines[0].prefill_calls),
          f"bank path launches {launches}")
    same = sum(a == b for x, y in zip(*streams) for a, b in zip(x, y))
    n = sum(m for _, m in reqs)
    # teacher-forced logits of both engines' params on the CPU stream
    prompt = torch.from_numpy(toks[:, :16])
    feed = torch.tensor(streams[1][0][:4])
    worst = 0.0
    with torch.inference_mode():
        outs = []
        for eng in engines:
            d = eng.device
            lg, c = M.prefill(cfg, eng.params, {"tokens": prompt.to(d)},
                              cache_capacity=32)
            seq = [lg.cpu()]
            for i in range(4):
                lg, c = M.decode_step(cfg, eng.params,
                                      feed[i].expand(3).to(d), c, 16 + i)
                seq.append(lg.cpu())
            outs.append(seq)
    for got, want in zip(*outs):
        err, tol = logit_err(torch, got, want, LOGIT_ULPS_SMOKE)
        check(err <= tol, f"bank engine logits card vs CPU: {err} > {tol}")
        worst = max(worst, err / tol)
    print(f"  bank {bank_dir.name}: masks_at(nm=(2,4)) card == CPU; "
          f"from_artifact launches {launches}; greedy token agreement "
          f"card vs CPU {same}/{n}; logits worst err {worst:.2f} of "
          f"tolerance ({LOGIT_ULPS_SMOKE} bf16 ulps of the max)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    print("[1/6] device")
    card = card_line()
    print("  card (name, power limit):")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("  torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False, "
          "allow_bf16_reduced_precision_reduction = False")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}")

    print("[2/6] build")
    from repro_torch.kernels._build import library
    t0 = time.perf_counter()
    library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    print(f"[3/6] kernels against their plain versions [{card}]")
    mm = phase_nm_matmul(torch, dev)
    mask = phase_nm_mask24(torch, dev)

    torch.cuda.empty_cache()
    print(f"[4/6] full-width llama3.2-1b 2:4 serving [{card}]")
    launches = phase_serve(torch, dev, card)

    print("[5/6] committed mask bank at smoke width, card vs CPU")
    phase_bank(torch, dev)

    print("[6/6] summary")
    kernels = [
        {"name": "nm_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/nm_spmm.cu",
         "replaces": "src/repro/kernels/nm_spmm.py:126",
         "launches": launches["nm_matmul"], **mm,
         "work": "one decode layer: wq, wk, wv, wo, up, gate, down at M=4 "
                 "(4 slots), packed2, bf16"},
        {"name": "nm_mask24", "route": "cuda",
         "source": "src/repro_torch/csrc/nm_mask24.cu",
         "replaces": "src/repro/kernels/nm_prox.py:82",
         "launches": launches["nm_mask24"], **mask,
         "work": "f32 scores (16*2048, 8192) -> bool keep-mask"},
    ]
    print(f"  {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
