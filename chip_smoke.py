#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device   - the card's name and power limit; TF32 and reduced-precision
              bf16 reductions off for the plain reference paths.
2. build    - the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
              source, all started together, sm_90a).
3. kernels  - each kernel against its plain PyTorch version on the card at
              each main path's shapes, with its device time (CUDA graph of
              back-to-back launches over enough weight bytes to defeat the
              50 MB L2), the plain version's, one PyTorch library call's,
              and the least time the card could take (bytes or operations).
4. llama    - the first main path at full width: llama3.2-1b (16 layers,
              d 2048) from random weights (``torch.Generator`` seed 0), 2:4
              masks by ``baseline_masks("magnitude", mode="nm")`` through
              nm_mask24, packed2 compression, ``ServeEngine(slots=4)``
              serving 6 requests of 32-128 prompt tokens x 16 new tokens;
              launch counts asserted; the first kernel call at every
              distinct shape of the run held against its plain version;
              then compressed vs masked-dense logits.
5. mixtral  - the MoE main path at full width: mixtral-8x22b cut from 56 to
              2 layers (memory) and nothing else, through the same phase,
              every expert bank through nm_matmul_expert; the routing of
              compressed and masked-dense compared too.
6. bank     - the committed mask bank at smoke width through
              ``MaskBank.load`` and ``ServeEngine.from_artifact``, card
              against CPU.
7. summary  - a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
              line last.

It imports nothing of jax or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
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

# Each main path's 2-D projections, (K, N), and the row counts M timed for
# them: M = 4 is decode (4 slots); the larger ones are prefills.  A prompt
# of n tokens prefills n - 1 (its last token feeds the first decode step),
# bucketed to a power of two for llama and exact for the MoE kinds, so the
# 32-128-token prompts give llama M = 32-128 and mixtral M = 31-127.
NM_MATMUL_SHAPES = {
    "llama3.2-1b": ({"wq": (2048, 2048), "wk": (2048, 512),
                     "wv": (2048, 512), "wo": (2048, 2048),
                     "up": (2048, 8192), "gate": (2048, 8192),
                     "down": (8192, 2048)}, (1, 4, 16, 64)),
    "mixtral-8x22b": ({"wq": (6144, 6144), "wk": (6144, 1024),
                       "wv": (6144, 1024), "wo": (6144, 6144)},
                      (1, 4, 31, 127)),
}
# mixtral-8x22b's expert banks, (K, N) per expert, its expert count, and
# the capacities C (rows per expert) its kernel calls see: 4 at decode
# (4 slots), 16-40 for prefills of 31-127 tokens
EXPERT_SHAPES = {"up": (6144, 16384), "gate": (6144, 16384),
                 "down": (16384, 6144)}
EXPERTS = 8
EXPERT_MS = (1, 4, 16, 24, 32, 40)
BF16_TOL, F32_TOL = 2e-2, 1e-4     # rtol = atol, kernel against plain


def _layer_totals(rows: list, shapes: dict) -> dict:
    """One decode layer (M = 4, packed2): the sums over its projections."""
    per = {(r["K"], r["N"]): r for r in rows
           if r["M"] == 4 and r["layout"] == "packed2"}
    tot = {k: sum(per[kn][k] for kn in shapes.values())
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {per[kn]["bound_by"] for kn in shapes.values()}
    return {**tot, "bound_by": "bytes" if by == {"bytes"} else "operations"}


def phase_nm_matmul(torch, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                             nm_matmul, nm_matmul_plain)
    from repro_torch.sparse.formats import _pack_idx2
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    max_err, by_path = 0.0, {}
    for path, (shapes, ms_) in NM_MATMUL_SHAPES.items():
        path_rows = []
        for K, N in sorted(set(shapes.values())):
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
                ds = [dense.clone() for _ in range(
                    max(1, -(-2 * L2_BYTES // (K * N * 2))))]
                for M in ms_:
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
                    check(torch.allclose(got.float(), want.float(),
                                         rtol=BF16_TOL, atol=BF16_TOL),
                          f"nm_matmul {layout} M={M} K={K} N={N}: bf16 max "
                          f"err {err} over rtol=atol={BF16_TOL}")
                    check(torch.allclose(got32, want32, rtol=F32_TOL,
                                         atol=F32_TOL),
                          f"nm_matmul {layout} M={M} K={K} N={N}: f32 out "
                          f"disagrees with plain at rtol=atol={F32_TOL}")
                    max_err = max(max_err, err)
                    ms = device_ms(torch, lambda i: nm_matmul(
                        x, vs[i], ps[i], layout=layout), copies)
                    plain = device_ms(torch, lambda i: nm_matmul_plain(
                        x, vs[i], ps[i], layout=layout), copies)
                    lib = device_ms(torch, lambda i: torch.matmul(
                        x, ds[i % len(ds)]), len(ds))
                    b_ms, b_by = bound(M * K * 2 + w_bytes + M * N * 2,
                                       M * N * K, BF16_OPS_PER_S)
                    path_rows.append({
                        "layout": layout, "M": M, "K": K, "N": N,
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "library_ms": lib, "bound_ms": b_ms,
                        "bound_by": b_by})
                    print(f"  nm_matmul {layout:7s} M={M:3d} K={K:5d} "
                          f"N={N:5d}  err {err:.3e}  kernel {ms * 1e3:9.2f}"
                          f" us  plain {plain * 1e3:9.2f} us  torch.matmul"
                          f"(dense) {lib * 1e3:8.2f} us  bound "
                          f"{b_ms * 1e3:7.2f} us ({b_by})  {b_ms / ms:6.1%}"
                          " of bound")
                del vs, ps, ds
        by_path[path] = _layer_totals(path_rows, shapes)
        print(f"  nm_matmul, one {path} decode layer (M=4, packed2): kernel "
              f"{by_path[path]['ms']:.4f} ms, bound "
              f"{by_path[path]['bound_ms']:.4f} ms")
    return {"max_abs_err": max_err, **by_path["llama3.2-1b"],
            "by_path": by_path}


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


def phase_nm_matmul_expert(torch, dev) -> dict:
    """E = 8 experts at the capacities of mixtral's main path; both banks,
    both layouts."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                             nm_matmul_expert,
                                             nm_matmul_expert_plain)
    from repro_torch.sparse.formats import _pack_idx2
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    E, rows, max_err = EXPERTS, [], 0.0
    for K, N in sorted(set(EXPERT_SHAPES.values())):
        comp = [ref.compress_24(torch.randn((K, N), generator=g, device=dev)
                                * K ** -0.5) for _ in range(E)]
        vals = torch.stack([v for v, _ in comp]).to(torch.bfloat16)
        idx = torch.stack([i for _, i in comp])
        del comp
        dense = ref.decompress_24(vals, idx)      # masked-dense bank, bf16
        for layout in (LAYOUT_PACKED2, LAYOUT_INT8):
            plane = _pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
            w_bytes = vals.numel() * 2 + plane.numel()
            for M in EXPERT_MS:
                x = torch.randn((E, M, K), generator=g, device=dev).to(
                    torch.bfloat16)
                got = nm_matmul_expert(x, vals, plane, layout=layout)
                want = nm_matmul_expert_plain(x, vals, plane, layout=layout)
                got32 = nm_matmul_expert(x, vals, plane, layout=layout,
                                         out_dtype=torch.float32)
                want32 = nm_matmul_expert_plain(x, vals, plane,
                                                layout=layout,
                                                out_dtype=torch.float32)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                check(torch.allclose(got.float(), want.float(),
                                     rtol=BF16_TOL, atol=BF16_TOL),
                      f"nm_matmul_expert {layout} M={M} K={K} N={N}: bf16 "
                      f"max err {err} over rtol=atol={BF16_TOL}")
                err32 = float((got32 - want32).abs().max())
                check(torch.allclose(got32, want32, rtol=F32_TOL,
                                     atol=F32_TOL),
                      f"nm_matmul_expert {layout} M={M} K={K} N={N}: f32 "
                      f"out max err {err32} over rtol=atol={F32_TOL}")
                max_err = max(max_err, err)
                del got, want, got32, want32
                # one bank is 18x the L2: back-to-back calls read it cold
                ms = device_ms(torch, lambda i: nm_matmul_expert(
                    x, vals, plane, layout=layout), 5)
                plain = device_ms(torch, lambda i: nm_matmul_expert_plain(
                    x, vals, plane, layout=layout), 1)
                torch.cuda.empty_cache()
                lib = device_ms(torch, lambda i: torch.bmm(x, dense), 5)
                b_ms, b_by = bound(E * M * K * 2 + w_bytes + E * M * N * 2,
                                   E * M * N * K, BF16_OPS_PER_S)
                rows.append({"layout": layout, "M": M, "K": K, "N": N,
                             "max_abs_err": err, "ms": ms,
                             "plain_ms": plain, "library_ms": lib,
                             "bound_ms": b_ms, "bound_by": b_by})
                print(f"  nm_matmul_expert {layout:7s} E={E} M={M:2d} "
                      f"K={K:5d} N={N:5d}  err {err:.3e}  kernel "
                      f"{ms:8.4f} ms  plain {plain:8.4f} ms  torch.bmm"
                      f"(dense) {lib:8.4f} ms  bound {b_ms:7.4f} ms "
                      f"({b_by})  {b_ms / ms:6.1%} of bound")
        del vals, idx, dense, plane
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **_layer_totals(rows, EXPERT_SHAPES)}


# ---------------------------------------------------------------------------
# Phases 4-5: each main path at full width, served through the kernels
# ---------------------------------------------------------------------------

# mixtral-8x22b's 56 layers cut to 2, and nothing else: per layer the f32
# init takes 10.0 GB, the bool masks 2.5 GB, the compressed weights 2.8 GB
# and the masked-dense bf16 weights 5.0 GB, so two layers, embed and
# lm_head peak near 45 GB of the card's 80, and four would not fit
MIXTRAL_LAYERS = 2
MAX_REROUTED_ROWS = 2      # of 36 (4 rows x (prefill + 8 decode steps))
PATH_KERNELS = ("nm_matmul", "nm_matmul_expert")


def _routed_sets(ids) -> "torch.Tensor":
    """(G, T, k) expert ids -> (T, k) sorted: the set each token routes to."""
    return ids.reshape(-1, ids.shape[-1]).sort(dim=-1).values


@contextlib.contextmanager
def first_call_per_signature(calls: dict):
    """While open, every call that ``sparse/apply.py`` makes to a 2:4
    kernel wrapper keeps, for the first call at each distinct signature
    (kernel, shapes, dtypes, layout), its inputs and the output the path
    went on with.  The wrappers themselves run and count as usual."""
    from repro_torch.sparse import apply as sparse_apply
    saved = {name: getattr(sparse_apply, name) for name in PATH_KERNELS}

    def recorder(name, fn):
        def call(x, vals, idx, **kw):
            out = fn(x, vals, idx, **kw)
            key = (name, tuple(x.shape), tuple(idx.shape), x.dtype,
                   kw.get("layout"), kw.get("out_dtype"))
            if key not in calls:
                calls[key] = (x.clone(), vals, idx, kw, out.clone())
            return out
        return call

    for name, fn in saved.items():
        setattr(sparse_apply, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(sparse_apply, name, fn)


def check_path_calls(torch, calls: dict) -> str:
    """Hold each recorded kernel output against the plain version on the
    same inputs: the kernel phase's rtol = atol per output, plus the room
    that f32 sums taken in another order need where the output cancels.

    The kernel phase's random operands give outputs of the size of their
    terms.  The path's do not: an expert bank is drawn at std 0.88 E^-0.5,
    as the reference draws it, so a down-bank output of ~1e4 is a sum of
    16384 terms whose magnitudes add up to ~1e6, and two summation orders
    differ there by a few f32 ulps of that sum, beyond 2e-2 of an output
    near 0.  Each output may also differ by 2 sqrt(K) f32 ulps of
    sum_k |x_k w_k| (the sqrt(n) rule for recursive summation, doubled).
    One wrong term of typical size, sum/K, is ~4x that at K = 16384.
    """
    from repro_torch.kernels.nm_spmm import (nm_matmul_expert_plain,
                                             nm_matmul_plain)
    plain = {"nm_matmul": nm_matmul_plain,
             "nm_matmul_expert": nm_matmul_expert_plain}
    worst, seen, n_cancel = 0.0, {name: set() for name in PATH_KERNELS}, 0
    for key, (x, vals, idx, kw, got) in calls.items():
        name = key[0]
        want = plain[name](x, vals, idx, **kw).float()
        terms = plain[name](x.abs(), vals.abs(), idx,
                            **{**kw, "out_dtype": torch.float32})
        K = x.shape[-1]
        rtol = F32_TOL if got.dtype == torch.float32 else BF16_TOL
        err = (got.float() - want).abs()
        elementwise = rtol + rtol * want.abs()
        tol = elementwise + 2 * K ** 0.5 * 2 ** -24 * terms
        ratio = float((err / tol).max())
        shape = (*x.shape, vals.shape[-1])      # ([E,] M, K, N)
        cancel = err > elementwise
        n_cancel += int(cancel.sum())
        if cancel.any():
            i = int((err / elementwise).flatten().argmax())
            print(f"    {name} at {shape}: {int(cancel.sum())} outputs past "
                  f"rtol=atol={rtol} alone; the furthest: |plain| "
                  f"{float(want.flatten()[i].abs()):.4g}, err "
                  f"{float(err.flatten()[i]):.4g} = "
                  f"{float(err.flatten()[i] / terms.flatten()[i]) * 2 ** 24:.2f}"
                  f" f32 ulps of sum|x*w| {float(terms.flatten()[i]):.4g}")
        check(ratio <= 1, f"{name} at {shape} on the main path: an output "
              f"differs from its plain version by {ratio:.3f} of the "
              "tolerance")
        worst = max(worst, ratio)
        seen[name].add(shape)
        del want, terms, err, tol
    return (f"{len(calls)} distinct kernel calls, each held against its "
            f"plain version: worst {worst:.3f} of the tolerance, "
            f"{n_cancel} outputs past rtol=atol alone (cancelling sums); "
            + "; ".join(f"{name} at {sorted(s)}"
                        for name, s in seen.items() if s))


def phase_serve(torch, dev, card: str, cfg, per_layer: dict) -> dict:
    """Serve ``cfg`` at its widths from random weights with 2:4 magnitude
    masks; ``per_layer`` is each kernel's launches per layer per forward
    (a prefill or a decode step).  Then compressed against masked-dense,
    routing included where the model has MoE layers."""
    from repro_torch import tree
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse.apply import compressed_report, sparsify_params

    L = cfg.num_layers
    n_moe = sum(k.startswith("moe") for k in cfg.layer_kinds)
    torch.cuda.reset_peak_memory_stats()
    params0 = M.init_params(cfg, 0, device=dev)
    n_params = sum(x.numel() for x in tree.leaves(params0))
    ffn = (f"{cfg.num_experts} experts top-{cfg.top_k}, moe_d_ff "
           f"{cfg.moe_d_ff}" if n_moe else f"d_ff {cfg.d_ff}")
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, "
          f"{ffn}, vocab {cfg.vocab_size}, window {cfg.sliding_window}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'}: {n_params} params")
    stats = tree.tree_map(lambda _: None, params0)
    prompt_lens = [32, 128, 48, 96, 64, 80]
    batch = batches_for(cfg, n=1, batch=len(prompt_lens), seq=128,
                        split="valid")[0]["tokens"]
    prompts = [batch[i, :n] for i, n in enumerate(prompt_lens)]
    max_tokens = 16

    # -- the main path, counted ---------------------------------------------
    calls = {}
    nm_matmul.launches = nm_matmul_expert.launches = nm_mask24.launches = 0
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
    with first_call_per_signature(calls):
        out = eng.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {"nm_matmul": nm_matmul.launches,
                "nm_matmul_expert": nm_matmul_expert.launches,
                "nm_mask24": nm_mask24.launches}
    # -----------------------------------------------------------------------
    forwards = eng.decode_steps + eng.prefill_calls
    print(f"  main path launches: {launches} over {eng.prefill_calls} "
          f"prefills + {eng.decode_steps} decode steps")
    check(all(len(out[r]) == max_tokens for r in rids),
          f"requests finished with {[len(out[r]) for r in rids]} tokens")
    check(launches["nm_mask24"] == 7,
          f"nm_mask24 launched {launches['nm_mask24']} times, want 7")
    for name in PATH_KERNELS:
        want = per_layer[name] * L * forwards
        check(launches[name] == want,
              f"{name} launched {launches[name]} times, want {want}")
    print("  " + check_path_calls(torch, calls))
    del calls
    rep = compressed_report(sparse, masks)
    check(rep["fallback_leaves"] == 0 and rep["kernel_native_packed"] == 7
          and rep["ratio"] == 0.5625,
          f"compression: {rep['fallback_leaves']} fallbacks, ratio "
          f"{rep['ratio']}")
    print(f"  2:4 export + packing {t_export:.2f} s; compressed weights "
          f"{rep['bytes_compressed'] / 1e9:.3f} GB vs "
          f"{rep['bytes_dense_bf16'] / 1e9:.3f} GB dense bf16 "
          f"(ratio {rep['ratio']:.4f})")
    n_tok = len(rids) * max_tokens
    print(f"  engine: {len(rids)} requests x {max_tokens} tokens in "
          f"{t_serve:.3f} s (first run, cold) = {n_tok / t_serve:.1f} tok/s")
    del sparse

    # -- steady-state timings (host clock around synchronised work) ---------
    with torch.inference_mode():
        rids = [eng.submit(p, max_tokens) for p in prompts]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        toks = torch.from_numpy(batch[:1]).to(dev)        # 128 tokens
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
        # where the device time of an eager decode step goes, by kernel
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                logits, caches = M.decode_step(cfg, eng.params, tok, caches,
                                               t_dev)
            torch.cuda.synchronize()
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
    # the kernels themselves (an operator's row would count them twice)
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in evs) / 3
    n_kern = sum(e.count for e in evs) / 3
    print(f"  profiler, 3 eager decode steps: {n_kern:.0f} kernels and "
          f"{dev_us / 1e3:.3f} ms of device time per step; top kernels (us "
          "per step, launches per step):")
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 3:10.1f}  {e.count / 3:5.1f}"
              f"  {e.key[:90]}")

    # -- compressed vs plain masked-dense, same fed tokens ------------------
    masked = M.serving_params(tree.tree_map(
        lambda w, m: w if m is None else (w * m).to(torch.bfloat16),
        params0, masks))
    del masks, params0
    prompt = torch.from_numpy(batches_for(cfg, n=1, batch=4, seq=64,
                                          split="valid", start=1)[0]
                              ["tokens"]).to(dev)
    routed = []
    route = moe_mod.route

    def recording_route(router, x, top_k):
        out = route(router, x, top_k)
        routed.append(_routed_sets(out[2]))
        return out

    moe_mod.route = recording_route
    try:
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
    finally:
        moe_mod.route = route
    check(len(routed) == 2 * n_moe * len(pairs),
          f"recorded {len(routed)} routings, want {2 * n_moe * len(pairs)}")
    B = prompt.shape[0]
    worst, agree, n_ids, rerouted = 0.0, 0, 0, 0
    for j, (got, want_l) in enumerate(pairs):
        comp = routed[2 * n_moe * j: 2 * n_moe * j + n_moe]
        mask_ = routed[2 * n_moe * j + n_moe: 2 * n_moe * (j + 1)]
        diff_row = torch.zeros(B, dtype=torch.bool, device=dev)
        for a, b in zip(comp, mask_, strict=True):
            d = (a != b).reshape(B, -1)         # tokens are row-major
            n_ids += int(d.sum())
            diff_row |= d.any(dim=-1)
        check(bool(torch.isfinite(got).all()), "non-finite logits")
        for r in range(B):
            if diff_row[r]:
                rerouted += 1
                continue
            err, tol = logit_err(torch, got[r], want_l[r], LOGIT_ULPS_FULL)
            check(err <= tol, f"compressed vs masked-dense logits, pass {j}"
                  f" row {r}: max err {err} over {tol} ({LOGIT_ULPS_FULL} "
                  "bf16 ulps of the row's max)")
            worst = max(worst, err / tol)
        agree += int((got.argmax(-1) == want_l.argmax(-1)).sum())
    total = len(pairs) * B
    routing = (f"{n_ids} routed expert ids differ, {rerouted}/{total} rows "
               "re-routed; worst logit err of the others" if n_moe
               else "worst logit err")
    print(f"  compressed vs masked-dense (prefill + 8 decode steps, {B} "
          f"rows): {routing} {worst:.2f} of tolerance; greedy token "
          f"agreement {agree}/{total}")
    check(rerouted <= MAX_REROUTED_ROWS,
          f"{rerouted} of {total} rows re-routed, more than "
          f"{MAX_REROUTED_ROWS}")
    return {"launches": launches, "step_ms": step_ms,
            "step_dev_ms": step_dev_ms, "prefill_ms": prefill_ms,
            "peak_gib": peak / 2 ** 30}


# ---------------------------------------------------------------------------
# Phase 6: the committed bank, card against CPU
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

    print("[1/7] device")
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

    print("[2/7] build")
    from repro_torch.kernels._build import ENTRY_POINTS, build, library
    t0 = time.perf_counter()
    build()
    for name in ENTRY_POINTS:
        library(name)
    print(f"  kernels built ({', '.join(ENTRY_POINTS)}: one nvcc each, in "
          f"parallel) and loaded in {time.perf_counter() - t0:.1f} s")

    print(f"[3/7] kernels against their plain versions [{card}]")
    t0 = time.perf_counter()
    mm = phase_nm_matmul(torch, dev)
    mask = phase_nm_mask24(torch, dev)
    expert = phase_nm_matmul_expert(torch, dev)
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    from repro_torch.configs.base import get_config
    torch.cuda.empty_cache()
    print(f"[4/7] full-width llama3.2-1b 2:4 serving [{card}]")
    t0 = time.perf_counter()
    llama = phase_serve(torch, dev, card, get_config("llama3.2-1b"),
                        {"nm_matmul": 7, "nm_matmul_expert": 0})
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[5/7] full-width mixtral-8x22b ({MIXTRAL_LAYERS} of 56 layers) "
          f"2:4 MoE serving [{card}]")
    t0 = time.perf_counter()
    moe = phase_serve(torch, dev, card, dataclasses.replace(
        get_config("mixtral-8x22b"), num_layers=MIXTRAL_LAYERS),
        {"nm_matmul": 4, "nm_matmul_expert": 3})
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print("[6/7] committed mask bank at smoke width, card vs CPU")
    phase_bank(torch, dev)

    print("[7/7] summary")
    paths = {"llama3.2-1b": llama["launches"],
             "mixtral-8x22b": moe["launches"]}

    def counts(name):
        by = {k: v[name] for k, v in paths.items() if name in v}
        return {"launches": sum(by.values()), "launches_by_path": by}

    kernels = [
        {"name": "nm_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/nm_spmm.cu",
         "replaces": "src/repro/kernels/nm_spmm.py:126",
         **counts("nm_matmul"), **mm,
         "work": "one llama decode layer: wq, wk, wv, wo, up, gate, down "
                 "at M=4 (4 slots), packed2, bf16; by_path: one decode "
                 "layer's projections on each path"},
        {"name": "nm_matmul_expert", "route": "cuda",
         "source": "src/repro_torch/csrc/nm_spmm.cu",
         "replaces": "src/repro/kernels/nm_spmm.py:202",
         **counts("nm_matmul_expert"), **expert,
         "work": "one mixtral decode layer: up, gate, down banks, E=8, "
                 "M=C=4 (4 slots), packed2, bf16"},
        {"name": "nm_mask24", "route": "cuda",
         "source": "src/repro_torch/csrc/nm_mask24.cu",
         "replaces": "src/repro/kernels/nm_prox.py:82",
         **counts("nm_mask24"), **mask,
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
