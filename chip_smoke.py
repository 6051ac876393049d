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
              and the least time the card could take (bytes or operations);
              the calibration kernels (prox24, saliency_fused_step) at every
              prunable leaf of full-width and smoke llama3.2-1b, bit for
              bit.
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
6. calibrate - the calibration main path at full width: llama3.2-1b from
              random weights (seed 0), the launcher's defaults (wanda, 2:4,
              median-normalised scores, 30 steps, 8 calibration batches of
              4 x 64 tokens, stats over the first 4) through
              ``calibrate_to_bank``, then
              ``MaskBank.load``, ``masks_at`` (nm_mask24), ``sparse_params``
              and ``ServeEngine`` serving 2 requests x 16 tokens through
              nm_matmul; launch counts asserted; the first call at every
              distinct kernel signature of the run held against its plain
              version; per-step time and a profiler breakdown; peak memory.
              Then the same calibration at smoke width on the card and on
              the CPU, Gamma/V within the CPU tests' tolerance and masks
              equal but for counted near-ties.
7. bank     - the committed mask bank at smoke width through
              ``MaskBank.load`` and ``ServeEngine.from_artifact``, card
              against CPU.
8. summary  - a ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}``
              line last.

It imports nothing of jax or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import pathlib
import shutil
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


# the calibration path's search constants (PruneConfig defaults)
PROX_LAM, V_LR, LAM = 1e-2, 0.1, 1e-3
PROX_OPS = 11 * 12         # f32 ops per element: 11 per iteration, 12 iters
FUSED_OPS = 10             # wanda with the median divisor


def calib_leaves(cfg) -> dict:
    """The prunable leaves of ``cfg``: name -> (L, K, N).  The search
    kernels take each as its (L*K, N) view."""
    import torch
    from repro_torch import tree
    from repro_torch.core.prunable import is_prunable_path
    from repro_torch.models import model as M
    out = {}
    for path, shp in tree.flatten_with_path(M.param_shapes(cfg)):
        if is_prunable_path(path, torch.empty(shp, device="meta")):
            out[path.split("']['")[-2]] = tuple(shp)
    return out


def _with_zeros(w):
    """Exact zeros and signed zeros in every group position."""
    w[0::13] = 0.0
    w[1::17] = -0.0
    return w


def _per_step(rows: list, leaves: dict) -> dict:
    """One search step: every prunable leaf once, at its shape's row."""
    by = {r["LKN"]: r for r in rows}
    tot = {k: sum(by[lkn][k] for lkn in leaves.values())
           for k in ("ms", "plain_ms", "bound_ms")}
    kinds = {by[lkn]["bound_by"] for lkn in leaves.values()}
    return {**tot, "bound_by": kinds.pop() if len(kinds) == 1
            else "operations", "library_ms": None}


def phase_prox24(torch, dev, paths: dict) -> dict:
    """prox24 in place (as the search runs it) against ref.prox24_ref, bit
    for bit, at each leaf shape of each calibration path."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_prox import prox24
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    rows, out = [], {}
    for path, leaves in paths.items():
        path_rows = []
        for L, K, N in sorted(set(leaves.values())):
            R = L * K
            w = _with_zeros(torch.randn((R, N), generator=g, device=dev)
                            * K ** -0.5)
            want = ref.prox24_ref(w, PROX_LAM)
            got = w.clone()
            prox24(got, lam=PROX_LAM, out=got)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            check(torch.equal(got, want) and torch.equal(
                torch.signbit(got), torch.signbit(want)),
                f"prox24 ({R}, {N}): differs from its plain version (max "
                f"err {err})")
            del want, got
            copies = max(1, -(-2 * L2_BYTES // (R * N * 4)))
            ws = [w.clone() for _ in range(copies)]
            ms = device_ms(torch, lambda i: prox24(ws[i], lam=PROX_LAM,
                                                   out=ws[i]), copies)
            plain = device_ms(torch, lambda i: ref.prox24_ref(
                ws[i], PROX_LAM), copies)
            del ws, w
            torch.cuda.empty_cache()
            b_ms, b_by = bound(R * N * 8, R * N * PROX_OPS, F32_OPS_PER_S)
            path_rows.append({"LKN": (L, K, N), "max_abs_err": err,
                              "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                              "bound_by": b_by})
            print(f"  prox24 f32 ({R:6d}, {N:5d}) in place  bit-identical  "
                  f"kernel {ms:8.4f} ms  plain {plain:8.4f} ms  bound "
                  f"{b_ms:7.4f} ms ({b_by})  {b_ms / ms:6.1%} of bound")
        out[path] = _per_step(path_rows, leaves)
        rows += path_rows
        print(f"  prox24, one {path} search step (7 leaves): kernel "
              f"{out[path]['ms']:.4f} ms, plain {out[path]['plain_ms']:.4f}"
              f" ms, bound {out[path]['bound_ms']:.4f} ms; no single "
              "PyTorch call computes it (the plain version is the unfused "
              "torch chain)")
    first = next(iter(paths))
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), **out[first],
            "by_path": out}


def phase_saliency(torch, dev, paths: dict) -> dict:
    """saliency_fused_step against its plain version, bit for bit, at each
    leaf shape of each calibration path: wanda, magnitude and ria, with
    and without the median divisor; timed as the search runs it (wanda,
    divisor, in place over V and Gamma)."""
    from repro_torch.core.metrics import median_element
    from repro_torch.kernels.saliency_fuse import (saliency_fused_step,
                                                   saliency_fused_step_plain)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    rows, out = [], {}
    for path, leaves in paths.items():
        path_rows = []
        for L, K, N in sorted(set(leaves.values())):
            R = L * K
            w = _with_zeros(torch.randn((R, N), generator=g, device=dev)
                            * K ** -0.5)
            a = torch.rand((R,), generator=g, device=dev) * 8 + 0.05
            v = torch.randn((R, N), generator=g, device=dev) * 0.5
            gam = torch.copysign(torch.clamp_min(v.abs() - LAM, 0.0), v)
            aw = w.abs().reshape(L, K, N)
            rowsum, colsum = aw.sum(-1).reshape(R), aw.sum(-2)
            del aw
            s_div = median_element(w.abs() * a[:, None]) + 1e-12
            for metric in ("wanda", "magnitude", "ria"):
                for div in (s_div, None):
                    kw = dict(metric=metric, v_lr=V_LR, lam=LAM,
                              rowsum=rowsum if metric == "ria" else None,
                              colsum=colsum if metric == "ria" else None,
                              s_div=div)
                    am = None if metric == "magnitude" else a
                    want = saliency_fused_step_plain(w, am, gam, v, **kw)
                    got = saliency_fused_step(w, am, gam, v, **kw)
                    torch.cuda.synchronize()
                    same = all(torch.equal(x, y) for x, y in zip(got, want))
                    err = max(float((x - y).abs().max())
                              for x, y in zip(got, want))
                    check(same, f"saliency_fused_step {metric} "
                          f"{'/ median ' if div is not None else ''}({R}, "
                          f"{N}): differs from its plain version (max err "
                          f"{err})")
                    del want, got
            elem = R * N * 20 + R * 4
            copies = max(1, -(-2 * L2_BYTES // elem))
            states = [(v.clone(), gam.clone()) for _ in range(copies)]
            kw = dict(metric="wanda", v_lr=V_LR, lam=LAM, s_div=s_div)
            ms = device_ms(torch, lambda i: saliency_fused_step(
                w, a, states[i][1], states[i][0], inplace=True, **kw),
                copies)
            plain = device_ms(torch, lambda i: saliency_fused_step_plain(
                w, a, states[i][1], states[i][0], **kw), copies)
            del states, w, v, gam, a, rowsum, colsum
            torch.cuda.empty_cache()
            b_ms, b_by = bound(elem, R * N * FUSED_OPS, F32_OPS_PER_S)
            path_rows.append({"LKN": (L, K, N), "max_abs_err": 0.0,
                              "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                              "bound_by": b_by})
            print(f"  saliency_fused_step ({R:6d}, {N:5d}) 6 variants "
                  f"bit-identical; wanda / median in place: kernel {ms:8.4f}"
                  f" ms  plain {plain:8.4f} ms  bound {b_ms:7.4f} ms "
                  f"({b_by})  {b_ms / ms:6.1%} of bound")
        out[path] = _per_step(path_rows, leaves)
        rows += path_rows
        print(f"  saliency_fused_step, one {path} search step (7 leaves): "
              f"kernel {out[path]['ms']:.4f} ms, plain "
              f"{out[path]['plain_ms']:.4f} ms, bound "
              f"{out[path]['bound_ms']:.4f} ms; no single PyTorch call "
              "computes it (the plain version is the unfused torch chain)")
    first = next(iter(paths))
    return {"max_abs_err": 0.0, **out[first], "by_path": out}


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
# Phase 6: calibration at full width, then serving from its bank
# ---------------------------------------------------------------------------

CALIB_STEPS = 30            # the launcher's default; cut steps, not widths
SEARCH_KERNELS = ("prox24", "saliency_fused_step")
# the CPU tests' tolerance for a calibration held against another one that
# computes its own stats: Gamma/V within BF16_ULP (|V_ref| + lam) + 1e-4
# max|V_ref| elementwise (tests/test_torch_calibrate.py)
BF16_ULP = 2.0 ** -8


def _banks_dir():
    d = ROOT / "build" / "chip_smoke_banks"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


@contextlib.contextmanager
def search_calls_checked(torch, seen: dict):
    """While open, the first call at every distinct signature of the two
    search kernels (in ``core/mirror.py``) is held against its plain
    version on a copy of the same inputs, bit for bit, before the kernel
    runs on them in place; every call still launches and counts."""
    from repro_torch.core import mirror
    from repro_torch.kernels import ref
    from repro_torch.kernels.saliency_fuse import saliency_fused_step_plain
    saved = {name: getattr(mirror, name) for name in SEARCH_KERNELS}

    def prox(w, *, lam, out=None, **kw):
        key = ("prox24", tuple(w.shape), w.dtype, out is w)
        if key not in seen:
            want = ref.prox24_ref(w, lam, **kw)
            got = saved["prox24"](w, lam=lam, out=out, **kw)
            torch.cuda.synchronize()
            seen[key] = float((got - want).abs().max())
            check(torch.equal(got, want) and torch.equal(
                torch.signbit(got), torch.signbit(want)),
                f"prox24 at {key} on the calibration path differs from its "
                f"plain version (max err {seen[key]})")
            return got
        return saved["prox24"](w, lam=lam, out=out, **kw)

    def fused(w, a, gamma, v, *, inplace=False, **kw):
        key = ("saliency_fused_step", tuple(w.shape), w.dtype,
               kw.get("metric"), kw.get("s_div") is not None, inplace)
        if key not in seen:
            want = saliency_fused_step_plain(w, a, gamma, v, **kw)
            got = saved["saliency_fused_step"](w, a, gamma, v,
                                               inplace=inplace, **kw)
            torch.cuda.synchronize()
            seen[key] = max(float((x - y).abs().max())
                            for x, y in zip(got, want))
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"saliency_fused_step at {key} on the calibration path "
                  f"differs from its plain version (max err {seen[key]})")
            return got
        return saved["saliency_fused_step"](w, a, gamma, v, inplace=inplace,
                                            **kw)

    mirror.prox24, mirror.saliency_fused_step = prox, fused
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(mirror, name, fn)


@contextlib.contextmanager
def timed_steps(torch, times: list):
    """Each ``mirror.search_step`` fenced and timed on the host clock."""
    from repro_torch.core import mirror
    step = mirror.search_step

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    mirror.search_step = timed
    try:
        yield times
    finally:
        mirror.search_step = step


def _bucket(name: str) -> str:
    n = name.lower()
    if "prox24" in n:
        return "prox24"
    if "saliency_fuse" in n:
        return "fused step"
    if any(k in n for k in ("topk", "radix", "kthvalue", "sort", "blockwise")):
        return "median selection (topk)"
    if any(k in n for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90_",
                            "cublas")):
        return "matmuls (forward + backward)"
    return "other (elementwise, reductions, copies)"


# where a search step's time goes: functions of the step, each timed
# exclusive of the others nested in it, fenced with a synchronize
STEP_PARTS = (("forward + backward", "mirror", "_task_value_and_grad"),
              ("alignment gradient", "mirror", "_align_leaf"),
              ("median selection", "metrics", "median_element"),
              ("prox24", "mirror", "prox24"),
              ("fused step", "mirror", "saliency_fused_step"))


@contextlib.contextmanager
def step_parts(torch, acc: dict):
    from repro_torch.core import metrics, mirror
    mods = {"mirror": mirror, "metrics": metrics}
    saved = [(mods[m], fn, getattr(mods[m], fn)) for _, m, fn in STEP_PARTS]
    stack = []

    def timed(label, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stack.append(0.0)
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            inner = stack.pop()
            acc[label] = acc.get(label, 0.0) + dt - inner
            if stack:
                stack[-1] += dt
            return out
        return call

    for (label, _, _), (mod, name, fn) in zip(STEP_PARTS, saved):
        setattr(mod, name, timed(label, fn))
    try:
        yield acc
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def profile_steps(torch, cfg, pcfg, params0, stats, batch, n: int) -> dict:
    """Over ``n`` more search steps from a fresh state: the wall time of
    each part of a step (fenced, exclusive), then, over another ``n``
    under the profiler, the kernels' device time by kind."""
    from functools import partial
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tree
    from repro_torch.core import mirror
    from repro_torch.core.metrics import median_element
    from repro_torch.core.prunable import prunable_map
    from repro_torch.optim.losses import lm_loss
    state = mirror.init_search(params0, 17)
    prunable = prunable_map(params0)
    loss_fn = partial(lm_loss, cfg)

    def steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            mirror.search_step(pcfg, loss_fn, state, batch, stats, prunable)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    steps()                                             # warm-up
    parts = {}
    with step_parts(torch, parts):
        fenced = steps()
    parts = {k: v / n * 1e3 for k, v in parts.items()}
    parts["other"] = fenced - sum(parts.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = steps()
    # the median selection: what topk costs against a full sort and
    # kthvalue, on the largest leaf's scores
    path, w = max(((p, x) for p, x in tree.flatten_with_path(state.W)
                   if x.dim() == 3), key=lambda px: px[1].numel())
    a = dict(tree.flatten_with_path(stats))[path]
    flat = (w.abs() * a[..., None]).reshape(-1)
    del state, w
    n_el = flat.numel()
    sel = {"topk (median_element)": lambda: median_element(flat),
           "sort": lambda: torch.sort(flat).values[n_el // 2],
           "kthvalue": lambda: torch.kthvalue(flat, n_el // 2 + 1).values}
    median = {}
    for name, fn in sel.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        med = fn()
        torch.cuda.synchronize()
        median[name] = ((time.perf_counter() - t0) * 1e3, float(med))
        torch.cuda.empty_cache()
    check(len({v for _, v in median.values()}) == 1,
          f"median selections disagree: {median}")
    del flat
    buckets, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            b = _bucket(e.key)
            buckets[b] = buckets.get(b, 0.0) + e.self_device_time_total / n
            launches += e.count
    return {"fenced_ms": fenced, "parts_ms": parts, "wall_ms": wall,
            "median_ms": {k: v for k, (v, _) in median.items()},
            "median_n": n_el,
            "device_ms": sum(buckets.values()) / 1e3,
            "buckets_ms": {k: v / 1e3 for k, v in sorted(
                buckets.items(), key=lambda kv: -kv[1])},
            "kernels_per_step": launches / n}


def phase_calibrate(torch, dev, card: str) -> dict:
    """The calibration main path at full width, then serving from its bank
    through nm_matmul."""
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig, get_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.nm_prox import nm_mask24, prox24
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.kernels.saliency_fuse import saliency_fused_step
    from repro_torch.launch.calibrate import calibrate_to_bank
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse.apply import compressed_report
    from repro_torch.sparse.bank import MaskBank

    cfg = get_config("llama3.2-1b")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=CALIB_STEPS,
                       stats_batches=4)
    calib = batches_for(cfg, n=8, batch=4, seq=64, split="calib")
    params0 = M.init_params(cfg, 0, device=dev)
    n_pr = sum(L * K * N for L, K, N in calib_leaves(cfg).values())
    banks = _banks_dir()
    print(f"  {cfg.name}: {sum(x.numel() for x in tree.leaves(params0))} "
          f"params, {n_pr} prunable; {pcfg.local_metric}, {pcfg.mode}, "
          f"score_norm {pcfg.score_norm}, {pcfg.steps} steps, calib 8 x 4 x "
          f"64, stats over {pcfg.stats_batches} batches; bank to {banks} "
          f"({shutil.disk_usage(banks).free / 1e9:.0f} GB free)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path, counted ---------------------------------------------
    seen, steps = {}, []
    prox24.launches = saliency_fused_step.launches = 0
    nm_mask24.launches = nm_matmul.launches = nm_matmul_expert.launches = 0
    t0 = time.perf_counter()
    with search_calls_checked(torch, seen), timed_steps(torch, steps):
        bank = calibrate_to_bank(banks / "full", cfg=cfg, pcfg=pcfg,
                                 params=params0, calib=calib,
                                 arch=cfg.name, smoke=False, log_every=10)
    t_calib = time.perf_counter() - t0
    peak_search = torch.cuda.max_memory_allocated()
    stats, meta = bank.stats, bank.meta
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loaded = MaskBank.load(banks / "full", device=dev)
    t_load = time.perf_counter() - t0
    check(loaded.meta["steps_run"] == CALIB_STEPS
          and loaded.meta["checksum"] == meta["checksum"],
          f"reloaded bank: steps_run {loaded.meta['steps_run']}, checksum "
          f"{loaded.meta['checksum']} vs {meta['checksum']}")
    sparse, masks = loaded.sparse_params(params0, with_masks=True)
    rep = compressed_report(sparse, masks)
    del loaded, masks
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, sparse, slots=2, capacity=64, device=dev)
    prompts = batches_for(cfg, n=1, batch=2, seq=40, split="valid")[0][
        "tokens"]
    rids = [eng.submit(prompts[0, :24], 16), eng.submit(prompts[1, :40], 16)]
    calls = {}
    with first_call_per_signature(calls):
        out = eng.run()
    torch.cuda.synchronize()
    launches = {"prox24": prox24.launches,
                "saliency_fused_step": saliency_fused_step.launches,
                "nm_mask24": nm_mask24.launches,
                "nm_matmul": nm_matmul.launches,
                "nm_matmul_expert": nm_matmul_expert.launches}
    # -----------------------------------------------------------------------
    forwards = eng.decode_steps + eng.prefill_calls
    print(f"  main path launches: {launches} over {CALIB_STEPS} search steps"
          f", one mask export and {eng.prefill_calls} prefills + "
          f"{eng.decode_steps} decode steps")
    for name in SEARCH_KERNELS:
        check(launches[name] == 7 * CALIB_STEPS,
              f"{name} launched {launches[name]} times, want "
              f"{7 * CALIB_STEPS}")
    check(launches["nm_mask24"] == 7,
          f"nm_mask24 launched {launches['nm_mask24']} times, want 7")
    check(launches["nm_matmul"] == 7 * cfg.num_layers * forwards,
          f"nm_matmul launched {launches['nm_matmul']} times, want "
          f"{7 * cfg.num_layers * forwards}")
    check(launches["nm_matmul_expert"] == 0, "nm_matmul_expert launched")
    check(all(len(out[r]) == 16 for r in rids),
          f"requests finished with {[len(out[r]) for r in rids]} tokens")
    print(f"  {len(seen)} distinct search-kernel calls held against their "
          f"plain versions, all bit-identical: "
          + "; ".join(f"{k[0]} {k[1]}" for k in sorted(seen)))
    print("  " + check_path_calls(torch, calls))
    del calls
    hist = meta["history"]
    check(len(hist) == CALIB_STEPS // 10 and all(
        all(map(lambda x: x == x and abs(x) < float("inf"), h.values()))
        for h in hist), f"history not finite: {hist}")
    for h in hist:
        print("  history: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                        sorted(h.items())))
    check(rep["fallback_leaves"] == 0 and rep["ratio"] == 0.5625,
          f"compression: {rep['fallback_leaves']} fallbacks, ratio "
          f"{rep['ratio']}")
    step_ms = statistics.median(steps[1:]) * 1e3
    print(f"  [{card}] stats {meta['stats_seconds']:.3f} s; search "
          f"{meta['search_seconds']:.3f} s for {CALIB_STEPS} steps (step 0, "
          f"with the plain-version checks, {steps[0] * 1e3:.1f} ms; the "
          f"others median {step_ms:.1f} ms, {min(steps[1:]) * 1e3:.1f}-"
          f"{max(steps[1:]) * 1e3:.1f}); calibrate_to_bank {t_calib:.1f} s "
          f"in all (bank save included), reload + checksum {t_load:.1f} s; "
          f"max memory allocated through the search "
          f"{peak_search / 2 ** 30:.2f} GiB")
    del eng, sparse, out
    gc.collect()
    torch.cuda.empty_cache()

    # -- where a search step's time goes (extra steps, not counted) ---------
    prof = profile_steps(torch, cfg, pcfg, params0,
                         stats, {"tokens": torch.from_numpy(
                             calib[0]["tokens"]).to(dev)}, 2)
    print(f"  2 search steps, each part fenced: {prof['fenced_ms']:.1f} ms "
          "per step: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                   prof["parts_ms"].items()))
    print(f"  profiler, 2 search steps: wall {prof['wall_ms']:.1f} ms per "
          f"step, device {prof['device_ms']:.1f} ms in "
          f"{prof['kernels_per_step']:.0f} kernels (idle "
          f"{1 - prof['device_ms'] / prof['wall_ms']:.1%}); kernels by kind,"
          " ms per step: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                       prof["buckets_ms"].items()))
    print(f"  the exact median of {prof['median_n']} scores (the largest "
          "leaf), one call each, ms: " + ", ".join(
              f"{k} {v:.2f}" for k, v in prof["median_ms"].items()))
    del params0, stats
    shutil.rmtree(banks / "full", ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms,
            "stats_s": meta["stats_seconds"],
            "search_s": meta["search_seconds"],
            "peak_gib": peak_search / 2 ** 30, "profile": prof}


def phase_calibrate_card_vs_cpu(torch, dev) -> None:
    """The same smoke-width calibration on the card and on the CPU."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig, get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.calibrate import calibrate_to_bank
    from repro_torch.models import model as M
    cfg = get_smoke_config("llama3.2-1b")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=CALIB_STEPS,
                       stats_batches=4)
    calib = batches_for(cfg, n=8, batch=4, seq=64, split="calib")
    params = M.init_params(cfg, 0, device="cpu")
    banks = _banks_dir()
    on = {}
    for d in (dev, "cpu"):
        name = "card" if d is dev else "cpu"
        on[name] = calibrate_to_bank(
            banks / name, cfg=cfg, pcfg=pcfg,
            params=tree.to_device(params, d), calib=calib, arch=cfg.name,
            smoke=True, log_every=10)
    card, cpu = on["card"], on["cpu"]
    worst, ties, n = 0.0, 0, 0
    masks_card, masks_cpu = card.masks_at(), cpu.masks_at()
    for (path, vc), (_, vg) in zip(tree.flatten_with_path(cpu.V),
                                   tree.flatten_with_path(card.V)):
        if vc is None:
            continue
        vref = vc.abs()
        tol = BF16_ULP * (vref + pcfg.lam) + 1e-4 * vref.max()
        gc_ = dict(tree.flatten_with_path(cpu.Gamma))[path]
        gg = dict(tree.flatten_with_path(card.Gamma))[path].cpu()
        for got, want in ((vg.cpu(), vc), (gg, gc_)):
            ratio = float(((got - want).abs() / tol).max())
            check(ratio <= 1, f"card vs CPU calibration at {path}: "
                  f"{ratio:.3f} of the tolerance")
            worst = max(worst, ratio)
        # masks: equal but for near-ties of the CPU run's own scores
        mk = dict(tree.flatten_with_path(masks_cpu))[path].numpy()
        mg = dict(tree.flatten_with_path(masks_card))[path].cpu().numpy()
        *_, K, N = mk.shape
        diff = (mk != mg).reshape(-1, K // 4, 4, N).any(axis=2)
        score = gc_.abs().numpy().reshape(-1, K // 4, 4, N)
        t = tol.numpy().reshape(-1, K // 4, 4, N)
        kc = mk.reshape(-1, K // 4, 4, N)
        kg = mg.reshape(-1, K // 4, 4, N)
        for l, r, c in zip(*np.nonzero(diff)):
            a, b = kc[l, r, :, c], kg[l, r, :, c]
            sc = score[l, r, :, c]
            margin = sc[a & ~b].min() - sc[b & ~a].max()
            check(margin <= 2 * t[l, r, :, c][a ^ b].max(),
                  f"card vs CPU masks at {path}[{l}, {r}, {c}]: margin "
                  f"{margin} is no near-tie")
            ties += 1
        n += mk.size // 4
    print(f"  smoke calibration, card vs CPU ({CALIB_STEPS} steps): Gamma/V "
          f"worst {worst:.3f} of the tolerance; {ties} of {n} groups of 4 "
          f"differ in the 2:4 masks, each a near-tie")
    shutil.rmtree(banks, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 7: the committed bank, card against CPU
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

    print("[1/8] device")
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

    print("[2/8] build")
    from repro_torch.kernels._build import ENTRY_POINTS, build, library
    t0 = time.perf_counter()
    build()
    for name in ENTRY_POINTS:
        library(name)
    print(f"  kernels built ({', '.join(ENTRY_POINTS)}: one nvcc each, in "
          f"parallel) and loaded in {time.perf_counter() - t0:.1f} s")

    print(f"[3/8] kernels against their plain versions [{card}]")
    from repro_torch.configs.base import get_config, get_smoke_config
    t0 = time.perf_counter()
    mm = phase_nm_matmul(torch, dev)
    mask = phase_nm_mask24(torch, dev)
    expert = phase_nm_matmul_expert(torch, dev)
    calib_paths = {"llama3.2-1b": calib_leaves(get_config("llama3.2-1b")),
                   "llama3.2-1b smoke": calib_leaves(
                       get_smoke_config("llama3.2-1b"))}
    prox = phase_prox24(torch, dev, calib_paths)
    fused = phase_saliency(torch, dev, calib_paths)
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[4/8] full-width llama3.2-1b 2:4 serving [{card}]")
    t0 = time.perf_counter()
    llama = phase_serve(torch, dev, card, get_config("llama3.2-1b"),
                        {"nm_matmul": 7, "nm_matmul_expert": 0})
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[5/8] full-width mixtral-8x22b ({MIXTRAL_LAYERS} of 56 layers) "
          f"2:4 MoE serving [{card}]")
    t0 = time.perf_counter()
    moe = phase_serve(torch, dev, card, dataclasses.replace(
        get_config("mixtral-8x22b"), num_layers=MIXTRAL_LAYERS),
        {"nm_matmul": 4, "nm_matmul_expert": 3})
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[6/8] full-width llama3.2-1b calibration -> bank -> 2:4 serving "
          f"[{card}]")
    t0 = time.perf_counter()
    calib = phase_calibrate(torch, dev, card)
    phase_calibrate_card_vs_cpu(torch, dev)
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print("[7/8] committed mask bank at smoke width, card vs CPU")
    phase_bank(torch, dev)

    print("[8/8] summary")
    paths = {"llama3.2-1b": llama["launches"],
             "mixtral-8x22b": moe["launches"],
             "calibrate llama3.2-1b": calib["launches"]}

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
        {"name": "prox24", "route": "cuda",
         "source": "src/repro_torch/csrc/prox24.cu",
         "replaces": "src/repro/kernels/nm_prox.py:46",
         **counts("prox24"), **prox,
         "work": "one full-width llama3.2-1b search step: the 7 prunable "
                 "leaves as (16*K, N) f32 views, in place, lam 1e-2, 12 "
                 "iterations; by_path: one step on each calibration path"},
        {"name": "saliency_fused_step", "route": "cuda",
         "source": "src/repro_torch/csrc/saliency_fuse.cu",
         "replaces": "src/repro/kernels/saliency_fuse.py:49",
         **counts("saliency_fused_step"), **fused,
         "work": "one full-width llama3.2-1b search step: the 7 prunable "
                 "leaves, wanda scores over the median divisor, V and Gamma "
                 "f32 in place; by_path: one step on each calibration path"},
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
