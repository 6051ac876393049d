#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

1. device   - the card's name and power limit; TF32 and reduced-precision
              bf16 reductions off for the plain reference paths.
2. build    - the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc per
              library, all started together, sm_90a; the decode
              attention's f32 and bf16 instantiations two libraries of one
              source), and from their ptxas reports the registers and
              spills of the decode attention kernel's D 112 and G 1
              instantiations.
3. kernels  - each kernel against its plain PyTorch version on the card at
              each main path's shapes, with its device time (CUDA graph of
              back-to-back launches over enough weight bytes to defeat the
              50 MB L2), the plain version's, one PyTorch library call's,
              and the least time the card could take (bytes or operations);
              nm_matmul's per-layer totals at decode and prefill rows beside
              torch.matmul, nm_matmul_expert's at every capacity beside
              torch.bmm;
              the calibration kernels (prox24, saliency_fused_step) at every
              prunable leaf of full-width and smoke llama3.2-1b, bit for
              bit; the decode attention kernels (flash_decode,
              flash_decode_partial, the combine) at llama's serving shapes,
              its long cache, mixtral's window, a ragged capacity,
              phase 10's gemma3-1b (G 4, D 256) and yi-6b (G 8, D 128)
              heads and phase 14's zamba2-7b shared attention (G 1,
              D 112) at serving and long caches (these also in f32), rows
              at different positions and all-masked shards, against their
              plain versions and ``F.scaled_dot_product_attention``'s time
              (with the planner's capacity splits P per case); phase 15's
              whisper self ring and 1536-slot cross cache (G 1, D 64) and
              pixtral's heads (G 4, D 128) at its engine's and launcher's
              capacities; ``nm_matmul`` at whisper's and pixtral's
              projections; prox24's bound by bytes and by its unfused f32
              issue rate.
4. llama    - the first main path at full width: llama3.2-1b (16 layers,
              d 2048) from random weights (``torch.Generator`` seed 0), 2:4
              masks by ``baseline_masks("magnitude", mode="nm")`` through
              nm_mask24, packed2 compression, ``ServeEngine(slots=4)``
              serving 6 requests of 32-128 prompt tokens x 16 new tokens;
              launch counts asserted (and one 2:4 kernel per projection
              per decode step in the profiler: split-K takes no second
              launch); the first kernel call at every
              distinct shape of the run held against its plain version;
              then the same requests at ``kv_shards=1`` (flash_decode) and
              ``kv_shards=4`` (flash_decode_partial + combine), each path
              counted on its own (one launch per layer per decode step),
              its kernel calls held against their plain versions, its
              logits and greedy streams against the ``kv_shards=None``
              run; the decode step of each path timed eager and replayed
              from a CUDA graph (replay == eager); the counted runs take
              eager steps (``serve.engine.eager``), then each path's
              requests run three times more on the engine's own CUDA-graph
              step (streams == the eager run's, one decode graph, the
              replayed kernels counted by the profiler); the decode step at
              capacity 8192 with every slot valid (K/V from a seeded
              generator on the card) at ``kv_shards`` None, 1, 4 and 16:
              launches, logits against None, replay == eager, CUDA-graph
              replays timed in turns; then compressed vs masked-dense
              logits.
5. mixtral  - the MoE main path at full width: mixtral-8x22b cut from 56 to
              2 layers (memory) and nothing else, through the same phase,
              every expert bank through nm_matmul_expert; the routing of
              compressed and masked-dense compared too.
6. calibrate - first the smoke-width calibration on the card and on the
              CPU, Gamma/V within the CPU tests' tolerance and masks equal
              but for counted near-ties, and stochria's threefry row/column
              draws of every full-width leaf, card == CPU; then
              the calibration main path at full width: llama3.2-1b from
              random weights (seed 0), the launcher's defaults (wanda, 2:4,
              median-normalised scores, 30 steps, 8 calibration batches of
              4 x 64 tokens, stats over the first 4) through
              ``calibrate_to_bank``, then
              ``MaskBank.load``, ``masks_at`` (nm_mask24), ``sparse_params``
              and ``ServeEngine`` serving 2 requests x 16 tokens through
              nm_matmul; launch counts asserted; the first call at every
              distinct kernel signature of the run held against its plain
              version; per-step time and a profiler breakdown; peak memory.
              The bank stays for phases 7, 8 and 13.
7. fleet    - ``SparsityFleet`` over phase 6's bank and weights at budgets
              0.0, 0.5 (global threshold: a sort of every score) and 2:4,
              6 slots, capacity 256, at ``kv_shards`` None and 1: phase 4's
              six prompts pinned to each member, through A/B weights, and
              through self-speculative decoding (2:4 drafts, 0.0 verifies,
              k 4, adaptive); counted on eager steps (launches, every
              distinct kernel call against its plain version, the
              members' shared leaves, the report's counters, A/B streams
              == pinned, spec streams == the verifier alone but for
              counted near-ties of the verifier's logits), then twice on
              the CUDA-graph engines (streams == eager, captures per
              surface unchanged by the second run), the draft and verify
              surfaces replayed == eager, the engine's step eager and
              graph per member, tok/s, spec's accept rate and tok/s
              against the verifier alone; peak memory.
8. eval     - the paper's evaluation loop at llama3.2-1b's full width on
              phase 6's weights and calibration batches: ``eval_ppl`` of
              the dense weights, phase 6's 2:4 bank (masked-dense and
              compressed), the stochria unstructured search at 0.5-0.7,
              the one-shot baselines and the Eq. 8 ablation; stats jit
              against tape; the serve launcher's ``--sparse`` and
              ``--temperature``; mixtral-8x22b's stats (2 layers); the
              committed moe-tiny's calibration card against CPU and its 2:4
              eval.
9. train    - (a) ``launch.train.main`` at llama3.2-1b's published widths
              (random weights, seed 0), torch's default algorithms: 20
              steps of 8 x 256 tokens, remat on: the median fenced step,
              tok/s, the model-FLOPs share of the bf16 peak, peak memory,
              and the host's share of it (threads, the collector's passes,
              the allocator's retries and cudaMalloc calls); (b) under ``torch.use_deterministic_algorithms``, the same
              run with checkpoints at steps 15 (``save_async``) and 20
              (its losses and median step beside (a)'s): the host copy, write and restore
              times, the step-20 checkpoint restored == the final state,
              byte for byte; its step 20 then made torn (LATEST 15, as if
              the run died during its final save) and a second launcher
              call resumes at step 15: its first batch a fresh loader's
              batch 15, its steps and final (params, AdamWState) the
              straight run's bit for bit; the optimizer update alone
              against its bytes bound and
              ``torch.optim.AdamW(fused=True)``; at most two step
              directories (~30 GB) on disk, free space checked first,
              deleted at the end; (c) tests/test_system.py's model trained
              on the card by its recipe, its claims with its bounds (dense
              ppl < 60, monotone 0.5 -> 0.6, no collapse, UniPruning <=
              1.1 x magnitude at 0.6, exact budgets, the 2:4 kernel product,
              compressed ppl == masked-dense within 1e-3, W0 untouched),
              ``saliency_fused_step``, ``prox24``, ``nm_mask24`` and
              ``nm_matmul`` launched on the trained weights and counted,
              each call held against its plain version on the same inputs
              (the search kernels at their first call of each signature,
              bit for bit; every ``nm_mask24`` mask exactly; every
              ``nm_matmul`` product within phase 3's tolerance);
              (d) moe-tiny trained on the card by benchmarks/common.py's
              recipe, its held-out ppl below the untrained model's, beside
              the committed weights'; the held-out batches' hash and
              numpy version, and the committed weights' ppl on the card
              and on this host's CPU in one process, within 2e-3.
10. gemma   - phase 4's path at the published widths of gemma3-1b (6
              of its 26 layers, one 5:1 local:global pattern, window 512,
              QK-norm, scaled embeddings, gelu; decode attention at G 4,
              D 256), yi-6b
              (G 8, D 128; cut in depth) and gemma2-2b (softcaps and
              sandwich norms; cut in depth; its decode attention stays on
              the plain path at every ``kv_shards``, as the reference's),
              each with its capacity-8192 step; yi's verify pass against
              sequential decode; then the trained gemma-tiny: eval_ppl
              dense and at 0.5 / 0.6 under its committed bank on the card
              and on this host's CPU in one process, and a 5-step wanda
              2:4 calibration card vs CPU, every search-kernel signature
              and nm_mask24 mask held against its plain version.
11. bank    - the committed mask bank at smoke width through
              ``MaskBank.load`` and ``ServeEngine.from_artifact``, card
              against CPU.
12. deepseek - deepseek-v2-lite-16b at its published widths, cut to 4 of
              its 27 layers by the script's time (MLA with kv_lora 512, a
              dense first layer, then 64 routed experts top-6 and 2
              shared) through phase 4's path, its weights (15.7 B whole)
              made, 2:4-masked and packed a layer
              slice at a time (the f32 tree would take 62.8 GB): every
              2-D projection through ``nm_matmul`` (8 a layer at prefill,
              6 at decode, where the absorbed attention reads w_uk / w_uv
              dense) and every bank through ``nm_matmul_expert`` at E 64
              (3 a MoE layer); the decode step at capacity 256 and 8192
              (``kv_shards`` None: MLA has no decode attention kernel);
              compressed against masked-dense with the masked-dense MoE
              calls pinned to the compressed run's experts (every
              routing it would change counted as a near-tie); verify
              against sequential decode; then the smoke config's greedy
              streams and a 5-step wanda 2:4 calibration, card against
              this host's CPU, and a ``kv_shards`` engine refused.  Phase
              3 holds both kernels at its shapes (K 10944, N 576, K 512,
              E 64).
13. obs     - the flight recorder (``repro_torch.obs``) at llama3.2-1b's
              full width, 2:4 from phase 6's bank, 4 slots, capacity 256,
              phase 4's 6 requests on the CUDA-graph engine: recorder off
              and on in turns (20 pairs after a warm-up), the median paired
              on/off decode tok/s ratio held to <= 3% overhead (the serving
              ratio and the prefill fences' wait printed); the profiler's
              kernel launches and the graph captures identical off and on;
              one ``serve.decode_step_ms`` observation a decode step, their
              sum between the profiler's device time and the wall time;
              ``dist.psum{site=attn_kv}`` at ``kv_shards`` 1 and 4 equal to
              the reference's trace-time count (2 a scanned call site of
              the traced decode surface at >= 2, not a count of steps); a
              0.0 / 0.5 / 2:4 fleet from the bank reporting decode p50 <=
              p95 per budget; ``launch.serve`` from the bank with
              ``--trace-dir`` / ``--xprof-dir`` (events.jsonl, metrics.prom,
              a Chrome trace naming ``nm_mma_kernel``); ``launch.calibrate``
              on the smoke config (4 steps in chunks of 2) with
              ``--trace-dir`` on the card and on this host's CPU, the chunk
              series within tests/test_torch_calibrate.py's history
              tolerance.  Phase 6's bank is removed after it.
14. recurrent - the recurrent families through phase 4's path at their
              published widths: zamba2-7b cut by the script's time to 9
              of its 81 layers since phase 15 came (5 ``mamba`` + 1
              ``mamba_shared``, then 3 ``mamba``: both of its stages;
              whole in PR 24; d 3584,
              d_inner 7168, 112 ssm heads x 64, state 64, the one shared
              attention block of 32 x 112 with each invocation's LoRA
              deltas, d_ff 14336; weights made, masked and packed a
              layer slice at a time), every projection through
              ``nm_matmul`` (2 a mamba layer, 9 a mamba_shared one), decode
              attention at ``kv_shards`` 1 and 4 through ``flash_decode``
              / ``flash_decode_partial`` + the combine at G 1, D 112, the
              capacity-8192 step at None and 1; xlstm-125m whole (12
              layers of mLSTM / sLSTM, d 768, 4 heads; no attention, so no
              ``kv_shards``), every projection through ``nm_matmul``; both
              compressed against masked-dense layer by layer on one input;
              then each smoke config card vs this host's CPU (greedy
              streams on reused slots, a one-token prompt from the blank
              state, the graph engine, xlstm's ``kv_shards`` refusal) and a
              short wanda calibration (zamba2 2:4; xlstm unstructured: its
              smoke ff_down is 85 deep).
15. encdec   - the last two families at their published widths:
              whisper-small whole (12 encoder layers over 1536 stub frames,
              12 decoder layers; layernorm, gelu, no rope; d 768, 12 heads
              x 64, d_ff 3072, vocab 51865; 1536: the reference's
              flash_attention takes no 1500, ``attention.py:214``) and
              pixtral-12b (8 of its 40 layers, by the script's time since
              phase 18; d 5120, 32/8 heads x 128, d_ff 14336, vocab
              131072, the 256-token vision prefix through ``vit_proj``;
              its weights made, masked and packed a layer slice at a time),
              2:4, through the serve launcher's loop
              (``launch.serve.generate``): whisper 4 rows of 32 tokens x 32
              new at ``kv_shards`` None, 1, 4 (decode attention on the self
              ring and the 1536-slot cross cache, G 1, D 64), pixtral 4
              rows of 256 image + 64 text tokens x 17 new at None and 1 (G
              4, D 128); each path counted, every kernel call held against
              its plain version, the decode loop replayed from a CUDA
              graph == eager, compressed vs masked-dense and the
              ``kv_shards`` paths held layer by layer on the same input
              (end to end printed); pixtral's engine (text only, as the
              reference's) through phase 4's path at None, 1, 4; then both
              smoke configs card vs this host's CPU (the launcher's streams,
              pixtral's engine, whisper's engine refused) and a short
              whisper wanda 2:4 calibration.
16. train_families - the train step (``launch.steps.make_train_step``,
              AdamW, remat on) at the published widths of the families
              phase 9 does not train: gemma3-1b (6 of 26 layers, phase
              10's cut), deepseek-v2-lite-16b (2 of 27: the ``mla_dense``
              and one ``mla_moe`` with its 64 experts), zamba2-7b (6 of
              81: 5 ``mamba`` + 1 ``mamba_shared``), xlstm-125m whole and
              whisper-small whole (128 frames + 128 tokens, the train
              cell's split); 2 steps each of 2 x 256 tokens from random
              weights (seed 0): every loss, grad norm and updated leaf
              finite, the second loss, each step's fenced ms and the peak
              memory; then each smoke config's step on the card against
              the same step on this host's CPU at the CPU tests'
              tolerances (ROADMAP R14).  No hand-written kernel runs here.
17. analysis - the port's static analysis at llama3.2-1b's published
              widths (2:4 packed2, ``ServeEngine(slots=4, capacity=256)``,
              phase 4's configuration) at ``kv_shards`` None and 1: (a) the
              decode surface audited and planned on the meta device
              before anything is built (``analysis.audit`` /
              ``memplan``: ``nm_matmul`` 112 launches a step, and
              ``flash_decode`` 16 at ``kv_shards`` 1), held against the
              profiler's count on one replay of the engine's CUDA-graph
              step; (b) that step's warm-up and capture recorded on the
              card: no host sync, and its one large upcast the logits'
              (ROADMAP R25); (c) the planned bytes of params + caches
              against ``memory_allocated`` after the engine is built,
              exactly (the allocator's 512-byte blocks); (d) one eager
              decode step's planned peak against ``max_memory_allocated``'s
              rise, within 10%; (e) every kernel instantiation's planned
              shared memory against the binary's (``cudaFuncGetAttributes``
              and the launch's dynamic size, the sources' ``*_smem`` entry
              points); (f) ``launch.dryrun`` of llama3.2-1b's four shape
              cells on meta, a subprocess on this host's CPU started
              before phase 15 (it runs beside phases 15-17's card work),
              its fit table against the card's memory.
18. tp       - tensor-parallel serving over ``torch.distributed`` ranks:
              llama3.2-1b (4 of 16 layers, by the script's time) and
              mixtral-8x22b (phase 5's 2 of 56 layers) at their published
              widths, 2:4 (phase 4's magnitude masks), 4 slots, capacity
              256, phase 4's requests, served by 4 ranks on cuda:0 over
              gloo (one card: NCCL takes one rank a card; every collective
              goes through the host, so the engine runs eager) under
              ``rules`` on meshes (1, 4) and (2, 2), llama also under
              ``REPRO_FORCE_REPLICATED``; the params and the single-process
              runs shared with the ranks by CUDA IPC.  Each case: every
              rank's streams equal, rank 0's streams and decode logits
              against the single-process engine at the same decode
              attention arithmetic (``kv_shards`` 4, 2 or None; within 8
              bf16 ulps), each rank's parameter bytes == the spec
              derivation's blocks, ``dist.psum`` per decode trace == the
              reference's static rule, the launches (summed over the ranks
              into the ``kernels`` line) == 4 x one process's, every
              distinct shard-local kernel call held against its plain
              version; mixtral (1, 4) under the profiler too.
19. calib_tp - the UniPruning search over ``torch.distributed`` ranks:
              llama3.2-1b at its published widths (phase 18's 4 of 16
              layers), the calibrate launcher's search (wanda, 2:4, median
              scores) for 3 steps over 2 calibration batches of 4 x 64, on
              phase 18's 4 ranks under rules on meshes (1, 4) and (2, 2)
              (stats, search, the 2:4 export) and through the launcher's
              ``--mesh host`` path ((4, 1): ``calibrate_to_bank`` under
              ``host_rules``, rank 0 writing the bank); the params and the
              single-process card search shared by CUDA IPC.  Each case:
              Gamma and V gathered to rank 0 within the CPU tests' bound
              (rtol 1e-5, atol 1e-7) of the single-process search, the 2:4
              masks equal but for counted near-ties, the history's loss and
              counts equal, each rank's state bytes ==
              ``search_state_sharding``'s blocks, ``saliency_fused_step``,
              ``prox24`` and ``nm_mask24`` launched at the shard-local
              shapes (the wrappers' counts == the profiler's, summed over
              the ranks into the ``kernels`` line), rank 0's every distinct
              call held against its plain version bit for bit, the bank the
              ranks wrote reloaded with the single process's masks, peak
              memory a rank.
20. train_tp - training over ``torch.distributed`` ranks: llama3.2-1b at
              its published widths (phase 18's 4 of 16 layers) and smoke
              mixtral-8x22b (its full-width expert banks with their AdamW
              state and every rank's whole gathers pass the card), phase
              16's train step (AdamW, remat, 2 steps of 2 x 256 tokens;
              mixtral 4 x 32) on phase 18's 4 ranks under rules on meshes
              (1, 4) and (2, 2), each rank's params and AdamW state its
              blocks, made leaf by leaf; the single-process card steps
              shared by CUDA IPC (mixtral on (2, 2) against one process
              dispatching in the mesh's two groups).  Each case: every
              rank's blocks of params, mu, nu and count equal the single
              process's bit for bit, the loss and grad_norm of every step
              equal on every rank, each rank's params + mu + nu bytes ==
              ``params_sharding``'s blocks, peak memory a rank, every
              kernel wrapper's count 0 (the path runs no hand-written
              kernel).  Then the (1, 4) state checkpointed by the
              launcher's path (gathered, rank 0 writes) is restored onto
              (2, 2) and into one process, and one more step on each
              equals the single process's third step bit for bit.  The
              train launcher itself (``launch.train --model-axis``, smoke
              llama: it takes the published 16 layers or the smoke
              config) runs over the ranks on (1, 4) and on (2, 2) with
              ``save_async`` checkpoints, its log and final blocks equal
              to one process's launcher run; then host 3 fails and
              ``ckpt.straggler.resume`` restores its last checkpoint onto
              the survivors' (1, 2) mesh, one step there at accum x 2
              equal to one process's step at accum 2, bit for bit.
21. summary - the card's line, a ``{"kernels": [...]}`` line (the eight
              kernels, launches by path, and the launches the profiler saw
              on the graph engines by path), then the ``{"ok": true, ...}``
              line last.

It imports nothing of jax or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
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


def ptxas_text() -> str:
    """ptxas's report (``-Xptxas -v``) of the decode attention libraries
    (``kernels/_build.py``: f32 and bf16, each its own nvcc): what this
    process's build printed, or, for a library built before it, an
    ``nvcc -cubin -Xptxas -v`` of the same source and flags under
    build/."""
    from repro_torch.kernels import _build
    text = ""
    for name in _build.VARIANTS:
        if name in _build.LOGS:
            text += _build.LOGS[name]
            continue
        out = ROOT / "build" / f"{name}_ptxas.cubin"
        out.parent.mkdir(parents=True, exist_ok=True)
        flags = [f for f in _build._flags(name) if f not in
                 ("-shared", "-Xcompiler", "-fPIC")]
        proc = subprocess.run([_build._nvcc(), *flags, "-cubin", "-o",
                               str(out), str(_build._source(name))],
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"nvcc -Xptxas -v failed:\n"
              f"{(proc.stdout + proc.stderr)[-2000:]}")
        text += proc.stdout + proc.stderr
    return text


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each ``flash_decode_kernel``
    instantiation at D 112 or G 1 (zamba2's shared attention: the
    latest shapes added), from ptxas's report: "dtype D G partial" ->
    (registers, spill stores, spill loads)."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"flash_decode_kernelI(13__nv_bfloat16|f)Li(\d+)ELi"
                      r"(\d+)ELb([01])E", line)
        if "Compiling entry function" in line:
            cur = None
            if m:
                dt = "bf16" if m.group(1) != "f" else "f32"
                D, G = int(m.group(2)), int(m.group(3))
                if D == 112 or G == 1:
                    cur = f"{dt} D{D} G{G} {'partial' if m.group(4) == '1' else 'out'}"
                    out[cur] = [0, 0, 0]
        elif cur and "spill stores" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out[cur][1:] = n[1:3]
        elif cur and "Used" in line and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers",
                                        line).group(1))
    check(len(out) == 36, f"ptxas report: {len(out)} D 112 / G 1 "
          "instantiations, want 36")
    return {k: tuple(v) for k, v in out.items()}


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
# 32-128-token prompts give llama M = 32-128 and mixtral M = 31-127; phase
# 8's eval forward runs llama at M = B*S = 4 * 128 = 512.
NM_MATMUL_SHAPES = {
    "llama3.2-1b": ({"wq": (2048, 2048), "wk": (2048, 512),
                     "wv": (2048, 512), "wo": (2048, 2048),
                     "up": (2048, 8192), "gate": (2048, 8192),
                     "down": (8192, 2048)}, (1, 4, 16, 64, 512)),
    "mixtral-8x22b": ({"wq": (6144, 6144), "wk": (6144, 1024),
                       "wv": (6144, 1024), "wo": (6144, 6144)},
                      (1, 4, 31, 127)),
    # an mla_moe layer's projections at decode (the absorbed decode reads
    # w_uk / w_uv dense); prefill adds w_uk and w_uv, and the dense first
    # layer its MLP (NM_MATMUL_EXTRA); packed2 only, the layout it serves
    "deepseek-v2-lite-16b": ({"wq": (2048, 3072), "w_dkv": (2048, 576),
                              "wo": (2048, 2048), "shared up": (2048, 2816),
                              "shared gate": (2048, 2816),
                              "shared down": (2816, 2048)}, (4, 127)),
    # phase 14: a zamba2-7b mamba layer (the shared block's 7 projections
    # in NM_MATMUL_EXTRA), and an xlstm-125m mLSTM + sLSTM layer pair;
    # prefills run at the exact prompt length (recurrent kinds)
    "zamba2-7b": ({"in_proj": (3584, 14576), "out_proj": (7168, 3584)},
                  (4, 127)),
    "xlstm-125m": ({"up": (768, 3072), "wq": (1536, 1536),
                    "wk": (1536, 1536), "wv": (1536, 1536),
                    "w_if": (1536, 8), "down": (1536, 768),
                    "w_in": (768, 3072), "ff_up": (768, 2048),
                    "ff_down": (1024, 768)}, (4, 127)),
    # phase 15: a whisper-small decoder layer's projections (the
    # encoder's and the cross K/V have the same (K, N)), at decode, the
    # decoder's prefill (4 x 32 rows) and the encoder's and cross K/V's
    # (4 x 1536 rows); a pixtral-12b layer's at decode and at the
    # launcher's prefill of 4 x (256 + 64) rows
    "whisper-small": ({"wq": (768, 768), "wk": (768, 768),
                       "wv": (768, 768), "wo": (768, 768),
                       "up": (768, 3072), "gate": (768, 3072),
                       "down": (3072, 768)}, (4, 128, 6144)),
    "pixtral-12b": ({"wq": (5120, 4096), "wk": (5120, 1024),
                     "wv": (5120, 1024), "wo": (4096, 5120),
                     "up": (5120, 14336), "gate": (5120, 14336),
                     "down": (14336, 5120)}, (4, 1280)),
}
NM_MATMUL_EXTRA = {"deepseek-v2-lite-16b": {
    "w_uk": (512, 2048), "w_uv": (512, 2048), "dense up": (2048, 10944),
    "dense gate": (2048, 10944), "dense down": (10944, 2048)},
    "zamba2-7b": {"shared wq": (3584, 3584), "shared up": (3584, 14336),
                  "shared down": (14336, 3584)}}
PACKED2_ONLY = ("deepseek-v2-lite-16b", "zamba2-7b", "xlstm-125m",
                "whisper-small", "pixtral-12b")
# mixtral-8x22b's expert banks, (K, N) per expert, its expert count, and
# the capacities C (rows per expert) its kernel calls see: 4 at decode
# (4 slots), 16-40 for prefills of 31-127 tokens
EXPERT_SHAPES = {"up": (6144, 16384), "gate": (6144, 16384),
                 "down": (16384, 6144)}
EXPERTS = 8
EXPERT_MS = (1, 4, 16, 24, 32, 40)
# deepseek-v2-lite-16b's banks: 64 experts, C 4 at decode (4 slots), 8-16
# at its prefills of 31-127 tokens (top-6 of 64)
DEEPSEEK_EXPERTS = (64, {"up": (2048, 1408), "gate": (2048, 1408),
                         "down": (1408, 2048)}, (4, 16))
BF16_TOL, F32_TOL = 2e-2, 1e-4     # rtol = atol, kernel against plain


def _layer_totals(rows: list, shapes: dict, M: int = 4) -> dict:
    """One layer's projections at M rows (M = 4: a decode step), packed2:
    the sums over them."""
    per = {(r["K"], r["N"]): r for r in rows
           if r["M"] == M and r["layout"] == "packed2"}
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
        for K, N in sorted(set(shapes.values())
                           | set(NM_MATMUL_EXTRA.get(path, {}).values())):
            w = torch.randn((K, N), generator=g, device=dev) * K ** -0.5
            vals, idx = ref.compress_24(w)
            vals = vals.to(torch.bfloat16)
            dense = ref.decompress_24(vals, idx)
            for layout in ((LAYOUT_PACKED2,) if path in PACKED2_ONLY
                           else (LAYOUT_PACKED2, LAYOUT_INT8)):
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
        by_path[path] = {**_layer_totals(path_rows, shapes), "by_M": {},
                         "rows": [r for r in path_rows
                                  if path in PACKED2_ONLY]}
        for M in ms_:
            tot = by_path[path]["by_M"][M] = _layer_totals(path_rows,
                                                           shapes, M)
            print(f"  nm_matmul, one {path} layer's projections at M={M:3d} "
                  f"({_row_kind(M)}"
                  f", packed2): kernel {tot['ms']:.4f} ms, torch.matmul"
                  f"(dense) {tot['library_ms']:.4f} ms, bound "
                  f"{tot['bound_ms']:.4f} ms ({tot['bound_by']}), "
                  f"{tot['bound_ms'] / tot['ms']:.1%} of bound, "
                  f"{tot['ms'] / tot['library_ms']:.2f}x torch.matmul")
    return {"max_abs_err": max_err, **by_path["llama3.2-1b"],
            "by_path": by_path}


def _row_kind(M: int) -> str:
    if M == 4:
        return "decode"
    return "eval, B*S" if M == 512 else "prefill" if M > 4 else "M=1"


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


def phase_nm_matmul_expert(torch, dev, E=EXPERTS, shapes=EXPERT_SHAPES,
                           ms_=EXPERT_MS, layouts=None, name="mixtral"
                           ) -> dict:
    """E experts at the capacities of a main path (mixtral's E = 8 by
    default: both banks, both layouts; deepseek's E = 64 packed2)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                             nm_matmul_expert,
                                             nm_matmul_expert_plain)
    from repro_torch.sparse.formats import _pack_idx2
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    rows, max_err = [], 0.0
    for K, N in sorted(set(shapes.values())):
        comp = [ref.compress_24(torch.randn((K, N), generator=g, device=dev)
                                * K ** -0.5) for _ in range(E)]
        vals = torch.stack([v for v, _ in comp]).to(torch.bfloat16)
        idx = torch.stack([i for _, i in comp])
        del comp
        dense = ref.decompress_24(vals, idx)      # masked-dense bank, bf16
        for layout in layouts or (LAYOUT_PACKED2, LAYOUT_INT8):
            plane = _pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
            w_bytes = vals.numel() * 2 + plane.numel()
            for M in ms_:
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
    by_c = {}
    for M in ms_:
        tot = by_c[M] = _layer_totals(rows, shapes, M)
        print(f"  nm_matmul_expert, one {name} layer's banks at E={E} "
              f"C={M:2d} (packed2): kernel {tot['ms']:.4f} ms, "
              f"torch.bmm(dense) {tot['library_ms']:.4f} ms, bound "
              f"{tot['bound_ms']:.4f} ms, "
              f"{tot['bound_ms'] / tot['ms']:.1%} of bound, "
              f"{tot['ms'] / tot['library_ms']:.2f}x torch.bmm")
    return {"max_abs_err": max_err, **_layer_totals(rows, shapes, ms_[0]
                                                    if 4 not in ms_ else 4),
            "by_C": by_c}


# decode attention: (label, B, K, G, D, C, shard counts), bf16.  llama's
# serving shapes (4 slots x 8 kv heads x 4 query heads of 64, the serving
# phases' capacity 256), its long cache, mixtral's heads at its 4096-slot
# window, and the smoke heads at a C that is no multiple of any chunk of
# the kernel.  Rows sit at different positions; row 1 sees only half of
# the first shard, so each later shard of it is all-masked.
FLASH_CASES = (("llama serving", 4, 8, 4, 64, 256, (1, 4)),
               ("llama long cache", 4, 8, 4, 64, 8192, (1, 4, 16)),
               ("mixtral window", 4, 8, 6, 128, 4096, (1, 4)),
               ("ragged C, smoke heads", 3, 2, 2, 32, 148, (1, 4)),
               # phase 10's shapes: gemma3-1b's one kv head of 4 x 256 at
               # its 512-slot window and a global layer's long cache,
               # yi-6b's 4 kv heads of 8 x 128 at serving and long caches
               ("gemma3 window", 4, 1, 4, 256, 512, (1, 4)),
               ("gemma3 long cache", 4, 1, 4, 256, 8192, (1, 4)),
               ("yi serving", 4, 4, 8, 128, 256, (1, 4)),
               ("yi long cache", 4, 4, 8, 128, 8192, (1, 4)),
               # phase 14's zamba2-7b shared attention: 32 kv heads of one
               # query head of 112 at serving and long caches
               ("zamba2 serving", 4, 32, 1, 112, 256, (1, 4)),
               ("zamba2 long cache", 4, 32, 1, 112, 8192, (1, 4)),
               # phase 15's whisper-small: 12 kv heads of one query head
               # of 64 on the launcher's self ring (64 slots) and the
               # cross cache of 1536 encoder slots; pixtral-12b's 8 kv
               # heads of 4 x 128 at the engine's capacity and the
               # launcher's (256 image + 64 + 17 slots)
               ("whisper self ring", 4, 12, 1, 64, 64, (1, 4)),
               ("whisper cross cache", 4, 12, 1, 64, 1536, (1, 4)),
               ("pixtral serving", 4, 8, 4, 128, 256, (1, 4)),
               ("pixtral launcher", 4, 8, 4, 128, 337, (1,)))
# the cases also held against their plain versions in f32 (checked, not
# timed): f32 at D 256 takes the kernel's one-stage ring
FLASH_F32 = ("gemma3 window", "gemma3 long cache", "yi serving",
             "yi long cache", "zamba2 serving")
FLASH_KERNELS = ("flash_decode", "flash_decode_partial", "combine_partials")


def flash_operands(torch, g, B, K, G, D, C, S, dev, copies=1):
    """q, bias (0 / -1e30 from per-row positions, as decode_attend builds
    it) and ``copies`` distinct bf16 K/V caches."""
    n = C // S
    pos = ([C - 1, n // 2, C // 2 + 3] + [0] * B)[:B]
    ok = torch.arange(C, device=dev)[None, :] <= torch.tensor(
        pos, device=dev)[:, None]
    bias = torch.where(ok, 0.0, -1e30).to(torch.float32)
    q = (0.5 * torch.randn((B, K, G, D), generator=g, device=dev)).to(
        torch.bfloat16)
    kvs = [tuple((0.5 * torch.randn((B, C, K, D), generator=g, device=dev))
                 .to(torch.bfloat16) for _ in range(2))
           for _ in range(copies)]
    return q, bias, ok, kvs


def flash_ratio(torch, name, args, got, shards=None, scale=None):
    """The largest |kernel - plain| over its tolerance, for one call of a
    decode attention kernel: f32 outputs 2e-4 of |plain| + the sum of the
    absolute terms (sum p |v|: sums in another order, exp within an ulp)
    + 2e-5; a bf16 output one bf16 ulp of |plain| more; an all-masked
    shard's m and l exactly (-1e30 and its slot count)."""
    from repro_torch.kernels import ref
    if name == "combine_partials":
        acc, m, l, dt = args
        want = ref.combine_partials_ref(acc, m, l, torch.float32)
        terms = ref.combine_partials_ref(acc.abs(), m, l, torch.float32)
        outs = [(got, want, terms, dt)]
    elif name == "flash_decode":
        q, k, v, bias = args
        want = ref.flash_decode_ref(q, k, v, bias, scale=scale).float()
        terms = ref.flash_decode_ref(q, k, v.abs(), bias,
                                     scale=scale).float()
        outs = [(got, want, terms, q.dtype)]
    else:
        q, k, v, bias = args
        wa, wm, wl = ref.flash_decode_shards_ref(q, k, v, bias, scale=scale,
                                                 shards=shards)
        ta = ref.flash_decode_shards_ref(q, k, v.abs(), bias, scale=scale,
                                         shards=shards)[0]
        acc, m, l = got
        dead = wm == -1e30
        n = k.shape[1] // shards
        check(bool((m[dead] == -1e30).all()) and bool((l[dead] == n).all()),
              f"flash_decode_partial {tuple(k.shape)} S={shards}: an "
              "all-masked shard does not flush m = -1e30, l = its slots")
        outs = [(acc, wa, ta, torch.float32), (m, wm, wm.abs(), torch.float32),
                (l, wl, wl, torch.float32)]
    worst, err = 0.0, 0.0
    for g_, w, t, dt in outs:
        tol = 2e-4 * (w.abs() + t) + 2e-5
        if dt == torch.bfloat16:
            tol = tol + w.abs() * 2 ** -7
        e = (g_.float() - w).abs()
        worst = max(worst, float((e / tol).max()))
        err = max(err, float(e.max()))
    return worst, err


def phase_flash_decode(torch, dev) -> dict:
    """flash_decode, flash_decode_partial and the combine against their
    plain versions at each case; device times of the kernels, the plain
    versions and ``F.scaled_dot_product_attention`` on the same work (the
    port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  flash_decode,
                                                  flash_decode_partial,
                                                  plan_splits)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    rows = []
    for label, B, K, G, D, C, shard_counts in FLASH_CASES:
        kv_bytes = 2 * B * C * K * D * 2
        copies = max(1, -(-2 * L2_BYTES // kv_bytes))
        for S in shard_counts:
            q, bias, ok, kvs = flash_operands(torch, g, B, K, G, D, C, S,
                                              dev, copies)
            k, v = kvs[0]
            got = flash_decode(q, k, v, bias)
            parts = flash_decode_partial(q, k, v, bias, shards=S)
            comb = combine_partials(*parts, q.dtype)
            torch.cuda.synchronize()
            r_fd, e_fd = flash_ratio(torch, "flash_decode", (q, k, v, bias),
                                     got)
            r_p, e_p = flash_ratio(torch, "flash_decode_partial",
                                   (q, k, v, bias), parts, S)
            r_c, e_c = flash_ratio(torch, "combine_partials",
                                   (*parts, q.dtype), comb)
            # the combine of the kernel's partials against flash_decode_ref
            r_e, _ = flash_ratio(torch, "flash_decode", (q, k, v, bias), comb)
            checks = [("flash_decode", r_fd), ("flash_decode_partial", r_p),
                      ("combine_partials", r_c),
                      ("partial + combine vs flash_decode_ref", r_e)]
            f32 = None
            if label in FLASH_F32:
                fq, fk, fv = q.float(), k.float(), v.float()
                f_parts = flash_decode_partial(fq, fk, fv, bias, shards=S)
                f_out = flash_decode(fq, fk, fv, bias)
                f_comb = combine_partials(*f_parts, torch.float32)
                torch.cuda.synchronize()
                f32 = {"flash_decode": flash_ratio(
                    torch, "flash_decode", (fq, fk, fv, bias), f_out),
                    "flash_decode_partial": flash_ratio(
                        torch, "flash_decode_partial", (fq, fk, fv, bias),
                        f_parts, S),
                    "combine_partials": flash_ratio(
                        torch, "flash_decode", (fq, fk, fv, bias), f_comb)}
                checks += [(f"{n} f32", r[0]) for n, r in f32.items()]
                del fq, fk, fv, f_parts, f_out, f_comb
            for what, r in checks:
                check(r <= 1, f"{what} {label} B={B} K={K} G={G} D={D} "
                      f"C={C} S={S}: {r:.3f} of the tolerance")
            qb, ob = B * K * G * D * 2, B * K * G * D * 2
            base = kv_bytes + qb + B * C * 4
            ops = 4 * B * K * G * C * D
            part_bytes = S * B * K * G * (D + 2) * 4
            b_fd = bound(base + ob, ops, F32_OPS_PER_S)
            b_p = bound(base + part_bytes, ops, F32_OPS_PER_S)
            b_c = bound(part_bytes + ob, 3 * S * B * K * G * (D + 2),
                        F32_OPS_PER_S)
            ms_p = device_ms(torch, lambda i: flash_decode_partial(
                q, *kvs[i], bias, shards=S), copies)
            plain_p = device_ms(torch, lambda i: ref.flash_decode_shards_ref(
                q, *kvs[i], bias, shards=S), copies)
            ms_c = device_ms(torch, lambda i: combine_partials(
                *parts, q.dtype), 8)
            plain_c = device_ms(torch, lambda i: ref.combine_partials_ref(
                *parts, q.dtype), 8)
            splits = plan_splits(B, K, C, S, sms)
            row = {"case": label, "B": B, "K": K, "G": G, "D": D, "C": C,
                   "S": S, "splits": splits, "flash_decode_partial": {
                       "max_abs_err": e_p, "ms": ms_p, "plain_ms": plain_p,
                       "library_ms": None, "bound_ms": b_p[0],
                       "bound_by": b_p[1]},
                   "combine_partials": {
                       "max_abs_err": e_c, "ms": ms_c, "plain_ms": plain_c,
                       "library_ms": None, "bound_ms": b_c[0],
                       "bound_by": b_c[1]}}
            if f32:
                row["f32_max_abs_err"] = {n: r[1] for n, r in f32.items()}
                print(f"  f32 {label} C={C} S={S}: flash_decode, "
                      f"flash_decode_partial, partial + combine within "
                      + ", ".join(f"{r[0]:.3f}" for r in f32.values())
                      + " of the tolerance (max err "
                      + ", ".join(f"{r[1]:.1e}" for r in f32.values()) + ")")
            if S == 1:
                ms = device_ms(torch, lambda i: flash_decode(
                    q, *kvs[i], bias), copies)
                plain = device_ms(torch, lambda i: ref.flash_decode_ref(
                    q, *kvs[i], bias), copies)
                # the yardstick: SDPA, query heads k*G + g on kv head k
                qs = q.reshape(B, K * G, 1, D)
                mask = ok[:, None, None, :]
                lib_args = [(kk.transpose(1, 2), vv.transpose(1, 2))
                            for kk, vv in kvs]
                try:
                    lib_out = F.scaled_dot_product_attention(
                        qs, *lib_args[0], attn_mask=mask, enable_gqa=True)
                    lib_err = float((lib_out.reshape(B, K, G, D).float()
                                     - got.float()).abs().max())
                    lib = device_ms(
                        torch, lambda i: F.scaled_dot_product_attention(
                            qs, *lib_args[i], attn_mask=mask,
                            enable_gqa=True), copies)
                except RuntimeError as e:     # a backend that refuses
                    print(f"  SDPA refused this work: {e}")
                    lib, lib_err = None, None
                row["flash_decode"] = {
                    "max_abs_err": e_fd, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "bound_ms": b_fd[0],
                    "bound_by": b_fd[1], "library_max_abs_diff": lib_err}
                sdpa = ("SDPA refused" if lib is None else
                        f"SDPA {lib * 1e3:8.2f} us (|SDPA - kernel| "
                        f"{lib_err:.1e})")
                print(f"  flash_decode {label:22s} B={B} K={K} G={G} D={D:3d}"
                      f" C={C:5d} P={splits}  err {e_fd:.2e}  kernel "
                      f"{ms * 1e3:8.2f} us"
                      f"  plain {plain * 1e3:8.2f} us  {sdpa}  bound "
                      f"{b_fd[0] * 1e3:6.2f} us ({b_fd[1]})  "
                      f"{b_fd[0] / ms:6.1%} of bound")
            print(f"  flash_decode_partial {label:22s} C={C:5d} S={S:2d} "
                  f"P={splits}  err {e_p:.2e}  kernel {ms_p * 1e3:8.2f} us  "
                  f"plain {plain_p * 1e3:8.2f} us  bound {b_p[0] * 1e3:6.2f} us "
                  f"({b_p[1]})  {b_p[0] / ms_p:6.1%} of bound; combine "
                  f"err {e_c:.2e}  kernel {ms_c * 1e3:6.2f} us  plain "
                  f"{plain_c * 1e3:7.2f} us  bound {b_c[0] * 1e3:5.2f} us; "
                  f"partial + combine {(ms_p + ms_c) * 1e3:8.2f} us")
            rows.append(row)
            del kvs, k, v, parts
            torch.cuda.empty_cache()
    return {"rows": rows}


# one mixtral-8x22b expert-bank leaf as the search's kernels take it:
# (E, K, N) = (8, 6144, 16384), f32, as an (8 * 6144, 16384) view
EXPERT_LEAF = (8, 6144, 16384)
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


def f32_issue_per_s(torch, dev) -> float:
    """Unfused f32 instructions the card can issue a second: one per lane
    (128 per SM) per clock at the card's top SM clock (nvidia-smi's
    clocks.max.sm).  A kernel built with -fmad=false runs each op as its own
    instruction, so this, and not the FMA-counted 67e12, bounds it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return sms * 128 * mhz * 1e6


def phase_prox24(torch, dev, paths: dict, untimed: tuple = ()) -> dict:
    """prox24 in place (as the search runs it) against ref.prox24_ref, bit
    for bit, at each leaf shape of each calibration path; bounds by bytes
    (over 67e12 f32 ops a second, the table's) and by the issue rate of its
    unfused f32 ops.  The paths named in ``untimed`` are checked only."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_prox import prox24
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    issue_rate = f32_issue_per_s(torch, dev)
    print(f"  unfused f32 issue rate {issue_rate:.4g} /s (SMs x 128 lanes x "
          "the top SM clock)")
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
            if path in untimed:
                print(f"  prox24 f32 ({R:6d}, {N:5d}) in place  "
                      f"bit-identical  ({path}, not timed)")
                continue
            copies = max(1, -(-2 * L2_BYTES // (R * N * 4)))
            ws = [w.clone() for _ in range(copies)]
            ms = device_ms(torch, lambda i: prox24(ws[i], lam=PROX_LAM,
                                                   out=ws[i]), copies)
            plain = device_ms(torch, lambda i: ref.prox24_ref(
                ws[i], PROX_LAM), copies)
            del ws, w
            torch.cuda.empty_cache()
            b_ms, b_by = bound(R * N * 8, R * N * PROX_OPS, F32_OPS_PER_S)
            issue_ms = R * N * PROX_OPS / issue_rate * 1e3
            path_rows.append({"LKN": (L, K, N), "max_abs_err": err,
                              "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                              "bound_by": b_by, "issue_bound_ms": issue_ms})
            print(f"  prox24 f32 ({R:6d}, {N:5d}) in place  bit-identical  "
                  f"kernel {ms:8.4f} ms  plain {plain:8.4f} ms  bound "
                  f"{b_ms:7.4f} ms ({b_by})  {b_ms / ms:6.1%} of bound; "
                  f"issue bound {issue_ms:7.4f} ms  {issue_ms / ms:6.1%}")
        if path in untimed:
            continue
        out[path] = _per_step(path_rows, leaves)
        by = {r["LKN"]: r for r in path_rows}
        out[path]["issue_bound_ms"] = sum(by[lkn]["issue_bound_ms"]
                                          for lkn in leaves.values())
        rows += path_rows
        print(f"  prox24, one {path} search step ({len(leaves)} leaves): "
              "kernel "
              f"{out[path]['ms']:.4f} ms, plain {out[path]['plain_ms']:.4f}"
              f" ms, bound {out[path]['bound_ms']:.4f} ms "
              f"({out[path]['bound_by']}), issue-rate bound "
              f"{out[path]['issue_bound_ms']:.4f} ms ({PROX_OPS} unfused f32 "
              "instructions per weight); no single PyTorch call computes it "
              "(the plain version is the unfused torch chain)")
    first = next(iter(paths))
    return {"max_abs_err": max(r["max_abs_err"] for r in rows), **out[first],
            "by_path": out}


def phase_saliency(torch, dev, paths: dict, untimed: tuple = ()) -> dict:
    """saliency_fused_step against its plain version, bit for bit, at each
    leaf shape of each calibration path: wanda, magnitude and ria, with
    and without the median divisor; timed as the search runs it (wanda,
    divisor, in place over V and Gamma), except on the paths named in
    ``untimed``."""
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
            if path in untimed:
                print(f"  saliency_fused_step ({R:6d}, {N:5d}) 6 variants "
                      f"bit-identical  ({path}, not timed)")
                continue
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
        if path in untimed:
            continue
        out[path] = _per_step(path_rows, leaves)
        rows += path_rows
        print(f"  saliency_fused_step, one {path} search step "
              f"({len(leaves)} leaves): "
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


# 2:4 projections of a recurrent layer kind (each a forward, prefill or
# decode): mamba's in_proj and out_proj, mamba_shared's and the shared
# block's wq, wk, wv, wo, up, gate, down; mLSTM's up, wq, wk, wv, w_if,
# down; sLSTM's w_in, ff_up, ff_down
RECURRENT_PROJECTIONS = {"mamba": 2, "mamba_shared": 9, "mlstm": 6,
                         "slstm": 3}


def path_launches(cfg) -> dict:
    """Each 2:4 kernel's launches in one forward of ``cfg``'s compressed
    model, {"prefill": {...}, "decode": {...}}: per layer, one
    ``nm_matmul`` per 2-D projection (attn / local / moe kinds: wq, wk,
    wv, wo, and up, gate, down of a dense MLP; MLA: wq, w_dkv, wo, w_uk and
    w_uv at prefill only (the absorbed decode reads those two dense), and
    up, gate, down of the dense or shared MLP; the recurrent kinds:
    RECURRENT_PROJECTIONS; whisper's ``dec``: the cross-attention's wq,
    wk, wv and wo at prefill, wq and wo at decode (the cross K/V are
    cached), and at prefill 7 a layer of its encoder) and one
    ``nm_matmul_expert`` per expert bank (3 a MoE layer)."""
    out = {f: {n: 0 for n in PATH_KERNELS} for f in ("prefill", "decode")}
    out["prefill"]["nm_matmul"] += 7 * cfg.encoder_layers
    for kind in cfg.layer_kinds:
        if kind in RECURRENT_PROJECTIONS:
            for f in out:
                out[f]["nm_matmul"] += RECURRENT_PROJECTIONS[kind]
            continue
        mla = kind.startswith("mla")
        moe = "moe" in kind
        mlp = 3 if (not moe or cfg.num_shared_experts) else 0
        for f in out:
            attn = (5 if f == "prefill" else 3) if mla else 4
            if kind == "dec":
                attn += 4 if f == "prefill" else 2
            out[f]["nm_matmul"] += attn + mlp
            out[f]["nm_matmul_expert"] += 3 if moe else 0
    return out


def weights_whole(torch, dev, cfg) -> dict:
    """``cfg``'s weights from ``init_params`` (seed 0), 2:4 magnitude masks
    (``baseline_masks``, one ``nm_mask24`` launch a stacked leaf) and
    packed2 compression (``sparsify_params``): the compressed tree, the
    masks, a maker of the masked-dense bf16 tree, the parameter count,
    the masks made and the export's seconds."""
    from repro_torch import tree
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.models import model as M
    from repro_torch.sparse.apply import sparsify_params
    params0 = M.init_params(cfg, 0, device=dev)
    n_params = sum(x.numel() for x in tree.leaves(params0))
    stats = tree.tree_map(lambda _: None, params0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = baseline_masks("magnitude", params0, stats, 0.5, mode="nm")
    sparse = sparsify_params(params0, masks, axes=M.param_axes(cfg),
                             idx_bits=2, dtype=torch.bfloat16)
    torch.cuda.synchronize()

    def masked():
        return M.serving_params(tree.tree_map(
            lambda w, m: w if m is None else (w * m).to(torch.bfloat16),
            params0, masks))
    return {"sparse": sparse, "masks": masks, "masked": masked,
            "n_params": n_params, "masks_made": sum(
                m is not None for m in tree.leaves(masks)),
            "export_s": time.perf_counter() - t0}


def weights_by_layer(torch, dev, cfg) -> dict:
    """What :func:`weights_whole` gives, for a model whose f32 tree does not
    fit the card at once (deepseek-v2-lite: 62.8 GB): each leaf drawn from
    its ``ParamSpec`` (``model.param_specs``), a stacked prunable leaf one
    layer slice at a time (f32 draw, ``baseline_masks`` magnitude 2:4
    through ``nm_mask24``, ``pack_nm`` packed2 into the stacked compressed
    leaf, the f32 slice and its mask freed before the next).  No mask tree
    is kept; the masked-dense bf16 tree is the compressed leaves'
    ``to_dense()``, a layer slice at a time."""
    from repro_torch import tree
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.core.prunable import prunable_map
    from repro_torch.models import model as M
    from repro_torch.sparse.formats import SparseTensor
    from repro_torch.sparse.pack import pack_nm
    specs = M.param_specs(cfg)
    prunable = dict(tree.flatten_with_path(prunable_map(specs)))
    axes = dict(tree.flatten_with_path(M.param_axes(cfg)))
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    out, n_masks, export_s, n_params = {}, 0, 0.0, 0
    for path, spec in tree.flatten_with_path(specs):
        n_params += math.prod(spec.shape)
        if not prunable[path]:
            out[path] = spec.draw(g, dev)
            continue
        lead = spec.shape[0] if axes[path].startswith("layers|") else None
        vals = idx = None
        for i in range(lead or 1):
            w = spec.draw(g, dev, index=(i,) if lead else ())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = baseline_masks("magnitude", {"kernel": w}, {"kernel": None},
                               0.5, mode="nm")["kernel"]
            st = pack_nm(w, m, idx_bits=2, dtype=torch.bfloat16)
            del w, m
            if lead is None:
                vals, idx = st.vals, st.idx
            else:
                if vals is None:
                    vals = torch.empty((lead, *st.vals.shape),
                                       dtype=st.vals.dtype, device=dev)
                    idx = torch.empty((lead, *st.idx.shape),
                                      dtype=st.idx.dtype, device=dev)
                vals[i].copy_(st.vals)
                idx[i].copy_(st.idx)
            del st
            torch.cuda.synchronize()
            export_s += time.perf_counter() - t0
            n_masks += 1
        out[path] = SparseTensor(vals, idx, idx_bits=2)
    sparse = tree.map_with_path(lambda p, _: out[p], specs)
    del out

    def dense(x):
        if not isinstance(x, SparseTensor):
            return x
        if x.ndim == 2:         # an unstacked leaf (zamba2's shared block)
            return x.to_dense().to(torch.bfloat16)
        d = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
        for i in range(x.shape[0]):
            d[i] = x.select(i).to_dense()
        return d

    def masked():
        return M.serving_params(tree.tree_map(dense, sparse))
    return {"sparse": sparse, "masks": None, "masked": masked,
            "n_params": n_params, "masks_made": n_masks,
            "export_s": export_s}


def _routed_sets(ids) -> "torch.Tensor":
    """(G, T, k) expert ids -> (T, k) sorted: the set each token routes to."""
    return ids.reshape(-1, ids.shape[-1]).sort(dim=-1).values


@contextlib.contextmanager
def first_call_per_signature(calls: dict):
    """While open, every call that ``sparse/apply.py`` and
    ``kernels/shard.py`` make to a 2:4 kernel wrapper, and every call that
    ``models/attention.py`` and
    ``kernels/shard.py`` make to a decode attention wrapper
    (``kernels/flash_decode.py``, imported there by name), keeps, for the first call at each
    distinct signature (kernel, shapes, dtypes, layout or shards), its
    inputs and the output the path went on with.  The wrappers themselves
    run and count as usual."""
    import torch
    from repro_torch.kernels import shard
    from repro_torch.models import attention
    from repro_torch.sparse import apply as sparse_apply
    # where the 2:4 path looks its wrappers up: sparse/apply.py, and
    # kernels/shard.py's tensor-parallel wrappers (phase 18)
    saved = {(mod, name): getattr(mod, name) for mod in (sparse_apply, shard)
             for name in PATH_KERNELS}
    # where the decode attention path looks its wrappers up
    saved_fd = {(mod, name): getattr(mod, name) for mod, name in (
        (attention, "flash_decode"), (shard, "flash_decode_partial"),
        (shard, "combine_partials"))}

    def clone(x):
        if isinstance(x, tuple):
            return tuple(clone(y) for y in x)
        return x.clone() if isinstance(x, torch.Tensor) else x

    def flash_recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            key = (name, tuple(tuple(a.shape) for a in args
                               if isinstance(a, torch.Tensor)),
                   args[0].dtype, args[-1] if name == "combine_partials"
                   else None, kw.get("shards"))
            if key not in calls:
                calls[key] = (clone(args), kw, clone(out))
            return out
        return call

    def recorder(name, fn):
        def call(x, vals, idx, **kw):
            out = fn(x, vals, idx, **kw)
            key = (name, tuple(x.shape), tuple(idx.shape), x.dtype,
                   kw.get("layout"), kw.get("out_dtype"))
            if key not in calls:
                calls[key] = (x.clone(), vals, idx, kw, out.clone())
            return out
        return call

    for (mod, name), fn in saved.items():
        setattr(mod, name, recorder(name, fn))
    for (mod, name), fn in saved_fd.items():
        setattr(mod, name, flash_recorder(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in {**saved, **saved_fd}.items():
            setattr(mod, name, fn)


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
    worst, n_cancel = 0.0, 0
    seen = {name: set() for name in PATH_KERNELS + FLASH_KERNELS}
    for key, rec in calls.items():
        name = key[0]
        if name in FLASH_KERNELS:
            args, kw, got = rec
            ratio, _ = flash_ratio(torch, name, args, got, kw.get("shards"),
                                   kw.get("scale"))
            check(ratio <= 1, f"{name} at {key[1]} on the main path: an "
                  f"output differs from its plain version by {ratio:.3f} "
                  "of the tolerance")
            worst = max(worst, ratio)
            seen[name].add(key[1][0] if name == "combine_partials"
                           else key[1][1] + ((key[4],) if key[4] else ()))
            continue
        x, vals, idx, kw, got = rec
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
                        for name, s in seen.items() if s)
            + " (decode attention: the K cache's shape and the shards; "
            "the combine: the partials' shape)")


@contextlib.contextmanager
def recording_routes(routes: list):
    """While open, every MoE routing appends (probs, sorted expert ids)
    per token: (T, E), (T, k)."""
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route

    def recording_route(router, x, top_k):
        out = route(router, x, top_k)
        routes.append((out[0].reshape(-1, out[0].shape[-1]),
                       _routed_sets(out[2])))
        return out

    moe_mod.route = recording_route
    try:
        yield routes
    finally:
        moe_mod.route = route


def record_decode(eng, routes: list) -> list:
    """From now on, each decode step of ``eng``: (rid per slot, fed
    tokens, positions, logits, the step's routings: what ``routes``
    gained during it).  ``del eng.fns.decode`` stops it."""
    steps, fn = [], eng.fns.decode

    def decode(params, toks, caches, t):
        r0 = len(routes)
        logits, caches = fn(params, toks, caches, t)
        steps.append(([None if r is None else r.rid for r in eng.active],
                      toks.clone(), t.clone(), logits.clone(),
                      routes[r0:]))
        return logits, caches

    eng.fns.decode = decode
    return steps


def compare_decode_runs(torch, ref_steps, got_steps, coupled: bool,
                        hold: bool = True):
    """Two engine runs of the same requests, row by row, for every decode
    row whose request has the same history in both (the same fed tokens,
    and the same experts wherever it routed):

    * if the row routes to other experts in some MoE layer, the first such
      layer is a near-tie: the reference's margin between an expert only
      it keeps and one only the other run keeps is at most twice the
      largest difference of the two runs' router probabilities there; the
      request is compared no further;
    * else its logits are within LOGIT_ULPS_FULL bf16 ulps of the
      reference row's largest, and where the greedy tokens differ, the
      reference's margin between the two tokens is at most twice the
      measured logit difference (a near-tie); the request is compared no
      further.

    ``coupled`` (MoE: the rows of a step share expert capacity): nothing
    after the first step with a near-tie.  ``hold`` off: the logits and
    tokens are measured and held to nothing (a model held layer by layer
    instead).  Returns (rows compared, worst logit error over its
    tolerance, token near-ties, routing near-ties)."""
    def rows(steps):
        return {(rid, int(t[s])): (i, s, int(toks[s]), lg[s], routes)
                for i, (rids, toks, t, lg, routes) in enumerate(steps)
                for s, rid in enumerate(rids) if rid is not None}
    ref_rows, got_rows = rows(ref_steps), rows(got_steps)
    diverged, ties, rerouted, stop = set(), [], [], None
    n, worst = 0, 0.0
    for key in sorted(ref_rows, key=lambda k: (ref_rows[k][0], k)):
        i, sa, tok_a, la, ra = ref_rows[key]
        if key[0] in diverged or key not in got_rows or (
                stop is not None and i > stop):
            continue
        _, sb, tok_b, lb, rb = got_rows[key]
        if tok_a != tok_b:
            diverged.add(key[0])
            continue
        flip = next((j for j, (x, y) in enumerate(zip(ra, rb, strict=True))
                     if not torch.equal(x[1][sa], y[1][sb])), None)
        if flip is not None:
            pa, pb = ra[flip][0][sa], rb[flip][0][sb]
            ia, ib = set(ra[flip][1][sa].tolist()), set(
                rb[flip][1][sb].tolist())
            perr = float((pa - pb).abs().max())
            margin = float(min(pa[x] for x in ia - ib)
                           - max(pa[y] for y in ib - ia))
            check(margin <= 2 * perr, f"request {key[0]} at position "
                  f"{key[1]}: experts {sorted(ia)} vs {sorted(ib)} in MoE "
                  f"layer {flip}, margin {margin} past twice the router "
                  f"probability difference {perr}")
            rerouted.append((key[0], key[1], flip, margin, perr))
        else:
            err, tol = logit_err(torch, lb, la, LOGIT_ULPS_FULL)
            check(err <= tol or not hold, f"request {key[0]} at position "
                  f"{key[1]}: logits differ by {err} over {tol} "
                  f"({LOGIT_ULPS_FULL} "
                  "bf16 ulps of the row's max)")
            n += 1
            worst = max(worst, err / tol)
            a, b = int(la.argmax()), int(lb.argmax())
            if a == b:
                continue
            margin = float(la[a] - la[b])
            check(margin <= 2 * err or not hold, f"request {key[0]} at "
                  f"position {key[1]}: tokens {a} vs {b} with margin "
                  f"{margin} past twice the logit difference {err}")
            ties.append((key[0], key[1], a, b, margin, err))
        diverged.add(key[0])
        if coupled and stop is None:
            stop = i
    return n, worst, ties, rerouted


def replay_matches_eager(torch, fn, state=()) -> bool:
    """``fn()`` (a decode step: the same inputs write the same cache slot)
    captured in a CUDA graph and replayed returns what it returns
    eagerly.  ``state``: the recurrent-state tensors the step advances
    (``model.state_leaves``), restored before each call after the first,
    so that every call starts from the same state."""
    saved = [t.clone() for t in state]

    def reset():
        for t, was in zip(state, saved, strict=True):
            t.copy_(was)

    want = fn().clone()
    reset()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        reset()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fn()
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    del graph
    return same


KV_SHARDS = (1, 4)      # the kv_shards of the serving runs besides None


def paired_graph_ms(torch, steps: dict, rounds: int = 10,
                    reps: int = 10) -> dict:
    """Each ``steps[key]()`` captured in a CUDA graph of its own; then
    ``rounds`` rounds that replay every graph ``reps`` times between CUDA
    events, in turns (the order reversed every other round).  key ->
    (median, min, max) ms of one replay: the step's device work with no
    host gap between its kernels, compared inside one call."""
    graphs = {}
    for key, fn in steps.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graphs[key] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[key]):
            fn()
    times = {key: [] for key in graphs}
    for r in range(rounds):
        for key in (list(graphs) if r % 2 == 0 else list(graphs)[::-1]):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(reps):
                graphs[key].replay()
            e1.record()
            e1.synchronize()
            times[key].append(e0.elapsed_time(e1) / reps)
    del graphs
    return {key: (statistics.median(t), min(t), max(t))
            for key, t in times.items()}


def decode_step_times(torch, M, cfg, params, batch, dev, kv_shards,
                      want_nm: int) -> dict:
    """One path's decode step at 4 slots: the eager wall time (median of
    steps 4-11), the step replayed from a CUDA graph against the eager
    step, a profiler's kernels over one eager step, and the step itself
    (``step``, with its own caches) for :func:`paired_graph_ms`.  A
    profiler window is taken again (up to PROFILE_TRIES) while its 2:4
    kernels are not ``want_nm`` a step: a window that lost records."""
    caches = M.init_caches(cfg, 4, 256, device=dev)
    tok = torch.from_numpy(batch[:4, 0]).to(dev)
    steps = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = M.decode_step(cfg, params, tok, caches, i,
                                       kv_shards=kv_shards)
        tok = logits.argmax(-1)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    t_dev = torch.full((4,), 30, dtype=torch.int32, device=dev)

    def step(i=0):
        return M.decode_step(cfg, params, tok, caches, t_dev,
                             kv_shards=kv_shards)[0]

    replay_ok = replay_matches_eager(torch, step,
                                     M.state_leaves(cfg, caches))
    for tries in range(1, PROFILE_TRIES + 1):
        with profiler_window(torch) as prof:
            step()
        # the kernels themselves (an operator's row would count them twice)
        evs = [e for e in device_events(prof)
               if e.self_device_time_total > 0]
        nm = sum(e.count for e in evs if "nm_mma_kernel" in e.key
                 or "nm_simt_kernel" in e.key)
        if nm == want_nm:       # a window that lost records: again
            break
    return {"step_ms": statistics.median(steps[4:]) * 1e3,
            "step": step, "replay_ok": replay_ok,
            "kernels": sum(e.count for e in evs), "windows": tries,
            "nm_kernels": nm,
            "device_ms": sum(e.self_device_time_total for e in evs) / 1e3,
            "top": [(e.self_device_time_total, e.count, e.key)
                    for e in sorted(evs, key=lambda e:
                                    -e.self_device_time_total)[:8]]}


LONG_CAPACITY = 8192
LONG_KV_SHARDS = (None, 1, 4, 16)


def long_cache_steps(torch, M, cfg, params, dev,
                     paths=LONG_KV_SHARDS, by_layer: bool = False) -> dict:
    """The decode step of 4 slots at capacity 8192 with every slot valid:
    the caches filled from a seeded generator on the card (the positions
    0..8191 of each slot), one step at t = 8191 per ``kv_shards`` path of
    ``paths`` (None first), each on its own copy of the caches.  Each path's attention launches counted
    over one eager step; its logits held against ``kv_shards=None`` (8 bf16
    ulps of the row's max); its step replayed from a CUDA graph == eager;
    then the paths' graphs timed in turns.  ``by_layer``: each path is
    held against None layer by layer on the same input instead
    (:func:`step_by_layer`), its logits' distance printed.  kv_shards ->
    numbers."""
    from repro_torch import tree
    from repro_torch.kernels import flash_decode as fd
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    base = M.init_caches(cfg, 4, LONG_CAPACITY, device=dev)
    n_bytes = 0
    # every cache leaf drawn (a recurrent state too); the K/V bytes counted
    for path, t in tree.flatten_with_path(base):
        t.normal_(generator=g)
        if path.endswith(("['k']", "['v']")):
            n_bytes += t.numel() * t.element_size()
    # each path on its own copy, cloned before any step (a step advances
    # the recurrent states in place): every path's first step starts from
    # the drawn state
    caches = {S: base if S is None else tree.tree_map(torch.clone, base)
              for S in paths}
    tok = torch.randint(0, cfg.vocab_size, (4,), generator=g, device=dev)
    t_dev = torch.full((4,), LONG_CAPACITY - 1, dtype=torch.int32,
                       device=dev)

    def path(S):
        return lambda: M.decode_step(cfg, params, tok, caches[S], t_dev,
                                     kv_shards=S)[0]

    steps = {S: path(S) for S in paths}
    L = attn_layers(cfg)
    rings = sorted(M.cache_lengths(cfg, LONG_CAPACITY))
    out, logits = {}, {}
    layer_ulps = {S: step_by_layer(torch, M, cfg, params, tok, base, t_dev,
                                   S) for S in paths[1:]} if by_layer else {}
    for S, step in steps.items():
        for name in FLASH_KERNELS:
            getattr(fd, name).launches = 0
        logits[S] = step().clone()
        launches = {name: getattr(fd, name).launches
                    for name in FLASH_KERNELS}
        attn = attn_kernels_on(cfg, S)
        want = {"flash_decode": L if attn and S == 1 else 0,
                "flash_decode_partial": L if attn and S != 1 else 0,
                "combine_partials": L if attn and S != 1 else 0}
        check(launches == want, f"capacity {LONG_CAPACITY}, kv_shards={S}: "
              f"launches {launches} in one decode step, want {want}")
        check(bool(torch.isfinite(logits[S]).all()),
              f"capacity {LONG_CAPACITY}, kv_shards={S}: non-finite logits")
        worst = 0.0
        for r in range(4):
            err, tol = logit_err(torch, logits[S][r], logits[None][r],
                                 LOGIT_ULPS_FULL)
            check(err <= tol or by_layer, f"capacity {LONG_CAPACITY}, "
                  f"kv_shards={S} vs "
                  f"None, row {r}: logits differ by {err} over {tol} "
                  f"({LOGIT_ULPS_FULL} bf16 ulps of the row's max)")
            worst = max(worst, err / tol)
        replay_ok = replay_matches_eager(torch, step,
                                         M.state_leaves(cfg, caches[S]))
        check(replay_ok, f"capacity {LONG_CAPACITY}, kv_shards={S}: the "
              "step replayed from a CUDA graph differs from the eager step")
        out[S] = {"launches": launches, "worst": worst,
                  "replay_ok": replay_ok}
        if S in layer_ulps:
            out[S]["worst_layer_ulps"] = layer_ulps[S]
    graph = paired_graph_ms(torch, steps)
    for S, (med, lo, hi) in graph.items():
        out[S].update(graph_ms=med, graph_min_ms=lo, graph_max_ms=hi)
        print(f"  capacity {LONG_CAPACITY} (every slot valid, rings "
              f"{rings}, {n_bytes / 1e9:.3f} GB of K/V), kv_shards={S}: "
              f"CUDA graph "
              f"replayed {med:.3f} ms "
              f"per decode step (median of 10 rounds in turns, {lo:.3f}-"
              f"{hi:.3f}); logits vs None worst {out[S]['worst']:.3f} of the "
              f"tolerance" + (" (printed, not held)" if by_layer else "")
              + (f", layer by layer worst {out[S]['worst_layer_ulps']:.3f} "
                 f"bf16 ulps (bound {LOGIT_ULPS_FULL})"
                 if "worst_layer_ulps" in out[S] else "")
              + f"; launches {out[S]['launches']}; replay == eager")
    del caches, base
    return out


def step_by_layer(torch, M, cfg, params, tok, caches, t, kv_shards) -> float:
    """One decode step at ``kv_shards`` against the replicated path layer
    by layer: every block runs on the replicated run's input twice, on two
    copies of its cache slice (``caches`` is left as it is), at None and
    at ``kv_shards``; outputs, rings and states held within LOGIT_ULPS_FULL
    bf16 ulps of each row's largest value.  Returns the worst."""
    from repro_torch import tree
    from repro_torch.models import blocks as blk
    shared = params.get("shared")
    worst = torch.zeros((), device=t.device)
    with torch.inference_mode():
        x = M._embed(cfg, params, tok[:, None])
        for s, (pattern, repeats) in enumerate(M.make_stages(cfg)):
            for i in range(repeats):
                lp, lc = M._layer(params["stages"][s], i), M._layer(
                    caches[s], i)
                for q, kind in enumerate(pattern):
                    c0, c1 = (tree.tree_map(torch.clone, lc[str(q)])
                              for _ in range(2))
                    y0, _ = blk.block_apply_decode(kind, cfg, lp[str(q)], x,
                                                   c0, t, shared=shared)
                    y1, _ = blk.block_apply_decode(
                        kind, cfg, lp[str(q)], x, c1, t, shared=shared,
                        kv_shards=kv_shards)
                    worst = torch.maximum(worst, _rows_ulps(y1, y0).max())
                    for a, b in zip(tree.leaves(c1), tree.leaves(c0),
                                    strict=True):
                        worst = torch.maximum(worst, _rows_ulps(a, b).max())
                    x = y0
                    del c0, c1
                x = x.to(torch.bfloat16)
    worst = float(worst)
    check(worst <= LOGIT_ULPS_FULL, f"capacity {LONG_CAPACITY}, "
          f"kv_shards={kv_shards} vs None, layer by layer on the same "
          f"input: {worst:.2f} bf16 ulps of a row's max, past "
          f"{LOGIT_ULPS_FULL}")
    return worst


PROMPT_LENS = (32, 128, 48, 96, 64, 80)
MAX_TOKENS = 16
# the profiled graph run's tokens per request: the profiler drops kernel
# records past its buffers (3 of ~55k were lost at 16 tokens on
# gemma3-1b's 26 layers), and every dropped record fails the count
PROFILED_TOKENS = 8
# profiler kernel names -> the wrappers whose launches they are
PROFILED = {"nm_spmm": ("nm_mma_kernel", "nm_simt_kernel"),
            "flash_decode": ("flash_decode_kernel",),
            "combine_partials": ("combine_kernel",)}


def serving_prompts(cfg) -> list:
    """Phase 4's six prompts: 32-128 tokens of the validation split."""
    from repro_torch.data.synthetic import batches_for
    batch = batches_for(cfg, n=1, batch=len(PROMPT_LENS), seq=128,
                        split="valid")[0]["tokens"]
    return [batch[i, :n] for i, n in enumerate(PROMPT_LENS)]


# spin kernels launched before the profiled work: late in the script the
# tracer loses a window's first records, in full runs on the H100 up to
# all of a 32-kernel warm-up and then 2 to 8 of the work's own, so 1024
PROFILER_WARMUP = 1024
# windows profiled at most while a window shows lost records (a spin
# kernel not seen, a per-step count not the same in every step, or off !=
# on)
PROFILE_TRIES = 3


@contextlib.contextmanager
def profiler_window(torch):
    """``torch.profiler`` (CPU and CUDA activities) over the block, which
    starts after ``PROFILER_WARMUP`` spin kernels and a 0.2 s wait.  Late
    in the script the tracer missed the first kernels of a window: the
    first 3 2:4 launches of gemma3-1b's first profiled windows, in three
    runs of the script, and in later runs all 32 spin kernels of a shorter
    warm-up and then 2 to 8 records of the work; the spin kernels take
    that place.  Yields the profiler; :func:`device_events` leaves the
    spin kernels out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_WARMUP):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.2)
        yield prof
        torch.cuda.synchronize()


def device_events(prof, spin: bool = False) -> list:
    """The profiler's device rows (kernels, memcpy), without the warm-up's
    spin kernels (or only them: ``spin``)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and ("spin_kernel" in e.key) == spin]


def profiled_launches(torch, fn) -> dict:
    """``fn()`` under the profiler: kernel launches by wrapper name
    (``PROFILED``), CUDA graph replays included, and (``"warm-up"``) how
    many of the ``PROFILER_WARMUP`` spin kernels it saw."""
    with profiler_window(torch) as prof:
        fn()
    evs = device_events(prof)
    return {"warm-up": sum(e.count for e in device_events(prof, spin=True)),
            **{name: sum(e.count for e in evs
                         if any(k in e.key for k in keys))
               for name, keys in PROFILED.items()}}


def attn_layers(cfg) -> int:
    """Layers that attend over a KV ring at decode (each launches one
    decode-attention kernel a step on a ``kv_shards`` path): all but the
    ringless recurrent ones (zamba2's 13 ``mamba_shared`` of 81; none of
    xlstm's)."""
    from repro_torch.models import blocks as blk
    return sum(blk.cache_length(k, cfg, 256) is not None
               for k in cfg.layer_kinds)


def attn_kernels_on(cfg, kv_shards) -> bool:
    """Whether decode attention at ``kv_shards`` runs the kernels: a
    softcapped model (gemma2) takes the plain replicated path at every
    ``kv_shards``, as the reference stays on its replicated branch."""
    return kv_shards is not None and not cfg.attn_softcap


def graph_engine_runs(torch, eng, prompts, want: list, counts: dict,
                      kv_shards, profiled_tokens: int = PROFILED_TOKENS
                      ) -> dict:
    """The counted requests again, on the engine's CUDA-graph step: run 1
    captures the decode graph at its first step, run 2 is timed, run 3 is
    profiled (each replayed kernel counted by name; 2 requests of
    ``PROFILED_TOKENS``, admitted and so prefilled before the profiler's
    window opens: it holds the replayed decode steps, whose kernels the
    eager counted run cannot see; the prefills' launches are the eager
    run's, counted there); each run's streams equal the eager run's (its
    first tokens), and neither later run captures again."""
    attn = attn_kernels_on(eng.cfg, kv_shards)
    L = attn_layers(eng.cfg)
    n_tok = sum(len(w) for w in want)
    res = {}
    for run in ("capture", "timed", "profiled"):
        # the profiled run takes the first 2 requests: the profiler's cost
        # grows with the events it keeps
        n = 2 if run == "profiled" else len(prompts)
        m = profiled_tokens if run == "profiled" else MAX_TOKENS
        rids = [eng.submit(p, m) for p in prompts[:n]]
        if run == "profiled":
            eng._admit()
        steps0, pre0 = eng.decode_steps, eng.prefill_calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if run == "profiled":
            for tries in range(1, PROFILE_TRIES + 1):
                box = {}
                launches = profiled_launches(
                    torch, lambda: box.update(out=eng.run()))
                warm = launches.pop("warm-up")
                out = box["out"]
                # a window that lost any of its warm-up's records may have
                # lost the work's too (seen once: 658 of 1024 spin kernels,
                # 32 of 108 2:4 launches): it is served and profiled again
                if warm == PROFILER_WARMUP or tries == PROFILE_TRIES:
                    break
                rids = [eng.submit(p, m) for p in prompts[:n]]
                eng._admit()
                steps0, pre0 = eng.decode_steps, eng.prefill_calls
        else:
            out = eng.run()
        torch.cuda.synchronize()
        res[run + "_s"] = time.perf_counter() - t0
        check([out[r] for r in rids] == [w[:m] for w in want[:n]],
              f"kv_shards={kv_shards}: "
              f"the graph engine's streams ({run} run) differ from the eager "
              "engine's")
        check(eng.fns.capture_counts() == {"decode": 1},
              f"kv_shards={kv_shards}: captures {eng.fns.capture_counts()} "
              f"after the {run} run, want one decode graph")
    steps, pre = eng.decode_steps - steps0, eng.prefill_calls - pre0
    nm = (sum(counts["prefill"].values()) * pre
          + sum(counts["decode"].values()) * steps)
    want_l = {"nm_spmm": nm,
              "flash_decode": L * steps if attn else 0,
              "combine_partials": L * steps if attn and kv_shards != 1
              else 0}
    check(launches == want_l, f"kv_shards={kv_shards}: the profiled graph "
          f"run launched {launches}, want {want_l} (2:4 kernels: one per "
          "compressed projection and bank per forward, path_launches; "
          "decode attention: one per layer "
          f"per decode step); the profiler saw {warm} of its "
          f"{PROFILER_WARMUP} warm-up kernels")
    res.update(tok_s=n_tok / res["timed_s"], launches=launches,
               decode_steps=steps, prefills=pre, profiler_warmup_seen=warm)
    return res


def phase_serve(torch, dev, card: str, cfg, long_cache: bool = False,
                verify: bool = False, weights=weights_whole,
                by_layer: bool = False,
                profiled_tokens: int = PROFILED_TOKENS,
                long_paths=LONG_KV_SHARDS, kv_by_layer: bool = False) -> dict:
    """Serve ``cfg`` at its widths from random weights with 2:4 magnitude
    masks, made by ``weights`` (:func:`weights_whole`, or
    :func:`weights_by_layer` for a model whose f32 tree does not fit);
    each kernel's launches per forward follow from the config
    (:func:`path_launches`).  Then the same requests at each ``kv_shards``
    of KV_SHARDS (none for MLA models: their decode has no attention
    kernel, and the engine refuses a set ``kv_shards``; none for a model
    with no attention, xlstm).  ``long_cache``: also the decode step at
    capacity 8192 (:func:`long_cache_steps`) on ``long_paths`` (those
    the model has).  Then compressed against masked-dense, routing
    included where the model has MoE layers; ``by_layer``: layer by layer
    on the same input, the masked-dense MoE calls taking the compressed
    calls' experts (:func:`compare_pinned`), where each attention layer's
    ``kv_shards`` paths are held against its replicated one too.
    ``kv_by_layer``: the end-to-end comparisons of the ``kv_shards``
    paths against None (logits of rows with the same history, and the
    capacity-8192 step) are printed, and each path is held layer by layer
    on the same input instead (:func:`compare_pinned`,
    :func:`step_by_layer`).
    ``verify``: then the compressed weights' verify pass against
    sequential decode (:func:`verify_vs_sequential`)."""
    from repro_torch import tree
    from repro_torch.core.prunable import prunable_map
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import ServeEngine, eager
    from repro_torch.sparse.apply import compressed_report
    counted = {"nm_matmul": nm_matmul, "nm_matmul_expert": nm_matmul_expert,
               "nm_mask24": nm_mask24,
               **{name: getattr(fd, name) for name in FLASH_KERNELS}}

    L = cfg.num_layers
    n_attn = attn_layers(cfg)
    n_moe = sum("moe" in k for k in cfg.layer_kinds)
    counts = path_launches(cfg)
    kv_list = () if any(k.startswith("mla") for k in cfg.layer_kinds) \
        or not n_attn else KV_SHARDS
    # one stacked leaf per compressed projection or bank of the stages
    n_leaves = sum(tree.leaves(prunable_map(M.param_specs(cfg))))
    torch.cuda.reset_peak_memory_stats()
    prompts = serving_prompts(cfg)
    batch = batches_for(cfg, n=1, batch=len(PROMPT_LENS), seq=128,
                        split="valid")[0]["tokens"]
    max_tokens = MAX_TOKENS

    # -- the main path, counted ---------------------------------------------
    calls = {}
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = weights(torch, dev, cfg)
    t_build = time.perf_counter() - t0
    sparse, t_export = w.pop("sparse"), w["export_s"]
    ffn = (f"{cfg.num_experts} experts top-{cfg.top_k} + "
           f"{cfg.num_shared_experts} shared, moe_d_ff {cfg.moe_d_ff}"
           if n_moe else f"d_ff {cfg.d_ff}")
    if any(k.startswith("mla") for k in cfg.layer_kinds):
        attn_w = (f"MLA kv_lora {cfg.kv_lora}, nope {cfg.qk_nope_dim} + "
                  f"rope {cfg.qk_rope_dim}, v {cfg.v_head_dim}")
    elif "mamba" in cfg.layer_kinds:
        attn_w = (f"Mamba2 d_inner {cfg.d_inner}, "
                  f"{cfg.d_inner // cfg.ssm_head_dim} ssm heads x "
                  f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                  f"{cfg.ssm_chunk}; {n_attn} shared-attention layers, LoRA "
                  f"rank {cfg.lora_rank}")
    elif not n_attn:
        attn_w = (f"xLSTM {cfg.lstm_heads} heads, mLSTM proj "
                  f"{cfg.lstm_proj_factor}, no attention")
    else:
        attn_w = f"window {cfg.sliding_window}"
    print(f"  {cfg.name}: {L} layers {'+'.join(cfg.layer_kinds[:2])}..., "
          f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
          f"x {cfg.head_dim}, {ffn}, vocab {cfg.vocab_size}, {attn_w}, "
          f"{'tied' if cfg.tie_embeddings else 'untied'}: {w['n_params']} "
          f"params, made, masked and packed in {t_build:.1f} s")
    eng = ServeEngine(cfg, sparse, slots=4, capacity=256, device=dev)
    routes = []
    steps_ref = record_decode(eng, routes)
    rids = [eng.submit(p, max_tokens) for p in prompts]
    t0 = time.perf_counter()
    with first_call_per_signature(calls), recording_routes(routes), eager():
        out = eng.run()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    # -----------------------------------------------------------------------
    del eng.fns.decode
    forwards = eng.decode_steps + eng.prefill_calls
    print(f"  main path launches: {launches} over {eng.prefill_calls} "
          f"prefills + {eng.decode_steps} decode steps")
    check(all(launches[name] == 0 for name in FLASH_KERNELS),
          "kv_shards=None launched a decode attention kernel")
    check(all(len(out[r]) == max_tokens for r in rids),
          f"requests finished with {[len(out[r]) for r in rids]} tokens")
    check(launches["nm_mask24"] == w["masks_made"],
          f"nm_mask24 launched {launches['nm_mask24']} times, want "
          f"{w['masks_made']}")
    for name in PATH_KERNELS:
        want = (counts["prefill"][name] * eng.prefill_calls
                + counts["decode"][name] * eng.decode_steps)
        check(launches[name] == want,
              f"{name} launched {launches[name]} times, want {want} "
              f"({counts['prefill'][name]} a prefill, "
              f"{counts['decode'][name]} a decode step)")
    print("  " + check_path_calls(torch, calls))
    del calls
    rep = compressed_report(sparse, w["masks"])
    check(rep["fallback_leaves"] == 0
          and rep["kernel_native_packed"] == n_leaves
          and rep["ratio"] == 0.5625,
          f"compression: {rep['fallback_leaves']} fallbacks, ratio "
          f"{rep['ratio']}")
    print(f"  2:4 export + packing {t_export:.2f} s; compressed weights "
          f"{rep['bytes_compressed'] / 1e9:.3f} GB vs "
          f"{rep['bytes_dense_bf16'] / 1e9:.3f} GB dense bf16 "
          f"(ratio {rep['ratio']:.4f})")
    n_tok = len(rids) * max_tokens
    print(f"  engine: {len(rids)} requests x {max_tokens} tokens in "
          f"{t_serve:.3f} s (first run, cold, eager steps) = "
          f"{n_tok / t_serve:.1f} tok/s")
    del sparse
    graph_runs = {None: graph_engine_runs(
        torch, eng, prompts, [out[r] for r in rids], counts, None,
        profiled_tokens)}

    # -- the same requests through the decode attention kernels: kv_shards
    # 1 (flash_decode) and S (flash_decode_partial over S capacity shards +
    # the combine), each a path counted on its own ----------------------
    kv_runs = {}
    for S in kv_list:
        calls = {}
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        e = ServeEngine(cfg, eng.params, slots=4, capacity=256, device=dev,
                        kv_shards=S)
        kv_routes = []
        steps = record_decode(e, kv_routes)
        kv_rids = [e.submit(p, max_tokens) for p in prompts]
        t0 = time.perf_counter()
        with first_call_per_signature(calls), recording_routes(kv_routes), \
                eager():
            kv_out = e.run()
        torch.cuda.synchronize()
        t_kv = time.perf_counter() - t0
        kv_launches = {name: fn.launches for name, fn in counted.items()}
        # -------------------------------------------------------------------
        fw = e.decode_steps + e.prefill_calls
        print(f"  kv_shards={S}: launches {kv_launches} over "
              f"{e.prefill_calls} prefills + {e.decode_steps} decode steps; "
              f"engine {n_tok / t_kv:.1f} tok/s (first run)")
        check(kv_rids == rids and all(len(kv_out[r]) == max_tokens
                                      for r in kv_rids),
              f"kv_shards={S}: requests finished with "
              f"{[len(kv_out[r]) for r in kv_rids]} tokens")
        attn = attn_kernels_on(cfg, S)
        want = {"nm_mask24": 0,
                "flash_decode": n_attn * e.decode_steps if attn and S == 1
                else 0,
                "flash_decode_partial": n_attn * e.decode_steps
                if attn and S != 1 else 0,
                "combine_partials": n_attn * e.decode_steps
                if attn and S != 1 else 0,
                **{name: counts["prefill"][name] * e.prefill_calls
                   + counts["decode"][name] * e.decode_steps
                   for name in PATH_KERNELS}}
        check(kv_launches == want, f"kv_shards={S}: launches {kv_launches}, "
              f"want {want} ({n_attn} attention layers per decode step)")
        print("  " + check_path_calls(torch, calls))
        del calls
        n_rows, worst, ties, rerouted = compare_decode_runs(
            torch, steps_ref, steps, coupled=n_moe > 0, hold=not kv_by_layer)
        differ = [r for r in rids if kv_out[r] != out[r]]
        explained = len(ties) + len(rerouted)
        # every differing stream starts at a counted near-tie; with MoE,
        # streams are compared only up to the first one
        check(kv_by_layer or (len(differ) == len(ties) if not n_moe
                              else (not differ or explained > 0)),
              f"kv_shards={S}: streams of requests {differ} differ, "
              f"{len(ties)} token and {len(rerouted)} routing near-ties")
        print(f"  kv_shards={S} vs None: {n_rows} decode rows with the same "
              f"history, logits worst {worst:.3f} of the tolerance "
              f"({LOGIT_ULPS_FULL} bf16 ulps of the row's max"
              + ("; printed, not held: held layer by layer below"
                 if kv_by_layer else "") + "); greedy "
              f"streams identical for {len(rids) - len(differ)} of "
              f"{len(rids)} requests; token near-ties (request, position, "
              f"None's token, this run's, margin, logit difference): {ties}"
              + (f"; routing near-ties (request, position, layer, margin, "
                 f"router probability difference): {rerouted}; MoE rows "
                 "share expert capacity, so rows are compared up to the "
                 "first near-tie" if n_moe else ""))
        kv_runs[S] = {"launches": kv_launches, "worst": worst,
                      "rows": n_rows, "near_ties": explained,
                      "differ": len(differ)}
        del e.fns.decode
        graph_runs[S] = graph_engine_runs(
            torch, e, prompts, [kv_out[r] for r in kv_rids], counts, S,
            profiled_tokens)
        del e, steps, kv_routes
    del steps_ref, routes

    # -- steady-state timings (host clock around synchronised work) ---------
    with torch.inference_mode():
        toks = torch.from_numpy(batch[:1]).to(dev)        # 128 tokens
        pre = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.prefill(cfg, eng.params, {"tokens": toks}, cache_capacity=256)
            torch.cuda.synchronize()
            pre.append(time.perf_counter() - t0)
        by_kv = {}
        for S in (None,) + kv_list:
            by_kv[S] = decode_step_times(torch, M, cfg, eng.params, batch,
                                         dev, S,
                                         sum(counts["decode"].values()))
        graph = paired_graph_ms(torch, {S: r.pop("step")
                                        for S, r in by_kv.items()})
        for S, r in by_kv.items():
            r["graph_ms"], r["graph_min_ms"], r["graph_max_ms"] = graph[S]
    step_ms = by_kv[None]["step_ms"]
    step_dev_ms = by_kv[None]["graph_ms"]
    prefill_ms = statistics.median(pre) * 1e3
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        long = (long_cache_steps(torch, M, cfg, eng.params, dev,
                                 (None,) + (tuple(long_paths[1:]) if kv_list
                                            else ()), kv_by_layer)
                if long_cache else None)
    print(f"  [{card}] prefill 1x128 {prefill_ms:.2f} ms; eager decode "
          f"{step_ms:.2f} ms/step at 4 slots = {4e3 / step_ms:.1f} tok/s; "
          f"max memory allocated {peak / 2 ** 30:.2f} GiB")
    for S, g in graph_runs.items():
        print(f"  [{card}] kv_shards={S}: the engine on its CUDA-graph step, "
              f"the same {len(rids)} requests: streams == the eager run's "
              f"(3 runs, one decode graph captured); warm run "
              f"{g['timed_s']:.3f} s = {g['tok_s']:.1f} tok/s (capture run "
              f"{g['capture_s']:.3f} s); profiler over 2 of the requests "
              f"x {profiled_tokens} tokens, prefilled before its window "
              f"({g['profiled_s']:.1f} s with its processing): "
              f"{g['launches']} over {g['prefills']} eager "
              f"prefills + {g['decode_steps']} replayed decode steps")
    for S, r in by_kv.items():
        print(f"  kv_shards={S}: eager decode step {r['step_ms']:.2f} ms; "
              f"CUDA graph replayed {r['graph_ms']:.3f} ms (median of 10 "
              f"rounds in turns with the other paths, "
              f"{r['graph_min_ms']:.3f}-{r['graph_max_ms']:.3f}; = "
              f"{r['graph_ms'] / r['step_ms']:.1%} of the eager step, the "
              f"rest host time between launches); replay == eager: "
              f"{r['replay_ok']}; profiler, one eager step (window "
              f"{r['windows']} of at most {PROFILE_TRIES}): "
              f"{r['kernels']:.0f} kernels and {r['device_ms']:.3f} ms of "
              "device time per step; top kernels (us per step, launches "
              "per step):")
        for us, count, key in r["top"]:
            print(f"    {us:10.1f}  {count:5.1f}  {key[:90]}")
        check(r["replay_ok"], f"kv_shards={S}: the decode step replayed "
              "from a CUDA graph differs from the eager step")
        # one 2:4 kernel per projection and bank, split-K included
        want = sum(counts["decode"].values())
        check(r["nm_kernels"] == want, f"kv_shards={S}: {r['nm_kernels']} "
              f"2:4 kernels per decode step, want {want} (one launch each)")

    # -- compressed vs plain masked-dense, same fed tokens ------------------
    masked = w.pop("masked")()
    w.clear()
    if by_layer:
        pinned = compare_pinned(torch, M, cfg, eng.params, masked, dev,
                                kv_list)
        del masked
        # 2 rows x VERIFY_TOKENS: a verify pass routes 8 tokens, where
        # expert capacity equals the token count (a larger pass may drop
        # assignments that one-token decode steps keep: the reference's
        # semantics, not a rounding difference)
        prompt = pinned.pop("prompt")[:2]
        verified = ({**verify_by_layer(torch, M, cfg, eng.params, prompt),
                     "end_to_end": verify_vs_sequential(
                         torch, M, cfg, eng.params, prompt, held=False)}
                    if verify else None)
        return {"launches": launches, "step_ms": step_ms,
                "verify": verified, "step_dev_ms": step_dev_ms,
                "prefill_ms": prefill_ms, "peak_gib": peak / 2 ** 30,
                "kv_runs": kv_runs, "steps_by_kv": by_kv, "long_cache": long,
                "graph_runs": graph_runs, "pinned": pinned,
                "export_s": t_export, "build_s": t_build}
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
    verified = (verify_vs_sequential(torch, M, cfg, eng.params, prompt)
                if verify else None)
    return {"launches": launches, "step_ms": step_ms, "verify": verified,
            "step_dev_ms": step_dev_ms, "prefill_ms": prefill_ms,
            "peak_gib": peak / 2 ** 30, "kv_runs": kv_runs,
            "steps_by_kv": by_kv, "long_cache": long,
            "graph_runs": graph_runs, "export_s": t_export,
            "build_s": t_build}


@contextlib.contextmanager
def pinned_routing(flips: list, rows: int):
    """While open, MoE routing (``models.moe.route``) follows ``pin``, the
    dict it yields: a call in ``pin["mode"] == "lead"`` routes as usual
    and is remembered; in ``("follow", sel)`` mode a call takes the
    experts of ``sel(probs, ids)`` of the last lead call (the lead's
    tokens that this call's tokens are), its gates renormalised from its
    own probabilities.  Each token where the call's own top-k would
    differ is appended to ``flips`` as (``pin["tag"]``, row, margin,
    router probability difference) (``rows`` rows a call, tokens
    row-major) and must be a near-tie: its own margin between an expert
    only it would keep and one only the lead keeps is at most twice the
    largest difference of the two calls' router probabilities there."""
    import torch
    from repro_torch.models import moe as moe_mod
    route = moe_mod.route
    pin = {"mode": "lead", "last": None, "calls": 0, "tag": None}

    def pinned(router, x, top_k):
        probs, gates, idx = route(router, x, top_k)
        if pin["mode"] == "lead":
            pin["last"] = (probs, idx)
            return probs, gates, idx
        pc, ic = pin["mode"][1](*pin["last"])
        pin["calls"] += 1
        differ = (idx.sort(dim=-1).values != ic.sort(dim=-1).values).any(-1)
        T = idx.shape[1]
        for g_, t in differ.nonzero().tolist():
            pm, own, forced = probs[g_, t], set(idx[g_, t].tolist()), set(
                ic[g_, t].tolist())
            margin = float(min(pm[e] for e in own - forced)
                           - max(pm[e] for e in forced - own))
            perr = float((pc[g_, t] - pm).abs().max())
            check(margin <= 2 * perr, f"{pin['tag']}: token {t} would route "
                  f"to {sorted(own)} against the pinned {sorted(forced)}, "
                  f"margin {margin} past twice the router probability "
                  f"difference {perr}")
            flips.append((pin["tag"], t // (T // rows), margin, perr))
        g = torch.gather(probs, -1, ic)
        return probs, g / g.sum(dim=-1, keepdim=True), ic

    moe_mod.route = pinned
    try:
        yield pin
    finally:
        moe_mod.route = route


def _same(probs, ids):
    return probs, ids


def _rows_ulps(got, want) -> "torch.Tensor":
    """Per row of the leading axis: the largest |got - want| in bf16 ulps
    of the row's largest |want| (2**-8 of it)."""
    g, w = got.float().flatten(1), want.float().flatten(1)
    return (g - w).abs().amax(1) / (w.abs().amax(1) * 2 ** -8)


def compare_pinned(torch, M, cfg, params, masked, dev,
                   kv_paths=()) -> dict:
    """Compressed (``params``) against masked-dense (``masked``), layer by
    layer, with the routing pinned: one prompt of 4 rows x 64 tokens
    prefilled, then 8 decode steps fed the compressed run's greedy tokens.
    At every layer and pass the layer of each tree runs on the compressed
    run's input, and on its own cache rows (the masked-dense layer on a
    copy of the compressed one's): its output and the ring rows it writes
    must agree within LOGIT_ULPS_FULL bf16 ulps of each row's largest
    value.  Beside it the masked-dense run goes on on its own hidden
    states, and its distance from the compressed run is printed by depth
    and at the logits, not held: over 27 layers at these random weights
    (the expert banks drawn at 0.88 E**-0.5 as the reference draws them)
    each layer multiplies the two runs' rounding differences, and at the
    logits they part by more than 8 ulps (measured: PERF.md, PR 22).
    Every MoE call of a masked-dense layer takes the experts the
    compressed layer chose at that call (its gates renormalised from its
    own probabilities): over 26 layers of top-6 of 64 experts its own
    router would part from the compressed one's at some token of nearly
    every row.  Each routing it would change is counted and must be a
    near-tie: its margin between an expert only it would keep and one
    only the compressed layer keeps is at most twice the largest
    difference of the two layers' router probabilities at that token.
    A layer of several blocks (a pattern of kinds in one stage: zamba2's
    five ``mamba`` and one ``mamba_shared``) is compared block by block,
    each tree's shared block beside its ``mamba_shared`` blocks, and its
    recurrent states as its rings.  ``kv_paths``: at each decode pass,
    every attention layer of the compressed tree also runs at each of
    these ``kv_shards`` on the same input and a copy of its cache rows,
    held to the same bound against its replicated run (outputs and ring
    rows)."""
    from repro_torch import tree
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import blocks as blk
    prompt = torch.from_numpy(batches_for(cfg, n=1, batch=4, seq=64,
                                          split="valid", start=1)[0]
                              ["tokens"]).to(dev)
    B, P = prompt.shape
    flips = []

    def clone(c):
        return tree.tree_map(torch.clone, c)

    # (kind, stage, layer, position in the pattern, the layer's last block)
    layers = [(kind, s, i, str(q), q == len(pattern) - 1)
              for s, (pattern, repeats) in enumerate(M.make_stages(cfg))
              for i in range(repeats) for q, kind in enumerate(pattern)]
    sh_c, sh_m = params.get("shared"), masked.get("shared")
    attends = {k for k in cfg.layer_kinds if k not in blk.MLA_KINDS
               and blk.cache_length(k, cfg, 96) is not None}
    worst_kv = torch.zeros((), device=dev)
    L = len(layers)
    worst = torch.zeros((), device=dev)        # teacher-forced, all layers
    free = torch.zeros((9, L), device=dev)     # free-running, by pass, depth
    logits_err, agree, ties = [], 0, []
    caches = {"c": M.init_caches(cfg, B, 96, device=dev),
              "f": M.init_caches(cfg, B, 96, device=dev)}
    with pinned_routing(flips, B) as pin, torch.inference_mode():
        pos = torch.arange(P, device=dev).expand(B, P)
        tok = prompt
        for j in range(9):                  # prefill + 8 decode steps
            t = torch.full((B,), P + j - 1, dtype=torch.int32,
                           device=dev)
            xc = M._embed(cfg, params, tok if j == 0 else tok[:, None])
            xf = M._embed(cfg, masked, tok if j == 0 else tok[:, None])
            for d, (kind, s, i, q, last) in enumerate(layers):
                pc_, pm_ = (M._layer(tr["stages"][s], i)[q]
                            for tr in (params, masked))
                cc_, cf_ = (M._layer(caches[k][s], i)[q]
                            for k in ("c", "f"))
                pin["mode"] = "lead"
                if j == 0:
                    ctx = blk.Ctx(positions=pos, cache_capacity=96)
                    yc, _, rc = blk.block_apply_full(kind, cfg, pc_, xc,
                                                     ctx, sh_c)
                    pin["mode"] = ("follow", _same)
                    pin["tag"] = (j, "same input")
                    yt, _, rt = blk.block_apply_full(kind, cfg, pm_, xc,
                                                     ctx, sh_m)
                    pin["tag"] = (j, "own")
                    yf, _, rf = blk.block_apply_full(kind, cfg, pm_, xf,
                                                     ctx, sh_m)
                    tree.tree_map(lambda a, b: a.copy_(b), cc_, rc)
                    tree.tree_map(lambda a, b: a.copy_(b), cf_, rf)
                else:
                    rt = clone(cc_)
                    by_kv = {S: clone(cc_) for S in kv_paths
                             if kind in attends}
                    yc, _ = blk.block_apply_decode(kind, cfg, pc_, xc,
                                                   cc_, t, shared=sh_c)
                    for S, rk in by_kv.items():
                        yk, _ = blk.block_apply_decode(
                            kind, cfg, pc_, xc, rk, t, shared=sh_c,
                            kv_shards=S)
                        worst_kv = torch.maximum(
                            worst_kv, _rows_ulps(yk, yc).max())
                        for a, b in zip(tree.leaves(rk), tree.leaves(cc_),
                                        strict=True):
                            worst_kv = torch.maximum(worst_kv,
                                                     _rows_ulps(a, b).max())
                    pin["mode"] = ("follow", _same)
                    pin["tag"] = (j, "same input")
                    yt, _ = blk.block_apply_decode(kind, cfg, pm_, xc,
                                                   rt, t, shared=sh_m)
                    pin["tag"] = (j, "own")
                    yf, _ = blk.block_apply_decode(kind, cfg, pm_, xf,
                                                   cf_, t, shared=sh_m)
                    rc = cc_
                worst = torch.maximum(worst, _rows_ulps(yt, yc).max())
                for a, b in zip(tree.leaves(rt), tree.leaves(rc),
                                strict=True):
                    worst = torch.maximum(worst, _rows_ulps(a, b).max())
                free[j, d] = _rows_ulps(yf, yc).max()
                xc, xf = yc, yf
                if last:        # the layer's end: the stream in bf16
                    xc, xf = xc.to(torch.bfloat16), xf.to(torch.bfloat16)
            lc = M._unembed(cfg, params, blk._norm(
                cfg, params["final_norm"], xc[:, -1:]))[:, 0]
            lf = M._unembed(cfg, masked, blk._norm(
                cfg, masked["final_norm"], xf[:, -1:]))[:, 0]
            for r in range(B):
                err, tol = logit_err(torch, lf[r], lc[r], LOGIT_ULPS_FULL)
                logits_err.append(err / tol)
                a, b = int(lc[r].argmax()), int(lf[r].argmax())
                agree += a == b
                if a != b:
                    margin = float(lc[r, a] - lc[r, b])
                    check(margin <= 2 * err, f"pass {j} row {r}: the "
                          f"free-running masked-dense token {b} against "
                          f"the compressed {a}, margin {margin} past "
                          f"twice the logit difference {err}")
                    ties.append((j, r, margin, err))
            tok = lc.argmax(-1)
    n_moe = sum("moe" in k for k in cfg.layer_kinds)
    check(pin["calls"] == 2 * n_moe * 9,
          f"pinned {pin['calls']} MoE calls, want {2 * n_moe * 9}")
    worst, worst_kv = float(worst), float(worst_kv)
    check(worst <= LOGIT_ULPS_FULL, f"compressed vs masked-dense, layer by "
          f"layer on the same input: {worst:.2f} bf16 ulps of a row's max "
          f"(outputs and ring rows), past {LOGIT_ULPS_FULL}")
    check(worst_kv <= LOGIT_ULPS_FULL, f"kv_shards {kv_paths} vs None, "
          f"layer by layer on the same input: {worst_kv:.2f} bf16 ulps of "
          f"a row's max (outputs and ring rows), past {LOGIT_ULPS_FULL}")
    if kv_paths:
        print(f"  kv_shards {kv_paths} vs None, every attention layer of "
              f"the compressed tree on the same input and a copy of its "
              f"cache rows, 8 decode passes: outputs and ring rows worst "
              f"{worst_kv:.3f} bf16 ulps of a row's max (bound "
              f"{LOGIT_ULPS_FULL})")
    by_depth = free.amax(0).tolist()
    same = [f for f in flips if f[0][1] == "same input"]
    rows = sorted({(tag[0], r) for tag, r, _, _ in same})
    total = 9 * B
    print(f"  compressed vs masked-dense layer by layer (prefill of {P} "
          f"tokens + 8 decode steps, {B} rows, every one of the {L} blocks "
          f"on the compressed run's input"
          + (", each masked-dense MoE call pinned to the compressed layer's "
             "experts" if n_moe else "")
          + f"): outputs and ring rows "
          f"worst {worst:.3f} bf16 ulps of a row's max (bound "
          f"{LOGIT_ULPS_FULL}); masked-dense's own router would have chosen "
          f"otherwise at {len(same)} (call, token) routings in {len(rows)} "
          f"of {total} (pass, row)s, each a near-tie")
    print(f"  the masked-dense run on its own hidden states (routing pinned): "
          f"its distance from the compressed run, in bf16 ulps of a row's "
          f"max, by depth (worst over passes): "
          + ", ".join(f"{v:.1f}" for v in by_depth)
          + f"; at the logits worst {max(logits_err) * LOGIT_ULPS_FULL:.1f}"
          f" ulps, greedy tokens {agree}/{total} agree, near-ties {ties}; "
          f"its own router would part from the pinned experts at "
          f"{len(flips) - len(same)} (call, token) routings, each a "
          "near-tie")
    return {"worst_layer_ulps": worst, "worst_kv_layer_ulps": worst_kv,
            "free_by_depth": by_depth,
            "free_logits_ulps": max(logits_err) * LOGIT_ULPS_FULL,
            "agree": agree, "rows": total, "flips": len(same),
            "flipped_rows": len(rows), "free_flips": len(flips) - len(same),
            "token_near_ties": len(ties),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "prompt": prompt}


VERIFY_TOKENS = 4     # fed tokens per row of phase 10's verify check


def verify_by_layer(torch, M, cfg, params, prompt) -> dict:
    """The verify pass against sequential decode layer by layer, for a
    model whose rounding differences grow past LOGIT_ULPS_FULL over its
    depth (deepseek's 27 layers: :func:`compare_pinned`): from the
    prompt's prefill, each layer's ``block_apply_verify`` over the
    ``VERIFY_TOKENS`` fed tokens against the same layer's
    ``block_apply_decode`` one token at a time, on the same inputs (the
    verify run's) and each on its own copy of the ring; every output and
    every ring row within LOGIT_ULPS_FULL bf16 ulps of each row's max.
    Each decode call's MoE routing is pinned to the verify call's experts
    at its tokens (:func:`pinned_routing`), each change a near-tie."""
    from repro_torch import tree
    from repro_torch.models import blocks as blk
    B, P = prompt.shape
    S = VERIFY_TOKENS
    fed = prompt[:, :S].flip(-1).contiguous()
    t = torch.full((B,), P, dtype=torch.int32, device=prompt.device)
    flips, worst = [], torch.zeros((), device=prompt.device)
    with torch.inference_mode(), pinned_routing(flips, B) as pin:
        _, c1 = M.prefill(cfg, params, {"tokens": prompt}, cache_capacity=96)
        c2 = tree.tree_map(torch.clone, c1)
        x = M._embed(cfg, params, fed)
        for s_, (pattern, repeats) in enumerate(M.make_stages(cfg)):
            for i in range(repeats):
                lp = M._layer(params["stages"][s_], i)
                cv, cs = M._layer(c1[s_], i), M._layer(c2[s_], i)
                for j, kind in enumerate(pattern):
                    pin["mode"] = "lead"
                    yv, _ = blk.block_apply_verify(kind, cfg, lp[str(j)], x,
                                                   cv[str(j)], t)
                    ys = []
                    for k in range(S):
                        pin["mode"] = ("follow", lambda p, e, k=k: (
                            p.reshape(p.shape[0], B, S, -1)[:, :, k],
                            e.reshape(e.shape[0], B, S, -1)[:, :, k]))
                        pin["tag"] = f"layer {s_}.{i} token {k}"
                        y, _ = blk.block_apply_decode(
                            kind, cfg, lp[str(j)], x[:, k:k + 1], cs[str(j)],
                            t + k)
                        ys.append(y)
                    ys = torch.cat(ys, dim=1)
                    worst = torch.maximum(worst, _rows_ulps(
                        ys.reshape(B * S, -1), yv.reshape(B * S, -1)).max())
                    for n in cv[str(j)]:
                        worst = torch.maximum(worst, _rows_ulps(
                            cs[str(j)][n], cv[str(j)][n]).max())
                    x = yv
    worst = float(worst)
    check(worst <= LOGIT_ULPS_FULL, f"verify vs sequential decode, layer by "
          f"layer on the same input: {worst:.2f} bf16 ulps of a row's max, "
          f"past {LOGIT_ULPS_FULL}")
    print(f"  verify ({S} fed tokens x {B} rows, compressed weights) vs "
          f"sequential decode, layer by layer on the verify run's inputs: "
          f"outputs and ring rows worst {worst:.3f} bf16 ulps of a row's "
          f"max (bound {LOGIT_ULPS_FULL}); decode's own router would have "
          f"chosen otherwise at {len(flips)} (call, token) routings, each "
          "a near-tie")
    return {"worst_layer_ulps": worst, "flips": len(flips)}


def verify_vs_sequential(torch, M, cfg, params, prompt,
                         held: bool = True) -> dict:
    """The verify pass (teacher-forced, ``VERIFY_TOKENS`` fed tokens per
    row in one call) against the same tokens fed one decode step at a
    time, from the prompt's prefill: each column's logits within
    LOGIT_ULPS_FULL bf16 ulps of the row's max, its greedy token the
    sequential one's but for counted near-ties (the reference's margin at
    most twice the measured difference), the written ring rows equal.  On
    the CPU the columns are bit-equal (tests/test_torch_gemma.py); on the
    card the batched and the one-row products sum in other orders
    (ROADMAP R9), so the bit-equal rows are counted, not required.
    ``held=False``: the logits are printed, not held (a model whose
    differences grow past the bound over its depth, held layer by layer
    by :func:`verify_by_layer`); a differing token must still be a
    near-tie."""
    B, P = prompt.shape
    fed = prompt[:, :VERIFY_TOKENS].flip(-1).contiguous()
    t = torch.full((B,), P, dtype=torch.int32, device=prompt.device)
    with torch.inference_mode():
        _, c1 = M.prefill(cfg, params, {"tokens": prompt}, cache_capacity=96)
        c2 = [{j: {n: x.clone() for n, x in c.items()} for j, c in st.items()}
              for st in c1]
        got, _ = M.verify_step(cfg, params, fed, c1, t)
        seq = []
        for i in range(VERIFY_TOKENS):
            lg, c2 = M.decode_step(cfg, params, fed[:, i], c2, t + i)
            seq.append(lg)
    worst, equal, ties = 0.0, 0, []
    for i, want in enumerate(seq):
        for r in range(B):
            g, w = got[r, i], want[r]
            err, tol = logit_err(torch, g, w, LOGIT_ULPS_FULL)
            check(err <= tol or not held, f"verify column {i} row {r}: "
                  f"logits differ from sequential decode by {err} over {tol}")
            worst = max(worst, err / tol)
            equal += int(torch.equal(g, w))
            a, b = int(w.argmax()), int(g.argmax())
            if a != b:
                margin = float(w[a] - w[b])
                check(margin <= 2 * err, f"verify column {i} row {r}: "
                      f"token {b} vs sequential {a}, margin {margin}")
                ties.append((i, r, margin, err))
    same_rows = all(torch.equal(x.float(), y.float())
                    for s1, s2 in zip(c1, c2) for j in s1
                    for n in s1[j] for x, y in [(s1[j][n], s2[j][n])])
    out = {"worst": worst, "bit_equal": equal, "columns": B * VERIFY_TOKENS,
           "near_ties": ties, "caches_equal": same_rows}
    print(f"  verify ({VERIFY_TOKENS} fed tokens x {B} rows, compressed "
          f"weights) vs sequential decode: logits worst {worst:.3f} of the "
          f"tolerance, {equal} of {B * VERIFY_TOKENS} columns bit-equal, "
          f"greedy near-ties {ties}; ring rows written equal: {same_rows}")
    return out


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


# phase 6's full-width bank, apart from _banks_dir (which the later phases'
# calibrations wipe): phases 7, 8 and 13 serve it; removed after phase 13
BANK_DIR = ROOT / "build" / "chip_smoke_bank6" / "full"


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
    with profiler_window(torch) as prof:
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
    for e in device_events(prof):
        if e.self_device_time_total > 0:
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
    from repro_torch.serve.engine import ServeEngine, eager
    from repro_torch.sparse.apply import compressed_report
    from repro_torch.sparse.bank import MaskBank

    cfg = get_config("llama3.2-1b")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=CALIB_STEPS,
                       stats_batches=4)
    calib = batches_for(cfg, n=8, batch=4, seq=64, split="calib")
    params0 = M.init_params(cfg, 0, device=dev)
    n_pr = sum(L * K * N for L, K, N in calib_leaves(cfg).values())
    shutil.rmtree(BANK_DIR.parent, ignore_errors=True)
    BANK_DIR.parent.mkdir(parents=True)
    banks = BANK_DIR.parent
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
    del masks
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServeEngine(cfg, sparse, slots=2, capacity=64, device=dev)
    prompts = batches_for(cfg, n=1, batch=2, seq=40, split="valid")[0][
        "tokens"]
    rids = [eng.submit(prompts[0, :24], 16), eng.submit(prompts[1, :40], 16)]
    calls = {}
    with first_call_per_signature(calls), eager():
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
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "bank": loaded,
            "stats_s": meta["stats_seconds"],
            "search_s": meta["search_seconds"],
            "peak_gib": peak_search / 2 ** 30, "profile": prof}


# ---------------------------------------------------------------------------
# Phase 7: the multi-budget fleet and self-speculative decoding
# ---------------------------------------------------------------------------

FLEET_BUDGETS = ("0.0", "0.5", "2:4")
FLEET_AB = {"0.0": 1, "0.5": 1, "2:4": 2}
FLEET_SPEC = "draft:2:4,verify:0.0,k:4"
FLEET_KV = (None, 1)
FLEET_SLOTS, FLEET_CAPACITY = 6, 256
SPEC_K = 4


def fleet_traffic(fleet, prompts, spec_state=None) -> dict:
    """The six prompts through ``fleet``, three ``run()``s: pinned to
    each member, then A/B (``FLEET_AB``), then self-speculative.
    ``spec_state``: the decoder's (k, accept EMA) to start the spec run
    from, so that every spec run takes the same rounds."""
    pinned = {(i, n): fleet.submit(p, MAX_TOKENS, budget=n)
              for n in FLEET_BUDGETS for i, p in enumerate(prompts)}
    erids = {k: fleet._routes[r][1] for k, r in pinned.items()}
    res = fleet.run()
    pinned = {k: res[r] for k, r in pinned.items()}
    ab = [fleet.submit(p, MAX_TOKENS, ab=FLEET_AB) for p in prompts]
    picks = [fleet._routes[r][0] for r in ab]
    res = fleet.run()
    ab = [(n, res[r]) for n, r in zip(picks, ab)]
    spec = [fleet.submit(p, MAX_TOKENS, spec=True) for p in prompts]
    sd = fleet._spec
    vrids = [sd._routes[fleet._spec_routes[r]][1] for r in spec]
    if spec_state is not None:
        sd.k, sd.accept_ema = spec_state
    state = (sd.k, sd.accept_ema)
    res = fleet.run()
    return {"pinned": pinned, "erids": erids, "ab": ab,
            "spec": [res[r] for r in spec], "vrids": vrids,
            "spec_state": state, "k_end": sd.k}


@contextlib.contextmanager
def recording_fleet(fleet, rec: dict):
    """While open (eager steps): every fused decode_step counted per
    member (the engines' steps and the draft loops), the dense member's
    decode rows kept (rid per slot, positions, logits), and every verify
    pass kept (rid per slot, start positions, logits)."""
    from repro_torch.models import model as M
    names = {id(e.params): n for n, e in fleet.engines.items()}
    fused, verify_step = fleet.fns._fused, M.verify_step

    def rids(name):
        return [None if r is None else r.rid
                for r in fleet.engines[name].active]

    def fused_rec(p, toks, caches, t):
        logits, c = fused(p, toks, caches, t)
        rec["forwards"][names[id(p)]] += 1
        if names[id(p)] == "0.0":
            rec["dense"].append((rids("0.0"), t.clone(), logits.clone()))
        return logits, c

    def verify_rec(cfg, p, toks, caches, t):
        logits, c = verify_step(cfg, p, toks, caches, t)
        rec["verify"].append((rids(names[id(p)]), t.clone(), logits.clone()))
        return logits, c

    fleet.fns._fused, M.verify_step = fused_rec, verify_rec
    try:
        yield rec
    finally:
        del fleet.fns._fused
        M.verify_step = verify_step


def spec_vs_verifier(torch, prompts, run: dict, rec: dict) -> dict:
    """Each spec stream against the verifier decoding alone (the dense
    member's pinned stream): the verify pass's logits against the decode
    step's at every position up to the first differing token (8 bf16 ulps
    of the row's max); a differing token must be a near-tie of the
    verifier's own decode logits (margin at most twice the difference)."""
    def decode_row(rid, pos):
        return next(lg[s] for rids, t, lg in rec["dense"]
                    for s, r in enumerate(rids)
                    if r == rid and int(t[s]) == pos)

    def verify_row(rid, pos):
        row = None       # the last pass over pos committed it
        for rids, t, lg in rec["verify"]:
            for s, r in enumerate(rids):
                if r == rid and int(t[s]) <= pos < int(t[s]) + lg.shape[1]:
                    row = lg[s, pos - int(t[s])]
        return row

    ties, n, equal, worst = [], 0, 0, 0.0
    for i, p in enumerate(prompts):
        a, b = run["pinned"][i, "0.0"], run["spec"][i]
        first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
        check(len(a) == len(b) or first is not None,
              f"spec request {i}: {len(b)} tokens against the verifier's "
              f"{len(a)} with no differing token")
        for j in range(len(a) if first is None else first + 1):
            pos = len(p) - 1 + j
            la = decode_row(run["erids"][i, "0.0"], pos)
            lb = verify_row(run["vrids"][i], pos)
            err, tol = logit_err(torch, lb, la, LOGIT_ULPS_FULL)
            check(err <= tol, f"spec request {i} at position {pos}: verify "
                  f"logits differ from the verifier's decode by {err} over "
                  f"{tol} ({LOGIT_ULPS_FULL} bf16 ulps of the row's max)")
            check(int(la.argmax()) == a[j] and int(lb.argmax()) == b[j],
                  f"spec request {i} at position {pos}: recorded logits do "
                  "not give the streams' tokens")
            n += 1
            equal += bool(torch.equal(la, lb))
            worst = max(worst, err / tol)
        if first is not None:
            margin = float(la[a[first]] - la[b[first]])
            check(margin <= 2 * err, f"spec request {i} at position {pos}: "
                  f"tokens {a[first]} vs {b[first]} with margin {margin} "
                  f"past twice the logit difference {err}")
            ties.append((i, pos, a[first], b[first], margin, err))
    return {"rows": n, "bit_equal_rows": equal, "worst": worst,
            "ties": ties}


def member_step_ms(torch, eng, n: int = 20) -> dict:
    """The engine's wall time per decode step (``EngineFns.step``: inputs
    to the card, the step, greedy tokens back), eager and replayed from
    its CUDA graph, median of ``n`` after 3 warm-up steps.  The member is
    idle: the steps write ring rows no request reads."""
    import numpy as np
    from repro_torch.serve.engine import eager
    toks = np.zeros((eng.slots,), np.int32)
    pos = np.full((eng.slots,), 200, np.int32)
    out = {}
    for mode in ("eager", "graph"):
        with eager() if mode == "eager" else contextlib.nullcontext():
            ts = []
            for i in range(n + 3):
                t0 = time.perf_counter()
                eng.fns.step(eng.params, toks, eng.caches, pos)
                ts.append(time.perf_counter() - t0)
        out[mode] = statistics.median(ts[3:]) * 1e3
    return out


def fleet_surfaces(torch, cfg, fleet, prompts, S) -> dict:
    """The draft loop (``draft_4``, the 2:4 member) and the verify pass
    (``verify_4``, the dense member) at fixed inputs, each replayed from a
    CUDA graph == eager; and the verify pass's 4 columns against 4
    sequential decode steps of the same member, bit for bit or not."""
    import numpy as np
    from repro_torch.models import model as M
    dev = fleet.fns.device
    dense, draft = fleet.engines["0.0"].params, fleet.engines["2:4"].params
    head = torch.from_numpy(np.stack([prompts[1][:40], prompts[3][:40]]))
    feed = torch.from_numpy(np.stack([prompts[1][40:44],
                                      prompts[3][40:44]])).to(dev)
    t = torch.full((2,), 40, dtype=torch.int32, device=dev)

    def prefilled(params):
        return M.prefill(cfg, params, {"tokens": head.to(dev)},
                         cache_capacity=FLEET_CAPACITY)[1]
    cv, cd, cs = prefilled(dense), prefilled(draft), prefilled(dense)

    def verify():
        return M.verify_step(cfg, dense, feed, cv, t)[0]

    def draft_loop():
        tok, out = feed[:, 0], []
        for i in range(SPEC_K):
            lg = M.decode_step(cfg, draft, tok, cd, t + i, kv_shards=S)[0]
            tok = lg.argmax(-1)
            out.append(lg)
        return torch.stack(out, dim=1)

    ok = {"draft_4": replay_matches_eager(torch, draft_loop),
          "verify_4": replay_matches_eager(torch, verify)}
    for name, same in ok.items():
        check(same, f"kv_shards={S}: {name} replayed from a CUDA graph "
              "differs from the eager call")
    got = verify()
    cols = []
    for i in range(SPEC_K):
        want = M.decode_step(cfg, dense, feed[:, i], cs, t + i,
                             kv_shards=S)[0]
        cols.append((float((got[:, i] - want).abs().max()),
                     bool(torch.equal(got[:, i], want)),
                     logit_err(torch, got[:, i], want, LOGIT_ULPS_FULL)[1]))
    return {"replay": ok, "columns": cols}


def fleet_at(torch, dev, card, cfg, bank, params0, prompts, S,
             counted: dict, masks_made: bool) -> dict:
    """One fleet at ``kv_shards=S``: built from the bank, the traffic
    eager and counted, then twice on the CUDA-graph engines; every gate of
    the phase.  ``masks_made``: the bank has thresholded its masks for an
    earlier fleet already (its memo)."""
    import collections
    from repro_torch import tree
    from repro_torch.serve.engine import eager
    from repro_torch.serve.fleet import SparsityFleet
    from repro_torch.sparse.apply import shared_leaves
    L = cfg.num_layers
    tag = f"kv_shards={S}"

    # -- the main path, counted (eager steps) -------------------------------
    calls = {}
    rec = {"forwards": collections.Counter(), "dense": [], "verify": []}
    for fn in counted.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet = SparsityFleet(bank, params0, FLEET_BUDGETS, slots=FLEET_SLOTS,
                          capacity=FLEET_CAPACITY, spec=FLEET_SPEC,
                          device=dev, kv_shards=S)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    with first_call_per_signature(calls), recording_fleet(fleet, rec), \
            eager():
        run = fleet_traffic(fleet, prompts)
    torch.cuda.synchronize()
    t_eager = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    # -----------------------------------------------------------------------
    engines = fleet.engines
    fw = rec["forwards"]
    want = {"nm_matmul": 7 * L * (fw["2:4"] + engines["2:4"].prefill_calls),
            "nm_matmul_expert": 0, "nm_mask24": 0 if masks_made else 7,
            "flash_decode": L * sum(fw.values()) if S == 1 else 0,
            "flash_decode_partial": 0, "combine_partials": 0}
    print(f"  {tag}: fleet {list(engines)} ({FLEET_SLOTS} slots, capacity "
          f"{FLEET_CAPACITY}) built in {t_build:.2f} s; eager traffic "
          f"{t_eager:.2f} s; launches {launches} over decode forwards "
          f"{dict(fw)} (the draft loops' included) and prefills "
          f"{ {n: e.prefill_calls for n, e in engines.items()} }")
    check(launches == want, f"{tag}: fleet launches {launches}, want {want}")
    print("  " + check_path_calls(torch, calls))
    del calls

    # -- shared leaves: one cast params0, no member copies it ---------------
    n_leaves = len(tree.leaves(fleet.params0))
    n_pruned = sum(m is not None for m in
                   tree.leaves(bank.masks_at(nm=(2, 4))))
    table = fleet.params0["embed"]["table"]
    for name, eng in engines.items():
        n = n_leaves if name == "0.0" else n_leaves - n_pruned
        got = (fleet.reports[name]["shared_dense_leaves"],
               shared_leaves(fleet.params0, eng.params))
        check(got == (n, n) and eng.params["embed"]["table"] is table,
              f"{tag}: member {name} shares {got} leaves of {n_leaves}, "
              f"want {n} (every leaf but the {n_pruned} pruned kernels), "
              "and the one embedding table")

    # -- streams and the report's counters ----------------------------------
    for i, (name, stream) in enumerate(run["ab"]):
        check(stream == run["pinned"][i, name], f"{tag}: A/B request {i} "
              f"on {name} differs from the same prompt pinned there")
    rep = fleet.report()
    b = rep["budgets"]
    picks = collections.Counter(n for n, _ in run["ab"])
    for name in FLEET_BUDGETS:
        toks = (sum(len(run["pinned"][i, name]) for i in range(len(prompts)))
                + sum(len(x) for n, x in run["ab"] if n == name))
        check(b[name]["requests"] == len(prompts) + picks[name]
              and b[name]["tokens"] == toks,
              f"{tag}: member {name} reports {b[name]['requests']} requests"
              f" and {b[name]['tokens']} tokens, want "
              f"{len(prompts) + picks[name]} and {toks}")
    shadow_toks = sum(len(run["pinned"][i, "0.0"])
                      for i, (n, _) in enumerate(run["ab"]) if n != "0.0")
    mirrored = sum(b[n]["cumulative"]["mirrored_picks"] for n in b)
    check(b["0.0"]["shadow"]["requests"] == mirrored == len(prompts)
          - picks["0.0"] and b["0.0"]["shadow"]["tokens"] == shadow_toks,
          f"{tag}: shadow {b['0.0']['shadow']}, mirrored picks {mirrored}, "
          f"want {len(prompts) - picks['0.0']} requests and {shadow_toks} "
          "tokens, out of the headline")
    spec_toks = sum(map(len, run["spec"]))
    check(rep["spec"]["requests"] == len(prompts)
          and rep["spec"]["tokens"] == spec_toks,
          f"{tag}: spec reports {rep['spec']['requests']} requests and "
          f"{rep['spec']['tokens']} tokens, want {len(prompts)} and "
          f"{spec_toks}")
    lossless = spec_vs_verifier(torch, prompts, run, rec)
    del rec

    # -- the same traffic twice on the CUDA-graph engines -------------------
    graph = []
    for r in range(2):
        before = fleet.report()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = fleet_traffic(fleet, prompts, run["spec_state"])
        torch.cuda.synchronize()
        g["seconds"] = time.perf_counter() - t0
        g["captures"] = fleet.fns.capture_counts()
        g["report"] = (before, fleet.report())
        for key in ("pinned", "spec"):
            check(g[key] == run[key], f"{tag}: graph run {r + 1}: the "
                  f"{key} streams differ from the eager run's")
        # A/B picks continue the weighted fair order, so compare each with
        # the same prompt pinned to its member
        check(all(x == g["pinned"][i, n] for i, (n, x) in enumerate(g["ab"])),
              f"{tag}: graph run {r + 1}: an A/B stream differs from its "
              "prompt pinned to the same member")
        graph.append(g)
    caps = graph[0]["captures"]
    check(caps["decode"] == len(FLEET_BUDGETS)
          and all(n == 1 for k, n in caps.items() if k != "decode"),
          f"{tag}: captures {caps}: want one decode graph per member and "
          "one graph per draft and verify surface")
    check(graph[1]["captures"] == caps, f"{tag}: the second graph run "
          f"captured again: {caps} -> {graph[1]['captures']}")
    surfaces = fleet_surfaces(torch, cfg, fleet, prompts, S)
    steps = {name: member_step_ms(torch, eng)
             for name, eng in engines.items()}

    # -- printed, beside the card -------------------------------------------
    (b0, b1) = graph[1]["report"]

    def delta(name):
        x, y = b0["budgets"][name]["cumulative"], \
            b1["budgets"][name]["cumulative"]
        return (y["tokens"] - x["tokens"]) / (y["seconds"] - x["seconds"])
    tok_s = {name: delta(name) for name in FLEET_BUDGETS}
    s0, s1 = b0["spec"], b1["spec"]
    spec_tok_s = (s1["tokens"] - s0["tokens"]) / (s1["seconds"]
                                                  - s0["seconds"])
    acc = rep["spec"]
    for name, ms in steps.items():
        print(f"  [{card}] {tag} member {name}: engine step (EngineFns.step,"
              f" {engines[name].slots} slots) eager {ms['eager']:.2f} ms, "
              f"CUDA graph {ms['graph']:.2f} ms; warm graph run (pinned + "
              f"A/B traffic) {tok_s[name]:.1f} tok/s")
    print(f"  [{card}] {tag} spec {FLEET_SPEC} (adaptive): accept rate "
          f"{acc['accept_rate']:.3f}, {acc['accepted_tokens_per_round']:.2f} "
          f"tokens per round over {acc['rounds']} rounds (eager run), k at "
          f"the end {run['k_end']}; warm graph run {spec_tok_s:.1f} tok/s "
          f"against the verifier alone {tok_s['0.0']:.1f} tok/s "
          f"({spec_tok_s / tok_s['0.0']:.2f}x); random weights: the accept "
          "rate says nothing of quality")
    print(f"  {tag}: graph runs streams == eager run (pinned, A/B, spec), "
          f"captures {caps}, unchanged by the second run; draft_4 / "
          f"verify_4 replayed == eager; graph traffic "
          f"{graph[0]['seconds']:.2f} s (capturing), "
          f"{graph[1]['seconds']:.2f} s (warm)")
    lt = lossless
    print(f"  {tag}: spec streams vs the verifier alone: "
          f"{sum(a == b for a, b in zip(run['spec'], [run['pinned'][i, '0.0'] for i in range(len(prompts))]))}"
          f" of {len(prompts)} identical; verify logits vs the verifier's "
          f"decode over {lt['rows']} rows: {lt['bit_equal_rows']} bit-equal, "
          f"worst {lt['worst']:.3f} of the tolerance ({LOGIT_ULPS_FULL} bf16 "
          f"ulps of the row's max); near-ties (request, position, "
          f"verifier's token, spec's, margin, logit difference): "
          f"{lt['ties']}")
    print(f"  {tag}: verify_4 columns vs 4 sequential decode steps of the "
          f"dense member (max |diff|, bit-equal, 8-ulp tolerance): "
          f"{surfaces['columns']}")
    out = {"launches": launches, "tok_s": tok_s, "spec_tok_s": spec_tok_s,
           "steps": steps, "accept_rate": acc["accept_rate"],
           "tokens_per_round": acc["accepted_tokens_per_round"],
           "k_end": run["k_end"], "lossless": lossless, "captures": caps,
           "columns": surfaces["columns"]}
    del fleet
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_fleet(torch, dev, card: str, bank) -> dict:
    """Phase 6's full-width bank (``MaskBank`` as phase 6 reloaded it, its
    mask memo cleared: the fleet thresholds its budgets itself) serving
    three budgets behind one router, at ``kv_shards`` None and 1
    (:func:`fleet_at`)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.models import model as M
    counted = {"nm_matmul": nm_matmul, "nm_matmul_expert": nm_matmul_expert,
               "nm_mask24": nm_mask24,
               **{name: getattr(fd, name) for name in FLASH_KERNELS}}
    cfg = get_config("llama3.2-1b")
    bank._mask_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params0 = M.init_params(cfg, 0, device=dev)      # phase 6's weights
    print(f"  {cfg.name}: phase 6's bank ({bank.meta['steps_run']} steps, "
          f"checksum {bank.meta['checksum']}); budgets {FLEET_BUDGETS} (the "
          "0.5 member thresholds every prunable score globally: a sort)")
    prompts = serving_prompts(cfg)
    out = {}
    for i, S in enumerate(FLEET_KV):
        out[S] = fleet_at(torch, dev, card, cfg, bank, params0, prompts, S,
                          counted, masks_made=i > 0)
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{card}] max memory allocated through the phase "
          f"{peak / 2 ** 30:.2f} GiB")
    del bank, params0
    gc.collect()
    torch.cuda.empty_cache()
    return {"by_kv": out, "peak_gib": peak / 2 ** 30}


def stoch_draws_card_vs_cpu(torch, dev) -> None:
    """stochria's Bernoulli row and column draws (threefry, as the
    reference's) of every full-width llama3.2-1b prunable leaf over 3
    search steps, drawn on the card and on the CPU: equal."""
    from repro_torch.configs.base import PruneConfig, get_config
    from repro_torch.core import metrics, prng
    from repro_torch.core.calibrate import SEARCH_SEED
    frac = PruneConfig().stoch_frac
    leaves = calib_leaves(get_config("llama3.2-1b"))
    n = kept = 0
    for step in range(3):
        key = prng.fold_in(prng.key(SEARCH_SEED), step)
        for i, shape in enumerate(leaves.values()):
            k = prng.fold_in(key, i)
            card = metrics.stoch_weights(k, shape, frac, dev)
            cpu = metrics.stoch_weights(k, shape, frac, "cpu")
            for got, want in zip(card, cpu):
                check(torch.equal(got.cpu(), want), f"stochria draws of "
                      f"{shape} at step {step}: card differs from CPU")
                n += want.numel()
                kept += int(want.sum())
    print(f"  stochria draws (threefry) of {len(leaves)} full-width leaves x "
          f"3 steps, card == CPU: {n} Bernoulli({frac}) weights, "
          f"{kept / n:.4f} kept")


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
    worst, ties, n = banks_agree(torch, on["card"], on["cpu"], pcfg)
    print(f"  smoke calibration, card vs CPU ({CALIB_STEPS} steps): Gamma/V "
          f"worst {worst:.3f} of the tolerance; {ties} of {n} groups of 4 "
          f"differ in the 2:4 masks, each a near-tie")
    shutil.rmtree(banks, ignore_errors=True)


def banks_agree(torch, card, cpu, pcfg) -> tuple:
    """A calibration on the card against the same one on the CPU: Gamma/V
    within the CPU tests' tolerance, and the masks equal but for near-ties
    of the CPU run's own scores.  Returns (worst share of the tolerance,
    groups that differ, groups): 2:4 groups of 4, or for an unstructured
    bank single weights of the masks at sparsity 0.5, each that differs
    within twice its tolerance of the CPU's global threshold."""
    import numpy as np
    from repro_torch import tree
    if pcfg.mode != "nm":
        return _unstructured_banks_agree(torch, card, cpu, pcfg)
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
    return worst, ties, n


def _unstructured_banks_agree(torch, card, cpu, pcfg) -> tuple:
    """:func:`banks_agree` for an unstructured bank: Gamma / V as there;
    the masks at sparsity 0.5 (one global threshold of the export's
    scores |Gamma| + eps |V|) equal but for weights whose CPU score is
    within twice its tolerance of the CPU's threshold."""
    from repro_torch import tree
    worst = 0.0
    masks_card, masks_cpu = card.masks_at(0.5), cpu.masks_at(0.5)
    G = dict(tree.flatten_with_path(cpu.Gamma))
    Vs = dict(tree.flatten_with_path(cpu.V))
    leaves = [p for p, v in Vs.items() if v is not None]
    gmax = max(float(G[p].abs().max()) for p in leaves)
    vmax = max(float(Vs[p].abs().max()) for p in leaves)
    eps = 1e-6 * max(gmax, 1e-30) / max(vmax, 1e-30) if gmax > 0 \
        else 1.0 / max(vmax, 1e-30)
    scores, tols = {}, {}
    for path, vg in tree.flatten_with_path(card.V):
        if vg is None:
            continue
        vc = Vs[path]
        tol = BF16_ULP * (vc.abs() + pcfg.lam) + 1e-4 * vc.abs().max()
        gg = dict(tree.flatten_with_path(card.Gamma))[path].cpu()
        for got, want in ((vg.cpu(), vc), (gg, G[path])):
            ratio = float(((got - want).abs() / tol).max())
            check(ratio <= 1, f"card vs CPU calibration at {path}: "
                  f"{ratio:.3f} of the tolerance")
            worst = max(worst, ratio)
        scores[path] = G[path].abs() + eps * vc.abs()
        tols[path] = tol
    mk = dict(tree.flatten_with_path(masks_cpu))
    mg = dict(tree.flatten_with_path(masks_card))
    thr = min(float(scores[p][mk[p].bool()].min()) for p in leaves)
    ties, n = 0, 0
    for p in leaves:
        diff = mk[p].bool() != mg[p].cpu().bool()
        off = (scores[p][diff] - thr).abs()
        check(bool((off <= 2 * tols[p][diff] + 1e-30).all()),
              f"card vs CPU unstructured masks at {p}: a weight "
              f"{float(off.max()) if diff.any() else 0.0} from the "
              "threshold differs, no near-tie")
        ties += int(diff.sum())
        n += mk[p].numel()
    return worst, ties, n


# ---------------------------------------------------------------------------
# Phase 8: the paper's evaluation at full width
# ---------------------------------------------------------------------------

# held-out batches of the eval: 4 x 4 x 128 tokens, so nm_matmul runs at
# B*S = 512 rows and the f32 log-softmax over vocab 128256 takes 262 MB
EVAL_BATCHES = dict(n=4, batch=4, seq=128)
EVAL_SPARSITIES = (0.5, 0.6, 0.7)
BASELINE_SPARSITY = 0.6
# the reference's default PruneConfig (stochria, unstructured, median
# norm), its 100 steps cut to the launcher's 30, as phase 6 runs
UNSTRUCTURED_STEPS = 30
# Table 5's Eq. 8 ablation (benchmarks/table5_mirror_ablation.py): rho
# 1e-5, l2 0.01, key 11; its 60 steps cut to 10
ABLATION = dict(rho=1e-5, l2=0.01, steps=10, seed=11,
                sparsities=(0.5, 0.6))
SPARSE_ARGS = ("--batch", "4", "--prompt-len", "64", "--gen", "12")
TEMPERATURE = 0.8
EVAL_KERNELS = ("nm_matmul", "nm_matmul_expert", "prox24",
                "saliency_fused_step", "nm_mask24")


def _kernel_fns():
    from repro_torch.kernels.nm_prox import nm_mask24, prox24
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.kernels.saliency_fuse import saliency_fused_step
    return {"nm_matmul": nm_matmul, "nm_matmul_expert": nm_matmul_expert,
            "prox24": prox24, "saliency_fused_step": saliency_fused_step,
            "nm_mask24": nm_mask24}


@contextlib.contextmanager
def counted(out: dict, name: str):
    """Every eval-path kernel's count set to 0 on entry; the launches made
    inside are stored as ``out[name]`` on exit."""
    fns = _kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    try:
        yield
    finally:
        out[name] = {k: fn.launches for k, fn in fns.items()}


def eval_checked(torch, cfg, params, valid, staged) -> dict:
    """``eval_ppl`` on the held-out batches, timed (host to host, its one
    sync included), then its loop body (``eval_nll`` over batches already
    on the card) under ``set_sync_debug_mode("error")``, and a plain
    per-batch loop that reads every batch's NLL: the two means equal to
    1e-6 relative, and eval_ppl == exp(min(mean NLL, 30))."""
    import math
    from repro_torch.optim import losses
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppl = losses.eval_ppl(cfg, params, valid)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tot, n = losses.eval_nll(cfg, params, staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    nll = float(tot) / n
    sizes = [b["tokens"][:, 1:].numel() for b in staged]
    plain = [float(losses.lm_loss(cfg, params, b)[1]["nll"]) for b in staged]
    want = sum(x * m for x, m in zip(plain, sizes)) / sum(sizes)
    check(abs(nll - want) <= 1e-6 * abs(want),
          f"eval_nll's mean NLL {nll} vs the plain loop's {want}")
    check(abs(ppl - math.exp(min(want, 30.0))) <= 1e-6 * ppl,
          f"eval_ppl {ppl} vs exp(min({want}, 30))")
    return {"ppl": ppl, "nll": nll, "s": dt, "tok_s": n / dt}


def _masked(params0, masks):
    from repro_torch.core import masks as masks_mod
    return masks_mod.apply_masks(params0, masks)


def phase_eval(torch, dev, card: str, bank24) -> dict:
    """The paper's evaluation loop at llama3.2-1b's published widths from
    phase 6's weights and calibration batches, then the launcher's
    ``--sparse`` and ``--temperature``, then MoE calibration: see the
    module docstring, phase 8."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig, get_config
    from repro_torch.core import calibrate as cal
    from repro_torch.core import masks as masks_mod
    from repro_torch.core import metrics as metrics_mod
    from repro_torch.core.prunable import prunable_map
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.calibrate import calibrate_to_bank
    from repro_torch.models import model as M
    from repro_torch.optim.losses import lm_loss
    from repro_torch.sparse import pack_mask_tree, unpack_mask_tree

    cfg = get_config("llama3.2-1b")
    calib = batches_for(cfg, n=8, batch=4, seq=64, split="calib")
    valid = batches_for(cfg, split="valid", **EVAL_BATCHES)
    staged = [{"tokens": torch.from_numpy(b["tokens"]).to(dev)}
              for b in valid]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params0 = M.init_params(cfg, 0, device=dev)        # phase 6's weights
    launches, rows, calls = {}, {}, {}
    tokens = sum(b["tokens"][:, 1:].size for b in valid)
    print(f"  {cfg.name}: eval on {EVAL_BATCHES['n']} held-out batches of "
          f"{EVAL_BATCHES['batch']} x {EVAL_BATCHES['seq']} tokens "
          f"({tokens} targets); phase 6's weights (seed 0) and calibration "
          "batches")

    def evaluate(name, params, path=None):
        if path is None:
            r = eval_checked(torch, cfg, params, valid, staged)
        else:
            with counted(launches, path), first_call_per_signature(calls):
                r = eval_checked(torch, cfg, params, valid, staged)
        rows[name] = r
        print(f"  eval {name:>28}: ppl {r['ppl']:.6g} (mean NLL "
              f"{r['nll']:.6f}), {r['s']:.3f} s, {r['tok_s']:.0f} tok/s; "
              "one host read, loop body sync-free, == the plain loop")
        return r

    # -- phase 6's 2:4 bank, masked-dense and compressed ---------------------
    bank24._mask_cache.clear()      # the fleet's budgets
    masks24 = bank24.masks_at()
    masked24 = _masked(params0, masks24)
    evaluate("dense", params0)
    evaluate("2:4 masked-dense (phase 6)", masked24)
    comp24 = bank24.sparse_params(params0)
    del bank24, masks24
    gc.collect()
    torch.cuda.empty_cache()
    evaluate("2:4 compressed (phase 6)", comp24, path="eval llama3.2-1b 2:4")
    n_fwd = 2 * len(valid)        # eval_ppl, then the sync-free loop
    n_fwd += len(valid)           # the plain loop
    check(launches["eval llama3.2-1b 2:4"]["nm_matmul"]
          == 7 * cfg.num_layers * n_fwd,
          f"2:4 eval launches {launches['eval llama3.2-1b 2:4']}")
    with torch.inference_mode():
        a = lm_loss(cfg, comp24, staged[0])[1]["nll"]
        b = lm_loss(cfg, masked24, staged[0])[1]["nll"]
        la = M.forward(cfg, comp24, staged[0])[0]
        lb = M.forward(cfg, masked24, staged[0])[0]
    err, tol = logit_err(torch, la, lb, LOGIT_ULPS_FULL)
    check(err <= tol, f"2:4 compressed vs masked-dense logits: {err} > "
          f"{tol}")
    check(abs(float(a) - float(b)) <= 2 * tol,
          f"2:4 compressed vs masked-dense NLL {float(a)} vs {float(b)}")
    print(f"  2:4 compressed vs masked-dense on batch 0: logits max err "
          f"{err:.4g} <= {tol:.4g} ({LOGIT_ULPS_FULL} bf16 ulps of the "
          f"largest), NLL {float(a):.6f} vs {float(b):.6f} (within 2x)")
    print("  " + check_path_calls(torch, calls))
    calls.clear()
    del comp24, masked24, la, lb
    gc.collect()
    torch.cuda.empty_cache()

    # -- stats: jit against the eager tape -----------------------------------
    t0 = time.perf_counter()
    s_jit = cal.collect_stats(cfg, params0, calib[:4], impl="jit")
    torch.cuda.synchronize()
    t_jit = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_tape = cal.collect_stats(cfg, params0, calib[:4], impl="tape")
    t_tape = time.perf_counter() - t0
    worst, ok, n = cal.stats_parity(s_tape, s_jit, prunable_map(params0))
    check(ok and n == 7, f"stats_parity: worst {worst} over {n} leaves")
    print(f"  stats over 4 batches: jit {t_jit:.2f} s, tape {t_tape:.2f} s; "
          f"stats_parity worst {worst:.3e} over {n} leaves (tol 5e-2)")
    del s_tape

    # -- the unstructured search (the reference's default PruneConfig) ------
    pcfg = PruneConfig(steps=UNSTRUCTURED_STEPS)
    banks = _banks_dir()
    seen = {}
    t0 = time.perf_counter()
    with counted(launches, "calibrate llama3.2-1b stochria unstructured"), \
            search_calls_checked(torch, seen):
        bank = calibrate_to_bank(banks / "unstructured", cfg=cfg, pcfg=pcfg,
                                 params=params0, calib=calib,
                                 arch=cfg.name, smoke=False, log_every=10)
    t_cal = time.perf_counter() - t0
    got = launches["calibrate llama3.2-1b stochria unstructured"]
    check(got["saliency_fused_step"] == 7 * pcfg.steps
          and got["prox24"] == 0 and got["nm_mask24"] == 0,
          f"unstructured search launches {got}")
    print(f"  {pcfg.local_metric}, {pcfg.mode}, score_norm "
          f"{pcfg.score_norm}, {pcfg.steps} steps (PruneConfig's 100 cut to "
          f"the launcher's 30): stats {bank.meta['stats_seconds']:.2f} s, "
          f"search {bank.meta['search_seconds']:.2f} s, calibrate_to_bank "
          f"{t_cal:.1f} s; {len(seen)} distinct search-kernel calls held "
          "against their plain versions, all bit-identical: "
          + "; ".join(f"{k[0]} {k[1]} {k[3]}" for k in sorted(seen)))
    for h in bank.meta["history"]:
        print("  history: " + ", ".join(f"{k} {v:.6g}" for k, v in
                                        sorted(h.items())))
    for s in EVAL_SPARSITIES:
        t0 = time.perf_counter()
        m = bank.masks_at(sparsity=s)
        torch.cuda.synchronize()
        t_mask = time.perf_counter() - t0
        got = masks_mod.sparsity_of(m)
        check(abs(got - s) <= 1e-6, f"sparsity_of {got} at budget {s}")
        if s == EVAL_SPARSITIES[0]:
            t0 = time.perf_counter()
            packed = pack_mask_tree(m)
            torch.cuda.synchronize()
            t_pack = time.perf_counter() - t0
            host = pack_mask_tree(tree.to_device(m, "cpu"))
            nbytes = 0
            for (path, a), (_, b) in zip(tree.flatten_with_path(packed),
                                         tree.flatten_with_path(host)):
                check((a is None) == (b is None) and (a is None or (
                    a.shape == b.shape and torch.equal(a.bits.cpu(),
                                                       b.bits))),
                      f"pack_mask_tree bytes differ card vs CPU at {path}")
                nbytes += 0 if a is None else a.nbytes
            back = unpack_mask_tree(packed)
            for (path, a), (_, b) in zip(tree.flatten_with_path(back),
                                         tree.flatten_with_path(m)):
                check((a is None and b is None) or torch.equal(a, b),
                      f"unpack_mask_tree round trip differs at {path}")
            print(f"  pack_mask_tree at {s}: {nbytes} bytes on the card "
                  f"({t_pack * 1e3:.1f} ms) == the CPU's packing of the "
                  "same masks; unpack round-trips")
            del packed, host, back
        print(f"  masks_at({s}): global threshold over the prunable scores "
              f"in {t_mask:.2f} s, sparsity_of {got:.9f}")
        evaluate(f"UniPruning {s}", _masked(params0, m))
        del m
        gc.collect()
        torch.cuda.empty_cache()
    stats = bank.stats
    bank._mask_cache.clear()
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    for method in ("magnitude", "wanda", "ria"):
        m = cal.baseline_masks(method, params0, stats, BASELINE_SPARSITY)
        evaluate(f"{method} {BASELINE_SPARSITY}", _masked(params0, m))
        del m
        gc.collect()
        torch.cuda.empty_cache()
    shutil.rmtree(banks, ignore_errors=True)

    # -- the Eq. 8 / Table 5 ablation ----------------------------------------
    from functools import partial
    from repro_torch.core import prng
    from repro_torch.core.mirror import no_mirror_step
    apcfg = PruneConfig(local_metric="stochria", rho=ABLATION["rho"],
                        steps=ABLATION["steps"])
    W = tree.tree_map(lambda x: x.float().clone(), params0)
    pr = prunable_map(params0)
    rng = prng.key(ABLATION["seed"])
    steps = []
    for n in range(apcfg.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W, loss = no_mirror_step(
            apcfg, partial(lm_loss, cfg), W,
            {"tokens": torch.from_numpy(calib[n % len(calib)]["tokens"])
             .to(dev)}, stats, pr, rng, n, l2=ABLATION["l2"])
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        check(math_finite(float(loss)), f"ablation objective {float(loss)}")
    print(f"  Eq. 8 ablation (stochria, rho {ABLATION['rho']}, l2 "
          f"{ABLATION['l2']}; Table 5's 60 steps cut to {apcfg.steps}): "
          f"objective {float(loss):.6g} after {apcfg.steps} steps, median "
          f"step {statistics.median(steps) * 1e3:.1f} ms")
    S = metrics_mod.metric_tree("stochria", W, stats, pr, key=rng,
                                norm="none")
    del W
    gc.collect()
    torch.cuda.empty_cache()
    for s in ABLATION["sparsities"]:
        m = masks_mod.unstructured_masks(S, s, scope="global")
        got = masks_mod.sparsity_of(m)
        check(abs(got - s) <= 1e-6, f"ablation sparsity_of {got} at {s}")
        evaluate(f"Eq. 8 ablation {s}", _masked(params0, m))
        del m
        gc.collect()
        torch.cuda.empty_cache()
    del S, stats, params0
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{card}] max memory allocated through the llama eval "
          f"{peak / 2 ** 30:.2f} GiB")
    out = {"rows": rows, "peak_gib": peak / 2 ** 30}
    out.update(phase_sparse_launcher(torch, dev, card, launches))
    out.update(phase_moe_calibration(torch, dev, card, launches, calls))
    out["launches"] = launches
    return out


def math_finite(x: float) -> bool:
    return x == x and abs(x) < float("inf")


def phase_sparse_launcher(torch, dev, card: str, launches: dict) -> dict:
    """``launch.serve.main`` with ``--sparse --save-artifact`` at full width
    (the bank under build/, removed after), then ``--temperature`` from
    that bank on the same seed-0 weights: its gumbel draws on the card ==
    the CPU's, bit for bit."""
    import io
    from repro_torch.core import prng
    from repro_torch.launch import serve
    banks = _banks_dir()
    out_dir = banks / "sparse"
    buf = io.StringIO()
    t0 = time.perf_counter()
    with counted(launches, "serve --sparse llama3.2-1b"), \
            contextlib.redirect_stdout(buf):
        serve.main(["--arch", "llama3.2-1b", "--sparse", "--save-artifact",
                    str(out_dir), *SPARSE_ARGS])
    t_sparse = time.perf_counter() - t0
    text = buf.getvalue()
    print(f"  serve --sparse ({t_sparse:.1f} s in main): "
          + " | ".join(text.strip().splitlines()))
    got = launches["serve --sparse llama3.2-1b"]
    check(got["saliency_fused_step"] == 7 * 30 and got["prox24"] == 7 * 30
          and got["nm_mask24"] == 7 and "saved mask bank" in text,
          f"--sparse launches {got}")
    meta = json.loads((out_dir / "manifest.json").read_text())["metadata"]
    check(meta["steps_run"] == 30 and meta["pcfg"]["mode"] == "nm"
          and meta["pcfg"]["local_metric"] == "wanda",
          f"--sparse bank: {meta['pcfg']}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with counted(launches, "serve --temperature llama3.2-1b"), \
            contextlib.redirect_stdout(buf):
        serve.main(["--arch", "llama3.2-1b", "--sparse-artifact",
                    str(out_dir), "--temperature", str(TEMPERATURE),
                    *SPARSE_ARGS])
    t_temp = time.perf_counter() - t0
    text = buf.getvalue()
    print(f"  serve --temperature {TEMPERATURE} ({t_temp:.1f} s in main): "
          + " | ".join(text.strip().splitlines()))
    gen = int(SPARSE_ARGS[SPARSE_ARGS.index("--gen") + 1])
    batch = int(SPARSE_ARGS[SPARSE_ARGS.index("--batch") + 1])
    from repro_torch.configs.base import get_config
    cfg = get_config("llama3.2-1b")
    got = launches["serve --temperature llama3.2-1b"]
    check(got["nm_matmul"] == 7 * cfg.num_layers * gen
          and got["nm_mask24"] == 7, f"--temperature launches {got}")
    shutil.rmtree(banks, ignore_errors=True)
    # the draws the loop made: decode step i's gumbel(key(100 + i))
    V = cfg.vocab_size
    for i in range(gen - 1):
        a = prng.gumbel(prng.key(100 + i), (batch, V), dev)
        b = prng.gumbel(prng.key(100 + i), (batch, V), "cpu")
        check(torch.equal(a.cpu(), b), f"gumbel draws of step {i}: card "
              "differs from CPU")
    print(f"  gumbel draws of the {gen - 1} decode steps ({batch} x {V} f32 "
          "each), card == CPU bit for bit")
    return {"sparse_s": t_sparse, "temperature_s": t_temp}


def _moe_counts():
    """While open, the routed-row counts each MoE stats record is given
    (per expert, in call order), from ``core.tape``'s jitted tape."""
    from repro_torch.core import tape as tape_mod
    rec = []
    record = tape_mod.JitTape.record

    def spy(self, kernel, x, *, count=None, ref_count=None):
        if count is not None:
            rec.append((count.cpu().tolist(), ref_count))
        return record(self, kernel, x, count=count, ref_count=ref_count)

    @contextlib.contextmanager
    def ctx():
        tape_mod.JitTape.record = spy
        try:
            yield rec
        finally:
            tape_mod.JitTape.record = record
    return ctx()


def phase_moe_calibration(torch, dev, card: str, launches: dict,
                          calls: dict) -> dict:
    """Full-width mixtral-8x22b (phase 5's 2 layers): the stats pass, jit
    against the tape, with each expert's routed rows; then the committed
    trained moe-tiny: a 30-step wanda 2:4 calibration on the card and on
    the CPU, and eval_ppl of its compressed bank through nm_matmul_expert
    against masked-dense."""
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig, get_config
    from repro_torch.configs.tiny import FAMILIES
    from repro_torch.convert import load_params_pickle
    from repro_torch.core import calibrate as cal
    from repro_torch.core.prunable import prunable_map
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.calibrate import calibrate_to_bank
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("mixtral-8x22b"),
                              num_layers=MIXTRAL_LAYERS)
    calib = batches_for(cfg, n=4, batch=4, seq=64, split="calib")
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init_params(cfg, 0, device=dev)
    with _moe_counts() as rec:
        t0 = time.perf_counter()
        s_jit = cal.collect_stats(cfg, params, calib, impl="jit")
        torch.cuda.synchronize()
        t_jit = time.perf_counter() - t0
    t0 = time.perf_counter()
    s_tape = cal.collect_stats(cfg, params, calib, impl="tape")
    t_tape = time.perf_counter() - t0
    s_worst, ok, n = cal.stats_parity(s_tape, s_jit, prunable_map(params))
    check(ok and n == 7,
          f"mixtral stats_parity: worst {s_worst} over {n} leaves")
    expert = [tuple(v.shape) for p, v in tree.flatten_with_path(s_jit)
              if v is not None and "['moe']" in p]
    check(len(expert) == 3 and all(s[:2] == (MIXTRAL_LAYERS,
                                             cfg.num_experts)
                                   for s in expert),
          f"mixtral expert-bank stats shapes {expert}")
    # one (up, gate, down) triple of records per layer per batch
    per_call = [rec[i][0] for i in range(0, len(rec), 3)]
    check(len(per_call) == len(calib) * MIXTRAL_LAYERS,
          f"{len(per_call)} expert-bank records")
    T = rec[0][1]
    print(f"  mixtral-8x22b ({MIXTRAL_LAYERS} of 56 layers, full width): "
          f"stats over {len(calib)} batches of 4 x 64, jit {t_jit:.2f} s, "
          f"tape {t_tape:.2f} s; stats_parity worst {s_worst:.3e} over {n} "
          f"leaves (tol 5e-2); expert stats {expert}")
    for layer in range(MIXTRAL_LAYERS):
        rows = per_call[layer::MIXTRAL_LAYERS]
        tot = [sum(r[e] for r in rows) for e in range(len(rows[0]))]
        print(f"    layer {layer}: routed rows per expert over the "
              f"{len(calib)} batches {tot} (each batch T = {T} tokens x "
              f"top-2 = {2 * T} assignments, capacity-dropped ones not "
              "counted)")
    del params, s_jit, s_tape
    gc.collect()
    torch.cuda.empty_cache()

    # -- the committed trained moe-tiny: calibration card vs CPU, then eval --
    tcfg = FAMILIES["moe-tiny"]
    p_cpu = load_params_pickle(ROOT / "results" / "bench_models"
                               / "moe-tiny.pkl")
    tcal = batches_for(tcfg, n=8, batch=4, seq=64, split="calib")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=CALIB_STEPS,
                       stats_batches=4)
    banks = _banks_dir()
    on = {}
    seen = {}
    for d in (dev, "cpu"):
        name = "card" if d is dev else "cpu"
        ctx = (counted(launches, "calibrate moe-tiny wanda 2:4")
               if d is dev else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx, (search_calls_checked(torch, seen) if d is dev
                   else contextlib.nullcontext()):
            on[name] = calibrate_to_bank(
                banks / name, cfg=tcfg, pcfg=pcfg,
                params=tree.to_device(p_cpu, d), calib=tcal, arch="moe-tiny",
                smoke=False, log_every=10)
            if d is dev:
                on[name].masks_at()
        on[name + "_s"] = time.perf_counter() - t0
    got = launches["calibrate moe-tiny wanda 2:4"]
    check(got["saliency_fused_step"] == 7 * CALIB_STEPS
          and got["prox24"] == 7 * CALIB_STEPS and got["nm_mask24"] == 7,
          f"moe-tiny calibration launches {got}")
    worst, ties, n = banks_agree(torch, on["card"], on["cpu"], pcfg)
    print(f"  moe-tiny (trained, committed) {CALIB_STEPS}-step wanda 2:4, "
          f"card {on['card_s']:.1f} s vs CPU {on['cpu_s']:.1f} s: Gamma/V "
          f"worst {worst:.3f} of the tolerance; {ties} of {n} groups of 4 "
          "differ in the masks, each a near-tie; expert leaves through "
          + "; ".join(f"{k[0]} {k[1]}" for k in sorted(seen)))
    valid = batches_for(tcfg, n=3, batch=12, seq=128, split="valid")
    staged = [{"tokens": torch.from_numpy(b["tokens"]).to(dev)}
              for b in valid]
    p_card = tree.to_device(p_cpu, dev)
    comp = on["card"].sparse_params(p_card)
    masked = on["card"].sparse_params(p_card, compressed=False)
    with counted(launches, "eval moe-tiny 2:4"), \
            first_call_per_signature(calls):
        rc = eval_checked(torch, tcfg, comp, valid, staged)
    rm = eval_checked(torch, tcfg, masked, valid, staged)
    got = launches["eval moe-tiny 2:4"]
    check(got["nm_matmul_expert"] == 3 * tcfg.num_layers * 3 * len(valid)
          and got["nm_matmul"] == 4 * tcfg.num_layers * 3 * len(valid),
          f"moe-tiny eval launches {got}")
    from repro_torch.optim.losses import lm_loss
    with torch.inference_mode():
        la = M.forward(tcfg, comp, staged[0])[0]
        lb = M.forward(tcfg, masked, staged[0])[0]
        a = float(lm_loss(tcfg, comp, staged[0])[1]["nll"])
        b = float(lm_loss(tcfg, masked, staged[0])[1]["nll"])
    err, tol = logit_err(torch, la, lb, LOGIT_ULPS_FULL)
    # MoE: a re-routed near-tie moves whole rows; the NLL still agrees
    check(abs(a - b) <= 2e-3 * abs(b), f"moe-tiny 2:4 NLL {a} vs {b}")
    print(f"  moe-tiny 2:4 eval: compressed ppl {rc['ppl']:.6g} ({rc['s']:.3f}"
          f" s, {rc['tok_s']:.0f} tok/s) vs masked-dense {rm['ppl']:.6g}; "
          f"batch 0 logits max err {err:.4g} (tol {tol:.4g}), NLL {a:.6f} vs "
          f"{b:.6f}")
    print("  " + check_path_calls(torch, calls))
    shutil.rmtree(banks, ignore_errors=True)
    return {"moe_tiny": {"compressed": rc, "masked": rm},
            "moe_stats_worst": s_worst}


# ---------------------------------------------------------------------------
# Phase 9: training (the launcher at full width, resume, the system test on
# a model the card trained, moe-tiny)
# ---------------------------------------------------------------------------

# the launcher at llama3.2-1b's published widths: 20 steps of 8 x 256
# tokens, remat on (the launcher's), a checkpoint at step 15 and the final
# one at 20
TRAIN_ARGS = ["--arch", "llama3.2-1b", "--steps", "20", "--batch", "8",
              "--seq", "256", "--ckpt-every", "15", "--log-every", "1"]
TRAIN_STEPS, TRAIN_TOKENS, RESUME_AT = 20, 8 * 256, 15
# tests/test_system.py's CFG and recipe, field for field
SYS_CFG = dict(name="sys", family="dense", d_model=96, num_layers=3,
               num_heads=4, num_kv_heads=2, head_dim=24, d_ff=256,
               vocab_size=512)
SYS_KERNELS = ("saliency_fused_step", "prox24", "nm_mask24", "nm_matmul")


def _train_dir():
    d = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


@contextlib.contextmanager
def launcher_recorded(torch, times: dict, batches: list):
    """The train launcher with its checkpoint manager timed (the host copy
    inside ``save_async``, each write on the worker thread, each restore)
    and its loader recorded ((cursor index, tokens) per batch), and its
    standard output captured as ``times["lines"]`` (echoed indented)."""
    import io
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import ShardedLoader
    from repro_torch.launch import train as launch_train

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    class Timed(CheckpointManager):
        def save_async(self, step, state, **kw):
            self.wait()       # the previous write is not this copy's time
            timed("save_async_s",
                  lambda: super(Timed, self).save_async(step, state, **kw))

        def _write(self, step, flat, metadata):
            timed("write_s",
                  lambda: super(Timed, self)._write(step, flat, metadata))

        def restore(self, template, **kw):
            out = timed("restore_s",
                        lambda: super(Timed, self).restore(template, **kw))
            torch.cuda.synchronize()
            return out

    class Recorded(ShardedLoader):
        def __next__(self):
            i = self.cursor.index
            b = super().__next__()
            batches.append((i, b["tokens"].copy()))
            return b

    saved = launch_train.CheckpointManager, launch_train.ShardedLoader
    launch_train.CheckpointManager, launch_train.ShardedLoader = \
        Timed, Recorded
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        launch_train.CheckpointManager, launch_train.ShardedLoader = saved
        times["lines"] = buf.getvalue().splitlines()
        for line in times["lines"]:
            print("  | " + line)


@contextlib.contextmanager
def host_state(torch, out: dict):
    """What the process holds when a host-bound run starts, and what took
    the host during it: live threads, objects Python's collector tracks,
    the caching allocator's reserved bytes; then the collector's passes
    and their seconds, the allocator's retries and cudaMalloc / cudaFree
    calls."""
    import threading
    out.update({"threads": sorted(t.name for t in threading.enumerate()),
                "gc_tracked": len(gc.get_objects()),
                "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30,
                "allocated_gib": torch.cuda.memory_allocated() / 2 ** 30})
    keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
    before = torch.cuda.memory_stats()
    passes, t0 = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            passes.append((info["generation"], time.perf_counter() - t0[0]))

    gc.callbacks.append(on_gc)
    try:
        yield out
    finally:
        gc.callbacks.remove(on_gc)
        after = torch.cuda.memory_stats()
        out.update({k: after.get(k, 0) - before.get(k, 0) for k in keys})
        out["gc_passes"] = [sum(g == n for g, _ in passes) for n in range(3)]
        out["gc_s"] = sum(s for _, s in passes)


def _state_leaves(out: dict) -> list:
    from repro_torch.ckpt.checkpoint import flatten_state
    return [x for _, x in flatten_state((out["params"], out["ostate"]))]


def phase_train_launcher(torch, dev, card: str) -> dict:
    """(a) and (b): see the module docstring, phase 9."""
    import math
    import re

    import numpy as np
    from repro_torch import tree
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import DataCursor, ShardedLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    cfg = get_config("llama3.2-1b")
    n_params = sum(math.prod(s) for s in tree.leaves(M.param_shapes(cfg)))
    ckpt_bytes = 3 * 4 * n_params
    d = _train_dir()
    free = shutil.disk_usage(d).free
    need = 2 * ckpt_bytes + 2 ** 30
    check(free >= need, f"{d}: {free / 1e9:.1f} GB free, the two step "
          f"checkpoints of phase 9 need {need / 1e9:.1f} GB")
    args = TRAIN_ARGS + ["--ckpt-dir", str(d)]
    line = re.compile(r"^step (\d+) loss (\d+\.\d{4}) gnorm (\d+\.\d{3}) "
                      r"\((\d+\.\d)s\)$")
    out = {"params": n_params, "ckpt_gb": ckpt_bytes / 1e9}
    print(f"  llama3.2-1b: {n_params / 1e9:.4f} B params, checkpoints of "
          f"{ckpt_bytes / 1e9:.2f} GB into {d} ({free / 1e9:.1f} GB free); "
          "(a) in torch's default mode, (b) under "
          "torch.use_deterministic_algorithms(True, warn_only=True)")
    try:
        # -- (a) default mode, timed: 20 steps ------------------------------
        times_a, seen_a, host_a = {}, [], {}
        torch.cuda.reset_peak_memory_stats()
        with launcher_recorded(torch, times_a, seen_a), \
                host_state(torch, host_a):
            ra = launch_train.main(TRAIN_ARGS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        lines = times_a["lines"]
        check([int(m.group(1)) for m in map(line.match, lines[:-1]) if m]
              == list(range(TRAIN_STEPS)) and lines[-1].startswith("done: "),
              f"launcher lines {lines}")
        log = ra["log"]
        check(all(math.isfinite(x) for _, l, g, _ in log for x in (l, g))
              and log[-1][1] < log[0][1], f"losses {log}")
        check([i for i, _ in seen_a] == list(range(TRAIN_STEPS)),
              f"(a) read batches {[i for i, _ in seen_a]}")
        dts = [b[3] - a[3] for a, b in zip(log, log[1:])]
        step_s = statistics.median(dts)
        flops = 6 * n_params * TRAIN_TOKENS
        out.update({
            "mode": "default", "step_ms": step_s * 1e3,
            "step_ms_all": [x * 1e3 for x in dts],
            "tok_s": TRAIN_TOKENS / step_s, "peak_gib": peak,
            "model_flops_share": flops / step_s / BF16_OPS_PER_S,
            "loss_first_last": (log[0][1], log[-1][1])})
        print(f"  (a) [{card}] default mode, 20 steps of 8 x 256: median "
              f"fenced step {step_s * 1e3:.1f} ms (steps 1-19: "
              f"{', '.join(f'{x * 1e3:.1f}' for x in dts)}), "
              f"{out['tok_s']:.0f} tok/s; model FLOPs 6 * {n_params:.4g} * "
              f"{TRAIN_TOKENS} = {flops:.4g} a step (remat's second forward "
              f"not counted) over the step: "
              f"{100 * out['model_flops_share']:.2f}% of the "
              f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s dense bf16 peak; peak "
              f"memory {peak:.2f} GiB; loss {log[0][1]:.2f} -> "
              f"{log[-1][1]:.2f}")
        out["host"] = host_a
        print(f"  (a) the host: {len(host_a['threads'])} threads "
              f"{host_a['threads']}, {host_a['gc_tracked']} objects tracked "
              f"by the collector and {host_a['reserved_gib']:.2f} GiB "
              f"reserved ({host_a['allocated_gib']:.2f} allocated) at the "
              f"start; during the run {host_a['gc_passes']} collector "
              f"passes by generation, {host_a['gc_s']:.3f} s, allocator "
              f"retries {host_a['num_alloc_retries']}, cudaMalloc "
              f"{host_a['num_device_alloc']}, cudaFree "
              f"{host_a['num_device_free']}")
        log_a = [(s, l, g) for s, l, g, _ in log]
        del ra
        gc.collect()
        torch.cuda.empty_cache()

        # -- (b) deterministic mode: straight with checkpoints at 15 and 20,
        # then torn at 20 and resumed --------------------------------------
        torch.use_deterministic_algorithms(True, warn_only=True)
        fill = torch.utils.deterministic.fill_uninitialized_memory
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            times_s, seen_s = {}, []
            with launcher_recorded(torch, times_s, seen_s):
                rst = launch_train.main(args)
            log_s = [(s, l, g) for s, l, g, _ in rst["log"]]
            mgr = CheckpointManager(d)
            check(mgr.all_steps() == [RESUME_AT, TRAIN_STEPS],
                  f"steps on disk {mgr.all_steps()}")
            t0 = time.perf_counter()
            (rp, rs), meta = mgr.restore((rst["params"], rst["ostate"]))
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            got = _state_leaves({"params": rp, "ostate": rs})
            check(meta == {"next_step": TRAIN_STEPS} and all(
                x.device == y.device and torch.equal(x, y)
                for x, y in zip(got, _state_leaves(rst), strict=True)),
                "the restored step-20 (params, AdamWState) differ from the "
                "saved state")
            del rp, rs, got
            mgr.close()
            # the first run died after its step-15 checkpoint, during its
            # final one: the step-20 directory never committed
            (d / f"step_{TRAIN_STEPS:08d}").rename(
                d / f"step_{TRAIN_STEPS:08d}.tmp")
            (d / "LATEST").write_text(str(RESUME_AT))
            times_b, seen_b = {}, []
            with launcher_recorded(torch, times_b, seen_b):
                rb = launch_train.main(args)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = fill
        out.update({"save_async_host_copy_s": times_s["save_async_s"][0],
                    "write_s": times_s["write_s"], "restore_s": t_restore})
        print(f"  (b) checkpoints: save_async's host copy of "
              f"{ckpt_bytes / 1e9:.2f} GB "
              f"{times_s['save_async_s'][0]:.2f} s, writes "
              + ", ".join(f"{x:.1f}" for x in times_s["write_s"])
              + f" s (step 15 on the worker thread, step 20 at the end); "
              f"restore of step 20 {t_restore:.1f} s: equal to the saved "
              f"state, every byte")
        lines = times_b["lines"]
        check(lines[0] == f"resumed at step {RESUME_AT}", f"(b) {lines[:2]}")
        fresh = ShardedLoader(cfg, global_batch=8, seq=256)
        for _ in range(RESUME_AT):
            next(fresh)
        want = next(fresh)["tokens"]
        check(seen_b[0][0] == RESUME_AT
              and np.array_equal(seen_b[0][1], want)
              and np.array_equal(seen_b[0][1], next(ShardedLoader(
                  cfg, global_batch=8, seq=256,
                  cursor=DataCursor(index=RESUME_AT)))["tokens"]),
              f"(b) resumed at batch {seen_b[0][0]}, not a fresh loader's "
              f"batch {RESUME_AT}")
        straight = log_s[RESUME_AT:]
        resumed = [(s, l, g) for s, l, g, _ in rb["log"]]
        same = all(torch.equal(x, y) for x, y in zip(
            _state_leaves(rb), _state_leaves(rst), strict=True))
        check(resumed == straight and same,
              f"(b) resumed steps {resumed} vs straight {straight}; final "
              f"state equal: {same}")
        step_b = statistics.median(
            b[3] - a[3] for a, b in zip(rst["log"], rst["log"][1:]))
        out.update({"default_log_equals_deterministic": log_a == log_s,
                    "deterministic_step_ms": step_b * 1e3,
                    "resume_restore_s": times_b["restore_s"][0],
                    "resume_write_s": times_b["write_s"]})
        print(f"  (b) the straight run's 20 (loss, grad_norm) "
              f"{'equal' if log_a == log_s else 'differ from'} (a)'s "
              f"default-mode ones, its median step {step_b * 1e3:.1f} ms "
              f"(deterministic mode, with checkpoints); step 20 made torn, "
              f"LATEST 15; the second "
              f"call resumed at step 15 (restore "
              f"{times_b['restore_s'][0]:.1f} s), read batch 15 == a fresh "
              f"loader's batch 15, and its steps 15-19 (loss, grad_norm) and "
              f"final (params, AdamWState) equal the straight run's bit for "
              f"bit; final write {times_b['write_s'][0]:.1f} s")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del rst
    gc.collect()
    torch.cuda.empty_cache()

    # -- the optimizer update alone, on (b)'s final state ---------------------
    params, state = rb["params"], rb["ostate"]
    del rb
    grads = tree.tree_map(torch.clone, state.mu)
    ocfg = opt.AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS)
    moved = 7 * 4 * n_params      # p, g, m, v read; p, m, v written

    def adamw():
        opt.adamw_update(ocfg, grads, state, params)

    def fused():
        fused_opt.step()

    flat = tree.leaves(params)
    for p, g in zip(flat, tree.leaves(grads)):
        p.grad = g
    fused_opt = torch.optim.AdamW(flat, lr=3e-4, betas=(0.9, 0.95),
                                  eps=1e-8, weight_decay=0.01, fused=True)
    t = {}
    for name, fn in (("adamw_update", adamw), ("fused", fused),
                     ("adamw_update ", adamw), ("fused ", fused)):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(3):
            fn()
        e1.record()
        e1.synchronize()
        t.setdefault(name.strip(), []).append(e0.elapsed_time(e1) / 3)
    out.update({"optimizer_ms": min(t["adamw_update"]),
                "optimizer_bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                "fused_adamw_ms": min(t["fused"])})
    print(f"  optimizer: adamw_update over {n_params / 1e9:.4f} B f32 "
          f"params {out['optimizer_ms']:.2f} ms (runs "
          + ", ".join(f"{x:.2f}" for x in t["adamw_update"])
          + f"); bound {out['optimizer_bound_ms']:.2f} ms ({moved / 1e9:.1f}"
          f" GB: p, g, m, v read once, p, m, v written once); "
          f"torch.optim.AdamW(fused=True), the same update in other "
          f"roundings (weight decay as p *= 1 - lr wd): "
          f"{out['fused_adamw_ms']:.2f} ms")
    del params, state, grads, flat, fused_opt
    gc.collect()
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def sparse_calls_checked(torch, seen: dict):
    """While open, every ``nm_mask24`` call (through ``core/masks.py``) and
    every ``nm_matmul`` call (through ``sparse/apply.py``) is held against
    its plain version on the same inputs: the mask exactly, the product
    within phase 3's tolerance for its output dtype; every call still
    launches and counts.  ``seen`` gets (shape, mismatches) per mask and
    (rows, K, N, max err) per product."""
    from repro_torch.core import masks
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_spmm import nm_matmul_plain
    from repro_torch.sparse import apply
    saved = masks.nm_mask24, apply.nm_matmul

    def mask(s):
        got = saved[0](s)
        mism = int((got != ref.nm_mask_ref(s)).sum())
        seen.setdefault("nm_mask24", []).append((tuple(s.shape), mism))
        check(mism == 0, f"nm_mask24 {tuple(s.shape)} on trained scores "
              f"differs from its plain version in {mism} entries")
        return got

    def matmul(x, vals, idx, **kw):
        got = saved[1](x, vals, idx, **kw)
        want = nm_matmul_plain(x, vals, idx, **kw)
        tol = BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL
        err = float((got.float() - want.float()).abs().max())
        key = (x.shape[0], x.shape[1], vals.shape[-1])
        seen.setdefault("nm_matmul", []).append((*key, err))
        check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
              f"nm_matmul (M, K, N) = {key} {got.dtype} on trained weights: "
              f"max err {err} over rtol=atol={tol}")
        return got

    masks.nm_mask24, apply.nm_matmul = mask, matmul
    try:
        yield seen
    finally:
        masks.nm_mask24, apply.nm_matmul = saved


def system_claims(torch, dev, launches: dict) -> dict:
    """(c): tests/test_system.py's recipe and claims, on the card, from
    ``init_params`` seed 0; the kernels' launches counted per path."""
    import math
    from repro_torch import tree
    from repro_torch.configs.base import ModelConfig, PruneConfig
    from repro_torch.core import calibrate, mirror
    from repro_torch.core import masks as masks_mod
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.nm_spmm import nm_matmul
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    from repro_torch.optim.losses import eval_ppl
    from repro_torch.sparse.apply import sparsify_params
    cfg = ModelConfig(**SYS_CFG)
    params = M.init_params(cfg, 0, device=dev)
    train = batches_for(cfg, n=40, batch=12, seq=96, split="train")
    valid = batches_for(cfg, n=3, batch=12, seq=96, split="valid")
    train = [{"tokens": torch.from_numpy(b["tokens"]).to(dev)}
             for b in train]
    step = make_train_step(cfg, opt.AdamWConfig(lr=2e-3, warmup_steps=20,
                                                total_steps=200),
                           accum=1, remat=False)
    ostate = opt.adamw_init(params)
    t0 = time.perf_counter()
    losses = []
    for i in range(200):
        params, ostate, m = step(params, ostate, train[i % len(train)])
        losses.append(m["loss"])
    losses = [float(x) for x in losses]
    t_train = time.perf_counter() - t0
    ppl = {"dense": eval_ppl(cfg, params, valid)}
    check(ppl["dense"] < 60, f"dense ppl {ppl['dense']}")

    calib = batches_for(cfg, n=8, batch=8, seq=96, split="calib")
    stats = calibrate.collect_stats(cfg, params, calib[:3])
    pcfg = PruneConfig(local_metric="stochria", steps=40)
    seen, sparse_seen = {}, {}
    with counted(launches, "system test: stochria search 0.5/0.6"), \
            search_calls_checked(torch, seen):
        pruned, state, _ = calibrate.unipruning_prune(
            cfg, pcfg, params, calib, sparsities=[0.5, 0.6])
    ppl["UniPruning 0.5"] = eval_ppl(cfg, pruned[0.5], valid)
    ppl["UniPruning 0.6"] = eval_ppl(cfg, pruned[0.6], valid)
    mb = calibrate.baseline_masks("magnitude", params, stats, 0.6)
    ppl["magnitude 0.6"] = eval_ppl(cfg, masks_mod.apply_masks(params, mb),
                                    valid)
    d, p50, p60 = ppl["dense"], ppl["UniPruning 0.5"], ppl["UniPruning 0.6"]
    m60 = mirror.export_masks(pcfg, state.Gamma, 0.6, V=state.V)
    sp60 = masks_mod.sparsity_of(m60)
    check(math.isfinite(p50) and math.isfinite(p60)
          and d <= p50 <= p60 * 1.05 and p60 < 40 * d
          and p60 <= ppl["magnitude 0.6"] * 1.10 and abs(sp60 - 0.6) < 0.01,
          f"the system test's claims: {ppl}, sparsity at 0.6 {sp60}")

    calib = batches_for(cfg, n=6, batch=8, seq=96, split="calib")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=25)
    with counted(launches, "system test: wanda 2:4 search"), \
            search_calls_checked(torch, seen), \
            sparse_calls_checked(torch, sparse_seen):
        pruned, state, _ = calibrate.unipruning_prune(
            cfg, pcfg, params, calib, sparsities=[0.5])
        masks = mirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    sp = masks_mod.sparsity_of(masks)
    ppl["2:4 masked-dense"] = eval_ppl(cfg, pruned[0.5], valid)
    flat_w = dict(tree.flatten_with_path(pruned[0.5]))
    path = next(p for p, x in tree.flatten_with_path(masks)
                if x is not None and x.shape[-2] % 4 == 0)
    w = flat_w[path][0].float()
    vals, idx = kref.compress_24(w)
    g = torch.Generator(device=dev).manual_seed(1)
    x = 0.1 * torch.randn((16, w.shape[0]), generator=g, device=dev)
    with counted(launches, "system test: 2:4 product and eval"), \
            sparse_calls_checked(torch, sparse_seen):
        y = nm_matmul(x, vals, idx)
        comp = sparsify_params(params, masks, axes=M.param_axes(cfg))
        ppl["2:4 compressed"] = eval_ppl(cfg, comp, valid)
    mm_err = float((y - x @ w).abs().max())
    mm_tol = float(2e-4 + 2e-4 * (x @ w).abs().max())
    check(abs(sp - 0.5) < 1e-6 and mm_err <= mm_tol
          and math.isfinite(ppl["2:4 masked-dense"])
          and abs(ppl["2:4 compressed"] / ppl["2:4 masked-dense"] - 1)
          <= 1e-3,
          f"2:4: sparsity {sp}, kernel product err {mm_err} (tol {mm_tol}), "
          f"ppl {ppl}")

    before = [x.clone() for x in tree.leaves(params)]
    calib = batches_for(cfg, n=4, batch=4, seq=64, split="calib")
    with counted(launches, "system test: W0 untouched"), \
            search_calls_checked(torch, seen):
        calibrate.unipruning_prune(cfg, PruneConfig(local_metric="wanda",
                                                    steps=5),
                                   params, calib, sparsities=[0.5])
    check(all(torch.equal(a, b) for a, b in zip(before,
                                                tree.leaves(params))),
          "the search wrote W0")
    mm_calls = sparse_seen.get("nm_matmul", [])
    check(len(sparse_seen.get("nm_mask24", [])) == sum(
              launches[k]["nm_mask24"] for k in launches
              if k.startswith("system test"))
          and len(mm_calls) == launches[
              "system test: 2:4 product and eval"]["nm_matmul"] - 1,
          f"checked calls {[(k, len(v)) for k, v in sparse_seen.items()]} "
          f"vs launches {launches}")
    return {"ppl": ppl, "train_s": t_train, "loss_first_last":
            (losses[0], losses[-1]), "kernel_err": (mm_err, mm_tol),
            "sparsity_60": sp60, "search_signatures_checked": len(seen),
            "nm_mask24_checked": len(sparse_seen["nm_mask24"]),
            "nm_matmul_checked": len(mm_calls),
            "nm_matmul_shapes": sorted({c[:3] for c in mm_calls}),
            "nm_matmul_max_err": max(c[3] for c in mm_calls)}


def moe_tiny_trained(torch, dev) -> dict:
    """(d): benchmarks/common.py's moe-tiny recipe on the card from
    ``init_params`` seed 0; its held-out ppl beside the committed weights'
    (benchmarks/common.py evaluate's batches: 3 of 12 x 128)."""
    import math
    from repro_torch import tree
    from repro_torch.configs.tiny import FAMILIES
    from repro_torch.convert import load_params_pickle
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    from repro_torch.optim.losses import eval_ppl
    cfg = FAMILIES["moe-tiny"]
    steps = 300
    params = M.init_params(cfg, 0, device=dev)
    valid = batches_for(cfg, n=3, batch=12, seq=128, split="valid")
    train = [{"tokens": torch.from_numpy(b["tokens"]).to(dev)} for b in
             batches_for(cfg, n=50, batch=16, seq=128, split="train")]
    out = {"untrained": eval_ppl(cfg, params, valid)}
    step = make_train_step(cfg, opt.AdamWConfig(
        lr=1.5e-3, warmup_steps=steps // 10, total_steps=steps), accum=1,
        remat=False)
    ostate = opt.adamw_init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        params, ostate, m = step(params, ostate, train[i % len(train)])
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["trained"] = eval_ppl(cfg, params, valid)
    # the committed weights on the card and on this host's CPU, in one
    # process, on the same batches (ROADMAP C2 / R16: another numpy draws
    # another corpus, so a card ppl is compared only with this CPU's)
    committed = load_params_pickle(ROOT / "results" / "bench_models"
                                   / "moe-tiny.pkl")
    out["committed"] = eval_ppl(cfg, tree.to_device(committed, dev), valid)
    out["committed_cpu"] = eval_ppl(cfg, committed, valid)
    out["corpus"] = corpus_line(valid)
    rel = abs(out["committed"] - out["committed_cpu"]) / out["committed_cpu"]
    print(f"  (d) moe-tiny's held-out batches: {out['corpus']} (numpy 2.0.2 "
          f"draws sha256 1352cef40c60d54b, sum 1135026); the committed "
          f"weights' eval_ppl card {out['committed']:.4f} vs this host's CPU "
          f"{out['committed_cpu']:.4f} (rel {rel:.2e}, tolerance "
          f"{EVAL_RTOL})")
    check(rel <= EVAL_RTOL, f"moe-tiny eval_ppl card {out['committed']} vs "
          f"CPU {out['committed_cpu']}: {rel:.2e} past {EVAL_RTOL}")
    check(math.isfinite(out["trained"])
          and out["trained"] < out["untrained"],
          f"moe-tiny trained on the card: {out}")
    return out


def phase_train(torch, dev, card: str) -> dict:
    """Phase 9: see the module docstring."""
    out = phase_train_launcher(torch, dev, card)
    launches = {}
    t0 = time.perf_counter()
    out["system"] = system_claims(torch, dev, launches)
    out["system"]["s"] = time.perf_counter() - t0
    ppl = out["system"]["ppl"]
    for k in SYS_KERNELS:
        check(sum(v[k] for v in launches.values()) > 0,
              f"the system test launched no {k}: {launches}")
    out["launches"] = {k: {n: c for n, c in v.items() if c}
                       for k, v in launches.items()}
    print(f"  (c) [{card}] tests/test_system.py's model trained on the card "
          f"(200 steps {out['system']['train_s']:.1f} s, loss "
          f"{out['system']['loss_first_last'][0]:.3f} -> "
          f"{out['system']['loss_first_last'][1]:.3f}); every claim held "
          f"with the test's bounds; ppl "
          + ", ".join(f"{k} {v:.4f}" for k, v in ppl.items())
          + f"; the 2:4 kernel product err {out['system']['kernel_err'][0]:.2e}"
          f" (tol {out['system']['kernel_err'][1]:.2e}); held against their "
          f"plain versions on the trained inputs: "
          f"{out['system']['search_signatures_checked']} search-kernel "
          f"signatures bit for bit, {out['system']['nm_mask24_checked']} "
          f"nm_mask24 masks exactly, {out['system']['nm_matmul_checked']} "
          f"nm_matmul products at (M, K, N) "
          f"{out['system']['nm_matmul_shapes']} (max err "
          f"{out['system']['nm_matmul_max_err']:.2e}); launches "
          f"{out['launches']} ({out['system']['s']:.1f} s)")
    out["moe_tiny"] = moe_tiny_trained(torch, dev)
    r = out["moe_tiny"]
    print(f"  (d) [{card}] moe-tiny, benchmarks/common.py's recipe (lr "
          f"1.5e-3, 300 steps of 16 x 128) on the card in "
          f"{r['train_s']:.1f} s: held-out ppl {r['trained']:.4f} (untrained "
          f"{r['untrained']:.2f}); the committed JAX-trained weights "
          f"{r['committed']:.4f} (this host's CPU {r['committed_cpu']:.4f})")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the gemma and yi families
# ---------------------------------------------------------------------------

# (arch, layers served): each at its published widths, cut in depth only
# (the script's time limit, PERF.md section 4): since phase 14 came in,
# gemma3-1b serves one of its 5:1 local:global patterns (6 of 26 layers;
# whole before), yi-6b 2 of 32 (8 before), gemma2-2b one local:global
# pair (2 of 26; 6 before)
GEMMA_YI = (("gemma3-1b", 6), ("yi-6b", 2), ("gemma2-2b", 2))
GEMMA_TINY_STEPS = 5
EVAL_RTOL = 2e-3            # the CPU tests' eval tolerance (ROADMAP R10)


def corpus_line(batches) -> str:
    """The sha256 prefix and token sum of a list of synthetic batches, and
    the numpy that drew them (``Generator.zipf``'s stream is not kept
    fixed across numpy versions: ROADMAP R16)."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for b in batches:
        h.update(b["tokens"].tobytes())
    return (f"sha256 {h.hexdigest()[:16]}, token sum "
            f"{sum(int(b['tokens'].sum()) for b in batches)}, numpy "
            f"{np.__version__}")


def gemma_tiny_card_vs_cpu(torch, dev, card: str, launches: dict) -> dict:
    """The trained gemma-tiny (``results/bench_models/gemma-tiny.pkl``):
    eval_ppl dense and at 0.5 / 0.6 under the committed
    ``gemma-tiny-unstructured`` bank, on the card and on this host's CPU
    in one process (the bank's masks card == CPU), within EVAL_RTOL; then
    a wanda 2:4 calibration on the card (every search-kernel signature and
    every ``nm_mask24`` mask held against its plain version) and on the
    CPU, Gamma/V within the CPU tests' tolerance and the masks equal but
    for near-ties."""
    from repro_torch import tree
    from repro_torch.configs.tiny import FAMILIES
    from repro_torch.convert import load_params_pickle
    from repro_torch.core import masks as masks_mod
    from repro_torch.data.synthetic import batches_for
    from repro_torch.optim.losses import eval_ppl
    from repro_torch.sparse.bank import MaskBank
    cfg = FAMILIES["gemma-tiny"]
    p_cpu = load_params_pickle(ROOT / "results" / "bench_models"
                               / "gemma-tiny.pkl")
    p_card = tree.to_device(p_cpu, dev)
    valid = batches_for(cfg, n=3, batch=12, seq=128, split="valid")
    bank_dir = ROOT / "results" / "bench_banks" / "gemma-tiny-unstructured"
    banks = {d: MaskBank.load(bank_dir, cfg=cfg, device=d)
             for d in (dev, "cpu")}
    rows = {}
    for s in (None, 0.5, 0.6):
        params = {}
        if s is None:
            params = {"card": p_card, "cpu": p_cpu}
        else:
            mc = banks[dev].masks_at(sparsity=s)
            mh = banks["cpu"].masks_at(sparsity=s)
            for (path, a), (_, b) in zip(tree.flatten_with_path(mc),
                                         tree.flatten_with_path(mh),
                                         strict=True):
                check((a is None) == (b is None)
                      and (a is None or torch.equal(a.cpu(), b)),
                      f"gemma-tiny bank masks at {s} differ between card "
                      f"and CPU at {path}")
            params = {"card": masks_mod.apply_masks(p_card, mc),
                      "cpu": masks_mod.apply_masks(p_cpu, mh)}
        ppl = {k: eval_ppl(cfg, p, valid) for k, p in params.items()}
        rel = abs(ppl["card"] - ppl["cpu"]) / ppl["cpu"]
        check(rel <= EVAL_RTOL, f"gemma-tiny eval_ppl at {s}: card "
              f"{ppl['card']} vs CPU {ppl['cpu']} ({rel:.2e} > {EVAL_RTOL})")
        rows["dense" if s is None else str(s)] = {**ppl, "rel": rel}
    print(f"  gemma-tiny (trained, committed; softcaps, sandwich norms, "
          f"gelu) eval_ppl over evaluate's batches ({corpus_line(valid)}), "
          f"card vs this host's CPU in one process: "
          + "; ".join(f"{k} {r['card']:.4f} vs {r['cpu']:.4f} (rel "
                      f"{r['rel']:.1e})" for k, r in rows.items())
          + f"; tolerance rtol {EVAL_RTOL}")
    # -- a short wanda 2:4 calibration, card vs CPU --------------------------
    calibration = calibration_card_vs_cpu(
        torch, dev, cfg, p_cpu, launches, "calibrate gemma-tiny wanda 2:4",
        batches_for(cfg, n=8, batch=4, seq=64, split="calib"), 4)
    return {"eval": rows, "calibration": calibration}


def calibration_card_vs_cpu(torch, dev, cfg, p_cpu, launches: dict,
                            name: str, calib: list, stats_batches: int,
                            shared_stats: bool = False,
                            mode: str = "nm") -> dict:
    """A GEMMA_TINY_STEPS-step wanda ``calibrate_to_bank`` of ``cfg`` (2:4,
    or unstructured where ``mode`` says so: a config whose projections
    are no multiple of 4 deep, smoke xlstm's ff_down of 85)
    from the CPU params ``p_cpu``, on the card (counted under ``name``;
    every search-kernel signature and every ``nm_mask24`` mask held
    against its plain version) and on this host's CPU: one fused step and
    one prox24 a prunable leaf a step, one nm_mask24 a leaf; Gamma/V
    within the CPU tests' tolerance and the masks equal but for
    near-ties (:func:`banks_agree`).  ``shared_stats`` (a model with MoE
    layers whose random router has near-ties, ROADMAP R12): the card's
    stats are held against the CPU's by each leaf's relative Frobenius
    error (2e-2, tests/test_torch_tape.py's MoE bound), and the card's
    search runs on the CPU's stats, as the CPU tests hold the reference's
    MoE search."""
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig
    from repro_torch.core import calibrate
    from repro_torch.core.prunable import prunable_map
    from repro_torch.launch.calibrate import calibrate_to_bank
    from repro_torch.sparse.bank import MaskBank
    pcfg = PruneConfig(local_metric="wanda", mode=mode,
                       steps=GEMMA_TINY_STEPS, stats_batches=stats_batches)
    nm = mode == "nm"
    bdir = _banks_dir()
    on, seen, checked, stats_err = {}, {}, {}, None
    for d in ("cpu", dev):
        key = "card" if d is dev else "cpu"
        t0 = time.perf_counter()
        ctx = ((counted(launches, name), search_calls_checked(torch, seen),
                sparse_calls_checked(torch, checked)) if d is dev else ())
        params = tree.to_device(p_cpu, d)
        with contextlib.ExitStack() as stack:
            for c in ctx:
                stack.enter_context(c)
            if d is dev and shared_stats:
                own = calibrate.collect_stats(cfg, params, calib, pcfg=pcfg)
                stats_err = max(
                    float((a.cpu() - b).norm() / b.norm())
                    for a, b in zip(tree.leaves(own),
                                    tree.leaves(on["cpu"].stats),
                                    strict=True)
                    if b is not None)
                check(stats_err <= 2e-2, f"{cfg.name} stats card vs CPU: a "
                      f"leaf {stats_err:.2e} apart (relative Frobenius), "
                      "past 2e-2")
                stats = tree.to_device(on["cpu"].stats, d)
                state, _ = calibrate.run_search(
                    cfg, pcfg, params, calib, stats,
                    log_every=GEMMA_TINY_STEPS)
                on[key] = MaskBank.save(bdir / key, arch=cfg.name,
                                        smoke=False, state=state, stats=stats,
                                        pcfg=pcfg, cfg=cfg)
            else:
                on[key] = calibrate_to_bank(
                    bdir / key, cfg=cfg, pcfg=pcfg, params=params,
                    calib=calib, arch=cfg.name, smoke=False,
                    log_every=GEMMA_TINY_STEPS)
            if d is dev and nm:
                on[key].masks_at()
        on[key + "_s"] = time.perf_counter() - t0
    n_leaves = sum(tree.leaves(prunable_map(p_cpu)))
    got = launches[name]
    check(got["saliency_fused_step"] == n_leaves * GEMMA_TINY_STEPS
          and got["prox24"] == n_leaves * GEMMA_TINY_STEPS * nm
          and got["nm_mask24"] == n_leaves * nm,
          f"{cfg.name} calibration launches {got}, want {n_leaves} leaves")
    check(len(checked.get("nm_mask24", ())) == n_leaves * nm,
          f"{cfg.name}: {len(checked.get('nm_mask24', ()))} nm_mask24 "
          f"masks checked, want {n_leaves * nm}")
    worst, ties, n = banks_agree(torch, on["card"], on["cpu"], pcfg)
    print(f"  {cfg.name} {GEMMA_TINY_STEPS}-step wanda "
          f"{'2:4' if nm else 'unstructured (masks at 0.5)'}, card "
          f"{on['card_s']:.1f} s vs CPU {on['cpu_s']:.1f} s"
          + ("" if stats_err is None else
             f" (stats card vs CPU: worst leaf {stats_err:.2e} relative "
             "Frobenius; the card's search on the CPU's stats)")
          + f": launches "
          f"{ {k: v for k, v in got.items() if v} }; search-kernel "
          f"signatures bit for bit {sorted(k[:2] for k in seen)}, "
          f"{len(checked.get('nm_mask24', ()))} nm_mask24 masks exactly; "
          f"Gamma/V worst {worst:.3f} of the tolerance; {ties} of {n} "
          f"{'groups of 4' if nm else 'weights'} differ in the masks, each "
          "a near-tie")
    shutil.rmtree(bdir, ignore_errors=True)
    return {"card_s": on["card_s"], "cpu_s": on["cpu_s"], "worst": worst,
            "near_ties": ties, "groups": n, "stats_err": stats_err}


def phase_gemma_yi(torch, dev, card: str) -> dict:
    """Phase 10: gemma3-1b, yi-6b and gemma2-2b served at their published
    widths through phase 4's path (:func:`phase_serve`), then the trained
    gemma-tiny card against CPU: see the module docstring."""
    from repro_torch.configs.base import get_config
    out, launches = {}, {}
    for arch, layers in GEMMA_YI:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        print(f"  -- {arch}" + (f", {layers} of {get_config(arch).num_layers}"
                                " layers" if layers else ", whole") + " --")
        out[arch] = phase_serve(torch, dev, card, cfg, long_cache=True,
                                verify=arch == "yi-6b")
        out[arch]["s"] = time.perf_counter() - t0
        print(f"  {arch} took {out[arch]['s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    out["gemma-tiny"] = gemma_tiny_card_vs_cpu(torch, dev, card, launches)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 12: deepseek-v2-lite-16b whole
# ---------------------------------------------------------------------------

DEEPSEEK = "deepseek-v2-lite-16b"
# layers served: the published depth is 27 (one mla_dense + 26 mla_moe);
# cut by the script's time to the dense layer + 7 MoE ones when phase 14
# came in, + 3 since phase 15 (PERF.md section 4)
DEEPSEEK_LAYERS = 4
# the profiled graph run's tokens per request: a deepseek decode step is
# ~27 layers x ~200 kernels, so 8 steps would pass the profiler's buffers
DEEPSEEK_PROFILED_TOKENS = 4
SMOKE_STREAMS = ((9, 6), (17, 8), (5, 8), (12, 6))   # (prompt, new tokens)


def _steps_to_cpu(steps: list) -> list:
    """:func:`record_decode` steps with their tensors on the host."""
    return [(rids, toks.cpu(), t.cpu(), lg.cpu(),
             [(p.cpu(), i.cpu()) for p, i in routes])
            for rids, toks, t, lg, routes in steps]


def deepseek_smoke_card_vs_cpu(torch, dev, card: str, launches: dict
                               ) -> dict:
    """The smoke deepseek-v2-lite-16b (seed-0 weights) on the card and on
    this host's CPU: greedy engine streams, the card's eager steps against
    the CPU's row by row (:func:`compare_decode_runs`: logits within
    LOGIT_ULPS_FULL bf16 ulps, differing tokens and experts only at
    near-ties), the card's CUDA-graph engine == its eager one; a
    ``kv_shards`` engine refused; then a short wanda 2:4 calibration card
    vs CPU (:func:`calibration_card_vs_cpu`) over the MLA, shared and
    expert leaves."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine, eager
    cfg = get_smoke_config(DEEPSEEK)
    p_cpu = M.init_params(cfg, 0, device="cpu")
    toks = batches_for(cfg, n=1, batch=len(SMOKE_STREAMS), seq=32,
                       split="valid")[0]["tokens"]
    reqs = [(toks[i, :n], m) for i, (n, m) in enumerate(SMOKE_STREAMS)]
    runs = {}
    for d in (dev, "cpu"):
        eng = ServeEngine(cfg, p_cpu, slots=2, capacity=64, device=d)
        routes = []
        steps = record_decode(eng, routes)
        rids = [eng.submit(p, m) for p, m in reqs]
        with recording_routes(routes), eager():
            out = eng.run()
        del eng.fns.decode
        runs[d] = ([out[r] for r in rids], _steps_to_cpu(steps), eng)
    n_rows, worst, ties, rerouted = compare_decode_runs(
        torch, runs["cpu"][1], runs[dev][1], coupled=True)
    same = sum(a == b for a, b in zip(runs[dev][0], runs["cpu"][0]))
    check(same == len(reqs) or ties or rerouted,
          f"smoke {DEEPSEEK}: card streams {runs[dev][0]} differ from the "
          f"CPU's {runs['cpu'][0]} with no near-tie")
    eng = runs[dev][2]
    rids = [eng.submit(p, m) for p, m in reqs]
    out = eng.run()
    check([out[r] for r in rids] == runs[dev][0]
          and eng.fns.capture_counts() == {"decode": 1},
          f"smoke {DEEPSEEK}: the card's graph engine streams differ from "
          "its eager ones")
    try:
        ServeEngine(cfg, p_cpu, slots=2, capacity=64, device=dev,
                    kv_shards=1)
        fail(f"{DEEPSEEK}: an engine with kv_shards=1 was built")
    except ValueError as e:
        check("MLA" in str(e), f"kv_shards refusal names no MLA: {e}")
    print(f"  smoke {DEEPSEEK} card vs this host's CPU: {same} of "
          f"{len(reqs)} greedy streams equal, {n_rows} decode rows "
          f"compared, logits worst {worst:.3f} of the tolerance, token "
          f"near-ties {ties}, routing near-ties {rerouted}; the card's "
          "graph engine == its eager one; kv_shards=1 refused (MLA)")
    calibration = calibration_card_vs_cpu(
        torch, dev, cfg, p_cpu, launches, f"calibrate {DEEPSEEK} smoke "
        "wanda 2:4", batches_for(cfg, n=2, batch=4, seq=32, split="calib"),
        2, shared_stats=True)
    del runs, eng
    return {"streams_equal": same, "streams": len(reqs), "rows": n_rows,
            "worst": worst, "near_ties": len(ties) + len(rerouted),
            "calibration": calibration}


def phase_deepseek(torch, dev, card: str) -> dict:
    """Phase 12: deepseek-v2-lite-16b at its published widths, cut to
    DEEPSEEK_LAYERS of its 27 layers, through phase 4's path, its weights
    made a layer slice at a time (:func:`weights_by_layer`), compressed
    against masked-dense with the routing pinned (:func:`compare_pinned`),
    verify against sequential decode; then the smoke config card vs
    CPU."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config(DEEPSEEK),
                              num_layers=DEEPSEEK_LAYERS)
    launches = {}
    t0 = time.perf_counter()
    out = phase_serve(torch, dev, card, cfg, long_cache=True, verify=True,
                      weights=weights_by_layer, by_layer=True,
                      profiled_tokens=DEEPSEEK_PROFILED_TOKENS)
    out["s"] = time.perf_counter() - t0
    print(f"  {DEEPSEEK} ({DEEPSEEK_LAYERS} of 27 layers) took "
          f"{out['s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke"] = deepseek_smoke_card_vs_cpu(torch, dev, card, launches)
    out["smoke_launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 11: the committed bank, card against CPU
# ---------------------------------------------------------------------------

def phase_bank(torch, dev) -> None:
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine, eager
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
        with eager():               # counted: the wrappers see every call
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


# ---------------------------------------------------------------------------
# Phase 13: the flight recorder (obs) and the recompile sentinel's surfaces
# ---------------------------------------------------------------------------

OBS_DIR = ROOT / "build" / "chip_smoke_obs"
# recorder off / on runs, in turns: a run's decode steps vary by +-8% and
# its eager prefills by a third between runs on the card's shared host
# (H100 runs of this phase), so the bound is held on a median of pairs:
# 20 (10 until a run whose ratios spread 0.89-1.04 put the median of 10
# at 3.88%: PERF.md section 6)
OBS_PAIRS = 20
OBS_OVERHEAD = 0.03       # benchmarks/bench_obs.py's claim: <= 3% decode
OBS_KV = (1, 4)
OBS_SERVE_ARGS = ["--arch", "llama3.2-1b", "--gen", "8"]
OBS_CAL_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
                "--scan-chunk", "2"]
OBS_SERIES = ("loss", "align", "mask_churn", "gamma_entropy", "sparsity")
# tests/test_torch_calibrate.py's tolerance for the history of two whole
# calibrations that each compute their own stats
OBS_RTOL, OBS_ATOL = 2e-3, 1e-6


def _timed_run(torch, eng, prompts, m: int = MAX_TOKENS) -> tuple:
    """The requests through ``eng.run()``: (wall seconds, tokens, decode
    steps)."""
    for p in prompts:
        eng.submit(p, m)
    steps = eng.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, sum(len(v) for v in out.values()),
            eng.decode_steps - steps)


def _decode_hist(obs, labels: str = "") -> dict:
    return obs.summary()["histograms"].get(f"serve.decode_step_ms{labels}",
                                           {"count": 0, "sum": 0.0})


def obs_overhead(torch, obs, eng, prompts) -> dict:
    """The graph engine serving phase 4's requests with the recorder off
    and on, in turns (the order reversed every other pair) after a
    warm-up in each mode, the garbage collector run before each timed run
    and held off during it (both modes alike).  Each run's decode tok/s is
    its tokens (every one comes from a decode step) over the wall time of
    its ``_step`` calls, which hold the decode path's recorder calls; the
    gate is the median of the paired on/off decode ratios.  The serving
    tok/s (the whole run, the eager prefills included: their host time
    varies by a third between runs on the H100) and the time the
    prefill spans' fences wait are reported beside it.  Each on-run's
    ``serve.decode_step_ms`` count equals its decode steps; the captures
    are unchanged by the recorder."""
    from repro_torch.obs import core
    acc = {"step": 0.0, "fence": 0.0}
    step, fence = eng._step, core.block_until_ready

    def timed_step():
        t0 = time.perf_counter()
        out = step()
        acc["step"] += time.perf_counter() - t0
        return out

    def timed_fence(tree):
        t0 = time.perf_counter()
        fence(tree)
        acc["fence"] += time.perf_counter() - t0

    obs.reset()
    _timed_run(torch, eng, prompts)                 # captures the graph
    obs.configure()
    _timed_run(torch, eng, prompts)
    obs.disable()
    captures = eng.fns.capture_counts()
    ratios, serve_ratios, fence_ms = [], [], []
    tok_s = {"off": [], "on": []}
    eng._step, core.block_until_ready = timed_step, timed_fence
    try:
        for i in range(OBS_PAIRS):
            pair = {}
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                if mode == "on":
                    obs.configure()
                before = _decode_hist(obs)["count"]
                acc["step"] = acc["fence"] = 0.0
                gc.collect()
                gc.disable()
                try:
                    dt, toks, steps = _timed_run(torch, eng, prompts)
                finally:
                    gc.enable()
                if mode == "on":
                    seen = _decode_hist(obs)["count"] - before
                    check(seen == steps, f"serve.decode_step_ms: {seen} "
                          f"observations for {steps} decode steps")
                    obs.disable()
                    fence_ms.append(acc["fence"] * 1e3)
                pair[mode] = (toks / acc["step"], toks / dt)
                tok_s[mode].append(toks / acc["step"])
            ratios.append(pair["on"][0] / pair["off"][0])
            serve_ratios.append(pair["on"][1] / pair["off"][1])
    finally:
        del eng._step
        core.block_until_ready = fence
    check(eng.fns.capture_counts() == captures,
          f"the recorder's runs captured {eng.fns.capture_counts()}, "
          f"before {captures}")
    return {"overhead": 1 - statistics.median(ratios), "ratios": ratios,
            "serve_overhead": 1 - statistics.median(serve_ratios),
            "serve_ratios": serve_ratios, "fence_ms": fence_ms,
            "decode_tok_s": tok_s, "captures": captures}


def obs_launches_and_clock(torch, obs, eng, prompts) -> dict:
    """The profiler's kernel launches of the same requests off and on
    (identical: the recorder launches nothing and captures nothing; a pair
    of windows that differ is profiled again, at most ``PROFILE_TRIES``
    times, since late in the script the tracer can lose a window's first
    records: 1117 of the 1120 2:4 launches in every window of one full
    run on the H100, off and on alike); then
    4 one-token requests of 8 tokens (no prefill forward: the run's device
    work is its decode steps and slot writes) with the recorder on: the
    sum of their ``serve.decode_step_ms`` lies between the profiler's
    device time and the run's wall time."""
    # 112 2:4 launches a forward: 2 eager prefills + 8 replayed steps
    want = 7 * eng.cfg.num_layers * (2 + PROFILED_TOKENS)
    for tries in range(1, PROFILE_TRIES + 1):
        out = {}
        for mode in ("off", "on"):
            obs.reset()
            if mode == "on":
                obs.configure()
            launches = profiled_launches(torch, lambda: _timed_run(
                torch, eng, prompts[:2], PROFILED_TOKENS))
            launches.pop("warm-up")
            out[mode] = launches
        if out["on"] == out["off"]:
            break           # else a window lost records: profile again
    check(out["on"] == out["off"], f"launches with the recorder on "
          f"{out['on']}, off {out['off']}")
    obs.reset()
    obs.configure()
    one = [p[:1] for p in prompts[:4]]
    box = {}
    with profiler_window(torch) as prof:
        box["r"] = _timed_run(torch, eng, one, PROFILED_TOKENS)
    wall, _, steps = box["r"]
    evs = [e for e in device_events(prof) if e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    h = _decode_hist(obs)
    check(h["count"] == steps, f"serve.decode_step_ms: {h['count']} "
          f"observations for {steps} decode steps")
    check(dev_ms <= h["sum"] <= wall * 1e3,
          f"decode_step_ms sum {h['sum']:.3f} ms not between the device "
          f"time {dev_ms:.3f} ms and the wall time {wall * 1e3:.3f} ms")
    obs.reset()
    return {"launches": out["on"], "nm_spmm_launched": want,
            "windows": tries, "steps": steps, "hist_ms": h["sum"],
            "device_ms": dev_ms, "wall_ms": wall * 1e3}


def obs_kv_paths(torch, obs, cfg, sparse, prompts, dev) -> dict:
    """Fresh graph engines at ``kv_shards`` 1 and 4 with the recorder on:
    ``dist.psum{site=attn_kv}`` is the reference's trace-time count, 2 at
    each scanned call site of the traced decode surface (llama: one
    (stage, pattern position)) at kv_shards >= 2 and none at 1, and a
    second run adds nothing; one decode-step observation a step."""
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    sites = sum(len(p) for p, _ in M.make_stages(cfg))
    out = {}
    for S in OBS_KV:
        obs.reset()
        obs.configure()
        eng = ServeEngine(cfg, sparse, slots=4, capacity=256, device=dev,
                          kv_shards=S)
        counts = []
        for _ in range(2):
            _, _, steps = _timed_run(torch, eng, prompts)
            counts.append(obs.counter_value("dist.psum", site="attn_kv"))
        want = 2 * sites if S >= 2 else 0
        check(counts == [want, want], f"kv_shards={S}: dist.psum"
              f"{{site=attn_kv}} {counts} over two runs, want {want} (2 a "
              "scanned call site of the one decode trace)")
        check(_decode_hist(obs)["count"] == eng.decode_steps,
              f"kv_shards={S}: decode_step_ms count")
        check(eng.fns.capture_counts() == {"decode": 1},
              f"kv_shards={S}: captures {eng.fns.capture_counts()}")
        out[S] = {"psum": counts[-1], "psum_bytes": obs.counter_value(
            "dist.psum_bytes", site="attn_kv"), "sites": sites}
        del eng
        obs.reset()
    return out


def obs_launcher(torch, obs) -> dict:
    """``launch.serve.main`` at full width from phase 6's bank with
    ``--trace-dir`` and ``--xprof-dir``: events.jsonl holds the
    ``launch.prefill`` timer and one ``serve.decode_step`` span a step,
    metrics.prom the decode-step count, and the Chrome trace names the
    2:4 kernel (``nm_mma_kernel``, nm_matmul's)."""
    from repro_torch.launch import serve as launch_serve
    D, X = OBS_DIR / "trace", OBS_DIR / "xprof"
    obs.reset()
    t0 = time.perf_counter()
    launch_serve.main(OBS_SERVE_ARGS + ["--sparse-artifact", str(BANK_DIR),
                                        "--trace-dir", str(D),
                                        "--xprof-dir", str(X)])
    dt = time.perf_counter() - t0
    obs.reset()
    events = list(obs.read_jsonl(D / "events.jsonl"))
    steps = int(OBS_SERVE_ARGS[OBS_SERVE_ARGS.index("--gen") + 1]) - 1
    prefill = [e for e in events if e.get("name") == "launch.prefill"]
    decode = [e for e in events if e.get("name") == "serve.decode_step"]
    prom = (D / "metrics.prom").read_text()
    trace = (X / "trace.json").read_text()
    check(len(prefill) == 1 and len(decode) == steps,
          f"launcher events: {len(prefill)} launch.prefill, {len(decode)} "
          f"serve.decode_step (want 1, {steps})")
    check(f"serve_decode_step_ms_count {steps}" in prom,
          "metrics.prom lacks the decode-step count")
    check("nm_mma_kernel" in trace, "the profiler trace names no "
          "nm_mma_kernel launch")
    return {"s": dt, "events": len(events), "trace_mb": len(trace) / 1e6,
            "decode_step_ms": [e["dur_ms"] for e in decode]}


def obs_calibrate_card_vs_cpu(torch, obs, dev) -> dict:
    """``launch.calibrate.main`` on the smoke config, 4 steps in chunks of
    2, with ``--trace-dir``, on the card and on this host's CPU in one
    process, on the same weights (the CPU's seed-0 draw: the launcher's
    ``init_params`` would draw from each device's own generator): 2
    ``calibrate.search_chunk`` logs a device, series of 2, card == CPU
    within tests/test_torch_calibrate.py's history tolerance."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import calibrate as launch_cal
    from repro_torch.models import model as M
    params = M.init_params(get_smoke_config("llama3.2-1b"), 0, device="cpu")
    init = M.init_params
    M.init_params = lambda cfg, seed=0, device=None: tree.to_device(
        params, device)
    chunks = {}
    try:
        for name, d in (("card", dev), ("cpu", "cpu")):
            obs.reset()
            launch_cal.main(OBS_CAL_ARGS + [
                "--device", str(d), "--out", str(OBS_DIR / f"bank_{name}"),
                "--trace-dir", str(OBS_DIR / f"cal_{name}")])
            chunks[name] = [e for e in obs.read_jsonl(
                OBS_DIR / f"cal_{name}" / "events.jsonl")
                if e.get("event") == "calibrate.search_chunk"]
    finally:
        M.init_params = init
        obs.reset()
    worst = 0.0
    for name, cs in chunks.items():
        check([(c["start"], c["steps"]) for c in cs] == [(0, 2), (2, 2)]
              and all(len(c[k]) == 2 for c in cs for k in OBS_SERIES),
              f"{name}: search chunks {[(c['start'], c['steps']) for c in cs]}")
    for a, b in zip(chunks["card"], chunks["cpu"]):
        for k in OBS_SERIES:
            for x, y in zip(a[k], b[k]):
                tol = OBS_ATOL + OBS_RTOL * abs(y)
                worst = max(worst, abs(x - y) / tol)
                check(abs(x - y) <= tol, f"chunk {a['start']} {k}: card "
                      f"{x} vs CPU {y} (tolerance {tol})")
    return {"worst": worst, "card": chunks["card"], "cpu": chunks["cpu"]}


def obs_fleet(torch, obs, bank, params0, prompts, dev) -> dict:
    """Phase 6's bank as a 0.0 / 0.5 / 2:4 fleet on the graph engines with
    the recorder on: phase 4's prompts pinned round-robin; every budget
    reports ``decode_ms_p50 <= decode_ms_p95``."""
    from repro_torch.serve.fleet import SparsityFleet
    obs.reset()
    obs.configure()
    fleet = SparsityFleet(bank, params0, FLEET_BUDGETS, slots=6,
                          capacity=256, device=dev)
    for i, p in enumerate(prompts):
        fleet.submit(p, MAX_TOKENS, budget=FLEET_BUDGETS[i % 3])
    fleet.run()
    rep = fleet.report()["budgets"]
    out = {}
    for name, r in rep.items():
        p50, p95 = r["decode_ms_p50"], r["decode_ms_p95"]
        check(p50 is not None and p95 is not None and 0 < p50 <= p95,
              f"fleet budget {name}: decode_ms p50 {p50}, p95 {p95}")
        out[name] = {"p50": p50, "p95": p95, "tok_s": r["tok_s"]}
    obs.reset()
    return out


def phase_obs(torch, dev, card: str) -> dict:
    """The flight recorder on the card (module docstring, phase 13)."""
    from repro_torch import obs
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.sparse.bank import MaskBank
    cfg = get_config("llama3.2-1b")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    OBS_DIR.mkdir(parents=True)
    t0 = time.perf_counter()
    bank = MaskBank.load(BANK_DIR, device=dev)
    params0 = M.init_params(cfg, 0, device=dev)      # phase 6's weights
    sparse = bank.sparse_params(params0)
    t_load = time.perf_counter() - t0
    prompts = serving_prompts(cfg)
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, sparse, slots=4, capacity=256, device=dev)
    over = obs_overhead(torch, obs, eng, prompts)
    dec = over["decode_tok_s"]
    print(f"  [{card}] {cfg.name} 2:4 (phase 6's bank, loaded with the "
          f"weights in {t_load:.1f} s), 4 slots, capacity 256, phase 4's "
          f"6 requests x {MAX_TOKENS} on the CUDA-graph engine, "
          f"{OBS_PAIRS} pairs recorder off / on: decode tok/s (tokens over "
          f"the decode steps' wall time) off {min(dec['off']):.1f}-"
          f"{max(dec['off']):.1f}, on {min(dec['on']):.1f}-"
          f"{max(dec['on']):.1f}, median on/off "
          f"{statistics.median(over['ratios']):.4f}: overhead "
          f"{100 * over['overhead']:.2f}% (limit {100 * OBS_OVERHEAD:.0f}%); "
          f"serving tok/s (the eager prefills included) overhead "
          f"{100 * over['serve_overhead']:.2f}% (ratios "
          f"{min(over['serve_ratios']):.3f}-{max(over['serve_ratios']):.3f}); "
          f"the prefill spans' fences waited "
          f"{statistics.median(over['fence_ms']):.2f} ms a run; captures "
          f"{over['captures']} unchanged")
    check(over["overhead"] <= OBS_OVERHEAD,
          f"the recorder costs {100 * over['overhead']:.2f}% of the decode "
          f"tok/s (ratios {over['ratios']})")
    clock = obs_launches_and_clock(torch, obs, eng, prompts)
    print(f"  [{card}] profiled launches off == on: {clock['launches']} "
          f"(window {clock['windows']} of at most {PROFILE_TRIES}; "
          f"{clock['nm_spmm_launched']} nm_spmm launched: a shortfall is "
          f"records the tracer lost, alike off and on); "
          f"{clock['steps']} decode steps of one-token requests: "
          f"decode_step_ms sum {clock['hist_ms']:.3f} ms between the "
          f"device time {clock['device_ms']:.3f} ms and the wall time "
          f"{clock['wall_ms']:.3f} ms")
    del eng
    kv = obs_kv_paths(torch, obs, cfg, sparse, prompts, dev)
    print(f"  [{card}] dist.psum{{site=attn_kv}} by kv_shards: "
          + ", ".join(f"{S}: {r['psum']:g} ({r['psum_bytes']:g} bytes; "
                      f"{r['sites']} scanned call site)"
                      for S, r in kv.items()))
    del sparse
    gc.collect()
    torch.cuda.empty_cache()
    fleet = obs_fleet(torch, obs, bank, params0, prompts, dev)
    print(f"  [{card}] fleet {FLEET_BUDGETS} from phase 6's bank, decode "
          "ms p50 / p95: " + ", ".join(
              f"{n} {r['p50']:.3f} / {r['p95']:.3f}"
              for n, r in fleet.items()))
    del bank, params0
    gc.collect()
    torch.cuda.empty_cache()
    launcher = obs_launcher(torch, obs)
    print(f"  [{card}] launch.serve --trace-dir --xprof-dir from the bank: "
          f"{launcher['events']} events, decode steps "
          f"{min(launcher['decode_step_ms']):.2f}-"
          f"{max(launcher['decode_step_ms']):.2f} ms, Chrome trace "
          f"{launcher['trace_mb']:.1f} MB naming nm_mma_kernel, "
          f"{launcher['s']:.1f} s")
    cal = obs_calibrate_card_vs_cpu(torch, obs, dev)
    print(f"  [{card}] launch.calibrate --trace-dir, smoke, 4 steps in "
          f"chunks of 2: card vs CPU series within "
          f"{cal['worst']:.3f} of the tolerance (rtol {OBS_RTOL}, atol "
          f"{OBS_ATOL}); card loss {cal['card'][0]['loss']} ...")
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return {**{k: v for k, v in over.items() if k != "captures"},
            "clock": clock, "kv": kv,
            "fleet": fleet, "launcher": {k: v for k, v in launcher.items()
                                         if k != "decode_step_ms"},
            "calibrate_worst": cal["worst"]}



# ---------------------------------------------------------------------------
# Phase 14: the recurrent families, zamba2-7b and xlstm-125m
# ---------------------------------------------------------------------------

ZAMBA, XLSTM = "zamba2-7b", "xlstm-125m"
# zamba2-7b's depth served: 5 mamba + 1 mamba_shared + 3 mamba, both of
# its stages (81 whole, PR 24); cut by the script's 1200 s limit when
# phase 15 came
ZAMBA_LAYERS = 9
# a whole zamba2-7b decode step is ~7200 kernels (81 layers of the Mamba2
# mixer's small ops) and its eager prefill more: 2 profiled tokens a
# request keep the window inside the profiler's buffers and its processing
# near 20 s a path (4 tokens: ~30 s)
RECURRENT_PROFILED_TOKENS = 2
# the capacity-8192 step: the replicated path and flash_decode
RECURRENT_LONG_PATHS = (None, 1)
# zamba2's kv_shards paths against None are held layer by layer on the
# same input (phase_serve kv_by_layer): its attention layers keep f32
# probabilities in the kernels where the replicated path rounds them to
# bf16 (the reference's rounding), and its recurrent states carry each
# difference to every later position, so end to end the runs part by
# more than 8 ulps at the logits (up to 34 on the H100 over the whole 81
# layers: PERF.md section 6); those figures are printed
# smoke streams (prompt tokens, new tokens): a one-token prompt admits
# through the blank row (a reused slot's state reset)
RECURRENT_SMOKE_STREAMS = ((9, 6), (17, 8), (1, 8), (12, 6), (5, 6))


def recurrent_smoke_card_vs_cpu(torch, dev, card: str, arch: str,
                                launches: dict, mode: str) -> dict:
    """A smoke config (seed-0 weights) on the card and on this host's
    CPU: greedy engine streams on 2 slots (5 requests, so slots are reused
    and one is admitted with a one-token prompt from the blank state),
    the card's eager steps against the CPU's row by row
    (:func:`compare_decode_runs`), the card's CUDA-graph engine == its
    eager one; xlstm's ``kv_shards`` engine refused (no attention); then a
    short wanda calibration card vs CPU (:func:`calibration_card_vs_cpu`,
    ``mode``: xlstm's smoke ff_down of 85 takes no 2:4)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine, eager
    cfg = get_smoke_config(arch)
    p_cpu = M.init_params(cfg, 0, device="cpu")
    toks = batches_for(cfg, n=1, batch=len(RECURRENT_SMOKE_STREAMS), seq=32,
                       split="valid")[0]["tokens"]
    reqs = [(toks[i, :n], m) for i, (n, m) in
            enumerate(RECURRENT_SMOKE_STREAMS)]
    runs = {}
    for d in (dev, "cpu"):
        eng = ServeEngine(cfg, p_cpu, slots=2, capacity=64, device=d)
        steps = record_decode(eng, [])
        rids = [eng.submit(p, m) for p, m in reqs]
        with eager():
            out = eng.run()
        del eng.fns.decode
        runs[d] = ([out[r] for r in rids], _steps_to_cpu(steps), eng)
    n_rows, worst, ties, _ = compare_decode_runs(
        torch, runs["cpu"][1], runs[dev][1], coupled=False)
    same = sum(a == b for a, b in zip(runs[dev][0], runs["cpu"][0]))
    check(same + len(ties) >= len(reqs),
          f"smoke {arch}: card streams {runs[dev][0]} differ from the "
          f"CPU's {runs['cpu'][0]} past the near-ties {ties}")
    eng = runs[dev][2]
    rids = [eng.submit(p, m) for p, m in reqs]
    out = eng.run()
    check([out[r] for r in rids] == runs[dev][0]
          and eng.fns.capture_counts() == {"decode": 1},
          f"smoke {arch}: the card's graph engine streams differ from its "
          "eager ones")
    refused = None
    if not M.cache_lengths(cfg, 64):
        try:
            ServeEngine(cfg, p_cpu, slots=2, capacity=64, device=dev,
                        kv_shards=1)
            fail(f"{arch}: an engine with kv_shards=1 was built")
        except ValueError as e:
            check("no attention" in str(e), f"kv_shards refusal: {e}")
            refused = "kv_shards=1 refused (no attention)"
    print(f"  smoke {arch} card vs this host's CPU: {same} of {len(reqs)} "
          f"greedy streams equal, {n_rows} decode rows compared, logits "
          f"worst {worst:.3f} of the tolerance, token near-ties {ties}; the "
          f"card's graph engine == its eager one"
          + (f"; {refused}" if refused else ""))
    # the card's stats against the CPU's by each leaf's relative Frobenius
    # error, its search on the CPU's stats: bf16 flips in the matmuls,
    # carried by the recurrent states, move later layers' stats by up to
    # 1.5% elementwise (tests/test_torch_zamba.py, ROADMAP R19)
    calibration = calibration_card_vs_cpu(
        torch, dev, cfg, p_cpu, launches, f"calibrate {arch} smoke wanda "
        + ("2:4" if mode == "nm" else "unstructured"),
        batches_for(cfg, n=2, batch=4, seq=32, split="calib"), 2,
        shared_stats=True, mode=mode)
    del runs, eng
    return {"streams_equal": same, "streams": len(reqs), "rows": n_rows,
            "worst": worst, "near_ties": len(ties),
            "calibration": calibration}


def phase_recurrent(torch, dev, card: str) -> dict:
    """Phase 14: zamba2-7b (ZAMBA_LAYERS of its 81 layers at its
    published widths) and xlstm-125m whole through phase 4's path
    (:func:`phase_serve`), both compressed against masked-dense layer by
    layer; then each smoke config card vs CPU with a short calibration."""
    from repro_torch.configs.base import get_config
    launches, out = {}, {}
    zamba = dataclasses.replace(get_config(ZAMBA), num_layers=ZAMBA_LAYERS)
    print(f"  {ZAMBA} cut to {ZAMBA_LAYERS} of its 81 layers (both stages): "
          "the script's 1200 s limit since phase 15")
    for cfg, kw in ((zamba, dict(long_cache=True, weights=weights_by_layer,
                                 long_paths=RECURRENT_LONG_PATHS,
                                 kv_by_layer=True)),
                    (get_config(XLSTM), dict(weights=weights_whole))):
        arch = cfg.name
        t0 = time.perf_counter()
        out[arch] = phase_serve(torch, dev, card, cfg, by_layer=True,
                                profiled_tokens=RECURRENT_PROFILED_TOKENS,
                                **kw)
        out[arch]["s"] = time.perf_counter() - t0
        print(f"  {arch} ({cfg.num_layers} layers) took "
              f"{out[arch]['s']:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    for arch, mode in ((ZAMBA, "nm"), (XLSTM, "unstructured")):
        out[arch]["smoke"] = recurrent_smoke_card_vs_cpu(
            torch, dev, card, arch, launches, mode)
    out["smoke_launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 15: whisper-small's encoder-decoder and pixtral-12b's vision prefix
# ---------------------------------------------------------------------------

WHISPER, PIXTRAL = "whisper-small", "pixtral-12b"
# whisper's 30-second window is 1500 frames, but the reference's
# flash_attention tiles a sequence only by a block that divides it
# (attention.py:214: 512 at these lengths), so 1536 is the nearest
# encoder length it takes above 1500
WHISPER_FRAMES = 1536
# 4 rows of 32-token decoder prompts, 32 new tokens: the prefill's and
# 31 decode steps, at a capacity of P + gen = 64 (4 shards divide it and
# the 1536 cross slots; 65 would not split in 4)
WHISPER_PROMPT, WHISPER_GEN = 32, 32
# pixtral: 4 rows of the 256-patch prefix + 64 text tokens, 17 new tokens
# (16 decode steps), capacity 64 + 17 + 256 = 337
PIXTRAL_TEXT, PIXTRAL_GEN = 64, 17
PIXTRAL_LAUNCHER_KV = (None, 1)
# pixtral's decoder depth served: 8 of 40 by the script's time since the
# tensor-parallel phase came (whole, 40 layers, phase 15's pixtral took
# 110.4 s of a 1208.4 s script on an H100 80GB HBM3, 700 W)
PIXTRAL_LAYERS = 8
LAUNCHER_BY_LAYER_STEPS = 4
# smoke streams card vs CPU: the launcher's (B 2, 16 prompt tokens)
ENCDEC_SMOKE_GEN = 8


def launcher_batch(cfg, rows: int, prompt: int, enc_len: int = 0) -> dict:
    """The launcher's numpy batch: ``rows`` prompts of ``prompt`` tokens of
    the validation split, with whisper's ``enc_len`` frame embeddings or
    pixtral's ``num_image_tokens`` patch embeddings (``_stub_embeds``)."""
    from repro_torch.data.synthetic import batches_for
    if cfg.is_encoder_decoder:
        b = batches_for(cfg, n=1, batch=rows, seq=enc_len, split="valid")[0]
        return {"tokens": b["tokens"][:, :prompt], "frames": b["frames"]}
    return batches_for(cfg, n=1, batch=rows, seq=prompt, split="valid")[0]


@contextlib.contextmanager
def recording_launcher(steps: list):
    """While open, each ``models.model.prefill`` and ``decode_step`` call
    appends (fed tokens or None, logits) to ``steps``: what
    ``launch.serve.generate`` computed, step by step."""
    from repro_torch.models import model as M
    prefill, decode = M.prefill, M.decode_step

    def rec_prefill(*a, **kw):
        logits, caches = prefill(*a, **kw)
        steps.append((None, logits.clone()))
        return logits, caches

    def rec_decode(cfg, params, token, caches, t, **kw):
        logits, caches = decode(cfg, params, token, caches, t, **kw)
        steps.append((token.clone(), logits.clone()))
        return logits, caches

    M.prefill, M.decode_step = rec_prefill, rec_decode
    try:
        yield steps
    finally:
        M.prefill, M.decode_step = prefill, decode


def compare_launcher_runs(torch, ref: list, got: list, hold: bool):
    """Two recorded launcher runs (:func:`recording_launcher`) of the same
    batch, row by row while the row's fed tokens agree: logits within
    LOGIT_ULPS_FULL bf16 ulps of the reference row's largest (held unless
    ``hold`` is off: printed only), and where the greedy tokens differ,
    the reference's margin between them at most twice the logit
    difference (a near-tie; the row is compared no further).  Returns
    (rows compared, worst logit error over its tolerance, near-ties)."""
    B = ref[0][1].shape[0]
    n, worst, ties = 0, 0.0, []
    for r in range(B):
        for i, ((_, la), (fb, lb)) in enumerate(zip(ref, got, strict=True)):
            if i and int(fb[r]) != int(ref[i][0][r]):
                break
            err, tol = logit_err(torch, lb[r], la[r], LOGIT_ULPS_FULL)
            check(err <= tol or not hold, f"row {r}, step {i}: logits "
                  f"differ by {err} over {tol} ({LOGIT_ULPS_FULL} bf16 ulps "
                  "of the row's max)")
            n += 1
            worst = max(worst, err / tol)
            a, b = int(la[r].argmax()), int(lb[r].argmax())
            if a != b:
                margin = float(la[r, a] - la[r, b])
                check(margin <= 2 * err or not hold, f"row {r}, step {i}: "
                      f"tokens {a} vs {b} with margin {margin} past twice "
                      f"the logit difference {err}")
                ties.append((r, i, a, b, margin, err))
                break
    return n, worst, ties


def launcher_counts(cfg) -> dict:
    """``nm_matmul`` launches of one launcher prefill and of one decode
    step of ``cfg``'s compressed model (:func:`path_launches`, whisper's
    encoder and cross projections included), and the decode attention
    layers a step (whisper's self ring and cross cache: 2 a layer)."""
    c = path_launches(cfg)
    return {"prefill": c["prefill"]["nm_matmul"],
            "decode": c["decode"]["nm_matmul"],
            "attn": attn_layers(cfg) * (2 if cfg.is_encoder_decoder else 1)}


def graph_decode_loop(torch, M, cfg, params, batch: dict, gen: int,
                      kv_shards, want) -> dict:
    """The launcher's decode loop on a CUDA graph: the prefill eager
    (``models.model.prefill`` at the launcher's capacity), then one decode
    step captured (static token and position buffers, the greedy argmax
    inside) and replayed ``gen - 1`` times; its tokens must equal the
    eager launcher's ``want`` (B, gen).  Returns the replays' wall ms a
    step and tok/s."""
    dev = params["embed"]["table"].device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    B, P = batch["tokens"].shape
    off = cfg.num_image_tokens if "patches" in batch else 0
    with torch.inference_mode():
        logits, caches = M.prefill(cfg, params, batch,
                                   cache_capacity=P + gen + off)
        tok = logits.argmax(-1)
        tok_buf = tok.clone()
        t_buf = torch.full((B,), P + off, dtype=torch.int32, device=dev)

        def step():
            return M.decode_step(cfg, params, tok_buf, caches, t_buf,
                                 kv_shards=kv_shards)[0].argmax(-1)
        # the warm-up writes the first step's ring slot with the first
        # step's own values: the replay writes them again
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        toks = [tok.cpu()]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(gen - 1):
            t_buf.fill_(P + off + i)
            graph.replay()
            tok_buf.copy_(out)
            toks.append(out.cpu())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        del graph
    got = torch.stack(toks, dim=1)
    check(torch.equal(got, want), f"{cfg.name} kv_shards={kv_shards}: the "
          "decode loop replayed from a CUDA graph gives other tokens than "
          "the eager launcher")
    return {"graph_loop_ms": dt * 1e3 / (gen - 1),
            "graph_tok_s": B * (gen - 1) / dt}


def launcher_by_layer(torch, M, cfg, params, masked, batch: dict,
                      capacity: int, kv_paths=(),
                      steps: int = LAUNCHER_BY_LAYER_STEPS) -> dict:
    """Compressed (``params``) against masked-dense (``masked``) on the
    launcher's path, layer by layer on the compressed run's input:
    whisper's encoder layers, then the prefill of every decoder layer
    (outputs and the caches it writes: rings and cross K/V), then
    ``steps`` decode passes fed the compressed run's greedy tokens, where
    each decoder layer's masked-dense twin runs on a copy of the
    compressed layer's cache rows, and at each ``kv_paths`` S the
    compressed layer again (its decode attention through the kernels),
    each held within LOGIT_ULPS_FULL bf16 ulps of each row's largest
    value (outputs, rings, cross caches).  Returns the worst of each."""
    from repro_torch import tree
    from repro_torch.models import blocks as blk
    from repro_torch.models import common as cm
    dev = params["embed"]["table"].device
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    worst = torch.zeros((), device=dev)
    worst_kv = torch.zeros((), device=dev)

    def held(a_tree, b_tree, acc):
        for a, b in zip(tree.leaves(a_tree), tree.leaves(b_tree),
                        strict=True):
            acc = torch.maximum(acc, _rows_ulps(a, b).max())
        return acc

    with torch.inference_mode():
        enc = None
        if cfg.is_encoder_decoder:
            xc = cm.dense(params["frame_proj"],
                          M._features(params, batch["frames"]))
            B, Se, _ = xc.shape
            xc = xc + torch.from_numpy(cm.sinusoidal_positions(
                Se, cfg.d_model)).to(dev, xc.dtype)
            ectx = blk.Ctx(positions=torch.arange(Se, device=dev).expand(
                B, Se))
            for (pattern, repeats), sc, sm in zip(
                    M.encoder_stages(cfg), params["enc_stages"],
                    masked["enc_stages"], strict=True):
                for i in range(repeats):
                    yc = M._layer_apply(cfg, pattern, M._layer(sc, i), xc,
                                        ectx)[0]
                    ym = M._layer_apply(cfg, pattern, M._layer(sm, i), xc,
                                        ectx)[0]
                    worst = torch.maximum(worst, _rows_ulps(ym, yc).max())
                    xc = yc
            enc = blk._norm(cfg, params["enc_norm"], xc)
        x = M._embed_inputs(cfg, params, batch)
        B, S, _ = x.shape
        if cfg.is_encoder_decoder:
            x = x + params["pos_embed"][:S].to(x.dtype)[None]
        layers = [(kind, s, i, str(q))
                  for s, (pattern, repeats) in enumerate(M.make_stages(cfg))
                  for i in range(repeats) for q, kind in enumerate(pattern)]
        caches = M.init_caches(cfg, B, capacity, device=dev,
                               enc_len=0 if enc is None else enc.shape[1])
        ctx = blk.Ctx(positions=torch.arange(S, device=dev).expand(B, S),
                      cache_capacity=capacity, encoder_out=enc)
        tok = None
        for j in range(steps + 1):
            if j:
                t = torch.full((B,), S + j - 1, dtype=torch.int32,
                               device=dev)
                x = M._embed(cfg, params, tok[:, None])
                if cfg.is_encoder_decoder:
                    x = x + params["pos_embed"][t.long()][:, None].to(
                        x.dtype)
            for kind, s, i, q in layers:
                pc, pm = (M._layer(tr["stages"][s], i)[q]
                          for tr in (params, masked))
                cc = M._layer(caches[s], i)[q]
                if j == 0:
                    yc, _, rc = blk.block_apply_full(kind, cfg, pc, x, ctx)
                    ym, _, rm = blk.block_apply_full(kind, cfg, pm, x, ctx)
                    tree.tree_map(lambda a, b: a.copy_(b), cc, rc)
                else:
                    rm = tree.tree_map(torch.clone, cc)
                    by_kv = {S_: tree.tree_map(torch.clone, cc)
                             for S_ in kv_paths}
                    yc, _ = blk.block_apply_decode(kind, cfg, pc, x, cc, t)
                    rc = cc
                    for S_, rk in by_kv.items():
                        yk, _ = blk.block_apply_decode(kind, cfg, pc, x, rk,
                                                       t, kv_shards=S_)
                        worst_kv = torch.maximum(worst_kv,
                                                 _rows_ulps(yk, yc).max())
                        worst_kv = held(rk, rc, worst_kv)
                    ym, _ = blk.block_apply_decode(kind, cfg, pm, x, rm, t)
                worst = torch.maximum(worst, _rows_ulps(ym, yc).max())
                worst = held(rm, rc, worst)
                x = yc.to(torch.bfloat16)
            logits = M._unembed(cfg, params, blk._norm(
                cfg, params["final_norm"], x[:, -1:]))[:, 0]
            tok = logits.argmax(-1)
    worst, worst_kv = float(worst), float(worst_kv)
    check(worst <= LOGIT_ULPS_FULL, f"{cfg.name} compressed vs masked-dense "
          f"layer by layer on the same input: {worst:.2f} bf16 ulps of a "
          f"row's max (outputs and caches), past {LOGIT_ULPS_FULL}")
    check(worst_kv <= LOGIT_ULPS_FULL, f"{cfg.name} kv_shards {kv_paths} vs "
          f"None layer by layer on the same input: {worst_kv:.2f} bf16 "
          f"ulps, past {LOGIT_ULPS_FULL}")
    return {"worst_layer_ulps": worst, "worst_kv_layer_ulps": worst_kv,
            "blocks": len(layers), "encoder_layers": cfg.encoder_layers,
            "passes": steps + 1}


def launcher_path(torch, dev, cfg, w: dict, batch: dict, gen: int,
                  kv_list, name: str) -> dict:
    """``cfg``'s compressed weights (``w``: :func:`weights_whole` /
    :func:`weights_by_layer`) through the serve launcher's loop
    (``launch.serve.generate``) at each ``kv_shards`` of ``kv_list``
    (None first), each counted on its own (one ``nm_matmul`` per
    compressed projection a forward, one decode attention kernel (or
    partial + combine) per attention a decode step, nothing else; the
    None path also the 2:4 export's ``nm_mask24`` launches that made
    ``w``, one a mask),
    every distinct kernel call held against its plain version, its
    logits and streams against None's (printed; held layer by layer by
    :func:`launcher_by_layer`); the decode loop replayed from a CUDA
    graph == eager, its steps timed; one eager decode step and one
    graph replay of it per path timed in turns; then compressed vs
    masked-dense layer by layer, and end to end (printed)."""
    from repro_torch import tree
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.nm_prox import nm_mask24
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.sparse.apply import compressed_report
    counted = {"nm_matmul": nm_matmul, "nm_matmul_expert": nm_matmul_expert,
               "nm_mask24": nm_mask24,
               **{k: getattr(fd, k) for k in FLASH_KERNELS}}
    # the 2:4 export's launches since the caller zeroed the counter before
    # making ``w``: the None path's
    export = nm_mask24.launches
    check(export == w["masks_made"], f"{name}: nm_mask24 launched {export} "
          f"times making the weights, want {w['masks_made']}")
    params = M.serving_params(w["sparse"])
    rep = compressed_report(params, w["masks"]) if w["masks"] else None
    want_n = launcher_counts(cfg)
    B, P = batch["tokens"].shape
    off = cfg.num_image_tokens if "patches" in batch else 0
    capacity = P + gen + off
    runs, out = {}, {}
    for S in (None,) + tuple(kv_list):
        calls, steps = {}, []
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        with first_call_per_signature(calls), recording_launcher(steps):
            toks, t_pre, t_dec = generate(cfg, params, batch, gen,
                                          kv_shards=S)
        launches = {k: fn.launches for k, fn in counted.items()}
        if S is None:
            launches["nm_mask24"] += export
        attn = want_n["attn"] * (gen - 1) if S is not None else 0
        want = {"nm_matmul": want_n["prefill"] + want_n["decode"] * (gen - 1),
                "nm_matmul_expert": 0,
                "nm_mask24": export if S is None else 0,
                "flash_decode": attn if S == 1 else 0,
                "flash_decode_partial": attn if S not in (None, 1) else 0,
                "combine_partials": attn if S not in (None, 1) else 0}
        check(launches == want, f"{name} kv_shards={S}: launches "
              f"{launches}, want {want}")
        print(f"  {name} kv_shards={S}: launcher prefill {B}x{P}"
              + (f" + {off} image tokens" if off else "")
              + (f" over {batch['frames'].shape[1]} frames"
                 if "frames" in batch else "")
              + f" {t_pre * 1e3:.1f} ms, {gen - 1} eager decode steps "
              f"{t_dec * 1e3 / (gen - 1):.2f} ms a step; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        print("  " + check_path_calls(torch, calls))
        check(bool(torch.isfinite(steps[-1][1]).all()), f"{name} "
              f"kv_shards={S}: non-finite logits")
        check(tuple(toks.shape) == (B, gen), f"{name}: tokens "
              f"{tuple(toks.shape)}")
        runs[S] = (toks, steps)
        out[S] = {"launches": launches, "prefill_ms": t_pre * 1e3,
                  "eager_step_ms": t_dec * 1e3 / (gen - 1)}
        if S is not None:
            n_rows, worst, ties = compare_launcher_runs(
                torch, runs[None][1], steps, hold=False)
            same = int((toks == runs[None][0]).all(dim=1).sum())
            check(same + len(ties) >= B, f"{name} kv_shards={S}: streams "
                  f"of {B - same} rows differ past the near-ties {ties}")
            out[S].update(rows=n_rows, end_to_end_ulps=worst *
                          LOGIT_ULPS_FULL, streams_equal=same)
            print(f"  {name} kv_shards={S} vs None end to end: {same} of "
                  f"{B} streams equal, {n_rows} rows with the same history, "
                  f"logits worst {worst * LOGIT_ULPS_FULL:.2f} bf16 ulps of "
                  f"the row's max (printed; held layer by layer below); "
                  f"near-ties {ties}")
        out[S].update(graph_decode_loop(torch, M, cfg, params, batch, gen, S,
                                        toks))
    # one decode step per path, eager vs replayed, timed in turns
    with torch.inference_mode():
        dbatch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        step_fns = {}
        for S in out:
            _, caches = M.prefill(cfg, params, dbatch,
                                  cache_capacity=capacity)
            tok = runs[S][0][:, 0].to(dev)
            t_dev = torch.full((B,), P + off, dtype=torch.int32,
                               device=dev)
            step_fns[S] = (lambda c=caches, S=S, tok=tok, t=t_dev:
                           M.decode_step(cfg, params, tok, c, t,
                                         kv_shards=S)[0])
            check(replay_matches_eager(torch, step_fns[S]), f"{name} "
                  f"kv_shards={S}: the step replayed from a CUDA graph "
                  "differs from the eager step")
            if not cfg.is_encoder_decoder or S == 4:
                continue
            # where one eager step's device time goes, by kernel (pixtral's
            # engine run profiles its step: phase_serve; kv_shards=4's
            # step is kv_shards=1's but for the shards)
            with profiler_window(torch) as prof:
                step_fns[S]()
            evs = [e for e in device_events(prof)
                   if e.self_device_time_total > 0]
            out[S].update(
                kernels=sum(e.count for e in evs),
                device_ms=sum(e.self_device_time_total for e in evs) / 1e3,
                top=[(e.self_device_time_total, e.count, e.key[:90])
                     for e in sorted(evs, key=lambda e:
                                     -e.self_device_time_total)[:6]])
        timed = paired_graph_ms(torch, step_fns)
    for S, (med, lo, hi) in timed.items():
        out[S].update(graph_ms=med, graph_min_ms=lo, graph_max_ms=hi)
        print(f"  {name} kv_shards={S}: decode step from a CUDA graph "
              f"{med:.3f} ms (median of 10 rounds in turns, {lo:.3f}-"
              f"{hi:.3f}); the launcher's loop on its graph "
              f"{out[S]['graph_loop_ms']:.3f} ms a step = "
              f"{out[S]['graph_tok_s']:.1f} tok/s, streams == eager"
              + ("" if "top" not in out[S] else
                 f"; profiler, one eager step: {out[S]['kernels']:.0f} "
                 f"kernels, {out[S]['device_ms']:.3f} ms of device time; "
                 "top (us, launches):"))
        for us, count, key in out[S].get("top", ()):
            print(f"    {us:10.1f}  {count:5.0f}  {key}")
    del step_fns
    # compressed vs masked-dense: layer by layer (held), end to end
    # (printed)
    masked = w["masked"]()
    by_layer = launcher_by_layer(torch, M, cfg, params, masked, batch,
                                 capacity, tuple(kv_list))
    steps = []
    with recording_launcher(steps):
        mtoks = generate(cfg, masked, batch, gen)[0]
    n_rows, worst, ties = compare_launcher_runs(torch, runs[None][1], steps,
                                                hold=False)
    same = int((mtoks == runs[None][0]).all(dim=1).sum())
    check(same + len(ties) >= B, f"{name} compressed vs masked-dense: "
          f"streams of {B - same} rows differ past the near-ties {ties}")
    del masked
    print(f"  {name} compressed vs masked-dense, layer by layer on the same "
          f"input ({by_layer['encoder_layers']} encoder layers, "
          f"{by_layer['blocks']} decoder blocks, prefill + "
          f"{by_layer['passes'] - 1} decode passes): worst "
          f"{by_layer['worst_layer_ulps']:.3f} bf16 ulps of a row's max "
          f"(bound {LOGIT_ULPS_FULL}); kv_shards {tuple(kv_list)} vs None "
          f"layer by layer {by_layer['worst_kv_layer_ulps']:.3f}; end to "
          f"end: {same} of {B} streams equal, logits worst "
          f"{worst * LOGIT_ULPS_FULL:.2f} ulps over {n_rows} rows "
          f"(printed), near-ties {ties}")
    if rep is not None:
        check(rep["fallback_leaves"] == 0 and rep["ratio"] == 0.5625,
              f"{name} compression: {rep['fallback_leaves']} fallbacks, "
              f"ratio {rep['ratio']}")
    return {"paths": out, "by_layer": by_layer,
            "end_to_end_masked_ulps": worst * LOGIT_ULPS_FULL,
            "compressed_gb": None if rep is None
            else rep["bytes_compressed"] / 1e9}


def encdec_smoke_card_vs_cpu(torch, dev, launches: dict) -> dict:
    """The smoke whisper and pixtral (seed-0 weights, 2:4 magnitude) card
    vs this host's CPU: the launcher's greedy streams (2 rows, 16 prompt
    tokens, pixtral's 8 image tokens, whisper's 16 frames) at every
    ``kv_shards`` each takes, each path on both devices (the CPU runs the
    kernels' plain versions), the card's logits within
    LOGIT_ULPS_FULL ulps (:func:`compare_launcher_runs`); pixtral's engine
    streams (text only); whisper's engine refused; then a short whisper
    wanda 2:4 calibration card vs CPU."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sparse.apply import sparsify_params
    out = {}
    for arch, kv_list in ((WHISPER, (None, 1, 4)), (PIXTRAL, (None, 1))):
        cfg = get_smoke_config(arch)
        p_cpu = M.init_params(cfg, 0, device="cpu")
        masks = baseline_masks("magnitude", p_cpu, tree.tree_map(
            lambda _: None, p_cpu), 0.5, mode="nm")
        sp = M.serving_params(sparsify_params(
            p_cpu, masks, axes=M.param_axes(cfg), idx_bits=2,
            dtype=torch.bfloat16))
        sp_card = tree.to_device(sp, dev)
        batch = batches_for(cfg, n=1, batch=2, seq=16, split="valid")[0]
        equal, worst, n_rows = 0, 0.0, 0
        for S in kv_list:           # each path on both devices
            ref, steps = [], []
            with recording_launcher(ref):
                want = generate(cfg, sp, batch, ENCDEC_SMOKE_GEN,
                                kv_shards=S)[0]
            with recording_launcher(steps):
                got = generate(cfg, sp_card, batch, ENCDEC_SMOKE_GEN,
                               kv_shards=S)[0]
            rows, w_, ties = compare_launcher_runs(
                torch, ref, [(None if f is None else f.cpu(), lg.cpu())
                             for f, lg in steps], hold=True)
            n_rows += rows
            worst = max(worst, w_)
            check(torch.equal(got, want) or ties, f"smoke {arch} "
                  f"kv_shards={S}: card streams {got.tolist()} vs CPU "
                  f"{want.tolist()}")
            equal += int(torch.equal(got, want))
        engine = None
        if cfg.is_encoder_decoder:
            try:
                ServeEngine(cfg, sp_card, slots=2, capacity=32, device=dev)
                fail(f"{arch}: an engine was built")
            except ValueError as e:
                check("decoder-only" in str(e), f"engine refusal: {e}")
                engine = "refused (decoder-only, as the reference's)"
        else:
            prompts = [batch["tokens"][0, :9], batch["tokens"][1, :14],
                       batch["tokens"][0, 3:8]]
            res = []
            for d, p in (("cpu", sp), (dev, sp_card)):
                eng = ServeEngine(cfg, p, slots=2, capacity=32, device=d)
                rids = [eng.submit(q, 6) for q in prompts]
                o = eng.run()
                res.append([o[r] for r in rids])
            check(res[0] == res[1], f"smoke {arch} engine streams card "
                  f"{res[1]} vs CPU {res[0]}")
            engine = f"engine streams (text only) {len(prompts)} of " \
                     f"{len(prompts)} equal"
        print(f"  smoke {arch} card vs this host's CPU: launcher streams "
              f"equal at {equal} of {len(kv_list)} kv_shards paths "
              f"{kv_list}; {n_rows} rows with the same history, logits worst "
              f"{worst:.3f} of the tolerance; {engine}")
        out[arch] = {"paths_equal": equal, "paths": len(kv_list),
                     "worst": worst, "rows": n_rows}
    cfg = get_smoke_config(WHISPER)
    p_cpu = M.init_params(cfg, 0, device="cpu")
    out["calibration"] = calibration_card_vs_cpu(
        torch, dev, cfg, p_cpu, launches, f"calibrate {WHISPER} smoke wanda "
        "2:4", batches_for(cfg, n=2, batch=4, seq=32, split="calib"), 2,
        shared_stats=True)
    return out


def phase_encdec_vision(torch, dev, card: str) -> dict:
    """Phase 15: whisper-small whole (12 encoder + 12 decoder layers over
    1536 stub frames) and pixtral-12b at its published widths
    (``PIXTRAL_LAYERS`` of 40) 2:4, through the serve launcher's loop at
    every ``kv_shards`` (:func:`launcher_path`); pixtral's engine path
    (text only, phase 4's traffic: :func:`phase_serve`); then both smoke
    configs card vs CPU and a short whisper calibration."""
    from repro_torch.configs.base import get_config
    out, launches = {}, {}
    t0 = time.perf_counter()
    from repro_torch.kernels.nm_prox import nm_mask24
    cfg = get_config(WHISPER)
    torch.cuda.reset_peak_memory_stats()
    nm_mask24.launches = 0
    w = weights_whole(torch, dev, cfg)
    print(f"  {WHISPER}: {cfg.encoder_layers} encoder + {cfg.num_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.num_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"layernorm, gelu, no rope: {w['n_params']} params, made, masked "
          f"({w['masks_made']} nm_mask24 launches) and packed in "
          f"{w['export_s']:.2f} s; {WHISPER_FRAMES} frames (the reference's "
          f"flash_attention takes no 1500: attention.py:214)")
    batch = launcher_batch(cfg, 4, WHISPER_PROMPT, WHISPER_FRAMES)
    out[WHISPER] = launcher_path(torch, dev, cfg, w, batch, WHISPER_GEN,
                                 KV_SHARDS, WHISPER)
    out[WHISPER]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del w
    out[WHISPER]["s"] = time.perf_counter() - t0
    print(f"  {WHISPER} whole took {out[WHISPER]['s']:.1f} s, peak "
          f"{out[WHISPER]['peak_gib']:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    full = get_config(PIXTRAL)
    cfg = dataclasses.replace(full, num_layers=PIXTRAL_LAYERS)
    if PIXTRAL_LAYERS < full.num_layers:
        print(f"  {PIXTRAL} cut to {PIXTRAL_LAYERS} of its "
              f"{full.num_layers} layers: the script's 1200 s limit")
    torch.cuda.reset_peak_memory_stats()
    nm_mask24.launches = 0
    w = weights_by_layer(torch, dev, cfg)
    print(f"  {PIXTRAL}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, rope theta "
          f"{cfg.rope_theta:g}, vit_dim {cfg.vit_dim}, "
          f"{cfg.num_image_tokens} image tokens: {w['n_params']} params, "
          f"made, masked and packed a layer slice at a time in "
          f"{w['export_s']:.1f} s of export")
    batch = launcher_batch(cfg, 4, PIXTRAL_TEXT)
    out[PIXTRAL] = launcher_path(torch, dev, cfg, w, batch, PIXTRAL_GEN,
                                 PIXTRAL_LAUNCHER_KV[1:], PIXTRAL)
    out[PIXTRAL]["launcher_s"] = time.perf_counter() - t0
    del w
    gc.collect()
    torch.cuda.empty_cache()
    # the engine, text only (the reference's engine takes no patches),
    # phase 4's traffic at kv_shards None, 1, 4, on weights made again
    out[PIXTRAL]["engine"] = phase_serve(
        torch, dev, card, cfg, weights=weights_by_layer, by_layer=True,
        kv_by_layer=True)
    out[PIXTRAL]["s"] = time.perf_counter() - t0
    print(f"  {PIXTRAL} ({cfg.num_layers} layers) took "
          f"{out[PIXTRAL]['s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    out["smoke"] = encdec_smoke_card_vs_cpu(torch, dev, launches)
    out["smoke_launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 16: the train step on the families phase 9 does not train
# ---------------------------------------------------------------------------

# (arch, layers trained): the published widths, cut in depth only (None:
# whole); whisper's 12 + 12 layers whole over the train cell's split
TRAIN_FAMILIES = (("gemma3-1b", 6), (DEEPSEEK, 2), (ZAMBA, 6),
                  (XLSTM, None), (WHISPER, None))
TRAIN_FAMILY_STEPS, TRAIN_FAMILY_ROWS, TRAIN_FAMILY_TOKENS = 2, 2, 256
# tests/test_torch_train_families.py's tolerances (ROADMAP R14): loss,
# grad_norm, params against the other's, of the other's update, moments
R14_DENSE = dict(loss=2e-3, grad_norm=1e-2, params=2e-4, update=0.12,
                 moments=2e-2)
R14_MOE = dict(loss=1e-2, grad_norm=3e-2, params=2e-4, update=0.25,
               moments=0.2)
# zamba2's random-weight smoke model: the reference's own eager step is
# 0.206 of the update from its jitted one (tests/torch_port_evidence.py
# spread), so R14's dense 0.12 does not hold for the reference itself
R14_ZAMBA = dict(R14_DENSE, update=0.25)
# the CPU tests' (accumulation, remat) of each family's smoke step
TRAIN_SMOKE = {"gemma3-1b": (2, False), DEEPSEEK: (2, True),
               ZAMBA: (1, True), XLSTM: (1, False), WHISPER: (2, True)}


def _rel_norm(a: list, b: list, base: list | None = None) -> float:
    """||a - b|| / ||b - base|| over paired lists of CPU leaves (base 0)."""
    num = den = 0.0
    for x, y, z in zip(a, b, base or [None] * len(b), strict=True):
        y = y.double()
        num += float(((x.double() - y) ** 2).sum())
        den += float(((y if z is None else y - z.double()) ** 2).sum())
    return math.sqrt(num / den)


def train_family_card(torch, dev, card: str, arch: str, layers) -> dict:
    """Two steps of one family at its published widths on the card."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    # whisper: the encoder takes half a train cell's tokens as frames
    seq = TRAIN_FAMILY_TOKENS // 2 if cfg.is_encoder_decoder \
        else TRAIN_FAMILY_TOKENS
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in batches_for(cfg, n=TRAIN_FAMILY_STEPS,
                                    batch=TRAIN_FAMILY_ROWS, seq=seq,
                                    split="train")]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=dev)
    ostate = opt.adamw_init(params)
    n_params = sum(x.numel() for x in tree.leaves(params))
    step = make_train_step(cfg, opt.AdamWConfig(
        lr=3e-4, total_steps=TRAIN_FAMILY_STEPS, warmup_steps=1), remat=True)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    losses, norms, ms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        params, ostate, m = step(params, ostate, b)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    bad = [path for path, x in tree.flatten_with_path(params)
           if not bool(torch.isfinite(x).all())]
    check(all(map(math.isfinite, losses + norms)) and not bad,
          f"{arch} training on the card: losses {losses}, grad norms "
          f"{norms}, non-finite leaves {bad[:5]}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  [{card}] {arch} ({cfg.num_layers} layers"
          + (f" + {cfg.encoder_layers} encoder layers"
             if cfg.is_encoder_decoder else "")
          + f", {n_params / 1e9:.3f} B params): {TRAIN_FAMILY_STEPS} steps "
          f"of {TRAIN_FAMILY_ROWS} x "
          + (f"({seq} frames + {seq} tokens)" if cfg.is_encoder_decoder
             else f"{seq} tokens") + ", "
          f"losses {', '.join(f'{x:.4f}' for x in losses)} (second "
          f"{losses[-1]:.4f}), grad norms "
          f"{', '.join(f'{x:.3f}' for x in norms)}; step ms "
          f"{', '.join(f'{x:.1f}' for x in ms)} (fenced; the first with "
          f"the allocator's growth); peak {peak:.2f} GiB; weights made in "
          f"{init_s:.1f} s")
    del params, ostate, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "params_b": n_params / 1e9,
            "losses": losses, "grad_norms": norms, "step_ms": ms,
            "peak_gib": peak, "init_s": init_s}


def train_smoke_card_vs_cpu(torch, dev, arch: str) -> dict:
    """One step of the smoke config (4 x 32 tokens, the CPU tests'
    accumulation and remat) on the card and on this host's CPU, from the
    same params and batch: R14's tolerances."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    cfg = get_smoke_config(arch)
    accum, remat = TRAIN_SMOKE[arch]
    tol = {DEEPSEEK: R14_MOE, ZAMBA: R14_ZAMBA}.get(arch, R14_DENSE)
    p0 = M.init_params(cfg, 0, device="cpu")
    b = batches_for(cfg, n=1, batch=4, seq=32, split="train")[0]
    step = make_train_step(cfg, opt.AdamWConfig(lr=3e-4, total_steps=1,
                                                warmup_steps=1),
                           accum=accum, remat=remat)
    out = {}
    for d in ("cpu", dev):
        params = tree.tree_map(torch.clone, tree.to_device(p0, d))
        ostate = opt.adamw_init(params)
        params, ostate, m = step(params, ostate, b)
        out["card" if d is dev else "cpu"] = (
            float(m["loss"]), float(m["grad_norm"]),
            tree.leaves(tree.to_device(params, "cpu")),
            tree.leaves(tree.to_device(ostate.mu, "cpu"))
            + tree.leaves(tree.to_device(ostate.nu, "cpu")))
    (lc, gc_, pc, mc), (lh, gh, ph, mh) = out["card"], out["cpu"]
    got = {"loss": abs(lc - lh) / abs(lh), "grad_norm": abs(gc_ - gh) / gh,
           "params": _rel_norm(pc, ph),
           "update": _rel_norm(pc, ph, tree.leaves(p0)),
           "moments": _rel_norm(mc, mh)}
    print(f"  {arch} smoke (accum {accum}, remat {remat}): card vs this "
          f"host's CPU " + ", ".join(f"{k} {v:.2e} (tol {tol[k]:g})"
                                     for k, v in got.items()))
    for k, v in got.items():
        check(v <= tol[k], f"{arch} smoke train step, card vs CPU: {k} "
              f"{v:.3e} past {tol[k]}")
    return got


def phase_train_families(torch, dev, card: str) -> dict:
    """Phase 16: see the module docstring."""
    out = {arch: train_family_card(torch, dev, card, arch, layers)
           for arch, layers in TRAIN_FAMILIES}
    out["smoke"] = {arch: train_smoke_card_vs_cpu(torch, dev, arch)
                    for arch, _ in TRAIN_FAMILIES}
    return out


ANALYSIS_SLOTS, ANALYSIS_CAPACITY = 4, 256     # phase 4's engine
ANALYSIS_KV = (None, 1)
PEAK_RTOL = 0.10     # the reference's planner bound (tests/test_memplan.py)
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT = 300    # s: the dry run waits this long after (a)-(e)


def smem_calls() -> list:
    """One synthetic call of every kernel instantiation the wrappers
    launch (``analysis.audit.KernelCall``): the 2:4 kernels at each row
    tile (bf16 mma.sp, f32 SIMT), decode attention at every (D, G, dtype)
    whole and partial, the combine, the group-of-4 and saliency kernels at
    every dtype (and metric, with and without the divisor)."""
    from repro_torch.analysis.audit import KernelCall
    from repro_torch.kernels.flash_decode import GROUPS, HEAD_DIMS
    import torch

    def call(name, shapes, dtypes, positional=(), kwargs=None, tk=()):
        return KernelCall(name, 0, [list(x) for x in shapes], list(dtypes),
                          list(positional), kwargs or {}, list(tk), True)
    out = []
    for M in (1, 2, 4, 8, 16, 32, 40, 64):
        for dt in ("bfloat16", "float32"):
            out.append(call("nm_matmul", [(M, 256), (128, 64), (32, 64)],
                            [dt, dt, "uint8"]))
    for D in HEAD_DIMS:
        for G in GROUPS:
            for dt in ("bfloat16", "float32"):
                for name in ("flash_decode", "flash_decode_partial"):
                    out.append(call(name, [(4, 8, G, D), (4, 256, 8, D)],
                                    [dt, dt]))
    for dt in (torch.bfloat16, torch.float32):
        out.append(call("combine_partials", [(4, 4, 8, 4, 64)], ["float32"],
                        positional=[dt]))
    for dt in ("float32", "bfloat16", "float16"):
        out.append(call("nm_mask24", [(64, 64)], [dt]))
        out.append(call("prox24", [(64, 64)], [dt]))
        for metric in ("wanda", "magnitude", "ria"):
            for tk in ((), ("s_div",)):
                out.append(call("saliency_fused_step", [(64, 64)], [dt],
                                kwargs={"metric": metric}, tk=tk))
    return out


def analysis_capture(torch, fns, eng, dev) -> tuple:
    """The engine's CUDA-graph decode step (``serve.engine._Graph``: an
    eager warm-up, then the capture) recorded by the op auditor on the
    card, then one replay under the profiler: (the audit of warm-up +
    capture, the replay's launches)."""
    import numpy as np
    from repro_torch.analysis import audit
    from repro_torch.kernels import observe
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E

    def body(p, x, c, t):
        return fns.decode(p, x, c, t)[0].argmax(-1).to(torch.int32)
    inp = np.zeros((ANALYSIS_SLOTS,), np.int32)
    rec = audit.OpRecorder("decode graph", device="cuda")
    with observe.observing(rec), rec:
        g = E._Graph(body, eng.params, eng.caches, inp, inp, dev,
                     torch.cuda.graph_pool_handle(),
                     state=M.state_leaves(eng.cfg, eng.caches))
    rec.finish((eng.params, eng.caches), g.out)
    for _ in range(PROFILE_TRIES):
        launches = profiled_launches(torch, lambda: g.run(inp, inp))
        if launches.pop("warm-up") == PROFILER_WARMUP:   # no record lost
            break
    return rec.rep, launches


def start_dryrun(torch, dev):
    """Phase 17's (f): ``launch.dryrun`` of llama3.2-1b's four cells, a
    meta pass on this host's CPU, started as a subprocess before phase 15
    so that it runs beside the card's work (its prefill cell plans for
    ~36 s); :func:`stop_dryrun` ends it if the script fails first."""
    from repro_torch.analysis.memplan import card_budget
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    total = card_budget(dev)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "llama3.2-1b", "--all", "--out", str(DRYRUN_DIR), "--budget-gb",
         str(total / 1e9)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})


def stop_dryrun(dry) -> None:
    if dry.poll() is None:
        dry.kill()
        dry.wait()


def phase_analysis(torch, dev, card: str, dry) -> dict:
    """Phase 17: see the module docstring.  ``dry``: the running
    :func:`start_dryrun`."""
    from repro_torch.analysis.memplan import card_budget
    from repro_torch.configs.base import get_config
    cfg = get_config("llama3.2-1b")
    out = analysis_card(torch, dev, card, cfg)
    t0 = time.perf_counter()
    text, _ = dry.communicate(timeout=DRYRUN_TIMEOUT)
    out["dryrun_wait_s"] = time.perf_counter() - t0
    check(dry.returncode == 0, f"launch.dryrun exited {dry.returncode}:\n"
          f"{text}")
    table = text[text.index("arch "):].rstrip()
    print("  (f) launch.dryrun --arch llama3.2-1b --all on meta (this host's "
          f"CPU, started before phase 15, waited {out['dryrun_wait_s']:.1f} "
          f"s here; budget the card's {card_budget(dev) / 1e9:.2f} GB):")
    print("\n".join("    " + line for line in table.splitlines()))
    cells = {c: json.loads((DRYRUN_DIR / f"{cfg.name}__{c}__1card.json")
                           .read_text())
             for c in ("train_4k", "prefill_32k", "decode_32k", "long_500k")}
    check(all(r.get("skipped") or r.get("planned_peak_bytes")
              for r in cells.values()), f"dry-run cells {cells}")
    out["dryrun"] = {c: {k: r.get(k) for k in (
        "param_bytes_f32", "param_bytes_bf16", "param_bytes_24",
        "cache_bytes", "optimizer_bytes", "planned_peak_bytes",
        "total_bytes", "fits_card", "plan_s", "skipped")}
        for c, r in cells.items()}
    return out


def analysis_card(torch, dev, card, cfg) -> dict:
    """Phase 17's (a)-(e) on the card."""
    from repro_torch.analysis import audit, memplan
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    S_, C_ = ANALYSIS_SLOTS, ANALYSIS_CAPACITY
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    # (a) the decode surface on meta, before anything is built on the card
    meta = memplan.serving_params_meta(cfg)
    mcaches = M.init_caches(cfg, S_, C_, device="meta")
    mint = torch.zeros((S_,), dtype=torch.int32, device="meta")
    static, plans = {}, {}
    for S in ANALYSIS_KV:
        fns = E.EngineFns(cfg, C_, torch.device("meta"), S)
        args = (meta, mint, mcaches, mint)
        static[S] = audit.audit_fn(fns.decode, *args, surface="decode",
                                   device=None)
        plans[S] = memplan.plan_fn(fns.decode, *args, surface="decode",
                                   device=None, sm_count=sms)
        want = {"nm_matmul": 7 * cfg.num_layers,
                **({"flash_decode": cfg.num_layers} if S == 1 else {})}
        check(static[S].kernel_launches == want,
              f"kv_shards={S}: the static audit counts "
              f"{static[S].kernel_launches} launches a decode step, want "
              f"{want}")
    planned_resident = (memplan.param_bytes(meta, memplan.ALLOC_ROUND)
                        + memplan.param_bytes(mcaches, memplan.ALLOC_ROUND))
    del meta, mcaches, mint
    print("  (a) static audit on meta: " + "; ".join(
        f"kv_shards={S}: {r.kernel_launches} a step, host syncs "
        f"{len(r.host_callbacks)}, large upcasts {r.large_f32_upcasts} "
        f"({[u['numel'] for u in r.upcasts if not u['accum']]}), "
        f"accumulation operands {sum(u['accum'] for u in r.upcasts)}"
        for S, r in static.items()))
    for S, r in static.items():
        # the one counted upcast is the logits' bf16 -> f32 cast (the
        # reference's unembed makes it too, common.py:225; ROADMAP R25)
        check(r.host_callbacks == [] and r.large_f32_upcasts == 1
              and [u["numel"] for u in r.upcasts if not u["accum"]]
              == [S_ * cfg.vocab_size], f"kv_shards={S}: host syncs "
              f"{r.host_callbacks}, upcasts {r.upcasts}")
    # (c) parameters + caches on the card against the plan
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    fns_ = _kernel_fns()
    from repro_torch.kernels.flash_decode import flash_decode
    fns_["flash_decode"] = flash_decode
    for fn in fns_.values():
        fn.launches = 0
    w = weights_whole(torch, dev, cfg)
    eng = E.ServeEngine(cfg, w["sparse"], slots=S_, capacity=C_, device=dev)
    del w
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated(dev) - base
    print(f"  (c) params + caches: planned {planned_resident} B, "
          f"memory_allocated rose {resident} B after the engine was built")
    check(resident == planned_resident, f"params + caches took {resident} "
          f"B on the card, the plan {planned_resident} B")
    # (d) one eager decode step's peak against the plan; (b) the graph
    # capture audited on the card; (a) its replay under the profiler
    toks = torch.zeros((S_,), dtype=torch.int32, device=dev)
    peaks, captured, replayed = {}, {}, {}
    for S in ANALYSIS_KV:
        fns = eng.fns if S is None else E.EngineFns(cfg, C_, dev, S)
        r = memplan.crosscheck(fns.decode, eng.params, toks, eng.caches,
                               toks, surface=f"decode kv_shards={S}")
        peaks[S] = {k: r[k] for k in ("planned_peak", "measured_peak",
                                      "rel_err")}
        check(abs(r["rel_err"]) <= PEAK_RTOL, f"kv_shards={S}: one eager "
              f"decode step's peak rose {r['measured_peak']} B, the plan "
              f"{r['planned_peak']} B (rel {r['rel_err']:+.3f}, bound "
              f"{PEAK_RTOL})")
        rep, launches = analysis_capture(torch, fns, eng, dev)
        captured[S], replayed[S] = rep, launches
        st = static[S]
        check(rep.kernel_launches == {k: 2 * v for k, v in
                                      st.kernel_launches.items()}
              and rep.host_callbacks == []
              and rep.large_f32_upcasts == 2 * st.large_f32_upcasts,
              f"kv_shards={S}: the warm-up + capture recorded "
              f"{rep.kernel_launches}, host syncs {rep.host_callbacks}, "
              f"large upcasts {rep.large_f32_upcasts}; the static audit "
              f"{st.kernel_launches} a step, {st.large_f32_upcasts}")
        want = {"nm_spmm": st.kernel_launches["nm_matmul"],
                "flash_decode": st.kernel_launches.get("flash_decode", 0),
                "combine_partials": 0}
        check(launches == want, f"kv_shards={S}: the profiler saw {launches}"
              f" on one replay of the captured step, the static audit {want}")
    launched = {k: fn.launches for k, fn in fns_.items()}
    print("  (d) one eager decode step's peak, plan vs max_memory_allocated: "
          + "; ".join(f"kv_shards={S}: {p['planned_peak']} vs "
                      f"{p['measured_peak']} B ({p['rel_err']:+.4f})"
                      for S, p in peaks.items()))
    print("  (b) the captured step (warm-up + capture, recorded on the card):"
          + "; ".join(f" kv_shards={S}: {r.kernel_launches}, host syncs "
                      f"{len(r.host_callbacks)}, large upcasts "
                      f"{r.large_f32_upcasts}" for S, r in captured.items()))
    print("  (a) one replay under the profiler: " + "; ".join(
        f"kv_shards={S}: {v}" for S, v in replayed.items()))
    # (e) each instantiation's shared memory: planned vs the binary's
    smem, bad = [], []
    for call in smem_calls():
        launch = memplan.kernel_launch(call, sms)
        got = _build.kernel_smem(*launch.query)
        smem.append((launch.instantiation, got))
        if got != (launch.static_smem, launch.dynamic_smem):
            bad.append((launch.instantiation,
                        (launch.static_smem, launch.dynamic_smem), got))
    path = {lch.instantiation: lch.smem_bytes for S in ANALYSIS_KV
            for lch in plans[S].kernels}
    print(f"  (e) shared memory, plan == cudaFuncGetAttributes + the launch's "
          f"dynamic size for {len(smem) - len(bad)} of {len(smem)} "
          f"instantiations; this path's: {path}")
    check(not bad, f"shared memory planned vs taken: {bad}")
    del eng, fns_
    gc.collect()
    torch.cuda.empty_cache()
    return {"static": {str(S): {"launches": r.kernel_launches,
                                "large_f32_upcasts": r.large_f32_upcasts,
                                "host_syncs": len(r.host_callbacks)}
                       for S, r in static.items()},
            "resident_bytes": resident, "planned_resident": planned_resident,
            "peaks": {str(S): p for S, p in peaks.items()},
            "replayed": {str(S): v for S, v in replayed.items()},
            "smem_checked": len(smem), "smem_path": path,
            "launches": launched, "card": card,
            "s_card": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 18: tensor-parallel serving over torch.distributed ranks
# ---------------------------------------------------------------------------

# 4 ranks on cuda:0 over gloo: the card machine has one card, and NCCL takes
# one rank a card, so every all-reduce and all-gather goes through the host
TP_WORLD = 4
TP_MESHES = ((1, 4), (2, 2))
# llama3.2-1b cut from 16 to 4 layers here by the script's time: through
# gloo on one card an eager decode step of the 16 layers took 323-616 ms
# against 24-37 ms in one process, and the phase 191 s (H100 80GB HBM3,
# 700 W)
TP_LLAMA_LAYERS = 4
TP_KERNELS = ("nm_matmul", "nm_matmul_expert", "flash_decode",
              "flash_decode_partial", "combine_partials")
TP_STEP_REPS = 3


def tp_cases(cfg) -> list:
    """(name, mesh shape, REPRO_FORCE_REPLICATED, the single-process
    ``kv_shards`` whose decode attention the case's runs): (1, 4) and (2,
    2), whose rings shard their capacity over "model"'s 4 or 2 ranks
    (``flash_decode_partial`` on each rank's shard, combined across them),
    and for the dense model (1, 4) forced replicated (no tag, caches
    whole: the replicated attention)."""
    cases = [(f"{a}x{b}", (a, b), False, b) for a, b in TP_MESHES]
    if not cfg.num_experts:
        cases.append(("1x4 forced", (1, 4), True, None))
    return cases


def tp_psum_rule(cfg, params, rules, slots: int, capacity: int) -> dict:
    """The reference's static ``dist.psum`` count per decode trace
    (tests/test_tp.py): at each (stage, pattern position) site, one a
    K-sharded projection group (the gated pair and the up / gate banks one
    together, every other tagged leaf one) and 2 a capacity-sharded
    attention; read off the engine's placed tags."""
    from repro_torch.kernels.shard import kv_shard_axes, pair_k_sharded
    from repro_torch.dist.axes import use_rules
    from repro_torch.models import blocks as blk
    from repro_torch.models import model as M
    out = {"mlp": 0, "attn": 0, "attn_kv": 0, "moe": 0}
    with use_rules(rules):
        for (pattern, _), stage in zip(M.make_stages(cfg), params["stages"],
                                       strict=True):
            for j, kind in enumerate(pattern):
                p = stage[str(j)]
                tagged = lambda k: getattr(k["kernel"], "shard",  # noqa
                                           None) is not None
                out["attn"] += sum(tagged(p["attn"][n])
                                   for n in ("wq", "wk", "wv", "wo"))
                site = "moe" if "moe" in p else "mlp"
                ffn = p[site]
                pair = pair_k_sharded(ffn["up"]["kernel"],
                                      ffn["gate"]["kernel"])
                out[site] += (1 if pair else tagged(ffn["up"])
                              + tagged(ffn["gate"])) + tagged(ffn["down"])
                ring = blk.cache_length(kind, cfg, capacity)
                out["attn_kv"] += 2 * bool(kv_shard_axes(slots, ring))
    return out


def tp_planned_bytes(cfg, params, mesh) -> int:
    """This rank's parameter bytes by the spec derivation alone
    (``dist.sharding.params_sharding`` on the whole leaves' shapes)."""
    from repro_torch import tree
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.axes import make_rules
    from repro_torch.models import model as M
    from repro_torch.sparse.formats import SparseTensor
    specs = dict(tree.flatten_with_path(shd.params_sharding(
        M.param_axes(cfg), params, make_rules(mesh))))
    total = 0
    for path, w in tree.flatten_with_path(params):
        parts = ([(w.vals, specs[path].vals), (w.idx, specs[path].idx)]
                 if isinstance(w, SparseTensor) else [(w, specs[path])])
        for t, spec in parts:
            total += math.prod(shd.block_shape(tuple(t.shape), spec, mesh)) \
                * t.element_size()
    return total


def tp_held_bytes(params) -> tuple[int, bool]:
    """(the bytes of this rank's parameter leaves, whether every block is
    storage of its own: no whole leaf kept alive under a block)."""
    from repro_torch import tree
    from repro_torch.dist.sharding import DenseBlock
    from repro_torch.sparse.formats import SparseTensor
    total, own = 0, True
    for w in tree.leaves(params):
        block = isinstance(w, DenseBlock) or (isinstance(w, SparseTensor)
                                              and w.block is not None)
        parts = ([w.vals, w.idx] if isinstance(w, SparseTensor) else
                 [w.data] if isinstance(w, DenseBlock) else [w])
        for t in parts:
            n = t.numel() * t.element_size()
            total += n
            own &= not block or t.untyped_storage().nbytes() == n
    return total, own


def tp_eager_step_ms(torch, eng) -> float:
    """The median host-clock ms of ``TP_STEP_REPS`` eager decode steps of
    ``eng`` (every slot at its position; synchronised)."""
    import numpy as np
    from repro_torch.serve.engine import eager
    toks = np.zeros((eng.slots,), np.int32)
    times = []
    with eager():
        for _ in range(TP_STEP_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.fns.step(eng.params, toks, eng.caches, eng.pos)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def tp_pack_steps(torch, steps: list) -> dict:
    """:func:`record_decode`'s steps as a few stacked tensors (each tensor
    sent to a rank is one CUDA IPC handle to open): the slots' rids, fed
    tokens, positions, logits and, for MoE, each layer's routing."""
    out = {"rids": [st[0] for st in steps],
           **{k: torch.stack([st[i] for st in steps])
              for k, i in (("toks", 1), ("t", 2), ("logits", 3))}}
    if steps[0][4]:
        for k, i in (("probs", 0), ("ids", 1)):
            out[k] = torch.stack([torch.stack([r[i] for r in st[4]])
                                  for st in steps])
    return out


def tp_unpack_steps(packed: dict) -> list:
    """The steps :func:`tp_pack_steps` packed."""
    return [(rids, packed["toks"][i], packed["t"][i], packed["logits"][i],
             list(zip(packed["probs"][i], packed["ids"][i]))
             if "probs" in packed else [])
            for i, rids in enumerate(packed["rids"])]


def tp_reference(torch, dev, cfg, params, prompts, kv_shards) -> dict:
    """The single-process engine the ranks are held against, eager, at the
    ``kv_shards`` whose decode attention arithmetic a case runs: its
    streams, its recorded decode steps (kept on the card: the ranks map
    them by CUDA IPC) and its times."""
    from repro_torch.serve.engine import ServeEngine, eager
    e = ServeEngine(cfg, params, slots=4, capacity=256, device=dev,
                    kv_shards=kv_shards)
    routes = []
    steps = record_decode(e, routes)
    rids = [e.submit(p, MAX_TOKENS) for p in prompts]
    t0 = time.perf_counter()
    with recording_routes(routes), eager():
        out = e.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del e.fns.decode
    return {"out": [out[r] for r in rids],
            "steps": tp_pack_steps(torch, steps), "run_s": run_s,
            "step_ms": tp_eager_step_ms(torch, e)}


def tp_case(torch, dev, rank, cfg, params, prompts, shape, ref,
            profile: bool) -> dict:
    """One case on one rank: the engine under rules (placement, the
    ``dist.psum`` count of a decode trace, then phase 4's requests, eager,
    counted; rank 0 records each distinct kernel call and the decode
    steps, holds them against the plain versions and the single-process
    run ``ref``)."""
    from repro_torch import obs
    from repro_torch.dist.axes import make_rules
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels.nm_spmm import nm_matmul, nm_matmul_expert
    from repro_torch.launch.mesh import Mesh
    from repro_torch.serve.engine import ServeEngine, eager
    import numpy as np
    counted = {"nm_matmul": nm_matmul, "nm_matmul_expert": nm_matmul_expert,
               **{n: getattr(fd, n) for n in FLASH_KERNELS}}
    t_case = time.perf_counter()
    mesh = Mesh(shape, ("data", "model"))
    rules = make_rules(mesh)
    t0 = time.perf_counter()
    e = ServeEngine(cfg, params, slots=4, capacity=256, device=dev,
                    rules=rules)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    held, own = tp_held_bytes(e.params)
    planned = tp_planned_bytes(cfg, params, mesh)
    check(held == planned and own, f"rank {rank} {cfg.name} {shape}: "
          f"params hold {held} B (blocks their own storage: {own}), "
          f"planned {planned} B")
    # dist.psum over one decode trace, then a second decode of it
    rule = tp_psum_rule(cfg, e.params, rules, 4, 256)
    sites = tuple(rule)
    obs.reset()
    obs.configure()
    try:
        zeros = np.zeros((4,), np.int32)
        snap = lambda: {s: obs.counter_value("dist.psum", site=s)  # noqa
                        for s in sites}
        c0 = snap()
        with eager():
            e.fns.step(e.params, zeros, e.caches, zeros)
            c1 = snap()
            e.fns.step(e.params, zeros, e.caches, zeros + 1)
        c2 = snap()
    finally:
        obs.reset()
    psum = {s: c1[s] - c0[s] for s in sites}
    check(psum == rule and c2 == c1, f"rank {rank} {cfg.name} {shape}: "
          f"dist.psum per decode trace {psum} (then {c2} after {c1}), the "
          f"reference's rule {rule}")
    for fn in counted.values():
        fn.launches = 0
    calls, routes = {}, []
    steps = record_decode(e, routes)
    rids = [e.submit(p, MAX_TOKENS) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (first_call_per_signature(calls) if rank == 0
          else contextlib.nullcontext()), recording_routes(routes), eager():
        out = e.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counted.items()}
    del e.fns.decode
    prof_out = {}
    if profile:         # one eager decode step under the profiler
        with eager():
            prof_out = profiled_launches(torch, lambda: e.fns.step(
                e.params, zeros, e.caches, e.pos))
    counts = path_launches(cfg)
    sharded_kv = bool(rule["attn_kv"])
    want = {"flash_decode": 0,
            "flash_decode_partial": attn_layers(cfg) * e.decode_steps
            if sharded_kv else 0,
            "combine_partials": attn_layers(cfg) * e.decode_steps
            if sharded_kv else 0,
            **{n: counts["prefill"][n] * e.prefill_calls
               + counts["decode"][n] * e.decode_steps for n in PATH_KERNELS}}
    check(launches == want, f"rank {rank} {cfg.name} {shape}: launches "
          f"{launches}, want {want}")
    res = {"streams": [out[r] for r in rids], "launches": launches,
           "prefills": e.prefill_calls, "decode_steps": e.decode_steps,
           "psum": psum, "bytes": held, "place_s": place_s, "run_s": run_s,
           "step_ms": tp_eager_step_ms(torch, e), "profiled": prof_out,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if rank == 0:
        res["calls"] = check_path_calls(torch, calls)
        n_rows, worst, ties, rerouted = compare_decode_runs(
            torch, tp_unpack_steps(ref["steps"]), steps,
            coupled=bool(cfg.num_experts))
        differ = [i for i, (a, b) in enumerate(zip(ref["out"],
                                                   res["streams"]))
                  if a != b]
        explained = len(ties) + len(rerouted)
        check(len(differ) == len(ties) if not cfg.num_experts
              else (not differ or explained > 0),
              f"{cfg.name} {shape}: streams of requests {differ} differ "
              f"from the single-process engine's, {len(ties)} token and "
              f"{len(rerouted)} routing near-ties")
        res["compare"] = {"rows": n_rows, "worst": worst,
                          "near_ties": explained, "differ": len(differ)}
    del e, steps, routes, calls
    gc.collect()
    torch.cuda.empty_cache()
    res["case_s"] = time.perf_counter() - t_case
    return res


def tp_rank(rank: int, world: int, dev, jobs: list) -> dict:
    """One rank of phase 18 (``dist.ranks.run_ranks``: cuda:0, gloo):
    each job's cases.  A job's params and reference runs stay in the
    parent's memory, mapped here by CUDA IPC; each engine keeps this
    rank's blocks."""
    import torch
    from repro_torch.kernels.shard import FORCE_REPLICATED_ENV
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    out = {"entered": time.time()}
    for job in jobs:
        cfg = job["cfg"]
        for name, shape, forced, _ in tp_cases(cfg):
            if forced:
                os.environ[FORCE_REPLICATED_ENV] = "1"
            try:
                out[f"{cfg.name} {name}"] = tp_case(
                    torch, dev, rank, cfg, job["params"], job["prompts"],
                    shape, job["refs"][name],
                    profile=name == "1x4" and bool(cfg.num_experts))
            finally:
                os.environ.pop(FORCE_REPLICATED_ENV, None)
    out["s"] = time.perf_counter() - t0
    return out


def phase_tp(torch, dev, card: str) -> dict:
    """Phase 18: llama3.2-1b cut to ``TP_LLAMA_LAYERS`` and mixtral-8x22b
    to phase 5's 2 layers at their published widths, 2:4 (phase 4's
    masks: ``weights_whole``), served by 4 ranks
    under rules on (1, 4) and (2, 2) (llama also forced replicated), each
    held against the single-process engine at the same decode attention
    arithmetic."""
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    jobs = []
    for cfg in (dataclasses.replace(get_config("llama3.2-1b"),
                                    num_layers=TP_LLAMA_LAYERS),
                dataclasses.replace(get_config("mixtral-8x22b"),
                                    num_layers=MIXTRAL_LAYERS)):
        t1 = time.perf_counter()
        w = weights_whole(torch, dev, cfg)
        params = M.serving_params(w.pop("sparse"))
        del w
        print(f"  {cfg.name}: {cfg.num_layers} layers made, masked and "
              f"packed in {time.perf_counter() - t1:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        prompts = serving_prompts(cfg)
        refs = {name: tp_reference(torch, dev, cfg, params, prompts, S)
                for name, _, _, S in tp_cases(cfg)}
        for name, _, _, S in tp_cases(cfg):
            print(f"  {cfg.name} single process, kv_shards={S}: "
                  f"{len(prompts)} requests x {MAX_TOKENS} tokens in "
                  f"{refs[name]['run_s']:.3f} s eager, one eager decode step "
                  f"{refs[name]['step_ms']:.2f} ms")
        jobs.append({"cfg": cfg, "params": params, "prompts": prompts,
                     "refs": refs})
    t_ref = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {TP_WORLD} ranks on cuda:0 over gloo (one card; NCCL takes one "
          "rank a card): every all-reduce and all-gather goes through the "
          "host; eager steps (a CUDA graph captures collectives over NCCL "
          "only); params and the single-process runs shared by CUDA IPC")
    t1, spawned = time.perf_counter(), time.time()
    ranks = run_ranks(tp_rank, TP_WORLD, args=(jobs,), device="cuda",
                      backend="gloo", timeout=300.0, deadline=900.0)
    t_ranks = time.perf_counter() - t1
    summary = {"paths": {}, "profiled": {}, "cases": {}}
    for job in jobs:
        cfg = job["cfg"]
        for name, shape, _, S in tp_cases(cfg):
            key = f"{cfg.name} {name}"
            rs = [r[key] for r in ranks]
            ref = job["refs"][name]
            check(all(r["streams"] == rs[0]["streams"] for r in rs),
                  f"{key}: the ranks' streams differ")
            same = sum(a == b for a, b in zip(ref["out"], rs[0]["streams"]))
            launches = {n: sum(r["launches"][n] for r in rs)
                        for n in TP_KERNELS}
            summary["paths"][f"tp {key}"] = launches
            if rs[0]["profiled"]:
                summary["profiled"][f"tp {key}"] = {
                    n: sum(r["profiled"][n] for r in rs)
                    for n in rs[0]["profiled"]}
            cmp = rs[0]["compare"]
            print(f"  {key} (mesh {shape}) vs single process kv_shards={S}: "
                  f"streams equal for {same} of {len(ref['out'])} requests "
                  f"({cmp['near_ties']} counted near-ties); {cmp['rows']} "
                  f"decode rows with the same history, logits worst "
                  f"{cmp['worst']:.3f} of the tolerance ({LOGIT_ULPS_FULL} "
                  f"bf16 ulps of the row's max); dist.psum per decode "
                  f"trace {rs[0]['psum']}, the reference's rule; launches "
                  f"summed over the ranks {launches} ({rs[0]['prefills']} "
                  f"prefills + {rs[0]['decode_steps']} decode steps a "
                  f"rank); params a rank {[r['bytes'] for r in rs]} B == "
                  f"planned blocks; placed in "
                  f"{max(r['place_s'] for r in rs):.2f} s; served in "
                  f"{max(r['run_s'] for r in rs):.3f} s; one eager TP "
                  f"decode step {statistics.median(r['step_ms'] for r in rs):.2f}"
                  f" ms (host round trips through gloo: not a TP speed) "
                  f"against {ref['step_ms']:.2f} ms single-process; peak "
                  f"{max(r['peak_gib'] for r in rs):.2f} GiB a rank")
            print("    rank 0: " + rs[0]["calls"])
            summary["cases"][key] = {
                "mesh": list(shape), "kv_shards": S, "same_streams": same,
                "near_ties": cmp["near_ties"], "logit_worst": cmp["worst"],
                "psum": rs[0]["psum"], "bytes": [r["bytes"] for r in rs],
                "tp_step_ms": [r["step_ms"] for r in rs],
                "single_step_ms": ref["step_ms"],
                "run_s": max(r["run_s"] for r in rs),
                "peak_gib": max(r["peak_gib"] for r in rs)}
    for name, counts in summary["profiled"].items():
        cfg = next(j["cfg"] for j in jobs if name.startswith(
            f"tp {j['cfg'].name} "))
        per = path_launches(cfg)["decode"]
        want = {"nm_spmm": TP_WORLD * (per["nm_matmul"]
                                       + per["nm_matmul_expert"]),
                "flash_decode": TP_WORLD * attn_layers(cfg),
                "combine_partials": TP_WORLD * attn_layers(cfg)}
        seen = {k: v for k, v in counts.items() if k in want}
        check(seen == want, f"{name}: the profiler saw {counts} kernels "
              f"in one decode step on the {TP_WORLD} ranks, want {want}")
        print(f"  {name}: one eager decode step under the profiler on each "
              f"rank, kernels summed over the ranks {seen} == the wrappers' "
              "count a step")
    print(f"  the weights and the single-process runs {t_ref:.1f} s, the "
          f"ranks {t_ranks:.1f} s: started and joined with their params by "
          f"CUDA IPC in {max(r['entered'] for r in ranks) - spawned:.1f} s, "
          f"their work {max(r['s'] for r in ranks):.1f} s (the cases "
          + ", ".join(f"{k} {v['case_s']:.1f}" for k, v in ranks[0].items()
                      if isinstance(v, dict)) + " s on rank 0)")
    del jobs, ranks
    gc.collect()
    torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t0
    return summary


# ---------------------------------------------------------------------------
# Phase 19: the UniPruning search over torch.distributed ranks
# ---------------------------------------------------------------------------

# phase 18's 4 ranks on cuda:0 over gloo and its llama3.2-1b cut (4 of 16
# layers); the launcher's search defaults (wanda, 2:4, median scores)
CALIB_TP_MESHES = ((1, 4), (2, 2))
CALIB_TP_STEPS = 3
CALIB_TP_KERNELS = ("saliency_fused_step", "prox24", "nm_mask24")
CALIB_TP_PROFILED = {"saliency_fused_step": ("saliency_fuse_kernel",),
                     "prox24": ("prox24_kernel",),
                     "nm_mask24": ("nm_mask24_kernel",)}
CALIB_TP_DIR = ROOT / "build" / "chip_smoke_calib_tp"
CALIB_TP_RTOL, CALIB_TP_ATOL = 1e-5, 1e-7   # tests/test_torch_calib_tp.py's


@contextlib.contextmanager
def mask_calls_checked(torch, seen: dict):
    """While open, the first ``nm_mask24`` call at every distinct signature
    that ``core/masks.py`` makes is held against the plain ranking on the
    same scores, exactly; every call still launches and counts."""
    from repro_torch.core import masks
    from repro_torch.kernels import ref
    saved = masks.nm_mask24

    def call(s):
        got = saved(s)
        key = ("nm_mask24", tuple(s.shape), s.dtype)
        if key not in seen:
            want = ref.nm_mask_ref(s, 2, 4)
            seen[key] = int((got != want).sum())
            check(torch.equal(got, want), f"nm_mask24 at {key} on the "
                  f"sharded export differs from its plain version in "
                  f"{seen[key]} entries")
        return got

    masks.nm_mask24 = call
    try:
        yield seen
    finally:
        masks.nm_mask24 = saved


def calib_tp_planned_bytes(cfg, params, rules) -> int:
    """This rank's W / Gamma / V bytes by ``search_state_sharding``'s
    spec tree alone (from shapes: no state is made)."""
    import numpy as np
    from repro_torch import tree
    from repro_torch.core.mirror import SearchState
    from repro_torch.core.prunable import prunable_map
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as M
    shapes = tree.tree_map(lambda p: tuple(p.shape), params)
    gv = tree.tree_map(lambda s, p: s if p else None, shapes,
                       prunable_map(params))
    specs = shd.search_state_sharding(
        M.param_axes(cfg), SearchState(W=shapes, Gamma=gv, V=gv, step=0,
                                       rng=None), rules)
    total = 0
    for name in ("W", "Gamma", "V"):
        want = shapes if name == "W" else gv
        for x, spec in zip(tree.leaves(want),
                           tree.leaves(getattr(specs, name)), strict=True):
            if x is not None:
                total += 4 * int(np.prod(shd.block_shape(x, spec,
                                                         rules.mesh)))
    return total


def calib_tp_held_bytes(state) -> int:
    """The bytes of this rank's W / Gamma / V storages."""
    from repro_torch import tree
    from repro_torch.dist.sharding import block_data
    return sum(block_data(x).untyped_storage().nbytes()
               for t in (state.W, state.Gamma, state.V)
               for x in tree.leaves(t) if x is not None)


def calib_tp_compare(torch, ref: dict, gamma, v, masks, mesh=None) -> dict:
    """Trees from the ranks against the single-process search (whole, or
    with ``mesh`` this rank's ``DenseBlock``s against the same blocks of
    the single process's leaves): the worst |err| / (atol + rtol |want|)
    of Gamma and V (<= 1 holds), and the 2:4 mask entries that differ,
    each group of them a near-tie of the single process's scores (its
    kept / dropped gap within twice the bound)."""
    from repro_torch import tree
    from repro_torch.dist.sharding import DenseBlock, local_block

    def pairs(want, got):
        for w, g in zip(tree.leaves(want), tree.leaves(got), strict=True):
            if w is not None:
                yield ((local_block(w, g.spec, mesh), g.data, g.spec)
                       if isinstance(g, DenseBlock) else (w, g, ()))

    worst = 0.0
    for name, got in (("Gamma", gamma), ("V", v)):
        for w, g, _ in pairs(ref[name], got):
            worst = max(worst, float(((g - w).abs() / (
                CALIB_TP_ATOL + CALIB_TP_RTOL * w.abs())).max()))
    eps = 1e-6 * max(float(g.abs().max()) for g in tree.leaves(ref["Gamma"])
                     if g is not None) / max(
        float(x.abs().max()) for x in tree.leaves(ref["V"]) if x is not None)
    differ = ties = 0
    for (w, g, spec), gm, vv in zip(
            pairs(ref["masks"], masks),
            (x for x in tree.leaves(ref["Gamma"]) if x is not None),
            (x for x in tree.leaves(ref["V"]) if x is not None),
            strict=True):
        bad = (w != g.bool())
        n = int(bad.sum())
        if not n:
            continue
        differ += n
        if spec:
            gm, vv = (local_block(x, spec, mesh) for x in (gm, vv))
        N = w.shape[-1]
        score = (gm.abs() + eps * vv.abs()).reshape(-1, 4, N)
        srt = score.sort(dim=1).values
        gap = srt[:, 2] - srt[:, 1]
        tol = (CALIB_TP_ATOL + CALIB_TP_RTOL * score).amax(dim=1)
        groups = bad.reshape(-1, 4, N).any(dim=1)
        ties += int((groups & (gap <= 2 * tol)).sum())
        check(bool(((gap <= 2 * tol) | ~groups).all()),
              "a 2:4 mask group differs from the single process's where "
              "its scores are not near-tied")
    return {"worst": worst, "mask_entries_differ": differ,
            "near_tied_groups": ties}


def calib_tp_run(torch, dev, rank: int, fn, profiled: bool) -> dict:
    """``fn()`` counted (each search kernel's wrapper count set to 0 just
    before, read just after), rank 0 holding every distinct kernel call
    against its plain version; with ``profiled``, under the profiler on
    every rank (the device's activity, after :func:`profiler_window`'s spin
    kernels), whose kernel counts must equal the wrappers'."""
    fns = _kernel_fns()
    seen = {}
    for name in CALIB_TP_KERNELS:
        fns[name].launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    with (search_calls_checked(torch, seen) if rank == 0
          else contextlib.nullcontext()), \
            (mask_calls_checked(torch, seen) if rank == 0
             else contextlib.nullcontext()), \
            (profile(activities=[ProfilerActivity.CUDA]) if profiled
             else contextlib.nullcontext()) as prof:
        if profiled:
            for _ in range(PROFILER_WARMUP):
                torch.cuda._sleep(1000)
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
    launches = {name: fns[name].launches for name in CALIB_TP_KERNELS}
    t0 = time.perf_counter()
    seen_prof = None
    if profiled:
        evs = device_events(prof)
        seen_prof = {name: sum(e.count for e in evs
                               if any(k in e.key for k in keys))
                     for name, keys in CALIB_TP_PROFILED.items()}
        check(seen_prof == launches, f"rank {rank}: the profiler saw "
              f"{seen_prof} search kernels, the wrappers counted "
              f"{launches}")
    return {"out": out, "launches": launches, "profiled": seen_prof,
            "calls": sorted(f"{k[0]} {k[1]}" for k in seen), "s": s,
            "profile_s": time.perf_counter() - t0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def calib_tp_case(torch, dev, rank: int, job: dict, shape) -> dict:
    """One mesh: stats, the 3-step search and the 2:4 export under rules,
    counted and profiled; each rank holds its Gamma, V and mask blocks
    against the same blocks of the single-process search, and its history
    against that search's."""
    from repro_torch.core import calibrate as C
    from repro_torch.core import mirror
    from repro_torch.dist.axes import make_rules
    from repro_torch.launch.mesh import Mesh
    cfg, pcfg, params, calib = (job[k] for k in ("cfg", "pcfg", "params",
                                                 "calib"))
    mesh = Mesh(shape, ("data", "model"))
    rules = make_rules(mesh)

    def path():
        stats = C.collect_stats(cfg, params, calib, pcfg=pcfg, rules=rules)
        state, hist = C.run_search(cfg, pcfg, params, calib, stats,
                                   rules=rules, log_every=1)
        masks = mirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V,
                                    rules=rules)
        torch.cuda.synchronize()
        return state, stats, hist, masks

    res = calib_tp_run(torch, dev, rank, path, profiled=False)
    state, stats, hist, masks = res.pop("out")
    held = calib_tp_held_bytes(state)
    planned = calib_tp_planned_bytes(cfg, params, rules)
    check(held == planned, f"rank {rank} mesh {shape}: the search state "
          f"holds {held} B, search_state_sharding's blocks {planned} B")
    res["bytes"] = held
    t0 = time.perf_counter()
    res["compare"] = calib_tp_compare(torch, job["ref"], state.Gamma,
                                      state.V, masks, mesh)
    want = job["ref"]["history"]
    check(len(hist) == len(want) and all(
        a[k] == b[k] for a, b in zip(want, hist)
        for k in ("loss", "gamma_nonzero_frac", "mask_churn")),
        f"rank {rank} mesh {shape}: the search history differs from the "
        f"single process's: {hist} vs {want}")
    del state, masks
    if shape == CALIB_TP_MESHES[0]:
        # the profiler over one more search (1 step from the stats) and
        # its export, not over the case: with it on, the case took ~9 s
        # more, and the table of its ~20 s window ~7 s to build
        one = dataclasses.replace(pcfg, steps=1)

        def step():
            st, _ = C.run_search(cfg, one, params, calib, stats, rules=rules)
            mirror.export_masks(one, st.Gamma, 0.5, V=st.V, rules=rules)

        prof = calib_tp_run(torch, dev, rank, step, profiled=True)
        res.update(profiled=prof["profiled"],
                   profiled_launches=prof["launches"],
                   profile_s=prof["s"] + prof["profile_s"])
    del stats
    gc.collect()
    torch.cuda.empty_cache()
    res["gather_s"] = time.perf_counter() - t0
    return res


def calib_tp_launcher(torch, dev, rank: int, job: dict) -> dict:
    """The calibrate launcher's ``--mesh host`` path over the 4 ranks
    ((4, 1)): ``launch.calibrate.host_rules`` over this process group,
    then ``calibrate_to_bank`` under them, counted and profiled; rank 0
    writes the bank, loads it and holds it against the single-process
    search."""
    from repro_torch.launch.calibrate import calibrate_to_bank, host_rules
    from repro_torch.sparse.bank import MaskBank
    cfg, pcfg, params, calib = (job[k] for k in ("cfg", "pcfg", "params",
                                                 "calib"))
    rules, _, _ = host_rules(str(dev))
    res = calib_tp_run(torch, dev, rank, lambda: calibrate_to_bank(
        job["bank"], cfg=cfg, pcfg=pcfg, params=params,
        calib=calib, arch=cfg.name, smoke=False, log_every=1, rules=rules),
        profiled=False)
    bank = res.pop("out")
    check((bank is None) == (rank != 0), f"rank {rank}: MaskBank.save "
          f"returned {type(bank).__name__}")
    res["mesh"] = dict(rules.mesh.shape)
    t0 = time.perf_counter()
    if rank == 0:
        loaded = MaskBank.load(job["bank"], cfg=cfg, device=dev)
        res["compare"] = calib_tp_compare(torch, job["ref"], loaded.Gamma,
                                          loaded.V, loaded.masks_at())
        res["checksum"] = loaded.meta["checksum"]
        del loaded
    del bank
    gc.collect()
    torch.cuda.empty_cache()
    res["gather_s"] = time.perf_counter() - t0
    return res


def calib_tp_rank(rank: int, world: int, dev, job: dict) -> dict:
    """One rank of phase 19 (``dist.ranks.run_ranks``: cuda:0, gloo): the
    params and the single-process run stay in the parent's memory, mapped
    here by CUDA IPC."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    out = {"entered": time.time()}
    for shape in CALIB_TP_MESHES:
        out[f"{shape[0]}x{shape[1]}"] = calib_tp_case(torch, dev, rank, job,
                                                     shape)
    out["launcher 4x1"] = calib_tp_launcher(torch, dev, rank, job)
    out["s"] = time.perf_counter() - t0
    return out


def phase_calib_tp(torch, dev, card: str) -> dict:
    """Phase 19: llama3.2-1b at its published widths (phase 18's 4 of 16
    layers), the launcher's search (wanda, 2:4, median scores) for 3 steps
    over 2 calibration batches of 4 x 64, on 4 ranks under rules on (1,
    4), (2, 2) and the launcher's ``--mesh host`` (4, 1), each held
    against the single-process card search."""
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig, get_config
    from repro_torch.core import calibrate as C
    from repro_torch.core import mirror
    from repro_torch.data.synthetic import batches_for
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama3.2-1b"),
                              num_layers=TP_LLAMA_LAYERS)
    pcfg = PruneConfig(local_metric="wanda", mode="nm",
                       steps=CALIB_TP_STEPS, stats_batches=4)
    calib = batches_for(cfg, n=2, batch=4, seq=64, split="calib")
    params = M.init_params(cfg, 0, device=dev)
    shutil.rmtree(CALIB_TP_DIR, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    stats = C.collect_stats(cfg, params, calib, pcfg=pcfg)
    state, hist = C.run_search(cfg, pcfg, params, calib, stats, log_every=1)
    masks = mirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t1
    single_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref = {"Gamma": state.Gamma, "V": state.V, "masks": masks,
           "history": hist}
    del stats, state
    print(f"  {cfg.name} ({cfg.num_layers} layers): "
          f"{sum(x.numel() for x in tree.leaves(params))} params; "
          f"{pcfg.local_metric} {pcfg.mode}, score_norm {pcfg.score_norm}, "
          f"{pcfg.steps} steps, calib 2 x 4 x 64; one process: stats + "
          f"search + 2:4 export {single_s:.2f} s, peak {single_peak:.2f} GiB")
    job = {"cfg": cfg, "pcfg": pcfg, "params": params, "calib": calib,
           "ref": ref, "bank": CALIB_TP_DIR / "ranked"}
    print(f"  {TP_WORLD} ranks on cuda:0 over gloo (phase 18's), each kernel "
          "gathered whole where the model uses it, the search state and "
          "its kernels on each rank's blocks; params and the single-process "
          "search shared by CUDA IPC")
    t1, spawned = time.perf_counter(), time.time()
    ranks = run_ranks(calib_tp_rank, TP_WORLD, args=(job,), device="cuda",
                      backend="gloo", timeout=300.0, deadline=600.0)
    t_ranks = time.perf_counter() - t1
    summary = {"paths": {}, "profiled": {}, "calls": {}, "cases": {}}
    for case in [f"{a}x{b}" for a, b in CALIB_TP_MESHES] + ["launcher 4x1"]:
        rs = [r[case] for r in ranks]
        # the meshes' ranks hold distinct blocks of every prunable leaf;
        # the launcher's bank is compared whole on rank 0
        cmps = [r["compare"] for r in rs if "compare" in r]
        cmp = {"worst": max(c["worst"] for c in cmps),
               **{k: sum(c[k] for c in cmps)
                  for k in ("mask_entries_differ", "near_tied_groups")}}
        check(cmp["worst"] <= 1.0, f"calib_tp {case}: Gamma / V "
              f"{cmp['worst']:.3f} of the bound from the single process's")
        launches = {n: sum(r["launches"][n] for r in rs)
                    for n in CALIB_TP_KERNELS}
        want = {"saliency_fused_step": TP_WORLD * CALIB_TP_STEPS * 7,
                "prox24": TP_WORLD * CALIB_TP_STEPS * 7,
                "nm_mask24": 0 if case.startswith("launcher")
                else TP_WORLD * 7}
        check(launches == want, f"calib_tp {case}: launches summed over the "
              f"ranks {launches}, want {want}")
        summary["paths"][f"calib_tp {case}"] = launches
        if rs[0]["profiled"]:
            summary["profiled"][f"calib_tp {case}, 1 step + export"] = {
                n: sum(r["profiled"][n] for r in rs)
                for n in CALIB_TP_KERNELS}
            want1 = {"saliency_fused_step": TP_WORLD * 7,
                     "prox24": TP_WORLD * 7, "nm_mask24": TP_WORLD * 7}
            check(summary["profiled"][f"calib_tp {case}, 1 step + export"]
                  == want1, f"calib_tp {case}: the profiler's launches "
                  f"over one step and its export {rs[0]['profiled']} a "
                  f"rank, want {want1} summed")
        summary["calls"][case] = rs[0]["calls"]
        summary["cases"][case] = {
            "worst": cmp["worst"],
            "mask_entries_differ": cmp["mask_entries_differ"],
            "near_tied_groups": cmp["near_tied_groups"],
            "bytes": [r.get("bytes") for r in rs],
            "peak_gib": [r["peak_gib"] for r in rs],
            "s": max(r["s"] for r in rs),
            "check_s": max(r["gather_s"] for r in rs)}
        print(f"  {case}: Gamma / V worst {cmp['worst']:.3f} of the bound "
              f"(rtol {CALIB_TP_RTOL}, atol {CALIB_TP_ATOL}) from the single "
              f"process's, 2:4 masks: {cmp['mask_entries_differ']} entries "
              f"differ ({cmp['near_tied_groups']} near-tied groups); launches "
              f"summed over the ranks {launches}"
              + (f" (one more step and export under the profiler: "
                 f"{rs[0]['profiled']} a rank, == the wrappers')"
                 if rs[0]["profiled"] else "")
              + (f"; state bytes a rank {[r['bytes'] for r in rs]} == "
                 "search_state_sharding's blocks" if "bytes" in rs[0]
                 else "")
              + f"; {max(r['s'] for r in rs):.2f} s (gloo through the host on "
              f"one card: not a TP speed; then the checks "
              f"{max(r['gather_s'] for r in rs):.2f} s"
              + (f", the profiled step of them "
                 f"{max(r['profile_s'] for r in rs):.2f} s"
                 if rs[0]["profiled"] else "") + "); peak "
              f"{max(r['peak_gib'] for r in rs):.2f} GiB a rank")
        print(f"    rank 0's shard-local kernel calls, each bit for bit with "
              f"its plain version: {'; '.join(rs[0]['calls'])}")
    print(f"  the bank rank 0 wrote loads (checksum "
          f"{ranks[0]['launcher 4x1']['checksum']}); its masks differ from "
          f"the single process's in "
          f"{summary['cases']['launcher 4x1']['mask_entries_differ']} "
          f"entries")
    print(f"  the single process {t1 - t0:.1f} s, the ranks {t_ranks:.1f} s "
          f"(started and joined in "
          f"{max(r['entered'] for r in ranks) - spawned:.1f} s, their work "
          f"{max(r['s'] for r in ranks):.1f} s)")
    del job, ref, masks, params, ranks
    shutil.rmtree(CALIB_TP_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t0
    return summary


# ---------------------------------------------------------------------------
# Phase 20: training over torch.distributed ranks
# ---------------------------------------------------------------------------

# phase 18's 4 ranks on cuda:0 over gloo and its llama3.2-1b cut (4 of 16
# layers); phase 16's train step (AdamW, remat, 2 steps of 2 x 256 tokens)
TRAIN_TP_MESHES = ((1, 4), (2, 2))
TRAIN_TP_STEPS = 2
TRAIN_TP_ROWS, TRAIN_TP_TOKENS = 2, 256
# smoke mixtral at the CPU tests' batch: its full-width expert banks, their
# AdamW state and every rank's whole gathers pass the card at 1 layer
TRAIN_TP_SMOKE_ROWS, TRAIN_TP_SMOKE_TOKENS = 4, 32
TRAIN_TP_DIR = ROOT / "build" / "chip_smoke_train_tp"
# the train launcher over the ranks (it takes llama3.2-1b's published
# config, all 16 layers, or the smoke one): smoke llama, 4 steps of 2 x 32
# tokens, on (1, 4) straight and on (2, 2) with a checkpoint every 2 steps
TRAIN_TP_LAUNCH_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
                        "--batch", "2", "--seq", "32", "--log-every", "1"]
TRAIN_TP_LAUNCH_DIR = ROOT / "build" / "chip_smoke_train_tp_launcher"
# then host 3 of the (2, 2) mesh's 4 one-rank hosts fails: the survivors'
# plan keeps the model axis, (1, 2) over hosts 0 and 1, accum x 2
TRAIN_TP_RECOVERY = dict(surviving=(0, 1, 2), hosts_total=4,
                         old_mesh=(2, 2), model_axis=2, chips_per_host=1)


def train_tp_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by name (each counts its
    launches)."""
    from repro_torch.kernels import flash_decode as fd
    return {**_kernel_fns(), "flash_decode": fd.flash_decode,
            "flash_decode_partial": fd.flash_decode_partial,
            "combine_partials": fd.combine_partials}


def train_tp_ocfg():
    """Phase 16's schedule for its 2 steps."""
    from repro_torch.optim import optimizers as opt
    return opt.AdamWConfig(lr=3e-4, total_steps=TRAIN_TP_STEPS,
                           warmup_steps=1)


def train_tp_steps(torch, step, state, batches) -> tuple:
    """``step`` over the batches from ``state``, each fenced: (params,
    ostate, [(loss, grad_norm)], [ms])."""
    params, ostate = state
    metrics, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, ostate, m = step(params, ostate, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params, ostate, metrics, ms


def train_tp_compare(torch, state, ref, mesh) -> dict:
    """This rank's blocks of (params, AdamWState) against the same blocks
    of the single process's leaves (``ref``, whole): leaves compared, the
    leaves that differ and the largest |difference|."""
    from repro_torch.ckpt.checkpoint import flatten_state
    from repro_torch.dist import sharding as shd
    differ, worst, n = [], 0.0, 0
    for (path, x), (_, w) in zip(flatten_state(state), flatten_state(ref),
                                 strict=True):
        got = shd.block_data(x)
        want = (shd.local_block(w, x.spec, mesh)
                if isinstance(x, shd.DenseBlock) else w)
        n += 1
        if not torch.equal(got, want):
            differ.append(path)
            worst = max(worst, float((got.double() - want.double())
                                     .abs().max()))
    return {"leaves": n, "differ": differ[:4], "n_differ": len(differ),
            "max_abs_err": worst}


def train_tp_planned_bytes(cfg, rules) -> int:
    """This rank's params + mu + nu bytes by ``params_sharding``'s spec
    tree alone (from shapes): three f32 blocks of every leaf."""
    from repro_torch import tree
    from repro_torch.dist import sharding as shd
    from repro_torch.models import model as M
    shapes = M.param_shapes(cfg)
    specs = shd.params_sharding(M.param_axes(cfg), shapes, rules)
    return 3 * sum(4 * math.prod(shd.block_shape(s, spec, rules.mesh))
                   for s, spec in zip(tree.leaves(shapes),
                                      tree.leaves(specs), strict=True))


def train_tp_case(torch, dev, rank: int, job: dict, shape,
                  save: bool = False) -> dict:
    """One mesh: the placed init (leaf by leaf), the train step under
    rules over the job's batches, every kernel wrapper's count set to 0
    just before and read just after (the path launches none); this rank's
    blocks against the single process's, its metrics, bytes and peak; with
    ``save`` the state checkpointed by the launcher's path (gathered, rank
    0 writes, a barrier)."""
    from repro_torch import tree
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.axes import make_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    cfg, ref = job["cfg"], job["ref"][shape]
    mesh = Mesh(shape, ("data", "model"))
    rules = make_rules(mesh)
    fns = train_tp_wrappers()
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=dev, rules=rules)
    ostate = opt.adamw_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_train_step(cfg, train_tp_ocfg(), remat=True, rules=rules)
    params, ostate, metrics, ms = train_tp_steps(
        torch, step, (params, ostate), job["batches"][:TRAIN_TP_STEPS])
    s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    check(not any(launches.values()), f"rank {rank} train_tp {shape}: the "
          f"training path launched {launches}")
    check(metrics == ref["metrics"], f"rank {rank} train_tp {cfg.name} "
          f"{shape}: (loss, grad_norm) {metrics}, the single process "
          f"{ref['metrics']}")
    held = sum(shd.block_data(x).untyped_storage().nbytes()
               for t in (params, ostate.mu, ostate.nu)
               for x in tree.leaves(t))
    planned = train_tp_planned_bytes(cfg, rules)
    check(held == planned, f"rank {rank} train_tp {cfg.name} {shape}: "
          f"params + mu + nu hold {held} B, params_sharding's blocks "
          f"{planned} B")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t1 = time.perf_counter()
    cmp = train_tp_compare(torch, (params, ostate), ref["state"], mesh)
    check(cmp["n_differ"] == 0, f"rank {rank} train_tp {cfg.name} {shape}: "
          f"{cmp['n_differ']} of {cmp['leaves']} leaves differ from the "
          f"single process's ({cmp['differ']}, max |err| "
          f"{cmp['max_abs_err']:.3e})")
    out = {"metrics": metrics, "step_ms": ms, "init_s": init_s, "s": s,
           "bytes": held, "planned": planned, "peak_gib": peak,
           "launches": launches, "compare": cmp,
           "check_s": time.perf_counter() - t1}
    if save:
        t1 = time.perf_counter()
        mgr = CheckpointManager(job["ckpt"])
        mgr.save(TRAIN_TP_STEPS, (params, ostate),
                 metadata={"next_step": TRAIN_TP_STEPS}, rules=rules)
        mgr.close()
        out["save_s"] = time.perf_counter() - t1
    del params, ostate, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_tp_restore(torch, dev, rank: int, job: dict, shape) -> dict:
    """The checkpoint the (1, 4) case wrote, restored onto ``shape`` (each
    rank's blocks of it, memory-mapped) and one more step on the next
    batch, against the single process's third step."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist.axes import make_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    cfg, ref = job["cfg"], job["ref3"]
    mesh = Mesh(shape, ("data", "model"))
    rules = make_rules(mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    template = M.empty_params(cfg, device=dev, rules=rules)
    (params, ostate), meta = CheckpointManager(job["ckpt"]).restore(
        (template, opt.adamw_init(template)), rules=rules)
    del template
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    step = make_train_step(cfg, train_tp_ocfg(), remat=True, rules=rules)
    params, ostate, metrics, ms = train_tp_steps(
        torch, step, (params, ostate),
        job["batches"][meta["next_step"]:][:1])
    check(metrics == ref["metrics"], f"rank {rank} train_tp restored onto "
          f"{shape}: (loss, grad_norm) {metrics}, the single process's "
          f"third step {ref['metrics']}")
    cmp = train_tp_compare(torch, (params, ostate), ref["state"], mesh)
    check(cmp["n_differ"] == 0, f"rank {rank} train_tp restored onto "
          f"{shape}: {cmp['n_differ']} leaves differ from the single "
          f"process's third step ({cmp['differ']})")
    del params, ostate, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"metrics": metrics, "step_ms": ms, "restore_s": restore_s,
            "compare": cmp, "s": time.perf_counter() - t0}


def train_tp_launcher(torch, dev, rank: int, job: dict) -> dict:
    """The train launcher over the ranks (``launch.train.main``, every
    rank with the same arguments, the host mesh over this process group,
    ``host_rules`` resolving the card): straight on (1, 4), then on (2, 2)
    with its checkpoints (``save_async`` gathering on the calling thread
    while rank 0's worker thread writes, the barrier in ``wait``), every
    kernel wrapper's count set to 0 just before and read just after; rank
    0's log and this rank's final blocks against one process's run.  Then
    host 3 fails: ``ckpt.straggler.resume`` restores the latest
    checkpoint onto the survivors' (1, 2) mesh (ranks 2 and 3 idle), and
    one step there at accum x 2 equals one process's step from its own
    final state at accum 2."""
    import io

    import torch.distributed as dist

    from repro_torch.ckpt import straggler
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.synthetic import DataCursor, ShardedLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    cfg, ref = job["cfg"], job["ref"]
    fns = train_tp_wrappers()
    for fn in fns.values():
        fn.launches = 0
    out = {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        straight = launch_train.main(TRAIN_TP_LAUNCH_ARGS
                                     + ["--model-axis", "4"])
        t1 = time.perf_counter()
        saved = launch_train.main(TRAIN_TP_LAUNCH_ARGS + [
            "--model-axis", "2", "--ckpt-dir", job["ckpt"],
            "--ckpt-every", "2"])
    launches = {k: fn.launches for k, fn in fns.items()}
    check(not any(launches.values()), f"rank {rank} train_tp launcher: "
          f"the training path launched {launches}")
    for name, run in (("(1, 4)", straight), ("(2, 2)", saved)):
        got = [x[:3] for x in run["log"]]
        check(got == ref["log"], f"rank {rank} train_tp launcher on "
              f"{name}: log {got}, one process's {ref['log']}")
    cmp = train_tp_compare(torch, (saved["params"], saved["ostate"]),
                           ref["state"], Mesh((2, 2), ("data", "model")))
    check(cmp["n_differ"] == 0, f"rank {rank} train_tp launcher on (2, 2):"
          f" {cmp['n_differ']} of {cmp['leaves']} final leaf blocks differ "
          f"from one process's ({cmp['differ']})")
    steps = CheckpointManager(job["ckpt"]).all_steps()
    check(steps == [2, 4], f"rank {rank} train_tp launcher: checkpoints "
          f"{steps}, not [2, 4]")
    out["launcher"] = {"metrics": [x[1:3] for x in saved["log"]],
                       "s": time.perf_counter() - t0,
                       "straight_s": t1 - t0, "saved_s":
                       time.perf_counter() - t1, "launches": launches,
                       "compare": cmp}
    del straight, saved
    t0 = time.perf_counter()
    plan = straggler.plan_recovery(**TRAIN_TP_RECOVERY)
    r = straggler.resume(plan, CheckpointManager(job["ckpt"]), cfg,
                         accum=1, device=dev)
    check((r is not None) == (rank < 2), f"rank {rank} train_tp "
          f"straggler: member of the recovered mesh {r is not None}")
    row = {"plan": [list(plan.mesh_shape), list(plan.hosts),
                    plan.accum_scale], "member": r is not None}
    if r is not None:
        want = job["straggler"]
        check(r.accum == 2 and r.next_step == 4, f"rank {rank} train_tp "
              f"straggler: accum {r.accum}, next step {r.next_step}")
        step = make_train_step(cfg, launch_ocfg(), accum=r.accum,
                               remat=True, rules=r.rules)
        batch = next(ShardedLoader(cfg, global_batch=2, seq=32,
                                   cursor=DataCursor(index=r.next_step)))
        params, ostate, metrics, ms = train_tp_steps(
            torch, step, (r.params, r.ostate), [batch])
        check(metrics == want["metrics"], f"rank {rank} train_tp straggler:"
              f" (loss, grad_norm) {metrics}, one process's at accum 2 "
              f"{want['metrics']}")
        cmp = train_tp_compare(torch, (params, ostate), want["state"],
                               r.rules.mesh)
        check(cmp["n_differ"] == 0, f"rank {rank} train_tp straggler: "
              f"{cmp['n_differ']} leaf blocks differ from one process's "
              f"({cmp['differ']})")
        row.update(metrics=metrics, step_ms=ms, compare=cmp)
        del params, ostate, step, r
    dist.barrier()       # the idle ranks wait for the survivors' step
    row["s"] = time.perf_counter() - t0
    out["straggler"] = row
    return out


def launch_ocfg():
    """The train launcher's schedule for ``TRAIN_TP_LAUNCH_ARGS``."""
    from repro_torch.optim import optimizers as opt
    return opt.AdamWConfig(lr=3e-4, total_steps=4, warmup_steps=1)


def train_tp_launch_single(torch) -> dict:
    """One process's launcher run (``TRAIN_TP_LAUNCH_ARGS`` on the card):
    its log and final state, and one step from a copy of that state at
    accum 2 on the next batch (the straggler's resume)."""
    import io

    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import DataCursor, ShardedLoader
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import optimizers as opt
    with contextlib.redirect_stdout(io.StringIO()):
        run = launch_train.main(TRAIN_TP_LAUNCH_ARGS)
    cfg = get_smoke_config("llama3.2-1b")
    params, ostate = run["params"], run["ostate"]
    copy = lambda t: tree.tree_map(torch.clone, t)  # noqa: E731
    state = (copy(params), opt.AdamWState(mu=copy(ostate.mu),
                                          nu=copy(ostate.nu),
                                          count=ostate.count.clone()))
    step = make_train_step(cfg, launch_ocfg(), accum=2, remat=True)
    batch = next(ShardedLoader(cfg, global_batch=2, seq=32,
                               cursor=DataCursor(index=4)))
    p, o, metrics, _ = train_tp_steps(torch, step, state, [batch])
    return {"cfg": cfg, "ckpt": str(TRAIN_TP_LAUNCH_DIR),
            "ref": {"log": [x[:3] for x in run["log"]],
                    "state": (params, ostate)},
            "straggler": {"metrics": metrics, "state": (p, o)}}


def train_tp_rank(rank: int, world: int, dev, jobs: dict) -> dict:
    """One rank of phase 20 (``dist.ranks.run_ranks``: cuda:0, gloo): the
    single-process states stay in the parent's memory, mapped here by CUDA
    IPC."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    out = {"entered": time.time()}
    llama = jobs["llama"]
    for shape in TRAIN_TP_MESHES:
        out[f"llama {shape[0]}x{shape[1]}"] = train_tp_case(
            torch, dev, rank, llama, shape, save=shape == (1, 4))
    out["llama restored 2x2"] = train_tp_restore(torch, dev, rank, llama,
                                                 (2, 2))
    out.update(train_tp_launcher(torch, dev, rank, jobs["launcher"]))
    for shape in TRAIN_TP_MESHES:
        out[f"mixtral smoke {shape[0]}x{shape[1]}"] = train_tp_case(
            torch, dev, rank, jobs["mixtral"], shape)
    out["s"] = time.perf_counter() - t0
    return out


def train_tp_single(torch, dev, cfg, batches, shapes, extra: bool) -> dict:
    """The single-process card step's reference for each mesh shape
    (mixtral on a mesh with "data" > 1 dispatches in that many groups, as
    its ranks do: rules over a layout-only mesh, no block); with ``extra``
    one more step from the first shape's state (the restored resume's
    reference)."""
    from repro_torch import tree
    from repro_torch.dist.axes import make_rules
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    out, keyed = {}, {}
    for shape in shapes:
        groups = cfg.num_experts and shape[0] > 1
        key = shape[0] if groups else 1
        if key in keyed:
            out[shape] = keyed[key]
            continue
        rules = make_rules(Mesh(shape, ("data", "model"), rank=0)) \
            if groups else None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = M.init_params(cfg, 0, device=dev)
        ostate = opt.adamw_init(params)
        step = make_train_step(cfg, train_tp_ocfg(), remat=True,
                               rules=rules)
        params, ostate, metrics, ms = train_tp_steps(
            torch, step, (params, ostate), batches[:TRAIN_TP_STEPS])
        keyed[key] = out[shape] = {
            "state": (params, ostate), "metrics": metrics, "step_ms": ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "s": time.perf_counter() - t0}
    if extra:
        params, ostate = out[shapes[0]]["state"]
        copy = lambda t: tree.tree_map(torch.clone, t)  # noqa: E731
        state = (copy(params), opt.AdamWState(
            mu=copy(ostate.mu), nu=copy(ostate.nu),
            count=ostate.count.clone()))
        step = make_train_step(cfg, train_tp_ocfg(), remat=True)
        params, ostate, metrics, ms = train_tp_steps(
            torch, step, state, batches[TRAIN_TP_STEPS:][:1])
        out["third"] = {"state": (params, ostate), "metrics": metrics,
                        "step_ms": ms}
    return out


def phase_train_tp(torch, dev, card: str) -> dict:
    """Phase 20: see the module docstring."""
    from repro_torch import tree
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_config, get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    t0 = time.perf_counter()
    jobs = {}
    for name, cfg, rows, seq in (
            ("llama", dataclasses.replace(get_config("llama3.2-1b"),
                                          num_layers=TP_LLAMA_LAYERS),
             TRAIN_TP_ROWS, TRAIN_TP_TOKENS),
            ("mixtral", get_smoke_config("mixtral-8x22b"),
             TRAIN_TP_SMOKE_ROWS, TRAIN_TP_SMOKE_TOKENS)):
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                   for b in batches_for(cfg, n=TRAIN_TP_STEPS + 1,
                                        batch=rows, seq=seq, split="train")]
        refs = train_tp_single(torch, dev, cfg, batches, TRAIN_TP_MESHES,
                               extra=name == "llama")
        n_params = sum(math.prod(s) for s in tree.leaves(
            M.param_shapes(cfg)))
        r = refs[TRAIN_TP_MESHES[0]]
        print(f"  {cfg.name} ({cfg.num_layers} layers, {n_params} params, "
              f"params + AdamW state {12 * n_params / 1e9:.2f} GB): one "
              f"process, {TRAIN_TP_STEPS} steps of {rows} x {seq} tokens "
              f"with remat: (loss, grad_norm) {r['metrics']}, step ms "
              f"{', '.join(f'{x:.1f}' for x in r['step_ms'])}, peak "
              f"{r['peak_gib']:.2f} GiB"
              + (f"; a third step {refs['third']['metrics']}"
                 if "third" in refs else ""))
        job = {"cfg": cfg, "batches": batches,
               "ref": {s: {k: refs[s][k] for k in ("state", "metrics")}
                       for s in TRAIN_TP_MESHES}}
        if "third" in refs:
            job["ref3"] = {k: refs["third"][k] for k in ("state", "metrics")}
            job["ckpt"] = str(TRAIN_TP_DIR)
            ckpt_bytes = 12 * n_params
            shutil.rmtree(TRAIN_TP_DIR, ignore_errors=True)
            TRAIN_TP_DIR.parent.mkdir(parents=True, exist_ok=True)
            free = shutil.disk_usage(TRAIN_TP_DIR.parent).free
            check(free >= ckpt_bytes + 2 ** 30, f"{TRAIN_TP_DIR}: "
                  f"{free / 1e9:.1f} GB free, phase 20's checkpoint needs "
                  f"{ckpt_bytes / 1e9:.1f} GB")
        jobs[name] = job
    shutil.rmtree(TRAIN_TP_LAUNCH_DIR, ignore_errors=True)
    jobs["launcher"] = train_tp_launch_single(torch)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    print(f"  {TP_WORLD} ranks on cuda:0 over gloo (phase 18's): each rank "
          "holds its blocks of the params and of the AdamW state (made leaf "
          "by leaf), runs the whole batch with each block gathered whole as "
          "its bf16 cast where the model uses it, and gathers each sharded "
          "gradient whole for the global norm; the single process's states "
          "shared by CUDA IPC; the training path launches no hand-written "
          "kernel (every wrapper's count 0 on every rank)")
    t1, spawned = time.perf_counter(), time.time()
    ranks = run_ranks(train_tp_rank, TP_WORLD, args=(jobs,), device="cuda",
                      backend="gloo", timeout=300.0, deadline=600.0)
    t_ranks = time.perf_counter() - t1
    summary = {"cases": {}, "launches": {}}
    launcher = [r.pop("launcher") for r in ranks]
    strag = [r.pop("straggler") for r in ranks]
    summary["launches"]["train_tp launcher"] = {
        k: sum(r["launches"][k] for r in launcher)
        for k in launcher[0]["launches"]}
    summary["launcher"] = {
        "metrics": launcher[0]["metrics"],
        "s": max(r["s"] for r in launcher),
        "straight_s": max(r["straight_s"] for r in launcher),
        "saved_s": max(r["saved_s"] for r in launcher),
        "leaves_equal": sum(r["compare"]["leaves"] - r["compare"]["n_differ"]
                            for r in launcher)}
    print(f"  the train launcher over the {TP_WORLD} ranks (smoke "
          f"llama3.2-1b, {' '.join(TRAIN_TP_LAUNCH_ARGS[3:])}): on (1, 4) "
          f"and on (2, 2) with a checkpoint every 2 steps, every rank's "
          f"log == one process's launcher run "
          f"{summary['launcher']['metrics']}, the (2, 2) final blocks equal "
          f"its state ({summary['launcher']['leaves_equal']} leaf blocks "
          f"over {TP_WORLD} ranks), no kernel launched; "
          f"{summary['launcher']['straight_s']:.2f} s and "
          f"{summary['launcher']['saved_s']:.2f} s")
    members = [r for r in strag if r["member"]]
    summary["straggler"] = {"plan": strag[0]["plan"],
                            "members": len(members),
                            "metrics": members[0]["metrics"],
                            "step_ms": max(r["step_ms"][0] for r in members),
                            "s": max(r["s"] for r in strag)}
    print(f"  host 3 fails: plan (mesh, hosts, accum scale) "
          f"{strag[0]['plan']}; ckpt.straggler.resume restores the "
          f"launcher's step-4 checkpoint onto ranks 0 and 1 (2 and 3 idle), "
          f"one step there at accum 2 {members[0]['metrics']} == one "
          f"process's at accum 2, every block equal; step "
          f"{summary['straggler']['step_ms']:.1f} ms, case "
          f"{summary['straggler']['s']:.2f} s")
    for case in ranks[0]:
        if case in ("entered", "s"):
            continue
        rs = [r[case] for r in ranks]
        row = {"metrics": rs[0]["metrics"],
               "step_ms": [max(r["step_ms"][i] for r in rs)
                           for i in range(len(rs[0]["step_ms"]))],
               "s": max(r["s"] for r in rs),
               "leaves_equal": sum(r["compare"]["leaves"]
                                   - r["compare"]["n_differ"] for r in rs)}
        for k in ("bytes", "peak_gib", "init_s", "save_s", "restore_s"):
            if k in rs[0]:
                row[k] = [r[k] for r in rs]
        if "launches" in rs[0]:
            summary["launches"][f"train_tp {case}"] = {
                k: sum(r["launches"][k] for r in rs)
                for k in rs[0]["launches"]}
        summary["cases"][case] = row
        print(f"  {case}: every rank's blocks equal the single process's "
              f"({row['leaves_equal']} leaf blocks over {TP_WORLD} ranks, "
              f"params, mu, nu and count), (loss, grad_norm) "
              f"{row['metrics']} == one process's on every rank; step ms "
              f"{', '.join(f'{x:.1f}' for x in row['step_ms'])} (the "
              f"slowest rank; gloo through the host on one card: not a TP "
              f"speed)"
              + (f"; state bytes a rank {row['bytes']} == params_sharding's "
                 "blocks" if "bytes" in row else "")
              + (f"; init leaf by leaf {max(row['init_s']):.2f} s"
                 if "init_s" in row else "")
              + (f"; checkpoint written in {max(row['save_s']):.2f} s"
                 if "save_s" in row else "")
              + (f"; restored onto the mesh in "
                 f"{max(row['restore_s']):.2f} s" if "restore_s" in row
                 else "")
              + (f"; peak {max(row['peak_gib']):.2f} GiB a rank"
                 if "peak_gib" in row else "")
              + f"; case {row['s']:.2f} s")
    # the checkpoint the ranks wrote on (1, 4), into one process
    llama = jobs["llama"]
    t1 = time.perf_counter()
    cfg = llama["cfg"]
    template = M.empty_params(cfg, device=dev)
    (params, ostate), meta = CheckpointManager(TRAIN_TP_DIR).restore(
        (template, opt.adamw_init(template)))
    del template
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t1
    from repro_torch.ckpt.checkpoint import flatten_state
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_state((params, ostate)),
        flatten_state(llama["ref"][(1, 4)]["state"]), strict=True))
    check(same, "train_tp: the ranks' checkpoint restored into one process "
          "differs from the state the single process reached")
    step = make_train_step(cfg, train_tp_ocfg(), remat=True)
    params, ostate, metrics, _ = train_tp_steps(
        torch, step, (params, ostate),
        llama["batches"][meta["next_step"]:][:1])
    want = llama["ref3"]
    check(metrics == want["metrics"] and all(
        torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_state((params, ostate)), flatten_state(want["state"]),
            strict=True)), "train_tp: one more step of one process from "
          "the ranks' checkpoint differs from its own third step")
    summary["one_process_resume"] = {"metrics": metrics,
                                     "restore_s": restore_s}
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"  the ranks' (1, 4) checkpoint ({12 * n_params / 1e9:.2f} GB) "
          f"restored into one process in {restore_s:.2f} s equals its own "
          f"state; one more step from it {metrics} == its third step, bit "
          "for bit (and the (2, 2) ranks' step from it above)")
    print(f"  the single processes {t_ref:.1f} s, the ranks {t_ranks:.1f} s "
          f"(started and joined in "
          f"{max(r['entered'] for r in ranks) - spawned:.1f} s, their work "
          f"{max(r['s'] for r in ranks):.1f} s)")
    del jobs, llama, params, ostate, ranks, step
    shutil.rmtree(TRAIN_TP_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_TP_LAUNCH_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    summary["s"] = time.perf_counter() - t0
    return summary


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

    print("[1/21] device")
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

    print("[2/21] build")
    from repro_torch.kernels._build import ENTRY_POINTS, build, library
    t0 = time.perf_counter()
    build()
    for name in ENTRY_POINTS:
        library(name)
    print(f"  kernels built ({', '.join(ENTRY_POINTS)}: one nvcc each, in "
          f"parallel) and loaded in {time.perf_counter() - t0:.1f} s")
    spills = ptxas_report(ptxas_text())
    print(f"  ptxas, flash_decode_kernel at D 112 or G 1 (registers, spill "
          f"store bytes, spill load bytes), {time.perf_counter() - t0:.1f} s "
          "with the build: " + "; ".join(f"{k} {v}"
                                        for k, v in sorted(spills.items())))

    print(f"[3/21] kernels against their plain versions [{card}]")
    from repro_torch.configs.base import (ModelConfig, get_config,
                                         get_smoke_config)
    t0 = time.perf_counter()
    mm = phase_nm_matmul(torch, dev)
    mask = phase_nm_mask24(torch, dev)
    expert = phase_nm_matmul_expert(torch, dev)
    from repro_torch.kernels.nm_spmm import LAYOUT_PACKED2
    E64, shapes64, ms64 = DEEPSEEK_EXPERTS
    expert["by_path"] = {DEEPSEEK: phase_nm_matmul_expert(
        torch, dev, E64, shapes64, ms64, (LAYOUT_PACKED2,), DEEPSEEK)}
    expert["max_abs_err"] = max(expert["max_abs_err"],
                                expert["by_path"][DEEPSEEK]["max_abs_err"])
    calib_paths = {"llama3.2-1b": calib_leaves(get_config("llama3.2-1b")),
                   "llama3.2-1b smoke": calib_leaves(
                       get_smoke_config("llama3.2-1b")),
                   # one layer's up bank of mixtral-8x22b: the search's
                   # (L*E*K, N) view of an expert-bank leaf
                   "mixtral-8x22b expert bank": {"up": EXPERT_LEAF},
                   # phase 9's system test: tests/test_system.py's model,
                   # checked only (its leaves are ~55-300 KB: timing them
                   # past the L2 takes up to ~1900 copies a shape)
                   "system test": calib_leaves(ModelConfig(**SYS_CFG))}
    prox = phase_prox24(torch, dev, calib_paths, untimed=("system test",))
    fused = phase_saliency(torch, dev, calib_paths, untimed=("system test",))
    flash = phase_flash_decode(torch, dev)
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[4/21] full-width llama3.2-1b 2:4 serving [{card}]")
    t0 = time.perf_counter()
    llama = phase_serve(torch, dev, card, get_config("llama3.2-1b"),
                        long_cache=True)
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[5/21] full-width mixtral-8x22b ({MIXTRAL_LAYERS} of 56 layers) "
          f"2:4 MoE serving [{card}]")
    t0 = time.perf_counter()
    moe = phase_serve(torch, dev, card, dataclasses.replace(
        get_config("mixtral-8x22b"), num_layers=MIXTRAL_LAYERS))
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[6/21] full-width llama3.2-1b calibration -> bank -> 2:4 serving "
          f"[{card}]")
    t0 = time.perf_counter()
    phase_calibrate_card_vs_cpu(torch, dev)
    stoch_draws_card_vs_cpu(torch, dev)
    calib = phase_calibrate(torch, dev, card)
    print(f"  phase took {time.perf_counter() - t0:.1f} s")

    torch.cuda.empty_cache()
    print(f"[7/21] the fleet: phase 6's bank at budgets {FLEET_BUDGETS}, "
          f"pinned, A/B and self-speculative [{card}]")
    t0 = time.perf_counter()
    fleet = phase_fleet(torch, dev, card, calib["bank"])
    t_fleet = time.perf_counter() - t0
    print(f"  phase took {t_fleet:.1f} s")

    torch.cuda.empty_cache()
    print(f"[8/21] the paper's evaluation at full width: eval_ppl, the "
          f"unstructured search, baselines, the Eq. 8 ablation, the "
          f"launcher's --sparse and --temperature, MoE calibration [{card}]")
    t0 = time.perf_counter()
    # phase 6's bank: phase 8 takes the last reference and drops it once
    # its 2:4 weights are made
    evalr = phase_eval(torch, dev, card, calib.pop("bank"))
    shutil.rmtree(_banks_dir(), ignore_errors=True)
    t_eval = time.perf_counter() - t0
    print(f"  phase took {t_eval:.1f} s")

    torch.cuda.empty_cache()
    print(f"[9/21] training: the launcher at full width, its resume, the "
          f"system test on a model the card trained, moe-tiny [{card}]")
    t0 = time.perf_counter()
    trained = phase_train(torch, dev, card)
    t_train = time.perf_counter() - t0
    print(f"  phase took {t_train:.1f} s")

    torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    print(f"[10/21] gemma and yi: gemma3-1b, yi-6b and gemma2-2b 2:4 serving "
          f"at their published widths, the trained gemma-tiny card vs CPU "
          f"[{card}]")
    t0 = time.perf_counter()
    gemma = phase_gemma_yi(torch, dev, card)
    t_gemma = time.perf_counter() - t0
    print(f"  phase took {t_gemma:.1f} s")

    torch.cuda.empty_cache()
    print("[11/21] committed mask bank at smoke width, card vs CPU")
    phase_bank(torch, dev)

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[12/21] {DEEPSEEK} ({DEEPSEEK_LAYERS} of its 27 layers, MLA, 64 "
          f"experts top-6 + 2 shared) 2:4 serving at its published widths, "
          f"the smoke config card vs CPU [{card}]")
    t0 = time.perf_counter()
    deep = phase_deepseek(torch, dev, card)
    t_deep = time.perf_counter() - t0
    print(f"  phase took {t_deep:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[13/21] the flight recorder (obs): its decode overhead, launches "
          f"and captures off vs on, the decode-step clock, dist.psum at "
          f"kv_shards 1 / 4, the fleet's percentiles, both launchers' "
          f"traces [{card}]")
    t0 = time.perf_counter()
    obsr = phase_obs(torch, dev, card)
    # phase 6's bank served phases 7, 8 and 13
    shutil.rmtree(BANK_DIR.parent, ignore_errors=True)
    t_obs = time.perf_counter() - t0
    print(f"  phase took {t_obs:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[14/21] the recurrent families: {ZAMBA} ({ZAMBA_LAYERS} of 81 "
          f"layers: Mamba2 + the LoRA-shared attention, decode attention at "
          f"G 1, D 112) "
          f"and {XLSTM} whole (mLSTM / sLSTM) 2:4 serving at their "
          f"published widths, the smoke configs card vs CPU [{card}]")
    t0 = time.perf_counter()
    rec = phase_recurrent(torch, dev, card)
    t_rec = time.perf_counter() - t0
    print(f"  phase took {t_rec:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    # phase 17's dry run on this host's CPU, beside phases 15-17's card work
    dry = start_dryrun(torch, dev)
    try:
        print(f"[15/21] the last two families: {WHISPER} whole (12 encoder "
              f"layers over {WHISPER_FRAMES} frames + 12 decoder layers, "
              f"decode attention at G 1, D 64 on its self ring and cross "
              f"cache) and {PIXTRAL} ({PIXTRAL_LAYERS} of 40 layers, the "
              f"256-token vision prefix) 2:4 through the serve launcher and "
              f"{PIXTRAL}'s engine at their published widths, the smoke "
              f"configs card vs CPU [{card}]")
        t0 = time.perf_counter()
        encdec = phase_encdec_vision(torch, dev, card)
        t_encdec = time.perf_counter() - t0
        print(f"  phase took {t_encdec:.1f} s")

        gc.collect()
        torch.cuda.empty_cache()
        print(f"[16/21] the train step at the published widths of gemma3-1b "
              f"(6 of 26 layers), {DEEPSEEK} (2 of 27), {ZAMBA} (6 of 81), "
              f"{XLSTM} and {WHISPER} whole, then each smoke config card vs "
              f"CPU [{card}]")
        t0 = time.perf_counter()
        trainf = phase_train_families(torch, dev, card)
        t_trainf = time.perf_counter() - t0
        print(f"  phase took {t_trainf:.1f} s")

        gc.collect()
        torch.cuda.empty_cache()
        print(f"[17/21] static analysis at llama3.2-1b's published widths: "
              f"the decode surface audited and planned on meta, then held "
              f"on the card (launches per step against the profiler, host "
              f"syncs and upcasts of the captured step, params + caches, "
              f"one step's peak, shared memory), launch.dryrun of its four "
              f"cells [{card}]")
        t0 = time.perf_counter()
        ana = phase_analysis(torch, dev, card, dry)
        t_ana = time.perf_counter() - t0
        print(f"  phase took {t_ana:.1f} s")
    finally:
        stop_dryrun(dry)

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[18/21] tensor parallelism: llama3.2-1b ({TP_LLAMA_LAYERS} of 16 "
          f"layers) and mixtral-8x22b ({MIXTRAL_LAYERS} of 56 layers) 2:4 at "
          f"their published widths served by {TP_WORLD} ranks "
          f"under rules on meshes {TP_MESHES} (llama also forced "
          f"replicated), against the single-process engine [{card}]")
    t0 = time.perf_counter()
    tp = phase_tp(torch, dev, card)
    t_tp = time.perf_counter() - t0
    print(f"  phase took {t_tp:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[19/21] the UniPruning search over ranks: llama3.2-1b "
          f"({TP_LLAMA_LAYERS} of 16 layers) at its published widths, wanda "
          f"2:4, {CALIB_TP_STEPS} steps, on {TP_WORLD} ranks under rules on "
          f"meshes {CALIB_TP_MESHES} and the calibrate launcher's --mesh "
          f"host (4, 1), against the single-process search [{card}]")
    t0 = time.perf_counter()
    ctp = phase_calib_tp(torch, dev, card)
    t_ctp = time.perf_counter() - t0
    print(f"  phase took {t_ctp:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    print(f"[20/21] training over ranks: llama3.2-1b ({TP_LLAMA_LAYERS} of 16 "
          f"layers) at its published widths and smoke mixtral-8x22b, "
          f"{TRAIN_TP_STEPS} AdamW steps on {TP_WORLD} ranks under rules on "
          f"meshes {TRAIN_TP_MESHES}, a checkpoint written on (1, 4) "
          f"restored onto (2, 2) and into one process, the train launcher "
          f"over the ranks and the straggler's recovered mesh, against "
          f"the single-process train step [{card}]")
    t0 = time.perf_counter()
    ttp = phase_train_tp(torch, dev, card)
    t_ttp = time.perf_counter() - t0
    print(f"  phase took {t_ttp:.1f} s")

    print("[21/21] summary")
    served = {"llama3.2-1b": llama, "mixtral-8x22b": moe,
              **{arch: gemma[arch] for arch, _ in GEMMA_YI},
              DEEPSEEK: deep, ZAMBA: rec[ZAMBA], XLSTM: rec[XLSTM],
              f"{PIXTRAL} engine": encdec[PIXTRAL]["engine"]}
    paths = {"calibrate llama3.2-1b": calib["launches"]}
    for name, run in served.items():
        paths[name] = run["launches"]
        for S, r in run["kv_runs"].items():
            paths[f"{name} kv_shards={S}"] = r["launches"]
    # phase 15's launcher paths, each kv_shards path counted on its own
    for name in (WHISPER, PIXTRAL):
        for S, r in encdec[name]["paths"].items():
            paths[f"{name} launcher kv_shards={S}"] = {
                k: v for k, v in r["launches"].items() if v}
    for S, r in fleet["by_kv"].items():
        paths[f"fleet llama3.2-1b kv_shards={S}"] = r["launches"]
    # phase 17's: the eager steps it measured, the captures' warm-ups and
    # captures at kv_shards None and 1, and the mask export
    paths["analysis llama3.2-1b"] = {k: v for k, v in
                                     ana["launches"].items() if v}
    # phase 18's: each tensor-parallel case, launches summed over the ranks
    paths.update(tp["paths"])
    # phase 19's: each sharded search case, launches summed over the ranks
    paths.update(ctp["paths"])
    # phase 8's, 9's and 10's paths, each with the kernels it launched
    for name, launched in {**evalr["launches"], **trained["launches"],
                           **gemma["launches"],
                           **deep["smoke_launches"],
                           **rec["smoke_launches"],
                           **encdec["smoke_launches"]}.items():
        paths[name] = {k: v for k, v in launched.items() if v}
    # kernel launches the profiler saw on the CUDA-graph engine's runs of
    # phases 4-5's and 10's paths (2 requests), replays included, by
    # kernel function (nm_mma_kernel serves both 2:4 wrappers,
    # flash_decode_kernel both decode attention wrappers)
    graph_paths = {(name if S is None else f"{name} kv_shards={S}"):
                   g["launches"]
                   for name, run in served.items()
                   for S, g in run["graph_runs"].items()}

    def flash_row(name, case, S):
        rows = [r for r in flash["rows"] if name in r]
        head = next(r for r in rows if r["case"] == case and r["S"] == S)
        return {**head[name], "by_case": [
            {k: r[k] for k in ("case", "B", "K", "G", "D", "C", "S",
                               "splits")} | r[name] for r in rows]}

    def counts(name):
        by = {k: v[name] for k, v in paths.items() if name in v}
        graph_key = {"nm_matmul": "nm_spmm", "nm_matmul_expert": "nm_spmm",
                     "flash_decode": "flash_decode",
                     "flash_decode_partial": "flash_decode",
                     "combine_partials": "combine_partials"}.get(name)
        out = {"launches": sum(by.values()), "launches_by_path": by}
        if graph_key:
            out["graph_replay_launches_by_path"] = {
                k: v[graph_key] for k, v in graph_paths.items()
                if by.get(k)}
        return out

    kernels = [
        {"name": "nm_matmul", "route": "cuda",
         "tp_profiler_launches_per_step": tp["profiled"],
         "source": "src/repro_torch/csrc/nm_spmm.cu",
         "replaces": "src/repro/kernels/nm_spmm.py:126",
         **counts("nm_matmul"), **mm,
         "work": "one llama decode layer: wq, wk, wv, wo, up, gate, down "
                 "at M=4 (4 slots), packed2, bf16; by_path: one decode "
                 "layer's projections on each path (deepseek-v2-lite-16b: "
                 "an mla_moe layer's wq, w_dkv, wo, shared up / gate / "
                 "down, and every timed shape in its rows; zamba2-7b: a "
                 "mamba layer's in_proj and out_proj and the shared block's "
                 "7; xlstm-125m: an mLSTM and an sLSTM layer's 9; "
                 "whisper-small: a decoder layer's 7 at M 4, 128 and the "
                 "encoder's 6144; pixtral-12b: a layer's 7 at M 4 and "
                 "1280)"},
        {"name": "nm_matmul_expert", "route": "cuda",
         "tp_profiler_launches_per_step": tp["profiled"],
         "source": "src/repro_torch/csrc/nm_spmm.cu",
         "replaces": "src/repro/kernels/nm_spmm.py:202",
         **counts("nm_matmul_expert"), **expert,
         "work": "one mixtral decode layer: up, gate, down banks, E=8, "
                 "M=C=4 (4 slots), packed2, bf16; by_path: one "
                 "deepseek-v2-lite-16b layer's banks at E=64, C 4 and 16"},
        {"name": "nm_mask24", "route": "cuda",
         "calib_tp_profiler_launches": ctp["profiled"],
         "calib_tp_shard_local_calls": ctp["calls"],
         "source": "src/repro_torch/csrc/nm_mask24.cu",
         "replaces": "src/repro/kernels/nm_prox.py:82",
         **counts("nm_mask24"), **mask,
         "work": "f32 scores (16*2048, 8192) -> bool keep-mask"},
        {"name": "prox24", "route": "cuda",
         "calib_tp_profiler_launches": ctp["profiled"],
         "calib_tp_shard_local_calls": ctp["calls"],
         "source": "src/repro_torch/csrc/prox24.cu",
         "replaces": "src/repro/kernels/nm_prox.py:46",
         **counts("prox24"), **prox,
         "work": "one full-width llama3.2-1b search step: the 7 prunable "
                 "leaves as (16*K, N) f32 views, in place, lam 1e-2, 12 "
                 "iterations; by_path: one step on each calibration path"},
        {"name": "saliency_fused_step", "route": "cuda",
         "calib_tp_profiler_launches": ctp["profiled"],
         "calib_tp_shard_local_calls": ctp["calls"],
         "source": "src/repro_torch/csrc/saliency_fuse.cu",
         "replaces": "src/repro/kernels/saliency_fuse.py:49",
         **counts("saliency_fused_step"), **fused,
         "work": "one full-width llama3.2-1b search step: the 7 prunable "
                 "leaves, wanda scores over the median divisor, V and Gamma "
                 "f32 in place; by_path: one step on each calibration path"},
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:58",
         **counts("flash_decode"),
         **flash_row("flash_decode", "llama serving", 1),
         "graph_step_ms": {name: {
             **{f"C256 kv_shards={S}": r["graph_ms"]
                for S, r in run["steps_by_kv"].items()},
             **{f"C{LONG_CAPACITY} kv_shards={S}": r["graph_ms"]
                for S, r in (run["long_cache"] or {}).items()}}
             for name, run in served.items() if name != "mixtral-8x22b"},
         "work": "one llama3.2-1b decode layer's attention at serving: "
                 "B=4 slots, 8 kv heads x 4 query heads of 64, C=256, bf16; "
                 "by_case: every phase-3 case, gemma3-1b's 1 kv head x 4 "
                 "of 256, yi-6b's 4 kv heads x 8 of 128, zamba2-7b's "
                 "32 kv heads x 1 of 112, whisper-small's 12 kv heads x 1 "
                 "of 64 (its self ring and 1536-slot cross cache) and "
                 "pixtral-12b's 8 kv heads x 4 of 128 included; library: "
                 "F.scaled_dot_product_attention (enable_gqa)"},
        {"name": "flash_decode_partial", "route": "cuda",
         "tp_profiler_launches_per_step": tp["profiled"],
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:140",
         **counts("flash_decode_partial"),
         **flash_row("flash_decode_partial", "llama serving", 4),
         "work": "the same at kv_shards=4: (acc, m, l) of 4 capacity shards "
                 "in one launch"},
        {"name": "flash_decode_combine", "route": "cuda",
         "tp_profiler_launches_per_step": tp["profiled"],
         "source": "src/repro_torch/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/shard.py:327",
         **counts("combine_partials"),
         **flash_row("combine_partials", "llama serving", 4),
         "work": "the 4 shards' partials of the same layer -> bf16 output; "
                 "replaces the pmax/psum combine of shard.py:327-330, which "
                 "has no Pallas counterpart"},
    ]
    print(f"  {time.perf_counter() - t_start:.1f} s in all (the fleet phase "
          f"{t_fleet:.1f} s, the evaluation phase {t_eval:.1f} s, the "
          f"training phase {t_train:.1f} s, the gemma and yi phase "
          f"{t_gemma:.1f} s, the deepseek phase {t_deep:.1f} s, the "
          f"recorder's phase {t_obs:.1f} s, the recurrent phase "
          f"{t_rec:.1f} s, the encoder-decoder and vision phase "
          f"{t_encdec:.1f} s, the train-families phase {t_trainf:.1f} s, "
          f"the analysis phase {t_ana:.1f} s, the tensor-parallel phase "
          f"{t_tp:.1f} s, the sharded search phase {t_ctp:.1f} s, the "
          f"sharded training phase {t_ttp:.1f} s)")
    # phase 8's evaluation, on a line of its own
    print(json.dumps({"evaluation": {
        "llama3.2-1b": {k: {x: r[x] for x in ("ppl", "nll", "s", "tok_s")}
                        for k, r in evalr["rows"].items()},
        "moe-tiny 2:4": evalr["moe_tiny"], "peak_gib": evalr["peak_gib"]}}))
    # phase 9's training, on a line of its own
    print(json.dumps({"training": {
        k: v for k, v in trained.items() if k != "launches"}}))
    # phase 10's serving, on a line of its own (the CUDA-graph decode
    # step's ms paired across kv_shards, prefill, peak memory)
    print(json.dumps({"gemma_yi": {
        **{arch: {"prefill_ms": r["prefill_ms"], "peak_gib": r["peak_gib"],
                  "eager_step_ms": r["step_ms"], "s": r["s"],
                  "graph_ms": {str(S): v["graph_ms"]
                               for S, v in r["steps_by_kv"].items()},
                  "long_graph_ms": {str(S): v["graph_ms"]
                                    for S, v in (r["long_cache"]
                                                 or {}).items()},
                  "graph_tok_s": {str(S): g["tok_s"]
                                  for S, g in r["graph_runs"].items()},
                  "verify": r["verify"]}
           for arch, r in ((a, gemma[a]) for a, _ in GEMMA_YI)},
        "gemma-tiny": gemma["gemma-tiny"], "ptxas": spills}}))
    # phase 12's serving, on a line of its own
    print(json.dumps({"deepseek": {
        "prefill_ms": deep["prefill_ms"], "peak_gib": deep["peak_gib"],
        "peak_gib_with_masked_dense": deep["pinned"]["peak_gib"],
        "eager_step_ms": deep["step_ms"], "s": deep["s"],
        "build_s": deep["build_s"], "export_s": deep["export_s"],
        "graph_ms": deep["steps_by_kv"][None]["graph_ms"],
        "long_graph_ms": deep["long_cache"][None]["graph_ms"],
        "graph_tok_s": deep["graph_runs"][None]["tok_s"],
        "pinned": deep["pinned"], "verify": deep["verify"],
        "smoke": deep["smoke"]}}))
    # phase 13's recorder figures, on a line of its own
    print(json.dumps({"obs": obsr}))
    # phase 14's serving, on a line of its own
    print(json.dumps({"recurrent": {arch: {
        "prefill_ms": r["prefill_ms"], "peak_gib": r["peak_gib"],
        "peak_gib_with_masked_dense": r["pinned"]["peak_gib"],
        "eager_step_ms": r["step_ms"], "s": r["s"],
        "build_s": r["build_s"], "export_s": r["export_s"],
        "graph_ms": {str(S): v["graph_ms"]
                     for S, v in r["steps_by_kv"].items()},
        "long_graph_ms": {str(S): v["graph_ms"]
                          for S, v in (r["long_cache"] or {}).items()},
        "graph_tok_s": {str(S): g["tok_s"]
                        for S, g in r["graph_runs"].items()},
        "pinned": r["pinned"], "smoke": r["smoke"]}
        for arch, r in ((a, rec[a]) for a in (ZAMBA, XLSTM))}}))
    # phase 15's launcher paths and pixtral's engine, on a line of its own
    eng = encdec[PIXTRAL]["engine"]
    print(json.dumps({"encdec_vision": {
        **{name: {"paths": {str(S): {k: v for k, v in r.items()
                                     if k != "launches"}
                            for S, r in encdec[name]["paths"].items()},
                  "by_layer": encdec[name]["by_layer"],
                  "end_to_end_masked_ulps":
                      encdec[name]["end_to_end_masked_ulps"],
                  "s": encdec[name]["s"]}
           for name in (WHISPER, PIXTRAL)},
        WHISPER + " peak_gib": encdec[WHISPER]["peak_gib"],
        PIXTRAL + " layers": PIXTRAL_LAYERS,
        PIXTRAL + " engine": {
            "prefill_ms": eng["prefill_ms"], "peak_gib": eng["peak_gib"],
            "peak_gib_with_masked_dense": eng["pinned"]["peak_gib"],
            "eager_step_ms": eng["step_ms"], "build_s": eng["build_s"],
            "graph_ms": {str(S): v["graph_ms"]
                         for S, v in eng["steps_by_kv"].items()},
            "graph_tok_s": {str(S): g["tok_s"]
                            for S, g in eng["graph_runs"].items()},
            "pinned": {k: v for k, v in eng["pinned"].items()
                       if k != "free_by_depth"}},
        "smoke": {k: v for k, v in encdec["smoke"].items()}}}))
    # phase 16's training, on a line of its own
    print(json.dumps({"train_families": {**trainf, "s": t_trainf}}))
    # phase 17's static analysis, on a line of its own
    print(json.dumps({"analysis": {**{k: v for k, v in ana.items()
                                      if k != "card"}, "s": t_ana}}))
    # phase 18's tensor parallelism, on a line of its own
    print(json.dumps({"tensor_parallel": {"cases": tp["cases"],
                                          "s": t_tp}}))
    # phase 19's sharded search, on a line of its own
    print(json.dumps({"calib_tp": {"cases": ctp["cases"], "s": t_ctp}}))
    # phase 20's sharded training, on a line of its own (no kernel: every
    # wrapper's launches over the ranks, all 0)
    print(json.dumps({"train_tp": {**ttp, "s": t_ttp}}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
