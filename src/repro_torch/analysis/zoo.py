"""Whole-zoo dry run: calibrate -> bank -> sparsify -> decode -> fleet.

Port of ``repro.analysis.zoo`` without a mesh.  One static pass per config
family proving the UniPruning pipeline feasible before any card-hour
burns: every stage either runs on the ``meta`` device (shapes only: no
weights made, no FLOPs spent) or at smoke scale where packing needs real
values (mask thresholding, 2:4 compression: seconds on the CPU).  The
per-family facts pinned by the port's code (prunable leaf counts, kernel
layouts, the compression ratio, collectives per site, kernel calls per
site, static memory totals) land in golden manifests under
``analysis/golden/zoo/`` that ``run_zoo`` diffs; volatile facts (the torch
version) stay under ``info``.

Stages per family:

* ``calibrate`` - the stats pass on meta and the SearchState bytes
  (``memplan.search_state_bytes``, the reference's figure exactly);
* ``bank`` - a MaskBank over magnitude scores re-thresholded at two
  budgets (2:4 + 0.5 unstructured; two unstructured budgets for a family
  whose kernels cannot take 2:4), exercising the bounded mask cache;
* ``sparsify`` - 2:4 compression through ``sparse.apply``
  (``compressed_report``): kernel-native packed vs fallback leaves and the
  compressed-bytes ratio;
* ``engine_decode`` - the decode surface audited and planned on meta
  (host syncs, collectives per site, the kernels per site and per call,
  the static memory total, ``fits_card``).  ``pallas_calls`` is the
  per-site count on the reference's CPU route (a pair over one input is
  one call there: ``analysis.audit``); ``param_cast_bytes`` the bytes
  ``model.serving_params`` takes off the engine's params (the reference's
  engine keeps them as given), so ``arg_bytes + param_cast_bytes`` is the
  reference's ``arg_bytes``.  An encoder-decoder family (whisper) cannot
  use the slot engine: a structured skip that audits
  ``models.model.decode_step`` directly;
* ``fleet`` - N budgets from ONE bank share the untouched leaves by
  identity (``sparse.apply.shared_leaves``);
* ``shardcheck`` - the reference's single-device skip.

The reference's ``fits_16gb`` is a TPU v5e budget: the port reports
``fits_card`` against one H100 (80 GB nominal, ``memplan.CARD_BYTES``)
and compares neither with the reference, nor its planner's
``static_total_bytes``.

The reference's production AOT loop (``build_cell`` / ``run_cell`` /
``run_cells_main``) is a meta-device pass here: for each family at its
published config and each ``SHAPE_CELLS`` entry, the parameter bytes (f32
for training; bf16 and 2:4 compressed for serving), the cache bytes
(``launch.steps.cache_specs``), the AdamW state for a train cell, the
planner's peak for the cell's step and ``fits_card``.  The step is
planned at one and two layers a stage and carried linearly to the
stage's depth (the reference's scan plans its layer body once; the peak
is linear in the depth: ``tests/test_torch_zoo.py`` holds it at a third),
a train cell over two of its microbatches (each later one repeats the
second).  Each cell is planned at its own sequence length: xlstm's
sLSTM time loop makes its train and prefill cells the slowest to plan
(minutes of host time).  ``launch/dryrun.py`` is the CLI over it.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Any

import torch

from repro_torch import tree
from repro_torch.analysis import audit, memplan, surfaces
from repro_torch.configs.base import (ARCH_IDS, SHAPE_CELLS, ModelConfig,
                                      PruneConfig, ShapeCell, get_config,
                                      get_smoke_config)

PyTree = Any

__all__ = ["family_report", "build_zoo_manifest", "zoo_diff", "golden_path",
           "run_zoo", "reference_diff", "cell_skipped", "build_cell",
           "run_cell", "run_cells_main", "format_cells", "LONG_OK",
           "ZOO_DIR"]

ZOO_DIR = pathlib.Path(__file__).resolve().parent / "golden" / "zoo"

# budgets every family's bank is re-thresholded at (stages bank / fleet);
# families whose kernels cannot take 2:4 (a reduction dim % 4 != 0) swap
# the n:m budget for a second unstructured one
_BUDGETS = ((2, 4), 0.5)
_BUDGETS_UNSTRUCTURED = (0.25, 0.5)

# the reference golden's fields the port's report equals value for value
# (``reference_diff``); the others differ for representational reasons
REFERENCE_STAGE_FIELDS = {
    "calibrate": ("status", "param_leaves", "param_bytes", "stats_leaves",
                  "search_state_bytes"),
    "bank": ("status", "budgets", "prunable_leaves", "mask_cache_entries"),
    "sparsify": ("status", "sparse_leaves", "kernel_native_packed",
                 "fallback_leaves", "bytes_compressed", "bytes_dense_bf16",
                 "ratio", "reason"),
    "engine_decode": ("status", "surface", "sparse", "host_callbacks",
                      "psums_by_site", "collectives", "pallas_calls",
                      "out_bytes"),
    "fleet": ("status", "shared_leaves", "total_leaves",
              "mask_cache_entries"),
    "shardcheck": ("status", "reason"),
}


# ---------------------------------------------------------------------------
# Per-family pipeline stages
# ---------------------------------------------------------------------------

def _surrogate_bank(cfg, params):
    """In-memory MaskBank over magnitude scores: the static stand-in for a
    calibrated bank (same tree structure, deterministic, no search)."""
    from repro_torch.core import metrics as metrics_mod
    from repro_torch.core.prunable import prunable_map
    from repro_torch.sparse.bank import MaskBank
    pr = prunable_map(params)
    scores = metrics_mod.metric_tree(
        "magnitude", params, tree.tree_map(lambda _: None, pr), pr)
    V = tree.tree_map(lambda g: None if g is None else torch.zeros_like(g),
                      scores)
    return MaskBank(cfg, PruneConfig(mode="nm"), scores, V, None,
                    {"surrogate": True})


def _stage_calibrate(cfg, arch: str) -> dict:
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import model as M
    shapes = memplan.params_meta(cfg)
    leaves = audit.tensors(shapes)
    b = batches_for(cfg, n=1, batch=2, seq=16, split="calib")[0]
    batch = {k: torch.empty(v.shape, dtype=torch.as_tensor(v[:0]).dtype,
                            device="meta") for k, v in b.items()}
    stats = M.stats_sumsq(cfg, shapes, batch)
    n_stats = sum(x is not None for x in tree.leaves(stats))
    return {"status": "ok", "param_leaves": len(leaves),
            "param_bytes": audit.tree_bytes(shapes),
            "stats_leaves": n_stats,
            "search_state_bytes": memplan.search_state_bytes(arch)}


def _nm_infeasible(scores) -> str | None:
    """First prunable leaf whose reduction dim breaks 2:4 grouping, if any
    (xlstm's ff_down K = 85): n:m masks cannot exist for the family."""
    for path, leaf in tree.flatten_with_path(scores):
        if leaf is not None and leaf.shape[-2] % 4:
            return f"{path} K={leaf.shape[-2]} % 4 != 0"
    return None


def _stage_bank(bank, budgets) -> dict:
    for budget in budgets:
        if isinstance(budget, tuple):
            bank.masks_at(nm=budget)
        else:
            bank.masks_at(sparsity=budget)
    n_prunable = sum(x is not None for x in tree.leaves(bank.Gamma))
    return {"status": "ok", "budgets": len(budgets),
            "prunable_leaves": n_prunable,
            "mask_cache_entries": len(bank._mask_cache)}


def _stage_sparsify(cfg, params, bank) -> tuple[dict, PyTree]:
    from repro_torch.models import model as M
    from repro_torch.sparse import apply as apply_mod
    masks = bank.masks_at(nm=_BUDGETS[0])
    sparse = apply_mod.sparsify_params(
        params, masks, axes=M.param_axes(cfg), idx_bits=2,
        dtype=torch.bfloat16)
    rep = apply_mod.compressed_report(sparse, masks)
    return ({"status": "ok",
             "sparse_leaves": len(rep["layers"]),
             "kernel_native_packed": rep["kernel_native_packed"],
             "fallback_leaves": rep["fallback_leaves"],
             "bytes_compressed": rep["bytes_compressed"],
             "bytes_dense_bf16": rep["bytes_dense_bf16"],
             "ratio": round(rep["ratio"], 6) if rep["ratio"] else None},
            sparse)


def _audit_and_plan(fn, args, name: str):
    """(audit report, memory plan) of one call on meta."""
    fn, args = audit.fn_to_device(fn, "meta"), audit.to_device(args, "meta")
    rec, out = audit.record(fn, *args, surface=name, track_memory=True)
    return rec.rep, memplan.plan_recorded(rec, args, out, surface=name)


def _decode_entry(rep, plan) -> dict:
    return {"host_callbacks": len(rep.host_callbacks),
            "psums_by_site": dict(sorted(rep.psums_by_site.items())),
            "collectives": dict(sorted(rep.collectives.items())),
            "arg_bytes": rep.arg_bytes, "out_bytes": rep.out_bytes,
            "static_total_bytes": plan.total_bytes,
            "pallas_calls": rep.reference_calls,
            "kernel_calls": rep.kernel_calls,
            "kernel_launches": rep.kernel_launches,
            "kernel_pairs": rep.kernel_pairs,
            "large_f32_upcasts": rep.large_f32_upcasts,
            "fits_card": bool(plan.total_bytes < memplan.CARD_BYTES)}


def _stage_engine_decode(cfg, arch: str, sparse, *, device,
                         sparse_serve: bool = True) -> dict:
    from functools import partial

    from repro_torch.models import model as M
    if cfg.is_encoder_decoder:
        # the engine is decoder-only; decode_step supports an encoder-
        # decoder model, so the serving step is audited directly
        if sparse is None:
            sparse = M.init_params(cfg, 0, device=device)
        caches = M.init_caches(cfg, 1, 32, device=device, enc_len=8)
        ints = dict(dtype=torch.int32, device=device)
        rep, plan = _audit_and_plan(
            partial(M.decode_step, cfg),
            (sparse, torch.zeros((1,), **ints), caches,
             torch.zeros((), **ints)), "decode_step")
        entry = _decode_entry(rep, plan)
        del entry["collectives"]          # as the reference's skip entry
        return {"status": "skip",
                "reason": "encoder-decoder: slot engine unsupported; "
                          "decode_step audited directly",
                "surface": "decode_step", **entry, "param_cast_bytes": 0}
    raw = (surfaces._sparse_smoke(arch, device=device)[1] if sparse_serve
           else M.init_params(cfg, 0, device=device))
    surf = surfaces.serve_surfaces(arch, sparse=sparse_serve, device=device,
                                   params=raw)[0]
    rep, plan = _audit_and_plan(surf.fn, surf.args, surf.name)
    return {"status": "ok", "surface": surf.name, "sparse": sparse_serve,
            **_decode_entry(rep, plan),
            "param_cast_bytes": audit.tree_bytes(raw)
            - audit.tree_bytes(surf.args[0])}


def _stage_fleet(cfg, params, bank) -> dict:
    from repro_torch.core import masks as masks_mod
    from repro_torch.sparse import apply as apply_mod
    masks = bank.masks_at(sparsity=0.5)
    variant = masks_mod.apply_masks(params, masks)
    return {"status": "ok",
            "shared_leaves": apply_mod.shared_leaves(params, variant),
            "total_leaves": len(tree.leaves(params)),
            "mask_cache_entries": len(bank._mask_cache)}


def family_report(arch: str, *, mesh_shape: tuple | None = None,
                  device=None) -> dict:
    """The full static pipeline dry run for one config family; smoke
    tensors on the card unless ``device`` names another device."""
    from repro_torch.device import resolve_device
    from repro_torch.models import model as M
    surfaces.no_mesh(mesh_shape)
    device = resolve_device(device)
    cfg = get_smoke_config(arch)
    report: dict[str, Any] = {"family": arch, "model_family": cfg.family,
                              "mesh": None, "stages": {}}
    stages = report["stages"]
    stages["calibrate"] = _stage_calibrate(cfg, arch)
    params = M.init_params(cfg, 0, device=device)
    bank = _surrogate_bank(cfg, params)
    nm_block = _nm_infeasible(bank.Gamma)
    stages["bank"] = _stage_bank(
        bank, _BUDGETS_UNSTRUCTURED if nm_block else _BUDGETS)
    if nm_block:
        # no 2:4 layout exists for the family: serve masked-dense instead
        stages["sparsify"] = {
            "status": "skip",
            "reason": f"2:4 infeasible ({nm_block}); serving masked-dense"}
        sparse = None
    else:
        stages["sparsify"], sparse = _stage_sparsify(cfg, params, bank)
    stages["engine_decode"] = _stage_engine_decode(
        cfg, arch, sparse, device=device, sparse_serve=not nm_block)
    stages["fleet"] = _stage_fleet(cfg, params, bank)
    stages["shardcheck"] = {"status": "skip",
                            "reason": "single device: nothing partitioned"}
    report["feasibility"] = {
        "traces": all(s.get("status") in ("ok", "skip")
                      for s in stages.values()),
        "fits_card": bool(stages["engine_decode"].get("fits_card", False)),
        "sharding_clean": None,
    }
    return report


# ---------------------------------------------------------------------------
# Golden contracts
# ---------------------------------------------------------------------------

def build_zoo_manifest(arch: str, *, mesh_shape: tuple | None = None,
                       device=None) -> dict:
    man = family_report(arch, mesh_shape=mesh_shape, device=device)
    man["info"] = {"torch": torch.__version__}
    return man


def _strip_info(d):
    if isinstance(d, dict):
        return {k: _strip_info(v) for k, v in d.items() if k != "info"}
    if isinstance(d, list):
        return [_strip_info(x) for x in d]
    return d


def zoo_diff(golden: dict, current: dict) -> list[dict]:
    """Structured drift, path by path, ``info`` subtrees ignored."""
    diffs: list[dict] = []

    def walk(g, c, path):
        if isinstance(g, dict) and isinstance(c, dict):
            for k in sorted(set(g) | set(c)):
                if k == "info":
                    continue
                if k not in c:
                    diffs.append({"path": f"{path}.{k}", "golden": g[k],
                                  "current": "<missing>"})
                elif k not in g:
                    diffs.append({"path": f"{path}.{k}",
                                  "golden": "<missing>", "current": c[k]})
                else:
                    walk(g[k], c[k], f"{path}.{k}")
        elif _strip_info(g) != _strip_info(c):
            diffs.append({"path": path, "golden": g, "current": c})

    walk(golden, current, current.get("family", "?"))
    return diffs


def reference_diff(ref_golden: dict, report: dict) -> list[dict]:
    """The port's ``family_report`` against the reference's golden
    (``results/contracts/zoo/<arch>_1dev.json``) on
    :data:`REFERENCE_STAGE_FIELDS`, the engine's params as the reference
    holds them (``arg_bytes + param_cast_bytes``)."""
    diffs = []
    for stage, fields in REFERENCE_STAGE_FIELDS.items():
        g, c = ref_golden["stages"][stage], report["stages"][stage]
        for f in fields:
            if (f in g or f in c) and g.get(f) != c.get(f):
                diffs.append({"path": f"{stage}.{f}", "golden": g.get(f),
                              "current": c.get(f)})
    g, c = ref_golden["stages"]["engine_decode"], \
        report["stages"]["engine_decode"]
    if g["arg_bytes"] != c["arg_bytes"] + c["param_cast_bytes"]:
        diffs.append({"path": "engine_decode.arg_bytes",
                      "golden": g["arg_bytes"],
                      "current": c["arg_bytes"] + c["param_cast_bytes"]})
    return diffs


def golden_path(zoo_dir, arch: str, mesh_shape: tuple | None) -> pathlib.Path:
    tag = "x".join(str(d) for d in mesh_shape) if mesh_shape else "1dev"
    return pathlib.Path(zoo_dir) / f"{arch}_{tag}.json"


def run_zoo(archs=None, *, mesh_shape: tuple | None = None,
            zoo_dir=ZOO_DIR, update: bool = False, diff_out=None,
            device=None) -> int:
    """Check (or ``update``) every family's golden; 0 iff no drift."""
    import sys
    surfaces.no_mesh(mesh_shape)
    rc = 0
    all_diffs = []
    for arch in (archs or ARCH_IDS):
        man = build_zoo_manifest(arch, device=device)
        path = golden_path(zoo_dir, arch, mesh_shape)
        if update:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(man, indent=1, sort_keys=True) + "\n")
            print(f"wrote {path}")
            continue
        if not path.exists():
            rc = 1
            all_diffs.append({"path": str(path), "golden": "<missing file>",
                              "current": "built"})
            print(f"{path}: MISSING GOLDEN", file=sys.stderr)
            continue
        diffs = zoo_diff(json.loads(path.read_text()), man)
        feas = man["feasibility"]
        if diffs:
            rc = 1
            all_diffs.extend(diffs)
            print(f"{path}: ZOO CONTRACT DRIFT", file=sys.stderr)
            for d in diffs:
                print(f"  {d['path']}: golden={d['golden']!r} "
                      f"current={d['current']!r}", file=sys.stderr)
        else:
            print(f"{path}: OK (traces={feas['traces']} "
                  f"fits_card={feas['fits_card']})")
    if all_diffs and diff_out:
        pathlib.Path(diff_out).write_text(json.dumps(all_diffs, indent=1))
        print(f"diff written to {diff_out}", file=sys.stderr)
    return rc


# ---------------------------------------------------------------------------
# The shape cells on meta (the reference's production AOT loop)
# ---------------------------------------------------------------------------

# long_500k requires sub-quadratic service; skipped for pure full-attention
# archs, as in the reference
LONG_OK = {"zamba2-7b", "xlstm-125m", "gemma2-2b", "gemma3-1b"}


def cell_skipped(cfg: ModelConfig, cell: ShapeCell) -> str | None:
    if cell.name == "long_500k" and cfg.name not in LONG_OK:
        return "full-attention arch: 500k dense-KV decode not serviceable"
    return None


def _stage_repeats(cfg: ModelConfig) -> int:
    """Repeats of the main stage (the pattern after any prefix)."""
    return (cfg.num_layers - len(cfg.pattern_prefix)) // len(cfg.pattern)


def _cut(cfg: ModelConfig, r: int) -> ModelConfig:
    """``cfg`` with its main stage cut to ``r`` repeats (the prefix and
    the remainder stage kept); whisper's encoder to ``r`` layers."""
    p, pre = len(cfg.pattern), len(cfg.pattern_prefix)
    rem = (cfg.num_layers - pre) % p
    enc = ({"encoder_layers": r} if cfg.is_encoder_decoder else {})
    return dataclasses.replace(cfg, num_layers=pre + p * r + rem, **enc)


def build_cell(cfg: ModelConfig, cell: ShapeCell, *, accum_override: int = 0,
               cast_bf16: bool = False, sparse: bool = True):
    """(step fn, meta args, extra) for one (config, cell): a train cell's
    step over two of its microbatches (``extra["accum"]`` the cell's own),
    a prefill or decode cell's step over the serving params (2:4
    compressed where the family takes 2:4)."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import optimizers as opt
    specs = steps_mod.input_specs(cfg, cell)
    if cell.kind == "train":
        accum = accum_override or steps_mod.choose_accum(cfg, cell, 1)
        micro = cell.global_batch // accum
        plan_accum = min(accum, 2)
        params = memplan.params_meta(cfg)
        ostate = opt.adamw_init(params)
        batch = {k: v[:micro * plan_accum] for k, v in specs["batch"].items()}
        fn = steps_mod.make_train_step(cfg, opt.AdamWConfig(),
                                       accum=plan_accum, remat=True,
                                       cast_bf16=cast_bf16)
        return fn, (params, ostate, batch), {"accum": accum}
    params = memplan.serving_params_meta(cfg, sparse=sparse)
    if cell.kind == "prefill":
        return (steps_mod.make_prefill(cfg, cell), (params, specs["batch"]),
                {})
    return (steps_mod.make_decode(cfg, cell, seq_sharded=False),
            (params, specs["token"], specs["caches"], specs["t"]), {})


def _sparse_ok(cfg: ModelConfig) -> bool:
    """Every prunable kernel's reduction dim takes 2:4 groups."""
    from repro_torch.core.prunable import prunable_map
    params = memplan.params_meta(cfg)
    return _nm_infeasible(tree.tree_map(lambda w, p: w if p else None,
                                        params, prunable_map(params))) is None


def run_cell(arch: str, cell_name: str, *, multi_pod: bool = False,
             accum_override: int = 0, cast_bf16: bool = False,
             plan: bool = True, budget_bytes: float | None = None) -> dict:
    """One (family, cell) on meta: bytes, the planned peak, ``fits_card``.
    ``plan=False`` reports the bytes alone."""
    from repro_torch.launch import steps as steps_mod
    from repro_torch.optim import optimizers as opt
    if multi_pod:
        raise NotImplementedError(
            "--multi-pod lays a cell over several pods of cards: tensor "
            "parallelism is not ported yet (ROADMAP A item 7)")
    cfg = get_config(arch)
    cell = SHAPE_CELLS[cell_name]
    rec: dict = {"arch": arch, "cell": cell_name, "devices": 1}
    skip = cell_skipped(cfg, cell)
    if skip:
        rec["skipped"] = skip
        return rec
    budget = memplan.CARD_BYTES if budget_bytes is None else budget_bytes
    sparse = _sparse_ok(cfg)
    f32 = memplan.params_meta(cfg)
    specs = steps_mod.input_specs(cfg, cell)
    rec.update({"param_bytes_f32": audit.tree_bytes(f32),
                "param_bytes_bf16": audit.tree_bytes(
                    memplan.serving_params_meta(cfg, sparse=False)),
                "param_bytes_24": audit.tree_bytes(
                    memplan.serving_params_meta(cfg)) if sparse else None,
                "cache_bytes": audit.tree_bytes(specs.get("caches", [])),
                "input_bytes": audit.tree_bytes(
                    specs.get("batch", specs.get("token")))})
    if cell.kind == "train":
        rec["optimizer_bytes"] = audit.tree_bytes(opt.adamw_init(f32))
        resident = rec["param_bytes_f32"] + rec["optimizer_bytes"]
    else:
        rec["sparse"] = sparse
        resident = (rec["param_bytes_24"] if sparse
                    else rec["param_bytes_bf16"]) + rec["cache_bytes"]
    rec["resident_bytes"] = resident + rec["input_bytes"]
    if not plan:
        return rec
    t0 = time.time()
    R = _stage_repeats(cfg)
    peaks = {}
    for r in sorted({1, min(2, R)}):
        fn, args, extra = build_cell(_cut(cfg, r), cell,
                                     accum_override=accum_override,
                                     cast_bf16=cast_bf16, sparse=sparse)
        peaks[r] = memplan.plan_fn(fn, *args, surface=cell_name,
                                   device=None).peak_bytes
        rec.update(extra)
    per_layer = peaks.get(2, peaks[1]) - peaks[1]
    rec["planned_peak_bytes"] = peaks[1] + (R - 1) * per_layer
    rec["plan_repeats"] = sorted(peaks)
    rec["stage_repeats"] = R
    rec["plan_s"] = round(time.time() - t0, 1)
    rec["total_bytes"] = rec["resident_bytes"] + rec["planned_peak_bytes"]
    rec["budget_bytes"] = budget
    rec["fits_card"] = bool(rec["total_bytes"] <= budget)
    return rec


def format_cells(recs: list[dict]) -> str:
    """The fit table of :func:`run_cell` records, one line a cell."""
    gb = lambda b: "-" if b is None else f"{b / 1e9:.2f}"  # noqa: E731
    out = ["arch                   cell         params GB (f32/bf16/2:4)  "
           "cache GB  optim GB  peak GB  total GB  fits 1 card"]
    for r in recs:
        if r.get("skipped") or r.get("error"):
            out.append(f"{r['arch']:<22s} {r['cell']:<12s} "
                       f"{'SKIP' if r.get('skipped') else 'ERROR'}: "
                       f"{r.get('skipped') or r.get('error')}")
            continue
        params = (f"{gb(r['param_bytes_f32'])}/{gb(r['param_bytes_bf16'])}/"
                  f"{gb(r['param_bytes_24'])}")
        out.append(f"{r['arch']:<22s} {r['cell']:<12s} {params:<25s} "
                   f"{gb(r['cache_bytes']):>8s}  "
                   f"{gb(r.get('optimizer_bytes')):>8s} "
                   f"{gb(r.get('planned_peak_bytes')):>8s} "
                   f"{gb(r.get('total_bytes')):>9s}  "
                   f"{'yes' if r.get('fits_card') else 'NO'}")
    return "\n".join(out)


def run_cells_main(args) -> int:
    """Every requested (arch x cell) on meta, one JSON per cell under
    ``args.out`` and the fit table on stdout.  ``args`` carries arch /
    cell / all / multi_pod / accum / bf16_cast / out (``launch.dryrun``
    and ``zoo --cells`` parse into this shape)."""
    if getattr(args, "multi_pod", False):
        raise NotImplementedError(
            "--multi-pod lays a cell over several pods of cards: tensor "
            "parallelism is not ported yet (ROADMAP A item 7)")
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    if args.all:
        archs = [args.arch] if args.arch else ARCH_IDS
        jobs = [(a, c) for a in archs for c in SHAPE_CELLS]
    elif args.arch and args.cell:
        jobs = [(args.arch, args.cell)]
    elif args.arch:
        jobs = [(args.arch, c) for c in SHAPE_CELLS]
    else:
        raise SystemExit("--arch [--cell] or --all")
    recs = []
    for arch, cell in jobs:
        tag = f"{arch}__{cell}__1card"
        print(f"=== {tag} ===", flush=True)
        try:
            budget = getattr(args, "budget_gb", None)
            rec = run_cell(arch, cell, accum_override=args.accum,
                           cast_bf16=args.bf16_cast,
                           budget_bytes=None if budget is None
                           else budget * 1e9)
        except Exception as e:  # a failure here is a bug in the port
            rec = {"arch": arch, "cell": cell,
                   "error": f"{type(e).__name__}: {e}"}
            print("FAILED:", rec["error"], flush=True)
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
        recs.append(rec)
        ok = "SKIP" if rec.get("skipped") else (
            "ERROR" if rec.get("error") else "ok")
        print(f"--- {tag}: {ok} plan={rec.get('plan_s', '-')}s "
              f"total={rec.get('total_bytes', 0) / 1e9:.2f}GB "
              f"fits_card={rec.get('fits_card')}", flush=True)
    print(format_cells(recs))
    return int(any(r.get("error") for r in recs))
