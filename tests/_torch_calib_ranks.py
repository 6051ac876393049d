"""The rank side of tests/test_torch_calib_tp.py: what each gloo rank
computes.

Spawned ranks import this module and the port only (no jax, no test
module).  Every input is drawn from a seed (the port's ``init_params``,
the synthetic corpus), so each rank and the test process build the same
params and batches.
"""
import dataclasses
import warnings

import numpy as np
import torch

from repro_torch import obs, tree
from repro_torch.configs.base import (ModelConfig, PruneConfig,
                                      get_smoke_config)
from repro_torch.core import calibrate as C
from repro_torch.core import mirror
from repro_torch.data.synthetic import batches_for
from repro_torch.dist import sharding as shd
from repro_torch.dist.axes import make_rules
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M

# tests/test_calibrate.py's STACKED (d 64, 4 layers, 2 heads x 32, d_ff
# 128, vocab 256), named into the llama family that calibrates under rules
STACKED = ModelConfig(name="llama-t4", family="dense", d_model=64,
                      num_layers=4, num_heads=2, num_kv_heads=2, head_dim=32,
                      d_ff=128, vocab_size=256)
AXES = ("data", "model")
# (case, config, metric, mesh, steps)
CASES = (
    [(f"wanda {a}x{b}", "stacked", "wanda", (a, b), 3)
     for a, b in ((1, 4), (2, 2), (4, 1))]
    + [(f"{m} 2x2", "stacked", m, (2, 2), 3)
       for m in ("ria", "stochria", "wanda/mean")]
    + [("mixtral 1x4", "mixtral", "wanda", (1, 4), 2),
       ("dff72 1x4", "dff72", "wanda", (1, 4), 3)])
LAUNCH_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--steps", "3",
               "--calib-n", "2", "--batch", "2", "--seq", "32",
               "--scan-chunk", "2", "--log-every", "1", "--device", "cpu"]


def config(name: str) -> ModelConfig:
    if name == "stacked":
        return STACKED
    if name == "dff72":
        return dataclasses.replace(STACKED, d_ff=72)
    return get_smoke_config("mixtral-8x22b")


def inputs(name: str):
    """(cfg, params, batches): the port's init (seed 0) and 2 calibration
    batches of 2 x 32, tests/test_calibrate.py's."""
    cfg = config(name)
    return (cfg, M.init_params(cfg, 0, device="cpu"),
            batches_for(cfg, n=2, batch=2, seq=32, split="calib"))


def pcfg_for(metric: str, steps: int) -> PruneConfig:
    """2:4, median-normalised scores unless ``metric`` names another
    normaliser (``"wanda/mean"``)."""
    name, _, norm = metric.partition("/")
    return PruneConfig(local_metric=name, mode="nm", steps=steps,
                       score_norm=norm or "median")


def _np(t) -> dict:
    return {p: None if x is None else x.numpy()
            for p, x in tree.flatten_with_path(t)}


def _state_bytes(state) -> int:
    """Bytes of this rank's W, Gamma and V storages."""
    total = 0
    for t in (state.W, state.Gamma, state.V):
        for x in tree.leaves(t):
            if x is not None:
                total += shd.block_data(x).untyped_storage().nbytes()
    return total


def planned_state_bytes(cfg, params, mesh, specs=None) -> int:
    """The bytes of this rank's blocks by a spec tree alone:
    ``search_state_sharding``'s, or the W ``specs`` given (every tree of
    the state on them)."""
    whole = mirror.init_search(params, 0)
    if specs is None:
        specs = shd.search_state_sharding(M.param_axes(cfg), whole,
                                          make_rules(mesh))
    else:
        specs = mirror.SearchState(W=specs, Gamma=specs, V=specs, step=0,
                                   rng=None)
    total = 0
    for name in ("W", "Gamma", "V"):
        for x, spec in zip(tree.leaves(getattr(whole, name)),
                           tree.leaves(getattr(specs, name))):
            if x is not None:
                total += 4 * int(np.prod(shd.block_shape(
                    tuple(x.shape), spec, mesh)))
    return total


def search_case(cfg_name: str, metric: str, shape, steps: int) -> dict:
    """One sharded search: stats, the steps, both mask exports; the
    whole Gamma, V, stats and masks on rank 0 (numpy)."""
    cfg, params, batches = inputs(cfg_name)
    mesh = Mesh(shape, AXES)
    rules = make_rules(mesh)
    pcfg = pcfg_for(metric, steps)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        stats = C.collect_stats(cfg, params, batches, rules=rules)
        state, hist = C.run_search(cfg, pcfg, params, batches, stats,
                                   rules=rules, log_every=1)
    masks = {
        "2:4": mirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V,
                                   rules=rules),
        "0.5": mirror.export_masks(
            dataclasses.replace(pcfg, mode="unstructured"), state.Gamma, 0.5,
            V=state.V, rules=rules)}
    out = {"history": hist, "bytes": _state_bytes(state),
           "planned": planned_state_bytes(cfg, params, mesh),
           "planned_search": planned_state_bytes(
               cfg, params, mesh, shd.search_specs(
                   M.param_axes(cfg), params, rules, quiet=True)),
           "warnings": [str(w.message) for w in rec],
           "blocks": {p: tuple(shd.block_data(x).shape)
                      for p, x in tree.flatten_with_path(state.Gamma)
                      if x is not None}}
    got = {k: tree.tree_map(lambda m: None if m is None else shd.whole(
        shd.DenseBlock(m.data.to(torch.uint8), m.spec)
        if isinstance(m, shd.DenseBlock) else m, mesh), v)
        for k, v in masks.items()}
    whole = shd.gather_state(state, stats, rules)
    if whole is not None:
        out["Gamma"], out["V"], out["stats"] = (_np(t) for t in whole)
        out["masks"] = {k: _np(v) for k, v in got.items()}
    return out


def prune_case() -> dict:
    """``unipruning_prune(rules=)`` on (2, 2), wanda 2:4, 3 steps: the
    pruned params gathered whole on rank 0 (numpy)."""
    cfg, params, batches = inputs("stacked")
    mesh = Mesh((2, 2), AXES)
    pruned, _, _ = C.unipruning_prune(cfg, pcfg_for("wanda", 3), params,
                                      batches, sparsities=(0.5,),
                                      rules=make_rules(mesh))
    whole = tree.tree_map(lambda w: shd.whole(w, mesh), pruned[0.5])
    return {"pruned": _np(whole)} if mesh.rank == 0 else {}


def launcher_case(out_dir: str, trace_dir: str) -> dict:
    """The calibrate launcher's ``--mesh host`` over this rank's group,
    rank 0's flight recorder into ``trace_dir``."""
    from repro_torch.launch import calibrate as launch
    obs.reset()
    try:
        launch.main(LAUNCH_ARGS + ["--out", out_dir, "--mesh", "host",
                                   "--trace-dir", trace_dir])
    finally:
        obs.reset()
    return {"mesh": dict(launch.host_rules("cpu")[0].mesh.shape)}


def rank_main(rank: int, world: int, device, out_dir: str,
              trace_dir: str) -> dict:
    """Everything the test holds, from one rank."""
    out = {name: search_case(cfg, metric, shape, steps)
           for name, cfg, metric, shape, steps in CASES}
    out["prune"] = prune_case()
    out["launcher"] = launcher_case(out_dir, trace_dir)
    return out


def card_rank(rank: int, world: int, device) -> dict:
    """tests/test_torch_cuda.py: the STACKED wanda 2:4 search (3 steps) on
    (1, world) on this rank's card over gloo: the whole Gamma and V and
    the 2:4 masks on rank 0 (numpy), the history on every rank."""
    cfg, params, batches = inputs("stacked")
    params = tree.to_device(params, device)
    mesh = Mesh((1, world), AXES)
    rules = make_rules(mesh)
    pcfg = pcfg_for("wanda", 3)
    stats = C.collect_stats(cfg, params, batches, rules=rules)
    state, hist = C.run_search(cfg, pcfg, params, batches, stats,
                               rules=rules, log_every=1)
    masks = tree.tree_map(lambda m: None if m is None else shd.whole(
        shd.DenseBlock(m.data.to(torch.uint8), m.spec)
        if isinstance(m, shd.DenseBlock) else m, mesh),
        mirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V, rules=rules))
    whole = shd.gather_state(state, stats, rules)
    out = {"history": hist}
    if whole is not None:
        out["Gamma"], out["V"] = (_np(tree.to_device(t, "cpu"))
                                  for t in whole[:2])
        out["masks"] = _np(tree.to_device(masks, "cpu"))
    return out
