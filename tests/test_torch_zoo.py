"""The port's whole-zoo dry run (``repro_torch.analysis.zoo``) and its
shape-cell launcher (``repro_torch.launch.dryrun``) against the
reference's.

Each of the ten families' ``family_report`` against the reference's
golden (``results/contracts/zoo/<arch>_1dev.json``) on every field the two
share (``zoo.REFERENCE_STAGE_FIELDS``: every integer field of calibrate,
bank, sparsify and fleet; the engine decode's host syncs, collectives per
site and kernel calls per site, its bytes with the serving cast added
back) and against the port's committed golden on every field; whisper's
structured skip and xlstm's 2:4-infeasible skip (tests/test_memplan.py's
cases); ``zoo --update`` then a check, round trip into ``tmp_path``; the
dry run of llama3.2-1b's four cells on meta, its bytes against
``steps.input_specs`` and the reference's ``jax.eval_shape``; the
planner's depth carry held at a third depth; and the refusal of a
multi-pod mesh.  Everything runs on the CPU or the meta device.
"""
import json
import pathlib

import jax
import numpy as np
import pytest

from _torch_port import one_torch_thread  # noqa: F401  (autouse fixture)
from repro_torch.analysis import audit, memplan, zoo
from repro_torch.configs.base import (ARCH_IDS, SHAPE_CELLS, ShapeCell,
                                      get_config)

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_ZOO = ROOT / "results" / "contracts" / "zoo"


@pytest.fixture(scope="module")
def reports():
    """One family report per arch, made at first use."""
    made = {}

    def get(arch):
        if arch not in made:
            made[arch] = zoo.build_zoo_manifest(arch, device="cpu")
        return made[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_report_matches_the_reference(arch, reports):
    ref = json.loads(zoo.golden_path(REF_ZOO, arch, None).read_text())
    rep = reports(arch)
    assert zoo.reference_diff(ref, rep) == []
    # the kernel calls per site: the reference's CPU route runs a pair over
    # one input as one call
    dec = rep["stages"]["engine_decode"]
    assert dec["pallas_calls"] == sum(dec["kernel_calls"].values()) \
        - dec["kernel_pairs"] == ref["stages"]["engine_decode"][
            "pallas_calls"]
    assert dec["host_callbacks"] == 0 and dec["large_f32_upcasts"] == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_family_report_matches_the_ports_golden(arch, reports):
    golden = json.loads(zoo.golden_path(zoo.ZOO_DIR, arch, None).read_text())
    assert zoo.zoo_diff(golden, reports(arch)) == []


def test_whisper_structured_skip(reports):
    """The engine is decoder-only: whisper's decode step is audited
    directly (tests/test_memplan.py:114)."""
    rep = reports("whisper-small")
    eng = rep["stages"]["engine_decode"]
    assert eng["status"] == "skip" and eng["surface"] == "decode_step"
    assert "encoder-decoder" in eng["reason"]
    assert eng["host_callbacks"] == 0 and eng["pallas_calls"] > 0
    assert rep["feasibility"]["traces"]


def test_xlstm_nm_infeasible_skip(reports):
    """xlstm's ff_down has K = 85: no 2:4 layout, so the bank takes two
    unstructured budgets and serving is masked-dense
    (tests/test_memplan.py:125)."""
    rep = reports("xlstm-125m")
    assert rep["stages"]["sparsify"]["status"] == "skip"
    assert "K=85" in rep["stages"]["sparsify"]["reason"]
    assert rep["stages"]["bank"]["budgets"] == 2
    eng = rep["stages"]["engine_decode"]
    assert eng["sparse"] is False and eng["pallas_calls"] == 0
    assert eng["kernel_launches"] == {}


def test_zoo_update_then_check_round_trip(tmp_path, capsys):
    assert zoo.run_zoo(["llama3.2-1b"], zoo_dir=tmp_path, update=True,
                       device="cpu") == 0
    path = zoo.golden_path(tmp_path, "llama3.2-1b", None)
    assert path.exists()
    assert zoo.run_zoo(["llama3.2-1b"], zoo_dir=tmp_path,
                       device="cpu") == 0
    drifted = json.loads(path.read_text())
    drifted["stages"]["bank"]["prunable_leaves"] += 1
    path.write_text(json.dumps(drifted))
    diff_out = tmp_path / "diff.json"
    assert zoo.run_zoo(["llama3.2-1b"], zoo_dir=tmp_path, device="cpu",
                       diff_out=diff_out) == 1
    assert json.loads(diff_out.read_text())[0]["path"] \
        == "llama3.2-1b.stages.bank.prunable_leaves"
    assert zoo.run_zoo(["gemma2-2b"], zoo_dir=tmp_path, device="cpu") == 1


# ---------------------------------------------------------------------------
# the shape cells on meta
# ---------------------------------------------------------------------------


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("cell", list(SHAPE_CELLS))
def test_dryrun_llama_cells_bytes(cell):
    """Parameter and cache bytes of each cell equal the port's input specs'
    and the reference's ``jax.eval_shape`` ones."""
    from repro.configs.base import SHAPE_CELLS as JAX_CELLS
    from repro.configs.base import get_config as jax_config
    from repro.launch import steps as jsteps
    from repro.models import model as JM
    from repro_torch.launch import steps as tsteps
    rec = zoo.run_cell("llama3.2-1b", cell, plan=False)
    if cell == "long_500k":
        assert "full-attention" in rec["skipped"]
        return
    jcfg, cfg = jax_config("llama3.2-1b"), get_config("llama3.2-1b")
    shapes = JM.param_shapes(jcfg)
    assert rec["param_bytes_f32"] == _jax_bytes(shapes)
    specs = tsteps.input_specs(cfg, SHAPE_CELLS[cell])
    jspecs = jsteps.input_specs(jcfg, JAX_CELLS[cell])
    assert rec["cache_bytes"] == audit.tree_bytes(specs.get("caches", [])) \
        == _jax_bytes(jspecs.get("caches", []))
    # serving: the port casts every kernel and the table to bf16
    # (``model.serving_params``; the reference's dry run casts every f32
    # leaf, the norm scales too)
    kept = sum(int(np.prod(x.shape)) * 4 for p, x in
               jax.tree_util.tree_flatten_with_path(shapes)[0]
               if not jax.tree_util.keystr(p).endswith(("['kernel']",
                                                        "['table']")))
    assert kept and rec["param_bytes_bf16"] == (_jax_bytes(shapes) + kept) \
        // 2
    if cell == "train_4k":
        assert rec["optimizer_bytes"] == 2 * rec["param_bytes_f32"] + 4
    else:
        assert rec["param_bytes_24"] < rec["param_bytes_bf16"]


@pytest.mark.parametrize("cell", ["train_4k", "decode_32k"])
def test_dryrun_llama_cells_plan(cell, tmp_path):
    from repro_torch.launch import dryrun
    assert dryrun.main(["--arch", "llama3.2-1b", "--cell", cell, "--out",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / f"llama3.2-1b__{cell}__1card.json")
                     .read_text())
    assert rec["stage_repeats"] == 16 and rec["plan_repeats"] == [1, 2]
    assert rec["planned_peak_bytes"] > 0
    assert rec["total_bytes"] == rec["resident_bytes"] \
        + rec["planned_peak_bytes"]
    if cell == "decode_32k":
        # 128 x 32768 slots of 16 layers' K and V: no single card holds it
        assert rec["cache_bytes"] == 16 * 2 * 128 * 32768 * 8 * 64 * 2
        assert not rec["fits_card"]
    else:
        assert rec["accum"] == 256 and rec["fits_card"]


def test_plan_depth_carry_is_exact():
    """The planned peak is linear in a stage's depth: planned at 1 and 2
    layers and carried, it equals the plan at 3 (a train cell and a
    prefill cell of llama's published widths, short sequences)."""
    cfg = get_config("llama3.2-1b")
    for kind in ("train", "prefill"):
        cell = ShapeCell("small", 512, 2, kind)
        peaks = {}
        for r in (1, 2, 3):
            c = zoo._cut(cfg, r)
            fn, args, _ = zoo.build_cell(c, cell, accum_override=2)
            peaks[r] = memplan.plan_fn(fn, *args, device=None).peak_bytes
        assert peaks[3] == peaks[1] + 2 * (peaks[2] - peaks[1]), kind


def test_dryrun_refuses_multi_pod(tmp_path):
    from repro_torch.launch import dryrun
    with pytest.raises(NotImplementedError, match="item 7"):
        dryrun.main(["--all", "--multi-pod", "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="item 7"):
        zoo.run_cell("llama3.2-1b", "train_4k", multi_pod=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        zoo.family_report("llama3.2-1b", mesh_shape=(2, 2), device="cpu")
    assert zoo.cell_skipped(get_config("llama3.2-1b"),
                            SHAPE_CELLS["long_500k"])
