"""UniPruning calibration over gloo ranks on the CPU: the stats, the
sharded search state and the masks under rules, held against the port's
single-process search and, once, the reference's unsharded ``run_search``.

One spawn of 4 ranks (``repro_torch.dist.ranks.run_ranks``; each rank runs
``_torch_calib_ranks.rank_main``, which imports no jax) runs every case:

* tests/test_calibrate.py's STACKED shape (d 64, 4 layers, 2 heads x 32,
  d_ff 128, vocab 256; the port's ``init_params`` seed 0; 2 batches of 2
  x 32), wanda 2:4 for 3 steps on meshes (1, 4), (2, 2) and (4, 1), ria
  and stochria (median normaliser) and wanda with the mean normaliser on
  (2, 2), ``unipruning_prune`` on (2, 2); smoke mixtral-8x22b on (1,
  4) for 2 steps (the expert banks sharded along d_ff); d_ff 72 on (1,
  4), whose down kernel keeps its groups of 4 along K whole (loudly);
* the calibrate launcher's ``--mesh host`` over the 4 ranks ((4, 1)).

Held: the gathered Gamma and V (and the stats) within tests/
test_calibrate.py's ``rtol 1e-5, atol 1e-7`` of the single-process
search; the 2:4 and the 0.5 unstructured masks equal but for counted
near-ties; the history's five series (exact but for the cross-rank
summation order of ``align`` and ``gamma_entropy``); each rank's state
bytes against the spec derivation's blocks.  The reference's own mesh
search test does not run on jax 0.9 (ROADMAP R15), so the (2, 2) search is
also held against the reference's unsharded ``run_search`` at
``assert_calibration_matches``'s tolerances.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_calib_ranks as R
from _torch_port import (assert_calibration_matches,  # noqa: F401
                         one_torch_thread, to_jax)
from repro_torch import tree
from repro_torch.core import calibrate as C
from repro_torch.core import mirror
from repro_torch.dist import ranks
from repro_torch.dist.axes import make_rules
from repro_torch.launch.mesh import Mesh

WORLD = 4
CASES = [c[0] for c in R.CASES]
SPEC = {c[0]: c[1:] for c in R.CASES}
SERIES_EXACT = ("loss", "gamma_nonzero_frac", "mask_churn")
SERIES_SUMMED = ("align", "gamma_entropy")    # cross-rank partial sums


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("calib_tp")
    return {k: d / k for k in ("ranked", "ranked_trace", "single",
                               "single_trace")}


@pytest.fixture(scope="module")
def ranked(dirs):
    """Every rank's results of ``rank_main`` (one spawn for the module)."""
    return ranks.run_ranks(R.rank_main, WORLD,
                           args=(str(dirs["ranked"]),
                                 str(dirs["ranked_trace"])),
                           timeout=120.0, deadline=600.0)


@pytest.fixture(scope="module")
def single():
    """The port's single-process search of each distinct (config, metric,
    steps): (state, stats, history, {budget: masks})."""
    out = {}
    for cfg_name, metric, _, steps in SPEC.values():
        key = (cfg_name, metric, steps)
        if key in out:
            continue
        cfg, params, batches = R.inputs(cfg_name)
        pcfg = R.pcfg_for(metric, steps)
        stats = C.collect_stats(cfg, params, batches)
        state, hist = C.run_search(cfg, pcfg, params, batches, stats,
                                   log_every=1)
        masks = {"2:4": mirror.export_masks(pcfg, state.Gamma, 0.5,
                                            V=state.V),
                 "0.5": mirror.export_masks(
                     dataclasses.replace(pcfg, mode="unstructured"),
                     state.Gamma, 0.5, V=state.V)}
        out[key] = (state, stats, hist, masks)
    return out


def _single(single, case):
    cfg_name, metric, _, steps = SPEC[case]
    return single[(cfg_name, metric, steps)]


def _flat(t) -> dict:
    return {p: None if x is None else x.numpy()
            for p, x in tree.flatten_with_path(t)}


@pytest.mark.parametrize("case", CASES)
def test_state_matches_single_process(ranked, single, case):
    """Gamma, V and the stats gathered from the ranks, within the
    reference's own sharded-vs-unsharded bound of the single process's."""
    state, stats, _, _ = _single(single, case)
    got = ranked[0][case]
    for name, want in (("Gamma", state.Gamma), ("V", state.V),
                       ("stats", stats)):
        n = 0
        for path, w in _flat(want).items():
            if w is None:
                assert got[name][path] is None, (name, path)
                continue
            np.testing.assert_allclose(got[name][path], w, rtol=1e-5,
                                       atol=1e-7, err_msg=name + path)
            n += 1
        assert n >= 7, (name, n)      # every prunable kernel of the model
    for r in ranked[1:]:
        assert "Gamma" not in r[case]   # the whole trees on rank 0 only


def _near_ties(score, want, got, budget, tol, tau):
    """The entries where the masks differ, each checked to be a near-tie
    of the single process's scores: within ``tol`` of its 2:4 group's
    kept / dropped boundary, or of the global threshold ``tau``."""
    diff = np.argwhere(want != got)
    if not len(diff):
        return 0
    if budget == "2:4":
        K, N = score.shape[-2:]
        g = score.reshape(-1, K // 4, 4, N)
        srt = np.sort(g, axis=2)
        gap = (srt[:, :, 2, :] - srt[:, :, 1, :]).reshape(
            score.shape[:-2] + (K // 4, N))
        for idx in diff:
            *lead, k, n = idx
            assert gap[tuple(lead) + (k // 4, n)] <= 2 * tol[tuple(idx)], \
                (budget, idx)
    else:
        for idx in diff:
            assert abs(score[tuple(idx)] - tau) <= 2 * tol[tuple(idx)], \
                (budget, idx)
    return len(diff)


@pytest.mark.parametrize("case", CASES)
def test_masks_match_single_process(ranked, single, case):
    """The 2:4 and 0.5 unstructured masks from the ranks equal the single
    process's, but for near-ties counted (and printed) here."""
    state, _, _, masks = _single(single, case)
    got = ranked[0][case]["masks"]
    gmax = max(float(g.abs().max()) for g in tree.leaves(state.Gamma)
               if g is not None)
    vmax = max(float(v.abs().max()) for v in tree.leaves(state.V)
               if v is not None)
    eps = 1e-6 * gmax / vmax
    scores = {p: np.abs(g.numpy()) + eps * np.abs(v.numpy())
              for (p, g), v in zip(tree.flatten_with_path(state.Gamma),
                                   tree.leaves(state.V)) if g is not None}
    allv = np.sort(np.concatenate([s.reshape(-1) for s in scores.values()]))
    tau = float(allv[int(0.5 * (allv.size - 1))])
    ties = 0
    for budget, want in masks.items():
        for path, w in _flat(want).items():
            if w is None:
                continue
            tol = 1e-5 * scores[path] + 1e-7
            ties += _near_ties(scores[path], w, got[budget][path].astype(
                bool), budget, tol, tau)
    print(f"{case}: {ties} near-tied mask entries differ")
    assert ties <= 4


@pytest.mark.parametrize("case", CASES)
def test_history_matches_single_process(ranked, single, case):
    """The five series of every step, on every rank."""
    _, _, want, _ = _single(single, case)
    for r in ranked:
        got = r[case]["history"]
        assert len(got) == len(want) == SPEC[case][3]
        for a, b in zip(want, got):
            for k in SERIES_EXACT:
                assert b[k] == a[k], (case, k)
            for k in SERIES_SUMMED:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5,
                                           err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", CASES)
def test_state_bytes_are_the_blocks(ranked, case):
    """Each rank's W / Gamma / V storages hold its blocks and nothing
    more: ``search_state_sharding``'s blocks, but where a leaf keeps its
    prox groups whole (d_ff 72)."""
    for r in ranked:
        got = r[case]
        assert got["bytes"] == got["planned_search"], case
        if case.startswith("dff72"):
            assert got["bytes"] > got["planned"]
        else:
            assert got["bytes"] == got["planned"], case


def test_unipruning_prune_under_rules(ranked):
    """The pipeline's pruned params, each rank's blocks gathered, equal the
    single process's ``unipruning_prune`` bit for bit (equal masks on the
    same W0)."""
    cfg, params, batches = R.inputs("stacked")
    want, _, _ = C.unipruning_prune(cfg, R.pcfg_for("wanda", 3), params,
                                    batches, sparsities=(0.5,))
    got = ranked[0]["prune"]["pruned"]
    for path, w in _flat(want[0.5]).items():
        np.testing.assert_array_equal(got[path], w, path)


def test_dff72_keeps_prox_groups_whole_loudly(ranked):
    """d_ff 72 over 4 ranks would give the down kernel K blocks of 18,
    splitting its groups of 4: it replicates along K with a warning on
    every rank, and still equals the single process
    (test_state_matches_single_process)."""
    down = "['stages'][0]['0']['mlp']['down']['kernel']"
    for r in ranked:
        got = r["dff72 1x4"]
        assert got["blocks"][down][-2] == 72
        assert any("prox24" in w and "['mlp']['down']" in w
                   for w in got["warnings"]), got["warnings"]
        assert not r["wanda 1x4"]["warnings"]


def test_mixtral_expert_banks_shard_over_d_ff(ranked):
    """The expert banks (layers, E, K, N) shard their d_ff over "model"
    (the reference's axes leave the expert dim unnamed): up's N and down's
    K blocks are 256 / 4."""
    stage = "['stages'][0]['0']['moe']"
    for r in ranked:
        blocks = r["mixtral 1x4"]["blocks"]
        assert blocks[stage + "['up']['kernel']"] == (4, 4, 128, 64)
        assert blocks[stage + "['down']['kernel']"] == (4, 4, 64, 128)


def test_launcher_over_ranks_writes_one_bank(ranked, dirs):
    """``launch.calibrate --mesh host`` in each of 4 ranks: one bank that
    both packages read, with a 1-process launcher run's masks, and rank
    0's flight-recorder events in the 1-process run's order."""
    from repro.sparse.bank import MaskBank as JaxMaskBank
    from repro_torch import obs
    from repro_torch.launch import calibrate as launch
    from repro_torch.sparse.bank import MaskBank
    assert [r["launcher"]["mesh"] for r in ranked] == [
        {"data": 4, "model": 1}] * WORLD
    obs.reset()
    try:
        launch.main(R.LAUNCH_ARGS + ["--out", str(dirs["single"]),
                                     "--trace-dir",
                                     str(dirs["single_trace"])])
    finally:
        obs.reset()
    got = MaskBank.load(dirs["ranked"], device="cpu")
    want = MaskBank.load(dirs["single"], device="cpu")
    for (path, w), g in zip(tree.flatten_with_path(want.masks_at()),
                            tree.leaves(got.masks_at())):
        if w is not None:
            assert torch.equal(g, w), path
    jbank = JaxMaskBank.load(dirs["ranked"])
    for (path, w), g in zip(tree.flatten_with_path(got.Gamma),
                            jax.tree.leaves(jbank.Gamma,
                                            is_leaf=lambda x: x is None)):
        if w is not None:
            np.testing.assert_array_equal(np.asarray(g), w.numpy(), path)

    def events(d):
        return [(e["kind"], e.get("name") or e.get("event"))
                for e in obs.read_jsonl(d / "events.jsonl")]

    assert events(dirs["ranked_trace"]) == events(dirs["single_trace"])
    # one writer: no rank left a partial artifact beside it
    assert not list(dirs["ranked"].parent.glob("*.tmp"))


def test_against_the_reference_unsharded_search(ranked):
    """The (2, 2) wanda search gathered from the ranks against the
    reference's unsharded ``repro.core.calibrate.run_search`` on the same
    params, at tests/test_torch_calibrate.py's tolerances."""
    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.configs.base import PruneConfig as JaxPruneConfig
    from repro.core import calibrate as jcal
    from repro.sparse.bank import MaskBank as JaxMaskBank
    from repro_torch.sparse.bank import MaskBank
    cfg, params, batches = R.inputs("stacked")
    jcfg = JaxModelConfig(**{**dataclasses.asdict(cfg), "name": "t4"})
    pcfg = R.pcfg_for("wanda", 3)
    jp = to_jax(params)
    jstats = jcal.collect_stats(jcfg, jp, batches)
    jpcfg = JaxPruneConfig(**dataclasses.asdict(pcfg))
    jstate, jhist = jcal.run_search(jcfg, jpcfg, jp, batches, jstats,
                                    log_every=1)
    jbank = JaxMaskBank(jcfg, jpcfg, jstate.Gamma, jstate.V, jstats,
                        {"history": jhist})
    got = ranked[0]["wanda 2x2"]
    as_tree = lambda flat: tree.map_with_path(  # noqa: E731
        lambda p, _: None if flat[p] is None else torch.from_numpy(flat[p]),
        params)
    tbank = MaskBank(cfg, pcfg, as_tree(got["Gamma"]), as_tree(got["V"]),
                     as_tree(got["stats"]), {"history": got["history"]})
    assert_calibration_matches(jbank, tbank)


def test_other_families_refused_under_rules():
    """A family outside llama and mixtral raises before any collective,
    naming the ROADMAP item."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as M
    cfg = get_smoke_config("gemma3-1b")
    params = M.init_params(cfg, 0, device="cpu")
    rules = make_rules(Mesh((1, WORLD), R.AXES, rank=0))
    with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
        C.collect_stats(cfg, params, [], rules=rules)
    with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
        C.run_search(cfg, R.pcfg_for("wanda", 1), params, [], None,
                     rules=rules)


@pytest.mark.parametrize("kind", ["scores", "signed", "ties"])
def test_block_median_is_median_element(kind):
    """``LeafLayout.median`` (the bisection over the floats' order that
    the sharded search divides by) is ``median_element`` exactly, here on
    a one-rank layout: signed values, zeros and ties included."""
    from repro_torch.core.metrics import median_element
    from repro_torch.dist.sharding import LeafLayout
    g = torch.Generator().manual_seed(3)
    t = torch.randn((4, 64, 48), generator=g)
    t = {"scores": t.abs(), "signed": t,
         "ties": torch.round(t * 2).clamp_min(0) / 2}[kind]
    lay = LeafLayout((), Mesh((1, 1), R.AXES, rank=0), t.dim())
    assert lay.median(t).item() == median_element(t).item()
