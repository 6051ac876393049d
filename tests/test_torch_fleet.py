"""repro_torch multi-budget fleet (``serve.fleet``) against the JAX
reference: the cases of tests/test_fleet.py on the port, and both
packages' fleets over ONE JAX-written bank (2 wanda search steps on the
smoke llama3.2-1b from ``jax.random.key(0)``, its params carried across):
the same streams, ``report()`` counters (every key but the timings),
``shared_leaves`` counts and A/B pick order; ``decode_mode="vmap"`` equal
to fused on both packages; a mismatched shared ``EngineFns`` refused."""
import jax
import numpy as np
import pytest

from _torch_port import jax_params_to_torch
from repro.configs.base import PruneConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.data.synthetic import batches_for
from repro.models import model as JM
from repro.serve import engine as jengine
from repro.serve import fleet as jfleet
from repro.sparse import apply as japply
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.serve import engine as tengine
from repro_torch.serve import fleet as tfleet
from repro_torch.sparse import apply as tapply
from repro_torch.sparse.bank import MaskBank

JCFG = jax_smoke_config("llama3.2-1b")
CFG = get_smoke_config("llama3.2-1b")
BUDGETS = ["0.0", "0.5", "2:4"]
P1, P2 = np.array([5, 6, 7, 8]), np.array([9, 10, 11])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(jax params, torch params, bank dir)."""
    jp = JM.init_params(JCFG, jax.random.key(0))
    calib = batches_for(JCFG, n=2, batch=2, seq=16, split="calib")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=2)
    stats = jcal.collect_stats(JCFG, jp, calib)
    state, _ = jcal.run_search(JCFG, pcfg, jp, calib, stats)
    d = tmp_path_factory.mktemp("fleet") / "bank"
    JaxMaskBank.save(d, arch="llama3.2-1b", smoke=True, state=state,
                     stats=stats, pcfg=pcfg)
    return jp, jax_params_to_torch(jp), d


def _fleets(setup, budgets=BUDGETS, **kw):
    """(torch fleet, jax fleet) over the one bank."""
    jp, tp, d = setup
    return (tfleet.SparsityFleet.from_artifact(d, tp, budgets, device="cpu",
                                               **kw),
            jfleet.SparsityFleet.from_artifact(d, jp, budgets, **kw))


def _counters(rep):
    """report() without its timings (tok_s, seconds)."""
    def strip(r):
        out = {k: v for k, v in r.items() if k != "tok_s"}
        out["cumulative"] = {k: v for k, v in r["cumulative"].items()
                             if k != "seconds"}
        out["shadow"] = {k: v for k, v in r["shadow"].items()
                         if k != "seconds"}
        return out
    return rep["reference"], {n: strip(r) for n, r in rep["budgets"].items()}


def _same_report(tf, jf):
    got, want = _counters(tf.report()), _counters(jf.report())
    assert got[0] == want[0]
    for name in want[1]:
        g, w = got[1][name], want[1][name]
        assert g.keys() == w.keys(), name
        for k in w:
            if k == "weight_bytes_ratio":
                assert g[k] == pytest.approx(w[k]), name
            else:
                assert g[k] == w[k], (name, k)


@pytest.mark.parametrize("spelling", ["2:4", (4, 8), "0.5", 0.75, "0.0", "0",
                                      0, 0.0, "dense"])
def test_parse_budget_spellings(spelling):
    got, want = tfleet.parse_budget(spelling), jfleet.parse_budget(spelling)
    assert (got.kind, got.sparsity, got.nm, got.name, got.pruned_frac) == \
        (want.kind, want.sparsity, want.nm, want.name, want.pruned_frac)


def test_parse_budget_range_and_token_agreement():
    with pytest.raises(ValueError):
        tfleet.parse_budget("1.5")
    for a, b in (([1, 2, 3], [1, 9, 3]), ([1, 2], [1, 2, 3]), ([], [])):
        assert tfleet.token_agreement(a, b) == jfleet.token_agreement(a, b)
    assert tfleet.token_agreement([1, 2, 3], [1, 9, 3]) == \
        pytest.approx(2 / 3)


def test_fleet_routes_each_budget_to_its_own_engine(setup):
    """Each member equals a standalone engine at its budget, the 0.0
    member a plain dense engine over params0; streams and report counters
    equal the JAX fleet's."""
    jp, tp, d = setup
    tf, jf = _fleets(setup, slots=6, capacity=32)
    assert len(tf.bank._mask_cache) == 2
    prompts = [P1, P2]
    outs = []
    for f in (tf, jf):
        rids = {n: [f.submit(p, 5, budget=n) for p in prompts]
                for n in BUDGETS}
        res = f.run()
        outs.append({n: [res[r] for r in rids[n]] for n in BUDGETS})
    assert outs[0] == outs[1]
    _same_report(tf, jf)
    bank = MaskBank.load(d, device="cpu")
    oracles = {
        "0.0": tp,
        "0.5": bank.sparse_params(tp, sparsity=0.5, compressed=False),
        "2:4": bank.sparse_params(tp, nm=(2, 4), compressed=True),
    }
    for name, p in oracles.items():
        eng = tengine.ServeEngine(CFG, p, slots=2, capacity=32, device="cpu")
        want = [eng.submit(pr, 5) for pr in prompts]
        got = eng.run()
        assert outs[0][name] == [got[r] for r in want], name
    assert all(len(o) == 5 for n in BUDGETS for o in outs[0][n])


def test_fleet_materialization_is_shared_and_memoized(setup):
    """Untouched leaves are the SAME tensors across members (one copy of
    the cast params0, which no engine copies again); counts equal the
    reference's; a second fleet over the bank re-uses its mask trees."""
    jp, tp, d = setup
    tf, jf = _fleets(setup, slots=3, capacity=32)
    n_leaves = len(tree.leaves(tp))
    p0 = tf.params0
    assert tapply.shared_leaves(p0, tf.engines["0.0"].params) == n_leaves
    for name in ("0.5", "2:4"):
        sp = tf.engines[name].params
        shared = tapply.shared_leaves(p0, sp)
        assert 0 < shared < n_leaves
        assert tf.reports[name]["shared_dense_leaves"] == shared
        assert shared == japply.shared_leaves(jp, jf.engines[name].params)
        assert shared == jf.reports[name]["shared_dense_leaves"]
    assert tf.reports["2:4"]["weight_bytes_ratio"] <= 9 / 16 + 1e-9
    assert tf.reports["0.5"]["weight_bytes_ratio"] <= 1.0 + 1e-9
    before = {k: id(v) for k, v in tf.bank._mask_cache.items()}
    tfleet.SparsityFleet(tf.bank, tp, BUDGETS, slots=3, capacity=32,
                         device="cpu")
    assert {k: id(v) for k, v in tf.bank._mask_cache.items()} == before


def test_fleet_ab_split_is_deterministic_and_scores_agreement(setup):
    tf, jf = _fleets(setup, slots=3, capacity=32)
    ab = {"0.5": 3.0, "2:4": 1.0}
    picks, outs = [], []
    for f in (tf, jf):
        rids = [f.submit(P1, 3, ab=ab) for _ in range(8)]
        picks.append([f._routes[r][0] for r in rids])
        res = f.run()
        assert all(len(res[r]) == 3 for r in rids)
        outs.append([res[r] for r in rids])
    assert picks[0] == picks[1] and outs[0] == outs[1]
    _same_report(tf, jf)
    rep = tf.report()["budgets"]
    assert rep["0.5"]["requests"] == 6 and rep["2:4"]["requests"] == 2
    assert rep["0.0"]["requests"] == 0
    for name in ("0.5", "2:4"):
        agree = rep[name]["token_agreement_vs_reference"]
        assert agree is not None and 0.0 <= agree <= 1.0
    with pytest.raises(KeyError):
        tf.submit(P1, 3, ab={"0.9": 1.0})
    with pytest.raises(ValueError):
        tf.submit(P1, 3, budget="0.5", ab=True)
    # uniform split: the same pick order as the reference
    picks = []
    for f in (tf, jf):
        rids = [f.submit(P2, 2, ab=True) for _ in range(5)]
        picks.append([f._routes[r][0] for r in rids])
        f.run()
    assert picks[0] == picks[1]


def test_fleet_report_keeps_shadow_traffic_out_of_headline(setup):
    tf, jf = _fleets(setup, slots=3, capacity=32)
    for f in (tf, jf):
        rids = [f.submit(P1, 4, ab={"0.5": 1.0}) for _ in range(3)]
        res = f.run()
        assert all(len(res[r]) == 4 for r in rids)
    _same_report(tf, jf)
    rep = tf.report()["budgets"]
    ref = rep["0.0"]
    assert ref["requests"] == 0 and ref["tokens"] == 0
    assert ref["tok_s"] is None
    assert ref["cumulative"]["seconds"] == 0.0
    assert ref["shadow"]["requests"] == 3
    assert ref["shadow"]["tokens"] == 12
    assert ref["shadow"]["seconds"] > 0.0
    assert rep["0.5"]["requests"] == 3 and rep["0.5"]["tokens"] == 12
    assert rep["0.5"]["shadow"] == {"requests": 0, "tokens": 0,
                                    "seconds": 0.0}


def test_fleet_eos_frees_slot_and_reuses_it(setup):
    jp, tp, d = setup
    probe = tfleet.SparsityFleet.from_artifact(d, tp, BUDGETS, slots=3,
                                               capacity=32, device="cpu")
    r = probe.submit(P1, 8, budget="2:4")
    eos = probe.run()[r][0]
    tf, jf = _fleets(setup, slots=3, capacity=32, eos_id=eos)
    outs = []
    for f in (tf, jf):
        r1 = f.submit(P1, 8, budget="2:4")
        r2 = f.submit(P2, 4, budget="2:4")
        out = f.run()
        outs.append((out[r1], out[r2]))
    assert outs[0] == outs[1]
    assert outs[0][0] == [eos] and len(outs[0][1]) == 4
    bank = MaskBank.load(d, device="cpu")
    fresh = tengine.ServeEngine(CFG, bank.sparse_params(tp, nm=(2, 4)),
                                slots=1, capacity=32, eos_id=eos,
                                device="cpu")
    rf = fresh.submit(P2, 4)
    assert fresh.run()[rf] == outs[0][1]


def test_fleet_slot_pool_partition(setup):
    jp, tp, d = setup
    fleet = tfleet.SparsityFleet.from_artifact(d, tp, BUDGETS, slots=7,
                                               capacity=32, device="cpu")
    assert [fleet.engines[n].slots for n in BUDGETS] == [3, 2, 2]
    assert tfleet._partition_slots(7, 3) == jfleet._partition_slots(7, 3)
    with pytest.raises(ValueError, match="slots"):
        tfleet.SparsityFleet.from_artifact(d, tp, BUDGETS, slots=2,
                                           capacity=32, device="cpu")
    with pytest.raises(ValueError, match="duplicate"):
        tfleet.SparsityFleet.from_artifact(d, tp, ["0.5", 0.5], capacity=32,
                                           device="cpu")
    assert len({id(fleet.engines[n].fns) for n in BUDGETS}) == 1


def test_fleet_agreement_matrix_matches_reference(setup):
    tf, jf = _fleets(setup, slots=6, capacity=32)
    got = tf.agreement_matrix([P1, P2], max_tokens=4)
    want = jf.agreement_matrix([P1, P2], max_tokens=4)
    assert got == want
    _same_report(tf, jf)


def test_masks_grid_matches_reference(setup):
    jp, tp, d = setup
    got = MaskBank.load(d, device="cpu").masks_grid([0.3, 0.6])
    want = JaxMaskBank.load(d).masks_grid([0.3, 0.6])
    assert list(got) == list(want) == [0.3, 0.6]
    for s in want:
        for (path, a), b in zip(tree.flatten_with_path(got[s]),
                                jax.tree.leaves(want[s], is_leaf=lambda x:
                                                x is None)):
            if a is None:
                continue
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=path)


@pytest.mark.parametrize("budget", BUDGETS)
def test_vmap_decode_equals_fused_on_both_packages(setup, budget):
    """The reference's parity oracle: each slot decoding alone at its own
    position gives the fused engine's streams, in both packages (requests
    admitted mid-batch into freed slots, at different positions)."""
    jp, tp, d = setup
    reqs = [(P1, 6), (P2, 3), (np.array([1, 2]), 5)]
    streams = {}
    for pkg, p in (("torch", tp), ("jax", jp)):
        for mode in ("fused", "vmap"):
            if pkg == "torch":
                bank = MaskBank.load(d, device="cpu")
                eng = tengine.ServeEngine(
                    CFG, _budget_params(bank, p, budget), slots=2,
                    capacity=32, decode_mode=mode, device="cpu")
            else:
                bank = JaxMaskBank.load(d)
                eng = jengine.ServeEngine(
                    JCFG, _budget_params(bank, p, budget), slots=2,
                    capacity=32, decode_mode=mode)
            rids = [eng.submit(x, m) for x, m in reqs]
            res = eng.run()
            streams[pkg, mode] = [res[r] for r in rids]
    assert len(set(map(str, streams.values()))) == 1, streams


def _budget_params(bank, params, budget):
    if budget == "0.0":
        return params
    if budget == "0.5":
        return bank.sparse_params(params, sparsity=0.5, compressed=False)
    return bank.sparse_params(params, nm=(2, 4))


def test_mismatched_shared_fns_raises(setup):
    jp, tp, d = setup
    fns = tengine.EngineFns(CFG, 32, tengine.resolve_device("cpu"))
    tengine.ServeEngine(CFG, tp, slots=1, capacity=32, fns=fns,
                        device="cpu")
    for kw in ({"capacity": 64}, {"decode_mode": "vmap"},
               {"kv_shards": 1}):
        with pytest.raises(ValueError, match="shared EngineFns"):
            tengine.ServeEngine(CFG, tp, slots=1, fns=fns, device="cpu",
                                **{"capacity": 32, **kw})
    # the reference refuses the same mismatches
    jfns = jengine.EngineFns(JCFG, 32)
    for kw in ({"capacity": 64}, {"decode_mode": "vmap"}):
        with pytest.raises(ValueError, match="shared EngineFns"):
            jengine.ServeEngine(JCFG, jp, slots=1, fns=jfns,
                                **{"capacity": 32, **kw})
