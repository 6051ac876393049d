"""repro_torch self-speculative decoding (``serve.spec``) against the JAX
reference: the cases of tests/test_spec.py, each checked two ways.

* Lossless, as the JAX tests hold it: the port's spec streams equal the
  port's verifier decoding alone, whatever the draft proposes.
* Against the JAX ``SpecDecoder`` on the same params (the reference's
  ``init_params(cfg, jax.random.key(0))``, carried across): the same
  streams, and the same ``summary()`` and ``stats`` counters (every key
  but the seconds and tok/s).  The fleet cases run both packages' fleets
  on one JAX-written bank.
"""
import dataclasses

import jax
import numpy as np
import pytest

from _torch_port import jax_params_to_torch
from repro.configs.base import PruneConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.core import masks as jmasks
from repro.core import metrics as jmetrics
from repro.core.prunable import prunable_map
from repro.data.synthetic import batches_for
from repro.models import model as JM
from repro.serve import engine as jengine
from repro.serve import fleet as jfleet
from repro.serve import spec as jspec
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro_torch.configs.base import get_smoke_config
from repro_torch.serve import engine as tengine
from repro_torch.serve import fleet as tfleet
from repro_torch.serve import spec as tspec

JCFG = jax_smoke_config("llama3.2-1b")
CFG = get_smoke_config("llama3.2-1b")
PROMPTS = [np.array([5, 6, 7, 8]), np.array([9, 10, 11]), np.array([1, 2])]
# summary() keys that time the run, not count it
TIMED = {"seconds", "tok_s"}


@dataclasses.dataclass
class Pkg:
    """One package's serving classes behind one calling convention."""
    name: str
    engine_mod: object
    spec_mod: object
    fleet_mod: object

    def fns(self, capacity):
        if self.name == "jax":
            return self.engine_mod.EngineFns(JCFG, capacity)
        return self.engine_mod.EngineFns(CFG, capacity, _cpu())

    def engine(self, params, *, slots, capacity, eos_id=None, fns=None):
        if self.name == "jax":
            return self.engine_mod.ServeEngine(
                JCFG, params, slots=slots, capacity=capacity, fns=fns,
                eos_id=eos_id)
        return self.engine_mod.ServeEngine(
            CFG, params, slots=slots, capacity=capacity, fns=fns,
            eos_id=eos_id, device="cpu")

    def fleet(self, bank_dir, params, budgets, **kw):
        extra = {} if self.name == "jax" else {"device": "cpu"}
        return self.fleet_mod.SparsityFleet.from_artifact(
            bank_dir, params, budgets, **kw, **extra)


def _cpu():
    import torch
    return torch.device("cpu")


JAX = Pkg("jax", jengine, jspec, jfleet)
TORCH = Pkg("torch", tengine, tspec, tfleet)


@pytest.fixture(scope="module")
def params():
    """name -> (jax params, the same params in torch)."""
    jp = JM.init_params(JCFG, jax.random.key(0))
    pr = prunable_map(jp)
    scores = jmetrics.metric_tree(
        "magnitude", jp, jax.tree.map(lambda _: None, pr), pr)
    masked = jmasks.apply_masks(
        jp, jmasks.unstructured_masks(scores, sparsity=0.5))
    # boosting one tied-embedding row pins the draft's argmax to token 7
    boosted = np.asarray(jp["embed"]["table"]).copy()
    boosted[7] *= 100.0
    bad = dict(jp, embed={"table": jax.numpy.asarray(boosted)})
    return {name: (p, jax_params_to_torch(p))
            for name, p in (("dense", jp), ("masked", masked),
                            ("bad", bad))}


def _side(pair, pkg):
    return pair[0] if pkg is JAX else pair[1]


def _oracle(pkg, params, prompts, gen, *, capacity=32, eos_id=None):
    eng = pkg.engine(params, slots=len(prompts), capacity=capacity,
                     eos_id=eos_id)
    rids = [eng.submit(p, gen) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids]


def _pair(pkg, verify, draft, *, slots=3, capacity=32, eos_id=None, **kw):
    fns = pkg.fns(capacity)
    v = pkg.engine(verify, slots=slots, capacity=capacity, fns=fns,
                   eos_id=eos_id)
    d = pkg.engine(draft, slots=slots, capacity=capacity, fns=fns,
                   eos_id=eos_id)
    return pkg.spec_mod.SpecDecoder(d, v, **kw)


def _counters(sd):
    return ({k: v for k, v in sd.summary().items() if k not in TIMED},
            {k: v for k, v in sd.stats.items() if k not in TIMED})


def _both(run):
    """``run(pkg)`` on both packages -> (torch result, jax result); the
    streams and counters it returns must be equal."""
    got, want = run(TORCH), run(JAX)
    assert got == want
    return got


@pytest.mark.parametrize("drafts,verified", [
    ([3, 4, 5], [3, 4, 5]), ([3, 4, 5], [9, 4, 5]), ([3, 4, 5], [3, 4, 7]),
    ([3], [3]), ([3], [8]), ([1, 2, 3, 4], [1, 2, 3, 9])])
def test_accept_commit_edges(drafts, verified):
    want = {((3, 4, 5), (3, 4, 5)): (3, [3, 4, 5]),
            ((3, 4, 5), (9, 4, 5)): (0, [9]),
            ((3, 4, 5), (3, 4, 7)): (2, [3, 4, 7]),
            ((3,), (3,)): (1, [3]), ((3,), (8,)): (0, [8])}
    got = tspec.accept_commit(drafts, verified)
    assert got == jspec.accept_commit(drafts, verified)
    key = (tuple(drafts), tuple(verified))
    if key in want:
        assert got == want[key]


def test_spec_is_lossless_with_identical_params(params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        want = _oracle(pkg, p, PROMPTS, 8)
        sd = _pair(pkg, p, p, k=3, k_max=6, init_accept=0.9)
        rids = [sd.submit(x, 8) for x in PROMPTS]
        res, foreign = sd.run()
        assert [res[r] for r in rids] == want
        assert foreign == {"draft": {}, "verify": {}}
        assert sd.stats["rollbacks"] == 0
        assert sd.stats["accepted_draft_tokens"] == sd.stats["tokens"]
        assert sd.k > 3
        s = sd.summary()
        assert s["accept_rate"] == 1.0 and s["tokens"] == sum(map(len, want))
        return want, _counters(sd)
    _both(run)


def test_spec_is_lossless_with_divergent_draft(params):
    def run(pkg):
        want = _oracle(pkg, _side(params["dense"], pkg), PROMPTS, 8)
        assert not any(7 in w for w in want)  # the pin genuinely disagrees
        sd = _pair(pkg, _side(params["dense"], pkg),
                   _side(params["bad"], pkg), k=4, init_accept=0.9)
        rids = [sd.submit(x, 8) for x in PROMPTS]
        res, _ = sd.run()
        assert [res[r] for r in rids] == want
        assert sd.stats["rollbacks"] > 0
        assert sd.summary()["accept_rate"] < 1.0
        return want, _counters(sd)
    _both(run)


def test_spec_masked_draft_lossless_and_accepting(params):
    def run(pkg):
        want = _oracle(pkg, _side(params["dense"], pkg), PROMPTS, 10)
        sd = _pair(pkg, _side(params["dense"], pkg),
                   _side(params["masked"], pkg), k=4, k_max=8)
        rids = [sd.submit(x, 10) for x in PROMPTS]
        res, _ = sd.run()
        assert [res[r] for r in rids] == want
        assert 0.0 <= sd.summary()["accept_rate"] <= 1.0
        return want, _counters(sd)
    _both(run)


def test_spec_eos_truncates_inside_accepted_run(params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        base = _oracle(pkg, p, [PROMPTS[0]], 8)[0]
        eos = base[2]
        want = base[:base.index(eos) + 1]
        sd = _pair(pkg, p, p, slots=1, eos_id=eos, k=4, init_accept=0.9)
        r1 = sd.submit(PROMPTS[0], 8)
        r2 = sd.submit(PROMPTS[1], 4)
        res, _ = sd.run()
        assert res[r1] == want
        assert res[r1][-1] == eos and eos not in res[r1][:-1]
        assert res[r2] == _oracle(pkg, p, [PROMPTS[1]], 4, eos_id=eos)[0]
        assert all(r is None for r in sd.draft_eng.active)
        assert all(r is None for r in sd.verify_eng.active)
        return [res[r1], res[r2]], _counters(sd)
    _both(run)


def test_spec_max_tokens_not_a_multiple_of_k(params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        want = _oracle(pkg, p, PROMPTS, 6)
        sd = _pair(pkg, p, p, k=4, k_min=4, k_max=4, adaptive=False)
        rids = [sd.submit(x, 6) for x in PROMPTS]
        res, _ = sd.run()
        assert [res[r] for r in rids] == want
        assert all(len(res[r]) == 6 for r in rids)
        return want, _counters(sd)
    _both(run)


def test_spec_zero_and_one_token_requests(params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        sd = _pair(pkg, p, p, k=4)
        r0 = sd.submit(PROMPTS[0], 0)
        r1 = sd.submit(PROMPTS[0], 1)
        res, _ = sd.run()
        assert res[r0] == []
        assert res[r1] == _oracle(pkg, p, [PROMPTS[0]], 1)[0]
        return [res[r0], res[r1]], _counters(sd)
    _both(run)


def test_spec_k_eff_clamps_at_capacity_and_stays_lossless(params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        cap, gen = 16, 18     # positions run past capacity: wraps
        want = _oracle(pkg, p, [PROMPTS[0]], gen, capacity=cap)
        sd = _pair(pkg, p, p, slots=1, capacity=cap, k=8, k_min=8, k_max=8,
                   adaptive=False, init_accept=0.9)
        rid = sd.submit(PROMPTS[0], gen)
        res, _ = sd.run()
        assert res[rid] == want[0]
        assert sd.stats["draft_positions"] < 8 * sd.stats["pair_rounds"]
        return want, _counters(sd)
    _both(run)


def test_spec_constructor_validation(params):
    p = params["dense"][1]
    eng_a = TORCH.engine(p, slots=1, capacity=32)
    eng_b = TORCH.engine(p, slots=1, capacity=32)
    with pytest.raises(ValueError, match="distinct"):
        tspec.SpecDecoder(eng_a, eng_a)
    with pytest.raises(ValueError, match="capacity"):
        tspec.SpecDecoder(eng_a, TORCH.engine(p, slots=1, capacity=64))
    with pytest.raises(ValueError, match="eos_id"):
        tspec.SpecDecoder(eng_a, TORCH.engine(p, slots=1, capacity=32,
                                              eos_id=7))
    with pytest.raises(ValueError, match="k_min"):
        tspec.SpecDecoder(eng_a, eng_b, k=9, k_max=8)
    # windowed rings evict live rows on speculative writes: rejected (the
    # smoke mixtral: moe_local layers over a 16-slot window)
    from repro_torch.models import model as TM
    wcfg = get_smoke_config("mixtral-8x22b")
    wp = TM.init_params(wcfg, 0, device="cpu")
    wa, wb = (tengine.ServeEngine(wcfg, wp, slots=1, capacity=32,
                                  device="cpu") for _ in range(2))
    with pytest.raises(ValueError, match="sliding|window|kinds"):
        tspec.SpecDecoder(wa, wb)
    # recurrent state cannot roll back: rejected on the config alone (the
    # port's engine does not serve xlstm yet, so the pair is two stand-ins
    # carrying what the check reads)
    import types
    xcfg = dataclasses.replace(CFG, pattern=("mlstm", "slstm"))
    xa, xb = (types.SimpleNamespace(cfg=xcfg, capacity=32, eos_id=None)
              for _ in range(2))
    with pytest.raises(ValueError, match="kinds"):
        tspec.SpecDecoder(xa, xb)


@pytest.mark.parametrize("text", ["draft:2:4,verify:0.0,k:4",
                                  "draft:0.5,k:3,k_max:6,adaptive:false,"
                                  "ema:0.5", "k:2, draft:2:4 ,", ""])
def test_parse_spec_strings(text):
    got = tspec.parse_spec(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jspec.parse_spec(text))
    assert tspec.parse_spec(got) is got
    for bad, match in (("draft=0.5", "key:value"),
                       ("depth:4", "unknown spec key")):
        with pytest.raises(ValueError, match=match):
            tspec.parse_spec(bad)


# -- fleet routing ----------------------------------------------------------

@pytest.fixture(scope="module")
def bank_dir(tmp_path_factory, params):
    jp = params["dense"][0]
    calib = batches_for(JCFG, n=2, batch=2, seq=16, split="calib")
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=2)
    stats = jcal.collect_stats(JCFG, jp, calib)
    state, _ = jcal.run_search(JCFG, pcfg, jp, calib, stats)
    d = tmp_path_factory.mktemp("specfleet") / "bank"
    JaxMaskBank.save(d, arch="llama3.2-1b", smoke=True, state=state,
                     stats=stats, pcfg=pcfg)
    return d


def _fleet_counters(rep):
    """report() without its timings."""
    budgets = {n: {k: (v if k != "cumulative" else
                       {c: x for c, x in v.items() if c != "seconds"})
                   for k, v in r.items()
                   if k not in ("tok_s", "shadow")}
               for n, r in rep["budgets"].items()}
    spec = (None if rep["spec"] is None else
            {k: v for k, v in rep["spec"].items() if k not in TIMED})
    return rep["reference"], budgets, spec


def test_fleet_spec_routing_is_lossless_and_reported(bank_dir, params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        budgets = ["0.0", "0.5"]
        oracle = pkg.fleet(bank_dir, p, budgets, slots=4, capacity=32)
        rids = [oracle.submit(x, 8, budget="0.0") for x in PROMPTS]
        res = oracle.run()
        want = [res[r] for r in rids]
        fleet = pkg.fleet(bank_dir, p, budgets, slots=4, capacity=32,
                          spec="draft:0.5,k:3")
        srids = [fleet.submit(x, 8, spec=True) for x in PROMPTS]
        out = fleet.run()
        assert [out[r] for r in srids] == want
        rep = fleet.report()
        assert rep["spec"]["requests"] == len(PROMPTS)
        assert rep["spec"]["tokens"] == sum(map(len, want))
        assert rep["spec"]["tok_s"] is None or rep["spec"]["tok_s"] > 0
        assert 0.0 <= rep["spec"]["accept_rate"] <= 1.0
        assert (rep["spec"]["draft"], rep["spec"]["verify"]) == ("0.5", "0.0")
        return want, _fleet_counters(rep)
    _both(run)


def test_fleet_spec_interleaves_foreign_member_traffic(bank_dir, params):
    def run(pkg):
        p = _side(params["dense"], pkg)
        budgets = ["0.0", "0.5"]
        oracle = pkg.fleet(bank_dir, p, budgets, slots=4, capacity=32)
        rp = oracle.submit(PROMPTS[2], 6, budget="0.5")
        want_pin = oracle.run()[rp]
        fleet = pkg.fleet(bank_dir, p, budgets, slots=4, capacity=32,
                          spec="draft:0.5,k:3")
        pin = fleet.submit(PROMPTS[2], 6, budget="0.5")
        srids = [fleet.submit(x, 8, spec=True) for x in PROMPTS[:2]]
        out = fleet.run()
        assert out[pin] == want_pin
        assert all(len(out[r]) == 8 for r in srids)
        cum = fleet.report()["budgets"]["0.5"]["cumulative"]
        assert cum["spec_phase_tokens"] == len(want_pin)
        return [out[pin]] + [out[r] for r in srids], _fleet_counters(
            fleet.report())
    _both(run)


def test_fleet_spec_bad_member_and_reconfigure(bank_dir, params):
    fleet = TORCH.fleet(bank_dir, params["dense"][1], ["0.0", "0.5"],
                        slots=2, capacity=32)
    with pytest.raises(KeyError, match="spec member"):
        fleet.submit(PROMPTS[0], 4, spec="draft:2:4")
    with pytest.raises(ValueError, match="both"):
        fleet.submit(PROMPTS[0], 4, spec="draft:0.0")
    fleet.submit(PROMPTS[0], 4, spec="draft:0.5,k:2")
    with pytest.raises(ValueError, match="reconfigure"):
        fleet.submit(PROMPTS[0], 4, spec="draft:0.5,k:3")
    with pytest.raises(ValueError, match="exactly one"):
        fleet.submit(PROMPTS[0], 4)
    assert [len(v) for v in fleet.run().values()] == [4]
