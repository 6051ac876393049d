"""repro_torch's activation-statistics tapes and MoE calibration against the
JAX reference's, in one process: the eager ``StatsTape`` oracle and
``resolve_stats``, ``collect_stats(impl="jit" | "tape")``, ``stats_parity``,
the MoE expert-bank hook with its routed-row rescale, a 5-step MoE
calibration on the committed trained ``moe-tiny``, and each package
loading the other's MoE bank.

Tolerances, and why:

* dense stats (smoke llama, jit and tape): rtol 2**-8 elementwise, one
  bf16 unit, as tests/test_torch_calibrate.py.  The port's forward mirrors
  the *jitted* reference's roundings (ROADMAP R5, R6), so against the
  reference's eager tape the attention leaves differ by more: there the
  aggregate relative Frobenius error of each leaf (``stats_parity``'s
  measure) is held to 2e-2 (observed 1.5e-3 on moe-tiny).
* MoE expert banks: the aggregate error per leaf, 1e-2 for the jitted pass
  (observed 2.4e-3), 2e-2 against the reference's eager tape (observed
  7.9e-3).  A near-tied router can send a token to another expert in the
  two passes, moving a whole row between expert stats (layers 2-3 of
  moe-tiny: up to 5% in single (layer, expert) rows), which is why the
  reference's own ``stats_parity`` is aggregate.  Non-expert leaves of the
  jitted pass: rtol 2**-8 elementwise.  The port's tape against its own
  jitted pass: ``stats_parity`` <= 1e-6 on moe-tiny (the same forward;
  observed 3.8e-8) and <= 1e-3 on the dense llama, whose MLP down stats
  the jitted pass takes from the f32 product and the tape from the bf16
  one, as the reference's do (observed 2.9e-4).
* the routed-row rescale on a router that starves one expert: rtol 2**-8
  against the reference, and the starved expert exactly 0 on both.
* the MoE search on the reference's stats (wanda 2:4 and stochria
  unstructured, 5 steps): Gamma/V within 1e-4 of the leaf's max|V|
  (observed 2.4e-6) and the masks equal but for counted near-ties, as
  tests/test_torch_calibrate.py's search; each package loads the other's
  MoE bank bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (_near_ties, f64, jax_flat, jax_params_to_torch,
                         leaf_pairs, smoke_llama, tiny_model, to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_config as jax_get_config
from repro.core import calibrate as jcal
from repro.core import mirror as jmirror
from repro.core.prunable import prunable_map as jprunable_map
from repro.data.synthetic import batches_for
from repro.launch import calibrate as jlaunch
from repro.models import model as JM
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import mirror as tmirror
from repro_torch.core import tape as tape_mod
from repro_torch.core.prunable import prunable_map
from repro_torch.launch import calibrate as tlaunch
from repro_torch.sparse.bank import MaskBank

BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one intra-op thread, and restores the count
    after: these tests run beside others in parallel worker processes,
    where every process's full thread pool would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _aggregate(want, got) -> dict:
    """keystr path -> relative Frobenius error of the port's leaf."""
    return {path: float(np.linalg.norm(f64(tv) - f64(jv))
                        / np.linalg.norm(f64(jv)))
            for path, jv, tv in leaf_pairs(want, got)}


@pytest.fixture(scope="module")
def moe():
    jcfg, cfg, jp, tp = tiny_model("moe-tiny")
    calib = batches_for(jcfg, n=8, batch=4, seq=64, split="calib")
    return jcfg, cfg, jp, tp, calib


def test_dense_tape_and_jit_stats_match_reference():
    jcfg, cfg, jp, tp, calib = smoke_llama()
    calib = calib[:2]
    jtape = jcal.collect_stats(jcfg, jp, calib, impl="tape")
    jjit = jcal.collect_stats(jcfg, jp, calib, impl="jit")
    ttape = tcal.collect_stats(cfg, tp, calib, impl="tape")
    tjit = tcal.collect_stats(cfg, tp, calib, impl="jit")
    for path, jv, tv in leaf_pairs(jjit, tjit):
        np.testing.assert_allclose(f64(tv), f64(jv), rtol=BF16_ULP,
                                   err_msg=path)
    assert [p for p, _, _ in leaf_pairs(jtape, ttape)] == \
        [p for p, _, _ in leaf_pairs(jjit, tjit)]
    agg = _aggregate(jtape, ttape)
    print(f"dense tape vs the reference's tape: worst aggregate "
          f"{max(agg.values()):.2e}")
    assert max(agg.values()) <= 2e-2
    for path, tv in tree.flatten_with_path(ttape):
        assert (tv is None) == (jax_flat(jtape)[path] is None), path
        assert tv is None or tv.dtype == torch.float32
    worst, ok, n = tcal.stats_parity(ttape, tjit, prunable_map(tp))
    jworst = jcal.stats_parity(jtape, jjit, jprunable_map(jp))[0]
    print(f"tape vs jit: torch {worst:.2e}, jax {jworst:.2e}")
    assert ok and n == 7 and worst <= 1e-3, worst
    # the criterion itself: the reference's, on the same trees
    jw, jok, jn = jcal.stats_parity(jtape, jjit, jprunable_map(jp))
    tw, tok, tn = tcal.stats_parity(
        tree.tree_map(lambda a: None if a is None else to_torch(a),
                      jax.device_get(jtape)),
        tree.tree_map(lambda a: None if a is None else to_torch(a),
                      jax.device_get(jjit)), prunable_map(tp))
    assert (tok, tn) == (jok, jn) and abs(tw - jw) <= 1e-12 * max(jw, 1)


def test_collect_stats_refuses_unknown_impl_and_empty_calibration():
    jcfg, cfg, jp, tp, calib = smoke_llama()
    with pytest.raises(ValueError, match="unknown stats impl"):
        tcal.collect_stats(cfg, tp, calib[:1], impl="eager")
    with pytest.raises(ValueError, match="at least one"):
        tcal.collect_stats(cfg, tp, [], impl="tape")


def test_moe_stats_match_reference(moe):
    jcfg, cfg, jp, tp, calib = moe
    calib = calib[:4]
    out = {}
    for impl in ("jit", "tape"):
        want = jcal.collect_stats(jcfg, jp, calib, impl=impl)
        got = tcal.collect_stats(cfg, tp, calib, impl=impl)
        agg = _aggregate(want, got)
        out[impl] = (want, got)
        for path, jv, tv in leaf_pairs(want, got):
            assert tuple(tv.shape) == tuple(jv.shape), path
            expert = "['moe']" in path
            if expert:
                assert tv.dim() == 3            # (L, E, K)
            bound = (1e-2 if impl == "jit" else 2e-2) if expert else 2e-2
            assert agg[path] <= bound, (impl, path, agg[path])
            if impl == "jit" and not expert:
                np.testing.assert_allclose(f64(tv), f64(jv), rtol=BF16_ULP,
                                           err_msg=path)
        print(f"moe-tiny {impl}: worst aggregate error "
              f"{max(agg.values()):.2e}")
    pr = prunable_map(tp)
    worst, ok, n = tcal.stats_parity(out["tape"][1], out["jit"][1], pr)
    assert ok and n == 7 and worst <= 1e-6, worst
    jworst, jok, _ = jcal.stats_parity(out["tape"][0], out["jit"][0],
                                       jprunable_map(jp))
    print(f"stats_parity tape vs jit: torch {worst:.2e}, jax {jworst:.2e}")
    assert jok


def _starved_moe_layer():
    """One mixtral-shaped MoE layer (d 32, 8 experts, top-2) from the
    reference's init, and positive inputs against which expert 3's router
    column is all negative: it is never picked."""
    over = dict(d_model=32, num_layers=1, num_heads=2, num_kv_heads=1,
                head_dim=16, moe_d_ff=48, vocab_size=64)
    jcfg = dataclasses.replace(jax_get_config("mixtral-8x22b"), **over)
    jp = JM.init_params(jcfg, jax.random.key(3))
    jl = jax.tree.map(lambda a: a[0], jp["stages"][0])["0"]["moe"]
    router = np.array(jl["router"]["kernel"])
    router[:, 3] = -np.abs(router).max()
    jl["router"]["kernel"] = jnp.asarray(router)
    x = np.abs(np.random.default_rng(1).standard_normal((2, 24, 32)))
    return jl, jax_params_to_torch(jl), x.astype(np.float32), jcfg.top_k


@pytest.mark.parametrize("impl", ["jit", "tape"])
def test_routed_row_rescale_and_starved_expert(impl):
    """The expert-bank hook on one layer, under each package's tape: the
    sums of squares of the dispatch buffer rescaled by T / routed rows per
    expert, the starved expert's exactly 0."""
    from repro.core import tape as jtape_mod
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    jl, tl, x, top_k = _starved_moe_layer()
    counts = {}

    def spy(base, name):
        class Spy(base):
            def record(self, kernel, x, *, count=None, ref_count=None):
                counts[name] = (np.asarray(count).copy(), ref_count)
                super().record(kernel, x, count=count, ref_count=ref_count)
        return Spy()

    jt = spy(jtape_mod.JitTape if impl == "jit" else jtape_mod.StatsTape,
             "jax")
    tt = spy(tape_mod.JitTape if impl == "jit" else tape_mod.StatsTape,
             "torch")
    jt.register_layer(jl, "", 0)
    tt.register_layer(tl, "", 0)
    with jtape_mod.recording(jt):
        jmoe.moe_apply(jl, jnp.asarray(x).astype(jnp.bfloat16), top_k=top_k)
    with tape_mod.recording(tt):
        tmoe.moe_apply(tl, torch.from_numpy(x).to(torch.bfloat16),
                       top_k=top_k)
    jc, T = counts["jax"]
    tc, tT = counts["torch"]
    np.testing.assert_array_equal(tc, jc)
    # kept assignments only: an expert past its capacity drops the rest
    assert T == tT == 48 and tc.sum() <= 48 * top_k and tc[3] == 0
    want = jt.out if impl == "jit" else jt.sumsq
    got = tt.out if impl == "jit" else tt.sumsq
    assert set(want) == set(got) == {(f"['{k}']['kernel']", 0)
                                     for k in ("up", "gate", "down")}
    for key, jv in want.items():
        tv = got[key]
        tv = tv.double().numpy() if isinstance(tv, torch.Tensor) else tv
        jv = np.asarray(jv, np.float64)
        assert tv.shape == jv.shape == (8, 48 if "down" in key[0] else 32)
        np.testing.assert_allclose(tv, jv, rtol=BF16_ULP, err_msg=key[0])
        # an expert with no rows stays 0, every other one has stats
        np.testing.assert_array_equal(tv.max(axis=-1) > 0, tc > 0)
        np.testing.assert_array_equal(jv.max(axis=-1) > 0, tc > 0)
    from repro_torch.models.moe import capacity
    assert tc.max() == capacity(48, top_k, 8)     # this router overflows


# --- MoE calibration ---------------------------------------------------------

MOE_PCFGS = {"wanda nm": dict(local_metric="wanda", mode="nm", steps=5),
             "stochria unstructured": dict(local_metric="stochria",
                                           mode="unstructured", steps=5)}


@pytest.mark.parametrize("name", list(MOE_PCFGS))
def test_moe_calibration_matches_reference(moe, name, tmp_path):
    jcfg, cfg, jp, tp, calib = moe
    kw = MOE_PCFGS[name]
    jbank = jlaunch.calibrate_to_bank(
        tmp_path / "jax", cfg=jcfg, pcfg=JaxPruneConfig(**kw), params=jp,
        calib=calib, arch="moe-tiny", smoke=False, log_every=1)
    # the search on the reference's stats: expert leaves (L, E, K, N)
    # through the fused step, prox24 and nm_mask24 as (L*E*K, N) views
    stats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                          jax.device_get(jbank.stats))
    state, hist = tcal.run_search(cfg, PruneConfig(**kw), tp, calib, stats,
                                  log_every=1)
    assert state.step == 5 and len(hist) == 5
    for nm in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jbank, nm),
                                       getattr(state, nm)):
            scale = np.abs(f64(jax_flat(jbank.V)[path])).max()
            np.testing.assert_allclose(f64(tv), f64(jv), rtol=0,
                                       atol=1e-4 * scale, err_msg=nm + path)
    budgets = [0.5] if kw["mode"] == "nm" else [0.5, 0.6]
    ties = 0
    for s in budgets:
        want = jmirror.export_masks(jbank.pcfg, jbank.Gamma, s, V=jbank.V)
        got = tmirror.export_masks(PruneConfig(**kw), state.Gamma, s,
                                   V=state.V)
        for path, jv, tv in leaf_pairs(want, got):
            jk, tk = np.asarray(jv), tv.numpy()
            if kw["mode"] == "nm" and (jk != tk).any():
                G = f64(jax_flat(jbank.Gamma)[path])
                err = np.abs(f64(dict(tree.flatten_with_path(
                    state.Gamma))[path]) - G)
                for _, margin, tol in _near_ties(np.abs(G), jk, tk,
                                                 np.full_like(G, err.max())):
                    assert 0 <= margin <= tol, (path, margin, tol)
                    ties += 1
            elif (jk != tk).any():
                raise AssertionError(f"unstructured masks differ at {path}")
    print(f"moe-tiny {name}: {ties} near-tied groups differ")
    assert ties <= 2
    # the banks across packages: the port's search state saved by its
    # MaskBank (the reference's stats) and the reference's bank
    tbank = MaskBank.save(tmp_path / "torch", arch="moe-tiny", smoke=False,
                          state=state, stats=stats, pcfg=PruneConfig(**kw),
                          cfg=cfg)
    from_t = JaxMaskBank.load(tmp_path / "torch", cfg=jcfg)
    from_j = MaskBank.load(tmp_path / "jax", cfg=cfg, device="cpu")
    for key in ("schema", "format_version", "pcfg", "steps_run"):
        assert tbank.meta[key] == jbank.meta[key], key
    for nm in ("Gamma", "V", "stats"):
        for path, jv, tv in leaf_pairs(getattr(from_t, nm),
                                       getattr(tbank, nm)):
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                          err_msg=nm + path)
        for path, jv, tv in leaf_pairs(getattr(jbank, nm),
                                       getattr(from_j, nm)):
            np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                          err_msg=nm + path)
    s = budgets[-1] if kw["mode"] != "nm" else None
    for path, jv, tv in leaf_pairs(from_t.masks_at(sparsity=s),
                                   tbank.masks_at(sparsity=s)):
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(),
                                      err_msg=path)
    expert = [tuple(tv.shape) for path, _, tv in
              leaf_pairs(jbank.stats, from_j.stats) if "['moe']" in path]
    assert sorted(expert) == [(4, 4, 128), (4, 4, 128), (4, 4, 256)]


def test_calibrate_launcher_stats_impl_tape(tmp_path, capsys):
    tlaunch.main(["--arch", "llama3.2-1b", "--smoke", "--out",
                  str(tmp_path / "bank"), "--steps", "2", "--calib-n", "2",
                  "--stats-batches", "2", "--seq", "16", "--stats-impl",
                  "tape", "--device", "cpu"])
    assert "via tape" in capsys.readouterr().out
    bank = JaxMaskBank.load(tmp_path / "bank")
    assert bank.meta["stats_impl"] == "tape" and bank.meta["steps_run"] == 2
