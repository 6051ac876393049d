"""repro_torch serving, calibrating and evaluating the smoke xlstm-125m
(alternating mLSTM / sLSTM blocks, no attention) against the JAX
reference on the CPU, in one process.

The smoke config's sLSTM ff_down is int(64 * 4/3) = 85 deep, no multiple
of 4, so at smoke width xlstm takes unstructured budgets only and serves
masked-dense, as the reference does (at the published width ff_down is
1024 deep and 2:4 compresses: chip_smoke.py phase 14).  One set of params
is drawn (the port's ``init_params``, seed 0) and carried to the
reference as jax arrays.

Tolerances, and why (tests/test_torch_zamba.py's):

* logits: 4 bf16 ulps of the largest logit (ROADMAP R8; measured 1.6);
* the states after prefill and decode: within 5e-2 of the leaf's
  largest value (bf16 rounding flips in the matmuls, carried by the f32
  states: measured 1.5e-2), the conv histories within 8 bf16 ulps;
* greedy streams: exactly, dense and masked at sparsity 0.5;
* the calibration (5 wanda unstructured steps): each package's own
  stats, layer 0's within rtol 2**-8 and the later layers' within 1e-2
  of their Frobenius norm and elementwise rtol 5e-2; then the search on
  the reference's stats (R5): Gamma and V within 1e-4 of the leaf's
  largest |V|, the masks at 0.5 (one global threshold) equal but for
  weights whose reference score is within twice that tolerance of the
  threshold;
* ``eval_ppl``: rtol 2e-3, on weights whose tied table is scaled by 1/16
  (the ppl of random smoke weights is clamped at exp(30)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (f64, jax_flat, leaf_pairs,  # noqa: F401
                         one_torch_thread, smoke_recurrent, to_jax, to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.core import calibrate as jcal
from repro.core import mirror as jmirror
from repro.data.synthetic import batches_for
from repro.models import model as JM
from repro.optim import losses as jlosses
from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import mirror as tmirror
from repro_torch.core.prunable import prunable_map
from repro_torch.models import model as TM
from repro_torch.optim import losses as tlosses
from repro_torch.serve import engine as tengine
from repro_torch.serve import spec as tspec
from repro_torch.sparse import apply as tapply

ARCH = "xlstm-125m"
CAPACITY = 32
GEN = 6
PCFG = dict(local_metric="wanda", mode="unstructured", steps=5,
            stats_batches=1)


@pytest.fixture(scope="module")
def model():
    m = smoke_recurrent(ARCH)
    tp = m["dense"][1]
    tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
        lambda _: None, tp), 0.5)
    masked = tapply.sparsify_params(tp, tm)
    m["masked"] = (to_jax(masked), masked)
    return m


def _ulps(want, n=4) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def test_prunable_leaves_and_published_width_feasibility(model):
    """Smoke: the 9 stacked prunable leaves (mLSTM up, wq, wk, wv, w_if,
    down; sLSTM w_in, ff_up, ff_down; not sLSTM's recurrent ``r`` nor the
    convs), ff_down 85 deep; the published width's ff_down is 1024 deep,
    so every prunable leaf takes 2:4 there (K % 8 == 0, N even: the
    compressed kernel's rules)."""
    _, cfg = model["cfg"]
    pm = dict(tree.flatten_with_path(prunable_map(model["dense"][1])))
    assert sum(pm.values()) == 9
    assert not pm["['stages'][0]['1']['slstm']['r']['kernel']"]
    assert model["dense"][1]["stages"][0]["1"]["slstm"]["ff_down"][
        "kernel"].shape[1] == 85
    full = get_config(ARCH)
    for path, shape in tree.flatten_with_path(TM.param_shapes(full)):
        if dict(tree.flatten_with_path(prunable_map(
                TM.param_specs(full))))[path]:
            K, N = shape[-2:]
            assert K % 8 == 0 and N % 2 == 0, (path, shape)
    assert TM.cache_lengths(cfg, CAPACITY) == set()


@pytest.mark.parametrize("weights", ["dense", "masked"])
def test_prefill_and_decode_logits_match_reference(model, weights):
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    tp = TM.serving_params(tp)
    B, P, steps = 2, 12, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (steps, B)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, cache_capacity=CAPACITY))(jp, toks)
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=CAPACITY)
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    for i in range(steps + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
        if i == steps:
            break
        t = np.array([P + i, P - 3 + i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))
    jf = jax_flat(jc)
    for path, leaf in tree.flatten_with_path(tc):
        w = np.asarray(jf[path], np.float32)
        tol = (_ulps(w, 8) if path.endswith("['conv']")
               else 5e-2 * float(np.abs(w).max()))
        np.testing.assert_allclose(leaf.float().numpy(), w, rtol=0,
                                   atol=tol, err_msg=path)


def _streams(eng, prompts, gen=GEN):
    rids = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("weights", ["dense", "masked"])
def test_engine_streams_equal_reference(model, weights):
    """4 requests on 2 slots, the third a one-token prompt admitted into a
    freed slot from the blank state; no attention, so no ``kv_shards``
    (refused)."""
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    want = _streams(jengine.ServeEngine(jcfg, jp, slots=2,
                                        capacity=CAPACITY), model["prompts"])
    eng = tengine.ServeEngine(cfg, tp, slots=2, capacity=CAPACITY,
                              device="cpu")
    assert _streams(eng, model["prompts"]) == want
    assert eng.prefill_calls == 3
    with pytest.raises(ValueError, match="no attention"):
        tengine.ServeEngine(cfg, tp, slots=2, capacity=CAPACITY,
                            device="cpu", kv_shards=1)


def test_spec_is_refused_as_in_the_reference(model):
    jcfg, cfg = model["cfg"]
    jp, tp = model["dense"]
    with pytest.raises(ValueError, match="recurrent") as want:
        jspec.SpecDecoder(*(jengine.ServeEngine(jcfg, jp, slots=2,
                                                capacity=CAPACITY)
                            for _ in range(2)))
    with pytest.raises(ValueError, match="recurrent") as got:
        tspec.SpecDecoder(*(tengine.ServeEngine(cfg, tp, slots=2,
                                                capacity=CAPACITY,
                                                device="cpu")
                            for _ in range(2)))
    assert str(got.value) == str(want.value)


def test_calibration_matches_reference(model):
    jcfg, cfg = model["cfg"]
    jp, tp = model["dense"]
    jpcfg, pcfg = JaxPruneConfig(**PCFG), PruneConfig(**PCFG)
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")
    jstats = jcal.collect_stats(jcfg, jp, calib, pcfg=jpcfg)
    for impl in ("jit", "tape"):
        tstats = tcal.collect_stats(cfg, tp, calib, pcfg=pcfg, impl=impl)
        pairs = leaf_pairs(jstats, tstats)
        assert len(pairs) == 9, impl
        for path, jv, tv in pairs:
            g, w = f64(tv), f64(jv)
            assert tuple(tv.shape) == tuple(jv.shape), path
            if path.startswith("['stages'][0]['0']"):
                # layer 0 of the stacked leaf: before any recurrent state
                np.testing.assert_allclose(g[0], w[0], rtol=2 ** -8,
                                           err_msg=impl + path)
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= 1e-2, (impl, path, err)
            np.testing.assert_allclose(g, w, rtol=5e-2, err_msg=impl + path)
    jstate, _ = jcal.run_search(jcfg, jpcfg, jp, calib, jstats)
    state, hist = tcal.run_search(
        cfg, pcfg, tp, calib, tree.tree_map(
            lambda a: None if a is None else to_torch(a),
            jax.device_get(jstats)), log_every=1)
    assert len(hist) == PCFG["steps"]
    tols = {}
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jstate, name),
                                       getattr(state, name)):
            scale = np.abs(f64(jax_flat(jstate.V)[path])).max()
            tols[path] = 1e-4 * scale
            np.testing.assert_allclose(f64(tv), f64(jv), rtol=0,
                                       atol=tols[path], err_msg=name + path)
    jm = jmirror.export_masks(jpcfg, jstate.Gamma, 0.5, V=jstate.V)
    tm = tmirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    # the reference's scores (|Gamma| + eps |V|) and its global threshold
    G, V = jax_flat(jstate.Gamma), jax_flat(jstate.V)
    paths = [p for p in G if G[p] is not None]
    gmax = max(np.abs(f64(G[p])).max() for p in paths)
    vmax = max(np.abs(f64(V[p])).max() for p in paths)
    eps = 1e-6 * gmax / vmax
    flips, n = 0, 0
    score = {p: np.abs(f64(G[p])) + eps * np.abs(f64(V[p])) for p in paths}
    jkeep = {p: np.asarray(k) for p, k, _ in leaf_pairs(jm, tm)}
    thr = min(score[p][jkeep[p]].min() for p in paths)
    for path, jk, tk in leaf_pairs(jm, tm):
        diff = np.asarray(jk) != tk.numpy()
        n += diff.size
        off = np.abs(score[path][diff] - thr)
        assert (off <= 2 * tols[path]).all(), (path, off.max())
        flips += int(diff.sum())
    print(f"xlstm smoke: {flips} of {n} weights differ, each a near-tie")
    assert flips <= n // 10000 + 2


@pytest.mark.parametrize("weights", ["dense", "masked"])
def test_eval_ppl_matches_reference(model, weights):
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]

    def shrink(path, a):
        return a / 16 if path == "['embed']['table']" else a
    tp = tree.map_with_path(shrink, tp)
    jp = jax.tree_util.tree_map_with_path(
        lambda kp, a: shrink(jax.tree_util.keystr(kp), a), jp)
    valid = batches_for(jcfg, n=2, batch=2, seq=32, split="valid")
    want = jlosses.eval_ppl(jcfg, jp, valid)
    got = tlosses.eval_ppl(cfg, tp, valid)
    assert 10 < want < 5000
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_launchers_run_xlstm_smoke_on_cpu(capsys, tmp_path):
    from repro_torch.launch import calibrate as launch_cal
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "16", "--gen", "4", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "sample continuation" in out
    launch_cal.main(["--arch", ARCH, "--smoke", "--steps", "2",
                     "--mode", "unstructured", "--out",
                     str(tmp_path / "bank"), "--device", "cpu"])
    launch_serve.main(["--arch", ARCH, "--smoke", "--sparse-artifact",
                       str(tmp_path / "bank"), "--sparsity", "0.5",
                       "--gen", "4", "--device", "cpu"])
    assert "sample continuation" in capsys.readouterr().out
