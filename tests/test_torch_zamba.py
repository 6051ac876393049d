"""repro_torch serving, calibrating and evaluating the smoke zamba2-7b
(Mamba2 layers, the one weight-shared attention + MLP block with each
invocation's LoRA deltas) against the JAX reference on the CPU, in one
process.

One set of params is drawn (the port's ``init_params``, seed 0; the LoRA
``b`` leaves, zero at init, drawn as N(0, 0.05) so that each invocation's
deltas count) and carried to the reference as jax arrays; the 2:4 tree is
the port's magnitude masks compressed by the port, its values and index
planes carried to the reference.

Tolerances, and why:

* logits: 4 bf16 ulps of the largest logit (ROADMAP R8).  Measured on
  these inputs: 2.6 ulps at most, where bf16 rounding flips in the
  reference's and the port's matmuls (another summation order) pass
  through the six layers' recurrent states;
* the caches after prefill and decode: the shared attention's K/V ring
  within 8 bf16 ulps of the leaf's largest value, the SSM states within
  5e-2 of it (the same flips, carried by the f32 states: measured 1.3e-2
  and 2.5e-2);
* greedy token streams: exactly, dense and 2:4;
* the calibration (5 wanda 2:4 steps): each package's own stats, the
  stats of layer 0 within rtol 2**-8; the later leaves (and
  the shared block's, summed over its invocations) within 1e-2 of their
  Frobenius norm, tests/test_torch_deepseek_calib.py's bound for leaves
  whose inputs carry earlier layers' flips, and elementwise within rtol
  5e-2 (measured: 1.5e-2 at 3 of 256 input features of the sixth layer's
  out_proj, whose input carries the five recurrent states before it);
  then the search on the reference's stats (R5, as
  tests/test_torch_deepseek_calib.py): Gamma and V within
  1e-4 of the leaf's largest |V|; the masks equal but for counted
  near-ties of the reference's own scores;
* ``eval_ppl``: rtol 2e-3 (tests/test_torch_eval.py), on weights whose
  tied table is scaled by 1/16 so that the ppl (~ vocab) is not clamped
  at exp(30) as random smoke weights' is.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (_near_ties, f64, jax_flat, leaf_pairs,  # noqa: F401
                         one_torch_thread, smoke_recurrent, to_jax, to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_config as jax_config
from repro.core import calibrate as jcal
from repro.core import mirror as jmirror
from repro.data.synthetic import batches_for
from repro.models import model as JM
from repro.optim import losses as jlosses
from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro_torch import tree
from repro_torch.configs.base import (PruneConfig, get_config,
                                      get_smoke_config)
from repro_torch.core import calibrate as tcal
from repro_torch.core import mirror as tmirror
from repro_torch.models import model as TM
from repro_torch.optim import losses as tlosses
from repro_torch.serve import engine as tengine
from repro_torch.serve import spec as tspec
from repro_torch.sparse import apply as tapply

ARCH = "zamba2-7b"
ULPS = 4
CAPACITY = 32
GEN = 6
PCFG = dict(local_metric="wanda", mode="nm", steps=5, stats_batches=1)


@pytest.fixture(scope="module")
def model():
    m = smoke_recurrent(ARCH)
    _, cfg = m["cfg"]
    tp = m["dense"][1]
    tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
        lambda _: None, tp), 0.5, mode="nm")
    tsp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                 idx_bits=2, dtype=torch.bfloat16)
    m["nm24"] = (to_jax(tsp), tsp)
    m["masked"] = tree.tree_map(lambda w, k: w if k is None else
                                (w * k).to(torch.bfloat16), tp, tm)
    return m


def _ulps(want, n=ULPS) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def test_config_structure_and_support():
    """The port's config, params and axes trees against the reference's
    (shapes by ``jax.eval_shape``: nothing drawn); ``check_supported``
    takes both recurrent families and the last two, whisper and pixtral,
    full and smoke, whose config, shapes and axes trees are the
    reference's too; it still refuses what no family has."""
    for full in (True, False):
        cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
        jcfg = jax_config(ARCH) if full else _jax_smoke(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.d_inner == jcfg.d_inner
        TM.check_supported(cfg)
        TM.check_supported(get_config("xlstm-125m") if full
                           else get_smoke_config("xlstm-125m"))
        for arch in ("whisper-small", "pixtral-12b"):
            other = get_config(arch) if full else get_smoke_config(arch)
            jother = jax_config(arch) if full else _jax_smoke(arch)
            assert dataclasses.asdict(other) == dataclasses.asdict(jother)
            TM.check_supported(other)
            shapes = jax.eval_shape(lambda: JM.init_params(
                jother, jax.random.key(0)))
            assert dict(tree.flatten_with_path(TM.param_shapes(other))) \
                == {p: tuple(v.shape) for p, v in jax_flat(shapes).items()}
            assert dict(tree.flatten_with_path(TM.param_axes(other))) \
                == jax_flat(JM.param_axes(jother))
    with pytest.raises(NotImplementedError, match="not ported"):
        TM.check_supported(dataclasses.replace(get_smoke_config(ARCH),
                                               norm="groupnorm"))
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg,
                                                   jax.random.key(0)))
    want = {p: tuple(v.shape) for p, v in jax_flat(shapes).items()}
    got = dict(tree.flatten_with_path(TM.param_shapes(cfg)))
    assert got == want
    jaxes = jax_flat(JM.param_axes(jcfg))
    assert dict(tree.flatten_with_path(TM.param_axes(cfg))) == jaxes
    # 13 x (5 mamba + 1 mamba_shared) + 3 mamba; 25 stacked prunable leaves
    assert TM.make_stages(cfg) == [(("mamba",) * 5 + ("mamba_shared",),
                                    13), (("mamba",) * 3, 1)]
    n = sum(np.prod(s) for s in want.values())
    assert 6.5e9 < n < 6.7e9
    assert got["['stages'][0]['0']['mamba']['in_proj']['kernel']"] == (
        13, 3584, 14576)


def _jax_smoke(arch):
    from repro.configs.base import get_smoke_config as jax_smoke_config
    return jax_smoke_config(arch)


@pytest.mark.parametrize("weights", ["dense", "nm24"])
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
        t = np.array([P + i, P - 3 + i], np.int32)   # rows apart
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))
    jf = jax_flat(jc)
    for path, leaf in tree.flatten_with_path(tc):
        w = np.asarray(jf[path], np.float32)
        tol = (_ulps(w, 8) if "['kv']" in path
               else 5e-2 * float(np.abs(w).max()))
        np.testing.assert_allclose(leaf.float().numpy(), w, rtol=0,
                                   atol=tol, err_msg=path)


def _streams(eng, prompts, gen=GEN):
    rids = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_engine_streams_equal_reference(model, weights):
    """4 requests on 2 slots: the third and fourth reuse freed slots, the
    third with a one-token prompt (no prefill: the slot's state is reset
    from the blank row).  Recurrent kinds prefill at the exact prompt
    length in both packages."""
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    want = _streams(jengine.ServeEngine(jcfg, jp, slots=2,
                                        capacity=CAPACITY), model["prompts"])
    eng = tengine.ServeEngine(cfg, tp, slots=2, capacity=CAPACITY,
                              device="cpu")
    got = _streams(eng, model["prompts"])
    assert got == want
    assert eng.prefill_calls == 3 and eng._prefill_bucket(9) == 9
    if weights == "nm24":      # compressed == masked-dense, on the port
        masked = tengine.ServeEngine(cfg, model["masked"], slots=2,
                                     capacity=CAPACITY, device="cpu")
        assert _streams(masked, model["prompts"]) == got


def test_reused_slot_starts_from_the_blank_state(model):
    """A slot freed by a long request and reused by a one-token prompt
    decodes what a fresh engine decodes for that prompt alone."""
    _, cfg = model["cfg"]
    tp = model["dense"][1]
    one = model["prompts"][2][:1]
    eng = tengine.ServeEngine(cfg, tp, slots=1, capacity=CAPACITY,
                              device="cpu")
    first = _streams(eng, [model["prompts"][1], one])
    fresh = tengine.ServeEngine(cfg, tp, slots=1, capacity=CAPACITY,
                                device="cpu")
    assert first[1] == _streams(fresh, [one])[0]


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


def test_calibration_matches_reference(model, tmp_path):
    """Each package's own stats (the shared block's summed over its
    invocations), then 5 search steps on the reference's; then the port's
    bank through a
    0.0 / 2:4 fleet, each member's streams equal to an engine of its own
    weights."""
    from repro_torch.serve.fleet import SparsityFleet
    from repro_torch.sparse.bank import MaskBank
    jcfg, cfg = model["cfg"]
    jp, tp = model["dense"]
    jpcfg, pcfg = JaxPruneConfig(**PCFG), PruneConfig(**PCFG)
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")
    jstats = jcal.collect_stats(jcfg, jp, calib, pcfg=jpcfg)
    tstats = tcal.collect_stats(cfg, tp, calib, pcfg=pcfg)
    pairs = leaf_pairs(jstats, tstats)
    assert len(pairs) == 19         # 12 stacked mamba + 7 shared leaves
    for path, jv, tv in pairs:
        g, w = f64(tv), f64(jv)
        if path.startswith("['stages'][0]['0']"):
            np.testing.assert_allclose(g, w, rtol=2 ** -8, err_msg=path)
        else:
            err = np.linalg.norm(g - w) / np.linalg.norm(w)
            assert err <= 1e-2, (path, err)
            np.testing.assert_allclose(g, w, rtol=5e-2, err_msg=path)
    # the search on the reference's stats (R5), as the MoE calibrations
    jstate, _ = jcal.run_search(jcfg, jpcfg, jp, calib, jstats)
    state, hist = tcal.run_search(
        cfg, pcfg, tp, calib, tree.tree_map(
            lambda a: None if a is None else to_torch(a),
            jax.device_get(jstats)), log_every=1)
    assert state.step == PCFG["steps"] and len(hist) == PCFG["steps"]
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jstate, name),
                                       getattr(state, name)):
            scale = np.abs(f64(jax_flat(jstate.V)[path])).max()
            np.testing.assert_allclose(f64(tv), f64(jv), rtol=0,
                                       atol=1e-4 * scale, err_msg=name + path)
    jm = jmirror.export_masks(jpcfg, jstate.Gamma, 0.5, V=jstate.V)
    tm = tmirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    ties, n = 0, 0
    for path, jk, tk in leaf_pairs(jm, tm):
        jk, tk = np.asarray(jk), tk.numpy()
        n += jk.size // 4
        if (jk != tk).any():
            G = f64(jax_flat(jstate.Gamma)[path])
            err = np.abs(f64(dict(tree.flatten_with_path(
                state.Gamma))[path]) - G)
            for _, margin, tol in _near_ties(np.abs(G), jk, tk,
                                             np.full_like(G, err.max())):
                assert 0 <= margin <= tol, (path, margin, tol)
                ties += 1
    print(f"zamba2 smoke: {ties} near-tied groups of {n} differ")
    assert ties <= n // 10000 + 2
    # the bank through the fleet: the shared block's one mask serves all
    # its invocations
    bank = MaskBank.save(tmp_path / "bank", arch=ARCH, smoke=True,
                         state=state, stats=tstats, pcfg=pcfg, cfg=cfg)
    fleet = SparsityFleet(bank, tp, ["0.0", "2:4"], slots=4,
                          capacity=CAPACITY, device="cpu")
    prompts = model["prompts"][:2]
    rids = {b: [fleet.submit(p, GEN, budget=b) for p in prompts]
            for b in ("0.0", "2:4")}
    out = fleet.run()
    for b, eng in fleet.engines.items():
        alone = tengine.ServeEngine(cfg, eng.params, slots=2,
                                    capacity=CAPACITY, device="cpu")
        assert [out[r] for r in rids[b]] == _streams(alone, prompts), b


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_eval_ppl_matches_reference(model, weights):
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]

    def shrink(path, a):
        return a / 16 if path == "['embed']['table']" else a
    tp = tree.map_with_path(shrink, tp)
    jp = jax.tree_util.tree_map_with_path(
        lambda kp, a: shrink(jax.tree_util.keystr(kp), a), jp,
        is_leaf=lambda x: x is None)
    valid = batches_for(jcfg, n=2, batch=2, seq=32, split="valid")
    want = jlosses.eval_ppl(jcfg, jp, valid)
    got = tlosses.eval_ppl(cfg, tp, valid)
    assert 10 < want < 5000
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_launchers_run_zamba2_smoke_on_cpu(capsys, tmp_path):
    from repro_torch.launch import calibrate as launch_cal
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "16", "--gen", "4", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "sample continuation" in out
    launch_cal.main(["--arch", ARCH, "--smoke", "--steps", "2", "--out",
                     str(tmp_path / "bank"), "--device", "cpu"])
    launch_serve.main(["--arch", ARCH, "--smoke", "--sparse-artifact",
                       str(tmp_path / "bank"), "--gen", "4", "--device",
                       "cpu"])
    assert "sample continuation" in capsys.readouterr().out
