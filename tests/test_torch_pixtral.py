"""repro_torch serving, calibrating, evaluating and training the smoke
pixtral-12b (the mistral-nemo decoder behind a vision prefix: ``vit_proj``
of stub patch embeddings, ``num_image_tokens`` rows before the prompt)
against the JAX reference on the CPU, in one process.

One set of params is drawn (the port's ``init_params``, seed 0) and
carried to the reference with ``to_jax``; the 2:4 tree is the port's
magnitude masks compressed by the port, its values and index planes
carried to the reference.

Tolerances, and why:

* logits: 4 bf16 ulps of the largest logit (ROADMAP R8); measured 1.1
  at most on these inputs;
* the caches after prefill (the image rows and the prompt's): within 8
  bf16 ulps of the leaf's largest value;
* greedy token streams, the launcher's (with the image prefix; decode
  positions past it) and the engine's (text only, as the reference's
  engine serves it): exactly, dense and 2:4, and compressed ==
  masked-dense exactly on the CPU;
* the stats: ``stats_parity``, the reference's aggregate criterion,
  within 2**-8 of each leaf's norm on each side's own jit pass (measured
  7.0e-4, the down projection; the first layer's stats within 1.2e-6,
  the later ones carrying the bf16 matmuls' rare flips, which the
  attention amplifies: R23), and the port's tape against its jit pass
  within 2**-8
  (measured 4.6e-4: the jit pass keeps the gated product in f32 into the
  down projection's sums, as the jitted reference does; the eager tape
  sees it rounded);
* a 5-step wanda 2:4 calibration through each package's
  ``calibrate_to_bank``, the port's on the reference's stats (R5; from
  its own stats 99 of the down projection's 131072 V entries fall
  outside the bound, where the reference's own tape stats put 5569 of
  two leaves outside it; R23, tests/torch_port_evidence.py ``c3``):
  ``assert_calibration_matches``, its history's
  ``mask_churn`` within one of the 589824 mask entries (one entry flips
  at step 4 and back at step 5, a near-tie the final masks do not show;
  every other figure of the history within the helper's rtol 2e-3);
* ``eval_ppl``: rtol 2e-3 (tests/test_torch_eval.py), on weights whose
  untied ``lm_head`` is scaled by 1/16 so that the ppl is not clamped at
  exp(30); the image prefix's positions take no loss;
* one train step: tests/test_torch_train.py's dense tolerances (R14):
  loss rtol 2e-3, grad_norm rtol 1e-2, the params within 2e-4 of the
  reference's in norm and 0.12 of its update.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_calibration_matches, f64,  # noqa: F401
                         global_rel, jax_flat, leaf_pairs, one_torch_thread,
                         reference_fns, reference_generate, smoke_with_24,
                         to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_config as jax_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.data.synthetic import batches_for
from repro.launch import calibrate as jlaunch
from repro.launch import steps as jsteps
from repro.models import model as JM
from repro.optim import losses as jlosses
from repro.optim import optimizers as jopt
from repro.serve import engine as jengine
from repro_torch import tree
from repro_torch.configs.base import PruneConfig, get_config
from repro_torch.core import calibrate as tcal
from repro_torch.core.prunable import prunable_map
from repro_torch.launch import calibrate as tlaunch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.optim import losses as tlosses
from repro_torch.optim import optimizers as topt
from repro_torch.serve import engine as tengine

ARCH = "pixtral-12b"
ROOT = pathlib.Path(__file__).resolve().parent.parent
PCFG = dict(local_metric="wanda", mode="nm", steps=5, stats_batches=1)
B, P, GEN = 2, 16, 8


@pytest.fixture(scope="module")
def model():
    return smoke_with_24(ARCH)


def _ulps(want, n=4) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def _batch(n=B, seq=P, start=0):
    return batches_for(jax_smoke_config(ARCH), n=1, batch=n, seq=seq,
                       split="valid", start=start)[0]


def test_config_structure_and_support():
    """The config full and smoke, its params and axes trees (shapes by
    ``jax.eval_shape``: nothing drawn) against the reference's; 7
    prunable leaves, as the repository's zoo contract counts them;
    ``vit_proj`` stays dense."""
    from repro_torch.configs.base import get_smoke_config
    for full in (True, False):
        cfg = get_config(ARCH) if full else get_smoke_config(ARCH)
        jcfg = jax_config(ARCH) if full else jax_smoke_config(ARCH)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        TM.check_supported(cfg)
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    shapes = jax.eval_shape(lambda: JM.init_params(jcfg, jax.random.key(0)))
    want = {p: tuple(v.shape) for p, v in jax_flat(shapes).items()}
    assert dict(tree.flatten_with_path(TM.param_shapes(cfg))) == want
    assert dict(tree.flatten_with_path(TM.param_axes(cfg))) == jax_flat(
        JM.param_axes(jcfg))
    assert TM.make_stages(cfg) == JM.make_stages(jcfg) == [(("attn",), 40)]
    assert TM.encoder_stages(cfg) == []
    prunable = [p for p, on in tree.flatten_with_path(
        prunable_map(TM.param_specs(cfg))) if on]
    zoo = json.loads((ROOT / "results" / "contracts" / "zoo"
                      / "pixtral-12b_1dev.json").read_text())
    assert len(prunable) == zoo["stages"]["bank"]["prunable_leaves"] == 7
    assert want["['vit_proj']['kernel']"] == (1024, 5120)
    assert want["['stages'][0]['0']['attn']['wk']['kernel']"] == (
        40, 5120, 1024)
    n = sum(np.prod(s) for s in want.values())
    assert 12.2e9 < n < 12.3e9


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_forward_prefill_and_decode_logits_match_reference(model, weights):
    """The full forward over the image prefix and the prompt, then
    prefill and 3 teacher-forced decode steps at positions past the
    prefix (the rows apart), and the caches after prefill."""
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    tp = TM.serving_params(tp)
    b = _batch()
    N = cfg.num_image_tokens
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(lambda p, b: JM.forward(jcfg, p, b)[0])(jp, jb)
    got = TM.forward(cfg, tp, b)[0]
    assert got.shape == (B, N + P, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_ulps(want), err_msg="forward")
    C, steps = N + P + GEN, 3
    jpre, jdec = reference_fns(jcfg, C)
    jl, jc = jpre(jp, jb)
    tl, tc = TM.prefill(cfg, tp, b, cache_capacity=C)
    jf = jax_flat(jc)
    for path, leaf in tree.flatten_with_path(tc):
        w = np.asarray(jf[path], np.float32)
        np.testing.assert_allclose(leaf.float().numpy(), w, rtol=0,
                                   atol=_ulps(w, 8), err_msg=path)
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (steps, B)).astype(np.int32)
    for i in range(steps + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
        if i == steps:
            break
        t = np.array([N + P + i, N + P - 3 + 2 * i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_launcher_streams_match_reference(model, weights):
    """``launch.serve.generate`` against the reference launcher's loop on
    the same params: capacity P + gen + the image tokens, decode positions
    past the prefix; 2:4 compressed == masked-dense exactly."""
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    b = _batch()
    want = reference_generate(jcfg, jp, b, GEN)
    got = tserve.generate(cfg, TM.serving_params(tp), b, GEN)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    if weights == "nm24":
        masked = tserve.generate(cfg, TM.serving_params(model["masked"]), b,
                                 GEN)[0]
        assert torch.equal(masked, got)


def _streams(eng, prompts, max_tokens):
    rids = [eng.submit(np.asarray(p, np.int32), m)
            for p, m in zip(prompts, max_tokens)]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_engine_streams_match_reference(model, weights):
    """The engine serves pixtral text-only, as the reference's: 3
    requests on 2 slots (the third admits into a freed slot)."""
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    toks = _batch(n=3, seq=24, start=1)["tokens"]
    reqs = [(9, 6), (24, 4), (14, 7)]
    prompts = [toks[i, :n] for i, (n, _) in enumerate(reqs)]
    m = [k for _, k in reqs]
    want = _streams(jengine.ServeEngine(jcfg, jp, slots=2, capacity=48),
                    prompts, m)
    eng = tengine.ServeEngine(cfg, tp, slots=2, capacity=48, device="cpu")
    assert _streams(eng, prompts, m) == want
    if weights == "nm24":
        masked = tengine.ServeEngine(cfg, model["masked"], slots=2,
                                     capacity=48, device="cpu")
        assert _streams(masked, prompts, m) == want


def test_stats_match_reference(model):
    """``stats_sumsq`` over the image prefix and the prompt: each
    package's own jit pass by ``stats_parity``; the port's tape pass
    against its jit pass; ``vit_proj`` has no stats in the jit pass."""
    jcfg, cfg = model["cfg"]
    jp, tp = model["dense"]
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")
    want = jcal.collect_stats(jcfg, jp, calib)
    got = tcal.collect_stats(cfg, tp, calib)
    tape = tcal.collect_stats(cfg, tp, calib, impl="tape")
    pm = prunable_map(tp)
    jtorch = tree.tree_map(lambda a: None if a is None else to_torch(a),
                           jax.device_get(want))
    worst, ok, n = tcal.stats_parity(got, jtorch, pm, tol=2 ** -8)
    assert ok and n == 7, (worst, n)
    worst_tape, ok, _ = tcal.stats_parity(tape, got, pm, tol=2 ** -8)
    assert ok, worst_tape
    assert got["vit_proj"]["kernel"] is None
    assert jax_flat(want)["['vit_proj']['kernel']"] is None
    print(f"pixtral stats: {worst:.2e} against the reference, tape vs jit "
          f"{worst_tape:.2e}")


def test_calibration_matches_reference(model, tmp_path, monkeypatch):
    """5 wanda 2:4 steps through each package's ``calibrate_to_bank`` on
    batches with the image prefix, the port's stats pass handing it the
    reference's stats (R5; the stats themselves:
    :func:`test_stats_match_reference`)."""
    jcfg, cfg = model["cfg"]
    jp, tp = model["dense"]
    calib = batches_for(jcfg, n=1, batch=4, seq=32, split="calib")
    jbank = jlaunch.calibrate_to_bank(
        tmp_path / "jax", cfg=jcfg, pcfg=JaxPruneConfig(**PCFG), params=jp,
        calib=calib, arch=ARCH, smoke=True, log_every=1)
    stats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                          jax.device_get(jbank.stats))
    monkeypatch.setattr(tcal, "collect_stats", lambda *a, **kw: stats)
    tbank = tlaunch.calibrate_to_bank(
        tmp_path / "torch", cfg=cfg, pcfg=PruneConfig(**PCFG), params=tp,
        calib=calib, arch=ARCH, smoke=True, log_every=1)
    assert_calibration_matches(jbank, tbank, churn_flips=1)
    assert len([p for p, _, _ in leaf_pairs(jbank.Gamma, tbank.Gamma)]) == 7


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_eval_ppl_matches_reference(model, weights):
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]

    def shrink(path, a):
        return a / 16 if path == "['lm_head']['kernel']" else a
    tp = tree.map_with_path(shrink, tp)
    jp = jax.tree_util.tree_map_with_path(
        lambda kp, a: shrink(jax.tree_util.keystr(kp), a), jp,
        is_leaf=lambda x: x is None)
    valid = batches_for(jcfg, n=2, batch=2, seq=32, split="valid")
    want = jlosses.eval_ppl(jcfg, jp, valid)
    got = tlosses.eval_ppl(cfg, tp, valid)
    assert 10 < want < 5000
    np.testing.assert_allclose(got, want, rtol=2e-3)
    # the loss covers the text only: the image prefix's logits are dropped
    _, metrics = tlosses.lm_loss(cfg, tp, valid[0])
    logits = TM.forward(cfg, tp, valid[0])[0][:, cfg.num_image_tokens:-1]
    toks = torch.from_numpy(valid[0]["tokens"]).long()
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), toks[:, 1:].reshape(-1))
    np.testing.assert_allclose(float(metrics["nll"]), float(nll), rtol=1e-6)


def test_train_step_matches_reference(model):
    """One AdamW step (accumulation 2, remat on) against the reference's
    jitted ``make_train_step``, the loader's batch with its patches."""
    jcfg, cfg = model["cfg"]
    jp0, tp = model["dense"]
    tp = tree.tree_map(torch.clone, tp)
    kw = dict(lr=3e-4, total_steps=1, warmup_steps=1)
    b = batches_for(jcfg, n=1, batch=4, seq=32, split="train")[0]
    jp, js, jm = jax.jit(jsteps.make_train_step(
        jcfg, jopt.AdamWConfig(**kw), accum=2, remat=True))(
        jp0, jopt.adamw_init(jp0), {k: jnp.asarray(v) for k, v in b.items()})
    ts = topt.adamw_init(tp)
    tstep = tsteps.make_train_step(cfg, topt.AdamWConfig(**kw), accum=2,
                                   remat=True)
    _, _, tm = tstep(tp, ts, b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-3)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-2)
    rel = global_rel(jp, tp)
    upd = global_rel(jp, tp, base=jp0)
    print(f"pixtral train step: params {rel:.2e}, of the update {upd:.3f}")
    assert rel <= 2e-4 and upd <= 0.12


def test_launchers_run_pixtral_smoke_on_cpu(capsys, tmp_path):
    from repro_torch.launch import calibrate as launch_cal
    tserve.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                 "16", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "sample continuation" in out
    launch_cal.main(["--arch", ARCH, "--smoke", "--steps", "2", "--out",
                     str(tmp_path / "bank"), "--device", "cpu"])
    tserve.main(["--arch", ARCH, "--smoke", "--sparse-artifact",
                 str(tmp_path / "bank"), "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "7 kernels 2:4-compressed" in out and "sample continuation" in out
