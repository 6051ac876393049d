"""repro_torch serving, calibrating, evaluating and training the smoke
whisper-small (encoder-decoder: layernorm, gelu, no rope; the encoder's
non-causal stages over stub frame embeddings, the decoder's learned
positions and its cross-attention over the encoder output) against the
JAX reference on the CPU, in one process.

One set of params is drawn (the port's ``init_params``, seed 0) and
carried to the reference with ``to_jax``; the 2:4 tree is the port's
magnitude masks compressed by the port, its values and index planes
carried to the reference.

Tolerances, and why:

* ``layernorm``: bit for bit against the jitted reference on bf16
  inputs; on f32 inputs, whose output keeps the f32 sums' last places
  (summed in another order), within 8 f32 ulps of the largest output
  (2**-20 of it; measured 7.2e-7 at outputs up to ~4.5);
  ``sinusoidal_positions``: bit for bit (the same numpy);
* the non-causal flash attention, forward and backward in f32 with
  Sq != Sk: 1e-5 of the largest element (tests/test_torch_gemma.py's
  bound for the softcapped flash);
* logits: 4 bf16 ulps of the largest logit (ROADMAP R8); measured 1.5
  at most on these inputs, the decoder's cross-attention carrying the
  encoder's last-place differences;
* the caches after prefill: the self rings and the cross K/V within 8
  bf16 ulps of the leaf's largest value;
* greedy token streams: exactly, dense and 2:4, and compressed ==
  masked-dense exactly on the CPU;
* ``kv_shards`` 1 and 4: under tests/_torch_port.py's single-device
  stand-in for the reference's sharded decode (R1), logits within 4 bf16
  ulps and the streams exactly;
* the stats (the encoder's stages included): ``stats_parity``, the
  reference's aggregate criterion, within 2**-8 of each leaf's norm on
  each side's own jit pass (measured 1.05e-3, the decoder's down
  projection: the gelu product's roundings in the jitted reference are
  not all mirrored), and the port's tape against its jit pass within
  2**-8 (measured 4.5e-4; the reference's own differ by up to 1.8e-3);
* a 5-step wanda 2:4 calibration through each package's
  ``calibrate_to_bank``, the port's on the reference's stats (R5):
  ``assert_calibration_matches``;
* ``eval_ppl``: rtol 2e-3 (tests/test_torch_eval.py), on weights whose
  tied table is scaled by 1/16 so that the ppl is not clamped at exp(30);
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

from _torch_port import (assert_calibration_matches, bits, f64,  # noqa: F401
                         global_rel, jax_flat, jax_kv_shards, leaf_pairs,
                         one_torch_thread, port_calls, reference_fns,
                         reference_generate, smoke_with_24, to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_config as jax_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.data.synthetic import batches_for
from repro.launch import calibrate as jlaunch
from repro.launch import steps as jsteps
from repro.models import attention as JA
from repro.models import common as jcm
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
from repro_torch.models import attention as TA
from repro_torch.models import common as tcm
from repro_torch.models import model as TM
from repro_torch.optim import losses as tlosses
from repro_torch.optim import optimizers as topt
from repro_torch.serve import engine as tengine

ARCH = "whisper-small"
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
    ``jax.eval_shape``: nothing drawn) and stages against the
    reference's; 18 prunable leaves, as the repository's zoo contract
    counts them; the frame and position tables stay dense."""
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
    assert TM.make_stages(cfg) == JM.make_stages(jcfg) == [(("dec",), 12)]
    assert TM.encoder_stages(cfg) == JM.make_stages(jcfg, 12, ("enc",)) \
        == [(("enc",), 12)]
    prunable = [p for p, on in tree.flatten_with_path(
        prunable_map(TM.param_specs(cfg))) if on]
    zoo = json.loads((ROOT / "results" / "contracts" / "zoo"
                      / "whisper-small_1dev.json").read_text())
    assert len(prunable) == zoo["stages"]["bank"]["prunable_leaves"] == 18
    assert not any(k in p for p in prunable
                   for k in ("frame_proj", "pos_embed", "embed"))
    assert want["['pos_embed']"] == (TM.POS_EMBED_ROWS, 768)
    assert want["['enc_stages'][0]['0']['mlp']['down']['kernel']"] == (
        12, 3072, 768)


def test_layernorm_and_sinusoidal_positions_match_reference():
    rng = np.random.default_rng(0)
    p = {"scale": rng.standard_normal(96).astype(np.float32) * 0.1,
         "bias": rng.standard_normal(96).astype(np.float32) * 0.1}
    tparams = {k: torch.from_numpy(v) for k, v in p.items()}
    for dtype in (jnp.bfloat16, jnp.float32):
        x = jnp.asarray(rng.standard_normal((3, 40, 96)) * 3, dtype)
        want = jax.jit(lambda p, x: jcm.layernorm(p, x))(p, x)
        got = tcm.layernorm(tparams, to_torch(x))
        assert got.dtype == to_torch(x).dtype
        if dtype == jnp.bfloat16:
            np.testing.assert_array_equal(bits(got), bits(want))
        else:
            w = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                       atol=2 ** -20 * np.abs(w).max())
    for num, dim in ((1536, 768), (37, 128)):
        np.testing.assert_array_equal(tcm.sinusoidal_positions(num, dim),
                                      jcm.sinusoidal_positions(num, dim))


@pytest.mark.parametrize("Sq,Sk", [(16, 16), (8, 32)])
def test_noncausal_flash_forward_and_backward_match_reference(Sq, Sk):
    """The encoder's self-attention (Sq == Sk) and the cross-attention
    (Sq != Sk): every kv block is read, none masked."""
    rng = np.random.default_rng(Sq + Sk)
    Bq, K, G, D = 2, 2, 2, 16
    q, do = (rng.standard_normal((Bq, Sq, K * G, D)).astype(np.float32) * 2
             for _ in range(2))
    k, v = (rng.standard_normal((Bq, Sk, K, D)).astype(np.float32) * 2
            for _ in range(2))

    def jf(q, k, v):
        return JA.flash_attention(q, k, v, causal=False, q_block=8,
                                  kv_block=16)
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    wgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = TA.flash_attention(tq, tk, tv, causal=False, q_block=8,
                             kv_block=16)
    got.backward(torch.from_numpy(do))
    for name, t, w in zip(("out", "dq", "dk", "dv"),
                          (got.detach(), tq.grad, tk.grad, tv.grad),
                          (want, *wgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    with torch.no_grad():
        again = TA.flash_attention(tq, tk, tv, causal=False, q_block=8,
                                   kv_block=16)
    assert torch.equal(again, got.detach())
    jref = np.asarray(JA.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=False))
    tref = TA.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=False)
    for name, t, w in (("oracle", tref, jref),
                       ("flash vs oracle", again, tref.numpy())):
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    with pytest.raises(ValueError):     # the reference's block assert
        TA.flash_attention(tq, tk[:, :-1], tv[:, :-1], causal=False,
                           q_block=8, kv_block=16)


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_forward_prefill_and_decode_logits_match_reference(model, weights):
    """The full forward's logits, then prefill and 3 teacher-forced decode
    steps with the rows at different positions (each takes its own
    ``pos_embed`` row), and the caches after prefill."""
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    tp = TM.serving_params(tp)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = jax.jit(lambda p, b: JM.forward(jcfg, p, b)[0])(jp, jb)
    got = TM.forward(cfg, tp, b)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_ulps(want), err_msg="forward")
    C, steps = P + GEN, 3
    jpre, jdec = reference_fns(jcfg, C)
    jl, jc = jpre(jp, jb)
    tl, tc = TM.prefill(cfg, tp, b, cache_capacity=C)
    jf = jax_flat(jc)
    for path, leaf in tree.flatten_with_path(tc):
        w = np.asarray(jf[path], np.float32)
        np.testing.assert_allclose(leaf.float().numpy(), w, rtol=0,
                                   atol=_ulps(w, 8), err_msg=path)
    assert tc[0]["0"]["cross_k"].shape == (cfg.num_layers, B, P,
                                            cfg.num_kv_heads, cfg.head_dim)
    feed = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (steps, B)).astype(np.int32)
    for i in range(steps + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
        if i == steps:
            break
        t = np.array([P + i, P - 3 + 2 * i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_launcher_streams_match_reference(model, weights):
    """``launch.serve.generate`` against the reference launcher's loop on
    the same params: the batch's stub frames through the encoder, the
    decoder's greedy tokens; 2:4 compressed == masked-dense exactly."""
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


@pytest.mark.parametrize("kv_shards", [1, 4])
def test_kv_shards_match_reference(model, jax_kv_shards, port_calls,
                                   kv_shards):
    """Decode attention through ``flash_decode`` (1) or S capacity shards
    (4) on both the self ring (24 slots) and the cross cache (the
    encoder's 16), against the reference's sharded branch under the
    stand-in: logits every step; then the launcher's streams."""
    jcfg, cfg = model["cfg"]
    jp, tp = model["nm24"]
    tp = TM.serving_params(tp)
    traced = jax_kv_shards(kv_shards)
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    C, steps = P + 8, 3
    # jitted afresh: a trace cached before the stand-in went in skips it
    jl, jc = jax.jit(lambda p, b: JM.prefill(jcfg, p, b,
                                             cache_capacity=C))(jp, jb)
    tl, tc = TM.prefill(cfg, tp, b, cache_capacity=C)
    feed = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (steps, B)).astype(np.int32)
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    for i in range(steps):
        t = np.array([P + i, P - 2 + i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t), kv_shards=kv_shards)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
    # the reference traced its one decode body's self and cross attention;
    # the port ran both in every layer of every step
    assert traced == [C, P]
    calls = dict(port_calls)
    assert calls == {name: 2 * cfg.num_layers * steps
                     for name in _names(kv_shards)}
    # the launcher's streams: those of kv_shards=None, which
    # test_launcher_streams_match_reference holds to the reference's
    got = tserve.generate(cfg, tp, b, GEN, kv_shards=kv_shards)[0]
    assert torch.equal(got, tserve.generate(cfg, tp, b, GEN)[0])
    with pytest.raises(ValueError, match="does not divide"):
        tserve.generate(cfg, tp, _batch(seq=P + 2), GEN, kv_shards=4)


def _names(kv_shards):
    return (("flash_decode",) if kv_shards == 1
            else ("flash_decode_partial", "combine_partials"))


def test_engine_refuses_whisper_as_the_reference(model):
    """The reference's engine asserts it is decoder-only; the port's
    raises, and so does every engine surface built on it (the fleet's
    shared step functions)."""
    jcfg, cfg = model["cfg"]
    jp, tp = model["dense"]
    with pytest.raises(AssertionError, match="decoder-only"):
        jengine.ServeEngine(jcfg, jp, slots=2, capacity=32)
    with pytest.raises(ValueError, match="decoder-only"):
        tengine.ServeEngine(cfg, tp, slots=2, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        tengine.EngineFns(cfg, 32, torch.device("cpu"))
    with pytest.raises(ValueError, match="decoder-only"):
        TM.verify_step(cfg, tp, np.zeros((1, 2), np.int32), [],
                       np.zeros(1, np.int32))


def test_stats_match_reference(model):
    """``stats_sumsq`` over the encoder's stages and the decoder's (the
    cross K/V projections see the encoder output): each package's own jit
    pass by ``stats_parity``; the port's tape pass against its jit pass."""
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
    assert ok and n == 18, (worst, n)
    worst_tape, ok, _ = tcal.stats_parity(tape, got, pm, tol=2 ** -8)
    assert ok, worst_tape
    enc = [p for p, v in tree.flatten_with_path(got)
           if v is not None and p.startswith("['enc_stages']")]
    assert len(enc) == 7
    print(f"whisper stats: {worst:.2e} against the reference, tape vs jit "
          f"{worst_tape:.2e}")


def test_calibration_matches_reference(model, tmp_path, monkeypatch):
    """5 wanda 2:4 steps through each package's ``calibrate_to_bank``,
    the port's stats pass handing it the reference's stats (R5; the
    stats themselves: :func:`test_stats_match_reference`)."""
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
    assert_calibration_matches(jbank, tbank)
    assert len([p for p, _, _ in leaf_pairs(jbank.Gamma, tbank.Gamma)]) == 18


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


def test_train_step_matches_reference(model):
    """One AdamW step (accumulation 2, remat on) against the reference's
    jitted ``make_train_step``: the encoder's and the decoder's leaves,
    frames and tokens from the loader's batch."""
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
    print(f"whisper train step: params {rel:.2e}, of the update {upd:.3f}")
    assert rel <= 2e-4 and upd <= 0.12


def test_launchers_run_whisper_smoke_on_cpu(capsys, tmp_path):
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
    assert "18 kernels 2:4-compressed" in out and "sample continuation" in out
    with pytest.raises(ValueError, match="decoder-only"):
        tserve.main(["--arch", ARCH, "--smoke", "--sparse-artifact",
                     str(tmp_path / "bank"), "--fleet", "0.0,2:4",
                     "--device", "cpu"])
