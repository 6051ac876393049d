"""repro_torch's gemma and yi families against the JAX reference on the
CPU: the gemma features one by one (``softcap``, gelu, QK-norm, the
sandwich norms, the scaled embeddings, the softcapped flash attention, its
custom backward and the materialised oracle), then smoke yi-6b, gemma2-2b
and gemma3-1b end to end (prefill and decode logits, greedy
``ServeEngine`` streams, 2:4-compressed too), yi's verify pass, and spec's
refusal of gemma's windowed kinds.
Every model runs the reference's own params (``init_params(cfg,
jax.random.key(0))``, carried across).

Tolerances, and why:

* gelu on bf16, the scaled embeddings, QK-norm: bit for bit (the port
  rounds every op as the compiled reference does; gelu on every bf16
  input of magnitude >= 1e-30, below which XLA flushes denormals).
* ``softcap`` on f32 logits: 8 f32 ulps (rtol 2**-20).  XLA's CPU tanh is
  its own rational approximation: against torch's it differs in ~60% of
  f32 inputs, by at most 5 ulps (measured on 2**20 normal draws x 3).
* A block (jitted reference against the port, same bf16 input): every
  output within one bf16 ulp of its position's largest output, and at
  most 2% of them off at all (measured at most 29 of 4096, the worst
  0.25 of that ulp, where the residual add cancels: the attention
  softcap's tanh and the rope's cos / sin, rounded, move a few).
* The softcapped flash forward and backward in f32: 1e-5 of the largest
  output or gradient (the tanh above, through exp and the sums, in
  another order; measured at most 4.5e-7, 7.7e-7 without the softcap;
  where a query sees one key, dq is the rounding of an exact zero).
* Logits: 4 bf16 ulps of the largest logit (ROADMAP R8), for the
  softcapped gemma2 too (measured at most 1.9: its final softcap caps
  the logits at 30, so an ulp of the max is 0.12); greedy streams exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import bits, jax_params_to_torch, one_torch_thread  # noqa: F401
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import common as JC
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro.serve import spec as jspec
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sparse import apply as japply
from repro_torch import tree
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.serve import spec as tspec
from repro_torch.serve.engine import ServeEngine
from repro_torch.sparse import apply as tapply

ARCHS = ("yi-6b", "gemma2-2b", "gemma3-1b")
ULPS = 4


def _ulps(want, n=ULPS) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def _bf16(a) -> tuple:
    """A numpy array as (jax bf16, torch bf16) with the same bits."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j).view(np.uint16).astype(
        np.int16)).view(torch.bfloat16)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        jcfg = jax_smoke_config(arch)
        jp = JM.init_params(jcfg, jax.random.key(0))
        out[arch] = (jcfg, get_smoke_config(arch), jp,
                     jax_params_to_torch(jp))
    return out


# ---------------------------------------------------------------------------
# The features one by one
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    from repro.configs.base import get_config as jax_config
    for arch in ARCHS:
        for getter, jgetter in ((get_config, jax_config),
                                (get_smoke_config, jax_smoke_config)):
            assert (dataclasses.asdict(getter(arch))
                    == dataclasses.asdict(jgetter(arch))), arch
        TM.check_supported(get_config(arch))


@pytest.mark.parametrize("change,missing", [
    (dict(num_shared_experts=2), "shared experts"),
    (dict(pattern=("mamba",)), "layer kinds"),
    (dict(norm="layernorm"), "norm other than rmsnorm"),
    (dict(act="relu"), "activation"),
    (dict(encoder_layers=2), "encoder-decoder"),
    (dict(vit_dim=64), "vision input")])
def test_check_supported_still_refuses_the_rest(change, missing):
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), **change)
    if missing in PORTED_SINCE:     # accepted now (a later slice's)
        TM.check_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match=missing):
        TM.check_supported(cfg)


# features the cases above name that a later slice ported: shared
# experts (deepseek's), the mamba kind (zamba2's), layernorm, the
# encoder-decoder (whisper's) and the vision input (pixtral's)
PORTED_SINCE = {"shared experts", "layer kinds", "norm other than rmsnorm",
                "encoder-decoder", "vision input"}


def test_tiny_families_are_the_benchmarks():
    import importlib
    try:
        bench = importlib.import_module("benchmarks.common")
    except ImportError:                 # benchmarks/ off the path
        import pathlib
        import sys
        sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
        bench = importlib.import_module("benchmarks.common")
    from repro_torch.configs.tiny import FAMILIES
    assert list(FAMILIES) == list(bench.FAMILIES)
    for name, cfg in FAMILIES.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            bench.FAMILIES[name]), name


def test_gelu_matches_xla_on_every_bf16_value():
    x = np.arange(1 << 16, dtype=np.uint16).view(jnp.bfloat16)
    x = x[np.isfinite(x.astype(np.float32))
          & (np.abs(x.astype(np.float32)) >= 1e-30)]
    want = jax.jit(lambda v: JMLP._act(v, "gelu"))(jnp.asarray(x))
    got = TC.act(torch.from_numpy(x.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16), "gelu")
    np.testing.assert_array_equal(bits(got), bits(want))
    with pytest.raises(NotImplementedError, match="relu"):
        TC.act(torch.zeros(2), "relu")


def test_softcap_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 512)) * 40).astype(np.float32)
    for cap in (30.0, 50.0):
        want = np.asarray(jax.jit(lambda v: JC.softcap(v, cap))(x))
        got = TC.softcap(torch.from_numpy(x), cap).numpy()
        np.testing.assert_allclose(got, want, rtol=2 ** -20, atol=0)
        assert np.abs(got).max() <= cap
    assert TC.softcap(torch.from_numpy(x), 0.0) is not None
    np.testing.assert_array_equal(TC.softcap(torch.from_numpy(x), 0.0), x)


def test_scale_embed_and_qk_norm_match_reference(models):
    jcfg, cfg, jp, tp = models["gemma3-1b"]
    toks = np.random.default_rng(1).integers(0, 512, (2, 9)).astype(np.int32)
    want = jax.jit(lambda p, t: JM._embed_inputs(jcfg, p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    got = TM._embed(cfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_array_equal(bits(got), bits(want))
    lp = jax.tree.map(lambda a: a[0], jp["stages"][0]["0"]["attn"])
    assert set(lp) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk) = (_bf16(rng.standard_normal((2, 9, n, 32)) * 3)
                          for n in (4, 1))
    wq, wk = jax.jit(JA._qk_normed)(lp, jq, jk)
    gq, gk = TA._qk_normed(jax_params_to_torch(lp), tq, tk)
    np.testing.assert_array_equal(bits(gq), bits(wq))
    np.testing.assert_array_equal(bits(gk), bits(wk))


@pytest.mark.parametrize("arch", ["gemma2-2b", "gemma3-1b"])
def test_blocks_match_the_jitted_reference(models, arch):
    """Each block kind of the smoke config (gemma2: sandwich norms and the
    attention softcap; gemma3: QK-norm, the local rope theta, gelu), one
    layer's params, the same bf16 input."""
    jcfg, cfg, jp, tp = models[arch]
    _, x = _bf16(np.random.default_rng(3).standard_normal(
        (2, 16, cfg.d_model)) * 3)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    pos = np.broadcast_to(np.arange(16), (2, 16)).copy()
    for s, (pattern, _) in enumerate(JM.make_stages(jcfg)):
        for j, kind in enumerate(pattern):
            jl = jax.tree.map(lambda a: a[0], jp["stages"][s][str(j)])
            assert ("post_ln1" in jl) == jcfg.sandwich_norm
            want = np.asarray(jax.jit(
                lambda p, h, k=kind: JB.block_apply_full(
                    k, jcfg, p, h, JB.Ctx(positions=jnp.asarray(pos)))[0])(
                jl, jx), np.float32)
            got = TB.block_apply_full(
                kind, cfg, jax_params_to_torch(jl), x,
                TB.Ctx(positions=torch.from_numpy(pos)))[0].float().numpy()
            # one bf16 ulp of each position's largest output
            ulp = 2.0 ** -7 * np.abs(want).max(axis=-1, keepdims=True)
            assert (np.abs(got - want) <= ulp).all(), (s, j, kind)
            assert (got != want).mean() <= 0.02, (s, j, kind)


@pytest.mark.parametrize("window", [0, 8])
def test_softcapped_flash_forward_and_backward_match_reference(window):
    rng = np.random.default_rng(4 + window)
    B, S, K, G, D, cap = 2, 32, 2, 2, 16, 5.0
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) * 2
                   for s in ((B, S, K * G, D), (B, S, K, D), (B, S, K, D),
                             (B, S, K * G, D)))

    def jf(q, k, v):
        return JA.flash_attention(q, k, v, window=window, attn_softcap=cap,
                                  q_block=8, kv_block=8)
    want, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    wgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = TA.flash_attention(tq, tk, tv, window=window, attn_softcap=cap,
                             q_block=8, kv_block=8)
    got.backward(torch.from_numpy(do))
    for name, t, w in zip(("out", "dq", "dk", "dv"),
                          (got.detach(), tq.grad, tk.grad, tv.grad),
                          (want, *wgrads)):
        w = np.asarray(w)
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)
    # the inference path (no autograd) gives the same forward
    with torch.no_grad():
        again = TA.flash_attention(tq, tk, tv, window=window,
                                   attn_softcap=cap, q_block=8, kv_block=8)
    assert torch.equal(again, got.detach())
    # the materialised oracles of both packages, and the flash forward
    # against the port's
    jref = np.asarray(JA.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)), window=window,
        attn_softcap=cap))
    tref = TA.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  window=window, attn_softcap=cap)
    for name, t, w in (("oracle", tref, jref), ("flash vs oracle", again,
                                                 tref.numpy())):
        np.testing.assert_allclose(t.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


# ---------------------------------------------------------------------------
# Smoke models end to end
# ---------------------------------------------------------------------------

B, P, C, STEPS = 2, 12, 24, 4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(models, arch):
    jcfg, cfg, jp, tp = models[arch]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 512, (B, P)).astype(np.int32)
    feed = rng.integers(0, 512, (STEPS, B)).astype(np.int32)
    jpre = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t},
                                           cache_capacity=C))
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    jl, jc = jpre(jp, jnp.asarray(toks))
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=C)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=_ulps(jl), err_msg="prefill")
    for i in range(STEPS):
        t = np.array([P + i, P - 3 + 2 * i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
    want = jax.jit(lambda p, t: JM.forward(jcfg, p, {"tokens": t})[0])(
        jp, jnp.asarray(toks))
    got = TM.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_ulps(want))
    if cfg.final_softcap:
        assert float(got.abs().max()) <= cfg.final_softcap


def _streams(eng, prompts, max_tokens):
    rids = [eng.submit(np.asarray(p, np.int32), m)
            for p, m in zip(prompts, max_tokens)]
    out = eng.run()
    return [out[r] for r in rids]


# a prompt longer than the smoke window (16), one that joins mid-batch
PROMPTS = [list(range(5, 25)), [9, 10, 11], [1, 2, 3, 4, 5, 6, 7]]
MAX_TOKENS = [6, 3, 8]


@pytest.mark.parametrize("arch,weights", [(a, "dense") for a in ARCHS]
                         + [("gemma3-1b", "2:4")])
def test_engine_streams_match_reference(models, arch, weights):
    """Dense for every family; 2:4-compressed (``nm_matmul``'s plain
    version) for gemma3-1b, the slice's main path."""
    jcfg, cfg, jp, tp = models[arch]
    if weights == "2:4":
        jm = jcal.baseline_masks("magnitude", jp,
                                 jax.tree.map(lambda _: None, jp), 0.5,
                                 mode="nm")
        tm = tcal.baseline_masks("magnitude", tp,
                                 tree.tree_map(lambda _: None, tp), 0.5,
                                 mode="nm")
        jp = japply.sparsify_params(jp, jm, axes=JM.param_axes(jcfg),
                                    idx_bits=2, dtype=jnp.bfloat16)
        tp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                    idx_bits=2, dtype=torch.bfloat16)
    want = _streams(JaxServeEngine(jcfg, jp, slots=2, capacity=48),
                    PROMPTS, MAX_TOKENS)
    eng = ServeEngine(cfg, tp, slots=2, capacity=48, device="cpu")
    assert _streams(eng, PROMPTS, MAX_TOKENS) == want
    assert [len(s) for s in want] == MAX_TOKENS


def test_yi_verify_matches_reference_and_sequential_decode(models):
    jcfg, cfg, jp, tp = models["yi-6b"]
    tp = TM.serving_params(tp)
    rng = np.random.default_rng(6)
    prompt = rng.integers(0, 512, (3, 10)).astype(np.int32)
    t0 = np.array([10, 7, 9], np.int32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)},
                       cache_capacity=32)
    toks = rng.integers(0, 512, (3, 4)).astype(np.int32)
    want, _ = jax.jit(lambda p, x, c, t: JM.verify_step(jcfg, p, x, c, t))(
        jp, jnp.asarray(toks), jc, jnp.asarray(t0))
    got, _ = TM.verify_step(cfg, tp, torch.from_numpy(toks),
                            jax_params_to_torch(jc), torch.from_numpy(t0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=_ulps(want))
    dc = jax_params_to_torch(jc)
    for i in range(4):
        seq, _ = TM.decode_step(cfg, tp, torch.from_numpy(toks[:, i]), dc,
                                torch.from_numpy(t0 + i))
        assert torch.equal(got[:, i], seq), i


def test_spec_refuses_gemma_as_the_reference_does(models):
    """gemma's ``local`` kinds are windowed rings: both packages refuse a
    speculative pair on them; yi (global attention only) is accepted."""
    for arch in ("gemma2-2b", "gemma3-1b"):
        jcfg, cfg, jp, tp = models[arch]
        ja, jb = (JaxServeEngine(jcfg, jp, slots=1, capacity=32)
                  for _ in range(2))
        with pytest.raises(ValueError, match="kinds") as jerr:
            jspec.SpecDecoder(ja, jb)
        ta, tb = (ServeEngine(cfg, tp, slots=1, capacity=32, device="cpu")
                  for _ in range(2))
        with pytest.raises(ValueError, match="kinds") as terr:
            tspec.SpecDecoder(ta, tb)
        assert "local" in str(jerr.value) and "local" in str(terr.value)
    jcfg, cfg, jp, tp = models["yi-6b"]
    ta, tb = (ServeEngine(cfg, tp, slots=1, capacity=32, device="cpu")
              for _ in range(2))
    tspec.SpecDecoder(ta, tb)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_matches_reference(models, arch):
    jcfg, cfg, jp, tp = models[arch]
    jpaths = [jax.tree_util.keystr(kp) for kp, _ in
              jax.tree_util.tree_flatten_with_path(JM.param_axes(jcfg))[0]]
    paths = [p for p, _ in tree.flatten_with_path(TM.param_axes(cfg))]
    assert paths == jpaths
    assert (list(tree.flatten_with_path(TM.param_axes(cfg)))
            == [(jax.tree_util.keystr(kp), v) for kp, v in
                jax.tree_util.tree_flatten_with_path(
                    JM.param_axes(jcfg))[0]])
    shapes = dict(tree.flatten_with_path(TM.param_shapes(cfg)))
    for kp, v in jax.tree_util.tree_flatten_with_path(jp)[0]:
        assert shapes[jax.tree_util.keystr(kp)] == tuple(v.shape)
