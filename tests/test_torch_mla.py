"""repro_torch's multi-head latent attention (MLA) and shared experts,
deepseek-v2-lite's two features, against the JAX reference on the CPU at
the smoke widths (d 128, 4 heads, kv_lora 32, nope 32 + rope 16, v 32, 8
experts top-2, one shared expert).

Inputs are made by numpy from a seed and handed to both packages; params
are drawn once (the port's ``init_params``, seed 0) and carried to the
reference as jax arrays; the reference's functions run jitted.  The
2:4-compressed model is held end to end in tests/test_torch_deepseek.py.

Tolerances, and why:

* ``mla_apply_full``, ``mla_apply_decode``, ``mla_apply_verify`` and
  ``moe_apply`` with a shared expert: outputs and the ``ckv`` / ``krope``
  rings within 4 bf16 ulps of the largest value (ROADMAP R8; measured:
  bit for bit on these inputs, the absorbed decode's f32 einsums summed
  in torch's order and rounded to bf16 as the reference rounds them).
* ``flash_attention`` at qk width 48 and v width 32 (MLA's unequal
  widths): 4 bf16 ulps of the largest output, as the block outputs.
* the dense smoke model's logits and rings: 4 bf16 ulps of the largest
  value (measured: bit for bit on these inputs).
* ``kernel_dense`` of a compressed leaf, index planes, ``prunable_map``,
  the stages and the full config's parameter shapes: exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (bits, jax_flat, jax_params_to_torch,
                         one_torch_thread, to_torch)  # noqa: F401
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core.prunable import prunable_map as jax_prunable_map
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import common as JC
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.sparse import pack as jpack
from repro_torch import tree
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.core import masks as tmasks
from repro_torch.core.prunable import prunable_map
from repro_torch.kernels import nm_spmm
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.serve.engine import EngineFns, ServeEngine
from repro_torch.sparse import pack as tpack

ARCH = "deepseek-v2-lite-16b"
ULPS = 4
B, S = 2, 12


def _ulps(want, n=ULPS) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=_ulps(want), err_msg=what)


def to_jax(t):
    """A port tree of CPU tensors -> the same tree of jax arrays."""
    return tree.tree_map(lambda a: jnp.asarray(a.numpy()), t)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config in both packages, one set of params in both (drawn
    by the port's init and carried to the reference: its own init
    compiles one program a leaf shape, ~12 s here), and each layer's
    block params sliced out of each."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tp = TM.init_params(cfg, 0, device="cpu")
    jp = to_jax(tp)
    serving = TM.serving_params(tp)

    def layer(s):
        return (jax.tree.map(lambda a: a[0], jp["stages"][s]["0"]),
                TM._layer(serving["stages"][s], 0)["0"])
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((B, S, cfg.d_model))).astype(
        jnp.bfloat16)
    return {"cfg": (jcfg, cfg), "params": (jp, tp), "layer": layer,
            "x": x, "rng": rng}


def _positions(n=S):
    pos = np.broadcast_to(np.arange(n, dtype=np.int32), (B, n))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


# ---------------------------------------------------------------------------
# the config and the parameter tree
# ---------------------------------------------------------------------------

def test_full_config_stages_and_shapes_equal_reference():
    """27 layers: one ``mla_dense`` prefix stage and 26 ``mla_moe`` layers,
    every parameter at the published widths (traced abstractly, no
    weights drawn)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert TM.make_stages(cfg) == JM.make_stages(jcfg) == [
        (("mla_dense",), 1), (("mla_moe",), 26)]
    want = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                          jax.random.key(0))
    got = TM.param_shapes(cfg)
    jflat = {p: tuple(v.shape) for p, v in jax_flat(want).items()}
    tflat = dict(tree.flatten_with_path(got))     # tuple leaves
    assert tflat == jflat
    moe = "['stages'][1]['0']['moe']"
    assert tflat[moe + "['up']['kernel']"] == (26, 64, 2048, 1408)
    assert tflat[moe + "['shared']['down']['kernel']"] == (26, 2816, 2048)
    assert tflat["['stages'][1]['0']['attn']['w_dkv']['kernel']"] == (
        26, 2048, 576)
    assert tflat["['stages'][0]['0']['mlp']['down']['kernel']"] == (
        1, 10944, 2048)


def test_param_specs_draw_what_init_params_draws():
    """``param_specs`` drawn leaf by leaf in the tree's order from one
    generator give ``init_params``' values bit for bit; a stacked leaf's
    layer draws alone at one layer's shape (chip_smoke.py builds the
    full-width model this way, one layer slice at a time)."""
    cfg = get_smoke_config(ARCH)
    specs = TM.param_specs(cfg)
    g = torch.Generator().manual_seed(3)
    drawn = tree.tree_map(lambda sp: sp.draw(g), specs)
    want = TM.init_params(cfg, 3, device="cpu")
    pairs = zip(tree.flatten_with_path(drawn), tree.flatten_with_path(want),
                strict=True)
    for (path, a), (_, b) in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b), path
    bank = specs["stages"][1]["0"]["moe"]["up"]["kernel"]
    # the reference's fan-in rule takes a leaf's first per-layer axis,
    # the expert axis of a bank
    assert bank.ndim == 4 and bank.scale == cfg.num_experts ** -0.5
    layer = bank.draw(g, index=(1,))
    assert tuple(layer.shape) == bank.shape[1:]
    assert float(layer.abs().max()) <= 2 * bank.scale
    assert dict(tree.flatten_with_path(prunable_map(specs))) == dict(
        tree.flatten_with_path(prunable_map(want)))


def test_prunable_map_equals_reference(smoke):
    """Pruned: the MLA projections, the dense MLP, the shared MLP and the
    expert banks; kept dense: ``kv_norm``, the router, the embeddings and
    the head."""
    jp, tp = smoke["params"]
    flags = dict(tree.flatten_with_path(prunable_map(tp)))
    assert flags == jax_flat(jax_prunable_map(jp))
    on = sorted(p for p, v in flags.items() if v)
    attn = [f"['stages'][{s}]['0']['attn']['{n}']['kernel']"
            for s in (0, 1) for n in ("w_dkv", "w_uk", "w_uv", "wo", "wq")]
    ffn = ([f"['stages'][0]['0']['mlp']['{n}']['kernel']"
            for n in ("down", "gate", "up")]
           + [f"['stages'][1]['0']['moe']['{n}']['kernel']"
              for n in ("down", "gate", "up")]
           + [f"['stages'][1]['0']['moe']['shared']['{n}']['kernel']"
              for n in ("down", "gate", "up")])
    assert on == sorted(attn + ffn)
    assert not flags["['stages'][1]['0']['attn']['kv_norm']['scale']"]
    assert not flags["['stages'][1]['0']['moe']['router']['kernel']"]


def test_kernel_dense_equals_reference(smoke):
    """A 2:4-compressed ``w_uk`` (magnitude mask, packed2) decompressed as
    the absorbed decode reads it: the reference's ``kernel_dense`` of its
    own packing of the same leaf and mask, and the masked-dense bf16
    weight, bit for bit; a dense leaf passes through."""
    jl, tl = smoke["layer"](1)
    w = tl["attn"]["w_uk"]["kernel"]
    mask = tmasks.nm_masks({"w": w.abs()})["w"]
    st = tpack.pack_nm(w, mask, idx_bits=2, dtype=torch.bfloat16)
    jst = jpack.pack_nm(jnp.asarray(w.numpy()), jnp.asarray(mask.numpy()),
                        idx_bits=2, dtype=jnp.bfloat16)
    got = TC.kernel_dense({"kernel": st})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got),
                                  bits(JC.kernel_dense({"kernel": jst})))
    assert torch.equal(got, (w * mask).to(torch.bfloat16))
    assert TC.kernel_dense(tl["attn"]["w_uk"]) is w
    # serving keeps the absorbed weights f32, as the reference reads them
    assert w.dtype == torch.float32
    assert tl["attn"]["wq"]["kernel"].dtype == torch.bfloat16


@pytest.mark.parametrize("M", [4, 8, 16])
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048)])
def test_expert_banks_at_e64_plan_no_k_split(M, K, N):
    """deepseek's banks on a 132-SM card: 64 experts x N/64 column tiles
    (1408 or 2048 blocks) already fill it twice over, so ``split_k``
    plans one block along K, and the split-K counters (``_MAX_TILES``,
    fewer than those tiles) are never asked for."""
    blocks = 64 * -(-N // nm_spmm._BN)
    assert blocks > 2 * 132 and blocks > nm_spmm._MAX_TILES
    assert nm_spmm.split_k(M, K, N, 132, experts=64)[0] == 1


def test_k_10944_plans_a_partial_last_stage():
    """The dense layer's down projection: K 10944 = 85.5 x 128, so the
    bf16 kernel's stages end in a half stage; at decode (M 4) its
    32 column tiles split K into slices of whole stages."""
    K, N = 10944, 2048
    assert K % nm_spmm._MMA_KC == 64
    ksplit, per = nm_spmm.split_k(4, K, N, 132)
    stages = -(-K // nm_spmm._MMA_KC)
    assert stages == 86 and ksplit > 1 and (ksplit - 1) * per < stages
    assert ksplit * per >= stages and -(-N // nm_spmm._BN) <= \
        nm_spmm._MAX_TILES


# ---------------------------------------------------------------------------
# MLA attention
# ---------------------------------------------------------------------------

def test_flash_attention_unequal_qk_and_v_widths():
    """MLA's prefill attention: qk width nope + rope = 48, v width 32, at
    scale 48 ** -0.5; q and k blocks of 8 over 24 positions."""
    rng = np.random.default_rng(5)
    H, Sq = 4, 24
    q, k = (jnp.asarray(rng.standard_normal((B, Sq, H, 48))).astype(
        jnp.bfloat16) for _ in range(2))
    v = jnp.asarray(rng.standard_normal((B, Sq, H, 32))).astype(jnp.bfloat16)
    kw = dict(scale=48 ** -0.5, q_block=8, kv_block=8)
    want = jax.jit(lambda q, k, v: JA.flash_attention(q, k, v, **kw))(q, k, v)
    got = TA.flash_attention(to_torch(q), to_torch(k), to_torch(v), **kw)
    assert tuple(got.shape) == (B, Sq, H, 32) and got.dtype == torch.bfloat16
    _close(got, want, "flash_attention")


def _mla_kw(cfg):
    return TB._mla_kwargs(cfg)


@pytest.mark.parametrize("capacity", [16, 8])
def test_mla_apply_full_matches_reference(smoke, capacity):
    """Capacity 8 < 12 prompt tokens: the ring keeps the last 8."""
    jcfg, cfg = smoke["cfg"]
    jl, tl = smoke["layer"](1)
    jpos, tpos = _positions()
    want, wc = jax.jit(lambda p, x: JA.mla_apply_full(
        p, x, positions=jpos, cache_capacity=capacity,
        **JB._mla_kwargs(jcfg)))(jl["attn"], smoke["x"])
    got, gc = TA.mla_apply_full(tl["attn"], to_torch(smoke["x"]),
                                positions=tpos, cache_capacity=capacity,
                                **_mla_kw(cfg))
    _close(got, want, "y")
    for name in ("ckv", "krope"):
        assert gc[name].dtype == torch.bfloat16
        assert tuple(gc[name].shape) == tuple(wc[name].shape)
        _close(gc[name], wc[name], name)


@pytest.mark.parametrize("S_new", [1, 3])
def test_mla_decode_and_verify_match_reference(smoke, S_new):
    """From a prefilled ring (carried across), rows at different
    positions: one decode step (S_new 1) or a 3-token verify pass; the
    output and every ring row within 4 ulps, the port's ring written in
    place."""
    jcfg, cfg = smoke["cfg"]
    jl, tl = smoke["layer"](1)
    C, P = 24, 10
    jpos, tpos = _positions(P)
    kw = JB._mla_kwargs(jcfg)
    _, jc = jax.jit(lambda p, x: JA.mla_apply_full(
        p, x, positions=jpos, cache_capacity=C, **kw))(
            jl["attn"], smoke["x"][:, :P])
    x = smoke["x"][:, P:P + S_new]
    t = np.array([P, P - 4], np.int32)
    if S_new == 1:
        fn = jax.jit(lambda p, x, c, t: JA.mla_apply_decode(p, x, c, t, **kw))
        tfn = TA.mla_apply_decode
    else:
        fn = jax.jit(lambda p, x, c, t: JA.mla_apply_verify(p, x, c, t, **kw))
        tfn = TA.mla_apply_verify
    want, wc = fn(jl["attn"], x, jc, jnp.asarray(t))
    tc = jax_params_to_torch(jc)
    got, gc = tfn(tl["attn"], to_torch(x), tc, torch.from_numpy(t),
                  **_mla_kw(cfg))
    assert gc is tc
    _close(got, want, "y")
    for name in ("ckv", "krope"):
        _close(gc[name], wc[name], name)


def test_mla_decode_refuses_more_than_one_token(smoke):
    _, cfg = smoke["cfg"]
    _, tl = smoke["layer"](0)
    cache = TA.make_mla_cache(B, 8, cfg.kv_lora, cfg.qk_rope_dim,
                              device="cpu")
    with pytest.raises(ValueError, match="one token per row"):
        TA.mla_apply_decode(tl["attn"], torch.zeros(B, 2, cfg.d_model),
                            cache, torch.zeros(B, dtype=torch.int32),
                            **_mla_kw(cfg))


# ---------------------------------------------------------------------------
# shared experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [4, 24])
def test_moe_with_shared_expert_matches_reference(smoke, T):
    """The routed experts plus the shared gated MLP of width 1 x moe_d_ff
    over every token: T = 4 is a decode step, T = 24 a prefill whose
    capacity (8) drops assignments."""
    jcfg, cfg = smoke["cfg"]
    jl, tl = smoke["layer"](1)
    assert sorted(tl["moe"]["shared"]) == ["down", "gate", "up"]
    assert tuple(tl["moe"]["shared"]["up"]["kernel"].shape) == (
        cfg.d_model, cfg.num_shared_experts * cfg.moe_d_ff)
    x = jnp.asarray(smoke["rng"].standard_normal((1, T, cfg.d_model))
                    ).astype(jnp.bfloat16)
    want, want_aux = jax.jit(lambda p, x: JMOE.moe_apply(
        p, x, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor))(
            jl["moe"], x)
    got, got_aux = TMOE.moe_apply(tl["moe"], to_torch(x), top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor)
    _close(got, want, "y")
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0,
                               atol=1e-6)
    # without its shared expert the layer is the routed part alone
    routed = {k: v for k, v in tl["moe"].items() if k != "shared"}
    alone, _ = TMOE.moe_apply(routed, to_torch(x), top_k=cfg.top_k)
    assert not torch.equal(alone, got)


@pytest.mark.parametrize("kind", ["mla_dense", "mla_moe"])
def test_mla_block_matches_reference(smoke, kind):
    """One whole block of each MLA kind (norms, MLA, the residual adds,
    the MLP or the MoE FFN with its shared expert), jitted reference."""
    jcfg, cfg = smoke["cfg"]
    jl, tl = smoke["layer"](0 if kind == "mla_dense" else 1)
    jpos, tpos = _positions()
    want = jax.jit(lambda p, x: JB.block_apply_full(
        kind, jcfg, p, x, JB.Ctx(positions=jpos)))(jl, smoke["x"])[0]
    got = TB.block_apply_full(kind, cfg, tl, to_torch(smoke["x"]),
                              TB.Ctx(positions=tpos))[0]
    _close(got, want, kind)


def test_smoke_model_prefill_and_decode_logits_match_reference(smoke):
    """The whole smoke model (an mla_dense layer, two mla_moe layers),
    dense: prefill and 3 decode steps with the rows at different
    positions, logits and every ring row within 4 ulps (the 2:4 model:
    tests/test_torch_deepseek.py)."""
    jcfg, cfg = smoke["cfg"]
    jp, tp = smoke["params"]
    tp = TM.serving_params(tp)
    P, C, steps = 12, 32, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (steps, B)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, cache_capacity=C))(jp, toks)
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=C)
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    for i in range(steps + 1):
        _close(tl, jl, f"logits, step {i}")
        if i == steps:
            break
        t = np.array([P + i, P - 3 + i], np.int32)   # rows apart
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))
    jf = jax_flat(jc)
    for path, leaf in tree.flatten_with_path(tc):
        _close(leaf, jf[path], path)


# ---------------------------------------------------------------------------
# kv_shards: MLA decode has no decode-attention kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_shards", [1, 4])
def test_kv_shards_refused_for_mla(smoke, kv_shards):
    """A set ``kv_shards`` would change nothing on MLA layers (the
    reference's MLA decode is plain ``jnp``), so it raises, at the
    engine's construction and at a direct decode call."""
    _, cfg = smoke["cfg"]
    _, tp = smoke["params"]
    with pytest.raises(ValueError, match="MLA"):
        ServeEngine(cfg, tp, slots=2, capacity=32, device="cpu",
                    kv_shards=kv_shards)
    with pytest.raises(ValueError, match="MLA"):
        EngineFns(cfg, 32, torch.device("cpu"), kv_shards)
    _, tl = smoke["layer"](0)
    cache = TB.block_init_cache("mla_dense", cfg, B, 32, device="cpu")
    with pytest.raises(ValueError, match="MLA"):
        TB.block_apply_decode("mla_dense", cfg, tl, torch.zeros(
            B, 1, cfg.d_model, dtype=torch.bfloat16), cache,
            torch.zeros(B, dtype=torch.int32), kv_shards=kv_shards)
    # kv_shards=None serves
    ServeEngine(cfg, tp, slots=2, capacity=32, device="cpu")
