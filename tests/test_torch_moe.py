"""repro_torch MoE serving (mixtral smoke, moe-tiny) against the JAX
reference on the CPU: the expert kernel's plain version, the MoE FFN, the
expert-bank compressed format, the sliding window, and the serve engine.

Inputs are made by numpy from a seed and handed to both packages; params
are the reference's own (``init_params(cfg, jax.random.key(0))``, or the
committed ``results/bench_models/moe-tiny.pkl``), carried across by
``repro_torch.convert``.

Tolerances:
  * nm_matmul_expert: bf16 output rtol = atol = 2e-2, f32 output 1e-5 (the
    bounds of tests/test_kernels.py: one bf16 rounding of an f32 sum);
  * moe_apply y: 4 bf16 ulps of max |y| (atol = 4 * 2**-8 * max|y|), aux
    1e-6; expert ids, keep flags and positions exactly; the forward's aux,
    summed over layers from f32 means taken in another order, rtol 1e-5;
  * logits: 4 bf16 ulps of the largest logit, as tests/test_torch_model.py;
  * index planes, masks and greedy token streams exactly.
"""
import pathlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_same_leaves, jax_params_to_torch, to_torch
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.core import masks as jmasks
from repro.kernels import ref as jref
from repro.kernels.nm_spmm import nm_matmul_expert as jax_nm_matmul_expert
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sparse import apply as japply
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro.sparse.formats import _pack_idx2 as jax_pack_idx2
from repro_torch import tree
from repro_torch.configs.base import ModelConfig, get_smoke_config
from repro_torch.convert import load_params_pickle
from repro_torch.core import calibrate as tcal
from repro_torch.core import masks as tmasks
from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                         nm_matmul_expert,
                                         nm_matmul_expert_plain)
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import ServeEngine
from repro_torch.sparse import apply as tapply
from repro_torch.sparse.bank import MaskBank

ROOT = pathlib.Path(__file__).parent.parent
ARCH = "mixtral-8x22b"
# BENCH_serve_moe.json's setup (benchmarks/table8_inference.py
# serve_bench_moe): 4 prompts of unequal length, 2 slots, capacity 32,
# 6 new tokens each, magnitude 2:4 masks
BENCH_PROMPTS = [[5, 6, 7, 8], [9, 10, 11], [1, 2], [12, 13, 14, 15, 16]]
BENCH_STEPS = 6
# the moe-tiny family of benchmarks/common.py, field for field
MOE_TINY = dict(name="moe-tiny", family="moe", d_model=128, num_layers=4,
                num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
                moe_d_ff=256, vocab_size=512, pattern=("moe",),
                num_experts=4, top_k=2)


def _ulps(want, n=4) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


@pytest.fixture(scope="module")
def smoke():
    """Mixtral smoke params (the reference's), magnitude 2:4 masks, and
    the 2:4-compressed and masked-dense trees, in both packages."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = jax_params_to_torch(jp)
    jm = jcal.baseline_masks("magnitude", jp,
                             jax.tree.map(lambda _: None, jp), 0.5,
                             mode="nm")
    tm = tcal.baseline_masks("magnitude", tp,
                             tree.tree_map(lambda _: None, tp), 0.5,
                             mode="nm")
    return {
        "cfg": (jcfg, cfg), "dense": (jp, tp), "masks": (jm, tm),
        "nm24": (japply.sparsify_params(jp, jm, axes=JM.param_axes(jcfg),
                                        idx_bits=2, dtype=jnp.bfloat16),
                 tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                        idx_bits=2, dtype=torch.bfloat16)),
        "masked": (jmasks.apply_masks(jp, jm), tmasks.apply_masks(tp, tm)),
    }


# ---------------------------------------------------------------------------
# nm_matmul_expert: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,K", [(LAYOUT_PACKED2, 128),
                                      (LAYOUT_INT8, 132)])
@pytest.mark.parametrize("M", [1, 4, 40])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nm_matmul_expert_plain_matches_jax_interpret(layout, K, M, dtype):
    E, N = 4, 96
    rng = np.random.default_rng(K + M)
    w = rng.standard_normal((E, K, N)).astype(np.float32)
    x = (0.1 * rng.standard_normal((E, M, K))).astype(np.float32)
    comp = [jref.compress_24(jnp.asarray(w[e])) for e in range(E)]
    jdt = getattr(jnp, dtype)
    vals = jnp.stack([v for v, _ in comp]).astype(jdt)
    idx = jnp.stack([i for _, i in comp])
    plane = (jnp.stack([jax_pack_idx2(i) for _, i in comp])
             if layout == LAYOUT_PACKED2 else idx)
    jx = jnp.asarray(x).astype(jdt)
    tx, tv, tp = to_torch(jx), to_torch(vals), to_torch(plane)
    tol = {"bfloat16": 2e-2, "float32": 1e-5}[dtype]
    for out_dtype, t_out, o_tol in ((None, None, tol),
                                    (jnp.float32, torch.float32, 1e-5)):
        want = jax_nm_matmul_expert(jx, vals, plane, bm=M, bk=K, bn=N,
                                    layout=layout, interpret=True,
                                    out_dtype=out_dtype)
        got = nm_matmul_expert(tx, tv, tp, layout=layout, out_dtype=t_out)
        assert got.shape == (E, M, N)
        assert got.dtype == (t_out or getattr(torch, dtype))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=o_tol, atol=o_tol)
    # the wrapper's CPU path is the plain version
    assert torch.equal(nm_matmul_expert(tx, tv, tp),
                       nm_matmul_expert_plain(tx, tv, tp))


def test_nm_matmul_expert_rejects_mismatched_expert_axes():
    x = torch.zeros((4, 2, 16))
    vals = torch.zeros((3, 8, 6))
    idx = torch.zeros((3, 8, 6), dtype=torch.int8)
    with pytest.raises(ValueError, match="expert axes"):
        nm_matmul_expert(x, vals, idx)


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["dense", "nm24"])
@pytest.mark.parametrize("T", [5, 64])
def test_moe_apply_matches_reference(smoke, weights, T):
    """T = 5 is a decode-sized batch (C = T, nothing dropped).  T = 64
    gives C = 40 rows per expert, and 40 repeated tokens (a repeated
    phrase) all route to one pair of experts, whose overflow is dropped."""
    jcfg, cfg = smoke["cfg"]
    jt, tt = smoke[weights]
    jp = jax.tree.map(lambda a: a[1], jt["stages"][0]["0"]["moe"])
    tp = TM._layer(TM.serving_params(tt)["stages"][0], 1)["0"]["moe"]
    rng = np.random.default_rng(T)
    x = rng.standard_normal((1, T, cfg.d_model))
    if T > 8:
        x[:, :40] = x[:, :1]
    x = jnp.asarray(x).astype(jnp.bfloat16)
    cf = cfg.capacity_factor
    want_y, want_aux = jmoe.moe_apply(jp, x, top_k=cfg.top_k,
                                      capacity_factor=cf)
    got_y, got_aux = tmoe.moe_apply(tp, to_torch(x), top_k=cfg.top_k,
                                    capacity_factor=cf)
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y, np.float32), rtol=0,
                               atol=_ulps(want_y))
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=0,
                               atol=1e-6)
    # routing: expert ids, capacity positions and drops, exactly
    E = cfg.num_experts
    jl = jnp.einsum("gtd,de->gte", x.astype(jnp.float32),
                    jp["router"]["kernel"].astype(jnp.float32))
    _, jidx = jax.lax.top_k(jax.nn.softmax(jl, axis=-1), cfg.top_k)
    _, _, tidx = tmoe.route(tp["router"], to_torch(x), cfg.top_k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    C = tmoe.capacity(T, cfg.top_k, E, cf)
    flat = jidx.reshape(1, -1)
    want_pos = jmoe._positions_in_expert(flat, E, C)[:3]
    got_pos = tmoe._positions_in_expert(tidx.reshape(1, -1), E, C)[:3]
    for g, w in zip(got_pos, want_pos, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dropped = int((~got_pos[2]).sum())
    assert (dropped > 0) == (T > 8), dropped


# ---------------------------------------------------------------------------
# compressed expert banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx_bits", [2, 8])
def test_sparsify_expert_banks_equal_reference(smoke, idx_bits):
    jcfg, cfg = smoke["cfg"]
    (jp, tp), (jm, tm) = smoke["dense"], smoke["masks"]
    assert_same_leaves(jm, tm)
    jsp = japply.sparsify_params(jp, jm, axes=JM.param_axes(jcfg),
                                 idx_bits=idx_bits, dtype=jnp.bfloat16)
    tsp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                 idx_bits=idx_bits, dtype=torch.bfloat16)
    assert_same_leaves(jsp, tsp)
    bank = dict(tree.flatten_with_path(tsp))[
        "['stages'][0]['0']['moe']['up']['kernel']"]
    assert bank.shape == (4, 4, 128, 256)   # (layers, E, d_in, d_out)


def test_compressed_report_matches_bench_serve_moe(smoke):
    """The bytes of results/bench/BENCH_serve_moe.json."""
    tsp, tm = smoke["nm24"][1], smoke["masks"][1]
    rep = tapply.compressed_report(tsp, tm)
    assert rep["bytes_compressed"] == 1990656
    assert rep["bytes_dense_bf16"] == 3538944
    assert rep["ratio"] == 0.5625
    assert rep["fallback_leaves"] == 0
    expert = [r for r in rep["layers"] if "['moe']" in r["path"]]
    assert len(expert) == 3
    assert all(r["kernel_layout"] == LAYOUT_PACKED2 for r in expert)
    jrep = japply.compressed_report(smoke["nm24"][0], smoke["masks"][0])
    assert [(r["path"], r["bytes_compressed"]) for r in rep["layers"]] == \
        [(r["path"], r["bytes_compressed"]) for r in jrep["layers"]]


# ---------------------------------------------------------------------------
# sliding window: prefill and decode past the 16-token window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_windowed_prefill_and_decode_logits(smoke, weights):
    jcfg, cfg = smoke["cfg"]
    jp, tp = smoke[weights]
    tp = TM.serving_params(tp)
    B, P, C, steps = 2, 40, 48, 4     # prompts 2.5x the window
    assert cfg.sliding_window == 16 < P
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (steps, B)).astype(np.int32)
    want_full, want_aux, _ = jax.jit(
        lambda p, t: JM.forward(jcfg, p, {"tokens": t}))(jp, toks)
    got_full, got_aux, _ = TM.forward(cfg, tp,
                                      {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full),
                               rtol=0, atol=_ulps(want_full))
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5,
                               atol=0)
    jpre = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t},
                                           cache_capacity=C))
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    jl, jc = jpre(jp, toks)
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=C)
    # the windowed ring holds min(capacity, window) slots
    assert tuple(tc[0]["0"]["k"].shape) == tuple(jc[0]["0"]["k"].shape) \
        == (cfg.num_layers, B, 16, cfg.num_kv_heads, cfg.head_dim)
    for i in range(steps + 1):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
        if i == steps:
            break
        t = np.full((B,), P + i, np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------

def _streams(eng, prompts, steps):
    rids = [eng.submit(np.asarray(p, np.int32), steps) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def test_engine_streams_match_reference_on_bench_serve_moe(smoke):
    jcfg, cfg = smoke["cfg"]
    jsp, tsp = smoke["nm24"]
    want = _streams(JaxServeEngine(jcfg, jsp, slots=2, capacity=32),
                    BENCH_PROMPTS, BENCH_STEPS)
    eng = ServeEngine(cfg, tsp, slots=2, capacity=32, device="cpu")
    got = _streams(eng, BENCH_PROMPTS, BENCH_STEPS)
    assert got == want
    # MoE prefill runs at the exact prompt length (no padded bucket)
    assert eng._prefill_bucket(3) == 3 and eng.prefill_calls == 4
    masked = ServeEngine(cfg, smoke["masked"][1], slots=2, capacity=32,
                         device="cpu")
    assert _streams(masked, BENCH_PROMPTS, BENCH_STEPS) == got


@pytest.fixture(scope="module")
def moe_tiny():
    """The trained moe-tiny of benchmarks/common.py and its committed
    calibration bank (an arch outside the config registry: cfg passed)."""
    jcfg, cfg = JaxModelConfig(**MOE_TINY), ModelConfig(**MOE_TINY)
    path = ROOT / "results" / "bench_models" / "moe-tiny.pkl"
    with open(path, "rb") as f:
        jp = jax.tree.map(jnp.asarray, pickle.load(f))
    tp = load_params_pickle(path)
    assert_same_leaves(jp, tp)
    bank_dir = ROOT / "results" / "bench_banks" / "moe-tiny-unstructured"
    return (jcfg, cfg, jp, tp, JaxMaskBank.load(bank_dir, cfg=jcfg),
            MaskBank.load(bank_dir, cfg=cfg, device="cpu"))


@pytest.mark.parametrize("budget", [{"nm": (2, 4)}, {"sparsity": 0.5}])
def test_moe_tiny_bank_masks_and_streams_match_reference(moe_tiny, budget):
    jcfg, cfg, jp, tp, jbank, tbank = moe_tiny
    assert_same_leaves(jbank.masks_at(**budget), tbank.masks_at(**budget))
    compressed = "nm" in budget
    jsp = jbank.sparse_params(jp, compressed=compressed, **budget)
    tsp = tbank.sparse_params(tp, compressed=compressed, **budget)
    assert_same_leaves(jsp, tsp)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (9, 20, 5)]
    want = _streams(JaxServeEngine(jcfg, jsp, slots=2, capacity=48),
                    prompts, 5)
    got = _streams(ServeEngine(cfg, tsp, slots=2, capacity=48,
                               device="cpu"), prompts, 5)
    assert got == want


def test_launcher_serves_mixtral_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "24", "--gen", "4", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x24" in out and "sample continuation" in out
