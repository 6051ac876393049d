"""repro_torch decode attention (``kernels/flash_decode.py``,
``kernels/shard.py`` and the ``kv_shards`` paths of ``decode_attend``,
``decode_step`` and ``ServeEngine``) against the JAX reference on the CPU.

Inputs are made by numpy from a seed and handed to both packages; the JAX
kernels run in interpret mode, always without ``scale=`` (with an explicit
scale they fail under jit on jax 0.9: "captures constants"; the default is
the D**-0.5 both sides use).

The reference's own capacity-sharded path cannot run here: its
``decode_attend_sharded`` wraps ``shard_map(..., check_rep=False)``, which
jax 0.9 refuses.  So the model-level tests monkeypatch
``repro.kernels.shard.kv_shard_axes`` and ``decode_attend_sharded`` with a
test-local stand-in that computes what the reference's TPU branch computes
(``shard.py:318-330``) on one device: ``flash_decode_partial(..., bc=C/S,
interpret=True)`` on each of S capacity shards, combined by the
pmax/psum expression of ``shard.py:327-330`` written out over the shard
list (S = 1: ``flash_decode(..., interpret=True)``, the port of
``ops.py:76``).  Nothing in ``src/repro`` is edited.

Tolerances:
  * f32 outputs: rtol 2e-4, atol 2e-5 (tests/test_kernels.py's own for
    ``flash_decode``: the kernel sums in chunks, the oracle at once);
  * bf16 outputs: one bf16 ulp of the element plus 2e-5 (the f32 values
    differ as above, and may round to neighbouring bf16 values);
  * an all-masked shard: m == -1e30 and l == its slot count exactly;
  * logits: 4 bf16 ulps of the largest logit (tests/test_torch_model.py),
    for gemma3-1b and yi-6b (tests/test_torch_gemma.py) and zamba2-7b
    (tests/test_torch_zamba.py) too;
  * greedy token streams exactly.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (_jax_combine, _want_calls,  # noqa: F401
                         jax_kv_shards, jax_params_to_torch, port_calls)
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.kernels.flash_decode import (flash_decode as jax_flash_decode,
                                        flash_decode_partial as
                                        jax_flash_decode_partial,
                                        flash_decode_ref as
                                        jax_flash_decode_ref)
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.sparse import apply as japply
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.kernels import ref
from repro_torch.kernels import shard as tshard
from repro_torch.kernels.flash_decode import (combine_partials, flash_decode,
                                              flash_decode_partial)
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.serve.engine import ServeEngine
from repro_torch.sparse import apply as tapply

ROOT = pathlib.Path(__file__).parent.parent
BANK = ROOT / "results" / "bank" / "llama3.2-1b"
NEG = -1e30
RTOL, ATOL = 2e-4, 2e-5


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def assert_out_close(got: torch.Tensor, want, dtype: str) -> None:
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "bfloat16":
        err = np.abs(got - want)
        tol = _bf16_ulp(want) + ATOL
        assert (err <= tol).all(), float((err / tol).max())
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _operands(seed, B, K, G, D, C, dtype, valid=None):
    """q, k, v (numpy f32, bf16-representable when dtype is bf16) and an
    f32 bias of 0 / -1e30 with row b valid on its first valid[b] slots."""
    rng = np.random.default_rng(seed)
    q = 0.5 * rng.standard_normal((B, K, G, D))
    k = 0.5 * rng.standard_normal((B, C, K, D))
    v = 0.5 * rng.standard_normal((B, C, K, D))
    if valid is None:
        valid = rng.integers(C // 2, C + 1, size=B)
    bias = np.where(np.arange(C)[None, :] < np.asarray(valid)[:, None],
                    0.0, NEG).astype(np.float32)
    jdt = getattr(jnp, dtype)
    arrs = [np.array(jnp.asarray(a, jnp.float32).astype(jdt)
                     .astype(jnp.float32)) for a in (q, k, v)]
    return (*arrs, bias)


def _both(arrs, dtype):
    """The operands as jax arrays and torch tensors, in ``dtype``."""
    tdt = getattr(torch, dtype)
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs[:3]]
    t = [torch.from_numpy(a).to(tdt) for a in arrs[:3]]
    return (*j, jnp.asarray(arrs[3])), (*t, torch.from_numpy(arrs[3]))


# (B, K, G, D, C): tests/test_kernels.py:163's dims, llama3.2-1b's heads
# (8 kv x 4 of 64), mixtral-8x22b's (8 kv x 6 of 128), gemma3-1b's (1 kv x
# 4 of 256), yi-6b's (4 kv x 8 of 128) and zamba2-7b's (kv heads of one
# query head of 112) at a small C
DIMS = [(2, 2, 4, 32, 128), (1, 1, 8, 64, 256), (2, 4, 1, 32, 64),
        (2, 8, 4, 64, 64), (2, 8, 6, 128, 32), (4, 1, 4, 256, 64),
        (4, 4, 8, 128, 64), (2, 4, 1, 112, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", DIMS, ids=str)
def test_flash_decode_plain_matches_jax(dims, dtype):
    B, K, G, D, C = dims
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(
        _operands(sum(dims), B, K, G, D, C, dtype), dtype)
    before = flash_decode.launches
    got = flash_decode(tq, tk, tv, tb)
    assert flash_decode.launches == before      # the CPU runs the plain one
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, K, G, D)
    assert_out_close(got, jax_flash_decode(jq, jk, jv, jb, bc=min(32, C),
                                           interpret=True), dtype)
    assert_out_close(got, jax_flash_decode_ref(jq, jk, jv, jb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_flash_decode_partial_plain_matches_jax_per_shard(shards, dtype):
    """Shard s of the port's one call against the reference kernel on
    capacity slice s; row 0 sees only the first 5 slots, so shards 1..S-1
    are all-masked there."""
    B, K, G, D, C = 3, 2, 4, 32, 64
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(
        _operands(7 + shards, B, K, G, D, C, dtype, valid=[5, 40, 64]),
        dtype)
    acc, m, l = flash_decode_partial(tq, tk, tv, tb, shards=shards)
    n = C // shards
    assert acc.shape == (shards, B, K, G, D) and m.shape == l.shape \
        == (shards, B, K, G, 1)
    assert acc.dtype == m.dtype == l.dtype == torch.float32
    masked = 0
    for s in range(shards):
        sl = slice(s * n, (s + 1) * n)
        ja, jm, jl = (np.asarray(x) for x in jax_flash_decode_partial(
            jq, jk[:, sl], jv[:, sl], jb[:, sl], bc=n, interpret=True))
        np.testing.assert_allclose(acc[s].numpy(), ja, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(m[s].numpy(), jm, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(l[s].numpy(), jl, rtol=RTOL, atol=ATOL)
        dead = jm == NEG
        masked += int(dead.any())
        np.testing.assert_array_equal(m[s].numpy()[dead], np.float32(NEG))
        np.testing.assert_array_equal(l[s].numpy()[dead], np.float32(n))
    assert masked == shards - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims", [(4, 1, 4, 256, 64), (4, 4, 8, 128, 64),
                                  (4, 8, 1, 112, 64)],
                         ids=["gemma3 heads", "yi heads", "zamba2 heads"])
def test_wide_shapes_partial_and_combine_match_jax(dims, dtype):
    """gemma3-1b's (G 4, D 256), yi-6b's (G 8, D 128) and zamba2-7b's
    (G 1, D 112) through 4
    capacity shards: each shard's state against the reference kernel on
    its slice, the combine against the pmax / psum expression and the
    oracle; row 0 sees only the first 9 slots (shards 1..3 all-masked)."""
    B, K, G, D, C = dims
    S, n = 4, C // 4
    arrs = _operands(D + G, B, K, G, D, C, dtype, valid=[9, 40, 64, 17])
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(arrs, dtype)
    acc, m, l = flash_decode_partial(tq, tk, tv, tb, shards=S)
    parts = []
    for s in range(S):
        sl = slice(s * n, (s + 1) * n)
        parts.append(jax_flash_decode_partial(jq, jk[:, sl], jv[:, sl],
                                              jb[:, sl], bc=n,
                                              interpret=True))
        for got, want in zip((acc[s], m[s], l[s]), parts[-1]):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
    assert_out_close(combine_partials(acc, m, l, tq.dtype),
                     _jax_combine(parts, jq.dtype), dtype)
    ok = torch.from_numpy(arrs[3] == 0.0)
    assert_out_close(tshard.decode_attend_sharded(tq, tk, tv, ok, shards=S,
                                                  scale=D ** -0.5),
                     jax_flash_decode_ref(jq, jk, jv, jb), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [2, 4])
def test_decode_attend_sharded_matches_jax_combine(shards, dtype):
    B, K, G, D, C = 3, 2, 2, 32, 64
    arrs = _operands(11 + shards, B, K, G, D, C, dtype, valid=[3, 33, 64])
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(arrs, dtype)
    ok = torch.from_numpy(arrs[3] == 0.0)
    got = tshard.decode_attend_sharded(tq, tk, tv, ok, shards=shards,
                                       scale=D ** -0.5)
    assert got.dtype == tq.dtype and got.shape == (B, K, G, D)
    n = C // shards
    parts = [jax_flash_decode_partial(jq, jk[:, s:s + n], jv[:, s:s + n],
                                      jb[:, s:s + n], bc=n, interpret=True)
             for s in range(0, C, n)]
    assert_out_close(got, _jax_combine(parts, jq.dtype), dtype)
    assert_out_close(got, jax_flash_decode_ref(jq, jk, jv, jb), dtype)
    # the combine alone, on the reference's partials
    stacked = [torch.from_numpy(np.stack([np.array(p[i]) for p in parts]))
               for i in range(3)]
    assert_out_close(combine_partials(*stacked, tq.dtype),
                     _jax_combine(parts, jq.dtype), dtype)


# ---------------------------------------------------------------------------
# The model and engine paths against JAX under the stand-in
# ---------------------------------------------------------------------------

def _ulps(want, n=4) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def _rings(cfg, C) -> list:
    """The ring length of every block's decode attention in trace order:
    each stage's pattern once (the reference scans each stage's body)."""
    from repro_torch.models import blocks as tblk
    return [tblk.cache_length(k, cfg, C) for pattern, _ in TM.make_stages(cfg)
            for k in pattern]


@pytest.fixture(scope="module")
def smoke_models():
    out = {}
    for arch in ("llama3.2-1b", "mixtral-8x22b", "gemma3-1b", "gemma2-2b"):
        jcfg = jax_smoke_config(arch)
        jp = JM.init_params(jcfg, jax.random.key(0))
        out[arch] = (jcfg, get_smoke_config(arch), jp,
                     TM.serving_params(jax_params_to_torch(jp)))
    return out


@pytest.mark.parametrize("arch,B,P,C,kv_shards", [
    (arch, *shape, S) for arch, *shape in (("llama3.2-1b", 2, 12, 24),
                                           ("mixtral-8x22b", 2, 20, 48))
    for S in (1, 2, 4)] + [("gemma3-1b", 2, 20, 48, S) for S in (1, 4)])
def test_decode_step_kv_shards_match_jax(smoke_models, jax_kv_shards,
                                         port_calls, arch, B, P, C,
                                         kv_shards):
    """Prefill, then 4 teacher-forced decode steps with the rows at
    different positions; mixtral's and gemma3's windowed rings (16 slots)
    wrap, gemma3's global layers keep the whole capacity."""
    jcfg, cfg, jp, tp = smoke_models[arch]
    traced = jax_kv_shards(kv_shards)
    rng = np.random.default_rng(kv_shards)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (4, B)).astype(np.int32)
    jpre = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t},
                                           cache_capacity=C))
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    jl, jc = jpre(jp, toks)
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=C)
    for i in range(4):
        t = np.array([P + i, P - 3 + 2 * i], np.int32)[:B]
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t), kv_shards=kv_shards)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
    # both sides took the sharded path in every layer: JAX traced each
    # stage's decode body once (its layers are one scanned body), the port
    # ran every layer of every step
    assert traced == _rings(cfg, C)
    assert port_calls == _want_calls(kv_shards, 4 * cfg.num_layers)


@pytest.mark.parametrize("kv_shards", [1, 4])
def test_softcapped_decode_takes_the_replicated_path(smoke_models,
                                                     jax_kv_shards,
                                                     port_calls, kv_shards):
    """gemma2's attention softcap keeps the reference on its replicated
    branch at any mesh (attention.py:354): the port's decode at any
    ``kv_shards`` is its ``kv_shards=None`` path, bit for bit, and no
    kernel wrapper is called."""
    jcfg, cfg, jp, tp = smoke_models["gemma2-2b"]
    traced = jax_kv_shards(kv_shards)
    rng = np.random.default_rng(kv_shards)
    toks = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (3, 2)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t},
                                             cache_capacity=24))(jp, toks)
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    runs = {}
    for S in (None, kv_shards):
        tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                            cache_capacity=24)
        runs[S] = []
        for i in range(3):
            t = torch.tensor([12 + i, 9 + 2 * i], dtype=torch.int32)
            tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                    t, kv_shards=S)
            runs[S].append(tl)
    for i in range(3):
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc,
                      jnp.asarray([12 + i, 9 + 2 * i], jnp.int32))
        assert torch.equal(runs[kv_shards][i], runs[None][i]), i
        np.testing.assert_allclose(runs[None][i].numpy(), np.asarray(jl),
                                   rtol=0, atol=_ulps(jl))
    assert traced == [] and port_calls == {}


def _streams(eng, prompts, max_tokens):
    rids = [eng.submit(np.asarray(p, np.int32), m)
            for p, m in zip(prompts, max_tokens)]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("kv_shards", [1, 4])
def test_bank_engine_streams_match_jax(jax_kv_shards, port_calls,
                                      kv_shards):
    """The committed bank's smoke llama, 2:4-compressed, on
    tests/test_torch_serve.py's requests (the third admits mid-batch)."""
    from repro.data import synthetic as jsyn
    traced = jax_kv_shards(kv_shards)
    jcfg = jax_smoke_config("llama3.2-1b")
    jp = JM.init_params(jcfg, jax.random.key(0))
    reqs = [(9, 6), (40, 3), (17, 8)]
    toks = jsyn.batches_for(jcfg, n=1, batch=3, seq=64, split="valid")[0][
        "tokens"]
    prompts = [toks[i, :n] for i, (n, _) in enumerate(reqs)]
    want = _streams(JaxServeEngine.from_artifact(BANK, jp, slots=2,
                                                 capacity=64),
                    prompts, [m for _, m in reqs])
    eng = ServeEngine.from_artifact(BANK, jax_params_to_torch(jp), slots=2,
                                    capacity=64, device="cpu",
                                    kv_shards=kv_shards)
    assert eng.fns.kv_shards == kv_shards
    assert _streams(eng, prompts, [m for _, m in reqs]) == want
    assert traced == [64]
    assert port_calls == _want_calls(kv_shards, 4 * eng.decode_steps)


def test_gemma3_engine_streams_match_jax(smoke_models, jax_kv_shards,
                                         port_calls):
    """The smoke gemma3 (5:1 local:global, a 16-slot window, one kv head
    of 4 query heads) served at capacity 48 with 4 capacity shards: the
    local rings and the global ones both through the decode attention
    kernels' plain versions (``kv_shards=1``: the decode-step test above);
    the first prompt is longer than the window."""
    kv_shards = 4
    jcfg, cfg, jp, tp = smoke_models["gemma3-1b"]
    traced = jax_kv_shards(kv_shards)
    prompts = [list(range(3, 21)), [9, 10, 11]]
    want = _streams(JaxServeEngine(jcfg, jp, slots=2, capacity=48),
                    prompts, [5, 4])
    eng = ServeEngine(cfg, tp, slots=2, capacity=48, device="cpu",
                      kv_shards=kv_shards)
    assert _streams(eng, prompts, [5, 4]) == want
    assert traced == _rings(cfg, 48)
    assert port_calls == _want_calls(kv_shards,
                                     cfg.num_layers * eng.decode_steps)


@pytest.fixture(scope="module")
def smoke_zamba():
    from _torch_port import smoke_recurrent
    return smoke_recurrent("zamba2-7b")


@pytest.mark.parametrize("kv_shards", [1, 4])
def test_zamba2_shared_attention_kv_shards_match_jax(smoke_zamba,
                                                     jax_kv_shards,
                                                     port_calls, kv_shards):
    """zamba2's shared attention (G 1, its per-invocation LoRA deltas on
    q, k, v) on the kv_shards paths: 3 decode steps' logits against the
    reference's, rows at different positions; only the ``mamba_shared``
    layer attends (one traced site, one call a step); then the dense
    engine's streams at the same kv_shards (a one-token prompt among
    them)."""
    jcfg, cfg = smoke_zamba["cfg"]
    jp, tp = smoke_zamba["dense"]
    tp = TM.serving_params(tp)
    traced = jax_kv_shards(kv_shards)
    B, P, C = 2, 12, 32
    rng = np.random.default_rng(kv_shards)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (3, B)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(jcfg, p, {"tokens": t},
                                             cache_capacity=C))(jp, toks)
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=C)
    for i in range(3):
        t = np.array([P + i, P - 3 + 2 * i], np.int32)
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t), kv_shards=kv_shards)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=_ulps(jl), err_msg=f"step {i}")
    n_attn = sum(k == "mamba_shared" for k in cfg.layer_kinds)
    assert traced == [C]
    assert port_calls == _want_calls(kv_shards, 3 * n_attn)
    port_calls.clear()
    prompts = smoke_zamba["prompts"]
    want = _streams(JaxServeEngine(jcfg, jp, slots=2, capacity=C),
                    prompts, [5] * len(prompts))
    eng = ServeEngine(cfg, tp, slots=2, capacity=C, device="cpu",
                      kv_shards=kv_shards)
    assert _streams(eng, prompts, [5] * len(prompts)) == want
    assert port_calls == _want_calls(kv_shards,
                                     n_attn * eng.decode_steps)


def test_mixtral_engine_streams_match_jax(jax_kv_shards, port_calls):
    """BENCH_serve_moe's setup (tests/test_torch_moe.py), magnitude 2:4,
    4 capacity shards of the 16-slot windowed ring (capacity 32)."""
    traced = jax_kv_shards(4)
    arch = "mixtral-8x22b"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = jax_params_to_torch(jp)
    jm = jcal.baseline_masks("magnitude", jp,
                             jax.tree.map(lambda _: None, jp), 0.5,
                             mode="nm")
    tm = tcal.baseline_masks("magnitude", tp,
                             tree.tree_map(lambda _: None, tp), 0.5,
                             mode="nm")
    jsp = japply.sparsify_params(jp, jm, axes=JM.param_axes(jcfg),
                                 idx_bits=2, dtype=jnp.bfloat16)
    tsp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                 idx_bits=2, dtype=torch.bfloat16)
    prompts = [[5, 6, 7, 8], [9, 10, 11], [1, 2], [12, 13, 14, 15, 16]]
    want = _streams(JaxServeEngine(jcfg, jsp, slots=2, capacity=32),
                    prompts, [6] * 4)
    eng = ServeEngine(cfg, tsp, slots=2, capacity=32, device="cpu",
                      kv_shards=4)
    assert _streams(eng, prompts, [6] * 4) == want
    assert traced == [16]
    assert port_calls == _want_calls(4, 4 * eng.decode_steps)


# ---------------------------------------------------------------------------
# kv_shards=None is the replicated path as it was; bad values raise
# ---------------------------------------------------------------------------

def _replicated(q, cache_k, cache_v, kpos, t, *, scale, window):
    """decode_attend's body before kv_shards existed, op for op."""
    B, H, D = q.shape
    K = cache_k.shape[2]
    qg = q.reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bckd->bkgc", qg.float(), cache_k.float()) * scale
    kb = kpos if kpos.dim() == 2 else kpos[None]
    tq = t.to(torch.int32)
    tb = tq[:, None] if tq.dim() == 1 else tq
    ok = kb <= tb
    if window:
        ok &= tb - kb < window
    s = torch.where(ok[:, None, None, :], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgc,bckd->bkgd", (p / l).to(cache_v.dtype).float(),
                     cache_v.float())
    return o.reshape(B, H, D).to(q.dtype)


@pytest.mark.parametrize("window", [0, 6])
def test_kv_shards_none_is_the_replicated_path(window):
    B, H, K, D, C = 3, 4, 2, 32, 16
    rng = np.random.default_rng(window)
    q = torch.from_numpy(rng.standard_normal((B, H, D))).to(torch.bfloat16)
    ck, cv = (torch.from_numpy(rng.standard_normal((B, C, K, D)))
              .to(torch.bfloat16) for _ in range(2))
    t = torch.tensor([3, 15, 20], dtype=torch.int32)
    kpos = tattn.ring_positions(t, C)
    want = _replicated(q, ck, cv, kpos, t, scale=D ** -0.5, window=window)
    for kw in ({}, {"kv_shards": None}):
        got = tattn.decode_attend(q, ck, cv, kpos, t, window=window, **kw)
        assert torch.equal(got, want)
    # the kernel paths keep f32 probabilities: close, not equal
    for S in (1, 2, 4):
        got = tattn.decode_attend(q, ck, cv, kpos, t, window=window,
                                  kv_shards=S)
        np.testing.assert_allclose(got.float().numpy(),
                                   want.float().numpy(), rtol=0,
                                   atol=_ulps(want.float().numpy(), 2))


def test_engine_default_decode_is_unchanged(smoke_models):
    _, cfg, _, tp = smoke_models["llama3.2-1b"]
    eng = ServeEngine(cfg, tp, slots=2, capacity=24, device="cpu")
    assert eng.fns.kv_shards is None
    toks = torch.tensor([3, 7])
    t = torch.tensor([0, 5], dtype=torch.int32)
    c1 = TM.init_caches(cfg, 2, 24, device="cpu")
    c2 = TM.init_caches(cfg, 2, 24, device="cpu")
    a, _ = eng.fns.decode(eng.params, toks, c1, t)
    b, _ = TM.decode_step(cfg, eng.params, toks, c2, t)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch,capacity,kv_shards", [
    ("llama3.2-1b", 24, 5), ("llama3.2-1b", 24, 0), ("llama3.2-1b", 24, -2),
    ("llama3.2-1b", 24, 2.0), ("llama3.2-1b", 24, True),
    ("mixtral-8x22b", 48, 3),       # divides 48, not the 16-slot ring
    ("mixtral-8x22b", 12, 8)])      # ring min(12, 16) = 12
def test_kv_shards_that_do_not_divide_raise(smoke_models, arch, capacity,
                                            kv_shards):
    _, cfg, _, tp = smoke_models[arch]
    with pytest.raises(ValueError, match="kv_shards"):
        ServeEngine(cfg, tp, slots=2, capacity=capacity, device="cpu",
                    kv_shards=kv_shards)


def test_decode_paths_raise_on_a_capacity_shards_do_not_divide():
    B, H, K, D, C = 2, 4, 2, 32, 12
    q = torch.zeros((B, H, D), dtype=torch.bfloat16)
    ck = torch.zeros((B, C, K, D), dtype=torch.bfloat16)
    t = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_shards=5"):
        tattn.decode_attend(q, ck, ck, tattn.ring_positions(t, C), t,
                            kv_shards=5)
    bias = torch.zeros((B, C))
    with pytest.raises(ValueError, match="shards do not divide"):
        flash_decode_partial(q.reshape(B, K, 2, D), ck, ck, bias, shards=5)


def test_wrappers_raise_off_the_cpu_without_a_kernel():
    """A tensor on neither the CPU nor the card has no plain fallback."""
    q = torch.zeros((1, 2, 2, 32), device="meta")
    k = torch.zeros((1, 8, 2, 32), device="meta")
    bias = torch.zeros((1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_decode(q, k, k, bias)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_decode_partial(q, k, k, bias, shards=2)
    acc = torch.zeros((2, 1, 2, 2, 32), device="meta")
    m = torch.zeros((2, 1, 2, 2, 1), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        combine_partials(acc, m, m, torch.bfloat16)


def test_all_masked_capacity_flushes_the_reference_state():
    """flash_decode_partial_ref on an all-masked capacity: m = -1e30,
    l = C, acc = sum v (tests/test_tp.py:176); combined against a live
    shard it contributes exactly nothing."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 1, 2, 4)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 8, 1, 4)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 8, 1, 4)).astype(np.float32))
    bias = torch.tensor([[NEG] * 4 + [0.0] * 4])
    acc, m, l = flash_decode_partial(q, k, v, bias, shards=2)
    assert torch.equal(m[0], torch.full_like(m[0], NEG))
    assert torch.equal(l[0], torch.full_like(l[0], 4.0))
    torch.testing.assert_close(acc[0, 0, 0], v[0, :4, 0].sum(0).expand(2, 4))
    live = ref.flash_decode_partial_ref(q, k[:, 4:], v[:, 4:], bias[:, 4:])
    want = live[0] / live[2]
    torch.testing.assert_close(combine_partials(acc, m, l, torch.float32),
                               want, rtol=1e-6, atol=1e-7)
