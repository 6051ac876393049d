"""Tensor-parallel serving over gloo ranks on the CPU: tests/test_tp.py's
end-to-end cases (``tests/test_tp.py:237-340``) on the port, held against
the reference's replicated single-device ``ServeEngine`` in this process.

One spawn of 4 ranks (``repro_torch.dist.ranks.run_ranks``, a ``file://``
store; each rank runs ``_torch_tp_ranks.rank_main``, which imports no jax)
serves every case and returns what the tests below hold:

* smoke llama3.2-1b 2:4 (packed2) on meshes (1, 4) and (2, 2) and under
  ``REPRO_FORCE_REPLICATED`` on (1, 4), and mixtral-8x22b on (1, 4) and
  (2, 2): greedy streams equal to the reference engine's (its params
  carried across from the port's) and to the port's replicated engine's,
  on every rank; llama's prefill and first decode logits within 4 bf16
  ulps of the largest logit of the replicated port's (the K-partial sums
  across ranks are another summation order);
* d_ff=72: the down kernel cannot shard K over 4 (loud warning), and the
  streams still equal the reference's;
* ``dist.psum`` per decode trace on (2, 2) == tests/test_tp.py's {mlp 2,
  attn 4, attn_kv 2, moe 0}, and a second decode adds 0;
* each rank holds only its block: the bytes its parameter storages hold ==
  the bytes of its views == the spec derivation's block bytes;
* each K-sharded wrapper and ``decode_attend_sharded`` across ranks
  against the plain single-process result (tolerances at the tests);
* a 0.0 / 2:4 ``SparsityFleet`` under rules == the one without.

The reference's own multi-device engine does not run on jax 0.9 (ROADMAP
R1, R13, R15): the gate is its replicated engine's tokens, as ROADMAP
set.  Spawned ranks take torch's CPU ops on one thread each.
"""
import numpy as np
import pytest
import torch

import _torch_tp_ranks as R
from _torch_port import one_torch_thread, to_jax  # noqa: F401
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_smoke_config
from repro_torch.dist import ranks
from repro_torch.dist.axes import make_rules
from repro_torch.kernels import ref
from repro_torch.kernels.nm_spmm import (nm_matmul_expert_plain,
                                         nm_matmul_plain)
from repro_torch.launch.mesh import Mesh
from repro_torch.serve.engine import EngineFns, ServeEngine

WORLD = 4


@pytest.fixture(scope="module")
def ranked():
    """Every rank's results of ``rank_main`` (one spawn for the module)."""
    return ranks.run_ranks(R.rank_main, WORLD, timeout=120.0, deadline=600.0)


def _jax_streams(arch, cfg, sp, ps):
    """The reference's replicated single-device engine on the port's
    params, carried across (tests/test_tp.py's ``serve`` with rules=None)."""
    import dataclasses
    jcfg = jax_smoke_config(arch)
    if cfg.d_ff != jcfg.d_ff:
        jcfg = dataclasses.replace(jcfg, d_ff=cfg.d_ff)
    eng = JaxServeEngine(jcfg, to_jax(sp), slots=R.SLOTS,
                         capacity=R.CAPACITY)
    rids = [eng.submit(p, R.GEN) for p in ps]
    out = eng.run()
    return [[int(t) for t in out[r]] for r in rids]


@pytest.fixture(scope="module")
def replicated():
    """{case: (the reference's streams, the port's replicated streams)}
    and the port's replicated logits."""
    out = {}
    for arch, d_ff, case in (("llama3.2-1b", None, "llama"),
                             ("llama3.2-1b", 72, "dff72"),
                             ("mixtral-8x22b", None, "mixtral")):
        cfg, sp = R.sparse_smoke(arch, d_ff)
        ps = R.prompts(arch, cfg.vocab_size)[:1 if d_ff else 2]
        out[case] = (_jax_streams(arch, cfg, sp, ps),
                     R.serve(cfg, sp, None, ps))
        if case == "llama":
            out["llama logits"] = R.logits_probe(cfg, sp, None, ps)
    return out


def _every_rank(ranked, key):
    vals = [r[key] for r in ranked]
    for v in vals[1:]:
        assert v == vals[0], key
    return vals[0]


@pytest.mark.parametrize("case", [(1, 4), (2, 2), "forced"])
def test_llama_streams_match_reference(ranked, replicated, case):
    want, port = replicated["llama"]
    assert port == want
    assert _every_rank(ranked, ("llama", case)) == want


@pytest.mark.parametrize("shape", R.SHAPES)
def test_llama_logits_within_4_ulps(ranked, replicated, shape):
    """Prefill and first decode logits of every rank against the
    replicated port's: bit-identical across ranks (every all-reduce gives
    every rank the same bits), within 4 bf16 ulps of the largest logit
    of the replicated run."""
    want = replicated["llama logits"]
    for which in ("prefill", "decode"):
        got = [r["llama logits", shape][which] for r in ranked]
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])
        w = want[which]
        ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
        assert np.abs(got[0] - w).max() <= 4 * ulp, (which, shape)


def test_dff72_is_loud_and_still_equal(ranked, replicated):
    want, port = replicated["dff72"]
    assert port == want
    assert _every_rank(ranked, "dff72") == want
    for r in ranked:
        msgs = r["dff72 warnings"]
        assert any("cannot shard over mesh axis" in m
                   and "['mlp']['down']['kernel']" in m for m in msgs), msgs


def test_psum_counts_per_decode_trace(ranked):
    first, second, payload = _every_rank(ranked, "psum")
    assert first == {"mlp": 2, "attn": 4, "attn_kv": 2, "moe": 0}
    assert second == {"mlp": 0, "attn": 0, "attn_kv": 0, "moe": 0}
    # tests/test_tp.py's formula: the pair (M 2 x N_loc 128) + down
    # (2 x 64) in f32, once each, per rank
    assert payload == (2 * 2 * 128 + 2 * 64) * 4


@pytest.mark.parametrize("shape", R.SHAPES)
def test_mixtral_streams_match_reference(ranked, replicated, shape):
    want, port = replicated["mixtral"]
    assert port == want
    assert _every_rank(ranked, ("mixtral", shape)) == want
    tag, vals_shape = _every_rank(ranked, ("mixtral down", shape))
    assert tag[0] == "moe" and tag[2] == "model", tag
    # (layers, E, K/2 / model, N / data): the rank's block of the bank
    assert vals_shape == (4, 4, 256 // 2 // 4, 128) if shape == (1, 4) \
        else vals_shape == (4, 4, 256 // 2 // 2, 128 // 2)


def test_dense_mixtral_under_rules_equals_replicated(ranked):
    """Unpruned smoke mixtral on (2, 2): every kernel, expert bank, the
    router, the table and lm_head held as blocks (``DenseBlock``), the
    streams of the port's replicated engine."""
    cfg = get_smoke_config("mixtral-8x22b")
    from repro_torch.models import model as M
    want = R.serve(cfg, M.init_params(cfg, 0, device="cpu"), None,
                   R.prompts("mixtral", cfg.vocab_size))
    assert _every_rank(ranked, "mixtral dense") == want


@pytest.mark.parametrize("shape", R.SHAPES)
def test_each_rank_holds_only_its_block(ranked, shape):
    for r in ranked:
        held, viewed, planned = r["bytes", shape]
        assert held == viewed == planned, (shape, held, viewed, planned)
    # the 4 ranks hold less than 4 whole copies, and the ring is split
    cap = R.CAPACITY // shape[1]
    assert _every_rank(ranked, ("cache", shape))[2] == cap


def _plain_inputs():
    x2, x3, mats, banks, att = R.wrapper_inputs()
    return x2, x3, mats, banks, att


def _bf16_close(got, want, what):
    """Within one bf16 ulp of each element (plus 1e-6): the f32 partials
    sum across ranks in another order, which may round to a neighbour."""
    want = want.float()
    tol = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool((torch.from_numpy(got) - want).abs().le(tol + 1e-6).all()), \
        what


def test_k_sharded_wrappers_match_plain(ranked):
    """nm_dense_sharded / nm_dense2_sharded (K over "data", N over
    "model": one all-reduce then a gather), nm_moe_sharded (K over
    "model", N over "data") and nm_moe2_sharded on (2, 2), against the
    plain f32 product of the whole operands cast to bf16."""
    x2, x3, mats, banks, _ = _plain_inputs()
    got = ranked[0]["wrappers"]
    for r in ranked[1:]:
        for k in ("dense", "moe"):
            np.testing.assert_array_equal(r["wrappers"][k], got[k])
    assert got["tags_2d"] == ("mlp", "data", "model")
    assert got["tags_bank"] == ("moe", None, "model", "data")

    def plain(st, x, expert=False):
        fn = nm_matmul_expert_plain if expert else nm_matmul_plain
        return fn(x, st.vals, st.idx, out_dtype=torch.float32).to(x.dtype)

    _bf16_close(got["dense"], plain(mats[0], x2), "dense")
    for g, st in zip(got["pair"], mats):
        _bf16_close(g, plain(st, x2), "pair")
    _bf16_close(got["moe"], plain(banks[0], x3, True), "moe")
    for g, st in zip(got["moe2"], banks):
        _bf16_close(g, plain(st, x3, True), "moe2")


@pytest.mark.parametrize("exact", [True, False])
def test_decode_attend_across_ranks_matches_plain(ranked, exact):
    """The capacity-sharded attention over "model" (2 ranks a group) on
    (2, 2): the exact mimic against the replicated plain attention of
    ``models.attention.decode_attend`` (its ``p / l`` rounding), the flash
    partial + combine against ``kernels.ref.flash_decode_ref``; both
    within one bf16 ulp of each element, every rank the same bits."""
    from repro_torch.models.attention import decode_attend
    *_, (q, ck, cv, ok) = _plain_inputs()
    key = f"attend_exact={exact}"
    got = ranked[0]["wrappers"][key]
    for r in ranked[1:]:
        np.testing.assert_array_equal(r["wrappers"][key], got)
    if exact:
        kpos = torch.arange(32).expand(2, 32)
        t = torch.tensor([4, 28])
        want = decode_attend(q.reshape(2, 4, 16), ck, cv, kpos, t,
                             scale=16 ** -0.5).reshape(q.shape)
    else:
        bias = torch.where(ok, 0.0, -1e30).float()
        want = ref.flash_decode_ref(q, ck, cv, bias,
                                    scale=16 ** -0.5).to(q.dtype)
    _bf16_close(got, want, key)


def test_fleet_under_rules_equals_replicated_fleet(ranked):
    want = R.fleet_streams(None)
    assert _every_rank(ranked, "fleet") == want


# ---------------------------------------------------------------------------
# Refusals and the launcher (no ranks, or two)
# ---------------------------------------------------------------------------

def test_kv_shards_with_rules_and_unported_families_raise():
    rules = make_rules(Mesh((1, 1), ("data", "model")))
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(ValueError, match="kv_shards=4 with rules"):
        EngineFns(cfg, 32, torch.device("cpu"), kv_shards=4, rules=rules)
    for arch in ("gemma3-1b", "yi-6b", "deepseek-v2-lite-16b", "zamba2-7b",
                 "xlstm-125m", "gemma2-2b", "pixtral-12b"):
        with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
            EngineFns(get_smoke_config(arch), 32, torch.device("cpu"),
                      rules=rules)
    # a shared EngineFns carries its rules: another rules object is refused
    fns = EngineFns(cfg, 32, torch.device("cpu"), rules=rules)
    with pytest.raises(ValueError, match="cfg or rules"):
        ServeEngine(cfg, R.sparse_smoke("llama3.2-1b")[1], slots=2,
                    capacity=32, device="cpu", fns=fns,
                    rules=make_rules(Mesh((1, 1), ("data", "model"))))


def test_spec_verify_over_a_sharded_ring_is_refused():
    from repro_torch.kernels import shard as ksh
    from repro_torch.models import attention as attn
    cfg = get_smoke_config("llama3.2-1b")
    rules = make_rules(Mesh((1, 4), ("data", "model"), rank=1))
    x = torch.zeros(2, 3, cfg.d_model, dtype=torch.bfloat16)
    cache = {"k": torch.zeros(2, 8, 2, 32, dtype=torch.bfloat16),
             "v": torch.zeros(2, 8, 2, 32, dtype=torch.bfloat16)}
    from repro_torch.dist.axes import use_rules
    with use_rules(rules), ksh.serving_capacity(32):
        assert ksh.ring_layout(2, 8) == (("model",), 32, 8)
        with pytest.raises(NotImplementedError, match="ROADMAP A item 3"):
            attn.attn_apply_verify({}, x, cache, torch.zeros(2), num_heads=4,
                                   num_kv=2, head_dim=32)
    with use_rules(rules), pytest.raises(RuntimeError, match="capacity"):
        ksh.ring_layout(2, 8)


def test_pick_backend():
    assert ranks.pick_backend("cpu", 4, None) == "gloo"
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        ranks.pick_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="one rank a card"):
        ranks.pick_backend("cuda", torch.cuda.device_count() + 1, None)
    assert ranks.pick_backend("cuda", 4, "gloo") == "gloo"


def test_a_failing_rank_fails_the_run():
    with pytest.raises(ranks.RankError, match="rank 1 gives up"):
        ranks.run_ranks(R.failing, 2, timeout=30.0, deadline=120.0)
