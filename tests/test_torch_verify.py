"""repro_torch ``verify_step`` (teacher-forced S-token decode, the verify
pass of speculative decoding) against the JAX reference's jitted
``verify_step``, on the smoke llama3.2-1b and on the smoke mixtral with
its pattern replaced by the global-attention ``moe`` kind (``moe_local``
has no verify path), each with the reference's own params; and the
deepseek MLA blocks' verify against their sequential decode (the model's
verify against the reference's: tests/test_torch_deepseek.py).

Start caches come from the reference's prefill, carried across, so both
sides verify from identical state; rows start at different positions.
Tolerance: logits and the written K/V caches within 4 bf16 ulps of the
largest value (ROADMAP R8), as tests/test_torch_model.py holds decode.
Column i of the port's verify must equal the port's own i-th sequential
``decode_step`` bit for bit: on the CPU each row's arithmetic does not
depend on how many rows a call holds.  For the ``moe`` kind that holds
only while expert capacity drops nothing: a verify pass routes B*S tokens
with the reference's capacity for B*S tokens, which may drop assignments
that B-token decode steps keep (the reference's own semantics), so the MoE
case verifies 2 rows x S <= 4 tokens, where capacity equals the token
count and no expert can overflow.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import blocks as tblk
from repro_torch.models import model as TM

B, C = 3, 32
PROMPT = 10
T0 = np.array([10, 7, 9], np.int32)     # per-row start positions
ULPS = 4


def _cfgs(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    if arch == "mixtral-8x22b":
        jcfg = dataclasses.replace(jcfg, pattern=("moe",),
                                   sliding_window=None)
        cfg = dataclasses.replace(cfg, pattern=("moe",), sliding_window=None)
    return jcfg, cfg


@pytest.fixture(scope="module", params=["llama3.2-1b", "mixtral-8x22b"])
def setup(request):
    jcfg, cfg = _cfgs(request.param)
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = TM.serving_params(jax_params_to_torch(jp))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(prompt)},
                       cache_capacity=C)
    jverify = jax.jit(lambda p, x, c, t: JM.verify_step(jcfg, p, x, c, t))
    return {"jcfg": jcfg, "cfg": cfg, "jp": jp, "tp": tp, "jc": jc,
            "jverify": jverify, "rng": rng}


def _torch_caches(jc):
    return jax_params_to_torch(jc)


def _assert_within_ulps(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    atol = ULPS * 2 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("S", [1, 3, 4])
def test_verify_step_matches_jitted_reference(setup, S):
    st = setup
    toks = st["rng"].integers(0, st["cfg"].vocab_size,
                              (B, S)).astype(np.int32)
    want, jc = st["jverify"](st["jp"], jnp.asarray(toks), st["jc"],
                             jnp.asarray(T0))
    tc = _torch_caches(st["jc"])
    got, tc2 = TM.verify_step(st["cfg"], st["tp"], torch.from_numpy(toks),
                              tc, torch.from_numpy(T0))
    assert tc2 is tc                       # written in place
    assert got.shape == (B, S, st["cfg"].vocab_size)
    assert got.dtype == torch.float32
    _assert_within_ulps(got, want, "logits")
    jflat = dict((jax.tree_util.keystr(kp), v) for kp, v in
                 jax.tree_util.tree_flatten_with_path(jc)[0])
    for path, leaf in tree.flatten_with_path(tc):
        _assert_within_ulps(leaf, jflat[path], path)


@pytest.mark.parametrize("S", [1, 3, 4])
def test_verify_columns_equal_sequential_decode(setup, S):
    st = setup
    rows = 2 if st["cfg"].num_experts else B     # MoE: see the docstring
    toks = st["rng"].integers(0, st["cfg"].vocab_size,
                              (rows, S)).astype(np.int32)
    t0 = torch.from_numpy(T0[:rows])

    def caches():
        return tree.tree_map(lambda a: a[:, :rows].clone(),
                             _torch_caches(st["jc"]))
    tc = caches()
    got, _ = TM.verify_step(st["cfg"], st["tp"], torch.from_numpy(toks), tc,
                            t0)
    dc = caches()
    for i in range(S):
        want, _ = TM.decode_step(st["cfg"], st["tp"],
                                 torch.from_numpy(toks[:, i]), dc, t0 + i)
        assert torch.equal(got[:, i], want), i
    # the same ring rows, written once by verify and one at a time by decode
    for (path, a), (_, b) in zip(tree.flatten_with_path(tc),
                                 tree.flatten_with_path(dc), strict=True):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("kind", ["local", "moe_local"])
def test_verify_refuses_kinds_without_a_verify_path(kind):
    cfg = get_smoke_config("llama3.2-1b")
    with pytest.raises(ValueError, match="verify path"):
        tblk.block_apply_verify(kind, cfg, {}, torch.zeros(1, 2, 8), {},
                                torch.zeros(1, dtype=torch.int32))


@pytest.fixture(scope="module")
def deepseek():
    """The smoke deepseek-v2-lite-16b's params (the port's init, seed 0)
    and each MLA kind's first layer."""
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    params = TM.serving_params(TM.init_params(cfg, 0, device="cpu"))
    return cfg, {kind: TM._layer(params["stages"][s], 0)["0"]
                 for s, ((kind,), _) in enumerate(TM.make_stages(cfg))}


@pytest.mark.parametrize("S", [3, 4])
@pytest.mark.parametrize("kind", ["mla_dense", "mla_moe"])
def test_mla_verify_equals_sequential_decode(deepseek, kind, S):
    """An MLA block's verify pass over S fed tokens per row against the
    same tokens through S one-token decode steps, from one prefilled
    latent ring: every output column and every ring row bit for bit (2
    rows: the mla_moe block routes 2 x S <= 8 tokens, where capacity
    equals the token count, as in the module docstring)."""
    cfg, layers = deepseek
    p, rows, P = layers[kind], 2, 9
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal(
        (rows, P + S, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.arange(P).expand(rows, P)
    _, _, ring = tblk.block_apply_full(
        kind, cfg, p, x[:, :P], tblk.Ctx(positions=pos, cache_capacity=C))
    t0 = torch.tensor([P, P - 2], dtype=torch.int32)
    vc = tree.tree_map(torch.clone, ring)
    got, _ = tblk.block_apply_verify(kind, cfg, p, x[:, P:], vc, t0)
    dc = tree.tree_map(torch.clone, ring)
    for i in range(S):
        want, _ = tblk.block_apply_decode(kind, cfg, p, x[:, P + i:P + i + 1],
                                          dc, t0 + i)
        assert torch.equal(got[:, i:i + 1], want), i
    for name in ("ckv", "krope"):
        assert torch.equal(vc[name], dc[name]), name
