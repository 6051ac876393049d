"""repro_torch llama forward, prefill and decode against the JAX reference
on the smoke config, with the reference's own params (``init_params(cfg,
jax.random.key(0))``, carried across by ``convert.params_from_numpy``).

Logit tolerance: both sides round every activation and the logits
themselves to bf16, in different places and summation orders, so a logit
may differ by a few units in the last place of bf16 at the scale of the
largest logit: atol = 4 * 2**-8 * max|logit| (about 1.4 on these ~90-sized
logits, against differences of tens for any real fault), rtol = 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_params_to_torch
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.core import masks as jmasks
from repro.models import model as JM
from repro.sparse import apply as japply
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import masks as tmasks
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.sparse import apply as tapply

B, P, C, STEPS = 2, 12, 24, 4


def assert_logits_close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    atol = 4 * 2 ** -8 * float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_smoke_config("llama3.2-1b")
    cfg = get_smoke_config("llama3.2-1b")
    jp = JM.init_params(jcfg, jax.random.key(0))
    tp = jax_params_to_torch(jp)
    jm = jcal.baseline_masks("magnitude", jp, jax.tree.map(lambda _: None, jp),
                             0.5, mode="nm")
    tm = tcal.baseline_masks("magnitude", tp,
                             tree.tree_map(lambda _: None, tp), 0.5,
                             mode="nm")
    return {
        "cfg": (jcfg, cfg),
        "dense": (jp, tp),
        "nm24": (japply.sparsify_params(jp, jm, axes=JM.param_axes(jcfg),
                                        idx_bits=2, dtype=jnp.bfloat16),
                 tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                        idx_bits=2, dtype=torch.bfloat16)),
        "masked": (jmasks.apply_masks(jp, jm), tmasks.apply_masks(tp, tm)),
    }


def _tokens():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 512, (B, P)).astype(np.int32),
            rng.integers(0, 512, (STEPS, B)).astype(np.int32))


def _run_torch(cfg, params):
    toks, feed = _tokens()
    logits, caches = TM.prefill(cfg, params,
                                {"tokens": torch.from_numpy(toks)},
                                cache_capacity=C)
    out = [logits]
    for i in range(STEPS):
        t = torch.full((B,), P + i, dtype=torch.int32)
        logits, caches = TM.decode_step(cfg, params,
                                        torch.from_numpy(feed[i]), caches, t)
        out.append(logits)
    return out


def _run_jax(cfg, params):
    toks, feed = _tokens()
    logits, caches = JM.prefill(cfg, params, {"tokens": jnp.asarray(toks)},
                                cache_capacity=C)
    out = [logits]
    for i in range(STEPS):
        t = jnp.full((B,), P + i, jnp.int32)
        logits, caches = JM.decode_step(cfg, params, jnp.asarray(feed[i]),
                                        caches, t)
        out.append(logits)
    return out


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_prefill_and_teacher_forced_decode_match_reference(models, weights):
    jcfg, cfg = models["cfg"]
    jp, tp = models[weights]
    for got, want in zip(_run_torch(cfg, tp), _run_jax(jcfg, jp),
                         strict=True):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert_logits_close(got, want)


def test_forward_logits_match_reference(models):
    jcfg, cfg = models["cfg"]
    jp, tp = models["dense"]
    toks, _ = _tokens()
    want, _, _ = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    got, _, caches = TM.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (B, P, cfg.vocab_size) and caches == [None]
    assert_logits_close(got, want)


def test_compressed_serving_equals_masked_dense(models):
    """The port's analogue of tokens_match_masked_dense: on the CPU the
    compressed path multiplies by the same bf16 matrix as masked-dense, so
    the logits are identical, not merely close."""
    _, cfg = models["cfg"]
    for a, b in zip(_run_torch(cfg, models["nm24"][1]),
                    _run_torch(cfg, models["masked"][1]), strict=True):
        assert torch.equal(a, b)


def test_prefill_caches_match_reference(models):
    jcfg, cfg = models["cfg"]
    jp, tp = models["dense"]
    toks, _ = _tokens()
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       cache_capacity=C)
    _, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                       cache_capacity=C)
    for path, got in tree.flatten_with_path(tc):
        want = np.asarray(
            dict((jax.tree_util.keystr(kp), v) for kp, v in
                 jax.tree_util.tree_flatten_with_path(jc)[0])[path],
            np.float32)
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        # bf16 K/V of bf16 activations that carry the layers above them:
        # the module's 4-ulps-of-the-max bound
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=4 * 2 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("t", [0, 5, 7, 8, 23, -3])
def test_ring_positions_match_reference(t):
    from repro.models import attention as jattn
    C_ = 8
    want = np.asarray(jattn.ring_positions(jnp.asarray([t, t + 1]), C_))
    got = tattn.ring_positions(torch.tensor([t, t + 1]), C_)
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_attention_matches_reference_multi_block():
    """Several query and kv blocks, so the online-softmax rescaling and the
    causal block bound both run (bf16 inputs; f32 accumulation; output
    rounded to bf16 once: 2 ulps)."""
    from repro.models import attention as jattn
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    want = np.asarray(jattn.flash_attention(jb(q), jb(k), jb(v), q_block=8,
                                            kv_block=8), np.float32)
    got = tattn.flash_attention(tb(q), tb(k), tb(v), q_block=8, kv_block=8)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2 ** -8 * np.abs(want).max())
