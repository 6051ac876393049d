"""repro_torch's serve launcher against the JAX reference's, in one process:
``--temperature`` (``core.prng``'s narrower ``random_bits``, the f32, bf16
and f16 ``uniform`` and ``gumbel``, ``categorical``) and ``--sparse
[--save-artifact]``, the inline 2:4 calibration.

Tolerances, and why:

* ``random_bits`` of width 8, 16 and 32 and ``uniform`` in every float
  type: exact (integer arithmetic; compared by their bits).
* ``gumbel``: bf16 exact.  In f32 and f16 XLA's CPU log is a polynomial
  that is not correctly rounded where the port rounds each log once from
  f64, so a draw may differ from jax's by the inner log's last place
  carried through the outer one, 2 eps (1 + |g|) in f32 (observed: 23% of
  draws differ, at most 1.0 eps (1 + |g|)); in f16 (no path draws it)
  XLA's logs round through f32 another way, 4 eps (1 + |g|) (observed:
  6% differ, at most 2.73).
* ``--temperature`` streams on the committed trained llama-tiny at T 0.7
  and 1.0: teacher-forced along the reference's stream, every step's
  sample equal but for counted near-ties, where the reference's two
  candidates' gumbel + logits / T scores lie within twice the step's
  largest logit difference (R8: bf16 logits, ~1 unit at their scale)
  divided by T, plus the gumbel tolerance; the launcher's own
  free-running stream equal to the reference's on every row up to its
  first such tie.
* ``--sparse`` at smoke width: the reference's ``_calibrate_sparse`` and
  the port's on the reference's weights (both launchers' 30 steps cut to
  3: tests/test_torch_calibrate.py runs the same 30-step calibration),
  held at that file's calibration tolerances
  (``assert_calibration_matches``); the bank the port writes loads in the
  reference's ``MaskBank.load``.
"""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_calibration_matches, smoke_llama,
                         tiny_model)
from repro.data.synthetic import batches_for
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro_torch.core import prng
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.sparse.bank import MaskBank

SEEDS = (0, 100, 115, 2 ** 31 - 1)
FLOATS = ((jnp.float32, torch.float32, np.uint32),
          (jnp.bfloat16, torch.bfloat16, np.uint16),
          (jnp.float16, torch.float16, np.uint16))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test runs torch on one intra-op thread, and restores the count
    after: these tests run beside others in parallel worker processes,
    where every process's full thread pool would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a, utype):
    return np.asarray(a).view(utype)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_widths_and_uniform_match_jax(seed):
    jk, k = jax.random.key(seed), prng.key(seed)
    for width in (8, 16, 32):
        want = np.asarray(jax.random.bits(jk, (3, 700),
                                          jnp.dtype(f"uint{width}")))
        got = prng.random_bits(k, (3, 700), width=width).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
    for jdt, tdt, utype in FLOATS:
        for lo, hi in ((0.0, 1.0), (float(jnp.finfo(jdt).tiny), 1.0),
                       (-2.0, 3.0)):
            want = jax.random.uniform(jk, (2049,), jdt, minval=lo,
                                      maxval=hi)
            got = prng.uniform(k, (2049,), dtype=tdt, minval=lo, maxval=hi)
            np.testing.assert_array_equal(
                got.view({32: torch.int32, 16: torch.int16}[
                    torch.finfo(tdt).bits]).numpy().view(utype),
                _bits(want, utype), err_msg=f"{jdt} [{lo}, {hi})")


def _gumbel_tol(g: np.ndarray, dtype) -> np.ndarray:
    """k eps (1 + |g|), k = 2 in f32 and 4 in f16 (module docstring)."""
    k = 2 if dtype == np.float32 else 4
    return k * float(np.finfo(dtype).eps) * (1 + np.abs(g))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_and_categorical_match_jax(seed):
    jk, k = jax.random.key(seed), prng.key(seed)
    for jdt, tdt, utype in FLOATS:
        want = jax.random.gumbel(jk, (4, 4096), jdt)
        got = prng.gumbel(k, (4, 4096), dtype=tdt)
        if tdt == torch.bfloat16:
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(utype),
                _bits(want, utype))
            continue
        w = np.asarray(want.astype(jnp.float32), np.float64)
        g = got.double().numpy()
        np.testing.assert_array_less(np.abs(g - w),
                                     _gumbel_tol(w, np.float32 if utype is
                                                 np.uint32 else np.float16))
    # the sample: argmax of the gumbel draws plus the logits
    logits = np.random.default_rng(seed % 1000).standard_normal(
        (4, 512)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = prng.categorical(k, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.random.categorical(
        jk, jnp.asarray(logits).astype(jnp.bfloat16)))
    got = prng.categorical(k, torch.from_numpy(logits).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), want)


# --- --temperature ----------------------------------------------------------

def _reference_stream(jcfg, jp, toks, gen, T):
    """The reference launcher's loop (repro/launch/serve.py:276-299): the
    prefill's argmax, then ``categorical(key(100 + i), logits / T)``."""
    P = toks.shape[1]
    prefill = jax.jit(lambda p, b: JM.prefill(jcfg, p, b,
                                              cache_capacity=P + gen))
    decode = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    logits, caches = prefill(jp, {"tokens": jnp.asarray(toks)})
    tok = jnp.argmax(logits, axis=-1)
    out, steps = [np.asarray(tok)], []
    for i in range(gen - 1):
        logits, caches = decode(jp, tok, caches, jnp.asarray(P + i,
                                                             jnp.int32))
        tok = jax.random.categorical(jax.random.key(100 + i), logits / T)
        steps.append(np.asarray(logits))
        out.append(np.asarray(tok))
    return np.stack(out, axis=1), steps


@pytest.mark.parametrize("T, B, P, gen", [(0.7, 8, 32, 24), (1.0, 8, 32, 24),
                                         (1.0, 4, 16, 16)])
def test_temperature_streams_match_reference(T, B, P, gen):
    """The last case holds one counted near-tie (row 3, step 13: the
    reference's margin 0.025, under one bf16 unit of its logit 10.19)."""
    jcfg, cfg, jp, tp = tiny_model("llama-tiny")
    toks = batches_for(jcfg, n=1, batch=B, seq=P, split="valid")[0]["tokens"]
    want, jlogits = _reference_stream(jcfg, jp, toks, gen, T)
    params = TM.serving_params(tp)
    # teacher-forced along the reference's stream
    first_tie = np.full(B, gen)
    ties = 0
    with torch.inference_mode():
        logits, caches = TM.prefill(cfg, params,
                                    {"tokens": torch.from_numpy(toks)},
                                    cache_capacity=P + gen)
        assert np.array_equal(logits.argmax(-1).numpy(), want[:, 0])
        for i in range(gen - 1):
            logits, caches = TM.decode_step(
                cfg, params, torch.from_numpy(want[:, i]), caches, P + i)
            got = tserve._next_tokens(logits, T, i).numpy()
            for r in np.nonzero(got != want[:, i + 1])[0]:
                g = np.asarray(jax.random.gumbel(jax.random.key(100 + i),
                                                 jlogits[i].shape))
                score = g[r] + jlogits[i][r] / T
                a, b = want[r, i + 1], got[r]
                dl = float(np.abs(logits[r].numpy() - jlogits[i][r]).max())
                margin = float(score[a] - score[b])
                tol = 2 * dl / T + 4 * float(np.finfo(np.float32).eps) * (
                    1 + np.abs(score[[a, b]]).max())
                print(f"T {T} row {r} step {i}: near-tie, reference "
                      f"margin {margin:.4f} <= {tol:.4f}")
                assert 0 <= margin <= tol, (r, i, margin, tol)
                first_tie[r] = min(first_tie[r], i + 1)
                ties += 1
    assert ties <= 2
    # the launcher's own free-running loop
    stream, _, _ = tserve.generate(cfg, params, torch.from_numpy(toks), gen,
                                   temperature=T)
    stream = stream.numpy()
    for r in range(B):
        np.testing.assert_array_equal(stream[r, :first_tie[r]],
                                      want[r, :first_tie[r]])
    assert len({tuple(x) for x in want[:, 1:].tolist()}) > 1
    print(f"T {T}: {B} x {gen} tokens, {ties} near-ties")


# --- --sparse [--save-artifact] --------------------------------------------

SPARSE_STEPS = 3


@pytest.fixture
def few_steps(monkeypatch):
    """Both launchers' ``_calibrate_sparse`` with their 30 search steps cut
    to ``SPARSE_STEPS`` (its ``PruneConfig`` otherwise as written): what
    is under test is the launcher's path (calibration batches, config,
    bank, masks); tests/test_torch_calibrate.py holds the 30-step
    calibration of this same configuration against the reference's."""
    import repro_torch.configs.base as tbase
    from repro.configs.base import PruneConfig as JaxPruneConfig
    monkeypatch.setattr(jserve, "PruneConfig", lambda **kw: JaxPruneConfig(
        **{**kw, "steps": SPARSE_STEPS}))
    real = tbase.PruneConfig
    monkeypatch.setattr(tbase, "PruneConfig", lambda **kw: real(
        **{**kw, "steps": SPARSE_STEPS}))


def test_sparse_bank_matches_reference_calibrate_sparse(tmp_path, few_steps):
    jcfg, cfg, jp, tp, _ = smoke_llama()
    # the launchers' default prompt length: the calibration batches are
    # 8 x 4 x 64 tokens, as in tests/test_torch_calibrate.py
    args = dict(prompt_len=64, arch="llama3.2-1b", smoke=True)
    jserve._calibrate_sparse(jcfg, argparse.Namespace(
        save_artifact=str(tmp_path / "jax"), **args), jp)
    masked = tserve._calibrate_sparse(cfg, argparse.Namespace(
        save_artifact=str(tmp_path / "torch"), **args), tp)
    jbank = JaxMaskBank.load(tmp_path / "jax")
    from_t = JaxMaskBank.load(tmp_path / "torch")
    tbank = MaskBank.load(tmp_path / "torch", device="cpu")
    assert from_t.meta["checksum"] == tbank.meta["checksum"]
    assert from_t.meta["pcfg"] == jbank.meta["pcfg"]
    assert from_t.meta["pcfg"]["local_metric"] == "wanda"
    assert from_t.meta["steps_run"] == SPARSE_STEPS
    assert_calibration_matches(jbank, tbank)
    # what it serves: W0 * the bank's 2:4 masks
    from repro_torch import tree
    masks = dict(tree.flatten_with_path(tbank.masks_at()))
    for path, w in tree.flatten_with_path(masked):
        w0 = dict(tree.flatten_with_path(tp))[path]
        m = masks[path]
        assert torch.equal(w, w0 if m is None else w0 * m), path


def test_launcher_sparse_save_artifact_and_temperature(tmp_path, capsys,
                                                       few_steps):
    out = tmp_path / "bank"
    tserve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                 "--prompt-len", "16", "--gen", "5", "--sparse",
                 "--save-artifact", str(out), "--temperature", "0.8",
                 "--device", "cpu"])
    text = capsys.readouterr().out
    assert f"saved mask bank -> {out}" in text
    assert "masked-dense, bank-backed" in text and "sample continuation" in text
    bank = JaxMaskBank.load(out)
    assert bank.meta["pcfg"]["mode"] == "nm"
    assert bank.meta["steps_run"] == SPARSE_STEPS
    assert bank.meta["stats_impl"] == "jit"
