"""repro_torch's mirror-descent search, piece by piece, against the JAX
reference on the smoke llama (the reference's own params carried across):
the prox, the metrics and score normalisation, the stats pass, the task
loss and gradient, the flash attention backward, the alignment term and
one search step from the same state.  The whole calibration is held
against the reference's in tests/test_torch_calibrate.py.

Tolerances, and why:

* prox and soft-threshold: exact against the reference run op by op
  (``jax.disable_jit``), as the port rounds every op.  Jitted, XLA's CPU
  backend contracts a multiply and an add into one fused multiply-add
  here and there, so against the jitted reference: atol 4 f32 units in the
  last place at the scale of max|w|.  Wanda/magnitude scores and the
  median: exact, jitted too (no multiply-add to contract).
* ria/stochria and mean normalisation: rtol 1e-6, atol 0 (f32 row/column
  sums and the mean reduce in another order).
* one batch's activation sums of squares: the bf16 matmul outputs that
  feed each projection differ from XLA's in the last place here and there
  (another accumulation order), and one such unit in a row that dominates
  a feature's sum moves its sum of squares by up to two units, more in the
  deeper layers, whose inputs carry the earlier layers' differences: rtol
  2**-6 (four bf16 units) per feature and 2**-9 in the per-leaf relative
  Frobenius norm (the reference's own criterion between its two stats
  passes, ``calibrate.stats_parity``, allows 5e-2).
* task gradient: per leaf, ||g - g_ref|| <= 1e-2 ||g_ref||.  The
  reference's own eager and jitted gradients differ by up to 1.04e-2 on
  this model and batch (bf16 roundings at other places), and both sit ~1%
  from an f32 computation; the port's differ from the jitted ones by
  0.4-0.6%.  Loss and nll: rtol 2e-4.  The smoke model's logits reach
  ~90, where one bf16 unit is 0.35, and the token losses carry those
  units (observed 7.5e-6 unmasked, 7.6e-5 with a loss mask).
* gradient accumulation over 2 microbatches against the whole batch:
  the task gradient's and the loss's tolerances above.
* flash attention backward: atol 2**-8 * max|ref| (one bf16 unit at the
  scale of the largest gradient), rtol 0; >99.6% of entries are equal.
* the alignment value and gradient: rtol 1e-5, and 1e-5 of each leaf's
  largest gradient (f32 chains, sums over rows and columns for ria).
* one search step from the same state: W' within 4 f32 units of max|W'|
  plus 1e-2 of the leaf's largest update (the task gradient's tolerance),
  V'/Gamma' within 1e-5 of the leaf's max|V'| (those W' differences move
  S(W') by a few 1e-6 of its scale, and V' takes v_lr of that; observed
  2.7e-6), the observables rtol 1e-5 (loss and nll 2e-4, as above).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import f64, jax_flat, leaf_pairs, smoke_llama, to_torch
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.core import calibrate as jcal
from repro.core import metrics as jmetrics
from repro.core import mirror as jmirror
from repro.core import prox as jprox
from repro.core.prunable import prunable_map as jprunable_map
from repro.models import attention as jattn
from repro.models import model as JM
from repro.optim.losses import lm_loss as jax_lm_loss
from repro_torch import tree
from repro_torch.configs.base import PruneConfig
from repro_torch.core import metrics as tmetrics
from repro_torch.core import mirror as tmirror
from repro_torch.core import prng
from repro_torch.core import prox as tprox
from repro_torch.core.prunable import prunable_map
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.optim.losses import lm_loss

PCFG = dict(local_metric="wanda", mode="nm", steps=30, stats_batches=4)
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def smoke():
    return smoke_llama()


# --- elementwise operators and metrics --------------------------------------

def _weights(seed, shape):
    rng = np.random.default_rng(seed)
    w = (0.2 * rng.standard_normal(shape)).astype(np.float32)
    w.reshape(-1)[::37] = 0.0
    w.reshape(-1)[1::41] = -0.0
    return w


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16)])
@pytest.mark.parametrize("lam", [1e-2, 0.7])
def test_prox_nm24_and_soft_threshold_equal_reference(shape, lam):
    w = _weights(len(shape), shape)
    got = tprox.prox_nm24(torch.from_numpy(w), lam)
    with jax.disable_jit():
        want = jprox.prox_nm24(jnp.asarray(w), lam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.signbit(got.numpy()),
                                  np.signbit(np.asarray(want)))
    jitted = jax.jit(partial(jprox.prox_nm24, lam=lam))(jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(jitted), rtol=0,
                               atol=4 * 2.0 ** -24 * np.abs(w).max())
    want = jax.jit(partial(jprox.soft_threshold, lam=lam / 10))(
        jnp.asarray(w))
    got = tprox.soft_threshold(torch.from_numpy(w), lam / 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # signed zeros as jnp.sign leaves them
    np.testing.assert_array_equal(np.signbit(got.numpy()),
                                  np.signbit(np.asarray(want)))


def test_prox_nm24_keeps_bf16_dtype():
    w = jnp.asarray(_weights(5, (32, 24))).astype(jnp.bfloat16)
    with jax.disable_jit():
        want = jprox.prox_nm24(w, 0.05)
    got = tprox.prox_nm24(to_torch(w), 0.05)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f64(got), f64(want.astype(jnp.float32)))


def _stats_for(seed, shape):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal(shape[:-1])).astype(np.float32) + 0.1


@pytest.mark.parametrize("name", ["magnitude", "wanda"])
@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16)])
def test_weight_and_wanda_scores_equal_reference(name, shape):
    w, a = _weights(1, shape), _stats_for(2, shape)
    want = jax.jit(jmetrics.get_metric(name))(jnp.asarray(w), jnp.asarray(a))
    got = tmetrics.get_metric(name)(torch.from_numpy(w), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(64, 48), (3, 32, 16)])
def test_ria_and_stochria_match_reference(shape):
    w, a = _weights(3, shape), _stats_for(4, shape)
    rng = np.random.default_rng(5)
    row_w = (rng.random(shape[-1:]) < 0.9).astype(np.float32)
    col_w = (rng.random(shape[-2:-1]) < 0.9).astype(np.float32)[:, None]
    jw, ja = jnp.asarray(w), jnp.asarray(a)
    tw, ta = torch.from_numpy(w), torch.from_numpy(a)
    np.testing.assert_allclose(
        tmetrics.ria(tw, ta).numpy(),
        np.asarray(jax.jit(jmetrics.ria)(jw, ja)), rtol=1e-6, atol=0)
    # stochria = ria over the same Bernoulli row/column weights
    want = jax.jit(jmetrics._ria_core)(jw, ja, jnp.asarray(row_w),
                                       jnp.asarray(col_w))
    got = tmetrics._ria_core(tw, ta, row_w=torch.from_numpy(row_w),
                             col_w=torch.from_numpy(col_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    # frac = 1 keeps every row and column: stochria is ria
    np.testing.assert_array_equal(
        tmetrics.stochria(tw, ta, key=prng.key(7), frac=1.0).numpy(),
        tmetrics.ria(tw, ta).numpy())


def test_stochria_draws_are_seeded_per_key_and_device_free():
    w = torch.from_numpy(_weights(6, (32, 40)))
    a = torch.from_numpy(_stats_for(7, (32, 40)))
    s1 = tmetrics.stochria(w, a, key=prng.key(11))
    assert torch.equal(s1, tmetrics.stochria(w, a, key=prng.key(11)))
    assert not torch.equal(s1, tmetrics.stochria(w, a, key=prng.key(12)))
    row_w, col_w = tmetrics.stoch_weights(prng.key(11), (32, 40), 0.9,
                                          "cpu")
    assert row_w.shape == (40,) and col_w.shape == (32, 1)
    assert 0.6 < float(row_w.mean()) < 1.0


@pytest.mark.parametrize("how", ["none", "mean", "median"])
@pytest.mark.parametrize("n", [4 * 96, 4 * 96 + 1])
def test_normalize_scores_matches_reference(how, n):
    s = np.abs(np.random.default_rng(n).standard_normal((n, 3))).astype(
        np.float32)
    want = jax.jit(partial(jmetrics.normalize_scores, how=how))(
        jnp.asarray(s))
    got = tmetrics.normalize_scores(torch.from_numpy(s), how)
    if how == "mean":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    flat = np.sort(s.reshape(-1))
    assert float(tmetrics.median_element(torch.from_numpy(s))) == \
        flat[flat.size // 2]


@pytest.mark.parametrize("name", ["magnitude", "wanda", "ria", "stochria"])
def test_metric_tree_matches_reference(smoke, name):
    jcfg, cfg, jp, tp, calib = smoke
    jstats = jcal.collect_stats(jcfg, jp, calib[:1])
    tstats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                           jax.device_get(jstats))
    # without a key stochria is ria on both sides
    want = jmetrics.metric_tree(name, jp, jstats, jprunable_map(jp),
                                norm="median")
    got = tmetrics.metric_tree(name, tp, tstats, prunable_map(tp),
                               norm="median")
    for path, jv, tv in leaf_pairs(want, got):
        np.testing.assert_allclose(f64(tv), f64(jv), rtol=1e-6, atol=0,
                                   err_msg=path)
    assert [p for p, v in tree.flatten_with_path(got) if v is not None] == \
        [p for p, v in jax_flat(want).items() if v is not None]


# --- stats, loss, gradients, attention backward -----------------------------

def test_stats_sumsq_matches_reference(smoke):
    jcfg, cfg, jp, tp, calib = smoke
    b = calib[0]
    want = jax.jit(lambda p, x: JM.stats_sumsq(jcfg, p, x))(
        jp, {"tokens": jnp.asarray(b["tokens"])})
    with torch.no_grad():
        got = TM.stats_sumsq(cfg, tp, {"tokens": torch.from_numpy(
            b["tokens"])})
    pairs = leaf_pairs(want, got)
    assert len(pairs) == 7
    for path, jv, tv in pairs:
        assert tuple(tv.shape) == tuple(jv.shape) == (4, jv.shape[1]), path
        j, t = f64(jv), f64(tv)
        np.testing.assert_allclose(t, j, rtol=4 * BF16_ULP, atol=0,
                                   err_msg=path)
        rel = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert rel <= 2.0 ** -9, (path, rel)


def test_lm_loss_and_task_gradient_match_reference(smoke):
    jcfg, cfg, jp, tp, calib = smoke
    b = calib[0]
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        partial(jax_lm_loss, jcfg), has_aux=True))(
            jp, {"tokens": jnp.asarray(b["tokens"])})
    W = tree.tree_map(lambda x: x.float().clone(), tp)
    (tl, tm), tg = tmirror._task_value_and_grad(
        PruneConfig(), partial(lm_loss, cfg), W,
        {"tokens": torch.from_numpy(b["tokens"])})
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-4)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=2e-4)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    pairs = leaf_pairs(jg, tg)
    assert len(pairs) == len(jax_flat(jp))
    for path, jv, tv in pairs:
        j, t = f64(jv), f64(tv)
        rel = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert rel <= 1e-2, (path, rel)
    # a masked batch weights tokens as the reference does
    mask = (np.arange(64)[None] % 3 != 0).astype(np.float32).repeat(4, 0)
    jl2, _ = jax.jit(partial(jax_lm_loss, jcfg))(
        jp, {"tokens": jnp.asarray(b["tokens"]), "mask": jnp.asarray(mask)})
    with torch.no_grad():
        tl2, _ = lm_loss(cfg, tp, {"tokens": torch.from_numpy(b["tokens"]),
                                   "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(tl2), float(jl2), rtol=2e-4)


def test_grad_accum_matches_full_batch(smoke):
    jcfg, cfg, jp, tp, calib = smoke
    W = tree.tree_map(lambda x: x.float().clone(), tp)
    b = {"tokens": torch.from_numpy(calib[0]["tokens"])}
    loss_fn = partial(lm_loss, cfg)
    (l1, m1), g1 = tmirror._task_value_and_grad(PruneConfig(), loss_fn, W, b)
    (l2, m2), g2 = tmirror._task_value_and_grad(PruneConfig(grad_accum=2),
                                                loss_fn, W, b)
    np.testing.assert_allclose(float(l2), float(l1), rtol=2e-4)
    np.testing.assert_allclose(float(m2["nll"]), float(m1["nll"]), rtol=2e-4)
    for (path, a), (_, c) in zip(tree.flatten_with_path(g1),
                                 tree.flatten_with_path(g2)):
        rel = float((c - a).norm() / a.norm())
        assert rel <= 1e-2, (path, rel)
    with pytest.raises(ValueError, match="grad_accum"):
        tmirror._task_value_and_grad(PruneConfig(grad_accum=3), loss_fn, W, b)


@pytest.mark.parametrize("sq,qb,kvb,window", [(64, 64, 64, 0),
                                              (128, 32, 32, 0),
                                              (128, 32, 64, 48)])
def test_flash_attention_backward_matches_reference(sq, qb, kvb, window):
    rng = np.random.default_rng(sq + qb + window)
    q, do = (jnp.asarray(rng.standard_normal((2, sq, 4, 32)), jnp.bfloat16)
             for _ in range(2))
    k, v = (jnp.asarray(rng.standard_normal((2, sq, 2, 32)), jnp.bfloat16)
            for _ in range(2))
    fwd = partial(jattn.flash_attention, window=window, q_block=qb,
                  kv_block=kvb)

    @jax.jit
    def vjp(q, k, v, do):
        out, f = jax.vjp(fwd, q, k, v)
        return (out, *f(do))

    want = vjp(q, k, v, do)
    tq, tk, tv = (to_torch(x).requires_grad_(True) for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, window=window, q_block=qb,
                                kv_block=kvb)
    out.backward(to_torch(do))
    for name, jx, tx in zip(("out", "dq", "dk", "dv"), want,
                            (out, tq.grad, tk.grad, tv.grad)):
        assert tx.dtype == torch.bfloat16, name
        j = f64(jx.astype(jnp.float32))
        np.testing.assert_allclose(f64(tx.float()), j, rtol=0,
                                   atol=BF16_ULP * np.abs(j).max(),
                                   err_msg=name)
    # under no_grad the serving forward runs, bit-identical
    with torch.no_grad():
        plain = tattn.flash_attention(tq, tk, tv, window=window, q_block=qb,
                                      kv_block=kvb)
    assert torch.equal(plain, out.detach())


# --- one search step from the same state ------------------------------------

def _state(jp, seed):
    """A mid-search state: W = params + noise, V random, Gamma = soft(V)."""
    rng = np.random.default_rng(seed)
    pr = jprunable_map(jp)
    W = jax.tree.map(lambda x: np.asarray(x, np.float32) + np.float32(1e-3) *
                     rng.standard_normal(x.shape).astype(np.float32), jp)
    V = jax.tree.map(lambda x, p: (np.float32(2e-3) * rng.standard_normal(
        x.shape)).astype(np.float32) if p else None, jp, pr)
    G = jax.tree.map(lambda v: None if v is None else np.asarray(
        jprox.soft_threshold(jnp.asarray(v), 1e-3)), V,
        is_leaf=lambda x: x is None)
    return W, G, V


def _jnp(t):
    return jax.tree.map(lambda x: None if x is None else jnp.asarray(x), t,
                        is_leaf=lambda x: x is None)


@pytest.mark.parametrize("metric", ["wanda", "ria"])
def test_align_value_and_grad_matches_reference(smoke, metric):
    jcfg, cfg, jp, tp, calib = smoke
    kw = dict(PCFG, local_metric=metric)
    jstats = jcal.collect_stats(jcfg, jp, calib[:1])
    tstats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                           jax.device_get(jstats))
    W, G, _ = _state(jp, 9)
    jval, jg = jax.jit(lambda w, g: jmirror._align_value_and_grad(
        JaxPruneConfig(**kw), w, g, jstats, jprunable_map(jp), None))(
            _jnp(W), _jnp(G))
    conv = lambda t: tree.tree_map(
        lambda x: None if x is None else torch.from_numpy(np.array(x)), t)
    tval, tg = tmirror._align_value_and_grad(
        PruneConfig(**kw), conv(W), conv(G), tstats, prunable_map(tp), 0)
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-5)
    for path, jv, tv in leaf_pairs(jg, tg):
        j = f64(jv)
        np.testing.assert_allclose(f64(tv), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max() + 1e-30,
                                   err_msg=path)


@pytest.mark.parametrize("metric,mode", [("wanda", "nm"),
                                         ("ria", "unstructured")])
def test_search_step_matches_reference(smoke, metric, mode):
    jcfg, cfg, jp, tp, calib = smoke
    kw = dict(PCFG, local_metric=metric, mode=mode)
    jpcfg, pcfg = JaxPruneConfig(**kw), PruneConfig(**kw)
    jstats = jcal.collect_stats(jcfg, jp, calib[:1])
    tstats = tree.tree_map(lambda a: None if a is None else to_torch(a),
                           jax.device_get(jstats))
    W, G, V = _state(jp, 3)
    jstate = jmirror.SearchState(W=_jnp(W), Gamma=_jnp(G), V=_jnp(V),
                                 step=jnp.int32(4), rng=jax.random.key(17))
    b = {"tokens": jnp.asarray(calib[1]["tokens"])}
    jnew, jm = jax.jit(lambda s, x: jmirror.search_step(
        jpcfg, partial(jax_lm_loss, jcfg), s, x, jstats,
        jprunable_map(jp)))(jstate, b)
    conv = lambda t: tree.tree_map(
        lambda x: None if x is None else torch.from_numpy(np.array(x)),
        jax.device_get(t))
    tstate = tmirror.SearchState(W=conv(W), Gamma=conv(G), V=conv(V),
                                 step=4, rng=17)
    tnew, tm = tmirror.search_step(
        pcfg, partial(lm_loss, cfg), tstate,
        {"tokens": torch.from_numpy(calib[1]["tokens"])}, tstats,
        prunable_map(tp))
    assert tnew.step == 5
    for path, jv, tv in leaf_pairs(jnew.W, tnew.W):
        j = f64(jv)
        update = np.abs(j - f64(jax_flat(W)[path])).max()
        np.testing.assert_allclose(
            f64(tv), j, rtol=0,
            atol=4 * 2.0 ** -24 * np.abs(j).max() + 1e-2 * update,
            err_msg=path)
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jnew, name),
                                   getattr(tnew, name)):
            j = f64(jv)
            np.testing.assert_allclose(
                f64(tv), j, rtol=0, atol=1e-5 * np.abs(f64(
                    jax_flat(jnew.V)[path])).max(), err_msg=name + path)
    assert set(tm) == set(jm)
    for k in jm:
        rtol = 2e-4 if k in ("loss", "nll") else 1e-5
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
