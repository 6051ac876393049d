"""repro_torch's evaluation side of the paper against the JAX reference's,
in one process: ``optim.losses.eval_ppl`` on the committed trained tiny
models (dense, under the committed unstructured banks, 2:4-compressed),
``core.masks.sparsity_of``, the Eq. 8 / Table 5 ablation
``core.mirror.no_mirror_step``, and the unstructured mask storage
(``sparse.formats.BitMask``, ``sparse.pack.pack_mask_tree``).

Tolerances, and why:

* ``eval_ppl``: rtol 2e-3.  Each side rounds every activation and the
  logits to bf16 in its own summation order; the per-batch mean NLL then
  differs by ~1e-4 of itself (observed ppl 2.8e-4 on moe-tiny, 3.7e-4 on
  llama-tiny).  Masks, their ``sparsity_of`` and BitMask bytes: exact.
* 2:4-compressed against masked-dense on the port: rtol 1e-3 (the plain
  2:4 matmul sums the kept products in f32 where the dense bf16 matmul
  sums all four; observed ~1e-5).
* ``no_mirror_step``, 5 steps of Table 5's ablation (stochria, rho 1e-5,
  l2 0.01; wanda and ria for 2 steps): the objective at rtol 2e-3 (the
  task loss's bf16 units; observed 1.5e-5); the weights' total update
  W - W0 within 2e-2 of its largest entry per leaf plus two units in the
  last place of W itself.  The update is ~1e-6, ~100 f32 units of the
  weights, so each side's rounding of W - kappa*alpha*g to f32 alone moves
  it ~1e-2 of itself; the gradients' own bf16 error is below that.  The
  raw-S masks at 0.5 / 0.6 (global threshold): equal but for entries the
  reference scored within twice the largest |S_port - S_ref| of its own
  threshold, each counted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (f64, jax_flat, leaf_pairs, tiny_bank, tiny_model,
                         to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.core import masks as jmasks
from repro.core import metrics as jmetrics
from repro.core.mirror import no_mirror_step as jax_no_mirror_step
from repro.core.prunable import prunable_map as jprunable_map
from repro.data.synthetic import batches_for
from repro.optim import losses as jlosses
from repro.sparse import formats as jformats
from repro.sparse import pack as jpack
from repro_torch import tree
from repro_torch.configs.base import PruneConfig
from repro_torch.core import masks as tmasks
from repro_torch.core import metrics as tmetrics
from repro_torch.core import prng
from repro_torch.core.mirror import no_mirror_step
from repro_torch.core.prunable import prunable_map
from repro_torch.optim import losses as tlosses
from repro_torch.sparse import (BitMask, SparseTensor, pack_mask_tree,
                                sparse_leaves, unpack_mask_tree)

PPL_RTOL = 2e-3
SPARSITIES = (0.5, 0.6)


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


@pytest.fixture(scope="module", params=["llama-tiny", "moe-tiny"])
def tiny(request):
    name = request.param
    jcfg, cfg, jp, tp = tiny_model(name)
    # benchmarks/common.py evaluate()'s held-out batches
    valid = batches_for(jcfg, n=3, batch=12, seq=128, split="valid")
    return (name, jcfg, cfg, jp, tp, valid) + tiny_bank(name)


def test_eval_ppl_dense_and_under_committed_banks(tiny):
    name, jcfg, cfg, jp, tp, valid, jbank, tbank = tiny
    want = jlosses.eval_ppl(jcfg, jp, valid)
    got = tlosses.eval_ppl(cfg, tp, valid)
    print(f"{name} dense ppl: jax {want:.6f}, torch {got:.6f}")
    np.testing.assert_allclose(got, want, rtol=PPL_RTOL)
    for s in SPARSITIES:
        jm, tm = jbank.masks_at(sparsity=s), tbank.masks_at(sparsity=s)
        for path, jv, tv in leaf_pairs(jm, tm):
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=path)
        sp = tmasks.sparsity_of(tm)
        assert sp == jmasks.sparsity_of(jm)
        assert abs(sp - s) < 1e-6, sp
        want = jlosses.eval_ppl(jcfg, jmasks.apply_masks(jp, jm), valid)
        got = tlosses.eval_ppl(cfg, tmasks.apply_masks(tp, tm), valid)
        print(f"{name} ppl at {s}: jax {want:.6f}, torch {got:.6f}")
        np.testing.assert_allclose(got, want, rtol=PPL_RTOL)


def test_eval_ppl_is_one_read_of_the_device_sum(tiny):
    """eval_ppl == exp(token-weighted mean of a plain per-batch loop's
    NLL), and eval_nll hands back a device scalar (nothing read)."""
    name, jcfg, cfg, jp, tp, valid, _, _ = tiny
    valid = valid[:2]
    tot, n = tlosses.eval_nll(cfg, tp, [
        {k: torch.as_tensor(v) for k, v in b.items()} for b in valid])
    assert isinstance(tot, torch.Tensor) and tot.dim() == 0
    assert n == sum(b["tokens"][:, 1:].size for b in valid)
    plain = [float(tlosses.lm_loss(cfg, tp, b)[1]["nll"]) for b in valid]
    sizes = [b["tokens"][:, 1:].size for b in valid]
    want = np.exp(sum(x * m for x, m in zip(plain, sizes)) / sum(sizes))
    np.testing.assert_allclose(tlosses.eval_ppl(cfg, tp, valid), want,
                               rtol=1e-6)


def test_eval_ppl_of_compressed_24_weights(tiny):
    """The 2:4 masks of the committed bank, served compressed
    (``nm_matmul`` / ``nm_matmul_expert``'s plain versions here) and
    masked-dense, against the reference's masked-dense ppl."""
    name, jcfg, cfg, jp, tp, valid, jbank, tbank = tiny
    comp = tbank.sparse_params(tp, nm=(2, 4), compressed=True)
    masked = tbank.sparse_params(tp, nm=(2, 4), compressed=False)
    assert sparse_leaves(comp) and not sparse_leaves(masked)
    assert all(isinstance(x, SparseTensor) for x in sparse_leaves(comp))
    got = tlosses.eval_ppl(cfg, comp, valid)
    dense = tlosses.eval_ppl(cfg, masked, valid)
    want = jlosses.eval_ppl(jcfg, jbank.sparse_params(
        jp, nm=(2, 4), compressed=False), valid)
    print(f"{name} 2:4 ppl: compressed {got:.6f}, masked-dense {dense:.6f}, "
          f"jax masked-dense {want:.6f}")
    np.testing.assert_allclose(got, dense, rtol=1e-3)
    np.testing.assert_allclose(dense, want, rtol=PPL_RTOL)


# --- the Eq. 8 / Table 5 ablation ------------------------------------------

ABLATION = dict(rho=1e-5, l2=0.01, steps=5, seed=11)


def _raw_score_ties(jS, tS, sparsity):
    """(reference masks, port masks, entries that differ, the tolerance)
    of the global unstructured masks of raw scores."""
    jm = jmasks.unstructured_masks(jS, sparsity, scope="global")
    tm = tmasks.unstructured_masks(tS, sparsity, scope="global")
    err = max(float(np.abs(f64(tv) - f64(jv)).max())
              for _, jv, tv in leaf_pairs(jS, tS))
    return jm, tm, err


@pytest.mark.parametrize("metric", ["stochria", "wanda", "ria"])
def test_no_mirror_step_matches_reference(metric):
    """Table 5's ablation loop (benchmarks/table5_mirror_ablation.py
    no_mirror_prune) on llama-tiny and the committed bank's stats, 5 steps
    on each package from the same weights; stochria is the table's."""
    jcfg, cfg, jp, tp = tiny_model("llama-tiny")
    jbank, tbank = tiny_bank("llama-tiny")
    calib = batches_for(jcfg, n=10, batch=8, seq=128, split="calib")
    steps = ABLATION["steps"] if metric == "stochria" else 2
    jpcfg = JaxPruneConfig(local_metric=metric, rho=ABLATION["rho"],
                           steps=steps)
    pcfg = PruneConfig(local_metric=metric, rho=ABLATION["rho"], steps=steps)
    from repro.optim.losses import lm_loss as jlm_loss
    jpr = jprunable_map(jp)
    jrng = jax.random.key(ABLATION["seed"])
    jstep = jax.jit(lambda W, b, s: jax_no_mirror_step(
        jpcfg, lambda p, bb: jlm_loss(jcfg, p, bb), W, b, jbank.stats, jpr,
        jrng, s, l2=ABLATION["l2"]))
    jW = jax.tree.map(lambda x: x.astype(jnp.float32), jp)
    W = tree.tree_map(lambda x: x.float().clone(), tp)
    pr = prunable_map(tp)
    rng = prng.key(ABLATION["seed"])
    for n in range(steps):
        b = calib[n % len(calib)]
        jW, jloss = jstep(jW, b, jnp.asarray(n))
        W, loss = no_mirror_step(
            pcfg, lambda p, bb: tlosses.lm_loss(cfg, p, bb), W,
            {"tokens": torch.as_tensor(b["tokens"])}, tbank.stats, pr, rng,
            n, l2=ABLATION["l2"])
        print(f"step {n}: objective jax {float(jloss):.6f}, torch "
              f"{float(loss):.6f}")
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    worst = 0.0
    for path, jw, tw in leaf_pairs(jW, W):
        w0 = f64(jax_flat(jp)[path])
        jd, td = f64(jw) - w0, f64(tw) - w0
        scale = np.abs(jd).max()
        if scale == 0:
            continue
        # each side rounds W - kappa*alpha*g to f32: two units of W's last
        # place besides the gradient's own error
        tol = 2e-2 * scale + 2 * np.spacing(np.abs(w0).astype(np.float32))
        worst = max(worst, float((np.abs(td - jd) / tol).max()))
        np.testing.assert_array_less(np.abs(td - jd), tol, err_msg=path)
    print(f"{metric}: worst update error {worst:.3f} of its tolerance")
    if metric != "stochria":
        return
    # Eq. 8 has no saliency variable: masks come from raw S(W_final)
    jS = jmetrics.metric_tree("stochria", jW, jbank.stats, jpr, key=jrng,
                              norm="none")
    tS = tmetrics.metric_tree("stochria", W, tbank.stats, pr, key=rng,
                              norm="none")
    n_el = sum(int(v.size) for v in jax.tree.leaves(jS) if v is not None)
    for s in SPARSITIES:
        jm, tm, err = _raw_score_ties(jS, tS, s)
        pairs = [(path, f64(jax_flat(jS)[path]), np.asarray(jk), tk.numpy())
                 for path, jk, tk in leaf_pairs(jm, tm)]
        # the reference's global threshold: between its smallest kept and
        # largest dropped score
        edge = 0.5 * (min(sc[k].min() for _, sc, k, _ in pairs)
                      + max(sc[~k].max() for _, sc, k, _ in pairs))
        ties = 0
        for path, sc, jk, tk in pairs:
            diff = jk != tk
            assert np.all(np.abs(sc[diff] - edge) <= 2 * err), (path, err)
            ties += int(diff.sum())
        print(f"raw-S masks at {s}: {ties} of {n_el} entries differ, each "
              f"within 2 x {err:.2e} of the reference's threshold")
        assert ties <= n_el // 10000


# --- unstructured mask storage ---------------------------------------------

@pytest.mark.parametrize("shape", [(1,), (7,), (8,), (13,), (3, 5), (64, 33),
                                   (2, 3, 9, 11)])
def test_bitmask_bytes_match_reference(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    m = rng.random(shape) < 0.4
    jb = jformats.BitMask.pack(jnp.asarray(m))
    tb = BitMask.pack(torch.from_numpy(m))
    assert tb.shape == jb.shape == tuple(shape)
    assert tb.nbytes == jb.nbytes == -(-m.size // 8)
    np.testing.assert_array_equal(tb.bits.numpy(), np.asarray(jb.bits))
    np.testing.assert_array_equal(tb.to_dense().numpy(), m)
    # bytes the reference packed unpack on the port, and the reverse
    np.testing.assert_array_equal(
        BitMask(torch.from_numpy(np.array(jb.bits)), shape)
        .to_dense().numpy(), m)
    np.testing.assert_array_equal(np.asarray(jformats.BitMask(
        jnp.asarray(tb.bits.numpy()), shape).to_dense()), m)


def test_mask_tree_packing_round_trips_committed_bank_masks():
    jbank, tbank = tiny_bank("moe-tiny")
    jm, tm = jbank.masks_at(sparsity=0.6), tbank.masks_at(sparsity=0.6)
    jpk, tpk = jpack.pack_mask_tree(jm), pack_mask_tree(tm)
    flat = dict(tree.flatten_with_path(tpk))
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jpk, is_leaf=lambda x: x is None or isinstance(x, jformats.BitMask))
    assert len(jflat) == len(flat)
    for kp, jb in jflat:
        path = jax.tree_util.keystr(kp)
        tb = flat[path]
        if jb is None:
            assert tb is None, path
            continue
        assert isinstance(tb, BitMask) and tb.shape == jb.shape
        np.testing.assert_array_equal(tb.bits.numpy(), np.asarray(jb.bits),
                                      err_msg=path)
    back = unpack_mask_tree(tpk)
    for path, jv, tv in leaf_pairs(jm, back):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                      err_msg=path)
    assert tmasks.sparsity_of(back) == jmasks.sparsity_of(jm)
    assert unpack_mask_tree(pack_mask_tree({"a": None, "b": [None]})) == \
        {"a": None, "b": [None]}


def test_sparse_leaves_in_flatten_order():
    v = torch.zeros(4, 3, dtype=torch.bfloat16)
    i = torch.zeros(4, 3, dtype=torch.int8)
    a, b = SparseTensor(v, i), SparseTensor(v.clone(), i.clone())
    t = {"z": a, "a": {"k": b, "w": torch.ones(2)}, "n": None}
    assert sparse_leaves(t) == [b, a]
    assert sparse_leaves({"x": torch.ones(3)}) == []
    assert to_torch(np.ones(2, np.float32)).dtype == torch.float32
