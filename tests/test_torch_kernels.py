"""repro_torch kernels: the plain versions (the CPU path of each wrapper)
against the JAX package's Pallas kernels in interpret mode.  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: f32 rtol = atol = 1e-5, bf16 2e-2, the bounds of
tests/test_kernels.py (the two sides sum in different orders and round
bf16 outputs once).  Index planes and masks are integer outputs and must
match exactly.  The search's elementwise passes (``prox24``,
``saliency_fused_step``) round every op on their own, as the reference does
op by op: exact against ``jax.disable_jit``.  The Pallas kernels in
interpret mode are jitted, and XLA's CPU backend contracts some multiply
and add pairs into fused multiply-adds there: atol 4 f32 units in the last
place at the scale of the largest output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_torch
from repro.kernels import ref as jref
from repro.kernels.nm_prox import nm_mask24 as jax_nm_mask24
from repro.kernels.nm_prox import prox24 as jax_prox24
from repro.kernels.saliency_fuse import \
    saliency_fused_step as jax_saliency_fused_step
from repro.kernels.nm_spmm import nm_matmul as jax_nm_matmul
from repro.kernels.nm_spmm import unpack_idx2 as jax_unpack_idx2
from repro.sparse.formats import _pack_idx2 as jax_pack_idx2
from repro_torch.kernels import ref
from repro_torch.kernels.nm_prox import nm_mask24, prox24
from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                         nm_matmul, unpack_idx2)
from repro_torch.kernels.saliency_fuse import saliency_fused_step
from repro_torch.sparse.formats import _pack_idx2

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _problem(seed, M, K, N, dtype):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = (0.1 * rng.standard_normal((M, K))).astype(np.float32)
    vals, idx = jref.compress_24(jnp.asarray(w))
    return (jnp.asarray(x).astype(dtype), vals.astype(dtype), idx, w)


@pytest.mark.parametrize("layout", [LAYOUT_INT8, LAYOUT_PACKED2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kn", [(64, 128), (256, 384)])
def test_nm_matmul_plain_matches_jax_interpret(layout, dtype, kn):
    K, N = kn
    x, vals, idx, _ = _problem(K + N, 32, K, N, getattr(jnp, dtype))
    plane = jax_pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    want = jax_nm_matmul(x, vals, plane, bm=16, bk=64, bn=128, layout=layout,
                         interpret=True)
    tx, tv, tp = to_torch(x), to_torch(vals), to_torch(plane)
    got = nm_matmul(tx, tv, tp, layout=layout)
    assert got.dtype == getattr(torch, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    # the raw f32 accumulator (out_dtype) agrees as well
    want32 = jax_nm_matmul(x, vals, plane, bm=16, bk=64, bn=128,
                           layout=layout, interpret=True,
                           out_dtype=jnp.float32)
    got32 = nm_matmul(tx, tv, tp, out_dtype=torch.float32)
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), rtol=1e-5,
                               atol=1e-5)


def test_compress_24_matches_reference_exactly():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((128, 96)).astype(np.float32)
    w[::7] = 0.0                      # whole zero rows force ties in groups
    w[1::4] = np.round(w[1::4])       # and rounded values force more
    jv, ji = jref.compress_24(jnp.asarray(w))
    tv, ti = ref.compress_24(torch.from_numpy(w))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        ref.decompress_24(tv, ti).numpy(),
        np.asarray(jref.decompress_24(jv, ji)))


@pytest.mark.parametrize("rows", [16, 20, 64])   # K/2 = 4r and 4r + 2
def test_pack_unpack_idx2_byte_exact(rows):
    rng = np.random.default_rng(rows)
    idx = rng.integers(0, 4, size=(3, rows, 40)).astype(np.int8)
    jp = np.asarray(jax_pack_idx2(jnp.asarray(idx)))
    tp = _pack_idx2(torch.from_numpy(idx))
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(unpack_idx2(tp).numpy(),
                                  np.asarray(jax_unpack_idx2(jnp.asarray(jp))))


def _tied_scores(seed, K, N):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((K, N)).astype(np.float32)
    s[: K // 2] = rng.integers(-2, 3, size=(K // 2, N))  # many exact ties
    s[0] = -0.0                                          # signed zero ties
    s[1] = 0.0
    s[2::8] = np.abs(s[3::8])                            # |s| ties across sign
    return s


@pytest.mark.parametrize("kn", [(64, 128), (256, 512), (128, 96)])
def test_nm_mask24_plain_equals_jax_interpret(kn):
    s = _tied_scores(sum(kn), *kn)
    want = np.asarray(jax_nm_mask24(jnp.asarray(s), bk=min(64, kn[0]),
                                    bn=kn[1], interpret=True))
    got = nm_mask24(torch.from_numpy(s))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy().reshape(kn[0] // 4, 4, kn[1]).sum(1) == 2).all()


def _f32_ulps(x) -> float:
    return 4 * 2.0 ** -24 * float(np.abs(np.asarray(x)).max())


@pytest.mark.parametrize("kn", [(64, 128), (256, 512)])
@pytest.mark.parametrize("lam", [1e-2, 0.5])
def test_prox24_plain_equals_reference(kn, lam):
    rng = np.random.default_rng(sum(kn))
    w = (0.3 * rng.standard_normal(kn)).astype(np.float32)
    w[::9] = 0.0
    got = prox24(torch.from_numpy(w), lam=lam)
    from repro.kernels import ref as jax_ref
    with jax.disable_jit():
        want = jax_ref.prox24_ref(jnp.asarray(w), lam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = jax_prox24(jnp.asarray(w), lam=lam, bk=min(64, kn[0]), bn=128,
                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=0,
                               atol=_f32_ulps(pallas))
    # in place, over the input (the search overwrites W)
    t = torch.from_numpy(w.copy())
    assert prox24(t, lam=lam, out=t) is t
    assert torch.equal(t, got)
    ref.prox24_ref(torch.from_numpy(w), lam)  # the plain version itself
    assert torch.equal(ref.prox24_ref(torch.from_numpy(w), lam), got)


def _fused_inputs(seed, K, N):
    rng = np.random.default_rng(seed)
    w = (0.2 * rng.standard_normal((K, N))).astype(np.float32)
    w[::11] = 0.0
    a = (np.abs(rng.standard_normal(K)) + 0.05).astype(np.float32)
    v = (0.01 * rng.standard_normal((K, N))).astype(np.float32)
    g = np.sign(v) * np.maximum(np.abs(v) - 1e-3, 0.0).astype(np.float32)
    return w, a, g.astype(np.float32), v


@pytest.mark.parametrize("metric", ["wanda", "magnitude", "ria"])
@pytest.mark.parametrize("kn", [(64, 128), (256, 512)])
def test_saliency_fused_step_plain_equals_reference(metric, kn):
    K, N = kn
    w, a, g, v = _fused_inputs(K + N, K, N)
    aw = np.abs(w)
    rowsum, colsum = aw.sum(1), aw.sum(0)
    ria = metric == "ria"
    kw = dict(metric=metric, v_lr=0.1, lam=1e-3)
    tw, ta, tg, tv = (torch.from_numpy(x) for x in (w, a, g, v))
    trow = torch.from_numpy(rowsum) if ria else None
    tcol = torch.from_numpy(colsum)[None] if ria else None
    got = saliency_fused_step(tw, None if metric == "magnitude" else ta, tg,
                              tv, rowsum=trow, colsum=tcol, **kw)
    from repro.kernels import ops as jax_ops
    with jax.disable_jit():   # the reference's CPU path, op by op
        want = jax_ops.fused_mirror_leaf(
            jnp.asarray(w), jnp.asarray(a), jnp.asarray(g), jnp.asarray(v),
            rowsum=jnp.asarray(rowsum) if ria else None,
            colsum=jnp.asarray(colsum) if ria else None, **kw)
    pallas = jax_saliency_fused_step(
        jnp.asarray(w), jnp.asarray(a), jnp.asarray(g), jnp.asarray(v),
        rowsum=jnp.asarray(rowsum) if ria else None,
        colsum=jnp.asarray(colsum) if ria else None, bk=min(64, K), bn=128,
        interpret=True, **kw)
    for t, j, p in zip(got, want, pallas):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_allclose(t.numpy(), np.asarray(p), rtol=0,
                                   atol=_f32_ulps(p))
    # in place over v and gamma
    tv2, tg2 = tv.clone(), tg.clone()
    out = saliency_fused_step(tw, None if metric == "magnitude" else ta, tg2,
                              tv2, rowsum=trow, colsum=tcol, inplace=True,
                              **kw)
    assert out[0] is tv2 and out[1] is tg2
    assert torch.equal(tv2, got[0]) and torch.equal(tg2, got[1])


def test_saliency_fused_step_stacked_rows_and_median_divisor():
    """A stacked (L, K, N) leaf as its (L*K, N) view, with per-layer colsum,
    and S divided by the search's median normaliser, equal the reference's
    search update of each layer op by op."""
    from repro.core import metrics as jmetrics
    from repro.core import prox as jprox
    L, K, N = 3, 32, 48
    w, a, g, v = _fused_inputs(5, L * K, N)
    aw = np.abs(w).reshape(L, K, N)
    rowsum, colsum = aw.sum(2).reshape(-1), aw.sum(1)
    s = np.abs(w) * a[:, None]
    med = np.sort(s.reshape(-1))[s.size // 2]
    s_div = torch.tensor(med + np.float32(1e-12))
    for metric in ("wanda", "ria"):
        ria = metric == "ria"
        v_new, g_new = saliency_fused_step(
            torch.from_numpy(w), torch.from_numpy(a), torch.from_numpy(g),
            torch.from_numpy(v), metric=metric, v_lr=0.1, lam=1e-3,
            rowsum=torch.from_numpy(rowsum) if ria else None,
            colsum=torch.from_numpy(colsum) if ria else None,
            s_div=s_div if metric == "wanda" else None)
        with jax.disable_jit():
            jw = jnp.asarray(w).reshape(L, K, N)
            ja = jnp.asarray(a).reshape(L, K)
            S = (jmetrics.normalize_scores(jmetrics.wanda(jw, ja), "median")
                 if metric == "wanda" else jmetrics.ria(jw, ja))
            V = jnp.asarray(v).reshape(L, K, N) - 0.1 * (
                jnp.asarray(g).reshape(L, K, N) - S)
            G = jprox.soft_threshold(V, 1e-3)
        tol = 0 if metric == "wanda" else 1e-6 * float(np.abs(V).max())
        np.testing.assert_allclose(v_new.numpy(), np.asarray(V).reshape(
            L * K, N), rtol=0, atol=tol)
        np.testing.assert_allclose(g_new.numpy(), np.asarray(G).reshape(
            L * K, N), rtol=0, atol=tol)


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor off the CPU either launches the kernel or raises: there is
    no silent fallback to the plain version."""
    x = torch.zeros((4, 64), device="meta")
    vals = torch.zeros((32, 64), device="meta")
    idx = torch.zeros((8, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        nm_matmul(x, vals, idx)
    with pytest.raises(ValueError):
        nm_mask24(torch.zeros((64, 8), device="meta"))
    w = torch.zeros((64, 8), device="meta")
    with pytest.raises(ValueError):
        prox24(w, lam=0.01)
    with pytest.raises(ValueError):
        saliency_fused_step(w, torch.zeros(64, device="meta"), w, w)
    with pytest.raises(ValueError):   # K % 4
        prox24(torch.zeros((6, 8)), lam=0.01)
    with pytest.raises(ValueError):  # mixed devices
        nm_matmul(torch.zeros((4, 64)), vals, idx)
