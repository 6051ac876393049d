"""repro_torch kernels: the plain versions (the CPU path of each wrapper)
against the JAX package's Pallas kernels in interpret mode.  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: f32 rtol = atol = 1e-5, bf16 2e-2, the bounds of
tests/test_kernels.py (the two sides sum in different orders and round
bf16 outputs once).  Index planes and masks are integer outputs and must
match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import to_torch
from repro.kernels import ref as jref
from repro.kernels.nm_prox import nm_mask24 as jax_nm_mask24
from repro.kernels.nm_spmm import nm_matmul as jax_nm_matmul
from repro.kernels.nm_spmm import unpack_idx2 as jax_unpack_idx2
from repro.sparse.formats import _pack_idx2 as jax_pack_idx2
from repro_torch.kernels import ref
from repro_torch.kernels.nm_prox import nm_mask24
from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                         nm_matmul, unpack_idx2)
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
    with pytest.raises(ValueError):  # mixed devices
        nm_matmul(torch.zeros((4, 64)), vals, idx)
