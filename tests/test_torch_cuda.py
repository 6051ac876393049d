"""repro_torch CUDA kernels against their plain versions, on the card.

Marked ``cuda``; they skip where there is no card.  This file imports no
jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports jax for the other files.)
Tolerances: bf16 output rtol = atol = 2e-2 (one bf16 rounding of an f32
sum taken in another order), f32 output 1e-4; masks exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.nm_prox import nm_mask24
from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                         nm_matmul, nm_matmul_plain)
from repro_torch.sparse.formats import _pack_idx2


def _tied_scores(seed, K, N):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((K, N)).astype(np.float32)
    s[: K // 2] = rng.integers(-2, 3, size=(K // 2, N))  # many exact ties
    s[0] = -0.0                                          # signed zero ties
    s[1] = 0.0
    s[2::8] = np.abs(s[3::8])                            # |s| ties across sign
    return s


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (and nvcc) to build and launch "
                    "the CUDA kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


_KERNEL_CASES = [(layout, mkn)
                 for mkn in [(1, 64, 64), (5, 132, 66), (16, 256, 130),
                             (37, 1024, 512), (200, 512, 256), (3, 8192, 64)]
                 for layout in (LAYOUT_INT8, LAYOUT_PACKED2)
                 if layout == LAYOUT_INT8 or mkn[1] % 8 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,mkn", _KERNEL_CASES)
def test_nm_matmul_kernel_matches_plain(cuda_device, layout, mkn):
    """Ragged M and N tiles, K % 8 == 4 (int8 only), split-K and un-split
    grids, both layouts."""
    M, K, N = mkn
    g = torch.Generator().manual_seed(M + K + N)
    w = torch.randn((K, N), generator=g)
    vals, idx = ref.compress_24(w)
    plane = _pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        x = (0.1 * torch.randn((M, K), generator=g)).to(dtype)
        v = vals.to(dtype)
        want = nm_matmul_plain(x, v, plane, layout=layout)
        before = nm_matmul.launches
        got = nm_matmul(x.to(cuda_device), v.to(cuda_device),
                        plane.to(cuda_device), layout=layout)
        torch.cuda.synchronize()
        assert nm_matmul.launches == before + 1
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=tol, atol=tol)
        got32 = nm_matmul(x.to(cuda_device), v.to(cuda_device),
                          plane.to(cuda_device), layout=layout,
                          out_dtype=torch.float32)
        want32 = nm_matmul_plain(x, v, plane, layout=layout,
                                 out_dtype=torch.float32)
        torch.testing.assert_close(got32.cpu(), want32, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_nm_mask24_kernel_equals_plain(cuda_device, dtype):
    s = torch.from_numpy(_tied_scores(7, 4 * 300, 333)).to(dtype)
    before = nm_mask24.launches
    got = nm_mask24(s.to(cuda_device))
    torch.cuda.synchronize()
    assert nm_mask24.launches == before + 1
    assert torch.equal(got.cpu(), ref.nm_mask_ref(s))
