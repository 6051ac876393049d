"""repro_torch CUDA kernels against their plain versions, on the card.

Marked ``cuda``; they skip where there is no card.  This file imports no
jax, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports jax for the other files.)
Tolerances: bf16 output rtol = atol = 2e-2 (one bf16 rounding of an f32
sum taken in another order), f32 output 1e-4; masks exactly.  The search's
elementwise kernels (``prox24``, ``saliency_fused_step``) round every op
on its own as their plain versions do, so they must equal them bit for
bit.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.nm_prox import nm_mask24, prox24
from repro_torch.kernels.saliency_fuse import (saliency_fused_step,
                                               saliency_fused_step_plain)
from repro_torch.kernels.nm_spmm import (LAYOUT_INT8, LAYOUT_PACKED2,
                                         nm_matmul, nm_matmul_expert,
                                         nm_matmul_expert_plain,
                                         nm_matmul_plain)
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
                             (37, 1024, 512), (200, 512, 256), (3, 8192, 64),
                             # deepseek-v2-lite: the dense layer's down (K
                             # 10944 = 85.5 x 128, a partial last mma.sp
                             # stage), w_dkv (N 576), w_uk / w_uv (K 512)
                             (4, 10944, 2048), (37, 10944, 128),
                             (4, 2048, 576), (31, 512, 2048)]
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


# (E, M, K, N): decode (M = 4 slots, 1) and prefill (M = 40, the capacity of
# one 128-token prompt) rows, ragged N, K % 8 == 4 (int8 only), and a grid
# small enough to split K
_EXPERT_CASES = [(layout, emkn)
                 for emkn in [(8, 4, 256, 130), (8, 1, 512, 64),
                              (8, 40, 256, 192), (4, 40, 132, 66),
                              (2, 4, 8192, 64),
                              # deepseek-v2-lite's 64 experts: up / gate at
                              # decode (C 4), down at a prefill's C 16
                              (64, 4, 2048, 1408), (64, 16, 1408, 2048)]
                 for layout in (LAYOUT_INT8, LAYOUT_PACKED2)
                 if layout == LAYOUT_INT8 or emkn[2] % 8 == 0]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,emkn", _EXPERT_CASES)
def test_nm_matmul_expert_kernel_matches_plain(cuda_device, layout, emkn):
    E, M, K, N = emkn
    g = torch.Generator().manual_seed(E + M + K + N)
    comp = [ref.compress_24(torch.randn((K, N), generator=g))
            for _ in range(E)]
    vals = torch.stack([v for v, _ in comp])
    idx = torch.stack([i for _, i in comp])
    plane = _pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        x = (0.1 * torch.randn((E, M, K), generator=g)).to(dtype)
        v = vals.to(dtype)
        dev = [t.to(cuda_device) for t in (x, v, plane)]
        before = nm_matmul_expert.launches
        got = nm_matmul_expert(*dev, layout=layout)
        torch.cuda.synchronize()
        assert nm_matmul_expert.launches == before + 1
        torch.testing.assert_close(
            got.cpu().float(),
            nm_matmul_expert_plain(x, v, plane, layout=layout).float(),
            rtol=tol, atol=tol)
        got32 = nm_matmul_expert(*dev, layout=layout,
                                 out_dtype=torch.float32)
        want32 = nm_matmul_expert_plain(x, v, plane, layout=layout,
                                        out_dtype=torch.float32)
        torch.testing.assert_close(got32.cpu(), want32, rtol=1e-4,
                                   atol=1e-4)


def _bf16_case(seed, E, M, K, N, layout, pairs=None):
    """bf16 x (E, M, K), compressed W as vals (E, K/2, N) and its plane; with
    ``pairs``, group g of column n keeps pairs[(g + n) % len(pairs)]."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((E, K, N), generator=g)
    if pairs is not None:
        keep = torch.zeros((E, K // 4, 4, N), dtype=torch.bool)
        for q in range(K // 4):
            for n in range(N):
                keep[:, q, list(pairs[(q + n) % len(pairs)]), n] = True
        w = torch.where(keep.reshape(E, K, N), 4 + w.abs(), 0.01 * w)
    comp = [ref.compress_24(w[e]) for e in range(E)]
    vals = torch.stack([v for v, _ in comp]).to(torch.bfloat16)
    idx = torch.stack([i for _, i in comp])
    plane = _pack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    x = (0.1 * torch.randn((E, M, K), generator=g)).to(torch.bfloat16)
    return x, vals, idx, plane


def _check_expert(cuda_device, x, vals, plane, layout):
    want = nm_matmul_expert_plain(x, vals, plane, layout=layout)
    dev = [t.to(cuda_device) for t in (x, vals, plane)]
    got = nm_matmul_expert(*dev, layout=layout)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    got32 = nm_matmul_expert(*dev, layout=layout, out_dtype=torch.float32)
    torch.testing.assert_close(
        got32.cpu(), nm_matmul_expert_plain(x, vals, plane, layout=layout,
                                            out_dtype=torch.float32),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [LAYOUT_PACKED2, LAYOUT_INT8])
def test_nm_matmul_mma_reads_every_position_pair(cuda_device, layout):
    """The packed2 nibbles (and the int8 plane packed as it is staged) are
    mma.sp's metadata as they stand: every ascending pair, (0, 1), (0, 3),
    (2, 3) and (1, 2) among them, in every group slot and row of a tile."""
    pairs = ((0, 1), (0, 3), (2, 3), (1, 2), (0, 2), (1, 3))
    x, vals, idx, plane = _bf16_case(5, 2, 8, 128, 64, layout, pairs)
    want_pos = torch.tensor([[p for q in range(32) for p in pairs[(q + n) % 6]]
                             for n in range(64)], dtype=torch.int8).T
    assert torch.equal(idx[0], want_pos) and torch.equal(idx[1], want_pos)
    _check_expert(cuda_device, x, vals, plane, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 8, 9, 16, 40, 64, 128])
@pytest.mark.parametrize("layout", [LAYOUT_PACKED2, LAYOUT_INT8])
def test_nm_matmul_mma_rows_cross_tiles(cuda_device, layout, M):
    """M across the n8 tiles, the 8-128-row block tiles and their warp
    splits; N over two column blocks and half of a third."""
    x, vals, _, plane = _bf16_case(M, 2, M, 512, 160, layout)
    _check_expert(cuda_device, x, vals, plane, layout)
    before = nm_matmul.launches
    got = nm_matmul(x[0].to(cuda_device), vals[0].to(cuda_device),
                    plane[0].to(cuda_device), layout=layout)
    torch.cuda.synchronize()
    assert nm_matmul.launches == before + 1
    torch.testing.assert_close(
        got.cpu().float(),
        nm_matmul_plain(x[0], vals[0], plane[0], layout=layout).float(),
        rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,K", [(LAYOUT_PACKED2, 200),
                                      (LAYOUT_PACKED2, 1048),
                                      (LAYOUT_INT8, 132), (LAYOUT_INT8, 516)])
@pytest.mark.parametrize("M", [4, 40])
def test_nm_matmul_mma_k_tails(cuda_device, layout, K, M):
    """K % 32 != 0 (K % 8 == 4 on the int8 plane) and N % 16 != 0: the
    tails are zero-filled in shared memory, their metadata valid."""
    x, vals, _, plane = _bf16_case(K + M, 3, M, K, 66, layout)
    _check_expert(cuda_device, x, vals, plane, layout)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nm_matmul_split_k_is_one_launch_and_replays(cuda_device, dtype):
    """A grid of one column block splits K; the last block to arrive sums
    the partials in split order in the same launch and resets its counter,
    so a second call and a CUDA-graph replay give the same bits."""
    import ctypes
    from repro_torch.kernels import nm_spmm
    M, K, N = 4, 8192, 64
    sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert nm_spmm.split_k(M, K, N, sm, bf16=dtype == torch.bfloat16)[0] > 1
    x, vals, _, plane = _bf16_case(11, 1, M, K, N, LAYOUT_PACKED2)
    x, vals = x[0].to(dtype), vals[0].to(dtype)
    want = nm_matmul_plain(x, vals, plane[0])
    dev = [t.to(cuda_device) for t in (x, vals, plane[0])]
    first = nm_matmul(*dev)
    second = nm_matmul(*dev)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert int(nm_spmm._COUNTERS[dev[0].device].abs().sum()) == 0
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(first.cpu().float(), want.float(), rtol=tol,
                               atol=tol)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        replayed = nm_matmul(*dev)
    # the captured call is one node, a kernel: no second pass over splits
    cudart = ctypes.CDLL("libcudart.so.12")
    count = ctypes.c_size_t(0)
    assert cudart.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                    None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert cudart.cudaGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                    nodes, ctypes.byref(count)) == 0
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cudart.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                           ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    assert kinds == [0], kinds      # cudaGraphNodeTypeKernel
    graph.instantiate()
    for _ in range(3):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, first)
    assert int(nm_spmm._COUNTERS[dev[0].device].abs().sum()) == 0


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


# (R, N): stacked leaf views (layers * K, N) at reduced depth, ragged N, and
# the smoke widths
_SEARCH_SHAPES = [(4 * 128, 128), (4 * 256, 128), (2 * 2048, 512),
                  (2 * 8192, 2048), (12, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("rn", _SEARCH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_prox24_kernel_equals_plain(cuda_device, rn, dtype):
    g = torch.Generator().manual_seed(sum(rn))
    w = (0.3 * torch.randn(rn, generator=g)).to(dtype)
    w[::5] = 0.0
    w[1::7] = -0.0
    for lam in (1e-2, 0.5):
        want = ref.prox24_ref(w.to(cuda_device), lam)
        before = prox24.launches
        got = prox24(w.to(cuda_device), lam=lam)
        torch.cuda.synchronize()
        assert prox24.launches == before + 1
        assert got.dtype == dtype
        assert torch.equal(got.cpu(), want.cpu())
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        t = w.to(cuda_device)          # in place
        prox24(t, lam=lam, out=t)
        assert torch.equal(t, got)


@pytest.mark.cuda
@pytest.mark.parametrize("rn", _SEARCH_SHAPES[:4])
@pytest.mark.parametrize("metric", ["wanda", "magnitude", "ria"])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_saliency_fused_step_kernel_equals_plain(cuda_device, rn, metric,
                                                 wdtype):
    R, N = rn
    L = 4 if R % 4 == 0 else 1
    g = torch.Generator().manual_seed(R + N)
    dev = cuda_device
    w = (0.2 * torch.randn(rn, generator=g)).to(wdtype).to(dev)
    a = (torch.randn(R, generator=g).abs() + 0.05).to(dev)
    v = (0.01 * torch.randn(rn, generator=g)).to(dev)
    gam = torch.copysign(torch.clamp_min(v.abs() - 1e-3, 0.0), v)
    aw = w.float().abs().reshape(L, R // L, N)
    ria = metric == "ria"
    kw = dict(metric=metric, v_lr=0.1, lam=1e-3,
              rowsum=aw.sum(-1).reshape(R) if ria else None,
              colsum=aw.sum(-2) if ria else None)
    s = w.float().abs() * a[:, None]
    s_div = torch.topk(s.reshape(-1), s.numel() - s.numel() // 2).values \
        .min() + 1e-12
    for div in (None, s_div):
        am = None if metric == "magnitude" else a
        want = saliency_fused_step_plain(w, am, gam, v, s_div=div, **kw)
        before = saliency_fused_step.launches
        got = saliency_fused_step(w, am, gam, v, s_div=div, **kw)
        torch.cuda.synchronize()
        assert saliency_fused_step.launches == before + 1
        for x, y in zip(got, want):
            assert x.dtype == torch.float32
            assert torch.equal(x, y)
        v2, g2 = v.clone(), gam.clone()
        saliency_fused_step(w, am, g2, v2, s_div=div, inplace=True, **kw)
        assert torch.equal(v2, got[0]) and torch.equal(g2, got[1])


# --- decode attention: flash_decode, flash_decode_partial, the combine ----

def _decode_operands(seed, B, K, G, D, C, dtype, dev, positions):
    """q, k, v in ``dtype`` on ``dev`` and an f32 bias (B, C) masking every
    slot past row b's position ``positions[b]`` (a ring that has not
    wrapped yet: slot c holds position c)."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (0.5 * torch.randn(shape, generator=g) for shape in
               ((B, K, G, D), (B, C, K, D), (B, C, K, D)))
    ok = torch.arange(C)[None, :] <= torch.tensor(positions)[:, None]
    bias = torch.where(ok, 0.0, -1e30).to(torch.float32)
    return [t.to(dtype).to(dev) for t in (q, k, v)] + [bias.to(dev)]


def _decode_tol(want, terms, dtype):
    """f32: 2e-4 of |plain| + sum|p v| (sums in another order, exp within
    an ulp) + 2e-5; bf16 outputs one bf16 ulp more."""
    tol = 2e-4 * (want.abs() + terms) + 2e-5
    if dtype == torch.bfloat16:
        tol = tol + want.abs() * 2 ** -7
    return tol


# (B, K, G, D, C, S): llama3.2-1b serving (4 slots, capacity 256), its long
# cache (at S 1 the kernel splits each row's 8192 slots over a cluster of
# 8 blocks; row 1's later splits are all-masked, row 3 has one valid
# slot), mixtral-8x22b at its window, the smoke heads at a C that is no
# multiple of any chunk of the kernel (at S 1 split into 18- and 19-slot
# ranges), and f32
_DECODE_CASES = [(4, 8, 4, 64, 256, 1), (4, 8, 4, 64, 256, 4),
                 (4, 8, 4, 64, 8192, 1),
                 (4, 8, 4, 64, 8192, 4), (4, 8, 4, 64, 8192, 16),
                 (4, 8, 6, 128, 4096, 1), (4, 8, 6, 128, 4096, 4),
                 (3, 2, 2, 32, 148, 1), (3, 4, 6, 32, 74, 1),
                 (3, 2, 2, 32, 148, 4), (3, 4, 6, 32, 74, 2),
                 # gemma3-1b (one kv head of 4 x 256: at D 256 f32 keeps
                 # one ring stage a warp) at its window and a long cache,
                 # yi-6b (4 kv heads of 8 x 128, every row of the tile),
                 # and both widths at a ragged C
                 (4, 1, 4, 256, 512, 1), (4, 1, 4, 256, 512, 4),
                 (4, 1, 4, 256, 8192, 1), (4, 4, 8, 128, 256, 1),
                 (4, 4, 8, 128, 256, 4), (4, 4, 8, 128, 8192, 4),
                 (3, 2, 8, 256, 148, 1), (3, 2, 8, 256, 148, 4),
                 # zamba2-7b's shared attention (32 kv heads of one query
                 # head of 112: 7 k-steps of 16, the last one alone) at
                 # serving and long caches, G 1 and D 112 at a ragged C
                 # and beside the other widths and groups
                 (4, 32, 1, 112, 256, 1), (4, 32, 1, 112, 256, 4),
                 (4, 32, 1, 112, 8192, 1), (4, 32, 1, 112, 8192, 4),
                 (3, 2, 1, 112, 148, 1), (3, 2, 1, 112, 148, 4),
                 (3, 2, 4, 112, 148, 2), (3, 2, 8, 112, 74, 1),
                 (3, 2, 1, 64, 148, 4), (3, 2, 1, 256, 148, 1),
                 (3, 4, 1, 32, 74, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", _DECODE_CASES, ids=str)
def test_flash_decode_kernels_match_plain(cuda_device, case, dtype):
    """Rows at different positions; row 1 sees only the first half shard,
    so every later shard of it is all-masked (m = -1e30, l = its slot
    count, exactly).  A second call of each kernel gives the same bits:
    the cluster merges its splits in split order, with no atomics."""
    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  flash_decode,
                                                  flash_decode_partial)
    B, K, G, D, C, S = case
    n = C // S
    pos = [C - 1, n // 2, C // 2 + 3][:B] + [0] * max(0, B - 3)
    q, k, v, bias = _decode_operands(sum(case), B, K, G, D, C, dtype,
                                     cuda_device, pos)
    before = (flash_decode.launches, flash_decode_partial.launches,
              combine_partials.launches)
    got = flash_decode(q, k, v, bias)
    acc, m, l = flash_decode_partial(q, k, v, bias, shards=S)
    comb = combine_partials(acc, m, l, dtype)
    torch.cuda.synchronize()
    assert (flash_decode.launches, flash_decode_partial.launches,
            combine_partials.launches) == tuple(x + 1 for x in before)
    again = flash_decode_partial(q, k, v, bias, shards=S)
    for x, y in zip((got, acc, m, l, comb),
                    (flash_decode(q, k, v, bias), *again,
                     combine_partials(*again, dtype)), strict=True):
        assert torch.equal(x, y)
    want = ref.flash_decode_ref(q, k, v, bias).float()
    terms = ref.flash_decode_ref(q, k, v.abs(), bias).float()
    tol = _decode_tol(want, terms, dtype)
    assert got.dtype == comb.dtype == dtype
    for out in (got, comb):
        assert bool(((out.float() - want).abs() <= tol).all())
    wa, wm, wl = ref.flash_decode_shards_ref(q, k, v, bias, shards=S)
    ta, _, _ = ref.flash_decode_shards_ref(q, k, v.abs(), bias, shards=S)
    assert bool(((acc - wa).abs() <= 2e-4 * (wa.abs() + ta) + 2e-5).all())
    assert bool(((l - wl).abs() <= 2e-4 * wl + 2e-5).all())
    assert bool(((m - wm).abs() <= 2e-4 * wm.abs() + 2e-5).all())
    dead = wm == -1e30
    assert bool(dead.any()) == (S > 1)
    assert bool((m[dead] == -1e30).all()) and bool((l[dead] == n).all())


# (B, K, G, D, C, S, valid slots per row): shapes the planner splits; rows
# with one valid slot, with splits all-masked inside a shard that has valid
# slots, and whole shards all-masked
_SPLIT_CASES = [(4, 8, 4, 64, 256, 1, [1, 40, 256, 33]),
                (4, 8, 4, 64, 256, 2, [1, 100, 256, 129]),
                (4, 8, 6, 128, 1024, 1, [1, 129, 1024, 700]),
                (3, 2, 2, 32, 148, 1, [1, 74, 148]),
                (4, 1, 4, 256, 512, 1, [1, 40, 512, 65]),
                (4, 4, 8, 128, 256, 2, [1, 100, 256, 129]),
                (4, 32, 1, 112, 256, 1, [1, 100, 256, 129]),
                (2, 2, 1, 112, 512, 1, [40, 300])]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", _SPLIT_CASES, ids=str)
def test_flash_decode_cluster_splits_match_plain(cuda_device, case, dtype):
    """Shapes the planner splits (P > 1 on any card of >= 16 SMs), rows
    whose valid slots end inside the first split."""
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_partial,
                                                  plan_splits)
    from repro_torch.kernels.nm_spmm import _sm_count
    B, K, G, D, C, S, valid = case
    n = C // S
    assert plan_splits(B, K, C, S, _sm_count(cuda_device.index or 0)) > 1
    q, k, v, bias = _decode_operands(sum(case[:6]), B, K, G, D, C, dtype,
                                     cuda_device, [x - 1 for x in valid])
    got = flash_decode(q, k, v, bias)
    acc, m, l = flash_decode_partial(q, k, v, bias, shards=S)
    torch.cuda.synchronize()
    want = ref.flash_decode_ref(q, k, v, bias).float()
    terms = ref.flash_decode_ref(q, k, v.abs(), bias).float()
    assert bool(((got.float() - want).abs()
                 <= _decode_tol(want, terms, dtype)).all())
    wa, wm, wl = ref.flash_decode_shards_ref(q, k, v, bias, shards=S)
    ta, _, _ = ref.flash_decode_shards_ref(q, k, v.abs(), bias, shards=S)
    assert bool(((acc - wa).abs() <= 2e-4 * (wa.abs() + ta) + 2e-5).all())
    assert bool(((l - wl).abs() <= 2e-4 * wl + 2e-5).all())
    assert bool(((m - wm).abs() <= 2e-4 * wm.abs() + 2e-5).all())
    dead = wm == -1e30
    assert bool((m[dead] == -1e30).all()) and bool((l[dead] == n).all())


@pytest.mark.cuda
def test_flash_decode_kernels_refuse_what_they_do_not_take(cuda_device):
    from repro_torch.kernels.flash_decode import flash_decode
    q, k, v, bias = _decode_operands(0, 2, 2, 3, 32, 16, torch.bfloat16,
                                     cuda_device, [3, 9])
    with pytest.raises(ValueError, match="G in"):           # G = 3
        flash_decode(q, k, v, bias)
    q, k, v, bias = _decode_operands(0, 2, 1, 16, 32, 16, torch.bfloat16,
                                     cuda_device, [3, 9])
    with pytest.raises(ValueError, match="G in"):           # G = 16
        flash_decode(q, k, v, bias)
    q, k, v, bias = _decode_operands(0, 2, 1, 4, 512, 16, torch.bfloat16,
                                     cuda_device, [3, 9])
    with pytest.raises(ValueError, match="D in"):           # D = 512
        flash_decode(q, k, v, bias)
    q, k, v, bias = _decode_operands(0, 2, 2, 2, 32, 16, torch.float16,
                                     cuda_device, [3, 9])
    with pytest.raises(TypeError):
        flash_decode(q, k, v, bias)
    q, k, v, bias = _decode_operands(0, 2, 2, 2, 32, 16, torch.bfloat16,
                                     cuda_device, [3, 9])
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                     bias)


@pytest.mark.cuda
def test_kv_shards_decode_step_captures_in_a_cuda_graph(cuda_device):
    """A smoke llama decode step with 4 capacity shards: captured in a CUDA
    graph, replayed, equal to the eager step; 4 layers -> 4 partial and 4
    combine launches (counted once, at capture)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  flash_decode_partial)
    from repro_torch.models import model as M
    cfg = get_smoke_config("llama3.2-1b")
    params = M.serving_params(M.init_params(cfg, 0, device=cuda_device))
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
    tok = toks[:, -1].to(cuda_device)
    t = torch.tensor([20, 11], dtype=torch.int32, device=cuda_device)
    _, caches = M.prefill(cfg, params, {"tokens": toks.to(cuda_device)},
                          cache_capacity=32)
    want, _ = M.decode_step(cfg, params, tok, caches, t, kv_shards=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        M.decode_step(cfg, params, tok, caches, t, kv_shards=4)
    torch.cuda.current_stream().wait_stream(side)
    before = (flash_decode_partial.launches, combine_partials.launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = M.decode_step(cfg, params, tok, caches, t, kv_shards=4)
    assert (flash_decode_partial.launches, combine_partials.launches) == \
        (before[0] + cfg.num_layers, before[1] + cfg.num_layers)
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_decode_step_captures_in_a_cuda_graph(cuda_device):
    """The same smoke llama decode step at ``kv_shards=1``: the cluster
    launch of ``flash_decode`` captured in a CUDA graph, replayed, equal
    bit for bit to the eager step; 4 layers -> 4 launches (counted once,
    at capture)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.models import model as M
    cfg = get_smoke_config("llama3.2-1b")
    params = M.serving_params(M.init_params(cfg, 0, device=cuda_device))
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=g)
    tok = toks[:, -1].to(cuda_device)
    t = torch.tensor([20, 11], dtype=torch.int32, device=cuda_device)
    _, caches = M.prefill(cfg, params, {"tokens": toks.to(cuda_device)},
                          cache_capacity=64)
    want, _ = M.decode_step(cfg, params, tok, caches, t, kv_shards=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        M.decode_step(cfg, params, tok, caches, t, kv_shards=1)
    torch.cuda.current_stream().wait_stream(side)
    before = flash_decode.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = M.decode_step(cfg, params, tok, caches, t, kv_shards=1)
    assert flash_decode.launches == before + cfg.num_layers
    got.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# -- the serve engine's steps under CUDA graphs ------------------------------

_BANK = "results/bank/llama3.2-1b"
# (prompt length, max_tokens): 3 requests on 2 slots, the third admitted
# into a freed slot after the graphs were captured
_ENGINE_REQS = ((9, 6), (17, 3), (5, 8))


def _smoke_members(dev):
    """(cfg, dense params, 2:4 params from the committed bank) on ``dev``."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.sparse.bank import MaskBank
    cfg = get_smoke_config("llama3.2-1b")
    params = M.serving_params(M.init_params(cfg, 0, device=dev))
    sparse = MaskBank.load(_BANK, device=dev).sparse_params(params)
    return cfg, params, sparse


def _engine_prompts(cfg):
    g = torch.Generator().manual_seed(1)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
            for n, _ in _ENGINE_REQS]


def _serve(cfg, params, dev, prompts, **kw):
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, slots=2, capacity=48, device=dev, **kw)
    rids = [eng.submit(p, m) for p, (_, m) in zip(prompts, _ENGINE_REQS)]
    res = eng.run()
    return eng, [res[r] for r in rids]


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["dense", "2:4"])
@pytest.mark.parametrize("kv_shards", [None, 1, 4])
def test_graph_engine_streams_equal_eager(cuda_device, weights, kv_shards):
    """The engine's decode replayed from its CUDA graph gives the eager
    engine's streams, a request admitted between replays included (its
    prefill and slot write land in the caches the graph reads); one decode
    graph per engine, and a second run captures nothing new."""
    from repro_torch.serve import engine as E
    cfg, params, sparse = _smoke_members(cuda_device)
    p = params if weights == "dense" else sparse
    prompts = _engine_prompts(cfg)
    with E.eager():
        _, want = _serve(cfg, p, cuda_device, prompts, kv_shards=kv_shards)
    eng, got = _serve(cfg, p, cuda_device, prompts, kv_shards=kv_shards)
    assert got == want
    assert eng.fns.capture_counts() == {"decode": 1}
    rids = [eng.submit(x, m) for x, (_, m) in zip(prompts, _ENGINE_REQS)]
    res = eng.run()
    assert [res[r] for r in rids] == want
    assert eng.fns.capture_counts() == {"decode": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kv_shards", [None, 1, 4])
@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-2b", "yi-6b"])
def test_gemma_and_yi_graph_engines_equal_eager(cuda_device, arch,
                                                kv_shards):
    """The smoke gemma3 (QK-norm, a 16-slot window, G 4), gemma2 (softcaps:
    decode attention stays on the plain path at every kv_shards) and yi
    (global attention) engines: replayed == eager, and the decode
    attention kernels launched exactly where the path takes them."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_partial)
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    cfg = get_smoke_config(arch)
    params = M.serving_params(M.init_params(cfg, 0, device=cuda_device))
    prompts = _engine_prompts(cfg)
    before = flash_decode.launches + flash_decode_partial.launches
    with E.eager():
        eng, want = _serve(cfg, params, cuda_device, prompts,
                           kv_shards=kv_shards)
    launched = flash_decode.launches + flash_decode_partial.launches - before
    if kv_shards is None or cfg.attn_softcap:
        assert launched == 0
    else:
        assert launched == cfg.num_layers * eng.decode_steps
    _, got = _serve(cfg, params, cuda_device, prompts, kv_shards=kv_shards)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["dense", "2:4"])
def test_deepseek_graph_engine_equals_eager(cuda_device, weights):
    """The smoke deepseek-v2-lite (MLA, shared experts) engine: its decode
    replayed from the CUDA graph (the absorbed decode decompresses the
    2:4 ``w_uk`` / ``w_uv`` inside it) == eager, with the 2:4 kernels
    launched per layer as the path takes them; a verify pass replayed ==
    eager; and ``kv_shards`` refused."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    from repro_torch.sparse.apply import sparsify_params
    from repro_torch import tree
    cfg = get_smoke_config("deepseek-v2-lite-16b")
    params = M.init_params(cfg, 0, device=cuda_device)
    if weights == "2:4":
        masks = baseline_masks("magnitude", params, tree.tree_map(
            lambda _: None, params), 0.5, mode="nm")
        params = sparsify_params(params, masks, axes=M.param_axes(cfg),
                                 idx_bits=2, dtype=torch.bfloat16)
    params = M.serving_params(params)
    prompts = _engine_prompts(cfg)
    nm0, ex0 = nm_matmul.launches, nm_matmul_expert.launches
    with E.eager():
        eng, want = _serve(cfg, params, cuda_device, prompts)
    if weights == "2:4":
        # a layer's 2-D projections: 8 at prefill, 6 at decode (the
        # absorbed decode reads w_uk / w_uv dense); 3 banks a MoE layer
        L = cfg.num_layers
        assert nm_matmul.launches - nm0 == L * (8 * eng.prefill_calls
                                                + 6 * eng.decode_steps)
        assert nm_matmul_expert.launches - ex0 == 3 * (L - 1) * (
            eng.prefill_calls + eng.decode_steps)
    eng, got = _serve(cfg, params, cuda_device, prompts)
    assert got == want
    assert eng.fns.capture_counts() == {"decode": 1}
    toks = np.asarray([p[:3] for p in prompts[:2]])
    pos = np.asarray([len(p) for p in prompts[:2]], np.int32)
    with E.eager():
        want_v, _ = eng.fns.verify(3)(eng.params, toks, eng.caches, pos)
    got_v, _ = eng.fns.verify(3)(eng.params, toks, eng.caches, pos)
    np.testing.assert_array_equal(got_v, want_v)
    with pytest.raises(ValueError, match="MLA"):
        E.ServeEngine(cfg, params, slots=2, capacity=48, device=cuda_device,
                      kv_shards=1)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("zamba2-7b", "dense", None),
                                  ("zamba2-7b", "2:4", None),
                                  ("zamba2-7b", "2:4", 1),
                                  ("zamba2-7b", "2:4", 4),
                                  ("xlstm-125m", "dense", None),
                                  ("xlstm-125m", "0.5", None)], ids=str)
def test_recurrent_graph_engines_equal_eager(cuda_device, case):
    """The smoke zamba2 (Mamba2, the shared attention at G 1 over its own
    LoRA deltas) and xlstm (mLSTM / sLSTM) engines: the decode replayed
    from its CUDA graph updates the recurrent states in place as the eager
    step does (the capture's warm-up leaves them as they were), a slot
    reused by a one-token prompt starts from the blank state; streams ==
    eager; 2:4 projections and decode attention launched exactly where
    the path takes them; xlstm's ``kv_shards`` refused (no attention)."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_partial)
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    from repro_torch.sparse.apply import sparsify_params
    arch, weights, kv_shards = case
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0, device=cuda_device)
    if weights != "dense":      # xlstm's smoke ff_down (K 85) takes no 2:4
        stats = tree.tree_map(lambda _: None, params)
        masks = (baseline_masks("magnitude", params, stats, 0.5, mode="nm")
                 if weights == "2:4" else
                 baseline_masks("magnitude", params, stats, 0.5))
        params = sparsify_params(params, masks, axes=M.param_axes(cfg),
                                 idx_bits=2, dtype=torch.bfloat16)
    params = M.serving_params(params)
    g = torch.Generator().manual_seed(1)
    reqs = ((9, 6), (17, 3), (1, 8), (5, 4))
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for n, _ in reqs]

    def serve():
        eng = E.ServeEngine(cfg, params, slots=2, capacity=48,
                            device=cuda_device, kv_shards=kv_shards)
        rids = [eng.submit(p, m) for p, (_, m) in zip(prompts, reqs)]
        res = eng.run()
        return eng, [res[r] for r in rids]

    nm0 = nm_matmul.launches
    fd0 = flash_decode.launches + flash_decode_partial.launches
    with E.eager():
        eng, want = serve()
    per_layer = {"mamba": 2, "mamba_shared": 9, "mlstm": 6, "slstm": 3}
    n_nm = sum(per_layer[k] for k in cfg.layer_kinds)
    assert nm_matmul.launches - nm0 == (n_nm * (eng.prefill_calls
                                                + eng.decode_steps)
                                        if weights == "2:4" else 0)
    n_attn = sum(k == "mamba_shared" for k in cfg.layer_kinds)
    assert (flash_decode.launches + flash_decode_partial.launches - fd0
            == (n_attn * eng.decode_steps if kv_shards else 0))
    eng, got = serve()
    assert got == want
    assert eng.fns.capture_counts() == {"decode": 1}
    if not n_attn:
        with pytest.raises(ValueError, match="no attention"):
            E.ServeEngine(cfg, params, slots=2, capacity=48,
                          device=cuda_device, kv_shards=1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 4])
def test_graph_draft_and_verify_equal_eager(cuda_device, k):
    """``EngineFns.draft(k)`` and ``verify(k)`` replayed from their graphs
    return the eager surfaces' tokens and leave the same caches; one graph
    per surface and engine."""
    from repro_torch import tree
    from repro_torch.models import model as M
    from repro_torch.serve import engine as E
    cfg, params, _ = _smoke_members(cuda_device)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=g)
    _, base = M.prefill(cfg, params, {"tokens": prompt.to(cuda_device)},
                        cache_capacity=48)
    pos = np.array([12, 7], np.int32)
    seed = np.array([3, 9], np.int32)
    feed = torch.randint(0, cfg.vocab_size, (2, k), generator=g).numpy()
    fns = E.EngineFns(cfg, 48, cuda_device)
    out = {}
    for mode in ("eager", "graph"):
        for name, inp in (("draft", seed), ("verify", feed)):
            caches = tree.tree_map(lambda a: a.clone(), base)
            ctx = E.eager() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                toks, _ = getattr(fns, name)(k)(params, inp, caches, pos)
                # a second call replays (graph) or reruns (eager)
                again, _ = getattr(fns, name)(k)(params, inp, caches, pos)
            assert np.array_equal(toks, again)
            out[mode, name] = (toks, caches)
    for name in ("draft", "verify"):
        (a, ca), (b, cb) = out["eager", name], out["graph", name]
        assert a.shape == (2, k) and np.array_equal(a, b), name
        for x, y in zip(tree.leaves(ca), tree.leaves(cb)):
            assert torch.equal(x, y), name
    # graph mode ran each surface on caches of its own: one graph each
    assert fns.capture_counts() == {f"draft_{k}": 1, f"verify_{k}": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["2:4", "pinned"])
def test_spec_is_lossless_on_the_card(cuda_device, draft):
    """Speculative decoding on the graph engines gives the verifier's own
    greedy streams at ``kv_shards=None``: the bank's 2:4 member drafting
    for the dense one, and a draft pinned to one token (one boosted
    embedding row) whose proposals keep being rejected."""
    from repro_torch.serve.engine import EngineFns, ServeEngine
    from repro_torch.serve.spec import SpecDecoder
    cfg, params, sparse = _smoke_members(cuda_device)
    if draft == "pinned":
        table = params["embed"]["table"].clone()
        table[7] *= 100
        sparse = {**params, "embed": {"table": table}}
    prompts = _engine_prompts(cfg)
    _, want = _serve(cfg, params, cuda_device, prompts)
    fns = EngineFns(cfg, 48, cuda_device)
    v = ServeEngine(cfg, params, slots=2, capacity=48, device=cuda_device,
                    fns=fns)
    d = ServeEngine(cfg, sparse, slots=2, capacity=48, device=cuda_device,
                    fns=fns)
    sd = SpecDecoder(d, v, k=4)
    rids = [sd.submit(p, m) for p, (_, m) in zip(prompts, _ENGINE_REQS)]
    res, _ = sd.run()
    assert [res[r] for r in rids] == want
    if draft == "pinned":
        assert sd.stats["rollbacks"] > 0
    counts = fns.capture_counts()
    assert set(counts) <= {f"{s}_{k}" for s in ("draft", "verify")
                           for k in range(1, 9)}
    assert all(n == 1 for n in counts.values())
    # a second run replays the graphs it captured
    rids = [sd.submit(p, m) for p, (_, m) in zip(prompts, _ENGINE_REQS)]
    res, _ = sd.run()
    assert [res[r] for r in rids] == want
    after = fns.capture_counts()
    assert all(after[s] == n for s, n in counts.items())
    assert all(n == 1 for n in after.values())


# --- the paper's evaluation and the rest of calibration ---------------------

def _mini_moe():
    """A 2-layer mixtral-shaped config at smoke-like widths (d 64, 8
    experts, top-2) and its params from seed 0, on the CPU."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("mixtral-8x22b"), d_model=64,
                              num_layers=2, num_heads=4, num_kv_heads=2,
                              head_dim=16, moe_d_ff=96, vocab_size=128)
    return cfg, M.init_params(cfg, 0, device="cpu")


def _calib(cfg, n=2, batch=2, seq=32):
    from repro_torch.data.synthetic import batches_for
    return batches_for(cfg, n=n, batch=batch, seq=seq, split="calib")


@pytest.mark.cuda
def test_eval_ppl_on_the_card_syncs_once(cuda_device):
    """eval_ppl of dense, masked-dense and 2:4-compressed smoke llama on
    the card against the CPU (rtol 2e-3, the CPU tests' bf16 bound), the
    loop body under ``set_sync_debug_mode("error")`` (no host sync until
    the one read), and the compressed run through nm_matmul at B*S rows."""
    from repro_torch import tree
    from repro_torch.optim import losses
    cfg, params, sparse = _smoke_members(cuda_device)
    from repro_torch.sparse.bank import MaskBank
    masked = MaskBank.load(_BANK, device=cuda_device).sparse_params(
        params, compressed=False)
    from repro_torch.data.synthetic import batches_for
    valid = batches_for(cfg, n=2, batch=4, seq=64, split="valid")
    for name, p in (("dense", params), ("masked", masked),
                    ("compressed", sparse)):
        want = losses.eval_ppl(cfg, tree.to_device(p, "cpu"), valid)
        staged = [{"tokens": torch.as_tensor(b["tokens"],
                                             device=cuda_device)}
                  for b in valid]
        before = nm_matmul.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tot, n = losses.eval_nll(cfg, p, staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        launches = nm_matmul.launches - before
        assert launches == (7 * cfg.num_layers * len(valid)
                            if name == "compressed" else 0), (name, launches)
        got = float(np.exp(min(float(tot) / n, 30.0)))
        assert abs(got - losses.eval_ppl(cfg, p, valid)) <= 1e-6 * got
        np.testing.assert_allclose(got, want, rtol=2e-3, err_msg=name)


@pytest.mark.cuda
def test_no_mirror_step_on_the_card(cuda_device):
    """Two Eq. 8 steps (stochria, rho 1e-5, l2 0.01) on the card against
    the CPU: the objective at rtol 2e-3 and the update W - W0 as
    tests/test_torch_eval.py holds it against the reference."""
    from functools import partial

    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig, get_smoke_config
    from repro_torch.core import calibrate as cal
    from repro_torch.core import prng
    from repro_torch.core.mirror import no_mirror_step
    from repro_torch.core.prunable import prunable_map
    from repro_torch.models import model as M
    from repro_torch.optim.losses import lm_loss
    cfg = get_smoke_config("llama3.2-1b")
    p0 = M.init_params(cfg, 0, device="cpu")
    calib = _calib(cfg)
    stats = cal.collect_stats(cfg, p0, calib)
    pcfg = PruneConfig(local_metric="stochria", rho=1e-5)
    out = {}
    for d in ("cpu", cuda_device):
        W = tree.to_device(tree.tree_map(lambda x: x.float().clone(), p0), d)
        st = tree.to_device(stats, d)
        for n in range(2):
            W, loss = no_mirror_step(
                pcfg, partial(lm_loss, cfg), W,
                {"tokens": torch.as_tensor(calib[n]["tokens"], device=d)},
                st, prunable_map(W), prng.key(11), n, l2=0.01)
        out[str(d)] = (tree.to_device(W, "cpu"), float(loss))
    (wc, lc), (wg, lg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, rtol=2e-3)
    for (path, a), (_, b), (_, w0) in zip(tree.flatten_with_path(wc),
                                          tree.flatten_with_path(wg),
                                          tree.flatten_with_path(p0)):
        da, db = (a - w0).double(), (b - w0).double()
        tol = 2e-2 * da.abs().max() + 2 * torch.from_numpy(np.spacing(
            w0.abs().numpy().astype(np.float32))).double()
        assert bool(((db - da).abs() <= tol).all()), path


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["jit", "tape"])
def test_moe_stats_on_the_card(cuda_device, impl):
    """MoE stats (expert banks with their routed-row rescale) on the card
    against the CPU: the aggregate relative error per leaf within 1e-2
    (the CPU tests' bound for routing near-ties), and the card's tape
    against its jitted pass within stats_parity's 5e-2."""
    from repro_torch import tree
    from repro_torch.core import calibrate as cal
    from repro_torch.core.prunable import prunable_map
    cfg, p0 = _mini_moe()
    calib = _calib(cfg)
    cpu = cal.collect_stats(cfg, p0, calib, impl=impl)
    card = cal.collect_stats(cfg, tree.to_device(p0, cuda_device), calib,
                             impl=impl)
    worst, ok, n = cal.stats_parity(tree.to_device(card, "cpu"), cpu,
                                    prunable_map(p0), tol=1e-2)
    assert ok and n == 7, worst
    other = cal.collect_stats(cfg, tree.to_device(p0, cuda_device), calib,
                              impl="jit" if impl == "tape" else "tape")
    assert cal.stats_parity(card, other, prunable_map(p0))[1]


@pytest.mark.cuda
def test_moe_search_on_the_card(cuda_device):
    """Three wanda 2:4 steps over expert banks (L, E, K, N) on the card:
    the fused step, prox24 and nm_mask24 launch on the (L*E*K, N) views,
    and Gamma/V match the CPU's within 1e-4 of max|V| (the CPU tests'
    search bound); the exported masks equal the CPU's but for counted
    near-ties."""
    from repro_torch import tree
    from repro_torch.configs.base import PruneConfig
    from repro_torch.core import calibrate as cal
    from repro_torch.core import mirror
    cfg, p0 = _mini_moe()
    calib = _calib(cfg)
    stats = cal.collect_stats(cfg, p0, calib)
    pcfg = PruneConfig(local_metric="wanda", mode="nm", steps=3)
    before = (prox24.launches, saliency_fused_step.launches,
              nm_mask24.launches)
    cpu, _ = cal.run_search(cfg, pcfg, p0, calib, stats)
    card, _ = cal.run_search(cfg, pcfg, tree.to_device(p0, cuda_device),
                             calib, tree.to_device(stats, cuda_device))
    mc = mirror.export_masks(pcfg, cpu.Gamma, 0.5, V=cpu.V)
    mg = mirror.export_masks(pcfg, card.Gamma, 0.5, V=card.V)
    after = (prox24.launches, saliency_fused_step.launches,
             nm_mask24.launches)
    assert [a - b for a, b in zip(after, before)] == [3 * 7, 3 * 7, 7]
    diff = 0
    for (path, vc), (_, vg) in zip(tree.flatten_with_path(cpu.V),
                                   tree.flatten_with_path(card.V)):
        if vc is None:
            continue
        scale = float(vc.abs().max())
        assert float((vg.cpu() - vc).abs().max()) <= 1e-4 * scale, path
        a = dict(tree.flatten_with_path(mc))[path]
        b = dict(tree.flatten_with_path(mg))[path].cpu()
        diff += int((a != b).sum())
    assert diff <= 8


@pytest.mark.cuda
def test_bitmask_and_sampling_card_equal_cpu(cuda_device):
    """BitMask bytes, the gumbel draws (f32 and bf16) and a categorical
    sample on the card equal the CPU's bit for bit, and the launcher's
    --temperature loop gives the CPU's stream at smoke width."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import prng
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.sparse import BitMask
    g = torch.Generator().manual_seed(0)
    m = torch.rand((37, 129), generator=g) < 0.3
    a, b = BitMask.pack(m), BitMask.pack(m.to(cuda_device))
    assert torch.equal(a.bits, b.bits.cpu())
    assert torch.equal(b.to_dense().cpu(), m)
    for dt in (torch.float32, torch.bfloat16):
        x = prng.gumbel(prng.key(100), (4, 128256), dtype=dt)
        y = prng.gumbel(prng.key(100), (4, 128256), cuda_device, dtype=dt)
        assert torch.equal(x, y.cpu()), dt
        logits = torch.randn((4, 128256), generator=g).to(dt)
        assert torch.equal(prng.categorical(prng.key(7), logits),
                           prng.categorical(prng.key(7), logits.to(
                               cuda_device)).cpu())
    cfg = get_smoke_config("llama3.2-1b")
    toks = torch.from_numpy(batches_for(cfg, n=1, batch=2, seq=16,
                                        split="valid")[0]["tokens"])
    p = M.serving_params(M.init_params(cfg, 0, device="cpu"))
    from repro_torch import tree
    want = generate(cfg, p, toks, 8, temperature=1.0)[0]
    got = generate(cfg, tree.to_device(p, cuda_device), toks, 8,
                   temperature=1.0)[0]
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_launcher_sparse_on_the_card(cuda_device, tmp_path, capsys):
    """``--sparse --save-artifact`` and ``--temperature`` through the serve
    launcher on the card at smoke width."""
    from repro_torch.launch import serve
    from repro_torch.sparse.bank import MaskBank
    serve.main(["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
                "--prompt-len", "32", "--gen", "6", "--sparse",
                "--save-artifact", str(tmp_path / "bank"),
                "--temperature", "0.8"])
    out = capsys.readouterr().out
    assert "saved mask bank" in out and "sample continuation" in out
    bank = MaskBank.load(tmp_path / "bank", device="cpu")
    assert bank.meta["steps_run"] == 30 and bank.pcfg.mode == "nm"


# --- training on the card ----------------------------------------------------

def _global_rel(a, b, base=None) -> float:
    """||a - b|| / ||b - base|| over the leaves of two trees, in f64."""
    from repro_torch import tree
    num = den = 0.0
    bl = tree.leaves(base) if base is not None else None
    for i, (x, y) in enumerate(zip(tree.leaves(a), tree.leaves(b),
                                   strict=True)):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        num += float(((x - y) ** 2).sum())
        ref = y - bl[i].cpu().double() if bl is not None else y
        den += float((ref ** 2).sum())
    return (num / den) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b"])
def test_train_step_card_matches_cpu(cuda_device, arch):
    """3 AdamW steps of the smoke model (remat on, accum 2) on the card
    against the CPU from the same weights, at the CPU parity tests'
    tolerances against the jitted reference (tests/test_torch_train.py:
    the card's bf16 matmuls round in other places than the CPU's, as the
    reference's do): loss rtol 2e-3 / 1e-2 (dense / MoE), grad_norm 1e-2
    / 3e-2, params within 2e-4 of their norm and 0.12 of the update, the
    moments within 2e-2 / 0.2."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    dense = arch == "llama3.2-1b"
    cfg = get_smoke_config(arch)
    p0 = M.init_params(cfg, 0, device="cpu")
    ocfg = opt.AdamWConfig(lr=3e-4, total_steps=3, warmup_steps=1)
    step = make_train_step(cfg, ocfg, accum=2, remat=True)
    runs = []
    for dev in ("cpu", cuda_device):
        params = tree.to_device(tree.tree_map(torch.clone, p0), dev)
        state = opt.adamw_init(params)
        mets = []
        for b in batches_for(cfg, n=3, batch=4, seq=32, split="train"):
            params, state, m = step(params, state, b)
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        assert tree.device_of(params).type == torch.device(dev).type
        runs.append((params, state, mets))
    (cp, cs, cm), (gp, gs, gm) = runs
    for (l0, g0), (l1, g1) in zip(cm, gm):
        assert abs(l1 / l0 - 1) <= (2e-3 if dense else 1e-2)
        assert abs(g1 / g0 - 1) <= (1e-2 if dense else 3e-2)
    assert int(gs.count) == 3 and gs.count.is_cuda
    assert _global_rel(gp, cp) <= 2e-4
    assert _global_rel(gp, cp, base=p0) <= 0.12
    assert max(_global_rel(gs.mu, cs.mu), _global_rel(gs.nu, cs.nu)) <= \
        (2e-2 if dense else 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x22b"])
def test_remat_gradients_equal_no_remat_on_the_card(cuda_device, arch):
    """Under ``torch.use_deterministic_algorithms`` (the embedding's and
    the log-softmax gather's backward accumulate with atomics otherwise),
    remat's gradients equal no remat's bit for bit on the card."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.models import model as M
    from repro_torch.optim.losses import lm_loss
    cfg = get_smoke_config(arch)
    params = M.init_params(cfg, 0, device=cuda_device)
    tokens = torch.from_numpy(batches_for(cfg, n=1, batch=4, seq=64,
                                          split="train")[0]["tokens"])
    grads = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            leaves = [x.detach().requires_grad_(True)
                      for x in tree.leaves(params)]
            W = tree.unflatten_like(params, leaves)
            loss, met = lm_loss(cfg, W, {"tokens": tokens}, remat=remat)
            grads.append((loss.detach(), met["aux"].detach(),
                          torch.autograd.grad(loss, leaves)))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, a0, g0), (l1, a1, g1) = grads
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for x, y in zip(g0, g1, strict=True):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    """``save_async`` of CUDA tensors, then an in-place update that must not
    reach the saved bytes; the restore lands on the template's card."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.optim import optimizers as opt
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"w": torch.randn((1024, 512), generator=g,
                               device=cuda_device),
              "b": [torch.randn((512,), generator=g, device=cuda_device)]}
    state = (params, opt.adamw_init(params))
    want = [x.cpu().clone() for x in (params["w"], params["b"][0])]
    mgr = CheckpointManager(tmp_path)
    mgr.save_async(3, state, metadata={"next_step": 3})
    params["w"].add_(1.0)
    params["b"][0].mul_(2.0)
    state[1].count += 5
    mgr.close()
    (rp, rs), meta = mgr.restore(state)
    assert meta == {"next_step": 3}
    assert rp["w"].is_cuda and rs.count.is_cuda and int(rs.count) == 0
    assert torch.equal(rp["w"].cpu(), want[0])
    assert torch.equal(rp["b"][0].cpu(), want[1])
    assert not rs.mu["w"].any()


# ---------------------------------------------------------------------------
# The flight recorder on the card: fences, and CUDA graph captures
# ---------------------------------------------------------------------------

@pytest.fixture
def recorder():
    from repro_torch import obs
    obs.reset()
    obs.configure()
    yield obs
    obs.reset()


@pytest.mark.cuda
def test_obs_fence_waits_for_the_card(cuda_device, recorder):
    """``sp.fence(x)`` synchronises the device that holds x before the
    span's clock stops: the queued work has finished when the span ends,
    and the span's time covers it."""
    x = torch.randn((4096, 4096), device=cuda_device)
    torch.cuda.synchronize()
    with recorder.span("matmul") as sp:
        for _ in range(8):
            y = x @ x
        sp.fence({"out": [y]})
    assert torch.cuda.current_stream().query()
    with recorder.span("queued") as bare:
        for _ in range(8):
            y = x @ x
    torch.cuda.synchronize()
    assert sp.seconds > bare.seconds
    with recorder.timer("t", fence=(y,)) as t:
        y = x @ x
    assert torch.cuda.current_stream().query() and t.seconds > 0


@pytest.mark.cuda
def test_obs_fence_inside_a_capture_does_not_raise(cuda_device, recorder):
    """A fence reached while a stream captures a CUDA graph waits for
    nothing (a synchronisation would end the capture); the graph replays
    what was captured."""
    x = torch.ones((64, 64), device=cuda_device)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x @ x
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        with recorder.span("captured") as sp:
            y = x @ x
            sp.fence(y)
    graph.replay()
    torch.cuda.synchronize()
    assert float(y[0, 0]) == 64.0


@pytest.mark.cuda
@pytest.mark.parametrize("kv_shards", [None, 4])
def test_obs_recorder_on_graph_engines(cuda_device, recorder, monkeypatch,
                                       kv_shards):
    """With the recorder on, the graph engine and spec's draft and verify
    graphs capture as they do with it off: no event is emitted while a
    stream captures, the streams equal the recorder-off run's, one
    ``serve.decode_step_ms`` observation a decode step, and
    ``dist.psum{site=attn_kv}`` counted at the decode graph's capture
    only (2 at ``kv_shards=4``: llama's one scanned call site)."""
    from repro_torch.obs import core
    from repro_torch.serve.spec import SpecDecoder
    cfg, params, sparse = _smoke_members(cuda_device)
    prompts = _engine_prompts(cfg)
    recorder.disable()
    _, want = _serve(cfg, params, cuda_device, prompts, kv_shards=kv_shards)
    recorder.configure()
    captured = []
    emit = core.emit
    monkeypatch.setattr(core, "emit", lambda e: captured.append(
        torch.cuda.is_current_stream_capturing()) or emit(e))
    eng, got = _serve(cfg, params, cuda_device, prompts,
                      kv_shards=kv_shards, labels={"budget": "0.0"})
    assert got == want
    assert eng.fns.capture_counts() == {"decode": 1}
    h = recorder.summary()["histograms"]['serve.decode_step_ms{budget="0.0"}']
    assert h["count"] == eng.decode_steps
    psum = recorder.counter_value("dist.psum", site="attn_kv")
    assert psum == (2 if kv_shards else 0)
    for p, (_, m) in zip(prompts, _ENGINE_REQS):     # replays: no count
        eng.submit(p, m)
    eng.run()
    assert recorder.counter_value("dist.psum", site="attn_kv") == psum
    if kv_shards is None:
        from repro_torch.serve.engine import ServeEngine
        d, v = (ServeEngine(cfg, p, slots=2, capacity=48, device=cuda_device)
                for p in (sparse, params))
        sd = SpecDecoder(d, v, k=2, adaptive=False)
        rids = [sd.submit(p, m) for p, (_, m) in zip(prompts, _ENGINE_REQS)]
        res, _ = sd.run()
        assert [res[r] for r in rids] == want
        assert d.fns.capture_counts() == {"draft_2": 1}
        assert v.fns.capture_counts() == {"verify_2": 1}
    assert captured and not any(captured)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("whisper-small", None),
                                  ("whisper-small", 1),
                                  ("whisper-small", 4),
                                  ("pixtral-12b", None),
                                  ("pixtral-12b", 1)], ids=str)
def test_encdec_and_vision_decode_card_matches_cpu(cuda_device, case):
    """The smoke whisper (the encoder over stub frames, the decoder's
    self ring and cross cache) and pixtral (the image prefix) 2:4 through
    the launcher's loop on the card and on the CPU: teacher-forced logits
    within 8 bf16 ulps of each row's max, greedy streams equal, every
    projection through ``nm_matmul`` and every decode attention through
    the ``kv_shards`` path's kernels, a decode step replayed from a CUDA
    graph == eager."""
    from repro_torch import tree
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.calibrate import baseline_masks
    from repro_torch.data.synthetic import batches_for
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_partial)
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M
    from repro_torch.sparse.apply import sparsify_params
    arch, kv_shards = case
    cfg = get_smoke_config(arch)
    p_cpu = M.init_params(cfg, 0, device="cpu")
    masks = baseline_masks("magnitude", p_cpu, tree.tree_map(
        lambda _: None, p_cpu), 0.5, mode="nm")
    p_cpu = M.serving_params(sparsify_params(
        p_cpu, masks, axes=M.param_axes(cfg), idx_bits=2,
        dtype=torch.bfloat16))
    p_card = tree.to_device(p_cpu, cuda_device)
    batch = batches_for(cfg, n=1, batch=2, seq=16, split="valid")[0]
    gen = 8
    off = cfg.num_image_tokens
    C = 16 + gen + off
    runs = {}
    for dev, params in (("cpu", p_cpu), (cuda_device, p_card)):
        nm0 = nm_matmul.launches
        fd0 = flash_decode.launches + flash_decode_partial.launches
        with torch.inference_mode():
            logits, caches = M.prefill(cfg, params, batch, cache_capacity=C)
            out = [logits.float().cpu()]
            tok = logits.argmax(-1) if dev == "cpu" else \
                runs["cpu"][1][0].to(cuda_device)
            fed = [tok.cpu()]
            for i in range(gen - 1):
                logits, caches = M.decode_step(cfg, params, tok, caches,
                                               16 + off + i,
                                               kv_shards=kv_shards)
                out.append(logits.float().cpu())
                tok = logits.argmax(-1) if dev == "cpu" else \
                    runs["cpu"][1][i + 1].to(cuda_device)
                fed.append(tok.cpu())
        runs["cpu" if dev == "cpu" else "card"] = (out, fed, caches)
        if dev != "cpu":
            per_fwd = {"whisper-small": (7 * cfg.encoder_layers
                                         + 11 * cfg.num_layers,
                                         9 * cfg.num_layers),
                       "pixtral-12b": (7 * cfg.num_layers,
                                       7 * cfg.num_layers)}[arch]
            assert nm_matmul.launches - nm0 == per_fwd[0] + per_fwd[1] * (
                gen - 1)
            attn = (2 if cfg.is_encoder_decoder else 1) * cfg.num_layers
            assert (flash_decode.launches + flash_decode_partial.launches
                    - fd0) == (attn * (gen - 1) if kv_shards else 0)
    for i, (a, b) in enumerate(zip(runs["cpu"][0], runs["card"][0])):
        tol = 8 * 2 ** -8 * a.abs().amax(-1)
        assert bool(((b - a).abs().amax(-1) <= tol).all()), i
    want = generate(cfg, p_cpu, batch, gen)[0]
    got = generate(cfg, p_card, batch, gen, kv_shards=kv_shards)[0]
    assert torch.equal(got, want)
    # one decode step captured in a CUDA graph == the eager step
    caches = runs["card"][2]
    tok = runs["card"][1][-1].to(cuda_device)
    t = torch.full((2,), 16 + off + gen, dtype=torch.int32,
                   device=cuda_device)

    def step():
        return M.decode_step(cfg, p_card, tok, caches, t,
                             kv_shards=kv_shards)[0]
    with torch.inference_mode():
        want_l = step().clone()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got_l = step()
        got_l.zero_()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(got_l, want_l)


# Tensor parallelism (dist, kernels/shard.py): the kernels at the
# shard-local shapes a rank launches.  (M, K, N, out): llama3.2-1b at its
# published widths on (1, 4): wq / wk / wv and up / gate N-split (whole K,
# bf16 out), wo K 512 and down K 2048 K-split (f32 partials); on (2, 2):
# wq / wk / wv / up / gate K 1024 and N halved, wo K 1024, down K 4096
# (f32 partials); decode (M 4) and a prefill's rows (M 127)
_TP_SHAPES = [(4, 2048, 512, "bf16"), (4, 2048, 128, "bf16"),
              (4, 2048, 2048, "bf16"), (4, 512, 2048, "f32"),
              (4, 2048, 2048, "f32"), (4, 1024, 1024, "f32"),
              (4, 1024, 256, "f32"), (4, 1024, 4096, "f32"),
              (4, 4096, 1024, "f32"), (127, 512, 2048, "f32"),
              (127, 1024, 4096, "f32")]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", _TP_SHAPES, ids=str)
def test_nm_matmul_at_shard_local_shapes(cuda_device, mkn):
    """bf16 x and vals, packed2, into the bf16 result of an N-split block
    or the f32 partial of a K-split one, against the plain version."""
    M, K, N, out = mkn
    g = torch.Generator().manual_seed(M + K + N)
    vals, idx = ref.compress_24(torch.randn((K, N), generator=g))
    plane = _pack_idx2(idx)
    x = (0.1 * torch.randn((M, K), generator=g)).to(torch.bfloat16)
    v = vals.to(torch.bfloat16)
    out_dtype = torch.float32 if out == "f32" else None
    want = nm_matmul_plain(x, v, plane, layout=LAYOUT_PACKED2,
                           out_dtype=out_dtype)
    got = nm_matmul(x.to(cuda_device), v.to(cuda_device),
                    plane.to(cuda_device), layout=LAYOUT_PACKED2,
                    out_dtype=out_dtype).cpu()
    tol = 1e-4 if out == "f32" else 2e-2
    assert got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


# (E, M, K, N): mixtral-8x22b's banks on (1, 4): up / gate N-split (K
# 6144, N 4096), down K-split (K 4096, N 6144); on (2, 2): up / gate K 3072
# N 8192, down K 8192 N 3072; all f32 partials but the N-split pair's
@pytest.mark.cuda
@pytest.mark.parametrize("emkn", [(8, 4, 6144, 4096, "bf16"),
                                  (8, 4, 4096, 6144, "f32"),
                                  (8, 4, 3072, 8192, "f32"),
                                  (8, 4, 8192, 3072, "f32")], ids=str)
def test_nm_matmul_expert_at_shard_local_shapes(cuda_device, emkn):
    E, M, K, N, out = emkn
    g = torch.Generator().manual_seed(E + M + K + N)
    w = torch.randn((E, K, N), generator=g)
    parts = [ref.compress_24(w[e]) for e in range(E)]
    vals = torch.stack([p[0] for p in parts]).to(torch.bfloat16)
    plane = _pack_idx2(torch.stack([p[1] for p in parts]))
    x = (0.1 * torch.randn((E, M, K), generator=g)).to(torch.bfloat16)
    out_dtype = torch.float32 if out == "f32" else None
    want = nm_matmul_expert_plain(x, vals, plane, layout=LAYOUT_PACKED2,
                                  out_dtype=out_dtype)
    got = nm_matmul_expert(x.to(cuda_device), vals.to(cuda_device),
                           plane.to(cuda_device), layout=LAYOUT_PACKED2,
                           out_dtype=out_dtype).cpu()
    tol = 1e-4 if out == "f32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_partial_per_rank_then_combine(cuda_device, ranks,
                                                    dtype):
    """Each rank's capacity shard (llama serving: B 4, 8 kv x 4 of 64, C
    256) through ``flash_decode_partial`` alone, the ranks' max and
    rescaled sums (the all-reduces), then the combine kernel on the one
    combined state (its rescale exp(0) = 1): within the decode tolerance
    of the plain attention over the whole ring."""
    from repro_torch.kernels.flash_decode import (combine_partials,
                                                  flash_decode_partial)
    B, K, G, D, C = 4, 8, 4, 64, 256
    q, k, v, bias = _decode_operands(ranks, B, K, G, D, C, dtype,
                                     cuda_device, [C - 1, 20, 130, 0])
    n = C // ranks
    parts = [flash_decode_partial(q, k[:, r * n:(r + 1) * n].contiguous(),
                                  v[:, r * n:(r + 1) * n].contiguous(),
                                  bias[:, r * n:(r + 1) * n].contiguous())
             for r in range(ranks)]
    mg = torch.stack([m for _, m, _ in parts]).amax(0)
    l = sum(l * torch.exp(m - mg) for _, m, l in parts)
    acc = sum(a * torch.exp(m - mg) for a, m, _ in parts)
    got = combine_partials(acc, mg, l, dtype)
    want = ref.flash_decode_ref(q, k, v, bias).float()
    terms = ref.flash_decode_ref(q, k, v.abs(), bias).float()
    assert got.dtype == dtype and got.shape == (B, K, G, D)
    assert bool(((got.float() - want).abs()
                 <= _decode_tol(want, terms, dtype)).all())


@pytest.mark.cuda
def test_tp_engine_over_gloo_on_one_card(cuda_device):
    """2 ranks on this card over gloo, smoke llama 2:4 on (1, 2): eager,
    the streams of the single-process engine at kv_shards 2; a graph
    surface refused, naming the backend."""
    import _torch_tp_ranks as R
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.serve.engine import ServeEngine, eager
    cfg, sp = R.sparse_smoke("llama3.2-1b")
    ps = R.prompts("llama", cfg.vocab_size)
    e = ServeEngine(cfg, sp, slots=R.SLOTS, capacity=R.CAPACITY,
                    device=cuda_device, kv_shards=2)
    rids = [e.submit(p, R.GEN) for p in ps]
    with eager():
        out = e.run()
    want = [out[r] for r in rids]
    got = run_ranks(R.gloo_card_rank, 2, device="cuda", backend="gloo",
                    timeout=120.0, deadline=300.0)
    for streams, refused in got:
        assert streams == want
        assert "gloo" in refused and "eager()" in refused


@pytest.mark.cuda
def test_sharded_search_over_gloo_on_one_card(cuda_device):
    """2 ranks on this card over gloo: tests/test_calibrate.py's STACKED
    shape, wanda 2:4 for 3 steps on (1, 2), each rank's blocks through
    ``saliency_fused_step``, ``prox24`` and ``nm_mask24``: the gathered
    Gamma and V within rtol 1e-5 / atol 1e-7 of the single-process card
    search, the 2:4 masks and the history's loss equal."""
    import _torch_calib_ranks as R
    from repro_torch import tree
    from repro_torch.core import calibrate as C
    from repro_torch.core import mirror
    from repro_torch.dist.ranks import run_ranks
    cfg, params, batches = R.inputs("stacked")
    params = tree.to_device(params, cuda_device)
    pcfg = R.pcfg_for("wanda", 3)
    stats = C.collect_stats(cfg, params, batches)
    state, hist = C.run_search(cfg, pcfg, params, batches, stats,
                               log_every=1)
    masks = mirror.export_masks(pcfg, state.Gamma, 0.5, V=state.V)
    got = run_ranks(R.card_rank, 2, device="cuda", backend="gloo",
                    timeout=120.0, deadline=300.0)
    for name, want in (("Gamma", state.Gamma), ("V", state.V),
                       ("masks", masks)):
        for path, w in tree.flatten_with_path(want):
            if w is None:
                continue
            g, w = got[0][name][path], w.cpu().numpy()
            if name == "masks":
                np.testing.assert_array_equal(g.astype(bool), w, path)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                           err_msg=name + path)
    for r in got:
        assert [h["loss"] for h in r["history"]] == [h["loss"] for h in hist]


@pytest.mark.cuda
def test_sharded_train_step_over_gloo_on_one_card(cuda_device):
    """2 ranks on this card over gloo: smoke llama's 2 AdamW steps with
    remat on (1, 2), each rank's params and AdamW state its blocks (the
    layers' recomputation runs on autograd's device thread, under the
    forward's rules): the gathered state and every step's loss and
    grad_norm equal the single-process card step's bit for bit."""
    import _torch_train_ranks as R
    from repro_torch.ckpt.checkpoint import flatten_state
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.dist.ranks import run_ranks
    from repro_torch.models import model as M
    from repro_torch.optim import optimizers as opt
    cfg = get_smoke_config(R.ARCHS["llama"])
    params = M.init_params(cfg, 0, device=cuda_device)
    params, ostate, metrics = R.train(
        cfg, None, R.batches(cfg)[:R.STEPS],
        state=(params, opt.adamw_init(params)))
    got = run_ranks(R.card_rank, 2, device="cuda", backend="gloo",
                    timeout=120.0, deadline=300.0)
    for r in got:
        assert r["metrics"] == metrics
    for path, w in flatten_state((params, ostate)):
        np.testing.assert_array_equal(got[0]["state"][path],
                                      w.cpu().numpy(), err_msg=path)
