"""2:4 compressed matmul: ``x (M, K) @ W (K, N)`` with W pruned 2:4 along K.

Port of ``repro.kernels.nm_spmm.nm_matmul``.  W is given compressed as
``vals`` (K/2, N), the two kept values of every group of 4 along K, and
their in-group positions in one of two index layouts:

  LAYOUT_INT8:    idx (K/2, N) int8, one position per byte
  LAYOUT_PACKED2: idx (K/8, N) uint8, bits 2j..2j+1 of byte row r hold the
                  position of compressed row 4r+j

For CUDA tensors :func:`nm_matmul` launches the hand-written kernel in
``csrc/nm_spmm.cu`` (one thread per pair of output columns, f32
accumulation, split-K when the grid is small; see the source for the
design and its bound).  For CPU tensors it runs :func:`nm_matmul_plain`,
the decompress-then-matmul version the tests and ``chip_smoke.py`` hold the
kernel against.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref

LAYOUT_INT8 = "int8"
LAYOUT_PACKED2 = "packed2"

_BN, _BM = 64, 16        # the kernel's column and row tile (nm_spmm.cu)
_MIN_SPLIT_GROUPS = 64   # 2:4 groups a split-K slice covers at least


def unpack_idx2(packed: torch.Tensor) -> torch.Tensor:
    """(..., rows, n) uint8 packed codes -> (..., rows*4, n) int8 positions.

    Byte row r carries compressed rows 4r..4r+3 in bit pairs 2j..2j+1.
    """
    *lead, rows, n = packed.shape
    p = packed.to(torch.int32)
    out = torch.stack([(p >> (2 * j)) & 0x3 for j in range(4)], dim=-2)
    return out.reshape(*lead, rows * 4, n).to(torch.int8)


def infer_layout(K: int, idx_shape: tuple[int, ...]) -> str:
    """Index-plane layout from shapes alone (K/2 rows -> int8, K/8 ->
    packed2)."""
    if idx_shape[-2] * 2 == K:
        return LAYOUT_INT8
    if idx_shape[-2] * 8 == K:
        return LAYOUT_PACKED2
    raise ValueError(f"index plane {tuple(idx_shape)} matches no layout "
                     f"for K={K}")


def _check_shapes(x, vals, idx, layout):
    if x.dim() != 2 or vals.dim() != 2 or idx.dim() != 2:
        raise ValueError("nm_matmul takes 2-D x, vals and idx, got "
                         f"{tuple(x.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(idx.shape)}")
    M, K = x.shape
    half_k, N = vals.shape
    if half_k * 2 != K or K % 4:
        raise ValueError(f"x {tuple(x.shape)} does not match vals "
                         f"{tuple(vals.shape)} (need K = 2 * vals rows, "
                         "K % 4 == 0)")
    layout = infer_layout(K, tuple(idx.shape)) if layout is None else layout
    if layout == LAYOUT_PACKED2:
        if K % 8 or tuple(idx.shape) != (K // 8, N):
            raise ValueError(f"packed2 index plane must be (K/8, N) = "
                             f"({K // 8}, {N}) with K % 8 == 0, got "
                             f"{tuple(idx.shape)}")
    elif layout == LAYOUT_INT8:
        if tuple(idx.shape) != (half_k, N):
            raise ValueError(f"int8 index plane must be (K/2, N) = "
                             f"({half_k}, {N}), got {tuple(idx.shape)}")
    else:
        raise ValueError(f"unknown index layout {layout!r}")
    return M, K, N, layout


def nm_matmul_plain(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                    *, layout: str | None = None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Decompress, then one dense matmul: the kernel's plain version."""
    _, _, _, layout = _check_shapes(x, vals, idx, layout)
    pos = unpack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    if out_dtype in (None, x.dtype):
        return ref.nm_matmul_ref(x, vals, pos)
    # the f32 accumulator leaves as is (the reference's out_dtype)
    return (x.float() @ ref.decompress_24(vals, pos).float()).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_k(M: int, K: int, N: int, sm_count: int) -> int:
    """Blocks along K: enough for ~2 blocks per SM when the N x M grid
    alone is smaller, each still covering >= 64 groups of 4."""
    blocks = -(-N // _BN) * -(-M // _BM)
    want = -(-2 * sm_count // blocks)
    return max(1, min(want, (K // 4) // _MIN_SPLIT_GROUPS))


def nm_matmul(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, *,
              layout: str | None = None,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: (M, K) @ 2:4-compressed W (K, N) -> (M, N) in x.dtype.

    layout: LAYOUT_INT8 or LAYOUT_PACKED2; None infers it from the index
    plane's shape.  out_dtype: output dtype override, float32 for the raw
    f32 accumulator (default x.dtype).

    CPU tensors take :func:`nm_matmul_plain`.  CUDA tensors launch the
    kernel (``nm_matmul.launches`` counts each launch) or raise: x and vals
    bf16 or f32 of one dtype, idx uint8 (packed2) or int8, all contiguous
    on one device, N even.
    """
    kinds = {x.device.type, vals.device.type, idx.device.type}
    if kinds == {"cpu"}:
        return nm_matmul_plain(x, vals, idx, layout=layout,
                               out_dtype=out_dtype)
    if kinds != {"cuda"} or not (x.device == vals.device == idx.device):
        raise ValueError("nm_matmul: x, vals and idx must lie on one device, "
                         f"got {x.device}, {vals.device}, {idx.device}")
    M, K, N, layout = _check_shapes(x, vals, idx, layout)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.bfloat16, torch.float32) or vals.dtype != x.dtype:
        raise TypeError(f"nm_matmul kernel takes bf16 or f32 x and vals of "
                        f"one dtype, got {x.dtype} and {vals.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"nm_matmul kernel writes {x.dtype} or float32, "
                        f"not {out_dtype}")
    packed = layout == LAYOUT_PACKED2
    want_idx = torch.uint8 if packed else torch.int8
    if idx.dtype != want_idx:
        raise TypeError(f"{layout} index plane must be {want_idx}, got "
                        f"{idx.dtype}")
    if not (x.is_contiguous() and vals.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("nm_matmul kernel needs contiguous x, vals and idx")
    if N % 2 or vals.data_ptr() % (2 * vals.element_size()) \
            or idx.data_ptr() % 2:
        raise ValueError("nm_matmul kernel reads column pairs: N must be "
                         "even and vals/idx aligned to a pair")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    ksplit = split_k(M, K, N, _sm_count(x.device.index))
    ws = (torch.empty((ksplit, M, N), dtype=torch.float32, device=x.device)
          if ksplit > 1 else None)
    from repro_torch.kernels._build import library
    err = library().repro_nm_matmul(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, K, N,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(packed), ksplit,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"nm_matmul kernel launch failed: CUDA error {err}")
    nm_matmul.launches += 1
    return out


nm_matmul.launches = 0
