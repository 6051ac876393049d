"""2:4 compressed matmul: ``x (M, K) @ W (K, N)`` with W pruned 2:4 along K,
and its expert-banked form ``x (E, M, K) @ W (E, K, N)``.

Port of ``repro.kernels.nm_spmm.nm_matmul`` and ``nm_matmul_expert``.  W is
given compressed as ``vals`` (K/2, N), the two kept values of every group
of 4 along K, and their in-group positions in one of two index layouts:

  LAYOUT_INT8:    idx (K/2, N) int8, one position per byte
  LAYOUT_PACKED2: idx (K/8, N) uint8, bits 2j..2j+1 of byte row r hold the
                  position of compressed row 4r+j

For CUDA tensors :func:`nm_matmul` and :func:`nm_matmul_expert` launch the
hand-written kernels in ``csrc/nm_spmm.cu``, chosen by dtype: bf16 x and
vals (the serving paths) run the ``mma.sp`` kernel on the sparse tensor
cores; f32 x and vals run the SIMT kernel (f32 FMAs), so f32 results are
those of the f32 arithmetic.  Both accumulate in f32, fold the expert axis
into the grid and split K across blocks, in one launch, when the grid is
small (see the source for the design and its bound).  A kernel that fails
to build or launch raises; nothing gives way to another kernel.  For CPU
tensors they run :func:`nm_matmul_plain` and :func:`nm_matmul_expert_plain`,
the decompress-then-matmul versions the tests and ``chip_smoke.py`` hold
the kernels against.  The expert axis leads every operand.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.observe import kernel, plain_devices

LAYOUT_INT8 = "int8"
LAYOUT_PACKED2 = "packed2"

_BN = 64                  # output columns per block, both kernels
_SIMT_BM = 16             # the f32 kernel's rows of x per block
_MIN_SPLIT_GROUPS = 64    # 2:4 groups an f32 split-K slice covers at least
_MMA_KC = 128             # K per pipeline stage of the bf16 kernel
_MAX_GRID_Z = 65535       # experts x row tiles share the grid's z dimension
_MAX_TILES = 1024         # split-K arrival counters per device


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


def _check_plane(K: int, N: int, idx_shape: tuple[int, ...],
                 layout: str | None) -> str:
    """Layout of one (expert's) index plane, checked against (K, N)."""
    layout = infer_layout(K, idx_shape) if layout is None else layout
    if layout == LAYOUT_PACKED2:
        if K % 8 or idx_shape != (K // 8, N):
            raise ValueError(f"packed2 index plane must be (K/8, N) = "
                             f"({K // 8}, {N}) with K % 8 == 0, got "
                             f"{idx_shape}")
    elif layout == LAYOUT_INT8:
        if idx_shape != (K // 2, N):
            raise ValueError(f"int8 index plane must be (K/2, N) = "
                             f"({K // 2}, {N}), got {idx_shape}")
    else:
        raise ValueError(f"unknown index layout {layout!r}")
    return layout


def _check_shapes(x, vals, idx, layout, *, experts: bool = False):
    """(E, M, K, N, layout), E = 1 for the 2-D product."""
    nd = 3 if experts else 2
    name = "nm_matmul_expert" if experts else "nm_matmul"
    if x.dim() != nd or vals.dim() != nd or idx.dim() != nd:
        raise ValueError(f"{name} takes {nd}-D x, vals and idx, got "
                         f"{tuple(x.shape)}, {tuple(vals.shape)}, "
                         f"{tuple(idx.shape)}")
    E = x.shape[0] if experts else 1
    if experts and not (vals.shape[0] == idx.shape[0] == E):
        raise ValueError(f"{name}: expert axes of x {tuple(x.shape)}, vals "
                         f"{tuple(vals.shape)} and idx {tuple(idx.shape)} "
                         "differ")
    M, K = x.shape[-2:]
    half_k, N = vals.shape[-2:]
    if half_k * 2 != K or K % 4:
        raise ValueError(f"x {tuple(x.shape)} does not match vals "
                         f"{tuple(vals.shape)} (need K = 2 * vals rows, "
                         "K % 4 == 0)")
    return E, M, K, N, _check_plane(K, N, tuple(idx.shape[-2:]), layout)


def nm_matmul_plain(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                    *, layout: str | None = None,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Decompress, then one dense matmul: the kernel's plain version."""
    *_, layout = _check_shapes(x, vals, idx, layout)
    pos = unpack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    if out_dtype in (None, x.dtype):
        return ref.nm_matmul_ref(x, vals, pos)
    # the f32 accumulator leaves as is (the reference's out_dtype)
    return (x.float() @ ref.decompress_24(vals, pos).float()).to(out_dtype)


def nm_matmul_expert_plain(x: torch.Tensor, vals: torch.Tensor,
                           idx: torch.Tensor, *, layout: str | None = None,
                           out_dtype: torch.dtype | None = None
                           ) -> torch.Tensor:
    """Decompress every expert, then one batched matmul: the expert
    kernel's plain version.  One ``torch.bmm`` in x.dtype, the op the
    masked-dense expert path (``models.common.expert_dense``) runs on the
    dense bank, so compressed and masked-dense serving agree bit for bit
    on the CPU, as one interpret-mode tile per expert does in the
    reference."""
    *_, layout = _check_shapes(x, vals, idx, layout, experts=True)
    pos = unpack_idx2(idx) if layout == LAYOUT_PACKED2 else idx
    w = ref.decompress_24(vals, pos)
    if out_dtype in (None, x.dtype):
        return torch.bmm(x, w.to(x.dtype))
    return torch.bmm(x.float(), w.float()).to(out_dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mma_rows(M: int) -> int:
    """The bf16 kernel's rows of x per block for M rows (more than 64 rows
    take several row tiles)."""
    return next((b for b in (8, 16, 32, 40) if M <= b), 64)


def split_k(M: int, K: int, N: int, sm_count: int, experts: int = 1,
            bf16: bool = True) -> tuple[int, int]:
    """(blocks along K, K stages per block): enough for ~2 blocks per SM
    when the expert x N x M grid alone is smaller.  bf16: each slice covers
    whole 128-deep stages and the f32 partials written and read stay under
    half the compressed weight's bytes (M N 8 per slice against 1.125 K N):
    the last block's pass over them is the split's serial tail; f32: each
    slice covers >= 64 groups of 4 (stages counted in groups)."""
    if not bf16:
        blocks = experts * -(-N // _BN) * -(-M // _SIMT_BM)
        want = -(-2 * sm_count // blocks)
        return max(1, min(want, (K // 4) // _MIN_SPLIT_GROUPS)), 0
    blocks = experts * -(-N // _BN) * -(-M // mma_rows(M))
    stages = -(-K // _MMA_KC)
    want = -(-2 * sm_count // blocks)
    ksplit = max(1, min(want, stages, 9 * K // (128 * M)))
    per = -(-stages // ksplit)
    return -(-stages // per), per


_COUNTERS: dict = {}


def _tile_counters(device: torch.device) -> torch.Tensor:
    """The device's split-K arrival counters: zeroed once here, and left
    zero by every launch (the last block at a tile resets its counter).
    Split-K launches on one device share them, so they run on one stream
    at a time."""
    c = _COUNTERS.get(device)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("nm_matmul: the split-K tile counters are "
                               "made at the first eager launch on a device;"
                               " launch once before capturing a CUDA graph")
        c = _COUNTERS[device] = torch.zeros(_MAX_TILES, dtype=torch.int32,
                                            device=device)
    return c


def _launch(name: str, x, vals, idx, E: int, M: int, K: int, N: int,
            layout: str, out_dtype) -> torch.Tensor:
    """Validate CUDA operands (E, M, K) / (E, K/2, N) / (E, ., N) and launch
    the kernel over E experts -> (E, M, N)."""
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.bfloat16, torch.float32) or vals.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes bf16 or f32 x and vals of one "
                        f"dtype, got {x.dtype} and {vals.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{name} kernel writes {x.dtype} or float32, not "
                        f"{out_dtype}")
    packed = layout == LAYOUT_PACKED2
    want_idx = torch.uint8 if packed else torch.int8
    if idx.dtype != want_idx:
        raise TypeError(f"{layout} index plane must be {want_idx}, got "
                        f"{idx.dtype}")
    if not (x.is_contiguous() and vals.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous x, vals and idx")
    if N % 2 or vals.data_ptr() % (2 * vals.element_size()) \
            or x.data_ptr() % 4 or idx.data_ptr() % 2:
        raise ValueError(f"{name} kernel reads column pairs: N must be even "
                         "and x/vals/idx aligned to a pair")
    bf16 = x.dtype == torch.bfloat16
    rows = mma_rows(M) if bf16 else _SIMT_BM
    if E * -(-M // rows) > _MAX_GRID_Z:
        raise ValueError(f"{name}: {E} experts x {-(-M // rows)} row tiles "
                         f"exceed the grid's {_MAX_GRID_Z} z-blocks")
    out = torch.empty((E, M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    ksplit, per = split_k(M, K, N, _sm_count(x.device.index), experts=E,
                          bf16=bf16)
    ws = counters = None
    if ksplit > 1:
        tiles = E * -(-N // _BN) * -(-M // rows)
        if tiles > _MAX_TILES:
            raise ValueError(f"{name}: {tiles} output tiles split along K "
                             f"exceed the {_MAX_TILES} counters")
        ws = torch.empty((ksplit, E, M, N), dtype=torch.float32,
                         device=x.device)
        counters = _tile_counters(x.device)
    from repro_torch.kernels._build import library
    err = library("nm_spmm").repro_nm_matmul_expert(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), E, M, K, N,
        int(bf16), int(out_dtype == torch.bfloat16), int(packed), ksplit,
        per, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True for CPU operands (the plain version; meta ones too while
    ``kernels.observe`` records); CUDA operands on one device go to the
    kernel; anything else raises."""
    kinds = {t.device.type for t in ts}
    if len(kinds) == 1 and kinds <= set(plain_devices()):
        return True
    if kinds != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name}: x, vals and idx must lie on one device, "
                         f"got {', '.join(str(t.device) for t in ts)}")
    return False


@kernel("nm_matmul")
def nm_matmul(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor, *,
              layout: str | None = None,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x: (M, K) @ 2:4-compressed W (K, N) -> (M, N) in x.dtype.

    layout: LAYOUT_INT8 or LAYOUT_PACKED2; None infers it from the index
    plane's shape.  out_dtype: output dtype override, float32 for the raw
    f32 accumulator (default x.dtype).

    CPU tensors take :func:`nm_matmul_plain`.  CUDA tensors launch a
    kernel (``nm_matmul.launches`` counts each launch) or raise: x and vals
    bf16 (the ``mma.sp`` kernel) or f32 (the SIMT kernel) of one dtype, idx
    uint8 (packed2) or int8, all contiguous on one device, N even.
    """
    if _on_cpu("nm_matmul", x, vals, idx):
        return nm_matmul_plain(x, vals, idx, layout=layout,
                               out_dtype=out_dtype)
    _, M, K, N, layout = _check_shapes(x, vals, idx, layout)
    out = _launch("nm_matmul", x[None], vals[None], idx[None], 1, M, K, N,
                  layout, out_dtype)[0]
    nm_matmul.launches += 1
    return out


nm_matmul.launches = 0


@kernel("nm_matmul_expert")
def nm_matmul_expert(x: torch.Tensor, vals: torch.Tensor, idx: torch.Tensor,
                     *, layout: str | None = None,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Per-expert batch x: (E, M, K) @ 2:4-compressed bank (E, K, N)
    -> (E, M, N) in x.dtype (float32 with ``out_dtype``).

    vals (E, K/2, N); idx (E, K/8, N) uint8 packed2 or (E, K/2, N) int8.
    CPU tensors take :func:`nm_matmul_expert_plain`.  CUDA tensors launch
    the kernel once for every expert (``nm_matmul_expert.launches`` counts
    each launch) or raise, on the terms of :func:`nm_matmul`.
    """
    if _on_cpu("nm_matmul_expert", x, vals, idx):
        return nm_matmul_expert_plain(x, vals, idx, layout=layout,
                                      out_dtype=out_dtype)
    E, M, K, N, layout = _check_shapes(x, vals, idx, layout, experts=True)
    out = _launch("nm_matmul_expert", x, vals, idx, E, M, K, N, layout,
                  out_dtype)
    nm_matmul_expert.launches += 1
    return out


nm_matmul_expert.launches = 0
