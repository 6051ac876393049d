"""Split-KV decode attention: one query token per row against the KV cache.

Port of ``repro.kernels.flash_decode`` and of ``kernels/ops.py:76-89``.
Three wrappers, each running its plain version (``kernels/ref.py``) for
CPU tensors and launching its hand-written kernel (``csrc/flash_decode.cu``)
for CUDA tensors, or raising:

* :func:`flash_decode` - the normalised output, online softmax over the
  whole capacity with f32 probabilities (``flash_decode.py:58``).
* :func:`flash_decode_partial` - the raw f32 (acc, m, l) of each of S
  equal capacity shards, in one launch (``flash_decode.py:140`` on each
  shard; the shards are a grid axis, not devices).
* :func:`combine_partials` - the cross-shard combine of
  ``kernels/shard.py:327-330`` (there a pmax and a psum over the mesh).

Operands: q (B,K,G,D) - the G query heads of each kv head; k and v
(B,C,K,D) - the cache in its own layout; bias (B,C) f32, 0 for a valid
slot and -1e30 for a masked one.  The kernels take f32 or bf16 q/k/v
(one dtype), D in {32, 64, 112, 128, 256}, G in {1, 2, 4, 6, 8} (zamba2's
shared attention: G 1, D 112), v's head dim equal to D, contiguous
operands and 16-byte aligned q, k and v.  Each launches on the current
stream and never synchronises, so a decode step that
calls them can be captured in a CUDA graph.

Inside its one launch, the attention kernel splits each shard's slots
over P blocks that form a thread-block cluster and merge their softmax
states through distributed shared memory (see the source).
:func:`plan_splits` chooses P on the host from the shapes and the SM
count; :func:`split_bounds` lists the slots each block takes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.nm_spmm import _sm_count
from repro_torch.kernels.observe import kernel, plain_devices

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the library of each dtype code: csrc/flash_decode.cu built once for each
# (kernels/_build.py VARIANTS)
_LIBRARY = {0: "flash_decode_f32", 1: "flash_decode_bf16"}
HEAD_DIMS = (32, 64, 112, 128, 256)
GROUPS = (1, 2, 4, 6, 8)
CHUNK = 16          # slots of a warp's ring stage in the kernel (kChunk)
MAX_SPLITS = 8      # the portable cluster size (kMaxSplits)


def plan_splits(B: int, K: int, C: int, S: int, sm_count: int) -> int:
    """P, the capacity splits of each of S shards (a cluster of P blocks
    per shard, kv head and row): doubled from 1 while the doubled grid
    holds at most two blocks per SM, up to ``MAX_SPLITS``, and only while
    every split keeps at least ``CHUNK`` slots."""
    n = C // S
    P = 1
    while (P < MAX_SPLITS and B * K * S * 2 * P <= 2 * sm_count
           and n // (2 * P) >= CHUNK):
        P *= 2
    return P


def split_bounds(C: int, S: int, P: int) -> list[tuple[int, int]]:
    """The slots [lo, hi) of each block, shard by shard and split by split
    in order: split p of shard s takes [s n + p n // P, s n + (p+1) n // P)
    with n = C // S, as the kernel computes them."""
    n = C // S
    return [(s * n + p * n // P, s * n + (p + 1) * n // P)
            for s in range(S) for p in range(P)]


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _check_shapes(name, q, k, v, bias, shards):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or bias.dim() != 2:
        raise ValueError(f"{name} takes q (B,K,G,D), k/v (B,C,K,D) and bias "
                         f"(B,C), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(bias.shape)}")
    B, K, _, D = q.shape
    C = k.shape[1]
    if (k.shape != (B, C, K, D) or v.shape[:3] != (B, C, K)
            or bias.shape != (B, C)):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} and bias {tuple(bias.shape)} "
                         "do not agree")
    if isinstance(shards, bool) or not isinstance(shards, int) \
            or shards < 1 or C % shards:
        raise ValueError(f"{name}: {shards!r} shards do not divide the "
                         f"capacity {C}")


def _kernel_args(name, q, k, v, bias) -> int:
    """Raise on what the kernel does not take; the dtype code."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError(f"{name}: operands on different devices")
    code = _DTYPE_CODES.get(q.dtype)
    if code is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes q, k and v all f32 or all bf16,"
                        f" not {q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes an f32 bias, not {bias.dtype}")
    _, _, G, D = q.shape
    if D not in HEAD_DIMS or G not in GROUPS or v.shape[-1] != D:
        raise ValueError(f"{name} kernel takes D in {HEAD_DIMS}, G in "
                         f"{GROUPS} and v's head dim equal to D, got D={D}, "
                         f"G={G}, Dv={v.shape[-1]}")
    if not all(t.is_contiguous() for t in (q, k, v, bias)):
        raise ValueError(f"{name} kernel needs contiguous operands")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} kernel needs 16-byte aligned q, k and v")
    return code


def _launch(q, k, v, bias, out, acc, m, l, shards, partial, code, scale):
    from repro_torch.kernels._build import library
    B, K, G, D = q.shape
    C = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    splits = plan_splits(B, K, C, shards, _sm_count(q.device.index))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = library(_LIBRARY[code]).repro_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), ptr(out),
        ptr(acc), ptr(m), ptr(l), B, C, K, G, D, shards, splits, code,
        int(partial), scale, _stream(q))
    if err:
        name = "flash_decode_partial" if partial else "flash_decode"
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@kernel("flash_decode")
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor, *, scale: float | None = None
                 ) -> torch.Tensor:
    """Decode attention over the whole capacity: (B,K,G,Dv) in q's dtype.

    ``scale`` defaults to D**-0.5.  CPU tensors: ``ref.flash_decode_ref``;
    CUDA tensors launch the kernel (``flash_decode.launches`` counts each
    launch) or raise."""
    _check_shapes("flash_decode", q, k, v, bias, 1)
    if q.device.type in plain_devices():
        return ref.flash_decode_ref(q, k, v, bias, scale=scale)
    code = _kernel_args("flash_decode", q, k, v, bias)
    out = torch.empty((*q.shape[:3], v.shape[-1]), dtype=q.dtype,
                      device=q.device)
    _launch(q, k, v, bias, out, None, None, None, 1, False, code, scale)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


@kernel("flash_decode_partial")
def flash_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor, *, scale: float | None = None,
                         shards: int = 1):
    """The raw softmax state of each of ``shards`` equal capacity slices,
    f32: acc (S,B,K,G,Dv), m (S,B,K,G,1), l (S,B,K,G,1); shard s is the
    reference's ``flash_decode_partial`` on slots [s C/S, (s+1) C/S).

    CPU tensors: ``ref.flash_decode_shards_ref``; CUDA tensors launch the
    kernel once for all shards (``flash_decode_partial.launches``) or
    raise."""
    _check_shapes("flash_decode_partial", q, k, v, bias, shards)
    if q.device.type in plain_devices():
        return ref.flash_decode_shards_ref(q, k, v, bias, scale=scale,
                                           shards=shards)
    code = _kernel_args("flash_decode_partial", q, k, v, bias)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((shards, *q.shape[:3], v.shape[-1]), **f32)
    m = torch.empty((shards, *q.shape[:3], 1), **f32)
    l = torch.empty((shards, *q.shape[:3], 1), **f32)
    _launch(q, k, v, bias, None, acc, m, l, shards, True, code, scale)
    flash_decode_partial.launches += 1
    return acc, m, l


flash_decode_partial.launches = 0


@kernel("combine_partials")
def combine_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Combine per-shard (acc, m, l) into the normalised output
    (B,K,G,Dv) in ``out_dtype``: the global max over shards, each shard
    rescaled by exp(m - max), (l, acc) summed in shard order, acc / l.

    CPU tensors: ``ref.combine_partials_ref``; CUDA tensors launch the
    kernel (``combine_partials.launches``) or raise: f32 contiguous
    partials, f32 or bf16 output."""
    if acc.dim() != 5 or m.shape != (*acc.shape[:4], 1) \
            or l.shape != m.shape:
        raise ValueError(f"combine_partials takes acc (S,B,K,G,Dv), m and l "
                         f"(S,B,K,G,1), got {tuple(acc.shape)}, "
                         f"{tuple(m.shape)}, {tuple(l.shape)}")
    if acc.device.type in plain_devices():
        return ref.combine_partials_ref(acc, m, l, out_dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"combine_partials: no kernel for device "
                         f"{acc.device}")
    code = _DTYPE_CODES.get(out_dtype)
    if code is None or any(t.dtype != torch.float32 for t in (acc, m, l)):
        raise TypeError(f"combine_partials kernel takes f32 partials and an "
                        f"f32 or bf16 output, not {acc.dtype} -> {out_dtype}")
    if not all(t.is_contiguous() for t in (acc, m, l)) \
            or m.device != acc.device or l.device != acc.device:
        raise ValueError("combine_partials kernel needs contiguous partials "
                         "on one device")
    S, B, K, G, Dv = acc.shape
    out = torch.empty((B, K, G, Dv), dtype=out_dtype, device=acc.device)
    from repro_torch.kernels._build import library
    err = library(_LIBRARY[code]).repro_flash_decode_combine(
        acc.data_ptr(), m.data_ptr(), l.data_ptr(), out.data_ptr(), S, B * K,
        G, Dv, code, _stream(acc))
    if err:
        raise RuntimeError(f"combine_partials kernel launch failed: CUDA "
                           f"error {err}")
    combine_partials.launches += 1
    return out


combine_partials.launches = 0
