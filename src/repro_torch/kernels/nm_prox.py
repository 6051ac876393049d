"""Group-of-4 kernels: the R_{2:4} proximal operator and the 2:4 keep-mask.

Port of ``repro.kernels.nm_prox``.  Both wrappers run their plain version
for CPU tensors and launch their hand-written kernel for CUDA tensors:

* :func:`prox24` - ``csrc/prox24.cu``, plain version ``ref.prox24_ref``
  (``core.prox.prox_nm24``): the prox the N:M search applies to every
  prunable leaf each step.  Each op rounds on its own in both, so the
  outputs are bit-identical.
* :func:`nm_mask24` - ``csrc/nm_mask24.cu``, plain version
  ``ref.nm_mask_ref``.  Both compute the integer function of
  ``core.masks.nm_masks`` (ties go to the lower position), so the masks are
  bit-identical.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.observe import kernel, plain_devices

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@kernel("prox24")
def prox24(w: torch.Tensor, *, lam: float, iters: int = 12,
           damping: float = 0.7, out: torch.Tensor | None = None
           ) -> torch.Tensor:
    """Prox of lam*R_{2:4} on each contiguous group of 4 along K.

    w: (K, N) f32, bf16 or f16 with K % 4 == 0 -> the same shape and dtype.
    A stacked (L, K, N) leaf goes through as its (L*K, N) view: with
    K % 4 == 0 no group crosses a layer.  ``out`` receives the result (it
    may be ``w`` itself: the search overwrites W in place).  CUDA tensors
    launch the kernel (``prox24.launches`` counts each launch) or raise:
    contiguous, f32, bf16 or f16.
    """
    if w.dim() != 2 or w.shape[0] % 4:
        raise ValueError(f"prox24 takes (K, N) weights with K % 4 == 0, "
                         f"got {tuple(w.shape)}")
    if out is not None and (out.shape != w.shape or out.dtype != w.dtype
                            or out.device != w.device):
        raise ValueError("prox24: out must match w in shape, dtype and "
                         "device")
    if w.device.type in plain_devices():
        res = ref.prox24_ref(w, lam, iters=iters, damping=damping)
        return res if out is None else out.copy_(res)
    if w.device.type != "cuda":
        raise ValueError(f"prox24: no kernel for device {w.device}")
    code = _DTYPE_CODES.get(w.dtype)
    if code is None:
        raise TypeError(f"prox24 kernel takes f32, bf16 or f16 weights, "
                        f"not {w.dtype}")
    if not w.is_contiguous() or (out is not None
                                 and not out.is_contiguous()):
        raise ValueError("prox24 kernel needs contiguous arrays")
    R, N = w.shape
    if out is None:
        out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    from repro_torch.kernels._build import library
    err = library("prox24").repro_prox24(
        w.data_ptr(), out.data_ptr(), R, N, code, lam, damping, 1 - damping,
        iters, _stream(w))
    if err:
        raise RuntimeError(f"prox24 kernel launch failed: CUDA error {err}")
    prox24.launches += 1
    return out


prox24.launches = 0


@kernel("nm_mask24")
def nm_mask24(s: torch.Tensor) -> torch.Tensor:
    """Top-2-of-4 keep-mask along K.  s: (K, N) scores -> bool (K, N).

    A stacked (L, K, N) leaf goes through as its (L*K, N) view: with
    K % 4 == 0 no group crosses a layer.  CUDA tensors launch the kernel
    (``nm_mask24.launches`` counts each launch) or raise: f32, bf16 or f16,
    contiguous.
    """
    if s.dim() != 2 or s.shape[0] % 4:
        raise ValueError(f"nm_mask24 takes (K, N) scores with K % 4 == 0, "
                         f"got {tuple(s.shape)}")
    if s.device.type in plain_devices():
        return ref.nm_mask_ref(s, 2, 4)
    if s.device.type != "cuda":
        raise ValueError(f"nm_mask24: no kernel for device {s.device}")
    code = _DTYPE_CODES.get(s.dtype)
    if code is None:
        raise TypeError(f"nm_mask24 kernel takes f32, bf16 or f16 scores, "
                        f"not {s.dtype}")
    if not s.is_contiguous():
        raise ValueError("nm_mask24 kernel needs contiguous scores")
    R, N = s.shape
    keep = torch.empty((R, N), dtype=torch.bool, device=s.device)
    if keep.numel() == 0:
        return keep
    from repro_torch.kernels._build import library
    err = library("nm_mask24").repro_nm_mask24(
        s.data_ptr(), keep.data_ptr(), R, N, code, _stream(s))
    if err:
        raise RuntimeError(f"nm_mask24 kernel launch failed: CUDA error {err}")
    nm_mask24.launches += 1
    return keep


nm_mask24.launches = 0
