"""2:4 keep-mask: top-2 |s| of every contiguous group of 4 along K.

Port of ``repro.kernels.nm_prox.nm_mask24`` (the proximal operator
``prox24`` of the same file comes with calibration).  For CUDA tensors
:func:`nm_mask24` launches the hand-written kernel in ``csrc/nm_mask24.cu``;
for CPU tensors it runs ``ref.nm_mask_ref``, its plain version.  Both
compute the integer function of ``core.masks.nm_masks`` (ties go to the
lower position), so the masks are bit-identical.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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
    if s.device.type == "cpu":
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
    err = library().repro_nm_mask24(
        s.data_ptr(), keep.data_ptr(), R, N, code,
        ctypes.c_void_p(torch.cuda.current_stream(s.device).cuda_stream))
    if err:
        raise RuntimeError(f"nm_mask24 kernel launch failed: CUDA error {err}")
    nm_mask24.launches += 1
    return keep


nm_mask24.launches = 0
