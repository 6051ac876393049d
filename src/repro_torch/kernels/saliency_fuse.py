"""Fused UniPruning inner loop: local metric + dual update + Gamma prox.

Port of ``repro.kernels.saliency_fuse``.  The search touches every prunable
parameter every step with a pure elementwise chain (score -> V update ->
soft-threshold); :func:`saliency_fused_step` does it in one pass that reads
W, Gamma and V (+ per-row stats) and writes V', Gamma'.  For CUDA tensors it
launches the hand-written kernel in ``csrc/saliency_fuse.cu``; for CPU
tensors it runs ``ref.saliency_step_ref``, its plain version.  Each op
rounds on its own in both, so the outputs are bit-identical.

Metrics: wanda S = |W| a, magnitude S = |W|, ria (and stochria, whose
subsampled row and column sums come in as ``rowsum``/``colsum``)
S = (|W|/rowsum + |W|/colsum) sqrt(a).  ``s_div`` divides S by a device
scalar, the search's median normalisation (``normalize_scores``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.observe import kernel, plain_devices

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
METRIC_CODES = {"wanda": 0, "magnitude": 1, "ria": 2, "stochria": 2}


def _check(name: str, t, shape, device) -> None:
    if t is None:
        raise ValueError(f"saliency_fused_step: {name} is required")
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32
            or t.device != device):
        raise ValueError(f"saliency_fused_step: {name} must be f32 "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def saliency_fused_step_plain(w, a, gamma, v, *, metric: str, v_lr: float,
                              lam: float, rowsum=None, colsum=None,
                              s_div=None):
    """The plain version of :func:`saliency_fused_step` (same arguments, on
    any device): ``ref.saliency_step_ref`` over the (L, K, N) view."""
    R, N = w.shape
    ria = METRIC_CODES[metric] == METRIC_CODES["ria"]
    L = colsum.shape[0] if ria else 1
    K = R // L
    v_new, g_new = ref.saliency_step_ref(
        w.reshape(L, K, N), None if metric == "magnitude" else a.reshape(L, K),
        gamma.reshape(L, K, N), v.reshape(L, K, N), v_lr=v_lr, lam=lam,
        rowsum=rowsum.reshape(L, K, 1) if ria else None,
        colsum=colsum.reshape(L, 1, N) if ria else None, s_div=s_div)
    return v_new.reshape(R, N), g_new.reshape(R, N)


@kernel("saliency_fused_step")
def saliency_fused_step(w: torch.Tensor, a: torch.Tensor | None,
                        gamma: torch.Tensor, v: torch.Tensor, *,
                        metric: str = "wanda", v_lr: float = 0.1,
                        lam: float = 1e-3,
                        rowsum: torch.Tensor | None = None,
                        colsum: torch.Tensor | None = None,
                        s_div: torch.Tensor | None = None,
                        inplace: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (V', Gamma'), f32.

    w: (R, N) f32/bf16/f16; gamma, v: (R, N) f32; a: (R,) f32 (unused, and
    may be None, for magnitude); for ria/stochria rowsum (R,) and colsum
    (L, N) f32, where a stacked (L, K, N) leaf goes in as its (L*K, N) view
    (row r belongs to layer r // K; an unstacked leaf has L = 1).  s_div: an
    optional f32 device scalar that S is divided by.  ``inplace`` writes V'
    over v and Gamma' over gamma.  CUDA tensors launch the kernel
    (``saliency_fused_step.launches`` counts each launch) or raise.
    """
    if metric not in METRIC_CODES:
        raise ValueError(f"saliency_fused_step: unknown metric {metric!r}; "
                         f"options: {tuple(METRIC_CODES)}")
    if w.dim() != 2:
        raise ValueError(f"saliency_fused_step takes (R, N) weights, got "
                         f"{tuple(w.shape)}")
    R, N = w.shape
    dev = w.device
    ria = METRIC_CODES[metric] == METRIC_CODES["ria"]
    _check("gamma", gamma, (R, N), dev)
    _check("v", v, (R, N), dev)
    if metric != "magnitude":
        _check("a", a, (R,), dev)
    if ria:
        _check("rowsum", rowsum, (R,), dev)
        if colsum is None or colsum.dim() != 2 or R % colsum.shape[0]:
            raise ValueError("saliency_fused_step: ria takes colsum (L, N) "
                             "with L dividing R")
        _check("colsum", colsum, (colsum.shape[0], N), dev)
    if s_div is not None:
        _check("s_div", s_div, (), dev)
    L = colsum.shape[0] if ria else 1
    K = R // L
    if dev.type in plain_devices():
        v_new, g_new = saliency_fused_step_plain(
            w, a, gamma, v, metric=metric, v_lr=v_lr, lam=lam, rowsum=rowsum,
            colsum=colsum, s_div=s_div)
        if inplace:
            return v.copy_(v_new), gamma.copy_(g_new)
        return v_new, g_new
    if dev.type != "cuda":
        raise ValueError(f"saliency_fused_step: no kernel for device {dev}")
    code = _DTYPE_CODES.get(w.dtype)
    if code is None:
        raise TypeError(f"saliency_fused_step kernel takes f32, bf16 or f16 "
                        f"weights, not {w.dtype}")
    ins = [w, gamma, v] + [t for t in (a, rowsum, colsum) if t is not None]
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("saliency_fused_step kernel needs contiguous arrays")
    v_out = v if inplace else torch.empty_like(v)
    g_out = gamma if inplace else torch.empty_like(gamma)
    if v_out.numel() == 0:
        return v_out, g_out
    ptr = lambda t: None if t is None else t.data_ptr()
    from repro_torch.kernels._build import library
    err = library("saliency_fuse").repro_saliency_fused_step(
        w.data_ptr(), ptr(a if metric != "magnitude" else None),
        ptr(rowsum if ria else None), ptr(colsum if ria else None),
        ptr(s_div), gamma.data_ptr(), v.data_ptr(), v_out.data_ptr(),
        g_out.data_ptr(), R, K, N, code, METRIC_CODES[metric], v_lr, lam,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"saliency_fused_step kernel launch failed: CUDA "
                           f"error {err}")
    saliency_fused_step.launches += 1
    return v_out, g_out


saliency_fused_step.launches = 0
