"""Sparse execution: route ``SparseTensor`` kernels through ``nm_matmul``.

Port of ``repro.sparse.apply`` (single device; the MoE expert-bank and
tensor-parallel routes come with those slices).  ``models.common.dense``
dispatches on leaf type, so a params tree whose prunable kernels
:func:`sparsify_params` replaced serves through the compressed kernel while
every dense leaf keeps its matmul.  The leaf's ``kernel_layout`` decides
what the kernel reads: packed 2-bit planes (K % 8 == 0) as stored, padded
or int8 storage as an int8 plane unpacked at dispatch.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.kernels.nm_spmm import LAYOUT_PACKED2, nm_matmul
from repro_torch.sparse import pack as pack_mod
from repro_torch.sparse.formats import SparseTensor

PyTree = Any


def _kernel_operand(st: SparseTensor) -> tuple[torch.Tensor, str]:
    """Index plane + layout tag as the kernel consumes it."""
    layout = st.kernel_layout
    if layout == LAYOUT_PACKED2:
        return st.idx, layout
    return st.unpacked_idx(), layout


def sparse_dense(st: SparseTensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ compressed (K, N) -> (..., N) in x.dtype."""
    if st.ndim != 2:
        raise ValueError("per-layer kernels only; slice stacked leaves "
                         f"with SparseTensor.select (got {st.shape})")
    *lead, k = x.shape
    idx, layout = _kernel_operand(st)
    y = nm_matmul(x.reshape(-1, k), st.vals.to(x.dtype), idx, layout=layout)
    return y.reshape(*lead, st.shape[-1])


def sparse_dense2(st_a: SparseTensor, st_b: SparseTensor, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pair sharing the reduction dim (gated-MLP up + gate): two kernel
    launches over the same x.  Concatenating the pair along N would re-copy
    both weights on every call."""
    return sparse_dense(st_a, x), sparse_dense(st_b, x)


# ---------------------------------------------------------------------------
# Tree conversion
# ---------------------------------------------------------------------------

def _stacked(axes_str: str | None) -> bool:
    return bool(axes_str) and axes_str.startswith("layers|")


def _aligned(params: PyTree, other: PyTree, name: str) -> list:
    """``other``'s leaves, checked to pair one-to-one with params' paths."""
    ref_paths = [p for p, _ in tree.flatten_with_path(params)]
    flat = tree.flatten_with_path(other)
    for rp, (gp, _) in zip(ref_paths, flat):
        if rp != gp:
            raise ValueError(
                f"{name} tree does not match params: first offending key "
                f"path {gp!r} ({name}) vs {rp!r} (params)")
    if len(ref_paths) != len(flat):
        raise ValueError(f"{name} tree does not match params: {len(flat)} "
                         f"leaves vs {len(ref_paths)} params leaves")
    return [leaf for _, leaf in flat]


def _is_nm(mask: torch.Tensor, m: int = 4, n: int = 2) -> bool:
    """Exactly n kept per contiguous group of m along the K dim."""
    if mask.shape[-2] % m:
        return False
    g = mask.reshape(*mask.shape[:-2], mask.shape[-2] // m, m,
                     mask.shape[-1])
    return bool((g.sum(-2) == n).all())


def sparsify_params(params: PyTree, masks: PyTree, *, axes: PyTree = None,
                    idx_bits: int = 2,
                    dtype: torch.dtype | None = None) -> PyTree:
    """Replace 2:4-maskable kernels with SparseTensor leaves; mask the rest.

    A kernel is compressed when its mask is 2:4 along the reduction dim and
    it is 2-D per layer (``axes``, the ``models.model.param_axes`` tree,
    marks stacked leaves, whose leading "layers" axis the layer loop slices).
    Other masked leaves become ``W * mask``; None-mask leaves pass through.
    masks/axes must mirror params, or this raises with the first offending
    key path.
    """
    flat = tree.flatten_with_path(params)
    flat_m = _aligned(params, masks, "masks")
    flat_a = (_aligned(params, axes, "axes") if axes is not None
              else [None] * len(flat))
    out = {}
    for (path, w), mk, ax in zip(flat, flat_m, flat_a, strict=True):
        if mk is None:
            out[path] = w
            continue
        eff_ndim = w.dim() - (1 if _stacked(ax) else 0)
        compressible = eff_ndim == 2 and _is_nm(mk)
        if compressible:
            out[path] = pack_mod.pack_nm(w, mk, idx_bits=idx_bits,
                                         dtype=dtype)
        else:
            out[path] = w * mk.to(w.dtype)
    return tree.map_with_path(lambda p, _: out[p], params)


def compressed_report(params: PyTree, masks: PyTree = None) -> dict:
    """Per-leaf and total weight bytes: compressed vs dense-bf16 equivalent.

    With ``masks``, pruned leaves that did not compress (masked-dense
    fallbacks, full dense bytes) are reported too and count into the ratio.
    """
    flat = tree.flatten_with_path(params)
    flat_m = (_aligned(params, masks, "masks") if masks is not None
              else [None] * len(flat))
    layers = []
    for (path, leaf), mk in zip(flat, flat_m, strict=True):
        if isinstance(leaf, SparseTensor):
            d = 2
            for s in leaf.shape:
                d *= s
            layers.append({"path": path, "shape": list(leaf.shape),
                           "idx_bits": leaf.idx_bits, "layout": leaf.layout,
                           "kernel_layout": leaf.kernel_layout,
                           "bytes_compressed": leaf.nbytes,
                           "bytes_dense_bf16": d, "ratio": leaf.nbytes / d,
                           "fallback": False})
        elif mk is not None:
            d = 2 * leaf.numel()
            layers.append({"path": path, "shape": list(leaf.shape),
                           "idx_bits": None, "layout": None,
                           "kernel_layout": "masked-dense",
                           "bytes_compressed": d, "bytes_dense_bf16": d,
                           "ratio": 1.0, "fallback": True})
    comp = sum(r["bytes_compressed"] for r in layers)
    dense_eq = sum(r["bytes_dense_bf16"] for r in layers)
    return {"layers": layers, "bytes_compressed": comp,
            "bytes_dense_bf16": dense_eq,
            "kernel_native_packed": sum(r["kernel_layout"] == LAYOUT_PACKED2
                                        for r in layers),
            "fallback_leaves": sum(r["fallback"] for r in layers),
            "ratio": comp / dense_eq if dense_eq else None}
