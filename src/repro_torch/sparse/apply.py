"""Sparse execution: route ``SparseTensor`` kernels through ``nm_matmul``.

Port of ``repro.sparse.apply``.  ``models.common.dense`` dispatches on leaf
type, so
a params tree whose prunable kernels :func:`sparsify_params` replaced
serves through the compressed kernel while every dense leaf keeps its
matmul.  MoE expert banks (E, d_in, d_out) dispatch the same way through
``models.common.expert_dense`` -> :func:`sparse_moe_dense`, which runs the
dispatch buffer through ``nm_matmul_expert``, one launch for every expert.
The leaf's ``kernel_layout`` decides what the kernel reads: packed 2-bit
planes (K % 8 == 0) as stored, padded or int8 storage as an int8 plane
unpacked at dispatch.

Under rules (tensor parallelism, ``kernels/shard.py``) a leaf is this
rank's block: a K-shard-tagged leaf (``kernels.shard.k_sharded``; a pair
first through ``pair_k_sharded``) runs the K-sharded wrappers, one
all-reduce a projection group; an untagged leaf whose block splits N or
the experts computes its local columns and gathers them.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.dist.axes import current_rules
from repro_torch.dist.sharding import sharded
from repro_torch.kernels import shard as ksh
from repro_torch.kernels.observe import kernel_pair
from repro_torch.kernels.nm_spmm import (LAYOUT_PACKED2, nm_matmul,
                                         nm_matmul_expert)
from repro_torch.sparse import pack as pack_mod
from repro_torch.sparse.formats import SparseTensor

PyTree = Any


def _kernel_operand(st: SparseTensor) -> tuple[torch.Tensor, str]:
    """Index plane + layout tag as the kernel consumes it."""
    layout = st.kernel_layout
    if layout == LAYOUT_PACKED2:
        return st.idx, layout
    return st.unpacked_idx(), layout


def _tp(st: SparseTensor) -> bool:
    """Route through the K-sharded wrappers?  True when the leaf carries a
    K-shard tag (``dist.sharding.tag_compressed``) and rules are
    installed (``serve.engine.EngineFns(rules=...)``)."""
    return ksh.k_sharded(st)


def _gathers(st: SparseTensor) -> bool:
    """An untagged leaf whose block is a proper part of it (N or the
    experts split), under installed rules."""
    rules = current_rules()
    return rules is not None and st.block is not None \
        and sharded(st.block, rules.mesh)


def sparse_dense(st: SparseTensor, x: torch.Tensor) -> torch.Tensor:
    """x: (..., K) @ compressed (K, N) -> (..., N) in x.dtype."""
    if st.ndim != 2:
        raise ValueError("per-layer kernels only; slice stacked leaves "
                         f"with SparseTensor.select (got {st.shape})")
    *lead, k = x.shape
    x2 = x.reshape(-1, k)
    if _tp(st):
        y = ksh.nm_dense_sharded(st, x2, site=st.shard_site)
    elif _gathers(st):
        y = ksh.nm_gathered(st, x2)
    else:
        idx, layout = _kernel_operand(st)
        y = nm_matmul(x2, st.vals.to(x.dtype), idx, layout=layout)
    return y.reshape(*lead, y.shape[-1])


def per_expert(buf: torch.Tensor) -> torch.Tensor:
    """MoE dispatch buffer (G, E, C, d) -> per-expert rows (E, G*C, d),
    contiguous: the operand layout of both expert-bank paths."""
    G, E, C, d = buf.shape
    return buf.transpose(0, 1).reshape(E, G * C, d).contiguous()


def from_per_expert(y: torch.Tensor, G: int) -> torch.Tensor:
    """(E, G*C, N) -> (G, E, C, N), the inverse regrouping."""
    E, GC, N = y.shape
    return y.reshape(E, G, GC // G, N).transpose(0, 1)


def sparse_moe_dense(st: SparseTensor, buf: torch.Tensor) -> torch.Tensor:
    """MoE dispatch buffer (G, E, C, d) @ compressed expert bank (E, d, N)
    -> (G, E, C, N) in buf.dtype.

    Tokens regroup per expert to (E, G*C, d) and run through
    ``nm_matmul_expert``: one launch covers every expert's product.
    """
    if st.ndim != 3:
        raise ValueError("expert banks are (E, K, N); slice stacked "
                         f"(layers, E, K, N) leaves first (got {st.shape})")
    G, E, C, d = buf.shape
    if st.block is None and st.shape[:2] != (E, d):
        raise ValueError(f"expert bank {st.shape} does not match the "
                         f"dispatch buffer {tuple(buf.shape)}")
    x3 = per_expert(buf)
    if _tp(st):
        y = ksh.nm_moe_sharded(st, x3, site=st.shard_site)
    elif _gathers(st):
        y = ksh.nm_gathered(st, x3, expert=True)
    else:
        idx, layout = _kernel_operand(st)
        y = nm_matmul_expert(x3, st.vals.to(buf.dtype), idx, layout=layout)
    return from_per_expert(y, G)


def sparse_dense2(st_a: SparseTensor, st_b: SparseTensor, x: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pair sharing the reduction dim (gated-MLP up + gate).  A
    K-shard-tagged pair (``kernels.shard.pair_k_sharded``): two local
    kernels and ONE all-reduce for the group.  Otherwise two kernel
    launches over the same x, the reference's TPU route (its CPU route
    concatenates the pair along N into one call, ``apply.py:160``, which
    would re-copy both weights on every call)."""
    if ksh.pair_k_sharded(st_a, st_b):
        *lead, k = x.shape
        ya, yb = ksh.nm_dense2_sharded(st_a, st_b, x.reshape(-1, k),
                                       site=st_a.shard_site)
        return ya.reshape(*lead, -1), yb.reshape(*lead, -1)
    with kernel_pair():
        return sparse_dense(st_a, x), sparse_dense(st_b, x)


def sparse_moe_dense2(st_up: SparseTensor, st_gate: SparseTensor,
                      buf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Up + gate expert banks over one dispatch buffer (a K-shard-tagged
    pair only: callers check ``kernels.shard.pair_k_sharded`` first): two
    local expert-grid kernels, one all-reduce across the pair and the
    expert grid."""
    h, g = ksh.nm_moe2_sharded(st_up, st_gate, per_expert(buf),
                               site=st_up.shard_site)
    G = buf.shape[0]
    return from_per_expert(h, G), from_per_expert(g, G)


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


def _is_expert_bank(path: str, eff_ndim: int) -> bool:
    """A 3-D-per-layer MoE expert bank (E, d_in, d_out)?  Keyed on the
    ``['moe']`` subtree, whose consumer (``moe_apply`` ->
    :func:`sparse_moe_dense`) dispatches over the leading expert axis."""
    return eff_ndim == 3 and "['moe']" in path


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
    it is, per layer, 2-D or a 3-D MoE expert bank (E, d_in, d_out)
    (``axes``, the ``models.model.param_axes`` tree, marks stacked leaves,
    whose leading "layers" axis the layer loop slices).
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
        compressible = ((eff_ndim == 2 or _is_expert_bank(path, eff_ndim))
                        and _is_nm(mk))
        if compressible:
            out[path] = pack_mod.pack_nm(w, mk, idx_bits=idx_bits,
                                         dtype=dtype)
        else:
            out[path] = w * mk.to(w.dtype)
    return tree.map_with_path(lambda p, _: out[p], params)


def shared_leaves(params0: PyTree, t: PyTree) -> int:
    """How many of ``t``'s leaves are ``params0``'s tensors, unchanged.

    Pruning replaces only the pruned kernels (SparseTensor or ``W * mask``);
    every None-mask leaf (embeddings, norms) passes through by object
    identity, so N budget variants built from one ``params0`` share ONE
    copy of the untouched leaves.  SparseTensor leaves are new storage by
    definition and never count.
    """
    ids = {id(leaf) for leaf in tree.leaves(params0) if leaf is not None}
    return sum(id(leaf) in ids for leaf in tree.leaves(t)
               if leaf is not None and not isinstance(leaf, SparseTensor))


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
