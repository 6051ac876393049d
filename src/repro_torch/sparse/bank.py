"""Persistent mask bank: one calibration, arbitrary budgets.

Port of ``repro.sparse.bank`` (loading and re-thresholding; writing a bank
comes with calibration).  The artifact holds the post-search state -
Gamma, the dual V, the activation stats - in the model's params structure,
with a crc32 checksum over every leaf.  ``masks_at`` re-thresholds it via
``core.mirror.export_masks`` in one shot.
"""
from __future__ import annotations

import dataclasses
import warnings
import zlib
from collections import OrderedDict
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import (PruneConfig, get_config,
                                      get_smoke_config)
from repro_torch.device import resolve_device

PyTree = Any

# masks_at memo bound (budgets a long-lived server keeps warm)
MASK_CACHE_ENTRIES = 8

SCHEMA = "unipruning.mask-bank/v1"
# v1: no integrity fields (legacy, loads with a warning); v2: checksum
FORMAT_VERSION = 2


def _cfg_for(arch: str, smoke: bool):
    return get_smoke_config(arch) if smoke else get_config(arch)


def _tree_checksum(t: PyTree) -> str:
    """Order-stable crc32 over materialized leaves (keystr path, dtype,
    shape, bytes), None leaves skipped: the reference's checksum, byte for
    byte, so a bank written by either package verifies in both."""
    crc = 0
    for path, leaf in tree.flatten_with_path(t):
        if leaf is None:
            continue
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.ascontiguousarray(np.asarray(leaf))
        crc = zlib.crc32(path.encode(), crc)
        crc = zlib.crc32(f"{a.dtype}{a.shape}".encode(), crc)
        crc = zlib.crc32(a.tobytes(), crc)
    return f"{crc:08x}"


class MaskBank:
    """Saved calibration state; re-threshold to masks at any budget."""

    def __init__(self, cfg, pcfg: PruneConfig, Gamma: PyTree, V: PyTree,
                 stats: PyTree, meta: dict):
        self.cfg = cfg
        self.pcfg = pcfg
        self.Gamma = Gamma
        self.V = V
        self.stats = stats
        self.meta = meta
        self._mask_cache: OrderedDict[tuple, PyTree] = OrderedDict()

    @classmethod
    def load(cls, directory, *, cfg=None, device=None) -> "MaskBank":
        """Load, verify the checksum, and place the state on ``device``
        (the card unless the caller names another)."""
        from repro_torch.models import model as M
        device = resolve_device(device)
        _, meta = ckpt.load_artifact(directory, {"Gamma": 0})
        if meta.get("schema") != SCHEMA:
            raise ValueError(f"{directory} is not a mask bank "
                             f"(schema {meta.get('schema')!r})")
        version = meta.get("format_version", 1)
        if version > FORMAT_VERSION:
            raise ValueError(
                f"mask bank at {directory} has format_version {version}, "
                f"this build reads <= {FORMAT_VERSION}: refusing a stale "
                "reader on a newer artifact")
        if version < 2:
            warnings.warn(
                f"mask bank at {directory} is a LEGACY format_version=1 "
                "artifact with no integrity checksum: a truncated or "
                "bit-rotted leaf would silently re-threshold to wrong masks.",
                stacklevel=2)
        if cfg is None:
            cfg = _cfg_for(meta["arch"], meta["smoke"])
        tpl = M.param_shapes(cfg)
        t, _ = ckpt.load_artifact(directory,
                                  {"Gamma": tpl, "V": tpl, "stats": tpl})
        if version >= 2:
            got = _tree_checksum(t)
            if got != meta["checksum"]:
                raise ValueError(
                    f"mask bank at {directory} failed its integrity check "
                    f"(stored {meta['checksum']}, recomputed {got}): "
                    "artifact is truncated or corrupt, refusing to serve "
                    "masks from it")
        t = tree.tree_map(
            lambda x: None if x is None else torch.from_numpy(x).to(device), t)
        return cls(cfg, PruneConfig(**meta["pcfg"]), t["Gamma"], t["V"],
                   t["stats"], meta)

    def masks_at(self, sparsity: float | None = None,
                 nm: tuple[int, int] | None = None) -> PyTree:
        """Keep-mask tree at a budget: ``sparsity`` (unstructured, global)
        or ``nm`` = (n, m); with neither, the bank's calibrated N:M pattern.
        Memoized per budget (LRU, ``MASK_CACHE_ENTRIES`` deep)."""
        from repro_torch.core import mirror
        pcfg = self.pcfg
        if nm is not None:
            pcfg = dataclasses.replace(pcfg, mode="nm", nm_n=nm[0],
                                       nm_m=nm[1])
            key = ("nm", (int(nm[0]), int(nm[1])))
        elif sparsity is not None:
            pcfg = dataclasses.replace(pcfg, mode="unstructured")
            key = ("unstructured", float(sparsity))
        else:
            if pcfg.mode != "nm":
                raise ValueError("unstructured bank needs an explicit "
                                 "sparsity")
            key = ("nm", (int(pcfg.nm_n), int(pcfg.nm_m)))
        masks = self._mask_cache.get(key)
        if masks is not None:
            self._mask_cache.move_to_end(key)
            return masks
        masks = mirror.export_masks(
            pcfg, self.Gamma, 0.5 if sparsity is None else sparsity, V=self.V)
        self._mask_cache[key] = masks
        while len(self._mask_cache) > MASK_CACHE_ENTRIES:
            self._mask_cache.popitem(last=False)
        return masks

    def sparse_params(self, params0: PyTree, *, sparsity: float | None = None,
                      nm: tuple[int, int] | None = None,
                      compressed: bool = True, idx_bits: int = 2,
                      dtype: torch.dtype | None = None,
                      with_masks: bool = False) -> PyTree:
        """W0 -> pruned params: 2:4-compressed (``SparseTensor`` kernels
        served by ``nm_matmul``) or masked-dense (W0 * mask).
        with_masks=True also returns the keep-mask tree."""
        from repro_torch.core import masks as masks_mod
        from repro_torch.models import model as M
        from repro_torch.models.common import COMPUTE_DTYPE
        from repro_torch.sparse import apply as apply_mod
        if nm is None and sparsity is None and self.pcfg.mode == "nm":
            nm = (self.pcfg.nm_n, self.pcfg.nm_m)
        masks = self.masks_at(sparsity=sparsity, nm=nm)
        if not compressed or nm is None:
            out = masks_mod.apply_masks(params0, masks)
        else:
            out = apply_mod.sparsify_params(
                params0, masks, axes=M.param_axes(self.cfg),
                idx_bits=idx_bits, dtype=dtype or COMPUTE_DTYPE)
        return (out, masks) if with_masks else out
