"""Named artifacts.  Port of ``repro.ckpt.checkpoint``'s
``save_artifact`` / ``load_artifact`` (step checkpoints come with
training).

An artifact is a directory with ``manifest.json`` (``{"metadata": ...,
"leaves": {keystr path: {file, shape, dtype} | null}}``) and one ``.npy``
per non-None leaf (``leaf_<flatten index>.npy``), as the JAX package writes
it, so either package reads the other's artifacts.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch import tree


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_artifact(directory: str | os.PathLike, t: Any, *,
                  metadata: dict | None = None) -> None:
    """Atomically write a tree + metadata as a standalone artifact dir:
    everything goes to ``<dir>.tmp`` first, which then replaces ``dir``."""
    final = pathlib.Path(directory)
    final.parent.mkdir(parents=True, exist_ok=True)
    tmp = final.parent / (final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"metadata": metadata or {}, "leaves": {}}
    for i, (path, leaf) in enumerate(tree.flatten_with_path(t)):
        if leaf is None:
            manifest["leaves"][path] = None
            continue
        a = _host(leaf)
        fname = f"leaf_{i:06d}.npy"
        np.save(tmp / fname, a)
        manifest["leaves"][path] = {"file": fname, "shape": list(a.shape),
                                    "dtype": str(a.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():   # re-save over an earlier artifact
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit


def load_artifact(directory: str | os.PathLike, template: Any
                  ) -> tuple[Any, dict]:
    """Restore an artifact into template's structure as numpy leaves
    (None where the manifest has no file); returns (tree, metadata)."""
    d = pathlib.Path(directory)
    manifest = json.loads((d / "manifest.json").read_text())
    by_path = manifest["leaves"]

    def leaf(path, _):
        ent = by_path.get(path)
        return None if ent is None else np.load(d / ent["file"])

    return tree.map_with_path(leaf, template), manifest["metadata"]
