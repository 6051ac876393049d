"""Artifact loader.  Port of ``repro.ckpt.checkpoint.load_artifact``.

An artifact is a directory with ``manifest.json`` (``{"metadata": ...,
"leaves": {keystr path: {file, shape, dtype} | null}}``) and one ``.npy``
per non-None leaf, as the JAX package writes it.  Writing artifacts and
step checkpoints comes with calibration and training.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any

import numpy as np

from repro_torch import tree


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
