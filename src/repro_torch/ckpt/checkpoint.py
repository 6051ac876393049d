"""Atomic, resumable checkpoints and named artifacts.  Port of
``repro.ckpt.checkpoint``.

Layout, the reference's, so either package restores the other's:

  <dir>/step_<N>.tmp/      - written first
      manifest.json        - {"step", "metadata", "leaves": {keystr path:
                             {file, shape, dtype} | null}}
      leaf_<i>.npy         - one per non-None leaf, i its flatten index
  <dir>/step_<N>/          - the atomic rename of the .tmp dir
  <dir>/LATEST             - text file with the committed step number

A crash mid-save leaves only a .tmp dir, never a torn commit.
``save_async`` copies the state to the host before it returns (so the
training step may update its tensors in place at once) and writes it on a
worker thread; ``wait`` (or the next save) joins it.  Leaves are saved
whole and restored onto the template's device: a checkpoint restores
onto any card.

On a mesh (``rules=``; every rank of the mesh calls): ``save`` /
``save_async`` gather each ``dist.sharding.DenseBlock`` leaf whole on
rank 0 on the calling thread, one leaf at a time, and rank 0 alone copies
it to the host and writes; the other ranks write nothing.  The commit is
followed by a barrier over the mesh (in ``save``, or in the ``wait``
that joins ``save_async``'s write), so no rank reads a half-committed
step.  ``restore(template, rules=)`` is the reference's
``restore(..., shardings=)``: each rank reads every leaf file
memory-mapped and keeps its block of the leaf where the template leaf is
a ``DenseBlock`` (``mu`` and ``nu`` take their parameter's).  A
checkpoint written on any mesh, by one process or by the reference
restores onto any other mesh.

A checkpoint state is a tree (:mod:`repro_torch.tree`) or the step state
``(params, AdamWState)`` the reference saves, whose paths read
``[0]['embed']['table']``, ``[1].mu['embed']['table']`` and
``[1].count``.  An artifact is a directory with the same manifest
(``{"metadata", "leaves"}``) and leaf files.
"""
from __future__ import annotations

import concurrent.futures as futures
import json
import os
import pathlib
import shutil
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree
from repro_torch.dist.sharding import DenseBlock, local_block
from repro_torch.optim.optimizers import AdamWState

PyTree = Any


def _parts(state: PyTree) -> list[tuple[str, Any]] | None:
    """The step state ``(params, AdamWState)`` as (keystr prefix, tree)
    parts, in jax's flatten order of a tuple and the registered dataclass;
    None for any other state, which is one tree."""
    if (isinstance(state, tuple) and len(state) == 2
            and isinstance(state[1], AdamWState)):
        params, st = state
        return [("[0]", params), ("[1].mu", st.mu), ("[1].nu", st.nu),
                ("[1].count", st.count)]
    return None


def flatten_state(state: PyTree) -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] of a checkpoint state in jax's flatten order:
    a tree, or the step state ``(params, AdamWState)``."""
    parts = _parts(state)
    if parts is None:
        return tree.flatten_with_path(state)
    return [x for prefix, t in parts
            for x in tree.flatten_with_path(t, prefix)]


def _map_state(fn: Callable, state: PyTree) -> PyTree:
    """``fn(keystr path, leaf)`` over every leaf, keeping the structure."""
    parts = _parts(state)
    if parts is None:
        return tree.map_with_path(fn, state)
    params, mu, nu, count = (tree.map_with_path(fn, t, prefix)
                             for prefix, t in parts)
    return params, AdamWState(mu=mu, nu=nu, count=count)


def _host(leaf) -> np.ndarray:
    """A copy of the leaf in host memory, never a view of it."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            raise TypeError("bf16 leaves have no numpy dtype: checkpoint "
                            "the f32 masters")
        return (leaf.clone() if leaf.device.type == "cpu"
                else leaf.cpu()).numpy()
    return np.array(leaf)


def _to_host(t: PyTree, mesh=None) -> list[tuple[str, Any]] | None:
    """The state's leaves on the host.  On a mesh: each ``DenseBlock``
    gathered whole on rank 0 in turn (a collective), so no rank holds
    more than one whole leaf; None on the other ranks."""
    lead = mesh is None or mesh.rank == 0
    out = []
    for p, x in flatten_state(t):
        if isinstance(x, DenseBlock):
            x = mesh.gather_whole(x.data, x.spec, dst=0)
        out.append((p, None if x is None or not lead else _host(x)))
    return out if lead else None


def _write_tree(tmp: pathlib.Path, final: pathlib.Path,
                flat: list[tuple[str, Any]], manifest_extra: dict) -> None:
    """Serialize flattened host leaves under tmp, then atomically commit
    to final."""
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {**manifest_extra, "leaves": {}}
    for i, (path, leaf) in enumerate(flat):
        if leaf is None:
            manifest["leaves"][path] = None
            continue
        fname = f"leaf_{i:06d}.npy"
        np.save(tmp / fname, leaf)
        manifest["leaves"][path] = {"file": fname, "shape": list(leaf.shape),
                                    "dtype": str(leaf.dtype)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():  # re-save (final + periodic, or an artifact update)
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit


# -- named artifacts (non-step state: mask banks, calibration results) -------

def save_artifact(directory: str | os.PathLike, t: Any, *,
                  metadata: dict | None = None) -> None:
    """Atomically write a tree + metadata as a standalone artifact dir:
    everything goes to ``<dir>.tmp`` first, which then replaces ``dir``."""
    final = pathlib.Path(directory)
    final.parent.mkdir(parents=True, exist_ok=True)
    _write_tree(final.parent / (final.name + ".tmp"), final, _to_host(t),
                {"metadata": metadata or {}})


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


# -- step checkpoints ---------------------------------------------------------

class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = futures.ThreadPoolExecutor(max_workers=1)
        self._pending: futures.Future | None = None
        self._barrier = None      # the mesh of a save_async not joined

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: PyTree, *, metadata: dict | None = None,
             rules=None) -> None:
        """Write ``state`` now (on a mesh: module docstring)."""
        self.wait()
        mesh = None if rules is None else rules.mesh
        flat = _to_host(state, mesh)
        if flat is not None:
            self._write(step, flat, metadata or {})
        if mesh is not None:
            mesh.barrier()

    def save_async(self, step: int, state: PyTree, *,
                   metadata: dict | None = None, rules=None) -> None:
        """Copy ``state`` to the host now, write it on the worker thread
        (on a mesh: the gathers now, on every rank; rank 0 writes)."""
        self.wait()
        mesh = None if rules is None else rules.mesh
        flat = _to_host(state, mesh)
        if flat is not None:
            self._pending = self._pool.submit(self._write, step, flat,
                                              metadata or {})
        self._barrier = mesh

    def wait(self) -> None:
        """Join the pending write (re-raising its error); on a mesh, then
        wait for every rank."""
        pending, self._pending = self._pending, None
        mesh, self._barrier = self._barrier, None
        if pending is not None:
            pending.result()
        if mesh is not None:
            mesh.barrier()

    def close(self) -> None:
        """Join the pending write and stop the worker thread.  No barrier:
        it also runs where a rank unwinds from an error, and its peers may
        never come (a save before it waited for them already)."""
        self._barrier = None
        try:
            self.wait()
        finally:
            self._pool.shutdown()

    def _write(self, step: int, flat: list, metadata: dict) -> None:
        _write_tree(self.dir / f"step_{step:08d}.tmp",
                    self.dir / f"step_{step:08d}", flat,
                    {"step": step, "metadata": metadata})
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, self.dir / "LATEST")
        self._gc()

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        f = self.dir / "LATEST"
        if not f.exists():
            steps = self.all_steps()
            return steps[-1] if steps else None
        return int(f.read_text().strip())

    def restore(self, template: PyTree, *, step: int | None = None,
                rules=None) -> tuple[PyTree, dict]:
        """Restore into the structure of ``template`` (default: the latest
        step).  Each leaf comes back a tensor on the template leaf's device
        (the CPU where the template leaf is not a tensor); None where the
        checkpoint has no file for its path.  ``rules``: a ``DenseBlock``
        template leaf comes back as this rank's block of the saved leaf,
        of its spec.  Returns (tree, metadata)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_path = manifest["leaves"]

        def leaf(path, tmpl):
            ent = by_path.get(path)
            if ent is None:
                return None
            if isinstance(tmpl, DenseBlock):
                if rules is None:
                    raise ValueError(f"{path}: a DenseBlock template leaf "
                                     "restores under rules")
                # copy-on-write map: a writable array, read where the
                # block lies, the file never written
                arr = torch.from_numpy(np.load(d / ent["file"],
                                               mmap_mode="c"))
                return DenseBlock(local_block(arr, tmpl.spec, rules.mesh)
                                  .to(tmpl.device, copy=True), tmpl.spec)
            dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
            return torch.from_numpy(np.load(d / ent["file"])).to(dev)

        return _map_state(leaf, template), manifest["metadata"]
