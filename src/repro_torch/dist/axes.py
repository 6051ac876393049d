"""Logical axis names -> mesh axes.  Port of ``repro.dist.axes``.

Model code annotates every parameter dimension with a *logical* name
("embed", "mlp", "vocab", ...).  A :class:`ShardingRules` maps logical
names onto mesh axes; the spec derivation (``dist.sharding``) turns each
leaf's names and shape into a :class:`PartitionSpec`, and the engine stores
each rank's block of the leaf under it.

A mesh is anything with ``axis_names`` and a ``shape`` mapping axis name to
size: ``launch.mesh.Mesh`` over the ranks of the default process group, or
a layout-only one (no process group) for planning and tests.  A spec is a
plain tuple of entries, each None, a mesh-axis name or a tuple of names, so
it compares equal to the reference's ``jax.sharding.PartitionSpec`` entry
for entry.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

_local = threading.local()


class PartitionSpec(tuple):
    """A spec: one entry per dim (None, an axis name, or a tuple of axis
    names, major to minor); a tuple, so ``==`` compares entry for entry
    with a tuple or the reference's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass
class ShardingRules:
    """mesh + {logical axis name: mesh axis | tuple of mesh axes | None}."""
    mesh: Any
    rules: dict[str, Any]

    def spec(self, names) -> PartitionSpec:
        """PartitionSpec for a sequence of logical names.

        A mesh axis may appear at most once in a spec; later dims that map
        onto an already-used mesh axis fall back to None (replicated).
        """
        used: set[str] = set()
        out = []
        for name in names:
            axes = self.rules.get(name) if name else None
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            axes = tuple(a for a in axes
                         if a in self.mesh.axis_names and a not in used)
            used.update(axes)
            if not axes:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        return P(*out)


def make_rules(mesh, *, seq_parallel: bool = False,
               seq_shard_kv: Any = False) -> ShardingRules:
    """Default logical->mesh mapping (FSDP over 'data', TP over 'model').

    seq_parallel: shard activation seq ("act_seq") over the TP axis.
    seq_shard_kv: False | "model" | "all" - how decode KV caches shard
    their capacity dim (the reference's ``seq_sharded`` decode, not ported:
    ROADMAP A item 3).
    """
    multi_pod = "pod" in mesh.axis_names
    data: Any = ("pod", "data") if multi_pod else "data"
    if seq_shard_kv == "all":
        kv_seq: Any = (("pod", "data", "model") if multi_pod
                       else ("data", "model"))
    elif seq_shard_kv:
        kv_seq = "model"
    else:
        kv_seq = None
    rules = {
        # parameters
        "embed": data, "mlp": "model", "qkv": "model",
        "vocab": "model", "experts": "model", "ssm": "model",
        "embed_act": None, "layers": None,
        # activations
        "batch": data, "seq": None, "heads": "model",
        "kv_heads": "model",
        "act_seq": "model" if seq_parallel else None,
        "kv_seq": kv_seq,
    }
    return ShardingRules(mesh=mesh, rules=rules)


def current_rules() -> ShardingRules | None:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    """Install ``rules`` for this thread for the duration of the block (None
    installs nothing: the single-device path)."""
    prev = current_rules()
    _local.rules = rules
    try:
        yield rules
    finally:
        _local.rules = prev


def _divisible(shape, spec, mesh) -> PartitionSpec:
    """Drop spec entries whose mesh-axis product does not divide the dim."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if axes is None:
            out.append(None)
            continue
        ax = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in ax:
            n *= mesh.shape[a]
        out.append(axes if dim % n == 0 else None)
    return P(*out)


def spec_for_shape(rules: ShardingRules, names, shape) -> PartitionSpec:
    """Divisibility-checked PartitionSpec for logical ``names`` on ``shape``:
    the primitive under both dense-leaf and compressed-leaf derivation."""
    return _divisible(shape, rules.spec(names), rules.mesh)


def constrain(x, *names):
    """The identity.  The reference pins an activation's layout here
    (``with_sharding_constraint``); the port keeps every activation
    replicated on every rank, and each sharded projection gathers or sums
    its result explicitly (``kernels.shard``), so there is nothing to
    pin."""
    return x
