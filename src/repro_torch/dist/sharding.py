"""Sharding derivation: params / batch / KV-cache spec trees, and each
rank's block of them.  Port of ``repro.dist.sharding``.

Specs are derived from the logical-axis annotations the model emits
(``models.model.param_axes``) through a :class:`~repro_torch.dist.axes.
ShardingRules` mapping, with a per-dimension divisibility fallback (a dim
that the mapped mesh axes do not divide is replicated instead of erroring).
Where the reference returns a ``NamedSharding`` the port returns its
:class:`~repro_torch.dist.axes.PartitionSpec` (the mesh is the rules').

Compressed leaves (``sparse.formats.SparseTensor`` / ``BitMask``) shard too,
and the K (contraction) dim is first-class: a SparseTensor standing in for
a dense (K, N) kernel inherits the dense kernel's logical axes, and its K
sharding is decided once for the *leaf* - both components shard K iff the
shard-local slices stay kernel-executable, i.e. K % (8 * ranks) == 0 for
2-bit-packed planes (whole index bytes a shard) resp. K % (4 * ranks) == 0
for int8 planes (whole 2:4 groups).  A leaf that cannot honor its K rule
replicates BOTH components along K and says so loudly (a warning with the
leaf path and axis).  K-shardable leaves additionally get the static
``shard`` tag (:func:`tag_compressed`) that routes dispatch through the
K-sharded wrappers in ``kernels/shard.py``.  Expert-banked leaves carry the
expert dim through unchanged.  BitMask bits are a flat byte buffer with no
meaningful axis: replicated.

``REPRO_FORCE_REPLICATED=1`` forces the replicated-K fallback everywhere
(no tags stamped, specs keep K unsharded).

Placement (the port's ``device_put``): :func:`local_block` is a rank's
block of one tensor under a spec; :func:`place_leaf` / :func:`place_params`
store each leaf as that block - a compressed leaf as a SparseTensor of its blocks with its
tag and ``block`` spec, a dense leaf that the mesh shards as a
:class:`DenseBlock`, a replicated leaf as it is; :func:`place_caches`
shards each KV ring's capacity over "model" exactly where the decode
attention runs across ranks (``kernels.shard.kv_shard_axes``) and keeps
the batch whole (ROADMAP R26).

The search state (``core.calibrate.run_search(rules=)``):
:func:`search_specs` (``search_state_sharding``'s specs, with a prunable
leaf's K kept whole where its blocks would split the groups of 4 of
``prox24`` and the 2:4 masks), :func:`place_state` (each rank's W / Gamma
/ V blocks), :func:`place_stats`, :func:`gather_state` (the whole trees on
rank 0, for the bank) and :class:`LeafLayout` (one leaf's whole-leaf sums,
draws, sizes and median from a block).
"""
from __future__ import annotations

import weakref
from typing import Any

import torch

from repro_torch import obs, tree
from repro_torch.dist.axes import (P, PartitionSpec, ShardingRules,
                                   make_rules, spec_for_shape)
from repro_torch.kernels.shard import (_ax_tuple, axes_size,
                                       kv_shard_axes, replicated_forced)
from repro_torch.sparse.formats import BitMask, SparseTensor

PyTree = Any


def make_production_rules(mesh, *, seq_shard_kv: Any = False,
                          seq_parallel: bool = False) -> ShardingRules:
    """Rules for the production mesh (pod/data FSDP + model TP)."""
    return make_rules(mesh, seq_parallel=seq_parallel,
                      seq_shard_kv=seq_shard_kv)


def _data_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _one(axes):
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _shape(x) -> tuple[int, ...]:
    """A leaf's shape: a shape tuple as it is, else ``.shape``."""
    return tuple(x) if isinstance(x, tuple) else tuple(x.shape)


def _site_for(path: str) -> str:
    """Projection-group label for collective accounting, from the leaf path."""
    if "['moe']" in path:
        return "moe"
    if "['attn']" in path:
        return "attn"
    if "['mlp']" in path or "['shared']" in path:
        return "mlp"
    return "dense"


def sparse_component_layout(axes_str: str | None, st: SparseTensor,
                            rules: ShardingRules, *, path: str = "",
                            quiet: bool = False):
    """One compressed leaf -> (vals_spec, idx_spec, shard_tag).

    The single source of the K-sharding decision, shared by
    :func:`sparse_leaf_sharding` and :func:`tag_compressed`, so placement
    and execution never disagree.  K shards iff ``K % (group * ranks) ==
    0`` with group 8 (2-bit-packed planes) resp. 4 (int8 planes);
    otherwise BOTH components replicate K and a warning names the leaf and
    axis (suppressed with ``quiet``, and entirely under
    ``REPRO_FORCE_REPLICATED``).  Leading dims (layers / experts) and N
    keep the dense per-dim divisibility fallback.  The tag is ``(site,
    *entries)`` over the *executed* dims (a leading "layers" entry
    stripped: the layer loop slices it away before dispatch) and is None
    unless K actually shards.
    """
    mesh = rules.mesh
    if axes_str is None:
        return P(), P(), None
    names = axes_str.split("|")
    shape = st.shape
    dense_spec = tuple(rules.spec(names))
    entries = list(dense_spec) + [None] * (len(shape) - len(dense_spec))
    lead = []
    for i, e in enumerate(entries[:-2]):
        sz = axes_size(mesh, e)
        lead.append(e if sz <= 1 or shape[i] % sz == 0 else None)
    K, N = shape[-2], shape[-1]
    k_e, n_e = entries[-2], entries[-1]
    n_keep = n_e if N % axes_size(mesh, n_e) == 0 else None
    d = axes_size(mesh, k_e)
    forced = replicated_forced()
    group = 8 if st.idx_bits == 2 else 4
    k_tag = None
    spec_k = k_e
    if k_e is not None and d > 1:
        if not forced and K % (group * d) == 0:
            k_tag = k_e
        else:
            spec_k = None
            if not quiet and not forced:
                obs.log(
                    "dist.sparse_k_replicated", level="warn",
                    leaf=path or axes_str, axis=str(k_e), dim=K,
                    devices=d, idx_bits=st.idx_bits,
                    warn=(f"compressed leaf {path or axes_str}: K={K} "
                          f"cannot shard over mesh axis {k_e!r} "
                          f"({d} devices, needs K % {group * d} == 0 for "
                          f"{'2-bit-packed' if group == 8 else 'int8'} "
                          f"index planes); vals AND idx replicate along K"))
    vals_spec = P(*lead, spec_k, n_keep)
    idx_spec = P(*lead, spec_k, n_keep)
    tag = None
    if k_tag is not None:
        exec_entries = lead[1:] if names[0] == "layers" else lead
        tag = (_site_for(path),
               *(e if axes_size(mesh, e) > 1 else None
                 for e in exec_entries),
               k_tag,
               n_keep if axes_size(mesh, n_keep) > 1 else None)
    return vals_spec, idx_spec, tag


def sparse_leaf_sharding(axes_str: str | None, st: SparseTensor,
                         rules: ShardingRules,
                         path: str = "") -> SparseTensor:
    """Specs for one SparseTensor leaf, as a matching SparseTensor of
    specs carrying the input leaf's ``idx_bits`` and tag verbatim."""
    vals_spec, idx_spec, _ = sparse_component_layout(axes_str, st, rules,
                                                     path=path)
    return SparseTensor(vals_spec, idx_spec, idx_bits=st.idx_bits,
                        shard=st.shard)


def _axes_by_path(axes_tree: PyTree) -> dict[str, Any]:
    return dict(tree.flatten_with_path(axes_tree))


def tag_compressed(axes_tree: PyTree, params: PyTree,
                   rules: ShardingRules) -> PyTree:
    """Stamp every SparseTensor leaf with its tensor-parallel dispatch tag.

    The tag (``SparseTensor.shard``) is what ``sparse.apply`` dispatches
    on: K-sharded leaves route through the K-sharded wrappers.  Quiet (no
    fallback warnings): callers pair this with :func:`params_sharding`,
    which is the loud pass.  Every other leaf, and a leaf whose tag does
    not change, passes through by identity."""
    axes = _axes_by_path(axes_tree)

    def leaf(path, w):
        if isinstance(w, SparseTensor):
            _, _, tag = sparse_component_layout(axes[path], w, rules,
                                                path=path, quiet=True)
            return w.with_shard(tag) if tag != w.shard else w
        return w

    return tree.map_with_path(leaf, params)


def params_sharding(axes_tree: PyTree, shapes_tree: PyTree,
                    rules: ShardingRules) -> PyTree:
    """'|'-joined logical-axis strings + shapes -> spec tree.

    ``shapes_tree`` may be ``models.model.param_shapes`` output or a
    params tree; SparseTensor leaves get component-wise specs via
    :func:`sparse_leaf_sharding`, BitMask leaves replicate.
    """
    axes = _axes_by_path(axes_tree)

    def leaf(path, shape_like):
        axes_str = axes[path]
        if isinstance(shape_like, SparseTensor):
            return sparse_leaf_sharding(axes_str, shape_like, rules,
                                        path=path)
        if isinstance(shape_like, BitMask):
            return BitMask(P(), shape_like.shape)
        if axes_str is None or shape_like is None:
            return P()
        return spec_for_shape(rules, axes_str.split("|"), _shape(shape_like))

    return tree.map_with_path(leaf, shapes_tree)


def search_state_sharding(axes_tree: PyTree, state, rules: ShardingRules):
    """Spec tree for a ``core.mirror.SearchState`` on the mesh: W inherits
    the dense parameter rules, Gamma and V each non-None leaf its kernel's
    spec, step and rng replicate."""
    from repro_torch.core.mirror import SearchState
    base = params_sharding(axes_tree, state.W, rules)

    def gv(g, sh):
        return None if g is None else sh

    return SearchState(W=base,
                       Gamma=tree.tree_map(gv, state.Gamma, base),
                       V=tree.tree_map(gv, state.V, base),
                       step=P(), rng=P())


def stacked_batch_sharding(stacked_tree: PyTree, mesh) -> PyTree:
    """Scan-stacked calibration chunks, leaves (steps, B, ...): the step
    axis stays unsharded, the batch dim shards over the data axes when
    divisible."""
    data = _one(_data_axes(mesh))
    dp = 1
    for a in _data_axes(mesh):
        dp *= mesh.shape[a]

    def leaf(s):
        if s is None:
            return P()
        shape = _shape(s)
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] % dp == 0:
            spec[1] = data
        return P(*spec)

    return tree.tree_map(leaf, stacked_tree)


def batch_sharding_tree(batch_tree: PyTree, mesh) -> PyTree:
    """Input batches: leading batch dim over the data axes, rest
    replicated."""
    dp = 1
    for a in _data_axes(mesh):
        dp *= mesh.shape[a]

    def leaf(s):
        if s is None:
            return P()
        shape = _shape(s)
        b = _one(tuple(a for a in _data_axes(mesh)))
        spec = [b if shape and shape[0] % dp == 0 else None]
        spec += [None] * (len(shape) - 1)
        return P(*spec)

    return tree.tree_map(leaf, batch_tree)


def cache_sharding(cache_tree: PyTree, mesh) -> PyTree:
    """Decode KV caches, leaves (layers, B, capacity, ...): the reference's
    layout (layers never sharded; B > 1: batch over the data axes,
    capacity over "model"; B == 1: capacity over every divisible axis).
    The port stores caches per :func:`place_caches`, which keeps the batch
    whole (ROADMAP R26)."""
    data = _data_axes(mesh)
    dp = 1
    for a in data:
        dp *= mesh.shape[a]

    def leaf(s):
        if s is None:
            return P()
        shape = _shape(s)
        spec: list = [None] * len(shape)
        if len(shape) >= 3:
            B, C = shape[1], shape[2]
            if B > 1 and B % dp == 0:
                spec[1] = _one(data)
                if C % mesh.shape["model"] == 0:
                    spec[2] = "model"
            else:
                axes = tuple(a for a in data + ("model",)
                             if C % mesh.shape[a] == 0)
                n = 1
                keep = []
                for a in axes:
                    if C % (n * mesh.shape[a]) == 0:
                        keep.append(a)
                        n *= mesh.shape[a]
                if keep:
                    spec[2] = keep[0] if len(keep) == 1 else tuple(keep)
        return P(*spec)

    return tree.tree_map(leaf, cache_tree)


# ---------------------------------------------------------------------------
# Placement: each rank's block
# ---------------------------------------------------------------------------

class DenseBlock:
    """A rank's block of a dense leaf that the mesh shards: ``data`` and
    ``spec``, the spec of the whole leaf (one entry a dim of ``data``,
    stacked "layers" first).  Model code that reads such a leaf dispatches
    on this type (``models.common``); :meth:`select` slices one layer out
    of a stacked leaf, as ``SparseTensor.select`` does."""

    def __init__(self, data: torch.Tensor, spec):
        self.data = data
        self.spec = PartitionSpec(*spec)

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    def select(self, i: int) -> "DenseBlock":
        return DenseBlock(self.data[i], self.spec[1:])

    def to(self, *args, **kwargs) -> "DenseBlock":
        return DenseBlock(self.data.to(*args, **kwargs), self.spec)

    def __repr__(self):
        return f"DenseBlock(shape={self.shape}, spec={self.spec})"


def sharded(spec, mesh) -> bool:
    """Does ``spec`` split any dim over more than one rank?"""
    return any(axes_size(mesh, e) > 1 for e in spec)


def block_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a ``shape`` leaf under ``spec``."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // axes_size(mesh, e) for d, e in zip(shape, entries))


def local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view; ``mesh.rank``'s
    block index along each entry, ``launch.mesh.Mesh.index``)."""
    for dim, e in enumerate(spec):
        n = axes_size(mesh, e)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, mesh.index(e) * size, size)
    return t


def _own(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The block as storage of its own, so the whole leaf can be freed."""
    return local_block(t, spec, mesh).clone() if sharded(spec, mesh) else t


def place_leaf(path: str, axes_str: str | None, w, rules: ShardingRules):
    """This rank's block of one leaf (``path`` its key path, ``axes_str``
    its logical axes), tagged and laid out as :func:`tag_compressed` and
    :func:`params_sharding` (the loud pass) say: a SparseTensor of its
    components' blocks with its tag and ``block`` spec, a
    :class:`DenseBlock` for a dense leaf the mesh shards, the leaf itself
    otherwise (a SparseTensor with its tag).  Each block is storage of its
    own, so the whole leaf can be freed.  A leaf placed already (a
    DenseBlock, or a SparseTensor with a ``block``) is returned as it
    is."""
    mesh = rules.mesh
    if isinstance(w, DenseBlock) or (isinstance(w, SparseTensor)
                                     and w.block is not None):
        return w
    if isinstance(w, SparseTensor):
        vals_spec, idx_spec, tag = sparse_component_layout(
            axes_str, w, rules, path=path)
        if not sharded(vals_spec, mesh):
            return w if tag == w.shard else w.with_shard(tag)
        return SparseTensor(_own(w.vals, vals_spec, mesh),
                            _own(w.idx, idx_spec, mesh),
                            idx_bits=w.idx_bits, shard=tag,
                            block=vals_spec)
    if isinstance(w, torch.Tensor) and axes_str is not None:
        spec = spec_for_shape(rules, axes_str.split("|"), w.shape)
        if sharded(spec, mesh):
            return DenseBlock(_own(w, spec, mesh), spec)
    return w


def place_params(axes_tree: PyTree, params: PyTree, rules: ShardingRules,
                 memo: dict | None = None) -> PyTree:
    """:func:`place_leaf` over every leaf.  ``memo`` (id(leaf) -> (weak
    reference to the leaf, its placement)): a leaf placed before, by
    another tree of the same model, is not copied again (a fleet's members
    share their untouched leaves)."""
    memo = {} if memo is None else memo
    axes = _axes_by_path(axes_tree)

    def leaf(path, w):
        if w is None:
            return None
        hit = memo.get(id(w))
        if hit is None or hit[0]() is not w:
            hit = memo[id(w)] = (weakref.ref(w),
                                 place_leaf(path, axes[path], w, rules))
        return hit[1]

    return tree.map_with_path(leaf, params)


def place_caches(caches: PyTree, rules: ShardingRules) -> PyTree:
    """This rank's block of every cache leaf (layers, B, C, ...): the
    capacity split over "model" where ``kernels.shard.kv_shard_axes(B, C)``
    runs the decode attention across ranks, else the whole leaf."""
    def leaf(c):
        if c is None or c.dim() < 3 or not kv_shard_axes(
                c.shape[1], c.shape[2], rules):
            return c
        return _own(c, P(None, None, "model"), rules.mesh)

    return tree.tree_map(leaf, caches)


# ---------------------------------------------------------------------------
# The search state on the mesh: each rank's W / Gamma / V / stats blocks
# ---------------------------------------------------------------------------

# prox24 and the 2:4 masks take groups of 4 along a kernel's K
PROX_GROUP = 4


def search_specs(axes_tree: PyTree, params: PyTree, rules: ShardingRules,
                 *, quiet: bool = False) -> PyTree:
    """The spec of each W leaf of the search state on the mesh:
    :func:`search_state_sharding`'s, except that a prunable leaf whose K
    block would split the groups of 4 along K that ``prox24`` and the 2:4
    masks take (K % (4 * ranks) != 0) replicates K, with a warning naming
    the leaf and axis (the reference's loud fallback, as
    :func:`sparse_component_layout` gives a compressed leaf; ``quiet``:
    none, for a second pass over the same leaves)."""
    from repro_torch.core.prunable import prunable_map
    mesh = rules.mesh
    base = params_sharding(axes_tree, params, rules)

    def leaf(path, spec, w, p):
        if not p or w is None:
            return spec
        K = w.shape[-2]
        entries = list(spec) + [None] * (len(w.shape) - len(spec))
        k_e = entries[-2]
        d = axes_size(mesh, k_e)
        if d > 1 and K % (PROX_GROUP * d):
            if not quiet:
                obs.log("dist.search_k_replicated", level="warn", leaf=path,
                        axis=str(k_e), dim=K, devices=d,
                        warn=(f"search state leaf {path}: K={K} over mesh "
                              f"axis {k_e!r} ({d} devices) leaves blocks of "
                              f"{K // d} rows, which split the groups of "
                              f"{PROX_GROUP} along K of prox24 and the 2:4 "
                              "masks; the leaf replicates along K"))
            entries[-2] = None
            return P(*entries)
        return spec

    lookup = {path: (w, p) for (path, w), p in zip(
        tree.flatten_with_path(params), tree.leaves(prunable_map(params)))}
    return tree.map_with_path(
        lambda path, spec: leaf(path, spec, *lookup[path]), base)


def _place(t, spec, mesh):
    """A tensor's block under ``spec``: a :class:`DenseBlock` of storage of
    its own where the spec shards it, else the tensor (a block placed
    already stays as it is)."""
    if t is None or isinstance(t, DenseBlock) or not sharded(spec, mesh):
        return t
    return DenseBlock(local_block(t, spec, mesh).clone(), spec)


def place_by(params: PyTree, specs: PyTree, rules: ShardingRules) -> PyTree:
    """Each leaf of ``params`` as its block under its spec in ``specs``
    (:func:`search_specs`): the stats pass's and the pruned weights'
    placement."""
    return tree.tree_map(lambda w, spec: _place(w, spec, rules.mesh),
                         params, specs)


def place_state(axes_tree: PyTree, params0: PyTree, rules: ShardingRules,
                *, seed: int, specs: PyTree | None = None):
    """This rank's :class:`~repro_torch.core.mirror.SearchState` from
    ``params0``: ``core.mirror.init_search`` made block by block, W an f32
    copy of the rank's block of each leaf, Gamma and V zeros of the
    prunable leaves' blocks, each a :class:`DenseBlock` (whose ``data`` the
    step updates in place) where :func:`search_specs` shards the leaf, the
    whole leaf elsewhere; the whole f32 tree is never made."""
    from repro_torch.core import prng
    from repro_torch.core.mirror import SearchState
    from repro_torch.core.prunable import prunable_map
    mesh = rules.mesh
    specs = search_specs(axes_tree, params0, rules) if specs is None \
        else specs

    def w_leaf(w, spec):
        blk = local_block(w.detach(), spec, mesh).to(torch.float32,
                                                       copy=True)
        return DenseBlock(blk, spec) if sharded(spec, mesh) else blk

    W = tree.tree_map(w_leaf, params0, specs)

    def zeros(w, p):
        if not p:
            return None
        z = torch.zeros(block_data(w).shape, dtype=torch.float32,
                        device=block_data(w).device)
        return DenseBlock(z, w.spec) if isinstance(w, DenseBlock) else z

    pr = prunable_map(params0)
    return SearchState(W=W, Gamma=tree.tree_map(zeros, W, pr),
                       V=tree.tree_map(zeros, W, pr), step=0,
                       rng=prng.key(seed))


def place_stats(stats: PyTree, specs: PyTree, rules: ShardingRules
                ) -> PyTree:
    """Each stats leaf (a kernel's per-input-feature norms, whole on every
    rank) as the block of its W leaf's spec without the N entry (a block
    placed already stays as it is)."""
    return tree.tree_map(
        lambda a, spec: None if a is None else _place(
            a, P(*(tuple(spec) + (None,) * (len(a.shape) + 1
                                            - len(spec)))[:-1]),
            rules.mesh), stats, specs)


def block_data(x):
    """A leaf's tensor: a :class:`DenseBlock`'s block, or the leaf."""
    return x.data if isinstance(x, DenseBlock) else x


def like_block(leaf, t: torch.Tensor):
    """``t`` in ``leaf``'s form: a :class:`DenseBlock` of its spec where
    ``leaf`` is one, else ``t``."""
    return DenseBlock(t, leaf.spec) if isinstance(leaf, DenseBlock) else t


def whole(x, mesh) -> torch.Tensor:
    """The whole leaf of a :class:`DenseBlock` (its blocks gathered along
    every sharded dim, on every rank), or the tensor itself."""
    if not isinstance(x, DenseBlock):
        return x
    t = x.data
    for dim, e in enumerate(x.spec):
        t = mesh.all_gather(t, e, dim)
    return t


def gather_state(state, stats: PyTree, rules: ShardingRules):
    """(Gamma, V, stats) whole on rank 0 (None on the others), for the
    bank: each leaf gathered in turn, so another rank holds one whole leaf
    at a time."""
    mesh = rules.mesh

    def one(x):
        t = whole(x, mesh)
        return t if mesh.rank == 0 else None

    out = tuple(tree.tree_map(lambda x: None if x is None else one(x), t)
                for t in (state.Gamma, state.V, stats))
    return out if mesh.rank == 0 else None


class LeafLayout:
    """One search-state leaf's block on the mesh (``spec`` the leaf's, one
    entry a dim): the whole leaf's reductions, draws and sizes from this
    rank's block (``core.metrics``, ``core.mirror``).  Under autograd the
    row and column sums are differentiable with the alignment term's
    backward (``kernels.shard.sum_terms``)."""

    def __init__(self, spec, mesh, ndim: int):
        self.entries = tuple(spec) + (None,) * (ndim - len(spec))
        self.mesh = mesh
        used = {a for e in self.entries for a in _ax_tuple(e)}
        # every axis the leaf is split over, in the mesh's order
        self.axes = tuple(a for a in mesh.axis_names if a in used)

    def sum_n(self, t: torch.Tensor) -> torch.Tensor:
        """Sums over N (the last dim), whole."""
        from repro_torch.kernels.shard import sum_terms
        return sum_terms(t, self.mesh, self.entries[-1])

    def sum_k(self, t: torch.Tensor) -> torch.Tensor:
        """Sums over K (the second-to-last dim), whole."""
        from repro_torch.kernels.shard import sum_terms
        return sum_terms(t, self.mesh, self.entries[-2])

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """A per-block partial summed over the leaf's ranks (a replicated
        copy counted once)."""
        return self.mesh.all_reduce(t, self.axes) if self.axes else t

    def whole_shape(self, block: torch.Tensor) -> tuple[int, ...]:
        """The whole leaf's shape."""
        return tuple(d * axes_size(self.mesh, e)
                     for d, e in zip(block.shape, self.entries))

    def numel(self, block: torch.Tensor) -> int:
        """The whole leaf's element count."""
        n = block.numel()
        for e in self.entries:
            n *= axes_size(self.mesh, e)
        return n

    def slice(self, v: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a whole vector ``v`` along the leaf's
        ``dim`` (dim 0 of ``v``)."""
        return local_block(v, P(self.entries[dim]), self.mesh)

    def median(self, t: torch.Tensor) -> torch.Tensor:
        """``sort(whole.flatten())[n // 2]`` of the whole leaf whose block
        is ``t`` (f32), exactly, as a device scalar, without gathering the
        leaf: a bisection over the floats' order (their bit patterns
        mapped to ordered int32 keys), each of its 32 rounds counting the
        keys at or below the midpoint in every block (an all-reduce of one
        count over the leaf's ranks)."""
        bits = t.detach().reshape(-1).view(torch.int32)
        key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
        target = self.numel(t) // 2 + 1
        # the bounds in int64, so hi - lo cannot overflow; mid fits int32
        lo = torch.full((), -2 ** 31, dtype=torch.int64, device=t.device)
        hi = torch.full((), 2 ** 31 - 1, dtype=torch.int64, device=t.device)
        for _ in range(32):
            mid = lo + (hi - lo) // 2
            below = self.total((key <= mid.to(torch.int32)).sum())
            lo = torch.where(below >= target, lo, mid + 1)
            hi = torch.where(below >= target, mid, hi)
        k = lo.to(torch.int32)
        return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)
