"""The port's sharding layout (``repro_torch.dist``, ``launch.mesh``, the
``SparseTensor`` tags) against the reference's, in one process, with no
ranks.

The reference's spec derivation is pure logic over a mesh's axis names and
sizes, so it runs here on ``jax.sharding.AbstractMesh(sizes, names)`` (the
jax 0.9 signature; tests/test_dist.py's ``mesh22`` fixture passes the older
``((name, size), ...)`` form, which jax 0.9 refuses: ROADMAP R15) and the
port's on the same object.  Every spec, tag and warning is compared entry
for entry: rules, specs, compressed-leaf layouts and tags over smoke
llama3.2-1b's and mixtral-8x22b's params at idx_bits 2 and 8 (2:4 by
magnitude), params / cache / batch / search-state specs, and each rank's
block shape against ``NamedSharding(mesh, spec).shard_shape``.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from _torch_port import one_torch_thread, to_jax  # noqa: F401
from repro.core.mirror import SearchState as JaxSearchState
from repro.dist import axes as jaxes
from repro.dist import sharding as jshd
from repro.sparse.formats import BitMask as JaxBitMask
from repro.sparse.formats import SparseTensor as JaxSparseTensor
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import mirror as tmirror
from repro_torch.dist import axes as taxes
from repro_torch.dist import sharding as tshd
from repro_torch.kernels import shard as tksh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM
from repro_torch.sparse import apply as tapply
from repro_torch.sparse.formats import BitMask, SparseTensor

MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
ARCHS = ("llama3.2-1b", "mixtral-8x22b")


def _mesh(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names)


def _spec(sh):
    """A reference NamedSharding's spec."""
    return sh.spec


@pytest.fixture(scope="module")
def smoke():
    """{(arch, idx_bits): (cfg, port tree 2:4 by magnitude, the same tree
    for the reference)} over smoke llama and mixtral, params drawn by the
    port (seed 0)."""
    out = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        tp = TM.init_params(cfg, 0, device="cpu")
        tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
            lambda _: None, tp), 0.5, mode="nm")
        for bits in (2, 8):
            sp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                        idx_bits=bits, dtype=torch.bfloat16)
            out[arch, bits] = (cfg, sp, to_jax(sp))
    return out


def _jax_axes(cfg):
    """The port's axes tree is the reference's (tests/test_torch_model.py
    holds ``param_axes`` equal); as a reference tree for its tree_map."""
    return TM.param_axes(cfg)


# ---------------------------------------------------------------------------
# Rules and specs
# ---------------------------------------------------------------------------

NAMES = [("embed", "mlp"), ("mlp", "embed"), ("vocab", "embed"),
         ("layers", "embed", "qkv"), ("experts", "embed", "mlp"),
         ("layers", "", "mlp", "embed"), ("batch", "seq", "embed_act"),
         ("heads", "kv_heads"), ("mlp", "mlp"), ("embed", "embed"),
         ("act_seq", "kv_seq"), (None, "qkv"), ()]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("seq_shard_kv", [False, "model", "all"])
def test_make_rules_and_spec_match_reference(mesh, seq_parallel,
                                             seq_shard_kv):
    m = _mesh(mesh)
    kw = dict(seq_parallel=seq_parallel, seq_shard_kv=seq_shard_kv)
    t, j = taxes.make_rules(m, **kw), jaxes.make_rules(m, **kw)
    assert t.rules == j.rules
    p, jp = tshd.make_production_rules(m, **kw), \
        jshd.make_production_rules(m, **kw)
    assert p.rules == jp.rules
    for names in NAMES:
        assert t.spec(names) == j.spec(names), names
        assert isinstance(t.spec(names), taxes.PartitionSpec)
        for shape in ((8, 12), (6, 5), (16, 64, 64), (3, 4, 2, 8)):
            want = jaxes.spec_for_shape(j, names, shape)
            assert taxes.spec_for_shape(t, names, shape) == want, \
                (names, shape)


def test_spec_dedupes_repeated_mesh_axes_and_compares_with_jax():
    m = _mesh("2x2")
    t = taxes.ShardingRules(mesh=m, rules={"a": "model", "b": "model",
                                           "c": ("data", "model")})
    j = jaxes.ShardingRules(mesh=m, rules=dict(t.rules))
    for names in (["a", "b"], ["c", "a"], ["a", "c"], ["b", None, "c"]):
        assert t.spec(names) == j.spec(names)
    assert t.spec(["a", "b"]) == JP("model", None)
    assert JP("model", None) == t.spec(["a", "b"])
    # the identity: activations stay replicated
    x = torch.ones(3)
    with taxes.use_rules(t):
        assert taxes.current_rules() is t
        assert taxes.constrain(x, "batch") is x
    assert taxes.current_rules() is None


# ---------------------------------------------------------------------------
# Compressed leaves: layouts, tags, the loud fallback
# ---------------------------------------------------------------------------

def _sparse_leaves(cfg, sp):
    axes = dict(tree.flatten_with_path(TM.param_axes(cfg)))
    return [(p, axes[p], w) for p, w in tree.flatten_with_path(sp)
            if isinstance(w, SparseTensor)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", [2, 8])
def test_sparse_component_layout_and_tags_match_reference(smoke, mesh, arch,
                                                          bits):
    cfg, sp, jsp = smoke[arch, bits]
    m = _mesh(mesh)
    t, j = taxes.make_rules(m), jaxes.make_rules(m)
    leaves = _sparse_leaves(cfg, sp)
    assert len(leaves) == 7
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jsp, is_leaf=lambda x: isinstance(x, JaxSparseTensor))[0])
    jflat = {jax.tree_util.keystr(k): v for k, v in jflat.items()}
    for path, ax, st in leaves:
        got = tshd.sparse_component_layout(ax, st, t, path=path, quiet=True)
        want = jshd.sparse_component_layout(ax, jflat[path], j, path=path,
                                            quiet=True)
        assert got == want, (path, got, want)
    tagged = tshd.tag_compressed(TM.param_axes(cfg), sp, t)
    jtagged = jshd.tag_compressed(_jax_axes(cfg), jsp, j)
    jt = {jax.tree_util.keystr(k): v for k, v in
          jax.tree_util.tree_flatten_with_path(
              jtagged, is_leaf=lambda x: isinstance(x, JaxSparseTensor))[0]}
    for path, w in tree.flatten_with_path(tagged):
        if isinstance(w, SparseTensor):
            assert w.shard == jt[path].shard, path
            assert w.k_shard == jt[path].k_shard, path
            assert w.shard_site == jt[path].shard_site, path
            if w.shard is None:      # untouched by identity, as the ref's
                assert w is dict(tree.flatten_with_path(sp))[path]


def test_mixtral_down_bank_tag_on_1x4_and_2x2(smoke):
    cfg, sp, _ = smoke["mixtral-8x22b", 2]
    path = "['stages'][0]['0']['moe']['down']['kernel']"
    for mesh, want in (("1x4", ("moe", None, "model", None)),
                       ("2x2", ("moe", None, "model", "data"))):
        tagged = tshd.tag_compressed(TM.param_axes(cfg), sp,
                                     taxes.make_rules(_mesh(mesh)))
        st = dict(tree.flatten_with_path(tagged))[path]
        assert st.shard == want and st.k_shard == "model", (mesh, st.shard)


def _dff72(idx_bits):
    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), d_ff=72)
    tp = TM.init_params(cfg, 0, device="cpu")
    tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
        lambda _: None, tp), 0.5, mode="nm")
    sp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                idx_bits=idx_bits, dtype=torch.bfloat16)
    return cfg, sp


@pytest.mark.parametrize("bits", [2, 8])
def test_dff72_warns_and_replicates_both_components(bits):
    """d_ff=72 on (1, 4): the down kernel's K cannot shard (needs K % 32
    for packed2, K % 16 for int8): BOTH components replicate K and the
    warning names the leaf, in both packages."""
    cfg, sp = _dff72(bits)
    m = _mesh("1x4")
    path = "['stages'][0]['0']['mlp']['down']['kernel']"
    with pytest.warns(UserWarning, match="cannot shard over mesh axis") as rec:
        specs = tshd.params_sharding(TM.param_axes(cfg), sp,
                                     taxes.make_rules(m))
    assert any(path in str(w.message) for w in rec)
    with pytest.warns(UserWarning, match="cannot shard over mesh axis") as jrec:
        jspecs = jshd.params_sharding(_jax_axes(cfg), to_jax(sp),
                                      jaxes.make_rules(m))
    assert sorted(str(w.message) for w in rec) == \
        sorted(str(w.message) for w in jrec)
    down = dict(tree.flatten_with_path(specs))[path]
    assert down.vals == down.idx == (None, None, "data")
    jdown = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JaxSparseTensor))[0]
    jdown = {jax.tree_util.keystr(k): v for k, v in jdown}[path]
    assert down.vals == _spec(jdown.vals) and down.idx == _spec(jdown.idx)
    tagged = tshd.tag_compressed(TM.param_axes(cfg), sp,
                                 taxes.make_rules(m))
    assert dict(tree.flatten_with_path(tagged))[path].shard is None


def test_force_replicated_stamps_no_tag(smoke, monkeypatch):
    cfg, sp, jsp = smoke["llama3.2-1b", 2]
    monkeypatch.setenv(tksh.FORCE_REPLICATED_ENV, "1")
    m = _mesh("2x2")
    tagged = tshd.tag_compressed(TM.param_axes(cfg), sp, taxes.make_rules(m))
    assert all(w.shard is None for w in tree.leaves(tagged)
               if isinstance(w, SparseTensor))
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # forced: no fallback warning
        specs = tshd.params_sharding(TM.param_axes(cfg), sp,
                                     taxes.make_rules(m))
        jspecs = jshd.params_sharding(_jax_axes(cfg), jsp,
                                      jaxes.make_rules(m))
    _same_specs(specs, jspecs)
    assert tksh.kv_shard_axes(4, 32, taxes.make_rules(m)) == ()
    assert tshd.place_caches([{"k": torch.zeros(1, 4, 32, 2, 8)}],
                             taxes.make_rules(
                                 tmesh.Mesh((2, 2), ("data", "model"))))[0]["k"].shape \
        == (1, 4, 32, 2, 8)


def test_k_sharded_gates_on_rules_tag_and_env(smoke, monkeypatch):
    """tests/test_tp.py's gate, on the port: the K-sharded route only with
    a tag AND installed rules; REPRO_FORCE_REPLICATED kills it."""
    st = next(w for w in tree.leaves(smoke["llama3.2-1b", 2][1])
              if isinstance(w, SparseTensor)).select(0)
    tagged = st.with_shard(("mlp", "model", None))
    rules = taxes.make_rules(_mesh("1x4"))
    assert not tksh.k_sharded(tagged)
    with taxes.use_rules(rules):
        assert tksh.k_sharded(tagged)
        assert not tksh.k_sharded(st)
        assert tksh.pair_k_sharded(tagged, tagged)
        assert not tksh.pair_k_sharded(tagged,
                                       st.with_shard(("mlp", "data", None)))
        monkeypatch.setenv(tksh.FORCE_REPLICATED_ENV, "1")
        assert not tksh.k_sharded(tagged)


def test_tag_survives_flatten_to_and_select(smoke):
    cfg, sp, _ = smoke["llama3.2-1b", 2]
    tagged = tshd.tag_compressed(TM.param_axes(cfg), sp,
                                 taxes.make_rules(_mesh("2x2")))
    path = "['stages'][0]['0']['mlp']['up']['kernel']"
    st = dict(tree.flatten_with_path(tagged))[path]
    assert st.shard == ("mlp", "data", "model")
    back = tree.unflatten_like(tagged, tree.leaves(tagged))
    assert dict(tree.flatten_with_path(back))[path].shard == st.shard
    moved = tree.to_device(tagged, "cpu")
    assert dict(tree.flatten_with_path(moved))[path].shard == st.shard
    assert st.to(torch.bfloat16).shard == st.shard
    one = st.select(1)
    assert one.shard == st.shard and one.shape == st.shape[1:]
    assert one.with_shard(None).shard is None and one.shard_site == "mlp"
    assert "shard=" in repr(st)


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------

def _same_specs(got, want):
    """A port spec tree against the reference's NamedSharding tree."""
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(
                 want, is_leaf=lambda x: isinstance(
                     x, (JaxSparseTensor, JaxBitMask, NamedSharding))
                 or x is None)[0]}
    tflat = dict(tree.flatten_with_path(got))
    assert list(tflat) == list(jflat)
    for path, w in jflat.items():
        g = tflat[path]
        if w is None:
            assert g is None, path
        elif isinstance(w, JaxSparseTensor):
            assert (g.vals, g.idx, g.idx_bits, g.shard) == \
                (_spec(w.vals), _spec(w.idx), w.idx_bits, w.shard), path
        elif isinstance(w, JaxBitMask):
            assert g.bits == _spec(w.bits) and g.shape == w.shape, path
        else:
            assert g == _spec(w), (path, g, _spec(w))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_sharding_matches_reference(smoke, mesh, arch):
    m = _mesh(mesh)
    t, j = taxes.make_rules(m), jaxes.make_rules(m)
    for bits in (2, 8):
        cfg, sp, jsp = smoke[arch, bits]
        _same_specs(tshd.params_sharding(TM.param_axes(cfg), sp, t),
                    jshd.params_sharding(_jax_axes(cfg), jsp, j))
    # the dense tree, by shapes alone
    cfg = get_smoke_config(arch)
    shapes = TM.param_shapes(cfg)
    jshapes = tree.tree_map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
                            shapes)
    _same_specs(tshd.params_sharding(TM.param_axes(cfg), shapes, t),
                jshd.params_sharding(_jax_axes(cfg), jshapes, j))


def test_params_sharding_bitmask_replicates():
    m = _mesh("2x2")
    mask = torch.rand(3, 64, 64, generator=torch.Generator().manual_seed(0)) \
        > 0.5
    out = tshd.params_sharding({"kernel": "layers|embed|mlp", "mask": None},
                               {"kernel": torch.zeros(3, 64, 64),
                                "mask": BitMask.pack(mask[0])},
                               taxes.make_rules(m))
    assert out["kernel"] == (None, "data", "model")
    assert out["mask"].bits == () and out["mask"].shape == (64, 64)


def _cache_tree(cfg, B, C):
    return TM.init_caches(cfg, B, C, device="meta")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,C", [(4, 32), (1, 64), (3, 24), (2, 30)])
def test_cache_and_batch_sharding_match_reference(mesh, arch, B, C):
    m = _mesh(mesh)
    caches = _cache_tree(get_smoke_config(arch), B, C)
    jcaches = tree.tree_map(
        lambda c: jax.ShapeDtypeStruct(tuple(c.shape), jnp.bfloat16), caches)
    _same_specs(tshd.cache_sharding(caches, m),
                jshd.cache_sharding(jcaches, m))
    batch = {"tokens": (B, C), "frames": (B, 16, 8), "none": None}
    jbatch = {k: None if v is None else jax.ShapeDtypeStruct(v, jnp.int32)
              for k, v in batch.items()}
    _same_specs(tshd.batch_sharding_tree(batch, m),
                jshd.batch_sharding_tree(jbatch, m))
    stacked = {"tokens": (5, B, C), "flat": (B,)}
    jstacked = {k: jax.ShapeDtypeStruct(v, jnp.int32)
                for k, v in stacked.items()}
    _same_specs(tshd.stacked_batch_sharding(stacked, m),
                jshd.stacked_batch_sharding(jstacked, m))


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_search_state_sharding_matches_reference(mesh):
    cfg = get_smoke_config("llama3.2-1b")
    m = _mesh(mesh)
    state = tmirror.init_search(TM.init_params(cfg, 0, device="cpu"), 0)
    sds = lambda t: None if t is None else jax.ShapeDtypeStruct(  # noqa
        tuple(t.shape), jnp.float32)
    jstate = JaxSearchState(W=tree.tree_map(sds, state.W),
                            Gamma=tree.tree_map(sds, state.Gamma),
                            V=tree.tree_map(sds, state.V),
                            step=jnp.zeros((), jnp.int32),
                            rng=jax.random.key(0))
    got = tshd.search_state_sharding(TM.param_axes(cfg), state,
                                     taxes.make_rules(m))
    want = jshd.search_state_sharding(_jax_axes(cfg), jstate,
                                      jaxes.make_rules(m))
    for name in ("W", "Gamma", "V"):
        _same_specs(getattr(got, name), getattr(want, name))
    assert got.step == _spec(want.step) and got.rng == _spec(want.rng)


# ---------------------------------------------------------------------------
# Each rank's block
# ---------------------------------------------------------------------------

def test_mesh_coords_are_row_major():
    """Rank r's coordinates are np.unravel_index(r, shape): the order in
    which jax.make_mesh lays a host's devices out (a reshape of the device
    list), so rank r holds device r's block."""
    for sizes, names in MESHES.values():
        for r in range(int(np.prod(sizes))):
            mesh = tmesh.Mesh(sizes, names, rank=r)
            assert tuple(mesh.coords[a] for a in names) == \
                tuple(int(i) for i in np.unravel_index(r, sizes))
            assert mesh.index(names) == r
            assert mesh.index(tuple(reversed(names))) == int(
                np.ravel_multi_index(tuple(reversed(
                    np.unravel_index(r, sizes))), tuple(reversed(sizes))))
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    host = tmesh.make_host_mesh()
    assert host.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(model=2)
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.Mesh((2, 2), ("data", "model")).all_reduce(
            torch.ones(2), "model")


def _blocks_match(specs, jspecs_shape, mesh_name, leaves):
    """Every rank's local_block of every leaf has the reference's
    NamedSharding(mesh, spec).shard_shape."""
    sizes, names = MESHES[mesh_name]
    am = _mesh(mesh_name)
    for r in range(int(np.prod(sizes))):
        mesh = tmesh.Mesh(sizes, names, rank=r)
        for path, t in leaves:
            spec = specs[path]
            want = NamedSharding(am, JP(*spec)).shard_shape(tuple(t.shape))
            got = tshd.local_block(t, spec, mesh)
            assert tuple(got.shape) == want, (path, r)
            assert tuple(got.shape) == tshd.block_shape(t.shape, spec, mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_local_block_shapes_match_named_sharding(smoke, mesh, arch):
    cfg, sp, _ = smoke[arch, 2]
    specs = tshd.params_sharding(TM.param_axes(cfg), sp,
                                 taxes.make_rules(_mesh(mesh)))
    flat, leaves = {}, []
    for path, s in tree.flatten_with_path(specs):
        w = dict(tree.flatten_with_path(sp))[path]
        if isinstance(w, SparseTensor):
            flat[path + ".vals"], flat[path + ".idx"] = s.vals, s.idx
            leaves += [(path + ".vals", w.vals), (path + ".idx", w.idx)]
        else:
            flat[path] = s
            leaves.append((path, w))
    _blocks_match(flat, None, mesh, leaves)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_place_params_keeps_each_ranks_block(smoke, mesh):
    """``place_params`` on every rank of a layout-only mesh: each leaf's
    block (SparseTensor components, DenseBlock data) is its local_block,
    in storage of its own, and the ranks' blocks tile the leaf."""
    cfg, sp, _ = smoke["mixtral-8x22b", 2]
    sizes, names = MESHES[mesh]
    axes = TM.param_axes(cfg)
    specs = dict(tree.flatten_with_path(tshd.params_sharding(
        axes, sp, taxes.make_rules(_mesh(mesh)))))
    whole = dict(tree.flatten_with_path(sp))
    tags = {p: w.shard for p, w in tree.flatten_with_path(
        tshd.tag_compressed(axes, sp, taxes.make_rules(_mesh(mesh))))
        if isinstance(w, SparseTensor)}
    stored = 0
    for r in range(int(np.prod(sizes))):
        m = tmesh.Mesh(sizes, names, rank=r)
        placed = tshd.place_params(axes, sp, taxes.make_rules(m))
        for path, w in tree.flatten_with_path(placed):
            spec = specs[path]
            if isinstance(w, SparseTensor):
                for part, s in ((w.vals, spec.vals), (w.idx, spec.idx)):
                    want = tshd.local_block(getattr(whole[path], "vals" if
                                                    part is w.vals else
                                                    "idx"), s, m)
                    assert torch.equal(part, want), path
                    stored += part.untyped_storage().nbytes()
                assert w.shard == tags[path]
                assert (w.block is None) == (not tshd.sharded(spec.vals, m))
            elif isinstance(w, tshd.DenseBlock):
                assert torch.equal(w.data, tshd.local_block(whole[path],
                                                            spec, m))
                assert w.data.untyped_storage().nbytes() == w.nbytes
                stored += w.nbytes
            else:
                assert w is whole[path] and not tshd.sharded(spec, m)
                stored += w.untyped_storage().nbytes()
    # a leaf is stored once a block: world / (ranks it is split over) times
    def nbytes(t):
        return t.numel() * t.element_size()
    total = 0
    for path, w in whole.items():
        n = (nbytes(w.vals) + nbytes(w.idx)) if isinstance(w, SparseTensor) \
            else nbytes(w)
        spec = specs[path].vals if isinstance(w, SparseTensor) \
            else specs[path]
        split = int(np.prod([tksh.axes_size(_mesh(mesh), e) for e in spec]))
        total += n * int(np.prod(sizes)) // split
    assert stored == total


def test_place_caches_splits_capacity_where_attention_runs_across_ranks():
    cfg = get_smoke_config("mixtral-8x22b")        # window 16
    m = tmesh.Mesh((1, 4), ("data", "model"), rank=2)
    rules = taxes.make_rules(m)
    for B, C, want in ((2, 32, 4), (1, 32, 16), (2, 8, 2), (2, 6, 6)):
        caches = TM.init_caches(cfg, B, C, device="cpu")
        placed = tshd.place_caches(caches, rules)
        ring = min(C, 16)
        assert placed[0]["0"]["k"].shape[2] == want, (B, C)
        assert bool(tksh.kv_shard_axes(B, ring, rules)) == (want != ring)


def test_moe_dispatch_groups_follow_the_batch_axes():
    """Under rules the MoE dispatch splits the tokens into the "batch"
    axes' groups (2 on (2, 2), 1 on (1, 4)), each with its own expert
    capacity (``repro/models/moe.py:53-65``): the output equals each half
    of the tokens dispatched on its own; under 8 tokens a group it falls
    back to one group."""
    from repro_torch.dist.axes import use_rules
    from repro_torch.models import moe
    cfg = get_smoke_config("mixtral-8x22b")
    p = TM.init_params(cfg, 0, device="cpu")["stages"][0]["0"]["moe"]
    p = tree.tree_map(lambda a: a[0], p)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 16, cfg.d_model), generator=g).to(torch.bfloat16)
    kw = dict(top_k=cfg.top_k, capacity_factor=0.5)
    halves = torch.cat([moe.moe_apply(p, x[i:i + 1], **kw)[0]
                        for i in range(2)])
    whole = moe.moe_apply(p, x, **kw)[0]
    assert not torch.equal(halves, whole)      # capacity drops differ
    for mesh, want in (("2x2", halves), ("1x4", whole)):
        rules = taxes.make_rules(tmesh.Mesh(*MESHES[mesh]))
        with use_rules(rules):
            assert moe._dp_setup() == MESHES[mesh][0][0]
            assert torch.equal(moe.moe_apply(p, x, **kw)[0], want), mesh
    # 8 tokens: 4 a group, under 8: one group, as without rules
    with use_rules(taxes.make_rules(tmesh.Mesh(*MESHES["2x2"]))):
        small = moe.moe_apply(p, x[:, :4], **kw)[0]
    assert torch.equal(small, moe.moe_apply(p, x[:, :4], **kw)[0])
