"""repro_torch masks, compressed format and mask bank against the JAX
reference on the smoke llama.  Every output here is integer or a
bit-exact copy (masks, index planes, SparseTensor vals, checksums), so
every comparison is exact."""
import dataclasses
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_same_leaves, jax_flat, jax_params_to_torch,
                         to_torch)
from repro.configs.base import PruneConfig as JaxPruneConfig
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.core import calibrate as jcal
from repro.core import masks as jmasks
from repro.models import model as JM
from repro.sparse import apply as japply
from repro.sparse.bank import MaskBank as JaxMaskBank
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.core import masks as tmasks
from repro_torch.models import model as TM
from repro_torch.sparse import apply as tapply
from repro_torch.sparse.bank import MaskBank, _tree_checksum
from repro_torch.sparse.pack import pack_nm

BANK = pathlib.Path(__file__).parent.parent / "results" / "bank" / \
    "llama3.2-1b"


@pytest.fixture(scope="module")
def smoke():
    jcfg = jax_smoke_config("llama3.2-1b")
    jparams = JM.init_params(jcfg, jax.random.key(0))
    none = jax.tree.map(lambda _: None, jparams)
    jm = jcal.baseline_masks("magnitude", jparams, none, 0.5, mode="nm")
    cfg = get_smoke_config("llama3.2-1b")
    params = jax_params_to_torch(jparams)
    m = tcal.baseline_masks("magnitude", params,
                            tree.tree_map(lambda _: None, params), 0.5,
                            mode="nm")
    return jcfg, jparams, jm, cfg, params, m


def test_configs_match_field_for_field(smoke):
    jcfg, _, _, cfg, _, _ = smoke
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    from repro_torch.configs.base import PruneConfig
    assert dataclasses.asdict(PruneConfig()) == \
        dataclasses.asdict(JaxPruneConfig())


def test_param_axes_and_shapes_match(smoke):
    jcfg, jparams, _, cfg, params, _ = smoke
    ja = jax_flat(JM.param_axes(jcfg))
    assert ja == dict(tree.flatten_with_path(TM.param_axes(cfg)))
    shapes = dict(tree.flatten_with_path(TM.param_shapes(cfg)))
    assert shapes == {p: tuple(v.shape) for p, v in jax_flat(jparams).items()}


def test_baseline_and_nm_masks_equal_reference(smoke):
    _, _, jm, _, _, m = smoke
    assert_same_leaves(jm, m)
    s = np.random.default_rng(1).integers(-3, 4, (4, 64, 24)).astype(
        np.float32)   # stacked leaf, heavy ties
    for n, mm in ((2, 4), (1, 4), (2, 8)):
        want = jmasks.nm_masks({"a": jnp.asarray(s)}, n, mm)["a"]
        got = tmasks.nm_masks({"a": torch.from_numpy(s)}, n, mm)["a"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scope", ["global", "layer", "row"])
def test_unstructured_masks_equal_reference(scope):
    rng = np.random.default_rng(2)
    s = {"a": rng.standard_normal((2, 64, 32)).astype(np.float32),
         "b": None, "c": rng.standard_normal((48, 16)).astype(np.float32)}
    js = {k: None if v is None else jnp.asarray(v) for k, v in s.items()}
    ts = {k: None if v is None else torch.from_numpy(v) for k, v in s.items()}
    for sp in (0.3, 0.5, 0.9):
        want = jmasks.unstructured_masks(js, sp, scope=scope)
        got = tmasks.unstructured_masks(ts, sp, scope=scope)
        assert got["b"] is None
        for k in ("a", "c"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_threshold_bisect_matches_reference():
    rng = np.random.default_rng(3)
    s = [rng.standard_normal((64, 32)).astype(np.float32), None]
    want = jmasks.threshold_bisect([jnp.asarray(s[0]), None], 0.6)
    got = tmasks.threshold_bisect([torch.from_numpy(s[0]), None], 0.6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("idx_bits", [2, 8])
def test_pack_and_sparsify_params_equal_reference(smoke, idx_bits):
    jcfg, jparams, jm, cfg, params, m = smoke
    jsp = japply.sparsify_params(jparams, jm, axes=JM.param_axes(jcfg),
                                 idx_bits=idx_bits, dtype=jnp.bfloat16)
    tsp = tapply.sparsify_params(params, m, axes=TM.param_axes(cfg),
                                 idx_bits=idx_bits, dtype=torch.bfloat16)
    assert_same_leaves(jsp, tsp)
    rep = tapply.compressed_report(tsp, m)
    jrep = japply.compressed_report(jsp, jm)
    assert rep["ratio"] == jrep["ratio"]
    if idx_bits == 2:
        assert rep["ratio"] == 0.5625
    assert rep["kernel_native_packed"] == jrep["kernel_native_packed"]
    assert rep["fallback_leaves"] == 0
    # to_dense is W * mask, exactly
    path = "['stages'][0]['0']['mlp']['down']['kernel']"
    st = dict(tree.flatten_with_path(tsp))[path]
    w = dict(tree.flatten_with_path(params))[path]
    mk = dict(tree.flatten_with_path(m))[path]
    assert torch.equal(st.to_dense(), (w * mk).to(torch.bfloat16))


def test_pack_nm_pads_packed_plane_when_k_is_not_a_multiple_of_8():
    from repro.sparse.pack import pack_nm as jax_pack_nm
    rng = np.random.default_rng(4)
    w = rng.standard_normal((12, 10)).astype(np.float32)   # K % 8 == 4
    mk = np.array(jmasks.nm_masks({"w": jnp.asarray(w)})["w"])
    js = jax_pack_nm(jnp.asarray(w), jnp.asarray(mk), idx_bits=2)
    ts = pack_nm(torch.from_numpy(w), torch.from_numpy(mk), idx_bits=2)
    np.testing.assert_array_equal(ts.idx.numpy(), np.asarray(js.idx))
    np.testing.assert_array_equal(ts.vals.numpy(), np.asarray(js.vals))
    assert ts.kernel_layout == "int8"
    assert torch.equal(ts.to_dense(), torch.from_numpy(w * mk))


@pytest.fixture(scope="module")
def banks():
    return JaxMaskBank.load(BANK), MaskBank.load(BANK, device="cpu")


def test_bank_checksum_and_state_equal_reference(banks):
    jb, tb = banks
    meta = json.loads((BANK / "manifest.json").read_text())["metadata"]
    assert _tree_checksum({"Gamma": tb.Gamma, "V": tb.V,
                           "stats": tb.stats}) == meta["checksum"]
    assert tb.pcfg == type(tb.pcfg)(**dataclasses.asdict(jb.pcfg))
    assert_same_leaves(jb.Gamma, tb.Gamma)
    assert_same_leaves(jb.V, tb.V)


@pytest.mark.parametrize("budget", [{}, {"nm": (2, 4)}, {"sparsity": 0.5},
                                    {"sparsity": 0.7}])
def test_bank_masks_at_equal_reference(banks, budget):
    jb, tb = banks
    assert_same_leaves(jb.masks_at(**budget), tb.masks_at(**budget))


def test_bank_sparse_params_equal_reference(banks):
    jb, tb = banks
    jparams = JM.init_params(jb.cfg, jax.random.key(0))
    assert_same_leaves(jb.sparse_params(jparams),
                       tb.sparse_params(jax_params_to_torch(jparams)))


def test_corrupt_bank_fails_its_checksum(tmp_path):
    bad = tmp_path / "bank"
    shutil.copytree(BANK, bad)
    leaf = sorted(bad.glob("leaf_*.npy"))[0]
    a = np.load(leaf)
    a.reshape(-1)[0] += 1.0
    np.save(leaf, a)
    with pytest.raises(ValueError, match="integrity"):
        MaskBank.load(bad, device="cpu")


def test_masked_tree_mismatch_names_the_key_path(smoke):
    _, _, _, cfg, params, m = smoke
    bad = dict(m)
    bad["extra"] = None
    with pytest.raises(ValueError, match="extra"):
        tapply.sparsify_params(params, bad, axes=TM.param_axes(cfg))


def test_to_torch_roundtrip_is_exact():
    a = jnp.asarray(np.linspace(-3, 3, 17, dtype=np.float32)).astype(
        jnp.bfloat16)
    t = to_torch(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


_MMA_SP_CODES = {0x4, 0x8, 0xC, 0x9, 0xD, 0xE}   # ascending, distinct pairs


@pytest.mark.parametrize("source", ["random", "llama3.2-1b", "llm-mini-nm"])
def test_nm_positions_are_ascending_for_the_mma_sp_kernel(source):
    """The bf16 nm_matmul kernels hand each packed2 nibble (idx0 | idx1 << 2
    of a group) to mma.sp as its 2:4 metadata, which takes only ascending,
    distinct positions: so are those of the port's and the reference's
    packing, on random masks with ties and on the committed 2:4 banks."""
    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.sparse.pack import nm_positions as jax_nm_positions
    from repro.sparse.pack import pack_nm as jax_pack_nm
    from repro_torch.sparse.pack import nm_positions
    if source == "random":
        s = np.random.default_rng(3).integers(-2, 3, (3, 64, 24))
        masks = {"w": np.asarray(jmasks.nm_masks(
            {"w": jnp.asarray(s, jnp.float32)})["w"])}
    else:
        # llm-mini is the example model of examples/prune_llm.py, whose
        # config no registry holds
        cfg = None if source != "llm-mini-nm" else JaxModelConfig(
            name="llm-mini", family="dense", d_model=192, num_layers=6,
            num_heads=6, num_kv_heads=3, head_dim=32, d_ff=512,
            vocab_size=1024)
        bank = JaxMaskBank.load(BANK.parent / source, cfg=cfg)
        assert bank.pcfg.mode == "nm"
        masks = {p: np.asarray(m) for p, m in
                 jax_flat(bank.masks_at()).items() if m is not None}
    assert masks
    rng = np.random.default_rng(5)
    for path, mk in masks.items():
        pos = nm_positions(torch.from_numpy(mk)).numpy()
        np.testing.assert_array_equal(
            pos, np.asarray(jax_nm_positions(jnp.asarray(mk))), err_msg=path)
        pairs = pos.reshape(*pos.shape[:-2], -1, 2, pos.shape[-1])
        assert (pairs[..., 0, :] < pairs[..., 1, :]).all(), path
        assert pos.min() >= 0 and pos.max() <= 3, path
        w = rng.standard_normal(mk.shape).astype(np.float32)
        packed = pack_nm(torch.from_numpy(w), torch.from_numpy(mk),
                         idx_bits=2).idx.numpy()
        np.testing.assert_array_equal(packed, np.asarray(jax_pack_nm(
            jnp.asarray(w), jnp.asarray(mk), idx_bits=2).idx), err_msg=path)
        codes = np.unique(np.stack([packed & 0xF, packed >> 4]))
        assert set(codes.tolist()) <= _MMA_SP_CODES, (path, codes)
