"""Helpers shared by the tests/test_torch_*.py files: carry arrays between
the JAX reference and the repro_torch port and compare trees leaf by leaf
by key path."""
import jax
import numpy as np
import torch

from repro.sparse.formats import SparseTensor as JaxSparseTensor
from repro_torch import tree
from repro_torch.convert import params_from_numpy
from repro_torch.sparse.formats import SparseTensor


def to_torch(a) -> torch.Tensor:
    """One jax/numpy array -> torch tensor (bf16 by its bits)."""
    return params_from_numpy(a)


def bits(a) -> np.ndarray:
    """Exact-comparison view of a jax array or torch tensor: bf16 as its
    16-bit patterns, everything else as numpy."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.cpu().view(torch.int16).numpy().view(np.uint16)
        return a.cpu().numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def jax_params_to_torch(params):
    return params_from_numpy(jax.device_get(params))


def jax_flat(t) -> dict:
    """keystr path -> leaf (None and SparseTensor kept whole)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: x is None or isinstance(x, JaxSparseTensor))
    return {jax.tree_util.keystr(kp): v for kp, v in flat}


def assert_same_leaves(jax_tree, torch_tree):
    """Same key paths, and every leaf bit-identical (SparseTensors by their
    vals and index planes)."""
    jf = jax_flat(jax_tree)
    tf = dict(tree.flatten_with_path(torch_tree))
    assert list(jf) == list(tf)
    for path, jv in jf.items():
        tv = tf[path]
        if jv is None:
            assert tv is None, path
        elif isinstance(jv, JaxSparseTensor):
            assert isinstance(tv, SparseTensor), path
            assert tv.idx_bits == jv.idx_bits, path
            np.testing.assert_array_equal(bits(tv.vals), bits(jv.vals),
                                          err_msg=path)
            np.testing.assert_array_equal(bits(tv.idx), bits(jv.idx),
                                          err_msg=path)
        else:
            assert tuple(tv.shape) == tuple(jv.shape), path
            np.testing.assert_array_equal(bits(tv), bits(jv), err_msg=path)


def f64(t) -> np.ndarray:
    """A torch tensor or jax/numpy array as float64 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(t, np.float64)


def leaf_pairs(jax_tree, torch_tree) -> list:
    """(keystr path, jax leaf, torch leaf) over the jax tree's non-None
    leaves."""
    tf = dict(tree.flatten_with_path(torch_tree))
    return [(p, jv, tf[p]) for p, jv in jax_flat(jax_tree).items()
            if jv is not None]


def smoke_llama():
    """(jax cfg, torch cfg, jax params, the same params in torch, the
    launcher's calibration batches: 8 x 4 x 64 tokens) for the smoke
    llama3.2-1b, the reference's params from ``jax.random.key(0)``."""
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro.data.synthetic import batches_for
    from repro.models import model as JM
    from repro_torch.configs.base import get_smoke_config
    jcfg = jax_smoke_config("llama3.2-1b")
    jp = JM.init_params(jcfg, jax.random.key(0))
    calib = batches_for(jcfg, n=8, batch=4, seq=64, split="calib")
    return (jcfg, get_smoke_config("llama3.2-1b"), jp,
            jax_params_to_torch(jp), calib)
