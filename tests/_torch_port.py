"""Helpers shared by the tests/test_torch_*.py files: carry arrays between
the JAX reference and the repro_torch port and compare trees leaf by leaf
by key path."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.sparse.formats import SparseTensor as JaxSparseTensor
from repro_torch import tree
from repro_torch.configs.tiny import FAMILIES
from repro_torch.convert import params_from_numpy
from repro_torch.sparse.formats import SparseTensor


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread for the module, restored after: the
    test runner runs several worker processes on the machine's cores, and
    each torch process spinning up a thread per core slows every worker by
    an order of magnitude.  A module that imports it gets it (autouse)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _near_ties(jscore, jkeep, tkeep, tol):
    """Groups of 4 along K where the keep-masks differ, each with the
    reference's margin between the entries the two masks swapped and the
    tolerance it is held to."""
    K, N = jscore.shape[-2:]
    g = lambda x: x.reshape(-1, K // 4, 4, N)
    js, jk, tk, tl = g(jscore), g(jkeep), g(tkeep), g(tol)
    out = []
    for idx in zip(*np.nonzero((jk != tk).any(axis=2))):
        l, r, n = idx
        s, a, b, t = js[l, r, :, n], jk[l, r, :, n], tk[l, r, :, n], \
            tl[l, r, :, n]
        margin = s[a & ~b].min() - s[b & ~a].max()
        out.append((idx, float(margin), float(2 * t[a ^ b].max())))
    return out


def assert_calibration_matches(jbank, tbank):
    """The port's bank against the reference's, each from its own stats,
    at tests/test_torch_calibrate.py's tolerances: Gamma and V within
    2**-8 (|V_ref| + lam) + 1e-4 max|V_ref| elementwise, 2:4 masks equal
    but for counted near-ties in the reference's scores, the history at
    rtol 2e-3."""
    from repro.core import mirror as jmirror
    tols = {}
    for path, V in jax_flat(jbank.V).items():
        if V is not None:
            V = np.abs(f64(V))
            tols[path] = 2.0 ** -8 * (V + jbank.pcfg.lam) + 1e-4 * V.max()
    for name in ("V", "Gamma"):
        for path, jv, tv in leaf_pairs(getattr(jbank, name),
                                   getattr(tbank, name)):
            np.testing.assert_array_less(np.abs(f64(tv) - f64(jv)),
                                         tols[path], err_msg=name + path)
    # masks: identical but for near-ties in the reference's own scores
    jmask, tmask = jbank.masks_at(), tbank.masks_at()
    eps = float(jmirror._absmax_fused(tuple(
        g for g in jax.tree.leaves(jbank.Gamma) if g is not None)))
    ties = 0
    for path, jk, tk in leaf_pairs(jmask, tmask):
        G, V = f64(jax_flat(jbank.Gamma)[path]), f64(jax_flat(jbank.V)[path])
        vmax = max(float(np.abs(f64(v)).max()) for v in
                   jax.tree.leaves(jbank.V) if v is not None)
        score = np.abs(G) + 1e-6 * eps / vmax * np.abs(V)
        for idx, margin, tol in _near_ties(score, np.asarray(jk),
                                           tk.numpy(), tols[path]):
            print(f"near-tie {path}{list(map(int, idx))}: reference margin "
                  f"{margin:.3e} <= {tol:.3e}")
            assert 0 <= margin <= tol, (path, idx, margin, tol)
            ties += 1
    n = sum(int(np.asarray(m).size) for m in jax.tree.leaves(jmask))
    print(f"{ties} near-tied groups of 4 differ, of {n // 4}")
    assert ties <= n // 4 // 1000
    # the convergence history
    jh, th = jbank.meta["history"], tbank.meta["history"]
    assert len(jh) == len(th)
    for a, b in zip(jh, th):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=2e-3, atol=1e-6,
                                       err_msg=k)


# the tiny families of benchmarks/common.py (repro_torch.configs.tiny),
# as keyword arguments for either package's ModelConfig
TINY = {name: dataclasses.asdict(cfg) for name, cfg in FAMILIES.items()}


def tiny_model(name: str):
    """(jax cfg, torch cfg, jax params, torch params) of the committed
    trained ``results/bench_models/<name>.pkl`` (an arch outside the
    config registry: each cfg is built from ``TINY``)."""
    import pathlib
    import pickle

    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import load_params_pickle
    path = (pathlib.Path(__file__).resolve().parent.parent / "results"
            / "bench_models" / f"{name}.pkl")
    with open(path, "rb") as f:
        jp = jax.tree.map(jnp.asarray, pickle.load(f))
    return (JaxModelConfig(**TINY[name]), ModelConfig(**TINY[name]), jp,
            load_params_pickle(path))


def tiny_bank(name: str):
    """The committed ``results/bench_banks/<name>-unstructured`` bank (the
    benchmarks' stochria calibration), loaded by each package."""
    import pathlib

    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.sparse.bank import MaskBank as JaxMaskBank
    from repro_torch.configs.base import ModelConfig
    from repro_torch.sparse.bank import MaskBank
    d = (pathlib.Path(__file__).resolve().parent.parent / "results"
         / "bench_banks" / f"{name}-unstructured")
    return (JaxMaskBank.load(d, cfg=JaxModelConfig(**TINY[name])),
            MaskBank.load(d, cfg=ModelConfig(**TINY[name]), device="cpu"))
