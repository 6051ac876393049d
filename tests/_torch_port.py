"""Helpers shared by the tests/test_torch_*.py files: carry arrays between
the JAX reference and the repro_torch port and compare trees leaf by leaf
by key path."""
import dataclasses
import functools

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


def global_rel(jt, tt, base=None) -> float:
    """||t - j|| / ||j - base|| over every leaf of the reference's tree
    ``jt`` and the port's ``tt`` (base 0 by default)."""
    tf = dict(tree.flatten_with_path(tt))
    bf = jax_flat(base) if base is not None else {}
    num = den = 0.0
    for path, jv in jax_flat(jt).items():
        j, t = f64(jv), f64(tf[path])
        num += float(np.sum((t - j) ** 2))
        den += float(np.sum((j - (f64(bf[path]) if bf else 0)) ** 2))
    return float(np.sqrt(num / den))


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


def assert_calibration_matches(jbank, tbank, churn_flips: int = 0):
    """The port's bank against the reference's, each from its own stats,
    at tests/test_torch_calibrate.py's tolerances: Gamma and V within
    2**-8 (|V_ref| + lam) + 1e-4 max|V_ref| elementwise, 2:4 masks equal
    but for counted near-ties in the reference's scores, the history at
    rtol 2e-3.  ``churn_flips``: a step's ``mask_churn`` may also differ
    by that many mask entries (a near-tie flipped at one step and back at
    the next, which the final masks do not show)."""
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
            flips = churn_flips / n if k == "mask_churn" else 0.0
            np.testing.assert_allclose(b[k], a[k], rtol=2e-3,
                                       atol=1e-6 + flips, err_msg=k)


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


def _jax_leaf(a):
    """One port leaf -> the reference's (bf16 by its bits; a SparseTensor
    as the reference's, values and index plane carried across)."""
    import jax.numpy as jnp
    if a is None:
        return None
    if isinstance(a, SparseTensor):
        return JaxSparseTensor(_jax_leaf(a.vals), _jax_leaf(a.idx),
                               a.idx_bits)
    if a.dtype == torch.bfloat16:
        return jnp.asarray(a.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(a.numpy())


def to_jax(t):
    """A port tree of CPU tensors (None and SparseTensor leaves included)
    -> the same tree for the reference."""
    return tree.tree_map(_jax_leaf, t)


def smoke_deepseek(prompt_lens=(9, 14, 9)):
    """The smoke deepseek-v2-lite-16b for serving tests: cfgs, params drawn
    by the port's ``init_params`` (seed 0; the reference's own init
    compiles one program a leaf shape), 2:4 magnitude masks and the port's
    packed2 compression, each as (reference tree, port tree), the
    masked-dense bf16 tree (the compressed leaves' values: MLA's absorbed
    ``w_uk`` / ``w_uv`` are read as stored), and numpy prompts."""
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import calibrate as tcal
    from repro_torch.models import model as TM
    from repro_torch.sparse import apply as tapply
    arch = "deepseek-v2-lite-16b"
    cfg = get_smoke_config(arch)
    tp = TM.init_params(cfg, 0, device="cpu")
    tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
        lambda _: None, tp), 0.5, mode="nm")
    tsp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                 idx_bits=2, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    return {
        "cfg": (jax_smoke_config(arch), cfg), "dense": (to_jax(tp), tp),
        "nm24": (to_jax(tsp), tsp),
        "masked": tree.tree_map(lambda w, m: w if m is None else
                                (w * m).to(torch.bfloat16), tp, tm),
        "prompts": [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                    for n in prompt_lens]}



def smoke_recurrent(arch: str, prompt_lens=(9, 14, 1, 6)):
    """A smoke recurrent family (zamba2-7b or xlstm-125m) for parity
    tests: cfgs, params drawn by the port's ``init_params`` (seed 0) with
    zamba2's LoRA ``b`` leaves (zero at init, which would make every
    per-invocation delta vanish) drawn as N(0, 0.05), as (reference tree,
    port tree), and numpy prompts (a one-token prompt among them: its slot
    starts from the blank state)."""
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as TM
    cfg = get_smoke_config(arch)
    tp = TM.init_params(cfg, 0, device="cpu")
    g = torch.Generator().manual_seed(5)
    tp = tree.map_with_path(
        lambda path, a: 0.05 * torch.randn(a.shape, generator=g)
        if "['lora_" in path and path.endswith("['b']") else a, tp)
    rng = np.random.default_rng(0)
    return {"cfg": (jax_smoke_config(arch), cfg), "dense": (to_jax(tp), tp),
            "prompts": [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                        for n in prompt_lens]}


# ---------------------------------------------------------------------------
# The reference's capacity-sharded decode, on one device
# ---------------------------------------------------------------------------

def _jax_combine(parts, dtype):
    """shard.py:327-330 over a list of per-shard (acc, m, l): pmax, then
    psum of (l * corr, acc * corr), then acc / max(l, 1e-30)."""
    import jax.numpy as jnp
    mg = parts[0][1]
    for _, m, _ in parts[1:]:
        mg = jnp.maximum(mg, m)
    l_tot = sum(l * jnp.exp(m - mg) for _, m, l in parts)
    acc_tot = sum(acc * jnp.exp(m - mg) for acc, m, _ in parts)
    return (acc_tot / jnp.maximum(l_tot, 1e-30)).astype(dtype)


@pytest.fixture
def jax_kv_shards(monkeypatch):
    """Install the stand-in for the reference's capacity-sharded decode
    with S shards: ``set_shards(S)`` returns the list its traces append
    to, one entry per decode attention traced."""
    import jax.numpy as jnp
    from repro.kernels import shard as jshard
    from repro.kernels.flash_decode import flash_decode as jax_flash_decode
    from repro.kernels.flash_decode import (flash_decode_partial as
                                            jax_flash_decode_partial)

    def set_shards(S):
        traced = []

        def kv_shard_axes(B, C):
            # the port shards B = 1 too (see kernels/shard.py)
            return ("model",) if C % S == 0 else ()

        def decode_attend_sharded(qg, cache_k, cache_v, ok, *, axes, scale):
            assert axes == ("model",)
            assert scale == qg.shape[-1] ** -0.5   # the kernels' default
            C = cache_k.shape[1]
            traced.append(C)
            bias = jnp.where(ok, 0.0, -1e30).astype(jnp.float32)
            if S == 1:
                return jax_flash_decode(qg, cache_k, cache_v, bias, bc=C,
                                        interpret=True)
            n = C // S
            parts = [jax_flash_decode_partial(
                qg, cache_k[:, s:s + n], cache_v[:, s:s + n],
                bias[:, s:s + n], bc=n, interpret=True)
                for s in range(0, C, n)]
            return _jax_combine(parts, qg.dtype)

        monkeypatch.setattr(jshard, "kv_shard_axes", kv_shard_axes)
        monkeypatch.setattr(jshard, "decode_attend_sharded",
                            decode_attend_sharded)
        return traced
    return set_shards


@pytest.fixture
def port_calls(monkeypatch):
    """Calls the port's decode attention makes to each kernel wrapper
    (their CPU runs add nothing to ``.launches``)."""
    from repro_torch.kernels import shard as tshard
    from repro_torch.models import attention as tattn
    calls = {}

    def counting(name, fn):
        def call(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    for mod, name in ((tattn, "flash_decode"),
                      (tshard, "flash_decode_partial"),
                      (tshard, "combine_partials")):
        monkeypatch.setattr(mod, name, counting(name, getattr(mod, name)))
    return calls


def _want_calls(kv_shards, n):
    if kv_shards == 1:
        return {"flash_decode": n}
    return {"flash_decode_partial": n, "combine_partials": n}


def smoke_with_24(arch: str):
    """A smoke config for parity tests: cfgs, params drawn by the port's
    ``init_params`` (seed 0; the reference's own init compiles one program
    a leaf shape) and their 2:4 magnitude masks compressed by the port
    (packed2), each as (reference tree, port tree), and the masked-dense
    bf16 tree (the compressed leaves' values)."""
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import calibrate as tcal
    from repro_torch.models import model as TM
    from repro_torch.sparse import apply as tapply
    cfg = get_smoke_config(arch)
    tp = TM.init_params(cfg, 0, device="cpu")
    tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
        lambda _: None, tp), 0.5, mode="nm")
    tsp = tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                 idx_bits=2, dtype=torch.bfloat16)
    return {"cfg": (jax_smoke_config(arch), cfg), "dense": (to_jax(tp), tp),
            "nm24": (to_jax(tsp), tsp), "masks": tm,
            "masked": tree.tree_map(lambda w, m: w if m is None else
                                    (w * m).to(torch.bfloat16), tp, tm)}


@functools.lru_cache(maxsize=None)
def reference_fns(jcfg, capacity: int):
    """The reference launcher's jitted prefill at ``capacity`` and decode
    step (``repro/launch/serve.py _serve``), one pair a (config,
    capacity) for the whole session, so tests share their compiles."""
    from repro.models import model as JM
    return (jax.jit(lambda p, b: JM.prefill(jcfg, p, b,
                                            cache_capacity=capacity)),
            jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t)))


def reference_generate(jcfg, jp, batch: dict, gen: int) -> np.ndarray:
    """The reference launcher's greedy loop (``repro/launch/serve.py
    _serve``) on given params: the jitted prefill at a capacity of P + gen
    (+ the image prefix), then ``gen - 1`` jitted decode steps at P + the
    prefix + i.  (B, gen) tokens."""
    import jax.numpy as jnp
    B, P = batch["tokens"].shape
    offset = jcfg.num_image_tokens if jcfg.vit_dim else 0
    prefill, decode = reference_fns(jcfg, P + gen + offset)
    logits, caches = prefill(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    toks = jnp.argmax(logits, axis=-1)
    out = [np.asarray(toks)]
    for i in range(gen - 1):
        logits, caches = decode(jp, toks, caches,
                                jnp.asarray(P + offset + i, jnp.int32))
        toks = jnp.argmax(logits, axis=-1)
        out.append(np.asarray(toks))
    return np.stack(out, axis=1)
