"""repro_torch's smoke deepseek-v2-lite-16b (an ``mla_dense`` prefix
layer, then ``mla_moe`` layers: MLA, 8 routed experts top-2 and one shared
expert) against the JAX reference on the CPU: the 2:4-compressed format
(each package compressing the same masks), the compressed model's
prefill and decode logits, and the serve launcher.  The engine, verify and spec:
tests/test_torch_deepseek_serve.py.

One set of params is drawn (the port's ``init_params``, seed 0) and
carried to the reference as jax arrays; 2:4 magnitude masks come from the
port's ``baseline_masks`` and each package compresses them itself.

Tolerances, and why:

* logits and the ``ckv`` / ``krope`` rings: 4 bf16 ulps of the largest
  value (ROADMAP R8; measured on these inputs: 0.001 of that ulp at most,
  one logit off; on the reference's own init, up to 3.2 ulps at prefill,
  where one attention output an ulp apart moves a few routed rows);
* index planes and ``compressed_report``: exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (assert_same_leaves, jax_flat,  # noqa: F401
                         one_torch_thread)
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.models import model as JM
from repro.sparse import apply as japply
from repro_torch import tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.kernels.nm_spmm import LAYOUT_PACKED2
from repro_torch.models import model as TM
from repro_torch.sparse import apply as tapply

ARCH = "deepseek-v2-lite-16b"
ULPS = 4


def _ulps(want, n=ULPS) -> float:
    return n * 2 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def _close(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=_ulps(want), err_msg=what)


def to_jax(t):
    """A port tree (CPU tensors, None leaves kept) -> jax arrays."""
    return tree.tree_map(
        lambda a: None if a is None else jnp.asarray(a.numpy()), t)


@pytest.fixture(scope="module")
def model():
    """cfgs, the dense params and the 2:4 trees (compressed by each
    package) of the smoke deepseek."""
    jcfg, cfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    tp = TM.init_params(cfg, 0, device="cpu")
    jp = to_jax(tp)
    tm = tcal.baseline_masks("magnitude", tp, tree.tree_map(
        lambda _: None, tp), 0.5, mode="nm")
    jm = to_jax(tm)
    return {
        "cfg": (jcfg, cfg), "masks": (jm, tm),
        "dense": (jp, tp),
        "nm24": (japply.sparsify_params(jp, jm, axes=JM.param_axes(jcfg),
                                        idx_bits=2, dtype=jnp.bfloat16),
                 tapply.sparsify_params(tp, tm, axes=TM.param_axes(cfg),
                                        idx_bits=2, dtype=torch.bfloat16)),
    }


def test_index_planes_and_compressed_report_equal_reference(model):
    """Every prunable leaf compresses: the MLA projections, the dense and
    shared MLPs as 2-D leaves, the expert banks as banks."""
    assert_same_leaves(*model["nm24"])
    jsp, tsp = model["nm24"]
    jm, tm = model["masks"]
    rep = tapply.compressed_report(tsp, tm)
    jrep = japply.compressed_report(jsp, jm)
    assert [(r["path"], r["shape"], r["bytes_compressed"],
             r["bytes_dense_bf16"], r["kernel_layout"]) for r in
            rep["layers"]] == [
        (r["path"], list(r["shape"]), r["bytes_compressed"],
         r["bytes_dense_bf16"], r["kernel_layout"]) for r in jrep["layers"]]
    for key in ("bytes_compressed", "bytes_dense_bf16", "ratio",
                "fallback_leaves", "kernel_native_packed"):
        assert rep[key] == jrep[key], key
    # 5 MLA + 3 MLP leaves in the prefix stage; 5 MLA + 3 banks + 3
    # shared in the mla_moe stage
    assert rep["kernel_native_packed"] == 19 and rep["fallback_leaves"] == 0
    assert rep["ratio"] == 0.5625
    banks = [r for r in rep["layers"] if "['moe']" in r["path"]
             and "shared" not in r["path"]]
    assert [tuple(r["shape"]) for r in banks] == [(2, 8, 64, 128),
                                                  (2, 8, 128, 64),
                                                  (2, 8, 128, 64)]
    assert all(r["kernel_layout"] == LAYOUT_PACKED2 for r in rep["layers"])


def test_compressed_prefill_and_decode_logits_match_reference(model):
    """Each package serving its own compression of the same masks (the
    dense model's: tests/test_torch_mla.py)."""
    jcfg, cfg = model["cfg"]
    jp, tp = model["nm24"]
    tp = TM.serving_params(tp)
    B, P, C, steps = 2, 12, 32, 3
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (steps, B)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: JM.prefill(
        jcfg, p, {"tokens": t}, cache_capacity=C))(jp, toks)
    tl, tc = TM.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                        cache_capacity=C)
    assert tuple(tc[1]["0"]["ckv"].shape) == (2, B, C, cfg.kv_lora)
    jdec = jax.jit(lambda p, tok, c, t: JM.decode_step(jcfg, p, tok, c, t))
    for i in range(steps + 1):
        _close(tl, jl, f"logits, step {i}")
        if i == steps:
            break
        t = np.array([P + i, P - 3 + i], np.int32)   # rows apart
        jl, jc = jdec(jp, jnp.asarray(feed[i]), jc, jnp.asarray(t))
        tl, tc = TM.decode_step(cfg, tp, torch.from_numpy(feed[i]), tc,
                                torch.from_numpy(t))
    jf = jax_flat(jc)
    for path, leaf in tree.flatten_with_path(tc):
        _close(leaf, jf[path], path)


def test_launcher_serves_deepseek_smoke_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                       "--prompt-len", "16", "--gen", "4", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "sample continuation" in out
