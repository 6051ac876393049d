"""repro_torch serving the smoke deepseek-v2-lite-16b against the JAX
reference on the CPU: greedy ``ServeEngine`` streams, dense and
2:4-compressed, and the verify pass against sequential decode
(self-speculative decoding: tests/test_torch_deepseek_spec.py).

One set of params is drawn (the port's ``init_params``, seed 0) and
carried to the reference as jax arrays; the port compresses 2:4 magnitude
masks and the reference serves the same compressed leaves (values and
index planes carried across; that the reference's own compression gives
them bit for bit is tests/test_torch_deepseek.py's).  Prefills run at the
exact prompt length in both packages (MoE kinds are not padding-safe).

Everything here is held exactly: token streams, the port's verify
columns against its own decode steps, compressed against masked-dense
bf16 streams.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, smoke_deepseek  # noqa: F401
from repro.serve import engine as jengine
from repro_torch import tree
from repro_torch.models import model as TM
from repro_torch.serve import engine as tengine

# 3 requests on 2 slots (the third admitted into a freed slot); two prompt
# lengths, so each package compiles or runs two prefill shapes
PROMPT_LENS, GEN = (9, 14, 9), 6
CAPACITY = 32


@pytest.fixture(scope="module")
def model():
    return smoke_deepseek(PROMPT_LENS)


def _streams(eng, prompts, gen=GEN):
    rids = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


@pytest.mark.parametrize("weights", ["dense", "nm24"])
def test_engine_streams_equal_reference(model, weights):
    jcfg, cfg = model["cfg"]
    jp, tp = model[weights]
    want = _streams(jengine.ServeEngine(jcfg, jp, slots=2,
                                        capacity=CAPACITY), model["prompts"])
    eng = tengine.ServeEngine(cfg, tp, slots=2, capacity=CAPACITY,
                              device="cpu")
    got = _streams(eng, model["prompts"])
    assert got == want
    assert eng.prefill_calls == 3 and eng._prefill_bucket(9) == 9
    if weights == "nm24":      # compressed == masked-dense, on the port
        masked = tengine.ServeEngine(cfg, model["masked"], slots=2,
                                     capacity=CAPACITY, device="cpu")
        assert _streams(masked, model["prompts"]) == got


def test_verify_step_columns_equal_sequential_decode(model):
    """3 fed tokens per row of 2 (capacity equals the 6 routed tokens, so
    no expert drops what a decode step keeps), compressed weights: each
    column bit for bit the port's own decode step, and the same ring rows
    written.  (The MLA verify against the reference's:
    tests/test_torch_mla.py.)"""
    _, cfg = model["cfg"]
    tp = TM.serving_params(model["nm24"][1])
    B, P, S = 2, 10, 3
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P)))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    t0 = torch.tensor([P, P - 4], dtype=torch.int32)
    _, ring = TM.prefill(cfg, tp, {"tokens": prompt}, cache_capacity=32)
    vc = tree.tree_map(torch.clone, ring)
    got, _ = TM.verify_step(cfg, tp, fed, vc, t0)
    dc = tree.tree_map(torch.clone, ring)
    for i in range(S):
        step, _ = TM.decode_step(cfg, tp, fed[:, i], dc, t0 + i)
        assert torch.equal(got[:, i], step), i
    for (path, a), (_, b) in zip(tree.flatten_with_path(vc),
                                 tree.flatten_with_path(dc), strict=True):
        assert torch.equal(a, b), path
