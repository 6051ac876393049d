"""repro_torch's self-speculative decoding (``serve.spec``) on the smoke
deepseek-v2-lite-16b against the JAX reference's ``SpecDecoder`` on the
CPU: 2:4-compressed drafts, the same masks masked-dense as the verifier.

The model, its params and trees: ``_torch_port.smoke_deepseek`` (the
port's ``init_params``, seed 0, carried to the reference; the port's
compression carried across).  Held exactly: the streams, spec's
counters, and the streams of the verifier decoding alone.
"""
import torch

import pytest

from _torch_port import one_torch_thread, smoke_deepseek, to_jax  # noqa: F401
from repro.serve import engine as jengine
from repro.serve import spec as jspec
from repro_torch.serve import engine as tengine
from repro_torch.serve import spec as tspec

CAPACITY = 32


@pytest.fixture(scope="module")
def model():
    return smoke_deepseek()


def _streams(eng, prompts, gen):
    rids = [eng.submit(p, gen) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def test_spec_streams_equal_verifier_and_reference(model):
    """2:4-compressed drafts, the same 2:4 weights masked-dense as the
    verifier (the one function through other kernels, so drafts are
    accepted), k = 4 fixed, 2 slots (a verify pass routes 2 x 4 tokens:
    capacity equals the count): the spec streams equal the verifier
    alone's and the JAX SpecDecoder's, with the same counters."""
    jcfg, cfg = model["cfg"]
    (jd, td), tv = model["nm24"], model["masked"]
    jv = to_jax(tv)
    prompts = model["prompts"][:2]

    def run(pkg):
        if pkg == "jax":
            fns = jengine.EngineFns(jcfg, CAPACITY)
            engines = [jengine.ServeEngine(jcfg, p, slots=2,
                                           capacity=CAPACITY, fns=fns)
                       for p in (jd, jv)]
            sd = jspec.SpecDecoder(*engines, k=4, adaptive=False)
        else:
            fns = tengine.EngineFns(cfg, CAPACITY, torch.device("cpu"))
            engines = [tengine.ServeEngine(cfg, p, slots=2,
                                           capacity=CAPACITY, fns=fns,
                                           device="cpu") for p in (td, tv)]
            sd = tspec.SpecDecoder(*engines, k=4, adaptive=False)
        rids = [sd.submit(p, 8) for p in prompts]
        out, _ = sd.run()
        return [out[r] for r in rids], {k: v for k, v in sd.stats.items()
                                        if k != "seconds"}
    (got, stats), want = run("torch"), run("jax")
    assert (got, stats) == want
    assert stats["accepted_draft_tokens"] > 0
    alone = _streams(tengine.ServeEngine(cfg, tv, slots=2,
                                         capacity=CAPACITY, device="cpu"),
                     prompts, 8)
    assert got == alone
