"""repro_torch ServeEngine against the JAX engine on the committed mask
bank (smoke llama, 2:4-compressed weights from ``from_artifact``): same
prompts, same greedy token streams, same submit-time rejections."""
import pathlib

import jax
import numpy as np
import pytest

from _torch_port import jax_params_to_torch
from repro.configs.base import get_smoke_config as jax_smoke_config
from repro.data import synthetic as jsyn
from repro.models import model as JM
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs.base import get_smoke_config
from repro_torch.data import synthetic as tsyn
from repro_torch.serve.engine import ServeEngine

BANK = pathlib.Path(__file__).parent.parent / "results" / "bank" / \
    "llama3.2-1b"
SLOTS, CAPACITY = 2, 64
# (prompt length, max_tokens): with 2 slots the third request admits
# mid-batch, into the slot the second frees after 3 tokens
REQUESTS = [(9, 6), (40, 3), (17, 8)]


@pytest.mark.parametrize("split", ["valid", "calib"])
def test_synthetic_batches_match_reference(split):
    cfg = get_smoke_config("llama3.2-1b")
    want = jsyn.batches_for(jax_smoke_config("llama3.2-1b"), n=2, batch=3,
                            seq=33, split=split, start=1)
    got = tsyn.batches_for(cfg, n=2, batch=3, seq=33, split=split, start=1)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


@pytest.fixture(scope="module")
def engines():
    jp = JM.init_params(jax_smoke_config("llama3.2-1b"), jax.random.key(0))
    return (JaxServeEngine.from_artifact(BANK, jp, slots=SLOTS,
                                         capacity=CAPACITY),
            ServeEngine.from_artifact(BANK, jax_params_to_torch(jp),
                                      slots=SLOTS, capacity=CAPACITY,
                                      device="cpu"))


def _prompts():
    toks = tsyn.batches_for(get_smoke_config("llama3.2-1b"), n=1,
                            batch=len(REQUESTS), seq=64, split="valid")[0]
    return [toks["tokens"][i, :n] for i, (n, _) in enumerate(REQUESTS)]


def test_from_artifact_token_streams_match_reference(engines):
    jeng, teng = engines
    outs = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, m) for p, (_, m) in zip(_prompts(), REQUESTS)]
        res = eng.run()
        outs.append([res[r] for r in rids])
    assert [len(o) for o in outs[1]] == [m for _, m in REQUESTS]
    assert outs[1] == outs[0]
    assert teng.prefill_calls == len(REQUESTS)
    # 6 steps for the first request; the third joins after step 3 and
    # needs 8 more
    assert teng.decode_steps == 11


@pytest.mark.parametrize("prompt,max_tokens", [
    (np.zeros((0,), np.int32), 4),               # empty prompt
    (np.ones((CAPACITY + 1,), np.int32), 4),     # prefill rows == capacity
    (np.ones((CAPACITY + 5,), np.int32), 4)])    # prefill rows > capacity
def test_submit_rejections_match_reference(engines, prompt, max_tokens):
    for eng in engines:
        with pytest.raises(ValueError):
            eng.submit(prompt, max_tokens)
        assert not eng.pending            # nothing queued, no slot claimed


@pytest.mark.parametrize("max_tokens", [0, -2])
def test_nonpositive_max_tokens_completes_without_a_slot(engines,
                                                         max_tokens):
    results = []
    for eng in engines:
        steps = getattr(eng, "decode_steps", None)
        rid = eng.submit(np.arange(5, dtype=np.int32), max_tokens)
        results.append(eng.run()[rid])
        if steps is not None:
            assert eng.decode_steps == steps
    assert results == [[], []]
