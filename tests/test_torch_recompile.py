"""The recompile sentinel (``analysis.recompile``) of both packages, and the
port's trace-time collective counters against the reference's.

Sentinel cases: tests/test_analysis.py's (counts and the budget, the
disabled no-op, the live engine: one decode signature in steady state, and
a cache dtype flip that trips the budget before the step runs) on
``repro.analysis.recompile`` and ``repro_torch.analysis.recompile``, one
parametrised test each; then the port's own surfaces (SparseTensor and
``SearchState`` leaves, the search's chunks and steps, spec's draft and
verify).

Collective counters: the reference counts ``dist.psum`` /
``dist.psum_bytes`` at ``site="attn_kv"`` when ``decode_attend_sharded``
is traced (``kernels/shard.py:304``: 2, and B*K*G*(1+Dv)*4 bytes, on its
CPU branch), so a counter holds the static per-trace count.  Its
``shard_map(check_rep=...)`` cannot run on jax 0.9, so the JAX side runs
under a stand-in for ``decode_attend_sharded`` that makes the reference's
own ``_count`` call and computes the replicated attention (as
tests/test_torch_flash_decode.py's stand-in does).  The port must give
the same values: exactly equal, counted once per traced surface and call
site, never per step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, to_jax  # noqa: F401
from repro import obs as jobs
from repro.analysis import recompile as jrec
from repro_torch import obs as tobs
from repro_torch import tree
from repro_torch.analysis import recompile as trec

PKGS = {"repro": (jrec, jobs), "repro_torch": (trec, tobs)}


@pytest.fixture(params=list(PKGS))
def pkg(request):
    rec, obs = PKGS[request.param]
    rec.disable()
    rec.reset()
    obs.reset()
    yield request.param, rec, obs
    rec.disable()
    rec.reset()
    obs.reset()


def _zeros(name, shape, dtype):
    if name == "repro":
        return jnp.zeros(shape, getattr(jnp, dtype))
    return torch.zeros(shape, dtype=getattr(torch, dtype))


def test_recompile_sentinel_counts_and_budget(pkg):
    name, rec, _ = pkg
    rec.enable(budgets={"decode": 2})
    a = _zeros(name, (4,), "bfloat16")
    assert rec.note("decode", (a,)) is True
    assert rec.note("decode", (a,)) is False          # same signature
    assert rec.counts()["decode"] == 1
    assert rec.note("decode", (_zeros(name, (4,), "float32"),)) is True
    assert rec.counts()["decode"] == 2
    with pytest.raises(rec.RecompileBudgetError):
        rec.note("decode", (_zeros(name, (5,), "bfloat16"),))


def test_recompile_sentinel_disabled_is_noop(pkg):
    _, rec, _ = pkg
    assert rec.note("decode", (1, 2)) is False
    assert rec.counts() == {}


@pytest.fixture(scope="module")
def smoke():
    from repro.configs.base import get_smoke_config as jax_smoke_config
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as TM
    cfg = get_smoke_config("llama3.2-1b")
    tp = TM.init_params(cfg, 0, device="cpu")
    return {"repro": (jax_smoke_config("llama3.2-1b"), to_jax(tp)),
            "repro_torch": (cfg, tp)}


def _engine(name, cfg, params, **kw):
    if name == "repro":
        from repro.serve.engine import ServeEngine
        return ServeEngine(cfg, params, slots=2, capacity=32, **kw)
    from repro_torch.serve.engine import ServeEngine
    return ServeEngine(cfg, params, slots=2, capacity=32, device="cpu", **kw)


def _flip_caches(name, caches):
    if name == "repro":
        return jax.tree.map(lambda a: a.astype(jnp.float16)
                            if jnp.issubdtype(a.dtype, jnp.floating) else a,
                            caches)
    return tree.tree_map(lambda a: a.to(torch.float16)
                         if a.is_floating_point() else a, caches)


def test_recompile_sentinel_on_live_engine(pkg, smoke):
    """Steady-state decode holds ONE signature; an induced cache dtype
    change trips the budget BEFORE the step dispatches."""
    name, rec, obs = pkg
    cfg, params = smoke[name]
    eng = _engine(name, cfg, params)
    obs.configure(enabled=True)
    rec.enable(budgets={"decode": 1})
    eng.submit(np.arange(1, 6) % cfg.vocab_size, 3)
    eng.run()
    assert rec.counts().get("decode") == 1
    assert obs.gauge_value("analysis.recompiles", surface="decode") == 1
    eng.submit(np.arange(2, 7) % cfg.vocab_size, 2)
    eng.run()
    assert rec.counts()["decode"] == 1
    steps = []
    if name == "repro_torch":
        step = eng.fns.step
        eng.fns.step = lambda *a: steps.append(1) or step(*a)
    eng.caches = _flip_caches(name, eng.caches)
    with pytest.raises(rec.RecompileBudgetError):
        eng._step()
    assert steps == []


def test_port_signature_leaves():
    """SparseTensor leaves sign by both planes and idx_bits; a dataclass's
    Python scalars (``SearchState.step``, its key words) by type, as the
    reference's registered dataclass holds them as arrays; other Python
    values by repr."""
    from repro_torch.core.mirror import SearchState
    from repro_torch.sparse.formats import SparseTensor
    v, i = torch.zeros((4, 8)), torch.zeros((1, 8), dtype=torch.uint8)
    assert trec.signature(SparseTensor(v, i, 2)) != \
        trec.signature(SparseTensor(v, i.to(torch.int8), 8))
    s0 = SearchState(W={"w": v}, Gamma={"w": v}, V={"w": None}, step=0,
                     rng=(0, 17))
    s1 = SearchState(W={"w": v}, Gamma={"w": v}, V={"w": None}, step=5,
                     rng=(3, 4))
    assert trec.signature(s0) == trec.signature(s1)
    assert trec.signature((1,)) != trec.signature((2,))
    assert trec.signature({"a": v}) != trec.signature([v])
    assert trec.signature(({}, v)) != trec.signature(([], v))


@pytest.mark.parametrize("chunk,steps,want", [
    (2, 4, {"search_chunk": 1}), (2, 5, {"search_chunk": 2}),
    (1, 3, {"search_step": 1})])
def test_port_search_notes(smoke, chunk, steps, want):
    """One signature a chunk length, as the reference's scanned chunks
    (its shorter last chunk has another stacked shape); one per step
    surface at ``scan_chunk <= 1``."""
    from repro_torch.configs.base import PruneConfig
    from repro_torch.core import calibrate as tcal
    from repro_torch.data.synthetic import batches_for
    cfg, tp = smoke["repro_torch"]
    calib = batches_for(cfg, n=2, batch=2, seq=16, split="calib")
    stats = tcal.collect_stats(cfg, tp, calib)
    pcfg = PruneConfig(local_metric="magnitude", mode="nm", steps=steps,
                       scan_chunk=chunk)
    trec.enable()
    try:
        tcal.run_search(cfg, pcfg, tp, calib, stats)
        assert trec.counts() == want
    finally:
        trec.disable()
        trec.reset()


def test_port_spec_notes_one_signature_per_k(smoke):
    from repro_torch.serve.spec import SpecDecoder
    cfg, tp = smoke["repro_torch"]
    d, v = (_engine("repro_torch", cfg, tp) for _ in range(2))
    sd = SpecDecoder(d, v, k=2, adaptive=False)
    for p in ([5, 6, 7], [9, 10, 11, 12]):
        sd.submit(p, 5)
    trec.enable()
    try:
        sd.run()
        assert trec.counts() == {"draft_2": 1, "verify_2": 1,
                                 "prefill_8": 1, "write_slot": 1}
    finally:
        trec.disable()
        trec.reset()


# ---------------------------------------------------------------------------
# dist.psum{site=attn_kv}: trace-time counts
# ---------------------------------------------------------------------------

S = 4


@pytest.fixture
def jax_kv_stand_in(monkeypatch):
    """The reference's capacity-sharded decode with its count and without
    its shard_map: ``_count`` as ``shard.py:304`` calls it, then the
    replicated attention."""
    from repro.kernels import shard as jshard

    def kv_shard_axes(B, C):
        return ("model",) if C % S == 0 else ()

    def decode_attend_sharded(qg, cache_k, cache_v, ok, *, axes, scale):
        B, K, G, _ = qg.shape
        jshard._count("attn_kv", B * K * G * (1 + cache_v.shape[-1]) * 4,
                      n_psum=2)
        s = jnp.einsum("bkgd,bckd->bkgc", qg, cache_k,
                       preferred_element_type=jnp.float32) * scale
        s = jnp.where(ok[:, None, None, :], s, -1e30)
        w = jax.nn.softmax(s, axis=-1).astype(cache_v.dtype)
        o = jnp.einsum("bkgc,bckd->bkgd", w, cache_v,
                       preferred_element_type=jnp.float32)
        return o.astype(qg.dtype)

    monkeypatch.setattr(jshard, "kv_shard_axes", kv_shard_axes)
    monkeypatch.setattr(jshard, "decode_attend_sharded",
                        decode_attend_sharded)


def _psum_run(name, cfg, params):
    """An engine at kv_shards=S serving two runs, then its draft surface
    (k 2) twice: the counters after each stage."""
    obs = PKGS[name][1]
    obs.reset()
    obs.configure()
    kw = {} if name == "repro" else {"kv_shards": S}
    eng = _engine(name, cfg, params, **kw)
    read = lambda: (obs.counter_value("dist.psum", site="attn_kv"),
                    obs.counter_value("dist.psum_bytes", site="attn_kv"))
    out = []
    for _ in range(2):
        eng.submit([5, 6, 7, 8], 4)
        eng.submit([9, 10], 3)
        eng.run()
        out.append(read())
    seed = np.array([3, 4], np.int32)
    pos = np.array([6, 6], np.int32)
    for _ in range(2):
        if name == "repro":
            eng.fns.draft(2)(eng.params, jnp.asarray(seed), eng.caches,
                             jnp.asarray(pos))
        else:
            eng.fns.draft(2)(eng.params, seed, eng.caches, pos)
        out.append(read())
    obs.reset()
    return out


def test_attn_kv_psum_counts_equal_reference(smoke, jax_kv_stand_in):
    """2 a decode trace and 2 a draft trace (the reference scans its layers
    and the draft's steps, so each call site is traced once), the same
    bytes; a second run and a second draft add nothing."""
    want = _psum_run("repro", *smoke["repro"])
    got = _psum_run("repro_torch", *smoke["repro_torch"])
    assert got == want
    cfg = smoke["repro_torch"][0]
    payload = 2 * cfg.num_kv_heads * (cfg.num_heads // cfg.num_kv_heads) \
        * (1 + cfg.head_dim) * 4
    assert got == [(2, payload)] * 2 + [(4, 2 * payload)] * 2


def test_port_attn_kv_psum_per_call_site():
    """A model whose stage pattern has several attention layers (gemma3: 5
    local and 1 global a stage) counts 2 at each pattern position of a
    decode trace; a direct call outside any engine surface is the
    reference's eager call: it counts each time and observes
    ``dist.collective_ms``."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as TM
    cfg = get_smoke_config("gemma3-1b")
    tp = TM.init_params(cfg, 0, device="cpu")
    sites = sum(len(pattern) for pattern, _ in TM.make_stages(cfg))
    tobs.reset()
    tobs.configure()
    try:
        eng = _engine("repro_torch", cfg, tp, kv_shards=S)
        eng.submit(list(range(3, 12)), 3)
        eng.run()
        assert tobs.counter_value("dist.psum", site="attn_kv") == 2 * sites
        caches = TM.init_caches(cfg, 2, 32, device="cpu")
        params = TM.serving_params(tp)
        with torch.inference_mode():
            for t in range(2):
                TM.decode_step(cfg, params, torch.tensor([1, 2]), caches, t,
                               kv_shards=S)
        assert tobs.counter_value("dist.psum", site="attn_kv") == \
            2 * sites + 2 * 2 * cfg.num_layers
        h = tobs.summary()["histograms"]['dist.collective_ms{site="attn_kv"}']
        assert h["count"] == 2 * cfg.num_layers
    finally:
        tobs.reset()
