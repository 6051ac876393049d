"""The flight recorder (``obs``) of both packages, and the port's hooks
against the reference's on the same work.

Unit cases: each case of tests/test_obs.py's unit tests (spans, nesting,
fencing, timers, exceptions, ``log(warn=)``, histogram edges and
percentiles, the registry, the exposition, the disabled no-ops, the JSONL
round trip and a partial last line), plus out-of-order exits and per-thread
span stacks, runs against ``repro.obs`` and ``repro_torch.obs`` as one
parametrised test each.

Parity: the same smoke llama3.2-1b work runs through the JAX package and
through the port on the CPU with the recorder on (params drawn by the
port's ``init_params`` and carried to JAX; the launchers are handed the
same params): a 0.0 / 2:4 fleet from the committed bank, whose members are
engines labelled by budget, run twice (speculative traffic, then pinned
and A/B traffic with a one-token prompt), ``masks_at`` twice on its bank,
the calibrate launcher (4 search steps, ``--scan-chunk 2``) and the serve
launcher, both with ``--trace-dir`` (the port's with ``--xprof-dir`` too:
the reference's jax.profiler trace adds ~13 s on a CPU and holds
nothing the recorder compares).  What is held, and how:

* exactly equal: the metric names and label sets of every counter, gauge
  and histogram; every counter's value (requests, tokens, buckets, chunks,
  steps, jit entries, threshold passes, mirrored picks); every
  histogram's observation count; the gauges that count or are computed
  from counts (queue depths, slot use, spec's k and accept EMA, the mask
  cache, the compiled-entry counts ``serve.jit_cache_size``, which the
  port keeps as distinct call signatures per surface); the event sequence:
  kind, span name or log event, depth, the parent structure, the spans'
  non-time attributes and the chunk logs' ``start`` / ``steps``; the
  fleet report's counters and token agreement.
* within the calibration tolerance of tests/test_torch_calibrate.py's
  history (rtol 2e-3, atol 1e-6): the chunk logs' loss, align,
  mask_churn, gamma_entropy and sparsity series, and the three
  ``calibrate.*`` gauges.
* only present (wall clocks): every span's ``dur_ms``, the ``*_ms``
  histograms' sums and percentiles, the stage seconds.
"""
import json
import pathlib
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, to_jax  # noqa: F401
from repro import obs as jobs
from repro_torch import obs as tobs

ROOT = pathlib.Path(__file__).parent.parent
BANK = ROOT / "results" / "bank" / "llama3.2-1b"
PKGS = {"repro": jobs, "repro_torch": tobs}


@pytest.fixture(params=list(PKGS))
def obs(request):
    o = PKGS[request.param]
    o.reset()
    yield o
    o.reset()


def _ones(o, n):
    return jnp.ones((n, n)) if o is jobs else torch.ones((n, n))


# -- spans -------------------------------------------------------------------


def test_disabled_span_is_the_shared_noop_singleton(obs):
    assert not obs.enabled()
    assert obs.span("a") is obs.span("b") is obs.NOOP_SPAN
    sp = obs.span("decode", slot=3)
    with sp as inner:
        assert inner is sp
        inner.set(bucket=64)
        inner.fence(None)
    assert sp.seconds is None
    assert obs.events() == []


def test_span_nesting_records_parent_and_depth(obs):
    obs.configure()
    with obs.span("outer") as outer:
        with obs.span("inner") as inner:
            assert inner.parent_id == outer.span_id
            assert inner.depth == 1
        with obs.span("inner2") as inner2:
            assert inner2.parent_id == outer.span_id
    assert outer.parent_id is None and outer.depth == 0
    ev = {e["name"]: e for e in obs.events() if e["kind"] == "span"}
    assert ev["inner"]["parent_id"] == ev["outer"]["span_id"]
    assert ev["inner"]["depth"] == 1 and ev["outer"]["depth"] == 0
    names = [e["name"] for e in obs.events()]
    assert names.index("inner") < names.index("outer")
    assert all(e["dur_ms"] >= 0 and e["ok"] for e in ev.values())


def test_span_fence_blocks_on_pending_work(obs):
    """On the CPU the port's fence has nothing to wait for; the card's is
    in tests/test_torch_cuda.py."""
    obs.configure()
    x = _ones(obs, 64)
    with obs.span("matmul") as sp:
        y = x @ x
        sp.fence(y)
    assert sp.seconds is not None and sp.seconds >= 0
    assert np.asarray(y)[0, 0] == 64.0


def test_timer_measures_even_while_disabled(obs):
    assert not obs.enabled()
    with obs.timer("stage") as t:
        pass
    assert t.seconds is not None and t.seconds >= 0
    assert obs.events() == []


def test_span_records_exception_and_unwinds_stack(obs):
    obs.configure()
    with pytest.raises(RuntimeError):
        with obs.span("boom"):
            raise RuntimeError("x")
    (ev,) = [e for e in obs.events() if e["kind"] == "span"]
    assert ev["name"] == "boom" and ev["ok"] is False
    with obs.span("after") as sp:
        assert sp.depth == 0


def test_span_exiting_out_of_order_drops_only_itself(obs):
    obs.configure()
    a = obs.span("a").__enter__()
    b = obs.span("b").__enter__()
    a.__exit__(None, None, None)          # a leaves before its child
    with obs.span("c") as c:
        assert c.parent_id == b.span_id and c.depth == 1
    b.__exit__(None, None, None)
    with obs.span("d") as d:
        assert d.depth == 0 and d.parent_id is None


def test_span_stacks_are_per_thread(obs):
    """A span opened in another thread while this thread's span is open
    has no parent: fleet members and spec's two engines never share a
    stack."""
    obs.configure()
    seen = {}

    def other():
        with obs.span("worker") as w:
            seen["depth"], seen["parent"] = w.depth, w.parent_id

    with obs.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == {"depth": 0, "parent": None}


# -- structured logs + warnings contract -------------------------------------


def test_log_warn_preserves_stdlib_warning_semantics(obs):
    obs.configure()
    with pytest.warns(UserWarning, match="legacy"):
        obs.log("bank.legacy", level="warning", warn="legacy artifact")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        obs.log("calibrate.done", steps=4)
    events = [e for e in obs.events() if e["kind"] == "log"]
    assert {e["event"] for e in events} == {"bank.legacy", "calibrate.done"}
    obs.reset()
    with pytest.warns(UserWarning, match="legacy"):
        obs.log("bank.legacy", level="warning", warn="legacy artifact")
    assert obs.events() == []


# -- registry ----------------------------------------------------------------


def test_histogram_bucket_edges_follow_le_convention(obs):
    h = obs.Histogram((1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 2.0, 5.0, 7.0):
        h.observe(v)
    assert h.counts == [2, 2, 1, 1]
    assert h.count == 6 and h.sum == pytest.approx(17.0)
    assert h.min == 0.5 and h.max == 7.0
    snap = h.snapshot()
    assert snap["buckets"]["+Inf"] == 1
    assert snap["buckets"]["1.0"] == 2


def test_histogram_percentiles_clamped_to_observed_range(obs):
    h = obs.Histogram((1.0, 10.0, 100.0))
    for v in (3.0, 4.0, 5.0):
        h.observe(v)
    p50, p99 = h.percentile(50), h.percentile(99)
    assert 3.0 <= p50 <= 5.0 and 3.0 <= p99 <= 5.0
    assert obs.Histogram().percentile(50) is None


def test_registry_counters_gauges_and_label_separation(obs):
    r = obs.Registry()
    r.inc("req", 1, {"budget": "0.5"})
    r.inc("req", 2, {"budget": "0.5"})
    r.inc("req", 5, {"budget": "2:4"})
    r.set_gauge("depth", 7, {"budget": "0.5"})
    assert r.counter_value("req", {"budget": "0.5"}) == 3
    assert r.counter_value("req", {"budget": "2:4"}) == 5
    assert r.counter_value("req", {"budget": "0.0"}) == 0
    assert r.gauge_value("depth", {"budget": "0.5"}) == 7
    assert r.gauge_value("depth") is None


def test_registry_declared_edges_and_prometheus_exposition(obs):
    r = obs.Registry()
    r.declare_hist("agree", (0.5, 1.0))
    r.observe("agree", 0.75)
    r.observe("lat_ms", 3.0)
    assert r.hist("agree").edges == (0.5, 1.0)
    assert r.hist("lat_ms").edges == obs.DEFAULT_MS_BUCKETS
    text = r.expose()
    assert '# TYPE agree histogram' in text
    assert 'agree_bucket{le="1"} 1' in text
    assert 'agree_bucket{le="+Inf"} 1' in text
    assert 'agree_count 1' in text
    r.inc("tok", 4, {"budget": "2:4"})
    assert 'tok{budget="2:4"} 4' in r.expose()


def test_metric_writes_are_noops_while_disabled(obs):
    assert not obs.enabled()
    obs.inc("serve.tokens_decoded", 4)
    obs.observe("serve.decode_step_ms", 1.5)
    obs.set_gauge("serve.slot_util", 0.5)
    assert obs.counter_value("serve.tokens_decoded") == 0
    assert obs.percentile("serve.decode_step_ms", 50) is None
    assert obs.gauge_value("serve.slot_util") is None


# -- JSONL export ------------------------------------------------------------


def test_jsonl_schema_round_trip(obs, tmp_path):
    obs.configure(trace_dir=tmp_path)
    with obs.span("prefill", slot=2, prompt_len=7):
        pass
    obs.log("calibrate.search_chunk", start=0, steps=2,
            loss=[1.0, 0.5], sparsity=np.float32(0.25),
            churn=torch.tensor(0.5), series=torch.tensor([1.0, 2.0]))
    obs.flush()
    events = list(obs.read_jsonl(tmp_path / "events.jsonl"))
    assert [e["kind"] for e in events] == ["span", "log"]
    span, log = events
    assert span["name"] == "prefill" and span["dur_ms"] >= 0
    assert span["attrs"] == {"slot": 2, "prompt_len": 7}
    assert span["parent_id"] is None and span["depth"] == 0
    assert "ts" in span and "ts" in log
    assert log["sparsity"] == pytest.approx(0.25)
    assert log["churn"] == 0.5 and log["series"] == [1.0, 2.0]
    assert log["loss"] == [1.0, 0.5]
    assert obs.trace_path() == tmp_path / "events.jsonl"


def test_jsonl_reader_skips_partial_last_line(obs, tmp_path):
    p = tmp_path / "events.jsonl"
    p.write_text(json.dumps({"kind": "log", "event": "a"}) + "\n"
                 + '{"kind": "log", "ev')
    events = list(obs.read_jsonl(p))
    assert len(events) == 1 and events[0]["event"] == "a"


def test_port_recorder_module_surface():
    """The port's package exports the reference's names, and its modules
    import torch and the standard library only."""
    assert tobs.__all__ == jobs.__all__
    assert tobs.DEFAULT_MS_BUCKETS == jobs.DEFAULT_MS_BUCKETS


# ---------------------------------------------------------------------------
# Parity: the same work through both packages with the recorder on
# ---------------------------------------------------------------------------

SPEC = "draft:2:4,verify:0.0,k:2,adaptive:0"
RTOL, ATOL = 2e-3, 1e-6          # tests/test_torch_calibrate.py's history
SERIES = ("loss", "align", "mask_churn", "gamma_entropy", "sparsity")
CAL_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--steps", "4",
            "--scan-chunk", "2", "--calib-n", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
SERVE_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "2",
              "--prompt-len", "8", "--gen", "3"]


def _work(pkg: str, params, tmp: pathlib.Path, prompts) -> dict:
    """The shared work through one package; returns its recorder's events
    and summary, the fleet's report and the trace directories."""
    if pkg == "repro":
        from repro import obs
        from repro.launch import calibrate as lcal
        from repro.launch import serve as lserve
        from repro.models import model as M
        from repro.serve.fleet import SparsityFleet
        kw, dev = {}, []
    else:
        from repro_torch import obs
        from repro_torch.launch import calibrate as lcal
        from repro_torch.launch import serve as lserve
        from repro_torch.models import model as M
        from repro_torch.serve.fleet import SparsityFleet
        kw, dev = {"device": "cpu"}, ["--device", "cpu"]
    obs.reset()
    obs.configure(trace_dir=tmp / "work")
    # the members are engines labelled by budget; spec drafts on 2:4
    fleet = SparsityFleet.from_artifact(BANK, params, ["0.0", "2:4"],
                                        slots=4, capacity=32, spec=SPEC,
                                        **kw)
    for p in prompts[:2]:
        fleet.submit(p, 4, spec=True)
    fleet.run()
    fleet.submit(prompts[0], 3, budget="0.0")
    fleet.submit(prompts[2], 2, budget="2:4")    # a one-token prompt
    for p in prompts[:2]:
        fleet.submit(p, 3, ab=True)
    fleet.run()
    report = fleet.report()
    fleet.bank.masks_at(sparsity=0.5)
    fleet.bank.masks_at(sparsity=0.5)
    saved = M.init_params
    M.init_params = lambda *a, **k: params    # the launchers' weights
    # the reference's --xprof-dir (a jax.profiler trace, ~13 s more on
    # a CPU) writes nothing the recorder holds; only the port's runs
    xprof = (lambda d: []) if pkg == "repro" else \
        (lambda d: ["--xprof-dir", str(tmp / d)])
    try:
        lcal.main(CAL_ARGS + dev + xprof("calx")
                  + ["--out", str(tmp / "bank"),
                     "--trace-dir", str(tmp / "cal")])
        lserve.main(SERVE_ARGS + dev + xprof("srvx")
                    + ["--trace-dir", str(tmp / "srv")])
    finally:
        M.init_params = saved
    out = {"events": obs.events(), "summary": obs.summary(),
           "report": report, "tmp": tmp}
    obs.reset()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import model as TM
    cfg = get_smoke_config("llama3.2-1b")
    tp = TM.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 11, 1)]
    return {pkg: _work(pkg, to_jax(tp) if pkg == "repro" else tp,
                       tmp_path_factory.mktemp(pkg), prompts)
            for pkg in PKGS}


def _keys(d: dict) -> list:
    return sorted(d)


def test_same_metric_names_and_label_sets(runs):
    j, t = runs["repro"]["summary"], runs["repro_torch"]["summary"]
    for kind in ("counters", "gauges", "histograms"):
        assert _keys(t[kind]) == _keys(j[kind]), kind


def test_same_counter_values(runs):
    j, t = runs["repro"]["summary"], runs["repro_torch"]["summary"]
    assert t["counters"] == j["counters"]
    assert j["counters"]["fleet.requests{budget=\"0.0\"}"] == 2


def test_same_histogram_counts(runs):
    j, t = runs["repro"]["summary"], runs["repro_torch"]["summary"]
    for name, h in j["histograms"].items():
        th = t["histograms"][name]
        assert th["count"] == h["count"], name
        if not name.split("{")[0].endswith("_ms"):
            # counts of fractions and tokens: every bucket equal
            assert th["buckets"] == h["buckets"], name
            assert th["sum"] == pytest.approx(h["sum"], rel=1e-12), name


def test_same_gauges(runs):
    j, t = runs["repro"]["summary"], runs["repro_torch"]["summary"]
    for name, v in j["gauges"].items():
        if name.startswith("calibrate."):
            np.testing.assert_allclose(t["gauges"][name], v, rtol=RTOL,
                                       atol=ATOL, err_msg=name)
        else:
            assert t["gauges"][name] == v, name


def _shape(events: list) -> list:
    """(kind, name, depth, parent's index, non-time attributes) per
    event, span ids replaced by their event's index."""
    index = {e["span_id"]: i for i, e in enumerate(events)
             if e["kind"] == "span"}
    out = []
    for e in events:
        if e["kind"] == "span":
            out.append(("span", e["name"], e["depth"],
                        index.get(e["parent_id"]), e["ok"],
                        e.get("attrs", {})))
        else:
            keep = {k: v for k, v in e.items()
                    if k in ("event", "level", "start", "steps", "arch",
                             "format_version")}
            out.append(("log", keep))
    return out


def test_same_event_sequence(runs):
    j, t = runs["repro"]["events"], runs["repro_torch"]["events"]
    assert _shape(t) == _shape(j)
    names = [e.get("name", e.get("event")) for e in j]
    assert names.count("calibrate.search_chunk") == 4    # 2 spans + 2 logs
    for name in ("serve.prefill", "fleet.run_spec",
                 "spec.draft", "spec.verify", "bank.threshold",
                 "calibrate.stats", "calibrate.search", "calibrate.done",
                 "launch.prefill", "launch.decode", "serve.decode_step"):
        assert name in names, name


def test_search_chunk_series_within_calibration_tolerance(runs):
    def chunks(run):
        return [e for e in run["events"] if e["kind"] == "log"
                and e["event"] == "calibrate.search_chunk"]
    j, t = chunks(runs["repro"]), chunks(runs["repro_torch"])
    assert [(c["start"], c["steps"]) for c in t] == [(0, 2), (2, 2)]
    for jc, tc in zip(j, t, strict=True):
        for k in SERIES:
            assert len(tc[k]) == tc["steps"] == 2, k
            np.testing.assert_allclose(tc[k], jc[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_fleet_report_percentiles_and_counters(runs):
    j, t = runs["repro"]["report"], runs["repro_torch"]["report"]
    for name, r in t["budgets"].items():
        jr = j["budgets"][name]
        assert 0 < r["decode_ms_p50"] <= r["decode_ms_p95"], name
        for k in ("requests", "tokens", "token_agreement_vs_reference",
                  "cumulative", "slots"):
            if k == "cumulative":
                assert {x: v for x, v in r[k].items() if x != "seconds"} \
                    == {x: v for x, v in jr[k].items() if x != "seconds"}
            else:
                assert r[k] == jr[k], (name, k)
    keep = ("k", "accept_ema", "requests", "rounds", "tokens", "rollbacks",
            "accept_rate")
    assert {k: t["spec"][k] for k in keep} == {k: j["spec"][k] for k in keep}


def test_launchers_write_trace_files(runs):
    """Both packages' launchers: events.jsonl and metrics.prom; the
    port's ``--xprof-dir``: torch.profiler's Chrome trace, the stages
    marked."""
    for pkg, run in runs.items():
        tmp = run["tmp"]
        for d in ("cal", "srv"):
            evs = list(PKGS[pkg].read_jsonl(tmp / d / "events.jsonl"))
            assert evs, (pkg, d)
            assert (tmp / d / "metrics.prom").read_text().startswith(
                "# TYPE"), (pkg, d)
        srv = list(PKGS[pkg].read_jsonl(tmp / "srv" / "events.jsonl"))
        steps = [e for e in srv if e.get("name") == "serve.decode_step"]
        assert len(steps) == 2 and any(e.get("name") == "launch.prefill"
                                       for e in srv), pkg
        assert "serve_decode_step_ms_count 2" in \
            (tmp / "srv" / "metrics.prom").read_text()
    tmp = runs["repro_torch"]["tmp"]
    for d, marks in (("calx", ("calibrate.stats", "calibrate.search")),
                     ("srvx", ("prefill", "decode"))):
        trace = json.loads((tmp / d / "trace.json").read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert set(marks) <= names, (d, marks)

