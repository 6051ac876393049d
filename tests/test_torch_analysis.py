"""The port's op-stream auditor, contracts and memory planner
(``repro_torch.analysis.audit`` / ``contracts`` / ``memplan`` /
``surfaces``) against the reference's (``repro.analysis.jaxpr_audit`` /
``contracts`` / ``memplan``).

tests/test_analysis.py's audit, contract and policy cases on the port;
smoke llama3.2-1b's five surfaces against the port's committed goldens
(``src/repro_torch/analysis/golden/``) and against the reference's own
(``results/contracts/llama3.2-1b_1dev.json``) on the fields they share,
every other field's difference listed with its reason (ROADMAP R25); the
kernel calls per surface at ``kv_shards`` None, 1 and 4 against the
reference's ``pallas_call`` count by its per-site convention; the planner
on hand-counted toy graphs; the SearchState bytes of all ten families
equal to the reference's ``memplan.search_state_bytes``; and the refusals
of a mesh.  Everything runs on the CPU or the meta device at smoke size.
"""
import json
import pathlib

import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401  (autouse fixture)
from repro_torch.analysis import audit, contracts, memplan, surfaces
from repro_torch.configs.base import ARCH_IDS

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_GOLDEN = ROOT / "results" / "contracts" / "llama3.2-1b_1dev.json"


# ---------------------------------------------------------------------------
# the auditor on small functions (tests/test_analysis.py's cases)
# ---------------------------------------------------------------------------


def test_audit_counts_ops_and_kernel_calls_per_call_and_per_site():
    """The op histogram, and the hand-written kernels seen at their entry
    points: every call per call, the first layer of a marked layer loop per
    site (the reference counts a scanned body once)."""
    from repro_torch.kernels import ref, shard as ksh
    from repro_torch.kernels.nm_spmm import nm_matmul
    w = torch.randn(64, 32)
    vals, idx = ref.compress_24(w)

    def f(x, vals, idx, w):
        trace = ksh.trace_sites()
        for i in range(3):                     # a 3-layer stack
            ksh.mark_site(trace, (0, 0), i)
            x = torch.sin(nm_matmul(x, vals, idx) @ w.T)
        ksh.mark_site(trace, None)
        return nm_matmul(x, vals, idx)        # outside the stack

    rep = audit.audit_fn(f, torch.ones(4, 64), vals, idx, w,
                         surface="stack")
    assert rep.surface == "stack"
    assert rep.kernel_launches == {"nm_matmul": 4}
    assert rep.kernel_calls == {"nm_matmul": 2}
    assert rep.primitives["kernel:nm_matmul"] == 4
    assert rep.primitives["sin"] == 3
    assert rep.host_callbacks == []
    # the plain version's ops beneath a kernel call stay hidden
    assert "gather" not in rep.primitives and "scatter" not in \
        rep.primitives


@pytest.mark.parametrize("kind", ["scalar_read", "to_host", "data_shape"])
def test_audit_flags_host_sync(kind):
    def f(x):
        y = x * 2
        if kind == "scalar_read":
            return y + y.sum().item()
        if kind == "to_host":
            return y.cpu()
        return y[y > 0]

    rep = audit.audit_fn(f, torch.ones(8))
    assert [h["kind"] for h in rep.host_callbacks] == [kind]


def test_audit_host_scalar_is_no_sync():
    """A host scalar made and read inside a step (``common._rounded``) is
    no device sync."""
    from repro_torch.models.common import _rounded

    def f(x):
        return x * _rounded(0.1, torch.bfloat16)

    assert audit.audit_fn(f, torch.ones(8)).host_callbacks == []


def test_audit_flags_large_bf16_upcast_but_not_small():
    from repro_torch.kernels.observe import f32_accumulation

    def f(x, s):
        return x.float().sum() + s.float()

    big = torch.zeros(256, 256, dtype=torch.bfloat16)    # 65536 >= 2**14
    small = torch.zeros(4, dtype=torch.bfloat16)
    rep = audit.audit_fn(f, big, small)
    assert rep.large_f32_upcasts == 1
    assert rep.upcasts[0]["numel"] == 65536

    # an implicit promotion counts too; an accumulation operand does not
    def g(x, w):
        with f32_accumulation():
            acc = x.float() @ x.float().T
        return acc + x * w

    rep = audit.audit_fn(g, big, torch.ones(256))
    assert rep.large_f32_upcasts == 1
    assert [u["accum"] for u in rep.upcasts] == [True, True, False]


def test_audit_bytes_and_dtypes():
    rep = audit.audit_fn(lambda x: x * 2,
                         torch.zeros(16, 16, dtype=torch.bfloat16))
    assert rep.arg_bytes == 16 * 16 * 2
    assert rep.out_bytes == 16 * 16 * 2
    assert "bfloat16" in rep.dtypes
    assert rep.device == "meta"


def test_audit_counts_arguments_updated_in_place():
    """The port's donation: the argument tensors whose version counters
    move (the engine's caches, the search state)."""
    def f(a, b, c):
        a.add_(1)
        b[0] = 3
        return c + 1

    rep = audit.audit_fn(f, torch.zeros(4), torch.zeros(4), torch.zeros(4))
    assert rep.donated_in_place == 2


# ---------------------------------------------------------------------------
# contracts: manifest diffing (pure)
# ---------------------------------------------------------------------------


def test_contract_diff_structure():
    g = {"surfaces": {"decode": {"psums_by_site": {"mlp": 2},
                                 "host_callbacks": 0}}}
    same = {"surfaces": {"decode": {"psums_by_site": {"mlp": 2},
                                    "host_callbacks": 0}}}
    assert contracts.diff_manifests(
        g, same, fields=("psums_by_site", "host_callbacks")) == []
    drift = {"surfaces": {"decode": {"psums_by_site": {"mlp": 4},
                                     "host_callbacks": 0}}}
    assert contracts.diff_manifests(g, drift, fields=("psums_by_site",)) \
        == [{"surface": "decode", "field": "psums_by_site",
             "golden": {"mlp": 2}, "current": {"mlp": 4}}]
    assert contracts.diff_manifests(g, {"surfaces": {}})[0]["current"] \
        == "missing"


def test_contract_check_missing_golden_fails(tmp_path):
    ok, diffs = contracts.check(tmp_path / "nope.json", {"surfaces": {}})
    assert not ok and diffs


def test_contract_policy_violations():
    man = {"surfaces": {
        "decode": {"host_callbacks": 1, "large_f32_upcasts": 2,
                   "dtypes": ["float64"], "policy": "serve"},
        "search_chunk": {"host_callbacks": 0, "large_f32_upcasts": 8,
                         "dtypes": ["float32"], "policy": "train"}}}
    got = {(v["surface"], v["field"])
           for v in contracts.policy_violations(man)}
    assert got == {("decode", "host_callbacks"),
                   ("decode", "large_f32_upcasts"), ("decode", "dtypes")}


# ---------------------------------------------------------------------------
# smoke llama's surfaces: the port's goldens and the reference's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama_manifest():
    surfs = surfaces.all_surfaces("llama3.2-1b", device="cpu")
    return contracts.build_manifest("llama3.2-1b", surfs)


def test_llama_contracts_match_the_ports_golden(llama_manifest):
    path = contracts.manifest_path(contracts.GOLDEN_DIR, "llama3.2-1b", None)
    ok, diffs = contracts.check(path, llama_manifest)
    assert ok, diffs
    assert sorted(llama_manifest["surfaces"]) == [
        "decode", "prefill_8", "search_chunk", "verify_4", "write_slot"]
    for name, e in llama_manifest["surfaces"].items():
        if e["policy"] == "serve":
            assert e["host_callbacks"] == 0 and e["large_f32_upcasts"] == 0


def test_llama_contracts_against_the_reference(llama_manifest):
    """Equal on REFERENCE_FIELDS; each other field's difference is the
    representational one listed here (ROADMAP R25)."""
    ref = json.loads(REF_GOLDEN.read_text())["surfaces"]
    port = llama_manifest["surfaces"]
    assert sorted(port) == sorted(ref)
    # the bytes the engine's serving cast takes off the params (the
    # reference's engine keeps the f32 embedding table)
    cast = 512 * 128 * (4 - 2)
    for name, e in port.items():
        g = ref[name]
        for f in contracts.REFERENCE_FIELDS:
            if name == "search_chunk" and f == "large_f32_upcasts":
                continue
            assert e[f] == g[f], (name, f)
        if name == "write_slot":
            # the slot index is a host int (the reference: an int32
            # scalar); the slot write is a copy into a view, no masks
            assert e["arg_bytes"] == g["arg_bytes"] - 4
            assert e["dtypes"] == ["bfloat16"]
        elif name == "search_chunk":
            # the step counter (int32) and the key (two uint32) are host
            # values in the port
            assert e["arg_bytes"] == g["arg_bytes"] - 12
            assert e["out_bytes"] == g["out_bytes"] - 12
            assert e["donation_declared"] == g["donation_declared"] - 2
            assert set(g["dtypes"]) - set(e["dtypes"]) == {"key<fry>",
                                                          "uint32"}
            # per call: 2 steps x (4 layers x 5 large weight gradients +
            # the logits, the tied table twice); the reference counts
            # its scanned step and layer bodies once: 1 x (1 x 5 + 3)
            assert e["large_f32_upcasts"] == 2 * (4 * 5 + 3)
            assert g["large_f32_upcasts"] == 1 * (1 * 5 + 3)
        else:
            assert e["arg_bytes"] == g["arg_bytes"] - cast
            assert e["out_bytes"] == g["out_bytes"]
            # token ids and positions index as int64; the reference's int8
            # is its kernel bodies' unpacked index plane
            assert set(e["dtypes"]) ^ set(g["dtypes"]) == {"int64", "int8"}
            # decode and verify update the engine's caches in place
            assert g["donation_declared"] == 0
            assert e["donation_declared"] == (0 if name == "prefill_8"
                                              else 2)
            assert contracts.reference_kernel_calls(e) \
                == g["info"]["primitives"]["pallas_call"]


@pytest.mark.parametrize("kv_shards", [None, 1, 4])
def test_llama_kernel_calls_per_surface(kv_shards):
    """Per call what the card launches, per site the reference's count:
    4 layers of 7 projections (6 calls per site on the reference's CPU
    route), one decode attention per attention layer at ``kv_shards`` 1, a
    partial and a combine at 4 with the reference's ``attn_kv`` psums."""
    ref = json.loads(REF_GOLDEN.read_text())["surfaces"]
    surfs = surfaces.serve_surfaces("llama3.2-1b", device="cpu",
                                    kv_shards=kv_shards)
    for s in surfs:
        rep = audit.audit_fn(s.fn, *s.args, surface=s.name)
        if s.name == "write_slot":
            assert rep.kernel_launches == {}
            continue
        assert rep.kernel_launches["nm_matmul"] == 4 * 7
        assert rep.kernel_calls["nm_matmul"] == 7
        assert rep.reference_calls - rep.kernel_calls.get(
            "flash_decode", 0) - rep.kernel_calls.get(
            "flash_decode_partial", 0) - rep.kernel_calls.get(
            "combine_partials", 0) == ref[s.name]["info"]["primitives"][
            "pallas_call"]
        attn = {k: v for k, v in rep.kernel_launches.items()
                if k != "nm_matmul"}
        if s.name != "decode" or kv_shards is None:
            assert attn == {} and rep.psums_by_site == {}, s.name
        elif kv_shards == 1:
            assert attn == {"flash_decode": 4}
            assert rep.kernel_calls["flash_decode"] == 1
            assert rep.psums_by_site == {}
        else:
            assert attn == {"flash_decode_partial": 4,
                            "combine_partials": 4}
            two = json.loads(REF_GOLDEN.with_name(
                "llama3.2-1b_2x2.json").read_text())["surfaces"]["decode"]
            assert rep.psums_by_site["attn_kv"] \
                == two["psums_by_site"]["attn_kv"]


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


def test_plan_chain_hand_counted():
    """Python keeps a step's locals alive to its end: a and b both live
    when c is made."""
    def chain(x):
        a = x * 2          # 4096 B
        b = a + 1          # 4096 B
        return b.sum()     # 4 B -> one 512 B block
    p = memplan.plan_fn(chain, torch.zeros(1024))
    assert (p.arg_bytes, p.out_bytes, p.temp_bytes, p.peak_bytes) == (
        4096, 512, 8192, 8704)
    assert p.total_bytes == 4096 + 512 + 8192


def test_plan_in_place_update_reuses_its_operand():
    def inplace(x, cache):
        a = x * 2
        a.add_(1)
        a.mul_(3)
        cache.copy_(a)
        return a, cache
    p = memplan.plan_fn(inplace, torch.zeros(1024), torch.zeros(1024))
    assert p.peak_bytes == 4096            # a only
    assert p.alias_bytes == 4096           # the cache, returned in place
    assert p.donation_declared == 1


def test_plan_buffer_that_dies_early():
    def early(x):
        big = torch.ones(100000)             # 400000 -> 400384 B
        s = big.sum()
        del big
        return x + s                          # made after big is freed
    p = memplan.plan_fn(early, torch.zeros(1024))
    assert p.temp_bytes == 400384 + 512
    assert p.peak_bytes == 400384 + 512       # not + the 4096 B result


def test_plan_counts_nm_matmul_workspace_and_launch():
    """A kernel call is one op: its output, plus the split-K workspace its
    launch allocates for that op; the launch's shared memory from its
    instantiation (``csrc/nm_spmm.cu``'s Tile<1, 1>)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.nm_spmm import nm_matmul
    from repro_torch.sparse.formats import _pack_idx2
    vals, idx = ref.compress_24(torch.randn(2048, 8192))
    vals, idx = vals.bfloat16(), _pack_idx2(idx)
    p = memplan.plan_fn(nm_matmul, torch.zeros(4, 2048,
                                               dtype=torch.bfloat16),
                        vals, idx)
    (launch,) = p.kernels
    assert launch.instantiation == "nm_mma_kernel<1,1>"
    assert launch.dynamic_smem == 3 * (64 * 64 * 2 + 16 * 64 + 8 * 128 * 2)
    ks = launch.grid[1]
    assert ks > 1 and launch.workspace_bytes == ks * 4 * 8192 * 4
    assert p.peak_bytes == 4 * 8192 * 2 + ks * 4 * 8192 * 4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_search_state_bytes_match_the_reference(arch):
    from repro.analysis import memplan as ref_memplan
    assert memplan.search_state_bytes(arch) \
        == ref_memplan.search_state_bytes(arch)


def test_search_fit_table_one_card():
    rows = memplan.fit_table(["llama3.2-1b", "mixtral-8x22b"])
    llama, mixtral = rows
    assert llama["per_mesh"][0]["fits"] and \
        llama["per_mesh"][0]["max_group_layers"] == 16
    # mixtral's 141 B params: W alone overflows 80 GB in f32
    assert mixtral["per_mesh"][0]["max_group_layers"] is None
    assert "mandatory" not in memplan.format_fit_table(rows).split("\n")[1]


# ---------------------------------------------------------------------------
# one card only
# ---------------------------------------------------------------------------


def test_mesh_and_devices_are_refused():
    from repro_torch.analysis.__main__ import main
    with pytest.raises(NotImplementedError, match="item 7"):
        surfaces.serve_surfaces("llama3.2-1b", mesh_shape=(2, 2),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        contracts.build_manifest("llama3.2-1b", [], mesh_shape=(2, 2))
    with pytest.raises(NotImplementedError, match="item 7"):
        memplan.search_plan("llama3.2-1b", device_counts=(1, 4))
    with pytest.raises(SystemExit, match="item 7"):
        main(["--devices", "4", "audit", "--mesh", "2x2"])
    with pytest.raises(NotImplementedError, match="item 7"):
        main(["audit", "--mesh", "2x2", "--device", "cpu"])
    assert main(["shardcheck"]) == 2 and main(["hlo", "x.hlo.gz"]) == 2
