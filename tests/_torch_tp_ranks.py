"""The rank side of tests/test_torch_tp.py: what each gloo rank computes.

Spawned ranks import this module and the port only (no jax, no test
module), so a rank starts in the time torch takes to import.  Every input
is drawn from a seed (the port's ``init_params``, numpy), so each rank and
the test process build the same params.
"""
import dataclasses
import os
import pathlib
import warnings

import numpy as np
import torch

from repro_torch import obs, tree
from repro_torch.configs.base import get_smoke_config
from repro_torch.core import calibrate as tcal
from repro_torch.dist import sharding as shd
from repro_torch.dist.axes import P, make_rules, use_rules
from repro_torch.kernels import shard as ksh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.sparse import apply as apply_mod
from repro_torch.sparse import pack
from repro_torch.sparse.formats import SparseTensor

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANK = ROOT / "results" / "bank" / "llama3.2-1b"
SHAPES = ((1, 4), (2, 2))
SLOTS, CAPACITY, GEN = 2, 32, 6
SITES = ("mlp", "attn", "attn_kv", "moe")


def sparse_smoke(arch: str, d_ff: int | None = None):
    """(cfg, 2:4 magnitude-masked packed2 params) of a smoke config, the
    params drawn by the port's ``init_params`` (seed 0) on the CPU."""
    cfg = get_smoke_config(arch)
    if d_ff is not None:
        cfg = dataclasses.replace(cfg, d_ff=d_ff)
    p = M.init_params(cfg, 0, device="cpu")
    masks = tcal.baseline_masks("magnitude", p, tree.tree_map(
        lambda _: None, p), 0.5, mode="nm")
    return cfg, apply_mod.sparsify_params(p, masks, axes=M.param_axes(cfg),
                                          idx_bits=2, dtype=torch.bfloat16)


def prompts(arch: str, vocab: int) -> list:
    """tests/test_tp.py's prompts."""
    if arch.startswith("mixtral"):
        return [np.arange(1, 9) % vocab, (np.arange(2, 10) * 5) % vocab]
    return [np.arange(1, 9) % vocab, (np.arange(3, 13) * 7) % vocab]


def serve(cfg, params, rules, ps) -> list:
    """tests/test_tp.py's ``serve``: 2 slots, capacity 32, 6 tokens."""
    eng = ServeEngine(cfg, params, slots=SLOTS, capacity=CAPACITY,
                      device="cpu", rules=rules)
    rids = [eng.submit(p, GEN) for p in ps]
    out = eng.run()
    return [out[r] for r in rids]


def logits_probe(cfg, params, rules, ps) -> dict:
    """The prefill logits of the first prompt and the first fused decode
    step's logits over both prompts admitted (f32 numpy)."""
    eng = ServeEngine(cfg, params, slots=SLOTS, capacity=CAPACITY,
                      device="cpu", rules=rules)
    for p in ps:
        eng.submit(p, GEN)
    with eng.fns.ruled():
        pre, _ = M.prefill(cfg, eng.params,
                           {"tokens": torch.from_numpy(
                               np.asarray(ps[0][None], np.int64))},
                           cache_capacity=CAPACITY)
    eng._admit()
    toks = torch.tensor([r.pending_token for r in eng.active])
    with eng.fns.ruled():
        dec, _ = eng.fns.decode(eng.params, toks, eng.caches,
                                torch.from_numpy(eng.pos.copy()))
    return {"prefill": pre.numpy(), "decode": dec.numpy()}


def _bytes(params) -> tuple[int, int]:
    """(bytes of the storages this rank holds for params, bytes of the
    views over them): equal when no block keeps its whole leaf alive."""
    seen, held, viewed = set(), 0, 0
    for w in tree.leaves(params):
        parts = ([w.vals, w.idx] if isinstance(w, SparseTensor) else
                 [w.data] if isinstance(w, shd.DenseBlock) else [w])
        for t in parts:
            viewed += t.numel() * t.element_size()
            key = t.untyped_storage().data_ptr()
            if key not in seen:
                seen.add(key)
                held += t.untyped_storage().nbytes()
    return held, viewed


def planned_bytes(cfg, params, mesh) -> int:
    """Bytes of this rank's blocks by the spec derivation alone."""
    specs = dict(tree.flatten_with_path(shd.params_sharding(
        M.param_axes(cfg), params, make_rules(mesh))))
    total = 0
    for path, w in tree.flatten_with_path(M.serving_params(params)):
        parts = ([(w.vals, specs[path].vals), (w.idx, specs[path].idx)]
                 if isinstance(w, SparseTensor) else [(w, specs[path])])
        for t, spec in parts:
            n = 1
            for d in shd.block_shape(tuple(t.shape), spec, mesh):
                n *= d
            total += n * t.element_size()
    return total


def psum_per_decode(cfg, params, mesh) -> tuple[dict, dict]:
    """tests/test_tp.py's counter check: ``dist.psum`` by site over one
    decode trace, then over a second decode of the same signature."""
    obs.reset()
    obs.configure(enabled=True)
    try:
        eng = ServeEngine(cfg, params, slots=SLOTS, capacity=CAPACITY,
                          device="cpu", rules=make_rules(mesh))
        toks = np.zeros((SLOTS,), np.int32)
        pos = np.zeros((SLOTS,), np.int32)

        def snap():
            return {s: obs.counter_value("dist.psum", site=s) for s in SITES}

        c0 = snap()
        eng.fns.step(eng.params, toks, eng.caches, pos)
        c1 = snap()
        eng.fns.step(eng.params, toks, eng.caches, pos + 1)
        c2 = snap()
        payload = obs.counter_value("dist.psum_bytes", site="mlp")
    finally:
        obs.reset()
    return ({s: c1[s] - c0[s] for s in SITES},
            {s: c2[s] - c1[s] for s in SITES}, payload)


def _rng_24(seed: int, shape) -> SparseTensor:
    """A 2:4-pruned packed2 weight of ``shape`` (.., K, N) from a seed."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))
    return pack.pack_nm(w, _mask24(w), idx_bits=2, dtype=torch.bfloat16)


def _mask24(w: torch.Tensor) -> torch.Tensor:
    """Keep the 2 largest |w| of every 4 along K (dim -2)."""
    g = w.abs().reshape(*w.shape[:-2], w.shape[-2] // 4, 4, w.shape[-1])
    top = g.argsort(dim=-2, descending=True, stable=True)[..., :2, :]
    keep = torch.zeros_like(g, dtype=torch.bool).scatter_(-2, top, True)
    return keep.reshape(w.shape)


def wrapper_inputs():
    """Operands of the wrapper checks, the same on every rank and in the
    test: x2 (3, 64) and x3 (4, 3, 64) bf16, two (64, 32) and two
    (4, 64, 32) 2:4 weights, and a decode attention's q (2, 2, 2, 16) and
    (2, 32, 2, 16) caches (bf16) with 5 and 29 valid slots."""
    rng = np.random.default_rng(7)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        torch.bfloat16)
    x2 = bf(rng.standard_normal((3, 64)))
    x3 = bf(rng.standard_normal((4, 3, 64)))
    mats = [_rng_24(11 + i, (64, 32)) for i in range(2)]
    banks = [_rng_24(21 + i, (4, 64, 32)) for i in range(2)]
    q = bf(rng.standard_normal((2, 2, 2, 16)))
    ck = bf(rng.standard_normal((2, 32, 2, 16)))
    cv = bf(rng.standard_normal((2, 32, 2, 16)))
    ok = torch.arange(32)[None, :] < torch.tensor([[5], [29]])
    return x2, x3, mats, banks, (q, ck, cv, ok)


WRAPPER_AXES = {"dense": "embed|mlp", "pair": "embed|mlp",
                "moe": "|mlp|embed", "moe2": "|embed|mlp"}


def _placed(st: SparseTensor, axes: str, rules, site: str) -> SparseTensor:
    vals_spec, idx_spec, tag = shd.sparse_component_layout(
        axes, st, rules, path=f"['{site}']", quiet=True)
    return SparseTensor(shd.local_block(st.vals, vals_spec, rules.mesh),
                        shd.local_block(st.idx, idx_spec, rules.mesh),
                        idx_bits=st.idx_bits, shard=tag, block=vals_spec)


def wrappers(mesh) -> dict:
    """Each K-sharded wrapper and the decode attention across the ranks,
    on :func:`wrapper_inputs` (the test holds them against the plain
    single-process results)."""
    rules = make_rules(mesh)
    x2, x3, mats, banks, (q, ck, cv, ok) = wrapper_inputs()
    out = {}
    with use_rules(rules):
        a = [_placed(m, WRAPPER_AXES["dense"], rules, "mlp") for m in mats]
        out["tags_2d"] = a[0].shard
        out["dense"] = ksh.nm_dense_sharded(a[0], x2, site="mlp")
        out["pair"] = ksh.nm_dense2_sharded(a[0], a[1], x2, site="mlp")
        down = _placed(banks[0], WRAPPER_AXES["moe"], rules, "moe")
        out["tags_bank"] = down.shard
        out["moe"] = ksh.nm_moe_sharded(down, x3)
        ug = [_placed(b, WRAPPER_AXES["moe2"], rules, "moe") for b in banks]
        out["moe2"] = ksh.nm_moe2_sharded(ug[0], ug[1], x3)
        axes = ksh.kv_shard_axes(q.shape[0], ck.shape[1])
        spec = P(None, "model")
        blk = [shd.local_block(t, spec, mesh) for t in (ck, cv, ok)]
        for exact in (True, False):
            out[f"attend_exact={exact}"] = ksh.decode_attend_sharded(
                q, *blk, axes=axes, scale=16 ** -0.5, exact=exact)
    return {k: (tuple(v) if isinstance(v, tuple) and isinstance(v[0], str)
                else [t.float().numpy() for t in v] if isinstance(v, list)
                else v.float().numpy() if isinstance(v, torch.Tensor)
                else v) for k, v in out.items()}


def fleet_streams(rules) -> list:
    """A 0.0 / 2:4 ``SparsityFleet`` over the committed smoke bank, each
    prompt pinned to each budget: the streams in submit order."""
    from repro_torch.serve.fleet import SparsityFleet
    from repro_torch.sparse.bank import MaskBank
    bank = MaskBank.load(BANK, device="cpu")
    params0 = M.init_params(bank.cfg, 0, device="cpu")
    fleet = SparsityFleet(bank, params0, ["0.0", "2:4"], slots=4,
                          capacity=CAPACITY, device="cpu", rules=rules)
    ps = prompts("llama", bank.cfg.vocab_size)
    rids = [fleet.submit(p, GEN, budget=b) for b in ("0.0", "2:4")
            for p in ps]
    out = fleet.run()
    return [out[r] for r in rids]


def rank_main(rank: int, world: int, device) -> dict:
    """Everything the test holds, from one rank."""
    out = {}
    cfg, sp = sparse_smoke("llama3.2-1b")
    ps = prompts("llama", cfg.vocab_size)
    for shape in SHAPES:
        mesh = Mesh(shape, ("data", "model"))
        rules = make_rules(mesh)
        out["llama", shape] = serve(cfg, sp, rules, ps)
        out["llama logits", shape] = logits_probe(cfg, sp, rules, ps)
        eng = ServeEngine(cfg, sp, slots=SLOTS, capacity=CAPACITY,
                          device="cpu", rules=rules)
        out["bytes", shape] = (*_bytes(eng.params),
                               planned_bytes(cfg, sp, mesh))
        out["cache", shape] = tuple(eng.caches[0]["0"]["k"].shape)
    mesh22 = Mesh((2, 2), ("data", "model"))
    out["psum"] = psum_per_decode(cfg, sp, mesh22)
    out["wrappers"] = wrappers(mesh22)
    out["fleet"] = fleet_streams(make_rules(mesh22))
    mesh14 = Mesh((1, 4), ("data", "model"))
    os.environ[ksh.FORCE_REPLICATED_ENV] = "1"
    try:
        out["llama", "forced"] = serve(cfg, sp, make_rules(mesh14), ps)
    finally:
        del os.environ[ksh.FORCE_REPLICATED_ENV]
    cfg72, sp72 = sparse_smoke("llama3.2-1b", d_ff=72)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out["dff72"] = serve(cfg72, sp72, make_rules(mesh14),
                             prompts("llama", cfg72.vocab_size)[:1])
    out["dff72 warnings"] = [str(w.message) for w in rec]
    mcfg, msp = sparse_smoke("mixtral-8x22b")
    mps = prompts("mixtral", mcfg.vocab_size)
    for shape in SHAPES:
        rules = make_rules(Mesh(shape, ("data", "model")))
        out["mixtral", shape] = serve(mcfg, msp, rules, mps)
        eng = ServeEngine(mcfg, msp, slots=SLOTS, capacity=CAPACITY,
                          device="cpu", rules=rules)
        down = eng.params["stages"][0]["0"]["moe"]["down"]["kernel"]
        out["mixtral down", shape] = (down.shard, tuple(down.vals.shape))
    # dense (unpruned) mixtral: every kernel and expert bank a DenseBlock
    dense = M.init_params(mcfg, 0, device="cpu")
    out["mixtral dense"] = serve(mcfg, dense, make_rules(mesh22), mps)
    return out


def failing(rank: int, world: int, device) -> None:
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    torch.distributed.barrier()


def gloo_card_rank(rank: int, world: int, device) -> tuple:
    """tests/test_torch_cuda.py: smoke llama 2:4 under rules on (1, 2) on
    this rank's card over gloo: the eager streams, and the message of the
    graph surface's refusal."""
    from repro_torch.serve.engine import eager
    cfg, sp = sparse_smoke("llama3.2-1b")
    ps = prompts("llama", cfg.vocab_size)
    rules = make_rules(Mesh((1, world), ("data", "model")))
    eng = ServeEngine(cfg, sp, slots=SLOTS, capacity=CAPACITY,
                      device=device, rules=rules)
    rids = [eng.submit(p, GEN) for p in ps]
    with eager():
        out = eng.run()
    eng.submit(ps[0], 2)
    try:
        eng.run()
        refused = ""
    except ValueError as err:
        refused = str(err)
    return [out[r] for r in rids], refused
