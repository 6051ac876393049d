"""Batched serving engine: request queue -> continuous batched decode.

Port of ``repro.serve.engine``.  Continuous batching over a fixed-slot KV
cache: requests join free slots, prefill runs once per admitted request
(one bucketed forward that fills the slot's cache rows), and decode
advances every slot one token per step in ONE ``model.decode_step`` call
with the per-slot positions as an index vector, so each slot writes its
own ring slot and masks attention at its own position and new slots admit
mid-batch.  ``decode_mode="vmap"`` keeps the reference's per-slot oracle:
each slot decodes alone at its own position, a loop over one-slot views
of the caches.  Finished slots free up on max_tokens or on emitting the
eos token and are reused by queued requests.

Weights may be dense or 2:4-compressed (``sparse.apply.sparsify_params``):
``models.common.dense`` dispatches per leaf, so the same engine serves
both, every compressed projection through the ``nm_matmul`` kernel and
every compressed MoE expert bank through ``nm_matmul_expert`` on the card.
Caches are per layer kind: a sliding-window layer keeps a ring of
min(capacity, window) slots, an MLA layer (deepseek) a ring of its latent
``ckv`` and shared rope key ``krope``, a recurrent layer (zamba2's Mamba2,
xlstm's mLSTM and sLSTM) its state, updated in place each step, and
zamba2's shared attention a full ring.  Recurrent kinds fold every token
into their state, so their prompts prefill unpadded, and a slot admitted
with a one-token prompt starts from the blank state (``blank_row``), as
in the reference.  ``kv_shards`` picks the decode
attention path (``models.attention.decode_attend``): None, the reference's replicated
plain-torch attention; 1, the ``flash_decode`` kernel; S >= 2, what the
reference computes on a mesh whose ``model`` axis (``mesh.shape["model"] ==
S``) shards the cache capacity: ``flash_decode_partial`` over S capacity
shards plus the combine kernel, on one card.  S must divide every cache
length, or construction raises; so does any set ``kv_shards`` on a model
with MLA layers, whose decode has no decode-attention kernel, or with no
attention at all (xlstm).  An encoder-decoder model (whisper) is refused,
as the reference's engine asserts, and so by the fleet and spec that
build on it; pixtral serves text-only (its prefill takes no
``patches``), as in the reference.  ``ServeEngine.from_artifact`` builds
the sparse engine straight from a saved mask bank.  Request validation
happens at ``submit()``: an empty prompt, a prompt at or over cache
capacity, or ``max_tokens <= 0`` never claims a slot.

The step functions (decode, the k-token draft loop and the k-token
teacher-forced verify of ``serve.spec``, bucketed prefill, the slot write)
live in :class:`EngineFns`; engines that share one instance (the members
of ``serve.fleet.SparsityFleet``) share its graph memory pool.  On the card
the decode, draft and verify steps replay CUDA graphs, where the reference
replays jitted programs: one per engine and surface, captured at first
use (each k of draft and verify its own surface, as jit buckets are), each
with static input buffers filled from pinned host memory and its greedy
tokens computed inside the graph.  Caches are updated in place (admission
too), so a graph captured before an admission sees it.  Prefill stays
eager.  :func:`eager` runs every step eagerly on the card as well, the
graphs' oracle (the analogue of ``jax.disable_jit``); on the CPU
everything is eager.

``rules`` (a ``dist.axes.ShardingRules`` over a ``launch.mesh.Mesh`` of
ranks, one engine a rank, every rank submitting the same requests):
tensor-parallel serving, as the reference's ``EngineFns(rules=)``.  The
engine tags the compressed leaves and keeps each rank's block of every
leaf (``dist.sharding.place_params``) and of every KV ring
(``place_caches``), and every surface runs with the rules and the
capacity installed (``dist.axes.use_rules``,
``kernels.shard.serving_capacity``); activations and greedy tokens are
replicated.  llama and mixtral only (``model.check_tp_supported``);
``kv_shards`` with rules raises.  A CUDA graph captures collectives over
NCCL only: over another backend on the card a graph surface raises unless
it runs under :func:`eager`.

The flight recorder (``repro_torch.obs``) sees what the reference's sees:
``serve.requests_submitted`` / ``_retired``, ``serve.queue_depth``, a
``serve.prefill`` span and ``serve.prefill_ms`` per admission,
``serve.prefill_bucket_hits``, ``serve.decode_step_ms``,
``serve.slot_util`` and ``serve.tokens_decoded`` per decode step, all
labelled with the engine's ``labels``; ``serve.jit_entries`` at the first
use of each (surface, bucket) and ``serve.jit_cache_size`` per surface
after each ``run()``.  A surface's cache size is the number of distinct
call signatures it has seen (:meth:`EngineFns.jit_cache_sizes`), what the
reference's jit cache holds; the graphs captured are
:meth:`EngineFns.capture_counts`.  No recorder call sits inside a captured
body: the decode step's clock is read around the replay, whose read of
the greedy tokens is the step's synchronisation.  The recompile sentinel
(``analysis.recompile``) notes prefill, the slot write and decode.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import obs, tree
from repro_torch.analysis import recompile
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.axes import use_rules
from repro_torch.kernels.shard import (check_kv_shards, serving_capacity,
                                       surface_call)
from repro_torch.models import model as M

# layer kinds whose prompt padding is invisible: position-masked attention
# rings, where a junk slot past the prompt is masked until overwritten.  MoE
# kinds are not: padding tokens would route, take expert capacity (C grows
# with the token count) and change which real tokens are dropped, so their
# prefill runs at the exact prompt length, as in the reference.
_PAD_SAFE_KINDS = {"attn", "local"}

_eager_depth = 0


@contextlib.contextmanager
def eager():
    """While open, every :class:`EngineFns` step runs eagerly on the card
    too: no CUDA graph is captured or replayed.  The graphs' oracle, and
    the mode in which patched or counting Python wrappers see each call."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    pending_token: int = 0        # next token to feed (last prompt tok, then
                                  # each generated one)


class _Graph:
    """One surface of one engine captured as a CUDA graph: static device
    inputs (fed tokens int64, positions int32), filled from pinned host
    buffers before each replay, and the greedy tokens (int32) read back
    from a static output.  Holds the params and caches whose buffers the
    graph reads and writes.  ``state``: the caches' recurrent-state tensors
    (``model.state_leaves``), which the eager warm-up before the capture
    would advance: they are restored after it, so that the first replay
    is the step's only application."""

    def __init__(self, body: Callable, params, caches: list,
                 inp: np.ndarray, pos: np.ndarray, device, pool,
                 traced: bool = False, state: list = ()):
        self.params, self.caches = params, caches
        self.inp = torch.empty(inp.shape, dtype=torch.int64, device=device)
        self.pos = torch.empty(pos.shape, dtype=torch.int32, device=device)
        self.inp_host = torch.empty(inp.shape, dtype=torch.int64,
                                    pin_memory=True)
        self.pos_host = torch.empty(pos.shape, dtype=torch.int32,
                                    pin_memory=True)
        self._fill(inp, pos)
        # one eager run first, on a side stream: it makes what capture
        # cannot (nm_matmul's split-K counters, library handles).  It writes
        # the same cache rows the replay below writes again.
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), surface_call(False):
            saved = [t.clone() for t in state]
            body(params, self.inp, caches, self.pos)
            for t, was in zip(state, saved, strict=True):
                t.copy_(was)
            del saved
        cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # the capture is the surface's trace when its signature is new
        with torch.cuda.graph(self.graph, pool=pool), surface_call(traced):
            self.out = body(params, self.inp, caches, self.pos)
        self.out_host = torch.empty(self.out.shape, dtype=self.out.dtype,
                                    pin_memory=True)

    def _fill(self, inp: np.ndarray, pos: np.ndarray) -> None:
        self.inp_host.numpy()[...] = inp
        self.pos_host.numpy()[...] = pos
        self.inp.copy_(self.inp_host, non_blocking=True)
        self.pos.copy_(self.pos_host, non_blocking=True)

    def run(self, inp: np.ndarray, pos: np.ndarray) -> np.ndarray:
        self._fill(inp, pos)
        self.graph.replay()
        self.out_host.copy_(self.out, non_blocking=True)
        torch.cuda.current_stream(self.out.device).synchronize()
        return self.out_host.numpy().copy()


class EngineFns:
    """Step functions + the blank-slot template for one (cfg, capacity,
    device, kv_shards, decode_mode, rules).

    ``ServeEngine`` builds one per instance by default; a multi-engine
    owner (``serve.fleet.SparsityFleet``) builds ONE and hands it to every
    member.  :meth:`step`, :meth:`draft` and :meth:`verify` return greedy
    tokens on the host; on the card (outside :func:`eager`) each replays
    the CUDA graph of its surface for the engine whose caches it is given,
    capturing it at first use, with every graph of this instance in one
    memory pool (they never run concurrently).  ``decode_mode="vmap"``
    decodes eagerly, slot by slot; its draft and verify are the fused ones,
    as in the reference.  ``rules``: tensor parallelism (module
    docstring); the placed blocks of leaves that several engines on this
    instance share (a fleet's untouched leaves) are placed once
    (``placed``).
    """

    def __init__(self, cfg: ModelConfig, capacity: int, device,
                 kv_shards: int | None = None, decode_mode: str = "fused",
                 rules=None):
        if decode_mode not in ("fused", "vmap"):
            raise ValueError(f"decode_mode {decode_mode!r}: 'fused' or "
                             "'vmap'")
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name}: the engine is decoder-only, as the "
                "reference's: an encoder-decoder model serves through "
                "launch.serve's generate (its prefill runs the encoder)")
        if rules is not None:
            M.check_tp_supported(cfg)
            if kv_shards is not None:
                raise ValueError(
                    f"kv_shards={kv_shards} with rules: kv_shards splits the "
                    "capacity inside one launch on one card; under rules the "
                    "mesh's 'model' ranks shard it")
        check_kv_shards(kv_shards, M.cache_lengths(cfg, capacity),
                        cfg.layer_kinds)
        self.cfg = cfg
        self.capacity = capacity
        self.device = device
        self.kv_shards = kv_shards
        self.decode_mode = decode_mode
        self.rules = rules
        # id(leaf) -> (weak reference to the leaf, this rank's block of it)
        self.placed: dict[int, tuple] = {}
        self.verify_fns: dict[int, Callable] = {}   # k -> verify pass
        self.draft_fns: dict[int, Callable] = {}    # k -> draft loop
        self.prefill_buckets: set[int] = set()      # buckets used
        # surface -> the distinct call signatures it has seen
        self._sigs: dict[str, set] = {"decode": set(), "write_slot": set()}
        # (surface, ids and shapes of a call) already signed; holds the
        # call's params and caches so their ids stay theirs
        self._signed: dict[tuple, tuple] = {}
        self._graphs: dict[tuple, _Graph] = {}
        self._pool = None
        self._blank_row = None

    @contextlib.contextmanager
    def ruled(self):
        """The rules and the capacity installed for one model call (nothing
        without rules)."""
        if self.rules is None:
            yield
            return
        with use_rules(self.rules), serving_capacity(self.capacity):
            yield

    # -- model calls (eager) -------------------------------------------------

    def decode(self, params, toks: torch.Tensor, caches: list,
               t: torch.Tensor):
        """One decode step over every slot at its own position, eagerly:
        fused, or slot by slot in ``vmap`` mode.  (logits, caches)."""
        if self.decode_mode == "fused":
            return self._fused(params, toks, caches, t)
        logits = [self._fused(params, toks[s:s + 1],
                              tree.tree_map(lambda a: a[:, s:s + 1], caches),
                              t[s:s + 1])[0]
                  for s in range(toks.shape[0])]
        return torch.cat(logits), caches

    def _fused(self, params, toks, caches, t):
        return M.decode_step(self.cfg, params, toks, caches, t,
                             kv_shards=self.kv_shards)

    def _new_signature(self, surface: str, args: tuple,
                       ids: tuple | None = None) -> bool:
        """Record a call of ``surface``; True when its signature
        (``recompile.signature``) is new to the surface: the call the
        reference's jit would trace.  ``ids``: a cheap key of the call
        (object ids and shapes) under which its signature is computed
        once."""
        if ids is not None:
            key = (surface, *ids)
            if key in self._signed:
                return False
            self._signed[key] = args
        sigs = self._sigs.setdefault(surface, set())
        sig = recompile.signature(args)
        if sig in sigs:
            return False
        sigs.add(sig)
        return True

    def prefill(self, params, toks: torch.Tensor) -> list:
        """Cache rows for one padded prompt (1, bucket)."""
        bucket = toks.shape[1]
        if bucket not in self.prefill_buckets:
            self.prefill_buckets.add(bucket)
            obs.inc("serve.jit_entries", surface="prefill", bucket=bucket)
        traced = self._new_signature(f"prefill_{bucket}", (params, toks),
                                     (id(params), bucket))
        # under rules a bucket's first call is its trace: the reference's
        # jitted prefill counts its collectives once a bucket
        with self.ruled(), (surface_call(traced) if self.rules is not None
                            else contextlib.nullcontext()):
            return M.prefill(self.cfg, params, {"tokens": toks},
                             cache_capacity=self.capacity)[1]

    def write_slot(self, full: list, row: list, s: int) -> list:
        """Replace slot s's cache rows with a 1-slot row, in place (under
        rules, the row's slots of this rank's ring block)."""
        self._new_signature("write_slot", (full, row, np.int32(s)))

        def put(f, n):
            if f.dim() >= 3 and f.shape[2] != n.shape[2]:
                # a capacity-sharded ring (dist.sharding.place_caches)
                i = self.rules.mesh.index("model")
                n = n.narrow(2, i * f.shape[2], f.shape[2])
            f[:, s].copy_(n[:, 0])

        tree.tree_map(put, full, row)
        return full

    def blank_row(self) -> list:
        """1-slot cache template that resets a reused slot's state."""
        if self._blank_row is None:
            self._blank_row = M.init_caches(self.cfg, 1, self.capacity,
                                            device=self.device)
        return self._blank_row

    # -- the greedy surfaces -------------------------------------------------

    def step(self, params, toks: np.ndarray, caches: list,
             pos: np.ndarray) -> np.ndarray:
        """One decode step's greedy tokens (B,) int32 on the host."""
        def body(p, x, c, t):
            return self.decode(p, x, c, t)[0].argmax(-1).to(torch.int32)
        return self._call("decode", body, params, toks, caches, pos,
                          graph=self.decode_mode == "fused")

    def draft(self, k: int) -> Callable:
        """The k-token autoregressive draft loop: ``(params, seed (B,),
        caches, pos (B,)) -> (drafts (B, k) int32, caches)``.  Feeds
        ``seed``, then its own greedy argmax k - 1 more times; each step
        is the fused ``model.decode_step``, so the loop proposes what the
        engine's own sequential decode would."""
        fn = self.draft_fns.get(k)
        if fn is None:
            obs.inc("serve.jit_entries", surface="draft", bucket=k)

            def body(p, seed, c, t):
                tok, out = seed, []
                for i in range(k):
                    tok = self._fused(p, tok, c, t + i)[0].argmax(-1)
                    out.append(tok)
                return torch.stack(out, dim=1).to(torch.int32)

            def fn(params, seed, caches, pos):
                return self._call(f"draft_{k}", body, params, seed, caches,
                                  pos), caches
            self.draft_fns[k] = fn
        return fn

    def verify(self, k: int) -> Callable:
        """The teacher-forced verify over k fed tokens in one pass:
        ``(params, toks (B, k), caches, pos (B,)) -> (argmax (B, k) int32,
        caches)``.  Column i is the greedy continuation of the fed prefix
        ``toks[:, :i + 1]`` (``model.verify_step``).  Cache rows for all k
        fed positions are written; rows past a rejection sit ahead of the
        slot's committed position and stay masked until the committed
        stream overwrites them, so rollback is host-side bookkeeping."""
        fn = self.verify_fns.get(k)
        if fn is None:
            obs.inc("serve.jit_entries", surface="verify", bucket=k)

            def body(p, toks, c, t):
                logits, _ = M.verify_step(self.cfg, p, toks, c, t)
                return logits.argmax(-1).to(torch.int32)

            def fn(params, toks, caches, pos):
                return self._call(f"verify_{k}", body, params, toks, caches,
                                  pos), caches
            self.verify_fns[k] = fn
        return fn

    def _call(self, surface: str, body: Callable, params, inp: np.ndarray,
              caches: list, pos: np.ndarray, graph: bool = True
              ) -> np.ndarray:
        """``body(params, inp, caches, positions)`` -> greedy tokens on the
        host: eagerly on the CPU, in vmap decode and under :func:`eager`;
        else through the surface's CUDA graph for these caches.  The
        call whose signature is new to the surface (on the graph path: its
        capture) is the surface's trace (``kernels.shard.surface_call``)."""
        inp = np.asarray(inp)
        pos = np.asarray(pos, np.int32)
        args = (params, inp, caches, pos)
        if self.rules is not None:
            body = self._ruled_body(body)
        if self.device.type != "cuda" or _eager_depth or not graph:
            traced = self._new_signature(
                surface, args, (id(params), id(caches), inp.shape,
                                pos.shape))
            with surface_call(traced):
                out = body(params,
                           torch.from_numpy(inp).to(self.device).long(),
                           caches,
                           torch.from_numpy(pos.copy()).to(self.device))
            return out.cpu().numpy()
        key = (surface, id(params), id(caches))
        g = self._graphs.get(key)
        if g is None:
            if self.rules is not None:
                backend = dist.get_backend()
                if backend != "nccl":
                    raise ValueError(
                        f"the {surface} surface under rules on the card: a "
                        "CUDA graph captures collectives over NCCL only, and "
                        f"the process group's backend is {backend!r}; run "
                        "the engine under serve.engine.eager()")
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[key] = _Graph(
                body, params, caches, inp, pos, self.device, self._pool,
                traced=self._new_signature(surface, args),
                state=M.state_leaves(self.cfg, caches))
        return g.run(inp, pos)

    def _ruled_body(self, body: Callable) -> Callable:
        def ruled(*args):
            with self.ruled():
                return body(*args)
        return ruled

    def place(self, params):
        """This rank's blocks of ``params`` (``dist.sharding.place_params``),
        each shared leaf placed once on this instance."""
        return shd.place_params(M.param_axes(self.cfg), params, self.rules,
                                memo=self.placed)

    def capture_counts(self) -> dict[str, int]:
        """CUDA graphs captured per surface (``decode``, ``draft_k``,
        ``verify_k``), over every engine on this instance; it grows only
        with a new engine or a new k."""
        return dict(sorted(collections.Counter(
            surface for surface, *_ in self._graphs).items()))

    def jit_cache_sizes(self) -> dict[str, int]:
        """Distinct call signatures per surface (``decode``,
        ``write_slot``, ``prefill_<bucket>``, ``verify_<k>``,
        ``draft_<k>``), over every engine on this instance: what the
        reference's jit caches hold, one entry per params structure and
        shapes, so fleet members that share both count once (on the card
        each engine still captures its own graph: :meth:`capture_counts`).
        """
        names = ["decode", "write_slot",
                 *(f"prefill_{b}" for b in self.prefill_buckets),
                 *(f"verify_{k}" for k in self.verify_fns),
                 *(f"draft_{k}" for k in self.draft_fns)]
        return {n: len(self._sigs.get(n, ())) for n in names}


class ServeEngine:
    """Slot-based continuous batching (greedy decode).

    Runs on the card unless ``device`` names another; params are moved
    there, with the embedding and dense kernels cast to the compute dtype
    once (``model.serving_params``); a leaf already on the device in that
    dtype is kept as it is (not copied), so engines built from one cast
    tree share its leaves.  ``kv_shards``: the decode attention path
    (module docstring); a value that is not an integer >= 1 dividing every
    cache length raises ``ValueError``.  ``fns``: a shared
    :class:`EngineFns`, which must have been built for this engine's cfg,
    capacity, decode mode, device and ``kv_shards`` (else ``ValueError``).
    ``labels``: metric labels stamped on every span, counter and
    histogram this engine records (a fleet labels its members by budget).
    ``rules``: tensor-parallel serving (module docstring); a shared
    ``fns`` must carry the same rules object.
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 capacity: int = 512, decode_mode: str = "fused",
                 eos_id: int | None = None, device=None,
                 kv_shards: int | None = None, fns: EngineFns | None = None,
                 labels: dict | None = None, rules=None):
        M.check_supported(cfg)
        device = resolve_device(device)
        if fns is None:
            fns = EngineFns(cfg, capacity, device, kv_shards, decode_mode,
                            rules=rules)
        elif (fns.cfg, fns.capacity, fns.decode_mode, fns.device,
              fns.kv_shards) != (cfg, capacity, decode_mode, device,
                                 kv_shards) or fns.rules is not rules:
            raise ValueError(
                "shared EngineFns was built for "
                f"(capacity={fns.capacity}, decode_mode={fns.decode_mode}, "
                f"device={fns.device}, kv_shards={fns.kv_shards}) and cannot "
                f"serve (capacity={capacity}, decode_mode={decode_mode}, "
                f"device={device}, kv_shards={kv_shards}) or a different "
                "cfg or rules")
        self.fns = fns
        self.cfg = cfg
        self.slots = slots
        self.capacity = capacity
        self.decode_mode = decode_mode
        self.device = device
        self.eos_id = cfg.eos_id if eos_id is None else eos_id
        self.rules = rules
        self.params = M.serving_params(tree.to_device(params, device))
        self.caches = M.init_caches(cfg, slots, capacity, device=device)
        if rules is not None:
            self.params = fns.place(self.params)
            self.caches = shd.place_caches(self.caches, rules)
        self.pos = np.zeros((slots,), np.int32)       # next position per slot
        self.active: list[Request | None] = [None] * slots
        self.queue: collections.deque[Request] = collections.deque()
        self._done_unslotted: list[Request] = []  # finished without a slot
        self._next_rid = 0
        self._pad_prefill = set(cfg.layer_kinds) <= _PAD_SAFE_KINDS
        # sliding-window layers cap their ring at min(capacity, window), so
        # a padded bucket must fit that ring
        self._min_ring = (min(capacity, cfg.sliding_window)
                          if cfg.sliding_window else capacity)
        self.obs_labels = dict(labels or {})
        # work counters: prefill forwards run and fused decode steps taken
        self.prefill_calls = 0
        self.decode_steps = 0

    @classmethod
    def from_artifact(cls, bank_dir, params0: Any, *,
                      sparsity: float | None = None, compressed: bool = True,
                      slots: int = 4, capacity: int = 512,
                      decode_mode: str = "fused",
                      eos_id: int | None = None, device=None,
                      kv_shards: int | None = None,
                      rules=None) -> "ServeEngine":
        """Engine over bank-derived sparse weights (no re-calibration)."""
        from repro_torch.sparse.bank import MaskBank
        device = resolve_device(device)
        bank = MaskBank.load(bank_dir, device=device)
        params = bank.sparse_params(tree.to_device(params0, device),
                                    sparsity=sparsity,
                                    compressed=compressed)
        return cls(bank.cfg, params, slots=slots, capacity=capacity,
                   decode_mode=decode_mode, eos_id=eos_id, device=device,
                   kv_shards=kv_shards, rules=rules)

    # -- client API ----------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_tokens: int = 16) -> int:
        """Queue a request; every admission invariant is checked here, so
        an invalid request never claims a slot."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError(
                "empty prompt: a request needs at least one token to feed "
                "the first decode step (rejected at submit, no slot claimed)")
        if len(prompt) - 1 >= self.capacity:
            raise ValueError(
                f"prompt of {len(prompt)} tokens needs {len(prompt) - 1} "
                f"prefill cache rows but engine capacity is {self.capacity} "
                "(rejected at submit, no slot claimed)")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, prompt, max_tokens)
        if max_tokens <= 0:
            # already complete: no slot, no decode step
            req.done = True
            self._done_unslotted.append(req)
        else:
            self.queue.append(req)
        if obs.enabled():
            obs.inc("serve.requests_submitted", **self.obs_labels)
            obs.set_gauge("serve.queue_depth", len(self.queue),
                          **self.obs_labels)
        return rid

    @property
    def pending(self) -> bool:
        """Any submitted-but-undelivered work (queued, active, or finished
        without a slot and awaiting the next ``run()``)."""
        return bool(self.queue or self._done_unslotted
                    or any(r is not None for r in self.active))

    def run(self) -> dict[int, list[int]]:
        """Drive until all submitted requests complete; returns rid->tokens."""
        results: dict[int, list[int]] = {
            r.rid: r.out for r in self._done_unslotted}
        self._done_unslotted.clear()
        while self.queue or any(r is not None for r in self.active):
            self._admit()
            for r in self._step():
                results[r.rid] = r.out
        if obs.enabled():
            # compiled-entry counts per shared surface: a growing gauge
            # across runs means a new params structure or shape
            for surface, size in self.fns.jit_cache_sizes().items():
                obs.set_gauge("serve.jit_cache_size", size, surface=surface)
        return results

    # -- internals -----------------------------------------------------------

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self._prefill_slot(s, req)

    def free_slot(self, s: int) -> None:
        """Release slot s for reuse (requests retired outside ``_step``,
        e.g. by the speculative decoder, go through here)."""
        self.active[s] = None
        self.pos[s] = 0

    def _prefill_bucket(self, n: int) -> int:
        """Padded prompt length: the next power of two (at least 8), capped
        at the capacity; the exact length where padding is not invisible
        (MoE kinds) or the bucket would overrun the smallest ring (it would
        evict real in-window tokens)."""
        if not self._pad_prefill:
            return n
        bucket = min(max(8, 1 << (n - 1).bit_length()), self.capacity)
        return bucket if bucket <= self._min_ring else n

    def _prefill_slot(self, s: int, req: Request) -> None:
        """Prefill all prompt tokens but the last into slot s's cache rows.

        The prompt is padded to its bucket; padding is masked during decode
        (kpos > t) and each junk ring slot is overwritten by a real token
        before it could become visible.
        """
        n = len(req.prompt) - 1  # submit() guarantees 0 <= n < capacity
        sp = obs.span("serve.prefill", slot=s, prompt_len=len(req.prompt),
                      **self.obs_labels)
        with sp:
            if n == 0:
                row = self.fns.blank_row()
                sp.set(bucket="blank")
            else:
                bucket = self._prefill_bucket(n)
                toks = np.zeros((1, bucket), np.int32)
                toks[0, :n] = req.prompt[:-1]
                if recompile.enabled():
                    recompile.note(f"prefill_{bucket}", (self.params, toks))
                row = self.fns.prefill(self.params,
                                       torch.from_numpy(toks).to(self.device))
                self.prefill_calls += 1
                sp.set(bucket=bucket)
                obs.inc("serve.prefill_bucket_hits", bucket=bucket,
                        **self.obs_labels)
            if recompile.enabled():
                recompile.note("write_slot", (self.caches, row, np.int32(s)))
            self.fns.write_slot(self.caches, row, s)
            sp.fence(row)
        if sp.seconds is not None:
            obs.observe("serve.prefill_ms", sp.seconds * 1e3,
                        **self.obs_labels)
        self.pos[s] = n
        req.pending_token = int(req.prompt[-1])

    def _step(self) -> list[Request]:
        toks = np.zeros((self.slots,), np.int32)
        n_active = 0
        for s, req in enumerate(self.active):
            if req is not None:
                toks[s] = req.pending_token
                n_active += 1
        # the decode step is the hot path: a histogram observation, no
        # span.  fns.step returns the greedy tokens on the host, the step's
        # own synchronisation, so the clock needs no fence of its own.
        if recompile.enabled():
            recompile.note("decode", (self.params, toks, self.caches,
                                      self.pos))
        t0 = time.perf_counter() if obs.enabled() else None
        nxt = self.fns.step(self.params, toks, self.caches, self.pos)
        if t0 is not None:
            obs.observe("serve.decode_step_ms",
                        (time.perf_counter() - t0) * 1e3, **self.obs_labels)
            obs.set_gauge("serve.slot_util", n_active / max(self.slots, 1),
                          **self.obs_labels)
            obs.inc("serve.tokens_decoded", n_active, **self.obs_labels)
        self.decode_steps += 1
        finished = []
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.pos[s] += 1
            tok = int(nxt[s])
            req.out.append(tok)
            req.pending_token = tok
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(req.out) >= req.max_tokens:
                req.done = True
                finished.append(req)
                self.free_slot(s)       # freed: _admit reuses it next step
        if finished and obs.enabled():
            obs.inc("serve.requests_retired", len(finished),
                    **self.obs_labels)
        return finished
