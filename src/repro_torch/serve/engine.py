"""Batched serving engine: request queue -> continuous batched decode.

Port of ``repro.serve.engine`` (fused decode mode).  Continuous batching
over a fixed-slot KV cache: requests join free slots, prefill runs once per
admitted request (one bucketed forward that fills the slot's cache rows),
and decode advances every slot one token per step in ONE
``model.decode_step`` call with the per-slot positions as an index vector,
so each slot writes its own ring slot and masks attention at its own
position and new slots admit mid-batch.  Finished slots free up on
max_tokens or on emitting the eos token and are reused by queued requests.

Weights may be dense or 2:4-compressed (``sparse.apply.sparsify_params``):
``models.common.dense`` dispatches per leaf, so the same engine serves
both, every compressed projection through the ``nm_matmul`` kernel on the
card.  ``ServeEngine.from_artifact`` builds the sparse engine straight from
a saved mask bank.  Request validation happens at ``submit()``: an empty
prompt, a prompt at or over cache capacity, or ``max_tokens <= 0`` never
claims a slot.  Caches are updated in place.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_tokens: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    pending_token: int = 0        # next token to feed (last prompt tok, then
                                  # each generated one)


class EngineFns:
    """Step functions + the blank-slot template for one (cfg, capacity,
    device): fused decode, bucketed prefill and the slot write."""

    def __init__(self, cfg: ModelConfig, capacity: int, device):
        self.cfg = cfg
        self.capacity = capacity
        self.device = device
        self._blank_row = None

    def decode(self, params, toks: torch.Tensor, caches: list,
               t: torch.Tensor):
        """One fused decode step over every slot at its own position."""
        return M.decode_step(self.cfg, params, toks, caches, t)

    def prefill(self, params, toks: torch.Tensor) -> list:
        """Cache rows for one padded prompt (1, bucket)."""
        return M.prefill(self.cfg, params, {"tokens": toks},
                         cache_capacity=self.capacity)[1]

    @staticmethod
    def write_slot(full: list, row: list, s: int) -> list:
        """Replace slot s's cache rows with a 1-slot row, in place."""
        tree.tree_map(lambda f, n: f[:, s].copy_(n[:, 0]), full, row)
        return full

    def blank_row(self) -> list:
        """1-slot cache template that resets a reused slot's state."""
        if self._blank_row is None:
            self._blank_row = M.init_caches(self.cfg, 1, self.capacity,
                                            device=self.device)
        return self._blank_row


class ServeEngine:
    """Slot-based continuous batching (greedy decode).

    Runs on the card unless ``device`` names another; params are moved
    there, with the embedding and dense kernels cast to the compute dtype
    once (``model.serving_params``).
    """

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 4,
                 capacity: int = 512, eos_id: int | None = None,
                 device=None):
        M.check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.capacity = capacity
        self.device = device
        self.eos_id = cfg.eos_id if eos_id is None else eos_id
        self.params = M.serving_params(tree.to_device(params, device))
        self.caches = M.init_caches(cfg, slots, capacity, device=device)
        self.pos = np.zeros((slots,), np.int32)       # next position per slot
        self.active: list[Request | None] = [None] * slots
        self.queue: collections.deque[Request] = collections.deque()
        self._done_unslotted: list[Request] = []  # finished without a slot
        self._next_rid = 0
        self.fns = EngineFns(cfg, capacity, device)
        # work counters: prefill forwards run and fused decode steps taken
        self.prefill_calls = 0
        self.decode_steps = 0

    @classmethod
    def from_artifact(cls, bank_dir, params0: Any, *,
                      sparsity: float | None = None, compressed: bool = True,
                      slots: int = 4, capacity: int = 512,
                      eos_id: int | None = None,
                      device=None) -> "ServeEngine":
        """Engine over bank-derived sparse weights (no re-calibration)."""
        from repro_torch.sparse.bank import MaskBank
        device = resolve_device(device)
        bank = MaskBank.load(bank_dir, device=device)
        params = bank.sparse_params(tree.to_device(params0, device),
                                    sparsity=sparsity,
                                    compressed=compressed)
        return cls(bank.cfg, params, slots=slots, capacity=capacity,
                   eos_id=eos_id, device=device)

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
        return rid

    @property
    def pending(self) -> bool:
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
        return results

    # -- internals -----------------------------------------------------------

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = req
                self._prefill_slot(s, req)

    def free_slot(self, s: int) -> None:
        """Release slot s for reuse."""
        self.active[s] = None
        self.pos[s] = 0

    def _prefill_bucket(self, n: int) -> int:
        """Padded prompt length: the next power of two (at least 8), capped
        at the ring.  Sound for position-masked attention rings, the only
        cache kind ported."""
        return min(max(8, 1 << (n - 1).bit_length()), self.capacity)

    def _prefill_slot(self, s: int, req: Request) -> None:
        """Prefill all prompt tokens but the last into slot s's cache rows.

        The prompt is padded to its bucket; padding is masked during decode
        (kpos > t) and each junk ring slot is overwritten by a real token
        before it could become visible.
        """
        n = len(req.prompt) - 1  # submit() guarantees 0 <= n < capacity
        if n == 0:
            row = self.fns.blank_row()
        else:
            bucket = self._prefill_bucket(n)
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :n] = req.prompt[:-1]
            row = self.fns.prefill(self.params,
                                   torch.from_numpy(toks).to(self.device))
            self.prefill_calls += 1
        self.fns.write_slot(self.caches, row, s)
        self.pos[s] = n
        req.pending_token = int(req.prompt[-1])

    def _step(self) -> list[Request]:
        toks = np.zeros((self.slots,), np.int32)
        for s, req in enumerate(self.active):
            if req is not None:
                toks[s] = req.pending_token
        logits, self.caches = self.fns.decode(
            self.params, torch.from_numpy(toks).to(self.device), self.caches,
            torch.from_numpy(self.pos.copy()).to(self.device))
        self.decode_steps += 1
        nxt = logits.argmax(dim=-1).cpu().numpy()
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
        return finished
