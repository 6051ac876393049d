"""Self-speculative fleet decoding: a sparse member drafts, dense verifies.

Port of ``repro.serve.spec``.  UniPruning's one-calibration-many-budgets
property gives the fleet a family of cheap draft models that share every
untouched leaf (embeddings, norms) and the whole KV-cache layout with the
dense reference.  Per round, the draft member proposes k tokens from its
own decode loop (``EngineFns.draft``, one dispatch: one CUDA graph replay
on the card), and the verifier re-derives the greedy continuation over the
same k fed tokens in one teacher-forced pass (``EngineFns.verify``).  The
longest agreeing prefix commits, plus the verifier's own token at the first
disagreement, so every round commits between 1 and k tokens in 2
dispatches, and the output stream is the verifier's own greedy stream
(greedy speculative decoding is lossless).

Accept/rollback is position bookkeeping, never cache surgery.  Both members
write ring rows for all k fed positions; a rejected suffix stays ahead of
the slot's committed position, where ``attention.ring_positions`` masks it
(kpos > t is invisible), until the committed stream reaches each row and
overwrites it.  Two invariants make this safe, both enforced here:

* every layer cache must be a full-capacity position-masked attention ring
  (kinds in :data:`SPEC_SAFE_KINDS`, no sliding window; rejected at
  construction);
* a round never writes a ring row past capacity unless it is the committed
  next position itself: ``k_eff`` shrinks to the capacity headroom,
  bottoming out at 1 = plain decode (which may wrap, like plain decode).

Adaptive k: an EMA of the per-round draft acceptance rate (seedable from
the fleet's live agreement stats) grows k toward ``k_max`` while drafts
keep being accepted and shrinks it toward ``k_min`` when they stop; each
distinct k is its own draft and verify surface (a CUDA graph per engine on
the card, ``EngineFns.capture_counts``).

Mixed traffic: engine slots not owned by a spec route ("foreign": pinned
or A/B fleet requests on the draft or verify member) still advance exactly
one token per round, read from column 0 of the same batched dispatch,
which is the plain fused decode of that slot.

The flight recorder sees the reference's series: ``spec.draft`` /
``spec.verify`` spans and their ``_ms`` histograms per dispatch,
``spec.accept_rate`` and ``spec.accepted_tokens_per_step`` per driven
route, ``spec.rollbacks``, ``spec.tokens_committed``,
``spec.requests_submitted`` / ``_retired``, the ``spec.accept_ema`` and
``spec.k`` gauges, and ``serve.tokens_decoded`` for the foreign slots;
the recompile sentinel notes ``draft_<k>`` and ``verify_<k>``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch import obs
from repro_torch.analysis import recompile
from repro_torch.serve.engine import ServeEngine

__all__ = ["SPEC_SAFE_KINDS", "SpecConfig", "SpecDecoder", "accept_commit",
           "parse_spec"]

# layer kinds whose decode caches are full-capacity position-masked
# attention rings (plain and MLA): junk rows ahead of the committed
# position are invisible until overwritten, so rollback is free.
SPEC_SAFE_KINDS = {"attn", "moe", "mla_dense", "mla_moe"}


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decode knobs (``parse_spec`` builds one from the CLI
    string ``draft:2:4,verify:0.0,k:4``)."""
    draft: str = "2:4"            # drafting member (any parse_budget form)
    verify: str | None = None     # verifying member; None = fleet reference
    k: int = 4                    # draft width (tokens proposed per round)
    k_min: int = 1
    k_max: int = 8
    adaptive: bool = True         # move k with the acceptance-rate EMA
    ema: float = 0.8              # EMA decay toward history
    ema_hi: float = 0.8           # grow k while EMA >= hi
    ema_lo: float = 0.4           # shrink k while EMA < lo


def parse_spec(text) -> SpecConfig:
    """``"draft:2:4,verify:0.0,k:4"`` -> :class:`SpecConfig`.

    Comma-separated ``key:value`` pairs, split on the first colon so budget
    values keep their own (``draft:2:4`` = draft member "2:4").
    """
    if isinstance(text, SpecConfig):
        return text
    kw: dict[str, Any] = {}
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(
                f"spec part {part!r} is not key:value "
                "(expected e.g. draft:2:4,verify:0.0,k:4)")
        key, val = part.split(":", 1)
        key, val = key.strip(), val.strip()
        if key in ("draft", "verify"):
            kw[key] = val
        elif key in ("k", "k_min", "k_max"):
            kw[key] = int(val)
        elif key == "adaptive":
            kw[key] = val.lower() in ("1", "true", "yes", "on")
        elif key in ("ema", "ema_hi", "ema_lo"):
            kw[key] = float(val)
        else:
            raise ValueError(f"unknown spec key {key!r} in {text!r}")
    return SpecConfig(**kw)


def accept_commit(drafts, verified) -> tuple[int, list[int]]:
    """One slot's round outcome: ``(accepted, committed_tokens)``.

    ``drafts[i]`` is the draft's token i+1 ahead of the pending token;
    ``verified[i]`` is the verifier's greedy token after the same fed
    prefix.  The commit is the longest agreeing draft prefix plus the
    verifier's correction at the first disagreement (none on full accept:
    the last draft token was itself verified).
    """
    k = len(verified)
    a = 0
    while a < k and int(drafts[a]) == int(verified[a]):
        a += 1
    toks = [int(t) for t in drafts[:a]]
    if a < k:
        toks.append(int(verified[a]))
    return a, toks


class SpecDecoder:
    """Drive one (draft, verifier) engine pair through speculative rounds.

    Both engines usually come from one ``SparsityFleet`` (shared
    ``EngineFns``, shared cache layout), but any two engines over the same
    config and capacity work, including two over identical params, which
    makes every draft accept.
    """

    def __init__(self, draft: ServeEngine, verify: ServeEngine, *,
                 k: int = 4, k_min: int = 1, k_max: int = 8,
                 adaptive: bool = True, ema: float = 0.8,
                 ema_hi: float = 0.8, ema_lo: float = 0.4,
                 init_accept: float | None = None,
                 labels: dict | None = None):
        if draft is verify:
            raise ValueError(
                "draft and verifier must be distinct engines (one engine "
                "cannot both propose and check its own proposals)")
        if draft.cfg is not verify.cfg and draft.cfg != verify.cfg:
            raise ValueError("draft and verifier must serve one model cfg")
        if draft.capacity != verify.capacity:
            raise ValueError(
                f"draft capacity {draft.capacity} != verifier capacity "
                f"{verify.capacity}: the pair must share one cache layout")
        if draft.eos_id != verify.eos_id:
            raise ValueError(
                f"draft eos_id {draft.eos_id} != verifier eos_id "
                f"{verify.eos_id}: termination must be decided identically")
        cfg = verify.cfg
        bad = sorted(set(cfg.layer_kinds) - SPEC_SAFE_KINDS)
        if bad or cfg.sliding_window:
            why = (f"layer kinds {bad}" if bad
                   else f"sliding_window={cfg.sliding_window}")
            raise ValueError(
                f"speculative decode needs full-capacity position-masked "
                f"attention rings to roll back rejected tokens; {cfg.name} "
                f"has {why} (windowed rings evict live rows on speculative "
                f"writes, recurrent state cannot be rolled back)")
        if not 1 <= k_min <= k <= k_max:
            raise ValueError(
                f"need 1 <= k_min <= k <= k_max, got "
                f"({k_min}, {k}, {k_max})")
        self.draft_eng = draft
        self.verify_eng = verify
        self.k = int(k)
        self.k_min, self.k_max = int(k_min), int(k_max)
        self.adaptive = bool(adaptive)
        self.ema_decay = float(ema)
        self.ema_hi, self.ema_lo = float(ema_hi), float(ema_lo)
        # seed from the fleet's live agreement when available; otherwise
        # start between the two thresholds (no k move until rounds vote)
        self.accept_ema = (float(init_accept) if init_accept is not None
                           else (ema_hi + ema_lo) / 2)
        self.obs_labels = dict(labels or {})
        self._routes: dict[int, tuple[int, int]] = {}  # srid -> (drid, vrid)
        self._done: dict[int, list[int]] = {}          # unslotted completions
        self._next_srid = 0
        self.stats = {"requests": 0, "requests_retired": 0, "rounds": 0,
                      "pair_rounds": 0, "tokens": 0, "draft_positions": 0,
                      "accepted_draft_tokens": 0, "rollbacks": 0,
                      "seconds": 0.0}
        # fraction- and count-scale histograms: the default ms-scale edges
        # would lump every sample under the first bucket
        obs.declare_hist("spec.accept_rate",
                         tuple(i / 10 for i in range(1, 11)))
        obs.declare_hist("spec.accepted_tokens_per_step",
                         tuple(float(i) for i in range(1, self.k_max + 1)))

    # -- client API ----------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_tokens: int = 16) -> int:
        """Queue one request on both members; engine-side validation
        applies unchanged and, because the pair shares capacity, accepts
        or rejects atomically."""
        srid = self._next_srid
        self._next_srid += 1
        drid = self.draft_eng.submit(prompt, max_tokens)
        vrid = self.verify_eng.submit(prompt, max_tokens)
        self.stats["requests"] += 1
        if max_tokens <= 0:
            # both engines finished it without a slot; claim both records
            # now (the verifier's is canonical)
            self._done[srid] = self._pop_unslotted(self.verify_eng, vrid)
            self._pop_unslotted(self.draft_eng, drid)
        else:
            self._routes[srid] = (drid, vrid)
        if obs.enabled():
            obs.inc("spec.requests_submitted", **self.obs_labels)
        return srid

    @property
    def pending(self) -> bool:
        return bool(self._routes or self._done)

    def run(self) -> tuple[dict[int, list[int]], dict[str, dict]]:
        """Drive every spec request to completion.

        Returns ``(results, foreign)``: spec rid -> tokens, and
        ``{"draft": {...}, "verify": {...}}`` engine rid -> tokens for
        non-spec requests that finished while riding the spec rounds.
        """
        results = dict(self._done)
        self._done.clear()
        foreign: dict[str, dict[int, list[int]]] = {"draft": {}, "verify": {}}
        stall = 0
        while self._routes:
            self.draft_eng._admit()
            self.verify_eng._admit()
            if self._round(results, foreign) == 0:
                stall += 1
                if stall > 4 * (len(self._routes) + self.draft_eng.slots
                                + self.verify_eng.slots) + 16:
                    raise RuntimeError(
                        "speculative decode made no progress; "
                        f"routes={sorted(self._routes)}")
            else:
                stall = 0
        return results, foreign

    def summary(self) -> dict:
        """Lifetime spec counters for ``SparsityFleet.report()``."""
        st = self.stats
        return {
            **self.obs_labels,
            "k": self.k,
            "accept_ema": self.accept_ema,
            "requests": st["requests"],
            "requests_retired": st["requests_retired"],
            "rounds": st["rounds"],
            "tokens": st["tokens"],
            "rollbacks": st["rollbacks"],
            "accept_rate": (st["accepted_draft_tokens"]
                            / st["draft_positions"]
                            if st["draft_positions"] else None),
            "accepted_tokens_per_round": (st["tokens"] / st["pair_rounds"]
                                          if st["pair_rounds"] else None),
            "tok_s": (st["tokens"] / st["seconds"]
                      if st["seconds"] else None),
            "seconds": st["seconds"],
        }

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _pop_unslotted(eng: ServeEngine, rid: int) -> list[int]:
        for i, r in enumerate(eng._done_unslotted):
            if r.rid == rid:
                del eng._done_unslotted[i]
                return r.out
        raise KeyError(f"rid {rid} not in unslotted done list")

    def _k_eff(self) -> int:
        """Fed width for this round: k capped to the ring headroom of the
        furthest-along live slot (rows past capacity would wrap the ring
        and evict live rows while still speculative; at 1 only the
        committed next position is written, as plain decode writes)."""
        maxpos = 0
        for eng in (self.draft_eng, self.verify_eng):
            for s, r in enumerate(eng.active):
                if r is not None:
                    maxpos = max(maxpos, int(eng.pos[s]))
        return max(1, min(self.k, self.verify_eng.capacity - maxpos))

    def _dispatch(self, phase: str, eng: ServeEngine, fn, inp: np.ndarray,
                  k_eff: int) -> np.ndarray:
        """One spec dispatch (draft or verify) with the sentinel's note and
        the span's clock; returns the host-side (slots, k) token matrix.
        The surface returns its tokens on the host, the dispatch's own
        synchronisation, so the span needs no fence."""
        if recompile.enabled():
            recompile.note(f"{phase}_{k_eff}",
                           (eng.params, inp, eng.caches, eng.pos))
        sp = obs.span(f"spec.{phase}", k=k_eff, **self.obs_labels)
        with sp:
            out, _ = fn(eng.params, inp, eng.caches, eng.pos)
        if sp.seconds is not None:
            obs.observe(f"spec.{phase}_ms", sp.seconds * 1e3,
                        **self.obs_labels)
        return out

    def _round(self, results: dict, foreign: dict) -> int:
        """One speculative round over both engines; returns tokens
        committed (0 only when nothing could progress)."""
        d_eng, v_eng = self.draft_eng, self.verify_eng
        d_act = {r.rid: s for s, r in enumerate(d_eng.active)
                 if r is not None}
        v_act = {r.rid: s for s, r in enumerate(v_eng.active)
                 if r is not None}
        if not d_act and not v_act:
            return 0
        # a route is driven only once both sides hold a slot (an unpaired
        # side idles: its writes stay ahead of its unadvanced position)
        pairs = [(srid, d_act[dr], v_act[vr])
                 for srid, (dr, vr) in self._routes.items()
                 if dr in d_act and vr in v_act]
        d_spec_rids = {dr for dr, _ in self._routes.values()}
        v_spec_rids = {vr for _, vr in self._routes.values()}
        k_eff = self._k_eff()

        # draft phase: every active draft-member slot feeds its pending
        # token and proposes k_eff continuations in one dispatch
        seed = np.zeros((d_eng.slots,), np.int32)
        for s, r in enumerate(d_eng.active):
            if r is not None:
                seed[s] = r.pending_token
        drafts = self._dispatch("draft", d_eng, d_eng.fns.draft(k_eff), seed,
                                k_eff)

        # verify phase: the verifier teacher-forces the same fed prefix,
        # the pending token then the first k_eff - 1 draft proposals
        vt = np.zeros((v_eng.slots, k_eff), np.int32)
        for s, r in enumerate(v_eng.active):
            if r is not None:
                vt[s, 0] = r.pending_token
        for _, sd, sv in pairs:
            if k_eff > 1:
                vt[sv, 1:] = drafts[sd, :k_eff - 1]
        verified = self._dispatch("verify", v_eng, v_eng.fns.verify(k_eff),
                                  vt, k_eff)

        committed = 0
        accept_sum = 0.0
        st = self.stats
        for srid, sd, sv in pairs:
            a, toks = accept_commit(drafts[sd], verified[sv])
            req_d, req_v = d_eng.active[sd], v_eng.active[sv]
            # request-budget and eos truncation before committing: tokens
            # past either boundary never reach the output or the positions
            m_cap = req_v.max_tokens - len(req_v.out)
            toks = toks[:m_cap]
            hit_eos = v_eng.eos_id is not None and v_eng.eos_id in toks
            if hit_eos:
                toks = toks[:toks.index(v_eng.eos_id) + 1]
            m = len(toks)
            req_v.out.extend(toks)
            req_d.out.extend(toks)
            d_eng.pos[sd] += m
            v_eng.pos[sv] += m
            if m:
                req_d.pending_token = req_v.pending_token = toks[-1]
            committed += m
            accept_sum += a / k_eff
            st["tokens"] += m
            # acceptance is scored over positions that could commit: drafts
            # past the request budget are discarded work, not rejections
            st["draft_positions"] += min(k_eff, m_cap)
            st["accepted_draft_tokens"] += min(a, m)
            if a < k_eff:
                st["rollbacks"] += 1
            if obs.enabled():
                obs.observe("spec.accept_rate", a / k_eff,
                            **self.obs_labels)
                obs.observe("spec.accepted_tokens_per_step", m,
                            **self.obs_labels)
                if a < k_eff:
                    obs.inc("spec.rollbacks", **self.obs_labels)
                obs.inc("spec.tokens_committed", m, **self.obs_labels)
            if hit_eos or len(req_v.out) >= req_v.max_tokens:
                req_d.done = req_v.done = True
                results[srid] = req_v.out
                d_eng.free_slot(sd)
                v_eng.free_slot(sv)
                del self._routes[srid]
                st["requests_retired"] += 1
                if obs.enabled():
                    obs.inc("spec.requests_retired", **self.obs_labels)

        # foreign slots (pinned or A/B member traffic): column 0 of the same
        # dispatch is that slot's plain fused decode; advance one token
        for kind, eng, mat, rids in (("draft", d_eng, drafts, d_spec_rids),
                                     ("verify", v_eng, verified,
                                      v_spec_rids)):
            n_foreign = 0
            for s, req in enumerate(eng.active):
                if req is None or req.rid in rids:
                    continue
                tok = int(mat[s, 0])
                req.out.append(tok)
                req.pending_token = tok
                eng.pos[s] += 1
                committed += 1
                n_foreign += 1
                if ((eng.eos_id is not None and tok == eng.eos_id)
                        or len(req.out) >= req.max_tokens):
                    req.done = True
                    foreign[kind][req.rid] = req.out
                    eng.free_slot(s)
            if n_foreign and obs.enabled():
                obs.inc("serve.tokens_decoded", n_foreign, **eng.obs_labels)

        st["rounds"] += 1
        if pairs:
            st["pair_rounds"] += 1
            rate = accept_sum / len(pairs)
            self.accept_ema = (self.ema_decay * self.accept_ema
                               + (1 - self.ema_decay) * rate)
            if self.adaptive:
                if self.accept_ema >= self.ema_hi and self.k < self.k_max:
                    self.k += 1
                elif self.accept_ema < self.ema_lo and self.k > self.k_min:
                    self.k -= 1
            if obs.enabled():
                obs.set_gauge("spec.accept_ema", self.accept_ema,
                              **self.obs_labels)
                obs.set_gauge("spec.k", self.k, **self.obs_labels)
        return committed
