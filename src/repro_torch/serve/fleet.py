"""Multi-budget sparsity fleet: ONE mask bank, N budgets, one router.

Port of ``repro.serve.fleet``.  UniPruning's headline property (paper
§4.3) is that a single calibration yields masks for any sparsity level in
one shot.  The fleet is where that property reaches serving: one
``MaskBank`` artifact materializes N budget variants (dense passthrough,
unstructured masked-dense, N:M compressed) behind a single router.

Construction cost is amortized three ways:

* the bank is thresholded once per budget (``MaskBank.masks_at`` memoizes
  per (sparsity, nm) key);
* ``params0`` is moved to the device and cast to the compute dtype once
  (``model.serving_params``) before any budget is materialized, and dense
  leaves that pruning leaves untouched (embeddings, norms) pass through
  ``sparse_params`` and the engines by object identity, so N members share
  ONE copy (``sparse.apply.shared_leaves`` counts the invariant);
* all members share one :class:`~repro_torch.serve.engine.EngineFns`, and
  with it one memory pool for their CUDA graphs.

Routing: ``submit(prompt, budget=...)`` pins a request to one member;
``submit(prompt, ab=...)`` splits traffic across members by weight
(deterministic weighted fair scheduling, no RNG) and mirrors each
off-reference request onto the densest member so the router accumulates
per-budget token agreement beside tokens/s; ``submit(prompt, spec=True)``
routes through the self-speculative decoder (``serve.spec``), whose output
is the verifier's own greedy stream.  ``report()`` returns the live
quality/latency table; ``agreement_matrix`` serves a prompt set through
every member for the full NxN comparison.

The slot pool is partitioned across members at construction: ``slots``
total decode slots spread over the members (every member gets at least
one).

With the flight recorder on (``repro_torch.obs``) the fleet records the
reference's series: ``fleet.requests`` and ``fleet.queue_depth`` by
budget (``spec:<draft>><verify>`` for spec traffic),
``fleet.mirrored_picks``, the ``fleet.mirror_agreement`` histogram, a
``fleet.run_member`` / ``fleet.run_spec`` span per drain, and each
member's own ``serve.*`` series under its ``budget`` label, from which
``report()`` takes its decode-latency percentiles.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterable, Mapping

import numpy as np

from repro_torch import obs, tree
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import EngineFns, ServeEngine
from repro_torch.serve.spec import SpecConfig, SpecDecoder, parse_spec

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Budget:
    """One fleet member's sparsity target.

    kind: ``dense`` (serve params0 untouched), ``unstructured`` (global
    budget, masked-dense serving) or ``nm`` ((n, m) semi-structured,
    2:4-compressed kernels when the pattern is 2:4).
    """
    kind: str
    sparsity: float = 0.0
    nm: tuple[int, int] | None = None

    @property
    def name(self) -> str:
        if self.kind == "nm":
            return f"{self.nm[0]}:{self.nm[1]}"
        return "0.0" if self.kind == "dense" else f"{self.sparsity:g}"

    @property
    def pruned_frac(self) -> float:
        """Fraction of prunable weights removed (density ordering key)."""
        if self.kind == "dense":
            return 0.0
        if self.kind == "nm":
            return 1.0 - self.nm[0] / self.nm[1]
        return self.sparsity


def parse_budget(spec) -> Budget:
    """``"2:4"`` / ``(2, 4)`` -> N:M; ``"0.5"`` / ``0.5`` -> unstructured;
    ``"0.0"`` / ``0`` / ``"dense"`` -> dense passthrough."""
    if isinstance(spec, Budget):
        return spec
    if isinstance(spec, tuple):
        n, m = spec
        return Budget("nm", nm=(int(n), int(m)))
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        s = float(spec)
    else:
        text = str(spec).strip().lower()
        if text == "dense":
            return Budget("dense")
        if ":" in text:
            n, m = text.split(":")
            return Budget("nm", nm=(int(n), int(m)))
        s = float(text)
    if not 0.0 <= s < 1.0:
        raise ValueError(f"sparsity budget must be in [0, 1), got {s}")
    return Budget("dense") if s == 0.0 else Budget("unstructured", sparsity=s)


def token_agreement(a: list, b: list) -> float:
    """Positionwise match fraction over the longer stream (a length
    mismatch, e.g. one side hit eos earlier, counts as disagreement)."""
    n = max(len(a), len(b))
    if n == 0:
        return 1.0
    return sum(x == y for x, y in zip(a, b)) / n


def _partition_slots(slots: int, n: int) -> list[int]:
    """Spread ``slots`` across ``n`` members, earlier members first."""
    base, rem = divmod(slots, n)
    return [base + (i < rem) for i in range(n)]


class SparsityFleet:
    """N sparsity budgets from one mask bank behind a single router.

    Runs on the card unless ``device`` names another (the bank must live
    there).  ``kv_shards`` picks every member's decode attention path.
    ``rules``: every member serves tensor-parallel over the rules' mesh
    (``serve.engine``), as the reference's ``SparsityFleet(rules=)``; the
    members' shared leaves are placed once.
    """

    def __init__(self, bank, params0: PyTree, budgets: Iterable, *,
                 slots: int | None = None, capacity: int = 512,
                 decode_mode: str = "fused", eos_id: int | None = None,
                 idx_bits: int = 2, spec: Any = None, device=None,
                 kv_shards: int | None = None, rules: Any = None):
        device = resolve_device(device)
        self.bank = bank
        self.cfg = bank.cfg
        budgets = [parse_budget(b) for b in budgets]
        self._order = [b.name for b in budgets]
        if len(set(self._order)) != len(self._order):
            raise ValueError(f"duplicate budgets in fleet: {self._order}")
        self.budgets = {b.name: b for b in budgets}
        slots = 2 * len(budgets) if slots is None else slots
        if slots < len(budgets):
            raise ValueError(
                f"{slots} slots cannot cover {len(budgets)} budgets "
                "(every member needs at least one)")
        # agreement is a fraction: default ms-scale histogram edges would
        # lump everything under the first bucket
        obs.declare_hist("fleet.mirror_agreement",
                         tuple(i / 10 for i in range(1, 11)))
        # one device copy of params0 in the compute dtype, before any budget
        # is materialized: the members share its untouched leaves
        self.params0 = M.serving_params(tree.to_device(params0, device))
        self.fns = EngineFns(self.cfg, capacity, device, kv_shards,
                             decode_mode, rules=rules)
        self.engines: dict[str, ServeEngine] = {}
        self.reports: dict[str, dict] = {}
        for b, s in zip(budgets, _partition_slots(slots, len(budgets))):
            params, report = self._materialize(b, idx_bits)
            self.engines[b.name] = ServeEngine(
                self.cfg, params, slots=s, capacity=capacity,
                decode_mode=decode_mode, eos_id=eos_id, device=device,
                kv_shards=kv_shards, fns=self.fns,
                labels={"budget": b.name}, rules=rules)
            self.reports[b.name] = report
        # densest member = the quality reference A/B agreement is scored
        # against (ties break toward earlier budget order)
        self.reference = min(
            budgets, key=lambda b: (b.pruned_frac,
                                    self._order.index(b.name))).name
        self._routes: dict[int, tuple[str, int]] = {}   # frid -> (name, rid)
        self._shadows: dict[int, int] = {}  # frid -> reference engine rid
        self._next_rid = 0
        self._ab_served: dict[str, int] = {n: 0 for n in self._order}
        # per-member counters; "shadow" keeps A/B mirror traffic out of the
        # headline tokens/seconds, "spec_phase_tokens" counts foreign
        # tokens spec rounds advanced
        self._stats = {n: {"requests": 0, "tokens": 0, "seconds": 0.0,
                           "mirrored_picks": 0, "spec_phase_tokens": 0,
                           "agree_sum": 0.0, "agree_n": 0,
                           "shadow": {"requests": 0, "tokens": 0,
                                      "seconds": 0.0}}
                       for n in self._order}
        # the speculative decoder is built on the first spec-routed submit
        self.spec_config = parse_spec(spec) if spec is not None else None
        self._spec: SpecDecoder | None = None
        self._spec_names: tuple[str, str] | None = None
        self._spec_routes: dict[int, int] = {}  # frid -> spec decoder rid

    @classmethod
    def from_artifact(cls, bank_dir, params0: PyTree, budgets: Iterable,
                      *, device=None, **kw) -> "SparsityFleet":
        """One artifact -> N budget engines (no re-calibration)."""
        from repro_torch.sparse.bank import MaskBank
        device = resolve_device(device)
        return cls(MaskBank.load(bank_dir, device=device), params0, budgets,
                   device=device, **kw)

    # -- per-budget weights --------------------------------------------------

    def _materialize(self, b: Budget, idx_bits: int) -> tuple[PyTree, dict]:
        """Budget -> (params tree, byte report).  The threshold pass over
        the calibration state is memoized in the bank (``masks_at``)."""
        from repro_torch.sparse import apply as apply_mod
        params0 = self.params0
        if b.kind == "dense":
            return params0, {"weight_bytes_ratio": 1.0,
                             "compressed_kernels": 0, "fallback_leaves": 0,
                             "shared_dense_leaves": len(tree.leaves(params0))}
        params, masks = self.bank.sparse_params(
            params0, sparsity=b.sparsity if b.kind == "unstructured" else None,
            nm=b.nm, compressed=b.kind == "nm", idx_bits=idx_bits,
            with_masks=True)
        rep = apply_mod.compressed_report(params, masks)
        return params, {
            "weight_bytes_ratio": rep["ratio"],
            "compressed_kernels": len(rep["layers"]) - rep["fallback_leaves"],
            "fallback_leaves": rep["fallback_leaves"],
            "shared_dense_leaves": apply_mod.shared_leaves(params0, params)}

    # -- routing -------------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_tokens: int = 16, *,
               budget=None, ab=None, spec=None) -> int:
        """Route one request; exactly one of ``budget=``/``ab=``/``spec=``.

        budget: a member (any ``parse_budget`` spelling), pinned routing.
        ab: True (uniform split) or a {budget: weight} mapping: the fleet
        picks the member deterministically (the smallest served/weight
        ratio) and, when the pick is not the densest member, mirrors the
        request onto the reference engine so ``report()`` accumulates
        token agreement for the pick.
        spec: True routes through the fleet's speculative decoder; a
        :class:`SpecConfig` or a ``draft:2:4,verify:0.0,k:4`` string
        configures it on first use instead of the fleet's ``spec=``.
        """
        if (budget is not None) + (ab is not None) + (spec is not None) != 1:
            raise ValueError("pass exactly one of budget=, ab= or spec=")
        if spec is not None:
            sd = self._spec_decoder(None if spec is True else spec)
            frid = self._next_rid
            self._next_rid += 1
            self._spec_routes[frid] = sd.submit(prompt, max_tokens)
            if obs.enabled():
                d, v = self._spec_names
                obs.inc("fleet.requests", budget=f"spec:{d}>{v}")
            return frid
        if budget is not None:
            name = parse_budget(budget).name
            if name not in self.engines:
                raise KeyError(
                    f"budget {name!r} not in fleet {self._order}")
        else:
            name = self._pick_ab(ab)
        frid = self._next_rid
        self._next_rid += 1
        erid = self.engines[name].submit(prompt, max_tokens)
        self._routes[frid] = (name, erid)
        self._stats[name]["requests"] += 1
        if obs.enabled():
            obs.inc("fleet.requests", budget=name)
            obs.set_gauge("fleet.queue_depth",
                          len(self.engines[name].queue), budget=name)
        if ab is not None and name != self.reference:
            # shadow for live agreement: the same prompt through the
            # densest member, consumed by the stats only
            self._shadows[frid] = self.engines[self.reference].submit(
                prompt, max_tokens)
            self._stats[name]["mirrored_picks"] += 1
            obs.inc("fleet.mirrored_picks", budget=name)
        return frid

    def _pick_ab(self, ab) -> str:
        if ab is True:
            weights = {n: 1.0 for n in self._order}
        elif isinstance(ab, Mapping):
            weights = {parse_budget(k).name: float(v) for k, v in ab.items()}
        else:
            raise TypeError(f"ab= takes True or a mapping, got {type(ab)}")
        unknown = set(weights) - set(self.engines)
        if unknown:
            raise KeyError(f"ab budgets {sorted(unknown)} not in fleet "
                           f"{self._order}")
        if not weights or min(weights.values()) <= 0:
            raise ValueError(f"ab weights must be positive: {weights}")
        # deterministic weighted fair pick: lowest (served+1)/weight next
        name = min(weights, key=lambda n: ((self._ab_served[n] + 1)
                                           / weights[n],
                                           self._order.index(n)))
        self._ab_served[name] += 1
        return name

    def _spec_decoder(self, override=None) -> SpecDecoder:
        """The fleet's speculative decoder, built at first use; the
        (draft, verifier) pair is fixed then."""
        if override is not None:
            sc = parse_spec(override)
            if self._spec is not None and sc != self.spec_config:
                raise ValueError(
                    f"fleet speculative decoder already configured as "
                    f"{self.spec_config}; cannot reconfigure to {sc}")
            self.spec_config = sc
        if self._spec is None:
            sc = self.spec_config or SpecConfig()
            dname = parse_budget(sc.draft).name
            vname = (parse_budget(sc.verify).name if sc.verify is not None
                     else self.reference)
            for nm in (dname, vname):
                if nm not in self.engines:
                    raise KeyError(
                        f"spec member {nm!r} not in fleet {self._order}")
            if dname == vname:
                raise ValueError(
                    f"spec draft and verifier are both {dname!r}; pick a "
                    "sparser draft than the verifier")
            # seed adaptive k from the drafting member's live A/B agreement
            # with the reference, when any has accumulated
            st = self._stats[dname]
            init = (st["agree_sum"] / st["agree_n"] if st["agree_n"]
                    and vname == self.reference else None)
            self._spec = SpecDecoder(
                self.engines[dname], self.engines[vname], k=sc.k,
                k_min=sc.k_min, k_max=sc.k_max, adaptive=sc.adaptive,
                ema=sc.ema, ema_hi=sc.ema_hi, ema_lo=sc.ema_lo,
                init_accept=init, labels={"draft": dname, "verify": vname})
            self._spec_names = (dname, vname)
        return self._spec

    def run(self) -> dict[int, list[int]]:
        """Drive every member to completion; returns fleet rid -> tokens.

        Spec-routed traffic runs first: the speculative decoder interleaves
        the draft and verifier members round by round, and foreign requests
        it finished merge into the member results.  Per-member wall time
        and token counts accumulate into ``report()``; A/B shadow outputs
        feed the agreement stats only, and their tokens and seconds
        accumulate under the member's ``shadow`` key.
        """
        per_engine: dict[str, dict[int, list[int]]] = {}
        merged: dict[int, list[int]] = {}
        if self._spec is not None and self._spec.pending:
            dname, vname = self._spec_names
            with obs.span("fleet.run_spec", draft=dname, verify=vname):
                t0 = time.perf_counter()
                spec_res, spec_foreign = self._spec.run()
                dt = time.perf_counter() - t0
            self._spec.stats["seconds"] += dt
            for kind, nm in (("draft", dname), ("verify", vname)):
                fin = spec_foreign[kind]
                if fin:
                    per_engine.setdefault(nm, {}).update(fin)
                    self._stats[nm]["spec_phase_tokens"] += sum(
                        len(v) for v in fin.values())
            for frid, srid in list(self._spec_routes.items()):
                if srid in spec_res:
                    merged[frid] = spec_res[srid]
                    del self._spec_routes[frid]
        shadow_rids = set(self._shadows.values())
        for name, eng in self.engines.items():
            if not eng.pending:
                continue
            with obs.span("fleet.run_member", budget=name):
                t0 = time.perf_counter()
                res = eng.run()
                dt = time.perf_counter() - t0
            per_engine.setdefault(name, {}).update(res)
            st = self._stats[name]
            total = sum(len(v) for v in res.values())
            sh_toks = (sum(len(v) for rid, v in res.items()
                           if rid in shadow_rids)
                       if name == self.reference else 0)
            # shadow work rode the same batched steps as real traffic, so
            # its share of the member's wall time is prorated by tokens
            sh_dt = dt * sh_toks / total if total else 0.0
            st["seconds"] += dt - sh_dt
            st["tokens"] += total - sh_toks
            if sh_toks:
                st["shadow"]["tokens"] += sh_toks
                st["shadow"]["seconds"] += sh_dt
                st["shadow"]["requests"] += sum(
                    1 for rid in res if rid in shadow_rids)
            if obs.enabled():
                obs.set_gauge("fleet.queue_depth", len(eng.queue),
                              budget=name)
        for frid, (name, erid) in list(self._routes.items()):
            res = per_engine.get(name, {})
            if erid not in res:
                continue
            merged[frid] = res[erid]
            del self._routes[frid]
            shadow = self._shadows.pop(frid, None)
            if shadow is not None:
                st = self._stats[name]
                agree = token_agreement(merged[frid],
                                        per_engine[self.reference][shadow])
                st["agree_sum"] += agree
                st["agree_n"] += 1
                obs.observe("fleet.mirror_agreement", agree, budget=name)
        return merged

    # -- live quality/latency ------------------------------------------------

    def report(self) -> dict:
        """Per-budget serving table: slots, traffic, tok/s, compressed
        ratio, A/B token agreement vs the densest member, with the
        reference's keys.  Every number is lifetime-scoped: ``cumulative``
        holds the monotonic counters and the top-level ``tok_s`` and
        agreement are averages over exactly those.  ``decode_ms_p50`` /
        ``decode_ms_p95``: with the flight recorder on, bucket-estimated
        percentiles over every decode step the member served
        (``serve.decode_step_ms`` under its budget label); None with it
        off."""
        budgets = {}
        for name in self._order:
            st = self._stats[name]
            budgets[name] = {
                "slots": self.engines[name].slots,
                "requests": st["requests"],
                "tokens": st["tokens"],
                "tok_s": (st["tokens"] / st["seconds"]
                          if st["seconds"] else None),
                "token_agreement_vs_reference": (
                    st["agree_sum"] / st["agree_n"] if st["agree_n"]
                    else None),
                "cumulative": {
                    "tokens": st["tokens"],
                    "requests": st["requests"],
                    "mirrored_picks": st["mirrored_picks"],
                    "seconds": st["seconds"],
                    "spec_phase_tokens": st["spec_phase_tokens"],
                },
                "shadow": dict(st["shadow"]),
                "decode_ms_p50": obs.percentile("serve.decode_step_ms", 50,
                                                budget=name),
                "decode_ms_p95": obs.percentile("serve.decode_step_ms", 95,
                                                budget=name),
                **self.reports[name],
            }
        return {"reference": self.reference, "budgets": budgets,
                "spec": (self._spec.summary() if self._spec is not None
                         else None)}

    def agreement_matrix(self, prompts: list, max_tokens: int = 8
                         ) -> tuple[dict, dict]:
        """Serve every prompt through every member (live traffic, counted
        in ``report()``); returns (NxN mean token agreement, per-member
        outputs)."""
        rids = {name: [self.submit(p, max_tokens, budget=name)
                       for p in prompts] for name in self._order}
        res = self.run()
        outs = {name: [res[r] for r in rids[name]] for name in self._order}
        matrix = {
            a: {b: float(np.mean([token_agreement(x, y) for x, y
                                  in zip(outs[a], outs[b])]))
                for b in self._order}
            for a in self._order}
        return matrix, outs
