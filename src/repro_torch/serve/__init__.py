"""Serving layer.  Port of ``repro.serve``.

* ``engine`` - :class:`ServeEngine`, slot-based continuous batching over a
  fixed-slot KV cache (dense or 2:4-compressed weights), with the step
  functions (CUDA graphs on the card) in :class:`EngineFns` so several
  engines can share them.
* ``fleet`` - :class:`SparsityFleet`, N sparsity budgets materialized from
  ONE mask bank and served behind a single router with tagged and A/B
  traffic splitting.
* ``spec`` - :class:`SpecDecoder`, self-speculative decoding across two
  fleet members: the sparse member drafts k tokens per round, the dense
  member verifies them in one teacher-forced pass.
"""
from repro_torch.serve.engine import EngineFns, ServeEngine  # noqa: F401
from repro_torch.serve.fleet import (  # noqa: F401
    Budget, SparsityFleet, parse_budget, token_agreement)
from repro_torch.serve.spec import (  # noqa: F401
    SpecConfig, SpecDecoder, accept_commit, parse_spec)
