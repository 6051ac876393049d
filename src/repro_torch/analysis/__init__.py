"""Analysis of the hot paths.  Port of ``repro.analysis``, so far:

* :mod:`repro_torch.analysis.recompile`, the recompile sentinel:
  per-surface counts of distinct call signatures, the
  ``analysis.recompiles`` obs gauge, and a budget that raises before a
  surface's cache grows past it;
* :mod:`repro_torch.analysis.lint`, the AST linter: the reference's
  REPRO rules in torch terms (host syncs in CUDA-graph bodies, the
  decode / verify steps and the search loop; unfenced clock pairs;
  silent fallbacks; host numpy in a kernel's launch path; zipped tree
  leaves; clobbered environment flags).  ``python -m
  repro_torch.analysis lint PATH ...``.

The audits, the contracts and the dry runs (``jaxpr_audit``,
``contracts``, ``surfaces``, ``zoo``, ``memplan``, ``shardcheck``) are
not ported yet (ROADMAP A item 8).
"""
