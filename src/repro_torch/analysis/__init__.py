"""Analysis of the hot paths.  Port of ``repro.analysis`` on one card:

* :mod:`repro_torch.analysis.lint`, the AST linter: the reference's REPRO
  rules in torch terms (host syncs in CUDA-graph bodies, the decode /
  verify steps and the search loop; unfenced clock pairs; silent
  fallbacks; host numpy in a kernel's launch path; zipped tree leaves;
  clobbered environment flags);
* :mod:`repro_torch.analysis.audit`, the reference's ``jaxpr_audit`` over
  the op stream of one call of a surface, recorded by a
  ``TorchDispatchMode`` on the CPU, the card or the ``meta`` device: the
  op histogram, host syncs, collectives per call site, large bf16 -> f32
  upcasts, bytes and dtypes, the arguments updated in place, and the
  hand-written kernel calls per call and per scanned call site;
* :mod:`repro_torch.analysis.surfaces`, the registered surfaces (decode,
  bucketed prefill, the slot write, the spec verifier, the search chunk);
* :mod:`repro_torch.analysis.contracts`, golden manifests per surface in
  ``analysis/golden/``, checked with a structured diff;
* :mod:`repro_torch.analysis.memplan`, a storage-liveness planner over the
  same op stream, each kernel launch's shared memory and workspace, and
  the SearchState fit table for one card;
* :mod:`repro_torch.analysis.zoo`, the whole-zoo dry run (calibrate ->
  bank -> sparsify -> engine decode -> fleet) for all ten families with
  goldens in ``analysis/golden/zoo/``, and the shape cells planned on
  meta (``launch/dryrun.py``);
* :mod:`repro_torch.analysis.recompile`, the recompile sentinel.

``python -m repro_torch.analysis`` is the CLI: ``lint`` / ``audit`` /
``contracts`` / ``zoo`` / ``memplan``.  Not ported: ``hlo`` (ROADMAP A
item 4) and ``shardcheck`` with every mesh variant (item 7).

This module imports neither torch nor numpy; the submodules that need
torch import it themselves, so the linter stays runnable in a bare
interpreter.
"""
