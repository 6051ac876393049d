"""Analysis of the hot paths.  Port of ``repro.analysis``, so far its
recompile sentinel (:mod:`repro_torch.analysis.recompile`): per-surface
counts of distinct call signatures, the ``analysis.recompiles`` obs gauge,
and a budget that raises before a surface's cache grows past it.  The
linter, the audits and the dry runs come with the static-analysis slice.
"""
