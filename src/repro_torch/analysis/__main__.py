"""One entry point for the port's static analysis.

  python -m repro_torch.analysis lint src/repro_torch chip_smoke.py
  python -m repro_torch.analysis audit --arch llama3.2-1b --device cpu \\
      [--search] [--kv-shards S] [--json out.json]       # op-stream audit
  python -m repro_torch.analysis contracts --device cpu \\
      [--arch a ...] [--update] [--diff-out d.json]       # golden contracts
  python -m repro_torch.analysis zoo --device cpu \\
      [--arch f ...] [--update] [--diff-out d.json]       # whole-zoo dry run
  python -m repro_torch.analysis zoo --cells [--arch f] [--cell c | --all] \\
      [--out build/dryrun]                                # shape cells, meta
  python -m repro_torch.analysis memplan --arch llama3.2-1b --device cpu \\
      [--fit [--full]]                                    # memory planner

Ported: ``lint`` (:mod:`~repro_torch.analysis.lint`), ``audit``
(:mod:`~repro_torch.analysis.audit`, the reference's ``jaxpr_audit``, over
the surfaces of :mod:`~repro_torch.analysis.surfaces`), ``contracts``
(:mod:`~repro_torch.analysis.contracts`, goldens in
``src/repro_torch/analysis/golden/``), ``zoo``
(:mod:`~repro_torch.analysis.zoo`, goldens in ``golden/zoo/``) and
``memplan`` (:mod:`~repro_torch.analysis.memplan`), all on one card or on
the ``meta`` device.  The surfaces are built on the card unless
``--device`` names another (``cpu`` here, where there is none); the audit
and the plans run on ``meta``.  ``hlo`` is not ported (ROADMAP A item 4:
``launch/hlo_analysis.py``'s purpose over the port's profiler traces);
``shardcheck``, ``--devices`` and a ``--mesh`` other than none wait for
tensor parallelism (ROADMAP A item 7) and raise.
"""
from __future__ import annotations

import json
import sys

_USAGE = __doc__


def _no_devices(argv: list[str]) -> None:
    if "--devices" in argv:
        raise SystemExit("--devices forces host devices for a mesh: the "
                         "port's static analysis runs on one card; a mesh "
                         "waits for tensor parallelism (ROADMAP A item 7)")


def _parse_mesh(s: str | None):
    if s in (None, "none", "1dev"):
        return None
    return tuple(int(x) for x in s.split("x"))


def _common(ap) -> None:
    ap.add_argument("--mesh", default=None,
                    help="'none' only: a mesh waits for ROADMAP A item 7")
    ap.add_argument("--device", default=None,
                    help="where the smoke surfaces are built (default: the "
                         "card; 'cpu' without one)")


def _cmd_audit(rest: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.analysis audit")
    ap.add_argument("--arch", default="llama3.2-1b")
    _common(ap)
    ap.add_argument("--search", action="store_true",
                    help="include the calibration search-chunk surface")
    ap.add_argument("--kv-shards", type=int, default=None)
    ap.add_argument("--json", dest="out", default=None)
    a = ap.parse_args(rest)
    from repro_torch.analysis import contracts, surfaces
    mesh = _parse_mesh(a.mesh)
    surfs = surfaces.all_surfaces(a.arch, mesh_shape=mesh,
                                  include_search=a.search, device=a.device,
                                  kv_shards=a.kv_shards)
    man = contracts.build_manifest(a.arch, surfs, mesh_shape=mesh)
    text = json.dumps(man, indent=1, sort_keys=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text)
    viols = contracts.policy_violations(man)
    for v in viols:
        print(f"POLICY {v['surface']}.{v['field']}: got {v['got']!r}, "
              f"allowed {v['allowed']!r}", file=sys.stderr)
    return 1 if viols else 0


def _cmd_contracts(rest: list[str]) -> int:
    import argparse
    from repro_torch.analysis import contracts, surfaces
    ap = argparse.ArgumentParser(prog="repro_torch.analysis contracts")
    ap.add_argument("--arch", action="append", default=None,
                    help="repeatable; default llama3.2-1b")
    _common(ap)
    ap.add_argument("--dir", default=str(contracts.GOLDEN_DIR))
    ap.add_argument("--update", action="store_true",
                    help="regenerate goldens instead of checking")
    ap.add_argument("--diff-out", default=None,
                    help="write the structured diff JSON here on failure")
    a = ap.parse_args(rest)
    mesh = _parse_mesh(a.mesh)
    rc = 0
    all_diffs = []
    for arch in (a.arch or ["llama3.2-1b"]):
        surfs = surfaces.all_surfaces(arch, mesh_shape=mesh,
                                      device=a.device)
        man = contracts.build_manifest(arch, surfs, mesh_shape=mesh)
        path = contracts.manifest_path(a.dir, arch, mesh)
        if a.update:
            contracts.save(path, man)
            print(f"wrote {path}")
            continue
        ok, diffs = contracts.check(path, man)
        if ok:
            print(f"{path}: OK ({len(man['surfaces'])} surfaces, no drift)")
        else:
            rc = 1
            all_diffs.extend(diffs)
            print(f"{path}: CONTRACT DRIFT", file=sys.stderr)
            for d in diffs:
                print(f"  {d['surface']}.{d['field']}: golden="
                      f"{d['golden']!r} current={d['current']!r}",
                      file=sys.stderr)
    if all_diffs and a.diff_out:
        with open(a.diff_out, "w") as f:
            json.dump(all_diffs, f, indent=1)
        print(f"diff written to {a.diff_out}", file=sys.stderr)
    return rc


def cells_parser(prog: str):
    """The shape-cell flags of ``zoo --cells`` and ``launch.dryrun``."""
    import argparse
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--cell", default=None, help="shape cell name")
    ap.add_argument("--all", action="store_true",
                    help="every cell (of --arch, or of every family)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="raises: a multi-pod mesh waits for ROADMAP A "
                         "item 7")
    ap.add_argument("--accum", type=int, default=0,
                    help="gradient-accumulation override (train cells)")
    ap.add_argument("--bf16-cast", action="store_true")
    ap.add_argument("--out", default="build/dryrun",
                    help="one JSON per cell here")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="the card's memory (default 80 GB, an H100)")
    return ap


def _cmd_zoo(rest: list[str]) -> int:
    import argparse
    from repro_torch.analysis import zoo
    if "--cells" in rest:
        rest = [x for x in rest if x != "--cells"]
        a = cells_parser("repro_torch.analysis zoo --cells").parse_args(rest)
        return zoo.run_cells_main(a)
    ap = argparse.ArgumentParser(prog="repro_torch.analysis zoo")
    ap.add_argument("--arch", action="append", default=None,
                    help="repeatable; default all ten families")
    _common(ap)
    ap.add_argument("--dir", default=str(zoo.ZOO_DIR))
    ap.add_argument("--update", action="store_true",
                    help="regenerate goldens instead of checking")
    ap.add_argument("--diff-out", default=None,
                    help="write the structured diff JSON here on failure")
    a = ap.parse_args(rest)
    return zoo.run_zoo(a.arch, mesh_shape=_parse_mesh(a.mesh),
                       zoo_dir=a.dir, update=a.update, diff_out=a.diff_out,
                       device=a.device)


def _cmd_memplan(rest: list[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.analysis memplan")
    ap.add_argument("--arch", default="llama3.2-1b")
    _common(ap)
    ap.add_argument("--fit", action="store_true",
                    help="print the whole-zoo SearchState fit table (smoke "
                         "configs; --full for the published ones) instead "
                         "of one arch's surfaces")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="default: one H100, 80 GB")
    a = ap.parse_args(rest)
    from repro_torch.analysis import memplan, surfaces
    budget = None if a.budget_gb is None else a.budget_gb * 1e9
    surfaces.no_mesh(_parse_mesh(a.mesh))
    if a.fit:
        rows = memplan.fit_table(smoke=not a.full, budget_bytes=budget)
        print(memplan.format_fit_table(rows))
        return 0
    for s in surfaces.serve_surfaces(a.arch, sparse=False, device=a.device):
        plan = memplan.plan_surface(s)
        print(json.dumps(plan.to_dict(), indent=1, sort_keys=True))
    sp = memplan.search_plan(a.arch, smoke=True, budget_bytes=budget)
    print(f"search_state_bytes={sp['state_bytes']}")
    return 0


def _not_ported(cmd: str) -> int:
    item = {"hlo": "4 (launch/hlo_analysis.py's purpose over the port's "
                   "profiler traces)",
            "shardcheck": "7 (tensor parallelism: nothing is partitioned "
                          "on one card)"}[cmd]
    print(f"{cmd}: not ported (ROADMAP A item {item})", file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_USAGE)
        return 0 if argv else 2
    _no_devices(argv)
    cmd, rest = argv[0], argv[1:]
    if cmd == "lint":
        from repro_torch.analysis import lint
        return lint.main(rest)
    if cmd in ("hlo", "shardcheck"):
        return _not_ported(cmd)
    handler = {"audit": _cmd_audit, "contracts": _cmd_contracts,
               "zoo": _cmd_zoo, "memplan": _cmd_memplan}.get(cmd)
    if handler is None:
        print(f"unknown subcommand {cmd!r}\n{_USAGE}", file=sys.stderr)
        return 2
    return handler(rest)


if __name__ == "__main__":
    raise SystemExit(main())
