"""One entry point for the port's static analysis.

  python -m repro_torch.analysis lint src/repro_torch chip_smoke.py

``lint`` is :mod:`repro_torch.analysis.lint` (REPRO001-004, 006, 007;
``--list-rules``, ``--rules``); it exits 1 when it finds anything.  The
reference's other subcommands (``audit``, ``contracts``, ``hlo``,
``zoo``, ``memplan``, ``shardcheck``) are not ported yet (ROADMAP A
item 8).
"""
from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "lint":
        from repro_torch.analysis import lint
        return lint.main(rest)
    print(f"unknown subcommand {cmd!r}\n{__doc__}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
