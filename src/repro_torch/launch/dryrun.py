"""Dry-run launcher: thin shim over ``repro_torch.analysis.zoo``.

Port of ``repro.launch.dryrun``.  Every (family x shape cell) at the
family's published config, planned on the ``meta`` device with no weights
made and no FLOPs spent (``zoo.run_cell``): parameter bytes (f32 for
training; bf16 and 2:4 compressed for serving), cache bytes, the AdamW
state of a train cell, the planner's peak for the cell's step, and
whether it all fits one card (80 GB; ``memplan.CARD_BYTES``).  It sets no
environment flags: the reference forces 512 host devices for its mesh, and
``--multi-pod`` (a mesh of pods) raises until tensor parallelism lands
(ROADMAP A item 7).

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --cell train_4k
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --all
  python -m repro_torch.launch.dryrun --all --out build/dryrun

Equivalent: ``python -m repro_torch.analysis zoo --cells ...``.
"""
from __future__ import annotations


def main(argv: list[str] | None = None) -> int:
    from repro_torch.analysis import zoo
    from repro_torch.analysis.__main__ import cells_parser
    args = cells_parser("repro_torch.launch.dryrun").parse_args(argv)
    return zoo.run_cells_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
