"""Distribution layer: logical-axis sharding rules, spec derivation and each
rank's block of a sharded leaf (port of ``repro.dist``), and the launcher
that starts one process a rank (``dist.ranks``)."""
