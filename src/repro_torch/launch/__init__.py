"""Command-line launchers (port of ``repro.launch``'s ``serve`` and
``train``; ``dryrun``, ``mesh`` and ``specs`` are ROADMAP.md queue 1,
item 15)."""
