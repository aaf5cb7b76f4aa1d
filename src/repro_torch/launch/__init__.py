"""Command-line launchers and meshes (port of ``repro.launch``'s
``serve``, ``train`` and ``mesh``; ``dryrun`` and ``specs`` are
ROADMAP.md queue 1)."""
