"""Command-line launchers, meshes and the dry run (port of
``repro.launch``: ``serve``, ``train``, ``mesh``, ``specs`` and
``dryrun``)."""
