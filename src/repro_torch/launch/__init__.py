"""Launchers: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and the meta-device dry-run of every
(arch × shape × mesh) cell, ``python -m repro_torch.launch.dryrun``; the
production meshes and the card's roofline constants (``mesh``)."""
