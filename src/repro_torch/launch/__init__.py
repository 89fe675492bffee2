"""Launchers (port of ``repro/launch``): the training CLI
(``python -m repro_torch.launch.train``).  The reference's mesh, sharding,
dry-run and roofline tools come with partitioning (ROADMAP queue 6)."""
