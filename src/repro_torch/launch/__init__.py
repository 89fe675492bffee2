"""Launchers (port of ``repro/launch``): the training CLI
(``python -m repro_torch.launch.train``), meshes over a ``torch.distributed``
world (``mesh``), the analytic cost model (``analytic``) and the H100
roofline (``roofline``).  The reference's sharding, dry-run and hill-climb
tools come with the model stack's sharding (ROADMAP queue 1, item 6, step 3)."""
