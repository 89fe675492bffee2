"""Launchers (port of ``repro/launch``): the training CLI
(``python -m repro_torch.launch.train``), meshes over a ``torch.distributed``
world (``mesh``), the sharding planner and the model stack's collectives
(``sharding``), the analytic cost model (``analytic``) and the H100
roofline (``roofline``).  The reference's dry-run and hill-climb tools come
with sharded training and the cross-pod collectives (ROADMAP queue 1, item
6, steps 3a-ii and 3b)."""
