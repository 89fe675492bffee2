"""Compatibility shim, as ``repro/train/fault.py``: the fault-tolerance
scaffolding lives in :mod:`repro_torch.fault`.  Import from there; these
re-exports keep the reference's import path working."""
import warnings

from ..fault import (  # noqa: F401
    Fault,
    FaultInjected,
    FaultPlan,
    Heartbeat,
    RestartPolicy,
    StragglerMonitor,
)

warnings.warn(
    "repro_torch.train.fault is a compatibility shim; import from repro_torch.fault "
    "instead", DeprecationWarning, stacklevel=2)
