from .checkpoint import CheckpointManager  # noqa: F401
from ..fault import Heartbeat, RestartPolicy, StragglerMonitor  # noqa: F401
from .train_loop import Trainer, TrainerConfig, make_train_step  # noqa: F401
