from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm, lr_at  # noqa: F401
from .compression import compress_grads, decompress_grads  # noqa: F401
