"""Continuous-batching serving engine of the port (port of ``repro.serve``)."""
from .engine import (  # noqa: F401
    NonFiniteLogits,
    RequestHandle,
    RequestState,
    ServeConfig,
    ServingEngine,
    prefill_buckets,
)
