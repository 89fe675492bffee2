from .suite import BENCHMARKS, NAMES, Benchmark  # noqa: F401
