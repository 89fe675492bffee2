from .pipeline import DataConfig, LMDataPipeline  # noqa: F401
