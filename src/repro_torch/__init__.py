"""repro_torch — the PyTorch/CUDA port of ``repro`` (the daisy scheduler).

Laid out module for module like ``repro``; each module names the reference
module it is held against.  Imports torch, numpy and the standard library,
never jax and nothing of ``repro``.
"""
