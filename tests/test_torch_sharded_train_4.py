"""Sharded training in a 4-rank CPU ``gloo`` world: meshes (2, 2) with block
remat (the recompute under the mesh), (pod 2, data 1, model 2), Qwen at
(1, 4) with q/k/v biases and KV heads that do not divide ``model`` (the
contracting-dim rule), Mixtral under expert and data parallelism with the
biased router (capacity drops, routed over the whole batch as the
reference's pjit routes it), and 3 experts (the TP fallback) under data
parallelism.  The cases and checks are in ``torch_sharded_train_cases.py``."""
from torch_sharded_train_cases import *  # noqa: F401,F403

RANKS = 4
