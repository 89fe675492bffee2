"""The sharded serving path in a 4-rank CPU ``gloo`` world: meshes (2, 2),
(pod 2, data 1, model 2), a (1, 4) whose KV heads do not divide ``model``
(the contracting-dim rule, with q/k/v biases), and Mixtral under expert
and data parallelism.  The cases and checks are in
``torch_sharded_serve_cases.py``."""
from torch_sharded_serve_cases import *  # noqa: F401,F403

RANKS = 4
