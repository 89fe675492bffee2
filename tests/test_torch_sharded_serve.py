"""The sharded serving path in a 2-rank CPU ``gloo`` world: meshes (1, 2),
a data-only (2,), a tied odd-vocabulary MiniCPM (feature-parallel
embedding, row-parallel head), Mixtral under expert parallelism with
capacity drops and with 3 experts (the experts' F cut over ``model``: the
TP fallback), and LLaVA's text backbone; deadlines, cancellation and
temperature sampling decided alike on every rank.  The cases and checks are
in ``torch_sharded_serve_cases.py``."""
from torch_sharded_serve_cases import *  # noqa: F401,F403
from torch_sharded_serve_cases import check_deadlines_cancel_sampling

RANKS = 2


def test_deadlines_cancel_sampling_decided_alike(world, unsharded):
    check_deadlines_cancel_sampling(world, unsharded)
