"""Sharded training in a 2-rank CPU ``gloo`` world: meshes (1, 2) and a
data-only (2,) for reduced MiniCPM-2B (its tied embedding vocabulary-parallel
and, with an odd vocabulary, feature-parallel with a row-parallel head) and
LLaVA-NeXT's text backbone with patch embeddings; and the input gradient of
a column- then row-parallel FFN on (1, 2), which before sharded training
missed the sum over ``model`` of its column-parallel products' partial input
gradients (Megatron's *f*).  The cases and checks are in
``torch_sharded_train_cases.py``."""
import numpy as np

from torch_sharded_train_cases import *  # noqa: F401,F403

RANKS = 2


def test_ffn_input_gradient_is_the_unsharded_one(world):
    ffn = world["minicpm 1x2"]["ffn"]
    y, dx = ffn["unsharded"]
    np.testing.assert_allclose(ffn["sharded"][0], y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ffn["sharded"][1], dx, rtol=1e-5, atol=1e-5)
    # without f the forward agrees and the input gradient does not
    np.testing.assert_allclose(ffn["without f"][0], y, rtol=1e-5, atol=1e-5)
    err = np.linalg.norm(ffn["without f"][1] - dx) / np.linalg.norm(dx)
    assert err > 0.1, err


def test_plain_forward_queues_a_batch_like_forward():
    """``plain.forward`` one sequence at a time, each MoE layer's queues
    starting after the earlier sequence's assignments (``moe_queued``), is
    the port's ``forward`` on the batch, capacity drops included: the
    yardstick of a data-parallel MoE gradient on the card."""
    import torch

    from repro_torch.models import model as PM
    from repro_torch.models import plain
    from repro_torch.models.convert import params_from_numpy
    from torch_sharded_train_cases import batch_of, config, reference_tree

    cfg = config("mixtral ep 2x2")
    params = params_from_numpy(cfg, reference_tree("mixtral ep 2x2")[1], "cpu")
    tokens = torch.from_numpy(batch_of(cfg)["tokens"][:2])
    s = tokens.shape[1]
    with torch.no_grad():
        want = PM.forward(cfg, params, {"tokens": tokens})
        first: dict = {}
        got = [plain.forward(cfg, params, tokens[0], moe_groups=[(0, s, 2 * s)], stats=first)]
        queued = [torch.bincount(e.reshape(-1), minlength=cfg.n_experts)
                  for e in first["experts"]]
        got.append(plain.forward(cfg, params, tokens[1], moe_groups=[(0, s, 2 * s)],
                                 moe_queued=queued))
    np.testing.assert_allclose(torch.stack(got).numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    # the queue matters: the second sequence alone in a group of 2S keeps more
    alone = plain.forward(cfg, params, tokens[1], moe_groups=[(0, s, 2 * s)])
    assert not np.allclose(alone.detach().numpy(), want[1].numpy(), rtol=1e-4, atol=1e-4)
