"""Training the ``moe``, ``hybrid``, ``ssm``, ``vlm`` and ``audio`` families:
the port's loss and every gradient against the reference's
``jax.value_and_grad`` of ``repro.train.train_loop.loss_fn`` at reduced size,
in fp32 on the CPU.

Parameters come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; token batches come from the data pipeline and
frontend embeddings from numpy.  Tolerances are tests/test_torch_train.py's:
the loss within 1e-5 relative, each gradient within 1e-4 relative to its
tensor's largest value (fp32; both sides sum in other orders).

The models: reduced Mixtral 8x7B (4 layers, 4 experts, top-2), reduced
Jamba-1.5-Large (one period of 8: attention, Mamba, MoE on every second
layer) under ``remat="none"`` and ``"block"``, reduced xLSTM-350M with the
pattern ``mmmm`` and with ``("m", "s")``, reduced LLaVA-NeXT with patch
embeddings and reduced SeamlessM4T with frames through its encoder.  The
Mamba scan without grad is held bit for bit against the in-place scan it
has always run, and ``remat="block_save_moe"`` against ``"block"``.
"""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_config
from repro.models import model as RM
from repro.train import train_loop as RT
from repro_torch.configs import get_config as p_config
from repro_torch.data import DataConfig, LMDataPipeline
from repro_torch.models import layers as PL
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves, tree_unflatten
from repro_torch.train import train_loop as PT

torch.set_num_threads(1)
GRAD_TOL, LOSS_TOL = 1e-4, 1e-5  # tests/test_torch_train.py
S, B = 16, 2
MIXTRAL, JAMBA, XLSTM = "mixtral-8x7b", "jamba-1.5-large-398b", "xlstm-350m"
VLM, AUDIO = "llava-next-mistral-7b", "seamless-m4t-large-v2"
# (case, arch, config changes)
CASES = {
    "moe": (MIXTRAL, {}),
    "hybrid-none": (JAMBA, {}),
    "hybrid-block": (JAMBA, {"remat": "block"}),
    "ssm-mmmm": (XLSTM, {}),
    "ssm-ms": (XLSTM, {"block_pattern": ("m", "s"), "n_layers": 4}),
    "vlm": (VLM, {}),
    "audio": (AUDIO, {}),
}


@functools.cache
def _reference(arch, **changes):
    rcfg = replace(r_config(arch).reduced(), **changes)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, rparams, jax.tree_util.tree_map(np.asarray, rparams)


def _case(name):
    """(reference config, its parameters, them as numpy, the port's config);
    the reference takes every change but the port's remat."""
    arch, changes = CASES[name]
    rcfg, rparams, np_params = _reference(
        arch, **{k: v for k, v in changes.items() if k != "remat"})
    return rcfg, rparams, np_params, replace(p_config(arch).reduced(), **changes)


def _port_params(pcfg, np_params):
    p = params_from_numpy(pcfg, np_params, "cpu")
    for t in tree_leaves(p):
        t.requires_grad_(True)
    return p


def _batch(cfg, step=1):
    batch = LMDataPipeline(DataConfig(seq_len=S, global_batch=B, vocab=cfg.vocab,
                                      seed=26)).batch_at(step)
    if cfg.frontend is not None:
        rng = np.random.default_rng(260 + step)
        batch["embeds"] = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(
            np.float32)
    return batch


def _stack(blocks):
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def _reference_layout(cfg, tree):
    """The port's tree (per-layer lists) laid out as the reference's: layers
    stacked, or for ``hybrid`` and ``ssm`` stacked per position of a period."""
    out = {}
    for k, v in tree.items():
        if k != "layers" or cfg.family not in ("hybrid", "ssm"):
            out[k] = _stack(v) if isinstance(v, list) else v
            continue
        period = cfg.attn_period if cfg.family == "hybrid" else len(cfg.block_pattern)
        out["periods"] = [_stack(v[pos::period]) for pos in range(period)]
    return out


def _assert_close_scaled(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def _port_loss_and_grads(pcfg, params, batch):
    loss = PT.loss_fn(pcfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss.detach(), torch.autograd.grad(loss, tree_leaves(params))


@functools.cache
def _reference_grads(arch, **changes):
    """The reference's loss and gradients on ``_batch``, jitted."""
    rcfg, rparams, _ = _reference(arch, **changes)
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg).items()}
    return jax.jit(jax.value_and_grad(lambda p: RT.loss_fn(rcfg, p, batch)))(rparams)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_reference(case):
    _, _, np_params, pcfg = _case(case)
    arch, changes = CASES[case]
    batch = _batch(pcfg)
    want_loss, want_grads = _reference_grads(
        arch, **{k: v for k, v in changes.items() if k != "remat"})
    params = _port_params(pcfg, np_params)
    loss, grads = _port_loss_and_grads(pcfg, params, batch)
    assert float(loss) == pytest.approx(float(want_loss), rel=LOSS_TOL)
    got = jax.tree_util.tree_leaves(_reference_layout(pcfg, tree_unflatten(params, list(grads))))
    want = jax.tree_util.tree_leaves(want_grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        _assert_close_scaled(g.numpy(), np.asarray(w), GRAD_TOL, f"{case} leaf {i}")


def _inplace_scan(dt, Bm, Cm, xc, A, h0, chunk):
    """The scan as it ran before it took gradients (the serving path's)."""
    b, s, din = dt.shape
    q = min(chunk, s)
    y = torch.empty((b, s, din), dtype=torch.float32)
    h = h0
    for c0 in range(0, s, q):
        dtc = dt[:, c0:c0 + q, :, None]
        a = torch.exp(dtc * A)
        hs = dtc * Bm[:, c0:c0 + q, None, :] * xc[:, c0:c0 + q, :, None]
        hs[:, 0] += a[:, 0] * h
        step = 1
        while step < q:
            hs[:, step:] = hs[:, step:] + a[:, step:] * hs[:, :-step]
            if 2 * step < q:
                a[:, step:] = a[:, step:] * a[:, :-step]
            step *= 2
        y[:, c0:c0 + q] = torch.einsum("bqdn,bqn->bqd", hs, Cm[:, c0:c0 + q])
        h = hs[:, -1].clone()
    return y, h


def _scan_inputs(seed, b=2, s=96, din=24, n=8):
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa
    dt = torch.nn.functional.softplus(t(b, s, din) - 2)
    return dt, t(b, s, n), t(b, s, n), t(b, s, din), -torch.exp(t(din, n) * 0.3), t(b, din, n)


@pytest.mark.parametrize("chunk", [32, 96])
def test_scan_without_grad_is_the_inplace_scan_bit_for_bit(chunk):
    inputs = _scan_inputs(chunk)
    got = PL._mamba_scan_chunked(*inputs, chunk)
    want = _inplace_scan(*inputs, chunk)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_scan_under_grad_matches_the_sequential_recurrence():
    """Under grad each chunk is checkpointed and computed out of place: the
    values are the in-place scan's bit for bit, and the gradients those of the
    plain per-position recurrence (fp32, another association: 1e-4 of each
    tensor's largest)."""
    inputs = _scan_inputs(7)
    leaves = [t.clone().requires_grad_() for t in inputs]
    y, h = PL._mamba_scan_chunked(*leaves, 32)
    want_y, want_h = _inplace_scan(*inputs, 32)
    assert torch.equal(y.detach(), want_y) and torch.equal(h.detach(), want_h)
    rng = np.random.default_rng(8)
    wy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    wh = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
    grads = torch.autograd.grad((y * wy).sum() + (h * wh).sum(), leaves)

    seq = [t.clone().requires_grad_() for t in inputs]
    dt, Bm, Cm, xc, A, h = seq
    ys = []
    for t in range(dt.shape[1]):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * xc[:, t])[..., None] * Bm[:, t,
                                                                                     None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    want = torch.autograd.grad((torch.stack(ys, 1) * wy).sum() + (h * wh).sum(), seq)
    for i, (g, w) in enumerate(zip(grads, want)):
        _assert_close_scaled(g.numpy(), w.numpy(), GRAD_TOL, i)


def test_block_save_moe_gives_the_block_gradients_bit_for_bit():
    _, _, np_params, pcfg = _case("moe")
    batch = _batch(pcfg, step=3)
    out = []
    for remat in ("block", "block_save_moe"):
        params = _port_params(pcfg, np_params)
        out.append(_port_loss_and_grads(replace(pcfg, remat=remat), params, batch))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_block_save_moe_keeps_the_dispatch_and_the_expert_outputs():
    """What the forward keeps for the backward (the tensors packed for it,
    seen through ``saved_tensors_hooks``; the checkpoints keep their inputs):
    under ``block`` no (E, C, D) tensor, under ``block_save_moe`` each MoE
    layer's dispatch buffer and expert outputs, two distinct (E, C, D)
    tensors a layer."""
    _, _, np_params, pcfg = _case("moe")
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg, step=3).items()}
    e, c = pcfg.n_experts, PL.moe_capacity(pcfg, B * S)
    kept = {}
    for remat in ("block", "block_save_moe"):
        params = _port_params(pcfg, np_params)
        seen = {}

        def pack(t):
            if tuple(t.shape) == (e, c, pcfg.d_model):
                seen[t.data_ptr()] = t
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = PT.loss_fn(replace(pcfg, remat=remat), params, batch)
        torch.autograd.grad(loss, tree_leaves(params))
        kept[remat] = len(seen)
    assert kept == {"block": 0, "block_save_moe": 2 * pcfg.n_layers}


@pytest.mark.parametrize("case", ["moe", "hybrid-none", "ssm-ms"])
def test_plain_forward_gradients_match_the_port(case, monkeypatch):
    """``models/plain.py`` differentiated by autograd, the yardstick of the
    card's gradient gates, against the port's model on one sequence, with
    the port's expert choices given as its routing (fp32; another
    association: the per-position recurrences, the per-expert loop)."""
    from repro_torch.models import plain

    _, _, np_params, pcfg = _case(case)
    raw = _batch(pcfg)
    batch = {k: torch.from_numpy(v[:1]) for k, v in raw.items()}
    routes, real_route = [], PL.moe_route

    def route(x, router, k):
        gates, experts = real_route(x, router, k)
        routes.append(experts)
        return gates, experts

    monkeypatch.setattr(PL, "moe_route", route)
    params = _port_params(pcfg, np_params)
    loss = PT.loss_fn(pcfg, params, batch)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    monkeypatch.setattr(PL, "moe_route", real_route)
    assert len(routes) == sum(map(pcfg.layer_is_moe, range(pcfg.n_layers)))
    pp = _port_params(pcfg, np_params)
    logits = plain.forward(pcfg, pp, batch["tokens"][0], routing=routes or None)
    want_loss = PT.cross_entropy(logits[None], batch["labels"])
    want = torch.autograd.grad(want_loss, tree_leaves(pp))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()), rel=LOSS_TOL)
    for i, (g, w) in enumerate(zip(grads, want)):
        _assert_close_scaled(g.numpy(), w.numpy(), GRAD_TOL, f"{case} leaf {i}")
