"""The port's kernels on a card, each against its plain version.

Needs an NVIDIA card and imports nothing of jax, so it runs on a machine
with the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_card.py``.  Without a card every test skips (decided in a
fixture).  The nest-kernel cases are tests/test_tiling.py's edge cases,
built from the port's IR; ``test_torch_kernels.py`` runs the same cases
through the plain versions against the reference on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Schedule
from repro_torch.core import ir as pir
from repro_torch.core.scheduler import random_inputs
from repro_torch.kernels import gemm as p_gemm
from repro_torch.kernels import nest_kernel as p_nest

torch.set_num_threads(1)
MAX_REL = 2e-4  # fp32 kernels (tests/test_kernels.py)


def max_rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / max(1e-30, np.abs(ref).max()))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest -m cuda` on one")
    return torch.device("cuda")


def stencil(ir, n):
    R, acc, aff = ir.Read, ir.acc, ir.aff
    st = ir.Computation(
        "st", acc("B", "i", "j"),
        (acc("A", "i", "j"), acc("A", aff("i", const=-1), "j"), acc("A", aff("i", const=1), "j"),
         acc("A", "i", aff("j", const=-1)), acc("A", "i", aff("j", const=1))),
        R(0) + 0.2 * (R(1) + R(2) + R(3) + R(4)))
    return ir.Program("stencil", (ir.Array("A", (n, n)), ir.Array("B", (n, n))),
                      (ir.Loop("i", n - 1, start=1, body=(ir.Loop("j", n - 1, start=1, body=(st,)),)),))


def triangle(ir, n):
    sc = ir.Computation("sc", ir.acc("C", "i", "j"), (ir.acc("C", "i", "j"),),
                        ir.Read(0) * 3.0, guards=(ir.aff("i", ("j", -1)),))
    return ir.Program("tri", (ir.Array("C", (n, n)),),
                      (ir.Loop("i", n, body=(ir.Loop("j", n, body=(sc,)),)),))


def syrk1(ir, n, m):
    mac = ir.Computation("mac", ir.acc("C", "i", "j"), (ir.acc("A", "i", "k"), ir.acc("A", "j", "k")),
                         ir.Read(0) * ir.Read(1), accumulate="+", guards=(ir.aff("i", ("j", -1)),))
    return ir.Program("syrk1", (ir.Array("A", (n, m)), ir.Array("C", (n, n))),
                      (ir.Loop("i", n, body=(ir.Loop("j", n, body=(ir.Loop("k", m, body=(mac,)),)),)),))


def reduce_op(ir, op, n=10, m=12):
    c = ir.Computation("r", ir.acc("y", "i"), (ir.acc("A", "i", "k"), ir.acc("w", "k")),
                       ir.Read(0) * ir.Read(1) + 0.25, accumulate=op)
    return ir.Program(f"reduce{op}", (ir.Array("A", (n, m)), ir.Array("w", (m,)), ir.Array("y", (n,))),
                      (ir.Loop("i", n, body=(ir.Loop("k", m, body=(c,)),)),))


CASES = (
    [(f"stencil-{t}", lambda ir: stencil(ir, 10), dict(pallas_nest=True, nest_tile=t))
     for t in [(3, 3), (4, 8), (16, 16)]]
    + [("triangle", lambda ir: triangle(ir, 11), dict(pallas_nest=True, nest_tile=(4, 4)))]
    + [(f"guarded-reduction-u{u}", lambda ir: syrk1(ir, 9, 16),
        dict(pallas_reduce=True, nest_tile=(4, 4, 8), unroll=u)) for u in (1, 2, 4)]
    + [(f"reduce{op}", lambda ir, op=op: reduce_op(ir, op),
        dict(pallas_reduce=True, nest_tile=(4, 8), unroll=2)) for op in ("+", "*", "max", "min")]
)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(16, 16, 16), (100, 52, 36), (33, 17, 9), (1000, 1100, 1200)])
def test_gemm_kernel_on_card(card, m, n, k):
    x = torch.randn(m, k, device=card)
    y = torch.randn(k, n, device=card)
    before = p_gemm.LAUNCHES["gemm"]
    got = p_gemm.gemm(x, y)
    torch.cuda.synchronize()
    assert p_gemm.LAUNCHES["gemm"] == before + 1
    assert max_rel(got.cpu().numpy(), p_gemm.gemm_plain(x, y).cpu().numpy()) < MAX_REL


@pytest.mark.cuda
@pytest.mark.parametrize("label,build,knobs", CASES, ids=[c[0] for c in CASES])
def test_nest_kernel_on_card(card, label, build, knobs):
    prog = build(pir)
    inp = random_inputs(prog, seed=4)
    env = {k: torch.tensor(v, device=card) for k, v in inp.items()}
    ref = {k: v.clone() for k, v in env.items()}
    nk = p_nest.plan_nest(prog, prog.body[0], Schedule(use_idioms=False, **knobs))
    before = dict(p_nest.EMITTED)
    p_nest.run_nest(nk, env)
    torch.cuda.synchronize()
    assert p_nest.EMITTED[nk.kind] == before[nk.kind] + 1
    p_nest.nest_plain(nk, ref)
    for name in env:
        assert max_rel(env[name].cpu().numpy(), ref[name].cpu().numpy()) < MAX_REL, name
