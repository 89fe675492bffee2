"""Whole programs through the port's torch backend on the CPU, held against
the reference (``Daisy(backend="xla")`` / ``compile_jax``) and the numpy
oracle, canonical and as written."""
import numpy as np
import pytest
import torch

from repro.cloudsc import erosion_program as r_erosion
from repro.cloudsc import mini_cloudsc_program as r_mini
from repro.cloudsc import saturation_chain_program as r_chain
from repro.core import Daisy as RDaisy
from repro.core import Schedule as RSchedule
from repro.core import codegen as r_codegen
from repro.core import compile_jax
from repro.core import ir as rir
from repro.polybench import BENCHMARKS as R_BENCH
from repro_torch.cloudsc import (erosion_program, mini_cloudsc_program, physical_inputs,
                                 saturation_chain_inputs, saturation_chain_program, scheme_inputs)
from repro_torch.core import Daisy, Schedule, codegen, compile_torch, execute_numpy
from repro_torch.core import ir as pir
from repro_torch.core.scheduler import random_inputs
from repro_torch.polybench import BENCHMARKS, NAMES

torch.set_num_threads(1)
RTOL, ATOL = 1e-3, 1e-4  # tests/test_polybench.py


def f32(inp):
    return {k: np.asarray(v, np.float32) for k, v in inp.items()}


def check(out, ref, oracle, names):
    for k in names:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), oracle[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("variant", ["a", "b", "np"])
@pytest.mark.parametrize("name", NAMES)
def test_daisy_torch_matches_reference(name, variant):
    b = BENCHMARKS[name]
    prog = b.make(variant, "mini")
    inp = random_inputs(prog, seed=3, dtype=np.float64)
    oracle = execute_numpy(prog, inp)
    fn, plan = Daisy(backend="torch", device="cpu").compile(prog)
    rfn, rplan = RDaisy(backend="xla").compile(R_BENCH[name].make(variant, "mini"))
    assert [(n.fingerprint, n.recipe.to_json(), n.source) for n in plan.nests] == \
        [(n.fingerprint, n.recipe.to_json(), n.source) for n in rplan.nests]
    check(fn(inp), rfn(f32(inp)), oracle, [b.output])


CLOUDSC = [
    ("erosion", erosion_program, r_erosion, physical_inputs, ["ZTP1", "ZQSMIX"]),
    ("mini_scheme", mini_cloudsc_program, r_mini, scheme_inputs,
     ["ZTP1", "ZQSMIX", "ZQL", "ZQI", "PFPLSL", "TENDQ"]),
    ("saturation_chain", saturation_chain_program, r_chain, saturation_chain_inputs, ["TEND"]),
]


@pytest.mark.parametrize("mode", ["canonical", "as_written"])
@pytest.mark.parametrize("label,build,rbuild,inputs,outs", CLOUDSC, ids=[c[0] for c in CLOUDSC])
def test_cloudsc_matches_reference(label, build, rbuild, inputs, outs, mode):
    prog = build(8, 6)
    inp = inputs(8, 6)
    oracle = execute_numpy(prog, inp)
    if mode == "canonical":
        out = Daisy(backend="torch", device="cpu").compile(prog)[0](inp)
        ref = RDaisy(backend="xla").compile(rbuild(8, 6))[0](f32(inp))
    else:
        out = compile_torch(prog, Schedule(mode="as_written", use_idioms=False), device="cpu")(inp)
        ref = compile_jax(rbuild(8, 6), RSchedule(mode="as_written", use_idioms=False))(f32(inp))
    check(out, ref, oracle, outs)


def test_inputs_are_not_mutated():
    prog = BENCHMARKS["gemm"].make("a", "mini")
    inp = {k: torch.tensor(v) for k, v in random_inputs(prog, seed=1).items()}
    before = {k: v.clone() for k, v in inp.items()}
    Daisy(backend="torch", device="cpu").compile(prog)[0](inp)
    assert all(torch.equal(inp[k], before[k]) for k in inp)


# ---------------------------------------------------------------------------
# recurrences: the row-view (scan) lowering and the sequential fallback,
# mirroring tests/test_tiling.py's scan cases against compile_jax
# ---------------------------------------------------------------------------
def recurrence(ir, n, rows, lookback):
    reads = [ir.acc("X", "t", "j")] + [ir.acc("F", ir.aff("t", const=-d), "j")
                                        for d in range(1, lookback + 1)]
    expr = ir.Read(0)
    for d in range(1, lookback + 1):
        expr = expr + (0.5 / d) * ir.Read(d)
    comp = ir.Computation("rec", ir.acc("F", "t", "j"), tuple(reads), expr)
    return ir.Program("rec", (ir.Array("X", (n, rows)), ir.Array("F", (n, rows))),
                      (ir.Loop("t", n, body=(ir.Loop("j", rows, body=(comp,)),)),), temps=("F",))


def flux(ir, n, rows):
    pfl = ir.Computation("pfl", ir.acc("F", "t", "j"),
                         (ir.acc("F", ir.aff("t", const=-1), "j"), ir.acc("X", "t", "j")),
                         0.8 * ir.Read(0) + ir.Read(1), guards=(ir.aff("t", const=-1),))
    pfl0 = ir.Computation("pfl0", ir.acc("F", "t", "j"), (ir.acc("X", "t", "j"),),
                          ir.Read(0), guards=(ir.aff(("t", -1)),))
    return ir.Program("flux", (ir.Array("X", (n, rows)), ir.Array("F", (n, rows))),
                      (ir.Loop("t", n, body=(ir.Loop("j", rows, body=(pfl, pfl0)),)),),
                      temps=("F",))


@pytest.mark.parametrize("label,build,scan,path", [
    ("lookback1", lambda ir: recurrence(ir, 7, 5, 1), True, "scan"),
    ("lookback2", lambda ir: recurrence(ir, 7, 5, 2), True, "scan"),
    ("fori", lambda ir: recurrence(ir, 7, 5, 1), False, "fori"),
    ("guarded-first-row", lambda ir: flux(ir, 6, 4), True, "scan"),
])
def test_recurrence_lowerings(label, build, scan, path):
    prog = build(pir)
    inp = random_inputs(prog, seed=5, dtype=np.float64)
    before, rbefore = codegen.LOWERING_STATS[path], r_codegen.LOWERING_STATS[path]
    out = compile_torch(prog, Schedule(use_idioms=False, scan=scan), device="cpu")(inp)
    ref = compile_jax(build(rir), RSchedule(use_idioms=False, scan=scan))(f32(inp))
    assert codegen.LOWERING_STATS[path] == before + 1
    assert r_codegen.LOWERING_STATS[path] == rbefore + 1
    check(out, ref, execute_numpy(prog, inp), ["F"])


def test_out_of_range_indices_follow_jax():
    """JAX clamps out-of-range gathers and drops out-of-range scatters; the
    port's lowering does the same where the planner finds an index can leave
    its array."""
    def build(ir):
        c = ir.Computation("c", ir.acc("B", ir.aff(("i", 2))), (ir.acc("A", ir.aff(("i", 2), const=1)),),
                           ir.Read(0) * 2.0)
        return ir.Program("oob", (ir.Array("A", (7,)), ir.Array("B", (7,))),
                          (ir.Loop("i", 5, body=(c,)),))

    prog = build(pir)
    inp = random_inputs(prog, seed=9, dtype=np.float64)
    stats = dict(codegen.LOWERING_STATS)
    out = compile_torch(prog, Schedule(use_idioms=False), device="cpu")(inp)
    ref = compile_jax(build(rir), RSchedule(use_idioms=False))(f32(inp))
    np.testing.assert_allclose(out["B"].numpy(), np.asarray(ref["B"]), rtol=1e-6)
    assert codegen.LOWERING_STATS["clamped_gathers"] > stats["clamped_gathers"]
    assert codegen.LOWERING_STATS["dropped_scatters"] > stats["dropped_scatters"]


def test_exact_conflict_check_vectorizes_only_independent_points():
    """A perfect single-assignment nest the dependence analysis keeps
    sequential is vectorized only when no point depends on another."""
    def transpose_copy(ir, n):  # correlation's symmetrization: reads upper, writes lower
        c = ir.Computation("sym", ir.acc("C", "j", "i"), (ir.acc("C", "i", "j"),), ir.Read(0),
                           guards=(ir.aff("j", ("i", -1), const=-1),))
        return ir.Program("sym", (ir.Array("C", (n, n)),),
                          (ir.Loop("i", n, body=(ir.Loop("j", n, body=(c,)),)),))

    def shift(ir, n):  # A[i+1] = 2 A[i]: a true chain
        c = ir.Computation("sh", ir.acc("A", ir.aff("i", const=1)), (ir.acc("A", "i"),),
                           ir.Read(0) * 2.0)
        return ir.Program("shift", (ir.Array("A", (n + 1,)),), (ir.Loop("i", n, body=(c,)),))

    for build, sequential in ((lambda ir: transpose_copy(ir, 9), False),
                              (lambda ir: shift(ir, 6), True)):
        prog = build(pir)
        assert codegen._conflict_free(prog, prog.body[0]) is not sequential
        inp = random_inputs(prog, seed=3, dtype=np.float64)
        fori = codegen.LOWERING_STATS["fori"]
        out = compile_torch(prog, Schedule(use_idioms=False, scan=False), device="cpu")(inp)
        ref = compile_jax(build(rir), RSchedule(use_idioms=False, scan=False))(f32(inp))
        assert (codegen.LOWERING_STATS["fori"] > fori) == sequential
        name = prog.arrays[0].name
        check(out, ref, execute_numpy(prog, inp), [name])
