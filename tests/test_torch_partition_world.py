"""The port's sharded executor (``repro_torch.core.partition``) in CPU
``gloo`` worlds of 2 and 4 ranks, each spawned once for the module by
``launch.mesh.run_world``.  Every rank runs ``world_cases`` on the same
global inputs; rank 0's outputs come back and are held here against the
unsharded lowering (bit for bit where no nest reduces), the float64 numpy
oracle and the reference's single-device ``compile_jax``.

Module-level imports load neither jax nor ``repro``: every rank imports
this module to find ``world_cases``; the reference is imported in a
fixture of the parent."""
import numpy as np
import pytest
import torch

from repro_torch.cloudsc import column_mesh, compile_scheme, mini_cloudsc_program, scheme_inputs
from repro_torch.core import (COLLECTIVES, Daisy, Recipe, Schedule, TuningDatabase,
                              compile_sharded, compile_torch, execute_numpy, fingerprint,
                              run_sharded)
from repro_torch.core.embedding import embed_nest
from repro_torch.core.fusion import optimization_pipeline
from repro_torch.core.idioms import classify_nest
from repro_torch.core.ir import Array, Computation, Loop, Program, acc
from repro_torch.core.scheduler import random_inputs
from repro_torch.core.tiling import TilingError, plan_nest_tiling
from repro_torch.fault import compile_with_degradation
from repro_torch.launch.mesh import run_world
from repro_torch.polybench import BENCHMARKS

torch.set_num_threads(1)

SCHED = Schedule(mode="canonical", use_idioms=False, shard_axis="data")
RTOL, ATOL = 1e-3, 1e-4  # tests/test_polybench.py
POLYBENCH = ("gemm", "doitgen", "gesummv", "bicg", "atax")
CLOUDSC_OUT = ("PFPLSL", "TENDQ", "ZTP1")


def elementwise(rows, cols) -> Program:
    c = Computation("ew", acc("B", "i", "j"), (acc("A", "i", "j"),),
                    lambda a: a * 2.0 + 1.0)
    return Program("ew", (Array("A", (rows, cols)), Array("B", (rows, cols))),
                   (Loop("i", rows, body=(Loop("j", cols, body=(c,)),)),))


def reduction(op: str, m: int, n: int = 6) -> Program:
    """S[j] op= A[i, j] * r[i]: sharding i all-reduces S with ``op``."""
    mac = Computation("mac", acc("S", "j"), (acc("A", "i", "j"), acc("r", "i")),
                      lambda a, r: a * r, accumulate=op)
    return Program(f"red{op}", (Array("A", (m, n)), Array("r", (m,)), Array("S", (n,))),
                   (Loop("i", m, body=(Loop("j", n, body=(mac,)),)),))


def polybench(name: str, n: int) -> Program:
    sizes = {"gemm": None, "doitgen": dict(nr=2 * n, nq=10, np=12),
             "gesummv": dict(n=8 * n), "bicg": dict(n=8 * n, m=12 * n),
             "atax": dict(m=8 * n, n=12 * n)}[name]
    b = BENCHMARKS[name]
    return b.variants["a"](sizes) if sizes else b.make("a", "mini")


def seed_kernel_recipes(daisy, program) -> None:
    """An exact kernel recipe for every canonical nest the nest planner or
    the BLAS-3 idiom accepts (as chip_smoke.py's phases 4-5 seed them)."""
    norm = daisy.plan(program).program
    for nest in norm.body:
        if classify_nest(nest).kind == "blas3":
            recipe = Recipe(kind="pallas_gemm", vec_budget=1 << 31)
        else:
            try:
                kind = plan_nest_tiling(norm, nest).kind
            except TilingError:
                continue
            recipe = Recipe(kind="pallas_nest" if kind == "parallel" else "pallas_reduce")
        daisy.db.add(fingerprint(nest), embed_nest(norm, nest), recipe, provenance="test")


def _numpy(env, names):
    return {k: env[k].numpy().copy() for k in names}


def world_cases() -> dict:
    """Every case on this rank of the current world; returns the outputs."""
    mesh = column_mesh(device="cpu")
    n = mesh.size("data")
    out: dict = {"n": n}

    def run(label, fn, inputs, names, plan):
        before = {k: dict(v) for k, v in COLLECTIVES.items()}
        env = fn(inputs)
        coll = {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
                for k, v in COLLECTIVES.items()}
        out[label] = dict(out=_numpy(env, names), plan=plan,
                          coll={k: v for k, v in coll.items() if v["calls"]})

    p = elementwise(8 * n, 16)
    fn, plan = compile_sharded(p, SCHED, mesh=mesh)
    run("elementwise", fn, random_inputs(p, seed=5), ["A", "B"], plan)
    out["run_sharded"] = run_sharded(p, random_inputs(p, seed=5), mesh, SCHED)["B"].numpy()
    p = elementwise(3 * n + 1, 8)
    fn, plan = compile_sharded(p, SCHED, mesh=mesh)
    run("padding", fn, random_inputs(p, seed=3, dtype=np.float64), ["B"], plan)
    for op in ("+", "max", "min"):
        p = reduction(op, 4 * n)
        fn, plan = compile_sharded(p, SCHED, mesh=mesh)
        run(f"reduce{op}", fn, random_inputs(p, seed=3, dtype=np.float64), ["S"], plan)
    pipe = optimization_pipeline(fuse=True)
    for name in POLYBENCH:
        p = pipe.run(polybench(name, n))
        fn, plan = compile_sharded(p, SCHED, mesh=mesh)
        inp = random_inputs(p, seed=3, dtype=np.float64)
        run(f"{name}/torch", fn, inp, [BENCHMARKS[name].output], plan)
        d = Daisy(db=TuningDatabase(radius=-1.0), backend="cuda", mesh=mesh)
        seed_kernel_recipes(d, p)
        fn, plan = d.compile(p)
        run(f"{name}/kernels", fn, inp, [BENCHMARKS[name].output], plan.partition)
    fn, plan = compile_scheme(8 * n, 5, mesh=mesh)
    run("cloudsc", fn, scheme_inputs(8 * n, 5), list(CLOUDSC_OUT), plan)
    prog = mini_cloudsc_program(8 * n, 5)
    d = Daisy(db=TuningDatabase(radius=-1.0), backend="cuda", mesh=mesh)
    seed_kernel_recipes(d, prog)
    fn, plan = d.compile(prog)
    run("cloudsc/kernels", fn, scheme_inputs(8 * n, 5), list(CLOUDSC_OUT), plan.partition)
    fn, plan = compile_sharded(elementwise(8 * n, 16), Schedule(shard_axis=None), mesh=mesh)
    out["disabled"] = plan
    p = polybench("gesummv", n)
    res = compile_with_degradation(p, mesh=mesh)
    run("degradation", res.fn, random_inputs(p, seed=3, dtype=np.float64),
        [BENCHMARKS["gesummv"].output], res.plan.partition)
    out["degradation"]["backend"] = res.backend
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request):
    return run_world(request.param, world_cases, threads=1)


@pytest.fixture(scope="module")
def reference():
    from repro.core import Schedule as RSchedule
    from repro.core import compile_jax
    from repro.core.fusion import optimization_pipeline as r_pipeline
    from repro.polybench.suite import BENCHMARKS as R_BENCHMARKS

    return RSchedule, compile_jax, r_pipeline, R_BENCHMARKS


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(1e-9, np.abs(want).max()))


def test_elementwise_bit_identical_to_unsharded(world):
    n = world["n"]
    p = elementwise(8 * n, 16)
    case = world["elementwise"]
    assert case["plan"].sharded and case["plan"].array_dims == {"A": 0, "B": 0}
    want = compile_torch(p, SCHED, device="cpu")(random_inputs(p, seed=5))
    for k in ("A", "B"):
        np.testing.assert_array_equal(case["out"][k], want[k].numpy())
    np.testing.assert_array_equal(world["run_sharded"], want["B"].numpy())
    # B is gathered; A, which no nest writes, is returned without a collective
    assert case["coll"] == {"all_gather": {"calls": 1, "bytes": 8 * 16 * 4}}


def test_padding_matches_oracle(world):
    n = world["n"]
    p = elementwise(3 * n + 1, 8)  # never divides n
    case = world["padding"]
    assert case["plan"].sharded and case["plan"].padded_extent(3 * n + 1) == 4 * n
    inp = random_inputs(p, seed=3, dtype=np.float64)
    assert case["out"]["B"].shape == (3 * n + 1, 8)
    assert _rel(case["out"]["B"], execute_numpy(p, inp)["B"]) < 1e-4


@pytest.mark.parametrize("op", ["+", "max", "min"])
def test_all_reduce_matches_oracle(world, op):
    n = world["n"]
    p = reduction(op, 4 * n)
    case = world[f"reduce{op}"]
    assert case["plan"].nests[0].reduces == (("S", op),)
    want = execute_numpy(p, random_inputs(p, seed=3, dtype=np.float64))["S"]
    assert _rel(case["out"]["S"], want) < 1e-4
    assert case["coll"] == {"all_reduce": {"calls": 1, "bytes": 6 * 4}}


@pytest.mark.parametrize("path", ["torch", "kernels"])
@pytest.mark.parametrize("name", POLYBENCH)
def test_polybench_matches_oracle_and_reference(world, reference, name, path):
    RSchedule, compile_jax, r_pipeline, R_BENCHMARKS = reference
    n = world["n"]
    out = BENCHMARKS[name].output
    case = world[f"{name}/{path}"]
    assert case["plan"].sharded, case["plan"].describe()
    p = optimization_pipeline(fuse=True).run(polybench(name, n))
    inp = random_inputs(p, seed=3, dtype=np.float64)
    got = case["out"][out]
    assert got.shape == p.array(out).shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, execute_numpy(p, inp)[out], rtol=RTOL, atol=ATOL)
    sizes = {"gemm": None, "doitgen": dict(nr=2 * n, nq=10, np=12),
             "gesummv": dict(n=8 * n), "bicg": dict(n=8 * n, m=12 * n),
             "atax": dict(m=8 * n, n=12 * n)}[name]
    rb = R_BENCHMARKS[name]
    rprog = r_pipeline(fuse=True).run(rb.variants["a"](sizes) if sizes else rb.make("a", "mini"))
    rsched = RSchedule(mode="canonical", use_idioms=False)
    want = compile_jax(rprog, rsched)({k: np.asarray(v, np.float32) for k, v in inp.items()})
    np.testing.assert_allclose(got, np.asarray(want[out]), rtol=RTOL, atol=ATOL)
    if name in ("bicg", "atax"):
        assert any(op == "+" for nest in case["plan"].nests for _, op in nest.reduces)
        assert case["coll"]["all_reduce"]["calls"] >= 1


@pytest.mark.parametrize("path", ["cloudsc", "cloudsc/kernels"])
def test_cloudsc_columns_match_oracle(world, path):
    n = world["n"]
    case = world[path]
    assert case["plan"].sharded
    assert all(x.iterator is not None for x in case["plan"].nests)
    assert all(not x.reduces for x in case["plan"].nests)  # zero collectives
    assert "all_reduce" not in case["coll"]
    norm = optimization_pipeline(fuse=True).run(mini_cloudsc_program(8 * n, 5))
    ref = execute_numpy(norm, scheme_inputs(8 * n, 5))
    for k in CLOUDSC_OUT:
        assert _rel(case["out"][k], ref[k]) < 1e-4, k


def test_cloudsc_kernels_equal_unsharded(world):
    """The sharded K2 path bit for bit against the unsharded one (the
    kernels' plain versions here): no nest reduces."""
    n = world["n"]
    prog = mini_cloudsc_program(8 * n, 5)
    d = Daisy(db=TuningDatabase(radius=-1.0), backend="cuda", device="cpu")
    seed_kernel_recipes(d, prog)
    want = d.compile(prog)[0](scheme_inputs(8 * n, 5))
    for k in CLOUDSC_OUT:
        np.testing.assert_array_equal(world["cloudsc/kernels"]["out"][k], want[k].numpy())


def test_shard_axis_none_disables(world):
    assert not world["disabled"].sharded


def test_compile_with_degradation_on_a_mesh(world):
    n = world["n"]
    case = world["degradation"]
    assert case["backend"] == "cuda" and case["plan"].sharded
    p = polybench("gesummv", n)
    out = BENCHMARKS["gesummv"].output
    want = execute_numpy(p, random_inputs(p, seed=3, dtype=np.float64))[out]
    np.testing.assert_allclose(case["out"][out], want, rtol=RTOL, atol=ATOL)


def test_a_failing_rank_fails_the_world():
    with pytest.raises(Exception, match="mesh of shape"):
        run_world(2, column_mesh, (3, "data", "cpu"), threads=1)
