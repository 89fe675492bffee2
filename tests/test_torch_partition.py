"""The port's partition planner (``repro_torch.core.partition``) against the
reference's, with no world: the reference's planner units on the port's
copy, whole-program plans equal to ``repro.core.partition`` for every
PolyBench variant at mini size and CLOUDSC's three programs at 1-8 shards,
the recipe's ``parallelize`` knob and the mesh in ``Daisy``'s cache key.
The sharded runs are in ``test_torch_partition_world.py``."""
import random

import numpy as np
import pytest
import torch

from repro.cloudsc import erosion as r_erosion
from repro.cloudsc import scheme as r_scheme
from repro.core.fusion import optimization_pipeline as r_pipeline
from repro.core.partition import plan_program_partition as r_plan
from repro.polybench.suite import BENCHMARKS as R_BENCHMARKS
from repro_torch.cloudsc import erosion as p_erosion
from repro_torch.cloudsc import scheme as p_scheme
from repro_torch.core import Daisy, Schedule, compile_sharded, execute_numpy
from repro_torch.core.fusion import optimization_pipeline as p_pipeline
from repro_torch.core.ir import Array, Computation, Loop, Program, acc, aff
from repro_torch.core.partition import _candidate, local_program, plan_program_partition
from repro_torch.core.recipes import Recipe
from repro_torch.core.scheduler import random_inputs
from repro_torch.core.search import _mutate, schedule_from_recipe
from repro_torch.launch.mesh import make_mesh
from repro_torch.polybench import BENCHMARKS as P_BENCHMARKS
from repro_torch.polybench import NAMES

torch.set_num_threads(1)

SCHED = Schedule(mode="canonical", use_idioms=False, shard_axis="data")
SHARDS = (1, 2, 3, 4, 8)
CLOUDSC = ("erosion_program", "mini_cloudsc_program", "saturation_chain_program")
PROGRAMS = [f"{n}/{v}" for n in NAMES for v in ("a", "b", "np")] + list(CLOUDSC)
NPROMA, KLEV = 20, 6  # 20 columns: padded at 3 and 8 shards


def elementwise(rows=16, cols=8) -> Program:
    c = Computation("ew", acc("B", "i", "j"), (acc("A", "i", "j"),),
                    lambda a: a * 2.0 + 1.0)
    return Program("ew", (Array("A", (rows, cols)), Array("B", (rows, cols))),
                   (Loop("i", rows, body=(Loop("j", cols, body=(c,)),)),))


def reduction(m=8, n=12) -> Program:
    """s[j] += A[i,j] * r[i] in (i, j) order: sharding i must all-reduce s."""
    mac = Computation("mac", acc("s", "j"), (acc("A", "i", "j"), acc("r", "i")),
                      lambda a, r: a * r, accumulate="+")
    return Program("red", (Array("A", (m, n)), Array("r", (m,)),
                           Array("s", (n,))),
                   (Loop("i", m, body=(Loop("j", n, body=(mac,)),)),))


def mesh_of_one():
    return make_mesh((1,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# planner units (the reference's tests/test_partition.py TestPlanner)
# ---------------------------------------------------------------------------
def test_elementwise_shards_outermost():
    plan = plan_program_partition(elementwise(), 4)
    assert plan.nests[0].iterator == "i"
    assert plan.array_dims == {"A": 0, "B": 0}
    assert plan.sharded
    assert plan.spec((16, 8), "A") == ("data", None)


def test_reduction_all_reduces():
    plan = plan_program_partition(reduction(), 4)
    assert plan.nests[0].iterator == "i"
    assert plan.nests[0].reduces == (("s", "+"),)
    assert plan.array_dims == {"A": 0, "r": 0, "s": None}
    assert plan.spec((12,), "s") == (None,)


def test_carried_recurrence_vetoed():
    base = Computation("f0", acc("A", "t"), (acc("X", "t"),),
                       lambda x: x, guards=(aff(("t", -1)),))
    rec = Computation("fl", acc("A", "t"),
                      (acc("A", aff("t", const=-1)), acc("X", "t")),
                      lambda a, x: 0.5 * a + x,
                      guards=(aff("t", const=-1),))
    p = Program("recur", (Array("A", (12,)), Array("X", (12,))),
                (Loop("t", 12, body=(base, rec)),))
    plan = plan_program_partition(p, 4)
    assert not plan.sharded
    assert "carried dependence" in plan.nests[0].reason


def test_column_recurrence_shards_the_parallel_dim():
    st = Computation("st", acc("A", "i", "j"),
                     (acc("A", aff("i", const=-1), "j"),),
                     lambda a: 0.5 * a, guards=(aff("i", const=-1),))
    p = Program("col", (Array("A", (6, 8)),),
                (Loop("i", 6, body=(Loop("j", 8, body=(st,)),)),))
    plan = plan_program_partition(p, 4)
    assert plan.nests[0].iterator == "j"
    assert plan.array_dims == {"A": 1}


def test_offset_access_is_cross_shard_flow():
    c = Computation("sh", acc("B", "i"), (acc("A", aff("i", const=1)),), lambda a: a)
    p = Program("off", (Array("A", (13,)), Array("B", (12,))),
                (Loop("i", 12, body=(c,)),))
    plan = plan_program_partition(p, 4)
    assert not plan.sharded
    assert "cross-shard" in plan.nests[0].reason


def test_guard_on_shard_iterator_vetoes():
    c = Computation("tri", acc("B", "i", "j"), (acc("A", "i", "j"),),
                    lambda a: a, guards=(aff("i", ("j", -1)),))  # j <= i
    p = Program("tri", (Array("A", (8, 8)), Array("B", (8, 8))),
                (Loop("i", 8, body=(Loop("j", 8, body=(c,)),)),))
    plan = plan_program_partition(p, 4)
    assert not plan.sharded
    assert "guard" in plan.nests[0].reason


def test_non_reducible_accumulate_vetoed():
    c = Computation("pr", acc("S"), (acc("r", "i"),), lambda r: r, accumulate="*")
    p = Program("prod", (Array("r", (8,)), Array("S", ())),
                (Loop("i", 8, body=(c,)),), temps=("S",))
    plan = plan_program_partition(p, 4)
    assert not plan.sharded
    assert "all-reducible" in plan.nests[0].reason


def test_padded_reduction_vetoed():
    c = Computation("dot", acc("S"), (acc("r", "i"),), lambda r: r, accumulate="+")
    p = Program("dot", (Array("r", (10,)), Array("S", ())),
                (Loop("i", 10, body=(c,)),), temps=("S",))
    plan = plan_program_partition(p, 4)
    assert not plan.sharded
    assert plan.nests[0].reason == "i: reduction over a padded extent (10 % 4 != 0)"


def test_replication_unlocks_later_nest():
    zs = Computation("zs", acc("s", "k"), (), lambda: 0.0)
    mac = Computation("mac", acc("w", "i"),
                      (acc("A2", "i", "j"), acc("s", "j")),
                      lambda a, s: a * s, accumulate="+")
    p = Program("mv", (Array("s", (10,)), Array("A2", (8, 10)), Array("w", (8,))),
                (Loop("k", 10, body=(zs,)),
                 Loop("i", 8, body=(Loop("j", 10, body=(mac,)),))))
    plan = plan_program_partition(p, 4)
    assert plan.nests[0].iterator is None  # fill replicated after restart
    assert "conflict" in plan.nests[0].reason
    assert plan.nests[1].iterator == "i"
    assert plan.array_dims == {"s": None, "A2": 0, "w": 0}


def test_reduce_target_read_inside_nest_vetoed():
    mac = Computation("mac", acc("T", "j"), (acc("A", "p", "j"),),
                      lambda a: a, accumulate="+")
    use = Computation("use", acc("B", "j"), (acc("T", "j"),), lambda t: 2.0 * t)
    p = Program("partial", (Array("A", (8, 2)), Array("T", (2,)), Array("B", (2,))),
                (Loop("j", 2, body=(Loop("p", 8, body=(mac,)), use)),),
                temps=("T",))
    plan = plan_program_partition(p, 4)
    assert not plan.sharded  # j too small, p must veto
    cand = _candidate(p, p.body[0], "p", 4)
    assert isinstance(cand, str) and "partial sums" in cand
    # the compiled fallback (a mesh of one: compile_torch's own function)
    # stays oracle-identical
    fn, plan1 = compile_sharded(p, SCHED, mesh=mesh_of_one())
    assert not plan1.sharded
    inp = random_inputs(p, seed=3, dtype=np.float64)
    got = fn(inp)["B"].numpy().astype(np.float64)
    ref = execute_numpy(p, inp)["B"]
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4


def test_disabled_nest_stays_replicated():
    plan = plan_program_partition(elementwise(), 4, enabled=[False])
    assert not plan.sharded
    assert "disabled" in plan.nests[0].reason


def test_local_program_pads_and_divides():
    p = elementwise(rows=10, cols=8)
    plan = plan_program_partition(p, 4)
    assert plan.padded_extent(10) == 12
    local = local_program(p, plan)
    assert local.array("A").shape == (3, 8)
    assert local.body[0].stop == 3


def test_small_extent_not_sharded():
    plan = plan_program_partition(elementwise(rows=3, cols=64), 4)
    assert plan.nests[0].iterator == "j"
    assert plan.array_dims == {"A": 1, "B": 1}


def test_describe_mentions_every_nest():
    text = plan_program_partition(reduction(), 4).describe()
    assert "shard i" in text and "all-reduce(s,+)" in text


def test_mesh_of_one_is_a_sound_no_op():
    """A mesh of one needs no process group; the plan is all-replicated with
    reasons and the function is ``compile_torch``'s."""
    fn, plan = compile_sharded(elementwise(), SCHED, mesh=mesh_of_one())
    assert not plan.sharded
    assert plan.nests[0].reason == "sharding disabled for this nest"
    inp = random_inputs(elementwise(), seed=5)
    assert torch.equal(fn(inp)["B"], torch.as_tensor(inp["A"]) * 2.0 + 1.0)


# ---------------------------------------------------------------------------
# whole-program plans against the reference's
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def normalized():
    """Every program normalized once by each package's own pipeline."""
    rp, pp = r_pipeline(fuse=True), p_pipeline(fuse=True)
    out = {}
    for n in NAMES:
        for v in ("a", "b", "np"):
            out[f"{n}/{v}"] = (rp.run(R_BENCHMARKS[n].make(v, "mini")),
                               pp.run(P_BENCHMARKS[n].make(v, "mini")))
    for name in CLOUDSC:
        r_mod = r_erosion if name == "erosion_program" else r_scheme
        p_mod = p_erosion if name == "erosion_program" else p_scheme
        out[name] = (rp.run(getattr(r_mod, name)(NPROMA, KLEV)),
                     pp.run(getattr(p_mod, name)(NPROMA, KLEV)))
    return out


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("name", PROGRAMS)
def test_plan_equals_the_reference(normalized, name, shards):
    ref_prog, prog = normalized[name]
    want = r_plan(ref_prog, shards)
    got = plan_program_partition(prog, shards)
    assert got.array_dims == want.array_dims
    assert ([(n.iterator, n.reduces, n.reason) for n in got.nests]
            == [(n.iterator, n.reduces, n.reason) for n in want.nests])
    assert got.describe() == want.describe()
    assert got.sharded == want.sharded


def test_plans_cover_the_card_phase_cases(normalized):
    """The plans the card's phase runs: every CLOUDSC column nest sharded
    with no collective; bicg and atax one ``+`` all-reduce; gemm shards its
    rows; jacobi-2d stays replicated."""
    mini = plan_program_partition(normalized["mini_cloudsc_program"][1], 2)
    assert all(n.iterator is not None and not n.reduces for n in mini.nests)
    for name in ("bicg/a", "atax/a"):
        plan = plan_program_partition(normalized[name][1], 2)
        assert [r for n in plan.nests for r in n.reduces if r[1] == "+"], name
    assert plan_program_partition(normalized["gemm/a"][1], 2).sharded
    assert not plan_program_partition(normalized["jacobi-2d/a"][1], 2).sharded


# ---------------------------------------------------------------------------
# scheduler plumbing
# ---------------------------------------------------------------------------
def test_recipe_parallelize_threads_into_schedule():
    assert schedule_from_recipe(Recipe(kind="vectorize", parallelize="data")).shard_axis == "data"
    assert schedule_from_recipe(Recipe(kind="vectorize"), shard_axis="data").shard_axis == "data"
    assert schedule_from_recipe(Recipe(kind="vectorize")).shard_axis is None
    # the 'none' sentinel disables sharding even under a scheduler default
    s = schedule_from_recipe(Recipe(kind="vectorize", parallelize="none"), shard_axis="data")
    assert s.shard_axis is None
    for kind in ("einsum", "pallas_gemm", "pallas_nest", "pallas_reduce", "sequential"):
        assert schedule_from_recipe(Recipe(kind=kind), shard_axis="data").shard_axis == "data"


def test_mutation_reaches_parallelize_knob():
    rng = random.Random(0)
    seen = set()
    r = Recipe(kind="vectorize")
    for _ in range(400):
        r2 = _mutate(r, rng)
        seen.add(r2.parallelize)
        if r2.parallelize != r.parallelize:
            r = r2  # walk the cycle: default -> pinned -> off
    assert {"data", "none"} <= seen


def test_mesh_enters_cache_key():
    prog = elementwise()
    d1 = Daisy(backend="torch", device="cpu")
    d2 = Daisy(backend="torch", mesh=mesh_of_one(), cache=d1.cache, db=d1.db)
    fn1, _ = d1.compile(prog)
    fn2, plan2 = d2.compile(prog)
    assert fn1 is not fn2  # mesh/no-mesh must not share a slot
    assert d2.compile(prog)[0] is fn2  # same mesh signature re-hits
    # an equal mesh (another object over the same ranks and device) re-hits
    d3 = Daisy(backend="torch", mesh=mesh_of_one(), cache=d1.cache, db=d1.db)
    assert d3.compile(prog)[0] is fn2
    assert plan2.partition is not None and not plan2.partition.sharded
    assert plan2.normalized
    with pytest.raises(ValueError, match="axis"):
        Daisy(backend="torch", mesh=mesh_of_one(), shard_axis="model")
    with pytest.raises(ValueError, match="mesh"):
        Daisy(backend="torch", mesh=mesh_of_one(), device="meta")
