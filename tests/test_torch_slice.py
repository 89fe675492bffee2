"""The slice end to end on the CPU: kernel recipes seeded into both
databases, the port's ``Daisy(backend="cuda", device="cpu")`` (plain versions
behind every kernel wrapper) against the reference's
``Daisy(backend="pallas_interpret")`` (tests/test_tiling.py:292-314's setup)."""
import numpy as np
import pytest
import torch

from repro.cloudsc import erosion_program as r_erosion
from repro.cloudsc import mini_cloudsc_program as r_mini
from repro.core import Daisy as RDaisy
from repro.core import Recipe as RRecipe
from repro.core import TuningDatabase as RDatabase
from repro.core import fingerprint as r_fp
from repro.core.embedding import embed_nest as r_embed
from repro.core.idioms import classify_nest as r_classify
from repro.core.ir import nest_computations as r_comps
from repro.polybench import BENCHMARKS as R_BENCH
from repro_torch.cloudsc import erosion_program, mini_cloudsc_program, physical_inputs, scheme_inputs
from repro_torch.core import Daisy, Recipe, TuningDatabase, codegen, execute_numpy
from repro_torch.core.scheduler import random_inputs
from repro_torch.kernels import gemm as p_gemm
from repro_torch.kernels import nest_kernel as p_nest
from repro_torch.polybench import BENCHMARKS, NAMES

torch.set_num_threads(1)
RTOL, ATOL = 1e-3, 1e-4
TILE = (8, 16, 16)

PROGRAMS = [(n, lambda pk, n=n: (BENCHMARKS if pk else R_BENCH)[n].make("a", "mini"),
             lambda n=n: random_inputs(BENCHMARKS[n].make("a", "mini"), seed=8, dtype=np.float64),
             [BENCHMARKS[n].output]) for n in NAMES]
PROGRAMS += [
    ("erosion", lambda pk: (erosion_program if pk else r_erosion)(8, 6),
     lambda: physical_inputs(8, 6), ["ZTP1", "ZQSMIX"]),
    ("mini_scheme", lambda pk: (mini_cloudsc_program if pk else r_mini)(8, 6),
     lambda: scheme_inputs(8, 6), ["ZTP1", "ZQSMIX", "ZQL", "ZQI", "TENDQ"]),
]


def kernel_kind(nest) -> str:
    if r_classify(nest).kind == "blas3":
        return "pallas_gemm"
    return "pallas_reduce" if any(c.accumulate for c in r_comps(nest)) else "pallas_nest"


@pytest.mark.parametrize("name,build,inputs,outs", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_daisy_cuda_backend_matches_reference_pallas(name, build, inputs, outs):
    rprog, pprog = build(False), build(True)
    rdb, pdb = RDatabase(), TuningDatabase()
    rd = RDaisy(db=rdb, backend="pallas_interpret")
    pd = Daisy(db=pdb, backend="cuda", device="cpu")
    norm = rd.plan(rprog).program
    kinds = []
    for nest in norm.body:
        kind = kernel_kind(nest)
        tile = None if kind == "pallas_gemm" else TILE
        kinds.append(kind)
        rdb.add(r_fp(nest), r_embed(norm, nest), RRecipe(kind=kind, tile=tile), provenance="test")
        pdb.add(r_fp(nest), r_embed(norm, nest), Recipe(kind=kind, tile=tile), provenance="test")

    plain0, gemm0, routed0 = dict(p_nest.PLAIN), p_gemm.PLAIN["gemm"], dict(codegen.ROUTED)
    fn, plan = pd.compile(pprog)
    rfn, rplan = rd.compile(rprog, jit=False)
    assert [(n.fingerprint, n.recipe.kind, n.source) for n in plan.nests] == \
        [(n.fingerprint, n.recipe.kind, n.source) for n in rplan.nests]
    assert [n.recipe.kind for n in plan.nests] == kinds

    inp = inputs()
    out = fn(inp)
    ref = rfn({k: np.asarray(v, np.float32) for k, v in inp.items()})
    oracle = execute_numpy(pprog, inp)
    for k in outs:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(out[k].numpy(), oracle[k], rtol=RTOL, atol=ATOL, err_msg=k)

    # every kernel recipe went through its kernel wrapper, or was sent to
    # torch by a counted planner/classifier decision
    routed = {r: v - routed0.get(r, 0) for r, v in codegen.ROUTED.items()}
    nest_routed = sum(v for r, v in routed.items() if r.startswith("nest:"))
    gemm_routed = sum(v for r, v in routed.items() if r.startswith("einsum2:"))
    nest_runs = sum(p_nest.PLAIN.values()) - sum(plain0.values())
    assert nest_runs + nest_routed == sum(k != "pallas_gemm" for k in kinds)
    assert p_gemm.PLAIN["gemm"] - gemm0 + gemm_routed >= kinds.count("pallas_gemm")
    if name == "gemm":
        assert p_gemm.PLAIN["gemm"] > gemm0
    if name in ("atax", "correlation", "mini_scheme"):
        assert nest_runs > 0
