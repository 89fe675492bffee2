"""PolyBench programs lowered as written (the baseline-compiler analogue:
only each computation's innermost legal loop vectorized) through the port,
held against the reference's ``compile_jax(mode="as_written")`` and the
numpy oracle."""
import numpy as np
import pytest
import torch

from repro.core import Schedule as RSchedule
from repro.core import compile_jax
from repro.polybench import BENCHMARKS as R_BENCH
from repro_torch.core import Schedule, compile_torch, execute_numpy
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
def test_as_written_matches_reference(name, variant):
    b = BENCHMARKS[name]
    prog = b.make(variant, "mini")
    inp = random_inputs(prog, seed=5, dtype=np.float64)
    out = compile_torch(prog, Schedule(mode="as_written", use_idioms=False), device="cpu")(inp)
    ref = compile_jax(R_BENCH[name].make(variant, "mini"),
                      RSchedule(mode="as_written", use_idioms=False))(f32(inp))
    check(out, ref, execute_numpy(prog, inp), [b.output])
