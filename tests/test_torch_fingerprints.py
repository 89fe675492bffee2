"""The port normalizes every program to the reference's canonical nests:
identical pipeline output and nest fingerprints (the tuning database's keys)."""
import numpy as np
import pytest
import torch

from repro.cloudsc import erosion_program as r_erosion
from repro.cloudsc import mini_cloudsc_program as r_mini
from repro.cloudsc import saturation_chain_program as r_chain
from repro.core import fingerprint as r_fp
from repro.core import optimization_pipeline as r_pipe
from repro.core import program_fingerprint as r_pfp
from repro.core.embedding import embed_nest as r_embed
from repro.polybench import BENCHMARKS as R_BENCH
from repro_torch.cloudsc import erosion_program as p_erosion
from repro_torch.cloudsc import mini_cloudsc_program as p_mini
from repro_torch.cloudsc import saturation_chain_program as p_chain
from repro_torch.core import fingerprint as p_fp
from repro_torch.core import optimization_pipeline as p_pipe
from repro_torch.core import program_fingerprint as p_pfp
from repro_torch.core.embedding import embed_nest as p_embed
from repro_torch.polybench import BENCHMARKS as P_BENCH
from repro_torch.polybench import NAMES

torch.set_num_threads(1)

PROGRAMS = [(f"{n}/{v}", lambda s, n=n, v=v: (R_BENCH if s == "r" else P_BENCH)[n].make(v, "mini"))
            for n in NAMES for v in ("a", "b", "np")]
PROGRAMS += [
    ("erosion", lambda s: (r_erosion if s == "r" else p_erosion)(8, 6)),
    ("mini_scheme", lambda s: (r_mini if s == "r" else p_mini)(8, 6)),
    ("saturation_chain", lambda s: (r_chain if s == "r" else p_chain)(8, 6)),
]


@pytest.mark.parametrize("label,build", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_pipeline_output_and_nest_fingerprints_match(label, build):
    rp, pp = build("r"), build("p")
    assert p_pfp(pp) == r_pfp(rp)  # the source programs already agree
    rn, pn = r_pipe(fuse=True).run(rp), p_pipe(fuse=True).run(pp)
    assert p_pfp(pn) == r_pfp(rn)
    assert p_pfp(pn, content=False) == r_pfp(rn, content=False)
    assert [p_fp(n) for n in pn.body] == [r_fp(n) for n in rn.body]
    for a, b in zip(pn.body, rn.body):
        np.testing.assert_array_equal(p_embed(pn, a), r_embed(rn, b))
