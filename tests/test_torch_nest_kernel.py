"""K2's generated source and launch decisions, on the CPU: which
computations load the old content of their write array (``needs_old``),
which nests of the main path run flattened, the bodies of each kernel (the
flattened form's unmasked one and its masked last block, the tiled form's
masked one), and the shape and stride parameters
that arrays of one declared shape share, checked at launch.
``test_torch_card.py`` runs the kernels on a card against their plain
versions; ``test_torch_kernels.py`` holds the plain versions against the
reference."""
import ast
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import Daisy, Schedule
from repro_torch.core import ir as pir
from repro_torch.kernels import nest_kernel as p_nest
from test_torch_card import (accumulate, broadcast_update, fill, guarded_forward,
                             guarded_then_accumulated, halo_write, pointwise, triangle)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mini_scheme_nest(ir):
    """The mini CLOUDSC scheme's four-computation nest, planned as the
    main path plans it."""
    from repro_torch.cloudsc import mini_cloudsc_program

    nests = _chip_smoke()._main_nests(p_nest, mini_cloudsc_program(16, 6), "parallel",
                                      device="cpu")
    return max(nests, key=lambda pn: len(pn[1].plan.comps))[1]


def _plan(build, tile=None):
    prog = build(pir)
    return p_nest.plan_nest(prog, prog.body[0], Schedule(use_idioms=False, pallas_nest=True,
                                                         nest_tile=tile))


def _bodies(src: str) -> dict[str, list[ast.stmt]]:
    """The bodies of ``nest_kernel`` by form: ``flat`` (every block but the
    last of the flattened range), ``flat ragged`` (its last block) and
    ``tiled``."""
    fn = next(f for f in ast.parse(src).body if isinstance(f, ast.FunctionDef)
              and f.name == "nest_kernel")
    flat = next((s for s in fn.body if isinstance(s, ast.If) and ast.unparse(s.test) == "FLAT"),
                None)
    if flat is None:
        return {"tiled": fn.body}
    inner = next(s for s in flat.body if isinstance(s, ast.If))
    return {"flat": inner.body, "flat ragged": inner.orelse, "tiled": flat.orelse}


def _stores(body) -> list[ast.Call]:
    return [n for s in body for n in ast.walk(s) if isinstance(n, ast.Call)
            and ast.unparse(n.func) == "tl.store"]


def _loads(body) -> list[ast.Call]:
    return [n for s in body for n in ast.walk(s) if isinstance(n, ast.Call)
            and ast.unparse(n.func) == "tl.load"]


def _base(ptr: ast.expr) -> str:
    return re.match(r"p\d+", ast.unparse(ptr)).group(0)


# (label, kernel, needs_old per computation, loads per body of each write array)
OLD_CASES = [
    ("mini scheme nest", lambda: mini_scheme_nest(pir), [False] * 4,
     {"_cse1": 0, "_cse0": 0, "ZQL": 1, "ZQI": 1}),
    ("fill", lambda: _plan(lambda ir: fill(ir, 9, 13)), [False], {"Z": 0}),
    ("pointwise, own write index read", lambda: _plan(lambda ir: pointwise(ir, 9, 13)),
     [False] * 3, {"T": 0, "B": 1, "C": 0}),
    ("broadcast, own write index read", lambda: _plan(lambda ir: broadcast_update(ir, 9, 13)),
     [False], {"A": 1}),
    ("guard, no later read", lambda: _plan(lambda ir: triangle(ir, 11), (4, 4)), [False],
     {"C": 1}),
    ("halo write, later slab read", lambda: _plan(lambda ir: halo_write(ir, 9, 13), (4, 8)),
     [False, False], {"B": 0, "C": 0}),
    ("accumulate", lambda: _plan(lambda ir: accumulate(ir, 9, 13)), [True], {"C": 1}),
    ("guarded accumulate", lambda: _plan(lambda ir: accumulate(ir, 9, 13, True), (4, 8)), [True],
     {"C": 1}),
    ("guard, later slab read", lambda: _plan(lambda ir: guarded_forward(ir, 9, 13), (4, 8)),
     [True, False], {"B": 1, "C": 0}),
    ("guard, later accumulate", lambda: _plan(lambda ir: guarded_then_accumulated(ir, 9, 13),
                                              (4, 8)), [True, True], {"B": 1}),
]


@pytest.mark.parametrize("label,make,want_old,want_loads", OLD_CASES,
                         ids=[c[0] for c in OLD_CASES])
def test_old_content_loaded_only_where_the_result_needs_it(label, make, want_old, want_loads):
    """``needs_old`` per computation, and in every body of the source each
    write array's pointer loaded as often as that asks: never where nothing
    reads the old content, once where the computation reads its own write
    index or needs the old content (one load serves both); no pointer and
    offset loaded twice."""
    nk = make()
    assert [p_nest.needs_old(nk.plan, ci) for ci in range(len(nk.plan.comps))] == want_old
    bodies = _bodies(nk.source)
    assert len(bodies) == (3 if nk.flat else 1)
    ptr = {name: f"p{k}" for k, name in enumerate(nk.arrays)}
    for body in bodies.values():
        assert len(_stores(body)) == len(nk.plan.comps)
        loads = _loads(body)
        for name, n in want_loads.items():
            assert sum(_base(c.args[0]) == ptr[name] for c in loads) == n, name
        assert len({ast.unparse(c.args[0]) for c in loads}) == len(loads)
        assert not any(re.match(r"old\d", ast.unparse(s)) for s in body) or any(want_old)


# the main path's parallel nests that keep the tiled form (by their first
# computation): a broadcast, a guard, a halo, or an array of another shape
TILED = {("correlation", "cn"), ("covariance", "cn"), ("covariance", "zc"),
         ("gemver", "a_up"), ("saturation_chain", "dq"), ("syrk", "sc"), ("syr2k", "sc")}


def _main_programs():
    from repro_torch.cloudsc import erosion_program, mini_cloudsc_program, saturation_chain_program
    from repro_torch.polybench import BENCHMARKS, NAMES

    out = [(n, [BENCHMARKS[n].make(v, "mini") for v in ("a", "b", "np")]) for n in NAMES]
    out += [("erosion", [erosion_program(8, 6)]), ("mini_scheme", [mini_cloudsc_program(8, 6)]),
            ("saturation_chain", [saturation_chain_program(8, 6)])]
    return out


@pytest.mark.parametrize("name,progs", _main_programs(), ids=[n for n, _ in _main_programs()])
def test_flattened_and_interior_forms_at_every_main_path_nest(name, progs):
    """Every parallel nest of the main path (planned as ``chip_smoke.py``
    plans it, at mini sizes): flattened unless it has a broadcast, a guard,
    a halo or arrays of other shapes; every body stores each computation;
    the flattened form's body tests no bound, its last block masks every
    access by the range's end, and the tiled form masks every access by
    its array's bounds; no computation of the main path loads old
    content."""
    cs = _chip_smoke()
    for prog in progs:
        for _, nk in cs._main_nests(p_nest, prog, "parallel", device="cpu"):
            first = nk.plan.comps[0].name
            assert nk.flat == ((name, first) not in TILED), (prog.name, first)
            assert not any(p_nest.needs_old(nk.plan, ci) for ci in range(len(nk.plan.comps)))
            bodies = _bodies(nk.source)
            assert len(bodies) == (3 if nk.flat else 1)
            assert ("if FLAT:" in nk.source) == nk.flat
            for form, body in bodies.items():
                assert len(_stores(body)) == len(nk.plan.comps), form
                masks = [ast.unparse(kw.value) for s in body for n in ast.walk(s)
                         if isinstance(n, ast.Call) for kw in n.keywords if kw.arg == "mask"]
                if form == "flat":
                    assert not masks, masks
                    continue
                assert len(masks) == len(_loads(body)) + len(_stores(body)), form
                bound = r"\bfm\b" if form == "flat ragged" else r"< n\d+_\d"
                assert all(re.search(bound, m) for m in masks), (form, masks)


def test_shared_parameters_are_checked_at_launch():
    """Arrays of one declared shape take one set of shape and stride
    parameters: a launch whose arrays of one group differ in strides
    raises, as does a wrong dtype or a second device type; consistent
    strides are passed once and end the flattened form."""
    nk = _plan(lambda ir: pointwise(ir, 5, 7))
    assert nk.groups == ((0, 1, 2, 3),) and nk.flat
    env = {a: torch.rand(5, 7) for a in nk.arrays}
    args, dev, flat = p_nest.launch_args(nk, env)
    assert flat and dev.type == "cpu"
    assert args[4:] == [5, 7, 7, 1, 0, 5, 0, 7] and all(a is env[n] for a, n in zip(args, nk.arrays))
    padded = {a: torch.rand(5, 16)[:, :7] for a in nk.arrays}
    args, _, flat = p_nest.launch_args(nk, padded)
    assert not flat and args[4:8] == [5, 7, 16, 1]
    mixed = dict(env, B=torch.rand(5, 16)[:, :7])
    with pytest.raises(ValueError, match="parameter group"):
        p_nest.launch_args(nk, mixed)
    with pytest.raises(ValueError, match="float32"):
        p_nest.launch_args(nk, dict(env, C=env["C"].double()))
    with pytest.raises(ValueError, match="want cuda"):
        p_nest.nest_launch(nk, env)
    # u and v share a group when the matrix is square; A has its own
    sq = _plan(lambda ir: broadcast_update(ir, 6, 6))
    assert sorted(len(g) for g in sq.groups) == [1, 2] and not sq.flat
    src_params = [a.arg for a in next(f for f in ast.parse(sq.source).body
                                      if isinstance(f, ast.FunctionDef)
                                      and f.name == "nest_kernel").args.args]
    assert src_params == ["p0", "p1", "p2", "n0_0", "n0_1", "s0_0", "s0_1", "n1_0", "s1_0",
                          "lo0", "hi0", "lo1", "hi1", "FLAT", "BLOCK"]
