"""Explain what the compiler pass pipeline does to a program.

Usage:
    PYTHONPATH=src python -m repro_torch.tools.explain gemm
    PYTHONPATH=src python -m repro_torch.tools.explain cloudsc_erosion --no-fuse
    PYTHONPATH=src python -m repro_torch.tools.explain saturation_chain --no-rewrite
    PYTHONPATH=src python -m repro_torch.tools.explain 2mm --variant np --size bench --ir

Port of ``repro/tools/explain.py``.  Prints the per-pass report (wall time,
nest/computation deltas, and every custom stat a pass attached — fusion
merge counts, LICM hoists and flop deltas, expansion/CSE counts — rendered
verbatim) followed by the canonical nests with their idiom classification
and the recipe the daisy scheduler would resolve for each.  It plans and
compiles nothing, so it launches nothing and needs no card.
"""
from __future__ import annotations

import argparse

from ..cloudsc import erosion_program, mini_cloudsc_program, saturation_chain_program
from ..core import Daisy
from ..core.ir import Loop, Program, fingerprint, loop_iterators, nest_computations
from ..polybench import BENCHMARKS

EXTRA = {
    "cloudsc_erosion": lambda size: erosion_program(
        nproma=128 if size == "bench" else 8, klev=137 if size == "bench" else 4
    ),
    "cloudsc_scheme": lambda size: mini_cloudsc_program(
        nproma=128 if size == "bench" else 8, klev=137 if size == "bench" else 5
    ),
    "saturation_chain": lambda size: saturation_chain_program(
        nproma=128 if size == "bench" else 8, klev=137 if size == "bench" else 5
    ),
}


def _describe_nest(nest, plan) -> str:
    if isinstance(nest, Loop):
        its = loop_iterators(nest)
        shape = "x".join(str(t) for t in _trips(nest, its))
        head = f"loops=({','.join(its)}) [{shape}]"
    else:
        head = "computation"
    comps = nest_computations(nest)
    return (
        f"{head} comps={len(comps)} idiom={plan.idiom} "
        f"recipe={plan.recipe.kind} source={plan.source}"
    )


def _trips(nest, its):
    trips = {}

    def rec(n):
        if isinstance(n, Loop):
            trips[n.iterator] = n.trip_count
            for b in n.body:
                rec(b)

    rec(nest)
    return [trips[i] for i in its]


def explain(program: Program, fuse: bool = True, rewrite: bool = True,
            show_ir: bool = False) -> str:
    """Render the per-pass report and canonical-nest plan for ``program``."""
    # planning touches no device; the CPU keeps the tool usable without a card
    daisy = Daisy(fuse=fuse, rewrite=rewrite, device="cpu")
    ctx = daisy.explain(program, snapshots=show_ir)
    plan = daisy.plan(program)
    lines = [
        f"program {program.name}: {len(program.body)} authored nest(s) -> "
        f"{len(plan.program.body)} canonical kernel(s)",
        "",
        ctx.report(),
        "",
        "canonical nests:",
    ]
    for nest, np_ in zip(plan.program.body, plan.nests):
        lines.append("  " + _describe_nest(nest, np_))
    if show_ir:
        lines += ["", "canonical IR fingerprints:"]
        for nest in plan.program.body:
            lines.append("  " + fingerprint(nest)[:120])
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("program",
                    help=f"polybench name ({', '.join(BENCHMARKS)}) or {', '.join(EXTRA)}")
    ap.add_argument("--variant", default="a", help="polybench variant: a | b | np")
    ap.add_argument("--size", default="mini", choices=["mini", "bench"])
    ap.add_argument("--no-fuse", dest="fuse", action="store_false",
                    help="stop after a priori normalization (no re-fusion)")
    ap.add_argument("--no-rewrite", dest="rewrite", action="store_false",
                    help="skip the expression rewrite passes (licm, "
                         "expand_factor, cse)")
    ap.add_argument("--ir", action="store_true", help="also print IR fingerprints")
    args = ap.parse_args(argv)

    if args.program in EXTRA:
        prog = EXTRA[args.program](args.size)
    elif args.program in BENCHMARKS:
        prog = BENCHMARKS[args.program].make(args.variant, args.size)
    else:
        raise SystemExit(f"unknown program {args.program!r}")
    print(explain(prog, fuse=args.fuse, rewrite=args.rewrite, show_ir=args.ir))


if __name__ == "__main__":
    main()
