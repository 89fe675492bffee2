#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero):

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: the CUDA GEMM (K1) with ``nvcc`` from ``src/repro_torch/csrc``;
3. kernels against their plain versions on the card: K1 at the kernel-test
   shapes and at 1000x1200 @ 1200x1100 in fp32 and bf16; the Triton nest
   kernel (K2 parallel, K3 reduction) on stencil halos, triangular guards, a
   guarded reduction with unroll 1/2/4 and each of + * max min; then each
   kernel's time at a main-path shape beside its plain version's, its bound
   and, where one torch call computes the same function, that call's time;
4. main path, PolyBench: ``Daisy(backend="cuda")`` on the 15 A variants and
   the three CLOUDSC programs at a small size against the float64 numpy
   oracle, then on the 15 benchmarks x {a, b, np} at ``bench`` size and the
   a/b variants at PolyBench/C 4.2.1 LARGE_DATASET sizes, each checked
   against ``Daisy(backend="torch")`` and timed (first and second call);
5. main path, CLOUDSC: erosion, the mini scheme and the saturation chain at
   137 levels x 65,536 columns, checked the same way;
6. counts: each kernel's launches over phases 4-5 (all must be > 0), and the
   kernel recipes the planner or the contraction classifier sent to torch.

Kernel recipes are seeded, per canonical nest, for every nest the nest
planner or the BLAS-3 idiom accepts (``pallas_gemm`` for BLAS-3 nests,
``pallas_nest`` / ``pallas_reduce`` for the rest), into a database without
nearest-neighbour transfer so each nest gets exactly its own recipe.

Output: progress lines, then a JSON line with every kernel's numbers, the
``nvidia-smi`` line with the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
Without a card, or without ``src/repro_torch`` beside this file, it prints no
result and exits nonzero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores,
# bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12

# PolyBench/C 4.2.1 LARGE_DATASET, in the suite's size keys
LARGE = {
    "gemm": dict(ni=1000, nj=1100, nk=1200),
    "2mm": dict(ni=800, nj=900, nk=1100, nl=1200),
    "3mm": dict(ni=800, nj=900, nk=1000, nl=1100, nm=1200),
    "syrk": dict(n=1200, m=1000),
    "syr2k": dict(n=1200, m=1000),
    "atax": dict(m=1900, n=2100),
    "bicg": dict(n=2100, m=1900),
    "gemver": dict(n=2000),
    "gesummv": dict(n=1300),
    "doitgen": dict(nr=150, nq=140, np=160),
    "jacobi-2d": dict(n=1300, t=500),
    "heat-3d": dict(n=120, t=500),
    "fdtd-2d": dict(nx=1000, ny=1200, t=500),
    "correlation": dict(m=1200, n=1400),
    "covariance": dict(m=1200, n=1400),
}
BENCH_SIZE = "bench"
KLEV, NPROMA = 137, 65536
PROGRAM_RTOL, PROGRAM_ATOL = 1e-3, 1e-4  # tests/test_polybench.py
KERNEL_MAX_REL = 2e-4                     # tests/test_kernels.py (fp32)
BF16_RTOL, BF16_ATOL = 5e-2, 5e-1         # tests/test_kernels.py (bf16)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def cuda_ms(fn, repeats: int = 10) -> float:
    """Median device milliseconds of ``fn`` (CUDA events, after a warm-up)."""
    from repro_torch.core.util import time_fn

    return time_fn(fn, repeats=repeats, warmup=2, max_seconds=30.0, device="cuda") / 1e3


def max_rel(out, ref) -> float:
    ref = ref.double()
    return float((out.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_gemm(torch, results: dict) -> None:
    from repro_torch.kernels import gemm as kg

    g = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    shapes = [(16, 16, 16), (100, 52, 36), (128, 256, 64), (33, 17, 9), (8, 8, 200),
              (1000, 1100, 1200)]
    for m, n, k in shapes:
        x = torch.randn(m, k, generator=g, device="cuda")
        y = torch.randn(k, n, generator=g, device="cuda")
        out = kg.gemm(x, y)
        torch.cuda.synchronize()
        ref = kg.gemm_plain(x, y)
        err = max_rel(out, ref)
        worst = max(worst, float((out - ref).abs().max()))
        log(f"  K1 gemm fp32 {m}x{k} @ {k}x{n}: max rel err {err:.3e}")
        if not err <= KERNEL_MAX_REL:
            raise AssertionError(f"K1 fp32 {m}x{n}x{k}: max rel err {err} > {KERNEL_MAX_REL}")
    for m, n, k in [(64, 32, 48), (1000, 1100, 1200)]:
        x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
        y = torch.randn(k, n, generator=g, device="cuda").to(torch.bfloat16)
        out = kg.gemm(x, y).float()
        torch.cuda.synchronize()
        ref = kg.gemm_plain(x, y).float()
        ok = torch.allclose(out, ref, rtol=BF16_RTOL, atol=BF16_ATOL)
        log(f"  K1 gemm bf16 {m}x{k} @ {k}x{n}: max abs diff {float((out - ref).abs().max()):.3e}")
        if not ok:
            raise AssertionError(f"K1 bf16 {m}x{n}x{k} outside rtol {BF16_RTOL} atol {BF16_ATOL}")

    # time at the main path's shape (PolyBench LARGE gemm), fp32
    m, n, k = 1000, 1100, 1200
    x = torch.randn(m, k, generator=g, device="cuda")
    y = torch.randn(k, n, generator=g, device="cuda")
    ms = cuda_ms(lambda: kg.gemm(x, y))
    plain_ms = cuda_ms(lambda: kg.gemm_plain(x, y))
    library_ms = cuda_ms(lambda: torch.matmul(x, y))
    flops = 2.0 * m * n * k
    nbytes = 4.0 * (m * k + k * n + m * n)
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    log(f"  K1 gemm fp32 {m}x{k} @ {k}x{n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.matmul {library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms")
    results["gemm"] = dict(
        name="gemm", route="cuda", source="src/repro_torch/csrc/gemm.cu",
        replaces="src/repro/kernels/gemm.py:65", max_abs_err=worst, ms=ms,
        plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes", library_ms=library_ms)


def _nest_programs(ir):
    """The nest-kernel unit cases (tests/test_tiling.py's edge cases) at a
    test size and at a card-sized one: (label, program, schedule, inputs)."""
    import numpy as np

    from repro_torch.core import Schedule
    from repro_torch.core.scheduler import random_inputs

    Read, acc, aff = ir.Read, ir.acc, ir.aff

    def stencil(n):
        st = ir.Computation(
            "st", acc("B", "i", "j"),
            (acc("A", "i", "j"), acc("A", aff("i", const=-1), "j"),
             acc("A", aff("i", const=1), "j"), acc("A", "i", aff("j", const=-1)),
             acc("A", "i", aff("j", const=1))),
            Read(0) + 0.2 * (Read(1) + Read(2) + Read(3) + Read(4)))
        return ir.Program("stencil", (ir.Array("A", (n, n)), ir.Array("B", (n, n))),
                          (ir.Loop("i", n - 1, start=1,
                                   body=(ir.Loop("j", n - 1, start=1, body=(st,)),)),))

    def tri(n):
        sc = ir.Computation("sc", acc("C", "i", "j"), (acc("C", "i", "j"),),
                            Read(0) * 3.0, guards=(aff("i", ("j", -1)),))
        return ir.Program("tri", (ir.Array("C", (n, n)),),
                          (ir.Loop("i", n, body=(ir.Loop("j", n, body=(sc,)),)),))

    def syrk1(n, m):
        mac = ir.Computation("mac", acc("C", "i", "j"), (acc("A", "i", "k"), acc("A", "j", "k")),
                             Read(0) * Read(1), accumulate="+", guards=(aff("i", ("j", -1)),))
        return ir.Program("syrk1", (ir.Array("A", (n, m)), ir.Array("C", (n, n))),
                          (ir.Loop("i", n, body=(ir.Loop("j", n, body=(
                              ir.Loop("k", m, body=(mac,)),)),)),))

    def reduce_op(op, n, m):
        c = ir.Computation("r", acc("y", "i"), (acc("A", "i", "k"),),
                           Read(0) * 1.0, accumulate=op)
        return ir.Program(f"reduce{op}", (ir.Array("A", (n, m)), ir.Array("y", (n,))),
                          (ir.Loop("i", n, body=(ir.Loop("k", m, body=(c,)),)),))

    par = lambda tile: Schedule(use_idioms=False, pallas_nest=True, nest_tile=tile)  # noqa: E731
    red = lambda tile, u=1: Schedule(use_idioms=False, pallas_reduce=True,  # noqa: E731
                                     nest_tile=tile, unroll=u)
    cases = []
    for tile in [(3, 3), (4, 8), (16, 16)]:
        cases.append((f"stencil n=10 tile={tile}", stencil(10), par(tile)))
    cases.append(("stencil n=4096 default tile", stencil(4096), par(None)))
    cases.append(("triangular guard n=11 tile=(4,4)", tri(11), par((4, 4))))
    cases.append(("triangular guard n=4096 default tile", tri(4096), par(None)))
    for u in (1, 2, 4):
        cases.append((f"guarded reduction 9x16 unroll={u}", syrk1(9, 16), red((4, 4, 8), u)))
        cases.append((f"guarded reduction 1024x512 unroll={u}", syrk1(1024, 512),
                      red((16, 16, 64), u)))
    for op in ("+", "*", "max", "min"):
        cases.append((f"reduction {op} 4096x64", reduce_op(op, 4096, 64), red(None)))
    out = []
    for label, prog, sched in cases:
        inp = random_inputs(prog, seed=7)
        if prog.name == "reduce*":  # keep the product of 64 terms near 1
            inp["A"] = np.random.default_rng(7).uniform(0.99, 1.01, size=(4096, 64)).astype(np.float32)
        out.append((label, prog, sched, inp))
    return out


def _env(torch, prog, inputs):
    return {a.name: (torch.zeros(a.shape, device="cuda") if a.name in prog.temps
                     else torch.as_tensor(inputs[a.name], device="cuda").float())
            for a in prog.arrays}


def _copy(env):
    return {k: v.clone() for k, v in env.items()}


def _compare(got, want) -> tuple[float, float]:
    """(max relative error, max abs difference) over every array."""
    rel = max(max_rel(got[k], want[k]) for k in got)
    diff = max(float((got[k] - want[k]).abs().max()) for k in got)
    return rel, diff


def check_nest_kernel(torch, results: dict) -> None:
    from repro_torch.core import ir
    from repro_torch.kernels import nest_kernel as nkm

    worst = {"pallas_nest": 0.0, "pallas_reduce": 0.0}
    for label, prog, sched, inp in _nest_programs(ir):
        nk = nkm.plan_nest(prog, prog.body[0], sched)
        base = _env(torch, prog, inp)
        got, want = _copy(base), _copy(base)
        t0 = time.perf_counter()
        nkm.run_nest(nk, got)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        nkm.nest_plain(nk, want)
        err, diff = _compare(got, want)
        worst[nk.kind] = max(worst[nk.kind], diff)
        log(f"  {'K2' if nk.kind == 'pallas_nest' else 'K3'} {label}: blocks "
            f"{[a.block for a in nk.plan.axes]}, max rel err {err:.3e} "
            f"(first launch incl. build {first:.2f} s)")
        if not err <= KERNEL_MAX_REL:
            raise AssertionError(f"nest kernel {label}: max rel err {err} > {KERNEL_MAX_REL}")

    # times at main-path nests: K2 on the mini CLOUDSC scheme's parallel
    # nest at 137 x 65,536, K3 on atax's matrix-vector reduction at LARGE
    from repro_torch.cloudsc import mini_cloudsc_program, scheme_inputs
    from repro_torch.core import Daisy, Schedule
    from repro_torch.core.ir import expr_ops
    from repro_torch.core.scheduler import nest_program, random_inputs
    from repro_torch.core.tiling import TilingError
    from repro_torch.polybench import BENCHMARKS

    def main_nest(prog, kind):
        norm = Daisy(backend="torch").plan(prog).program
        best = None
        for nest in norm.body:
            try:
                nk = nkm.plan_nest(norm, nest, Schedule(pallas_nest=True, pallas_reduce=True))
            except TilingError:
                continue
            if nk.plan.kind == kind and (best is None or len(nk.plan.comps) > len(best[1].plan.comps)):
                best = (nest_program(norm, nest), nk)
        return best

    picks = {
        "pallas_nest": (mini_cloudsc_program(NPROMA, KLEV), "parallel",
                        scheme_inputs(NPROMA, KLEV)),
        "pallas_reduce": (BENCHMARKS["atax"].variants["a"](LARGE["atax"]), "reduce", None),
    }
    for kind, (prog, pkind, inputs) in picks.items():
        nprog, nk = main_nest(prog, pkind)
        inp = random_inputs(nprog, seed=11)
        if inputs is not None:  # physical ranges for the thermodynamics
            inp.update({k: v for k, v in inputs.items() if k in inp})
        base = _env(torch, nprog, inp)
        got, want = _copy(base), _copy(base)
        nkm.run_nest(nk, got)
        nkm.nest_plain(nk, want)
        torch.cuda.synchronize()
        err, diff = _compare(got, want)
        worst[kind] = max(worst[kind], diff)
        if not err <= KERNEL_MAX_REL:
            raise AssertionError(f"{kind} on {nprog.name}: max rel err {err}")
        work = _copy(base)
        ms = cuda_ms(lambda: nkm.run_nest(nk, work))
        plain_ms = cuda_ms(lambda: nkm.nest_plain(nk, work))
        points = math.prod(a.trip for a in nk.plan.axes)
        flops = float(points * sum(max(1, expr_ops(c.expr)) + (1 if c.accumulate else 0)
                                   for c in nk.plan.comps))
        read = {r.array for c in nk.plan.comps for r in c.reads}
        written = {c.write.array for c in nk.plan.comps}
        if nk.kind == "pallas_reduce":
            read |= written  # the old output is combined with the result
        nbytes = 4.0 * (sum(base[a].numel() for a in read) + sum(base[a].numel() for a in written))
        t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        library_ms = None
        if kind == "pallas_reduce":
            library_ms = _addmv_library_ms(torch, nk, base, want)
        log(f"  {'K2' if kind == 'pallas_nest' else 'K3'} {nprog.name} "
            f"{[a.trip for a in nk.plan.axes]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library_ms if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"bound {max(t_ops, t_bytes):.4f} ms, max rel err {err:.3e}")
        results[kind] = dict(
            name=f"nest_kernel[{'parallel' if kind == 'pallas_nest' else 'reduce'}]",
            route="triton", source="src/repro_torch/kernels/nest_kernel.py",
            replaces=("src/repro/kernels/nest_kernel.py:244 (_kernel)" if kind == "pallas_nest"
                      else "src/repro/kernels/nest_kernel.py:244 (_emit_reduce)"),
            max_abs_err=worst[kind], ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=library_ms, shape=f"{nprog.name} {[a.trip for a in nk.plan.axes]}")


def _addmv_library_ms(torch, nk, base, want):
    """``torch.addmv`` time when it reproduces the reduction ``y[i] += c *
    A[i,j] * x[j]`` (either orientation of A); None when it does not."""
    comp = nk.plan.comps[0]
    if comp.accumulate != "+" or comp.guards or len(comp.reads) != 2:
        return None
    y = base[comp.write.array]
    mats = [r for r in comp.reads if len(r.index) == 2]
    vecs = [r for r in comp.reads if len(r.index) == 1]
    if y.ndim != 1 or len(mats) != 1 or len(vecs) != 1:
        return None
    A, x = base[mats[0].array], base[vecs[0].array]
    scale = float(comp.expr(1.0, 1.0))
    for mat in (A, A.t()):
        if mat.shape == (y.shape[0], x.shape[0]):
            out = torch.addmv(y, mat, x, alpha=scale)
            if max_rel(out, want[comp.write.array]) <= KERNEL_MAX_REL:
                return cuda_ms(lambda: torch.addmv(y, mat, x, alpha=scale))
    return None


# ---------------------------------------------------------------------------
# phases 4-5: the main path
# ---------------------------------------------------------------------------
def seed_kernel_recipes(daisy, program) -> None:
    """Add an exact kernel recipe for every canonical nest of ``program`` the
    nest planner or the BLAS-3 idiom accepts."""
    from repro_torch.core import Recipe, fingerprint
    from repro_torch.core.embedding import embed_nest
    from repro_torch.core.idioms import classify_nest
    from repro_torch.core.tiling import TilingError, plan_nest_tiling

    norm = daisy.plan(program).program
    for nest in norm.body:
        if classify_nest(nest).kind == "blas3":
            # a budget that vectorizes every iterator, so the contraction
            # reaches einsum/the GEMM at LARGE sizes too
            recipe = Recipe(kind="pallas_gemm", vec_budget=1 << 31)
        else:
            try:
                plan = plan_nest_tiling(norm, nest)
            except TilingError:
                continue
            recipe = Recipe(kind="pallas_nest" if plan.kind == "parallel" else "pallas_reduce")
        daisy.db.add(fingerprint(nest), embed_nest(norm, nest), recipe, provenance="chip_smoke")


def _timed(torch, fn, inputs):
    """(fn(inputs), seconds to the card's completion)."""
    t0 = time.perf_counter()
    env = fn(inputs)
    torch.cuda.synchronize()
    return env, time.perf_counter() - t0


def run_program(torch, cuda_daisy, torch_daisy, program, inputs, outputs, label) -> None:
    seed_kernel_recipes(cuda_daisy, program)
    t0 = time.perf_counter()
    fn_k, plan = cuda_daisy.compile(program)
    fn_t, _ = torch_daisy.compile(program)
    t_compile = time.perf_counter() - t0
    env_k, first_k = _timed(torch, fn_k, inputs)  # first calls build the Triton kernels
    env_t, first_t = _timed(torch, fn_t, inputs)
    worst = 0.0
    for name in outputs:
        got, ref = env_k[name], env_t[name]
        if tuple(got.shape) != tuple(program.array(name).shape) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label}: {name} has shape {tuple(got.shape)} or non-finite values")
        if not torch.allclose(got, ref, rtol=PROGRAM_RTOL, atol=PROGRAM_ATOL):
            raise AssertionError(f"{label}: {name} differs from the torch backend "
                                 f"(max rel {max_rel(got, ref):.3e})")
        worst = max(worst, max_rel(got, ref))
    kinds = {}
    for n in plan.nests:
        kinds[n.recipe.kind] = kinds.get(n.recipe.kind, 0) + 1
    del env_k, env_t
    t_k = _timed(torch, fn_k, inputs)[1]
    t_t = _timed(torch, fn_t, inputs)[1]
    log(f"  {label}: ok (max rel vs torch {worst:.2e}); recipes {kinds}; "
        f"compile {t_compile:.2f} s; run: cuda {t_k:.4f} s (first {first_k:.3f} s), "
        f"torch {t_t:.4f} s (first {first_t:.3f} s)")


def check_oracle(torch, cuda_daisy, program, inputs, outputs, label) -> None:
    """``Daisy(backend="cuda")`` on the card against the float64 numpy
    oracle (``execute_numpy``) at a small size."""
    from repro_torch.core import execute_numpy
    from repro_torch.core.scheduler import random_inputs

    import numpy as np

    seed_kernel_recipes(cuda_daisy, program)
    if inputs is None:
        inputs = random_inputs(program, seed=3, dtype=np.float64)
    fn, _ = cuda_daisy.compile(program)
    env = fn(inputs)
    oracle = execute_numpy(program, inputs)
    for name in outputs:
        got = env[name].cpu().numpy()
        if not np.allclose(got, oracle[name], rtol=PROGRAM_RTOL, atol=PROGRAM_ATOL):
            raise AssertionError(f"{label} (small): {name} differs from execute_numpy")
    log(f"  {label} small: matches execute_numpy")


def main_path(torch) -> None:
    import numpy as np

    from repro_torch.cloudsc import (erosion_program, mini_cloudsc_program, physical_inputs,
                                     saturation_chain_inputs, saturation_chain_program,
                                     scheme_inputs)
    from repro_torch.core import Daisy, TuningDatabase
    from repro_torch.core.scheduler import random_inputs
    from repro_torch.polybench import BENCHMARKS, NAMES

    db = TuningDatabase(radius=-1.0)  # exact recipes only: no transfer
    cuda_daisy = Daisy(db=db, backend="cuda")
    torch_daisy = Daisy(db=db, backend="torch")

    log("phase 4: main path, PolyBench (numpy oracle at mini, then bench, then LARGE a/b)")
    oracle_programs = [(BENCHMARKS[n].make("a", "mini"), None, [BENCHMARKS[n].output], f"{n}/a")
                       for n in NAMES]
    oracle_programs += [
        (erosion_program(8, 6), physical_inputs(8, 6), ["ZTP1", "ZQSMIX"], "cloudsc erosion"),
        (mini_cloudsc_program(8, 6), scheme_inputs(8, 6), ["TENDQ"], "cloudsc mini scheme"),
        (saturation_chain_program(8, 6), saturation_chain_inputs(8, 6), ["TEND"],
         "cloudsc saturation chain"),
    ]
    for prog, inputs, outputs, label in oracle_programs:
        check_oracle(torch, cuda_daisy, prog, inputs, outputs, label)
    for name in NAMES:
        b = BENCHMARKS[name]
        for var in ("a", "b", "np"):
            prog = b.make(var, BENCH_SIZE)
            run_program(torch, cuda_daisy, torch_daisy, prog, random_inputs(prog, seed=3),
                        [b.output], f"{name}/{var} {BENCH_SIZE}")
    for name in NAMES:
        b = BENCHMARKS[name]
        for var in ("a", "b"):
            prog = b.variants[var](LARGE[name])
            run_program(torch, cuda_daisy, torch_daisy, prog, random_inputs(prog, seed=3),
                        [b.output], f"{name}/{var} LARGE {LARGE[name]}")

    log(f"phase 5: main path, CLOUDSC at klev={KLEV}, nproma={NPROMA}")
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    run_program(torch, cuda_daisy, torch_daisy, erosion_program(NPROMA, KLEV),
                 f32(physical_inputs(NPROMA, KLEV)), ["ZTP1", "ZQSMIX"], "cloudsc erosion")
    run_program(torch, cuda_daisy, torch_daisy, mini_cloudsc_program(NPROMA, KLEV),
                 f32(scheme_inputs(NPROMA, KLEV)), ["ZTP1", "ZQSMIX", "ZQL", "ZQI", "TENDQ"],
                 "cloudsc mini scheme")
    run_program(torch, cuda_daisy, torch_daisy, saturation_chain_program(NPROMA, KLEV),
                 f32(saturation_chain_inputs(NPROMA, KLEV)), ["TEND"], "cloudsc saturation chain")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (HERE / "src" / "repro_torch").is_dir():
        print(f"no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import codegen
    from repro_torch.kernels import build
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import nest_kernel as nkm

    smi = nvidia_smi()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}")

    log("phase 2: build")
    t0 = time.perf_counter()
    build.cuda_library("gemm")
    log(f"  K1 gemm.cu built with nvcc in {time.perf_counter() - t0:.2f} s")
    for line in build.BUILD_LOG.get("gemm", (0.0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    results: dict[str, dict] = {}
    log("phase 3: kernels against their plain versions")
    check_gemm(torch, results)
    check_nest_kernel(torch, results)

    # the main path: every count starts at 0 here and is read right after
    kg.LAUNCHES["gemm"] = 0
    for k in nkm.EMITTED:
        nkm.EMITTED[k] = 0
    codegen.ROUTED.clear()
    main_path(torch)
    torch.cuda.synchronize()
    launches = {"gemm": kg.LAUNCHES["gemm"], "pallas_nest": nkm.EMITTED["pallas_nest"],
                "pallas_reduce": nkm.EMITTED["pallas_reduce"]}
    routed = dict(codegen.ROUTED)

    log("phase 6: counts over phases 4-5")
    log(f"  launches: K1 gemm {launches['gemm']}, K2 nest {launches['pallas_nest']}, "
        f"K3 reduce {launches['pallas_reduce']}")
    log(f"  kernel recipes routed to torch: {sum(routed.values())}")
    for reason, n in sorted(routed.items()):
        log(f"    {n} x {reason}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    kernels = []
    for key in ("gemm", "pallas_nest", "pallas_reduce"):
        row = dict(results[key])
        row["launches"] = launches[key]
        kernels.append(row)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # report which phase failed, then exit nonzero
        traceback.print_exc()
        sys.exit(1)
