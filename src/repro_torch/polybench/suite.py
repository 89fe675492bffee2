"""PolyBench 4.2 — the paper's 15 parallelizable benchmarks, in the IR.

Each benchmark ships three semantically-equivalent implementations:
  * ``a``  — the original PolyBench C loop structure (the paper's A variant),
  * ``b``  — an alternative permutation/composition (the paper's B variant),
  * ``np`` — the composition a NumPy/DaCe-style frontend would emit
             (paper §4.3: range indexing yields different loop structures).

Triangular domains are boxes + affine guards (see ir.Computation.guards).
Sizes are scaled from PolyBench LARGE to stay measurable on a 1-core CPU
container; all variants of one benchmark share sizes, so the paper's A/B
runtime *ratios* — the actual claim — are preserved.

Port of ``repro/polybench/suite.py``: the same builders; the one opaque
helper (``finish_std``) evaluates torch tensors instead of jax arrays and
carries its ``n_float`` as a keyword, where the device code generator reads it.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np

from ..core.ir import (
    Access,
    Affine,
    Array,
    Call,
    Computation,
    Const,
    Loop,
    Program,
    Read,
    acc,
    aff,
)

ALPHA, BETA = 1.5, 1.2
ZERO = Const(0.0)


def L(it: str, n: int, *body, start: int = 0) -> Loop:
    return Loop(it, n, start=start, body=tuple(body))


def C(name, write, reads, expr, accumulate=None, guards=()):
    return Computation(name, write, tuple(reads), expr, accumulate, tuple(guards))


@dataclass(frozen=True)
class Benchmark:
    name: str
    sizes: dict[str, dict[str, int]]
    variants: dict[str, Callable[[dict[str, int]], Program]]
    output: str  # array checked for correctness

    def make(self, variant: str, size: str = "mini") -> Program:
        return self.variants[variant](self.sizes[size])


_B: dict[str, Benchmark] = {}


def _register(name, sizes, output, **variants):
    _B[name] = Benchmark(name, sizes, variants, output)


# ---------------------------------------------------------------------------
# gemm: C = alpha*A@B + beta*C          (paper Fig. 1)
# ---------------------------------------------------------------------------
def _gemm_arrays(s):
    return (Array("A", (s["ni"], s["nk"])), Array("B", (s["nk"], s["nj"])),
            Array("C", (s["ni"], s["nj"])))


def _gemm_comps(i, j, k, j2):
    scale = C("scale", acc("C", i, j), [acc("C", i, j)], Read(0) * BETA)
    mac = C("mac", acc("C", i, j2), [acc("A", i, k), acc("B", k, j2)],
            ALPHA * Read(0) * Read(1), accumulate="+")
    return scale, mac


def gemm_a(s):  # polybench: for i { for j: scale; for k: for j: mac }  (fused in i)
    scale, mac = _gemm_comps("i", "j", "k", "j2")
    nest = L("i", s["ni"],
             L("j", s["nj"], scale),
             L("k", s["nk"], L("j2", s["nj"], mac)))
    return Program("gemm_a", _gemm_arrays(s), (nest,))


def gemm_b(s):  # paper Fig.1 gemm_2: separate nests, MAC in (i,j,k) order
    scale, mac = _gemm_comps("i", "j", "k", "j2")
    return Program("gemm_b", _gemm_arrays(s), (
        L("i", s["ni"], L("j", s["nj"], scale)),
        L("i2", s["ni"], L("j2", s["nj"], L("k", s["nk"],
          mac.rename({"i": "i2"})))),
    ))


def gemm_np(s):  # C *= beta (2D nest); C += alpha*(A@B) (jk-outer order)
    scale, mac = _gemm_comps("i", "j", "k", "j2")
    return Program("gemm_np", _gemm_arrays(s), (
        L("j", s["nj"], L("i", s["ni"], scale)),
        L("k", s["nk"], L("i2", s["ni"], L("j2", s["nj"], mac.rename({"i": "i2"})))),
    ))


_register("gemm",
          {"mini": dict(ni=20, nj=24, nk=28),
           "bench": dict(ni=320, nj=320, nk=320)},
          "C", a=gemm_a, b=gemm_b, np=gemm_np)


# ---------------------------------------------------------------------------
# 2mm: tmp = alpha*A@B; D = tmp@C2 + beta*D
# ---------------------------------------------------------------------------
def _2mm_arrays(s):
    return (Array("A", (s["ni"], s["nk"])), Array("B", (s["nk"], s["nj"])),
            Array("C2", (s["nj"], s["nl"])), Array("D", (s["ni"], s["nl"])),
            Array("tmp", (s["ni"], s["nj"])))


def _2mm_nests(order1, order2, order3, s):
    z = C("zero", acc("tmp", "i", "j"), [], ZERO)
    m1 = C("m1", acc("tmp", "i", "j"), [acc("A", "i", "k"), acc("B", "k", "j")],
           ALPHA * Read(0) * Read(1), accumulate="+")
    sc = C("sc", acc("D", "p", "q"), [acc("D", "p", "q")], Read(0) * BETA)
    m2 = C("m2", acc("D", "p", "q"), [acc("tmp", "p", "r"), acc("C2", "r", "q")],
           Read(0) * Read(1), accumulate="+")
    dims = dict(i=s["ni"], j=s["nj"], k=s["nk"], p=s["ni"], q=s["nl"], r=s["nj"])

    def nest(order, comps):
        inner: tuple = comps
        for it in reversed(order):
            inner = (Loop(it, dims[it], body=inner),)
        return inner[0]

    return z, m1, sc, m2, nest


def mm2_a(s):  # polybench: for i { for j { tmp=0; for k: acc } }; same for D
    z, m1, sc, m2, nest = _2mm_nests(None, None, None, s)
    n1 = L("i", s["ni"], L("j", s["nj"], z, L("k", s["nk"], m1)))
    n2 = L("p", s["ni"], L("q", s["nl"], sc, L("r", s["nj"], m2)))
    return Program("2mm_a", _2mm_arrays(s), (n1, n2))


def mm2_b(s):  # all stages fissioned, contractions in (k/r)-outer order
    z, m1, sc, m2, nest = _2mm_nests(None, None, None, s)
    return Program("2mm_b", _2mm_arrays(s), (
        nest(["j", "i"], (z,)),
        nest(["k", "j", "i"], (m1,)),
        nest(["q", "p"], (sc,)),
        nest(["r", "q", "p"], (m2,)),
    ))


def mm2_np(s):  # tmp = alpha*A@B (matmul composition); D = tmp@C2 + beta*D
    z, m1, sc, m2, nest = _2mm_nests(None, None, None, s)
    return Program("2mm_np", _2mm_arrays(s), (
        nest(["i", "j"], (z,)),
        nest(["i", "k", "j"], (m1,)),
        nest(["p", "q"], (sc,)),
        nest(["p", "r", "q"], (m2,)),
    ))


_register("2mm",
          {"mini": dict(ni=16, nj=18, nk=22, nl=24),
           "bench": dict(ni=256, nj=256, nk=256, nl=256)},
          "D", a=mm2_a, b=mm2_b, np=mm2_np)


# ---------------------------------------------------------------------------
# 3mm: E=A@B; F=C3@D3; G=E@F
# ---------------------------------------------------------------------------
def _3mm_arrays(s):
    return (Array("A", (s["ni"], s["nk"])), Array("B", (s["nk"], s["nj"])),
            Array("C3", (s["nj"], s["nm"])), Array("D3", (s["nm"], s["nl"])),
            Array("E", (s["ni"], s["nj"])), Array("F", (s["nj"], s["nl"])),
            Array("G", (s["ni"], s["nl"])))


def _3mm_stage(out, in1, in2, its, dims):
    i, j, k = its
    z = C(f"z{out}", acc(out, i, j), [], ZERO)
    m = C(f"m{out}", acc(out, i, j), [acc(in1, i, k), acc(in2, k, j)],
          Read(0) * Read(1), accumulate="+")
    return z, m


def mm3_a(s):
    stages = []
    for out, in1, in2, (di, dj, dk), pre in [
        ("E", "A", "B", (s["ni"], s["nj"], s["nk"]), "e"),
        ("F", "C3", "D3", (s["nj"], s["nl"], s["nm"]), "f"),
        ("G", "E", "F", (s["ni"], s["nl"], s["nj"]), "g"),
    ]:
        i, j, k = pre + "i", pre + "j", pre + "k"
        z, m = _3mm_stage(out, in1, in2, (i, j, k), None)
        stages.append(L(i, di, L(j, dj, z, L(k, dk, m))))
    return Program("3mm_a", _3mm_arrays(s), tuple(stages))


def mm3_b(s):  # contractions k-outer, zero nests transposed
    stages = []
    for out, in1, in2, (di, dj, dk), pre in [
        ("E", "A", "B", (s["ni"], s["nj"], s["nk"]), "e"),
        ("F", "C3", "D3", (s["nj"], s["nl"], s["nm"]), "f"),
        ("G", "E", "F", (s["ni"], s["nl"], s["nj"]), "g"),
    ]:
        i, j, k = pre + "i", pre + "j", pre + "k"
        z, m = _3mm_stage(out, in1, in2, (i, j, k), None)
        stages.append(L(j, dj, L(i, di, z)))
        stages.append(L(k, dk, L(i, di, L(j, dj, m))))
    return Program("3mm_b", _3mm_arrays(s), tuple(stages))


_register("3mm",
          {"mini": dict(ni=14, nj=16, nk=18, nl=20, nm=22),
           "bench": dict(ni=224, nj=224, nk=224, nl=224, nm=224)},
          "G", a=mm3_a, b=mm3_b, np=mm3_a)


# ---------------------------------------------------------------------------
# syrk: C (lower tri) = beta*C + alpha*A@A^T       (guarded triangle)
# ---------------------------------------------------------------------------
def _syrk_arrays(s):
    return (Array("A", (s["n"], s["m"])), Array("C", (s["n"], s["n"])))


def _syrk_comps():
    tri = aff("i", ("j", -1))  # i - j >= 0  <=>  j <= i
    sc = C("sc", acc("C", "i", "j"), [acc("C", "i", "j")], Read(0) * BETA,
           guards=[tri])
    mac = C("mac", acc("C", "i", "j"), [acc("A", "i", "k"), acc("A", "j", "k")],
            ALPHA * Read(0) * Read(1), accumulate="+", guards=[tri])
    return sc, mac


def syrk_a(s):  # polybench: for i { for j<=i: scale; for k { for j<=i: mac } }
    sc, mac = _syrk_comps()
    return Program("syrk_a", _syrk_arrays(s), (
        L("i", s["n"], L("j", s["n"], sc),
          L("k", s["m"], L("j2", s["n"], mac.rename({"j": "j2"})))),
    ))


def syrk_b(s):  # fissioned, mac in (j,k,i) order
    sc, mac = _syrk_comps()
    return Program("syrk_b", _syrk_arrays(s), (
        L("i", s["n"], L("j", s["n"], sc)),
        L("j2", s["n"], L("k", s["m"], L("i2", s["n"],
          mac.rename({"i": "i2", "j": "j2"})))),
    ))


def syrk_np(s):  # NPBench: for i { C[i,:i+1]*=beta; for k: C[i,:i+1]+=... }
    sc, mac = _syrk_comps()
    return Program("syrk_np", _syrk_arrays(s), (
        L("i", s["n"], L("j", s["n"], sc), L("k", s["m"], L("j2", s["n"],
          mac.rename({"j": "j2"})))),
    ))


_register("syrk",
          {"mini": dict(n=18, m=22), "bench": dict(n=256, m=256)},
          "C", a=syrk_a, b=syrk_b, np=syrk_np)


# ---------------------------------------------------------------------------
# syr2k: C (lower tri) = beta*C + alpha*(A@B^T + B@A^T)
# ---------------------------------------------------------------------------
def _syr2k_arrays(s):
    return (Array("A", (s["n"], s["m"])), Array("B", (s["n"], s["m"])),
            Array("C", (s["n"], s["n"])))


def _syr2k_comps():
    tri = aff("i", ("j", -1))
    sc = C("sc", acc("C", "i", "j"), [acc("C", "i", "j")], Read(0) * BETA,
           guards=[tri])
    mac1 = C("mac1", acc("C", "i", "j"), [acc("A", "j", "k"), acc("B", "i", "k")],
             ALPHA * Read(0) * Read(1), accumulate="+", guards=[tri])
    mac2 = C("mac2", acc("C", "i", "j"), [acc("B", "j", "k"), acc("A", "i", "k")],
             ALPHA * Read(0) * Read(1), accumulate="+", guards=[tri])
    return sc, mac1, mac2


def syr2k_a(s):
    sc, mac1, mac2 = _syr2k_comps()
    return Program("syr2k_a", _syr2k_arrays(s), (
        L("i", s["n"], L("j", s["n"], sc),
          L("k", s["m"], L("j2", s["n"], mac1.rename({"j": "j2"}),
                           mac2.rename({"j": "j2"})))),
    ))


def syr2k_b(s):
    sc, mac1, mac2 = _syr2k_comps()
    return Program("syr2k_b", _syr2k_arrays(s), (
        L("j", s["n"], L("i", s["n"], sc)),
        L("k", s["m"], L("i2", s["n"], L("j2", s["n"],
          mac1.rename({"i": "i2", "j": "j2"})))),
        L("k3", s["m"], L("j3", s["n"], L("i3", s["n"],
          mac2.rename({"i": "i3", "j": "j3", "k": "k3"})))),
    ))


_register("syr2k",
          {"mini": dict(n=16, m=20), "bench": dict(n=224, m=224)},
          "C", a=syr2k_a, b=syr2k_b, np=syr2k_a)


# ---------------------------------------------------------------------------
# atax: y = A^T (A x)
# ---------------------------------------------------------------------------
def _atax_arrays(s):
    return (Array("A", (s["m"], s["n"])), Array("x", (s["n"],)),
            Array("y", (s["n"],)), Array("tmp", (s["m"],)))


def _atax_comps():
    zy = C("zy", acc("y", "jz"), [], ZERO)
    zt = C("zt", acc("tmp", "i"), [], ZERO)
    t1 = C("t1", acc("tmp", "i"), [acc("A", "i", "j"), acc("x", "j")],
           Read(0) * Read(1), accumulate="+")
    t2 = C("t2", acc("y", "j2"), [acc("A", "i", "j2"), acc("tmp", "i")],
           Read(0) * Read(1), accumulate="+")
    return zy, zt, t1, t2


def atax_a(s):  # polybench: zero y; for i { tmp=0; for j: t1; for j: t2 }
    zy, zt, t1, t2 = _atax_comps()
    return Program("atax_a", _atax_arrays(s), (
        L("jz", s["n"], zy),
        L("i", s["m"], zt, L("j", s["n"], t1), L("j2", s["n"], t2)),
    ))


def atax_b(s):  # fully fissioned, second stage (j,i) order
    zy, zt, t1, t2 = _atax_comps()
    return Program("atax_b", _atax_arrays(s), (
        L("jz", s["n"], zy),
        L("i", s["m"], zt),
        L("i2", s["m"], L("j", s["n"], t1.rename({"i": "i2"}))),
        L("j2", s["n"], L("i3", s["m"], t2.rename({"i": "i3"}))),
    ))


_register("atax",
          {"mini": dict(m=20, n=24), "bench": dict(m=1200, n=1200)},
          "y", a=atax_a, b=atax_b, np=atax_b)


# ---------------------------------------------------------------------------
# bicg: s = A^T r ; q = A p    (classically fused in one (i,j) nest)
# ---------------------------------------------------------------------------
def _bicg_arrays(sz):
    return (Array("A", (sz["n"], sz["m"])), Array("r", (sz["n"],)),
            Array("p", (sz["m"],)), Array("s", (sz["m"],)),
            Array("q", (sz["n"],)))


def _bicg_comps():
    zs = C("zs", acc("s", "jz"), [], ZERO)
    zq = C("zq", acc("q", "iz"), [], ZERO)
    cs = C("cs", acc("s", "j"), [acc("r", "i"), acc("A", "i", "j")],
           Read(0) * Read(1), accumulate="+")
    cq = C("cq", acc("q", "i"), [acc("A", "i", "j"), acc("p", "j")],
           Read(0) * Read(1), accumulate="+")
    return zs, zq, cs, cq


def bicg_a(s):  # fused: for i { for j { s[j]+=..; q[i]+=.. } }
    zs, zq, cs, cq = _bicg_comps()
    return Program("bicg_a", _bicg_arrays(s), (
        L("jz", s["m"], zs), L("iz", s["n"], zq),
        L("i", s["n"], L("j", s["m"], cs, cq)),
    ))


def bicg_b(s):  # fissioned, s-stage in (j,i) order
    zs, zq, cs, cq = _bicg_comps()
    return Program("bicg_b", _bicg_arrays(s), (
        L("jz", s["m"], zs), L("iz", s["n"], zq),
        L("j", s["m"], L("i", s["n"], cs)),
        L("i2", s["n"], L("j2", s["m"], cq.rename({"i": "i2", "j": "j2"}))),
    ))


_register("bicg",
          {"mini": dict(n=20, m=24), "bench": dict(n=1200, m=1200)},
          "s", a=bicg_a, b=bicg_b, np=bicg_b)


# ---------------------------------------------------------------------------
# mvt / gemver / gesummv family
# ---------------------------------------------------------------------------
def _gemver_arrays(s):
    n = s["n"]
    return (Array("A", (n, n)), Array("u1", (n,)), Array("v1", (n,)),
            Array("u2", (n,)), Array("v2", (n,)), Array("w", (n,)),
            Array("x", (n,)), Array("y", (n,)), Array("z", (n,)))


def _gemver_comps():
    a_up = C("a_up", acc("A", "i", "j"),
             [acc("A", "i", "j"), acc("u1", "i"), acc("v1", "j"),
              acc("u2", "i"), acc("v2", "j")],
             Read(0) + Read(1) * Read(2) + Read(3) * Read(4))
    x_up = C("x_up", acc("x", "j2"), [acc("A", "i2", "j2"), acc("y", "i2")],
             BETA * Read(0) * Read(1), accumulate="+")
    x_z = C("x_z", acc("x", "j3"), [acc("x", "j3"), acc("z", "j3")],
            Read(0) + Read(1))
    w_up = C("w_up", acc("w", "i4"), [acc("A", "i4", "j4"), acc("x", "j4")],
             ALPHA * Read(0) * Read(1), accumulate="+")
    return a_up, x_up, x_z, w_up


def gemver_a(s):
    a_up, x_up, x_z, w_up = _gemver_comps()
    n = s["n"]
    return Program("gemver_a", _gemver_arrays(s), (
        L("i", n, L("j", n, a_up)),
        L("i2", n, L("j2", n, x_up)),
        L("j3", n, x_z),
        L("i4", n, L("j4", n, w_up)),
    ))


def gemver_b(s):  # x-stage in (j,i) order; w-stage (j,i) order
    a_up, x_up, x_z, w_up = _gemver_comps()
    n = s["n"]
    return Program("gemver_b", _gemver_arrays(s), (
        L("j", n, L("i", n, a_up)),
        L("j2", n, L("i2", n, x_up)),
        L("j3", n, x_z),
        L("j4", n, L("i4", n, w_up)),
    ))


_register("gemver",
          {"mini": dict(n=20), "bench": dict(n=1000)},
          "w", a=gemver_a, b=gemver_b, np=gemver_b)


def _gesummv_arrays(s):
    n = s["n"]
    return (Array("A", (n, n)), Array("B", (n, n)), Array("x", (n,)),
            Array("y", (n,)), Array("tmp", (n,)))


def _gesummv_comps():
    zt = C("zt", acc("tmp", "i"), [], ZERO)
    zy = C("zy", acc("y", "i"), [], ZERO)
    ct = C("ct", acc("tmp", "i"), [acc("A", "i", "j"), acc("x", "j")],
           Read(0) * Read(1), accumulate="+")
    cy = C("cy", acc("y", "i"), [acc("B", "i", "j"), acc("x", "j")],
           Read(0) * Read(1), accumulate="+")
    fin = C("fin", acc("y", "i"), [acc("tmp", "i"), acc("y", "i")],
            ALPHA * Read(0) + BETA * Read(1))
    return zt, zy, ct, cy, fin


def gesummv_a(s):  # polybench: one i loop: zero, j loop (both MACs), finalize
    zt, zy, ct, cy, fin = _gesummv_comps()
    n = s["n"]
    return Program("gesummv_a", _gesummv_arrays(s), (
        L("i", n, zt, zy, L("j", n, ct, cy), fin),
    ))


def gesummv_b(s):  # fissioned; MACs in (j,i) order
    zt, zy, ct, cy, fin = _gesummv_comps()
    n = s["n"]
    return Program("gesummv_b", _gesummv_arrays(s), (
        L("i", n, zt), L("i1", n, zy.rename({"i": "i1"})),
        L("j", n, L("i2", n, ct.rename({"i": "i2"}))),
        L("j2", n, L("i3", n, cy.rename({"i": "i3", "j": "j2"}))),
        L("i4", n, fin.rename({"i": "i4"})),
    ))


_register("gesummv",
          {"mini": dict(n=20), "bench": dict(n=1000)},
          "y", a=gesummv_a, b=gesummv_b, np=gesummv_b)


# ---------------------------------------------------------------------------
# doitgen: sum[r,q,p] = A[r,q,s]*C4[s,p];  A[r,q,p] = sum[r,q,p]
# ---------------------------------------------------------------------------
def _doitgen_arrays(s):
    return (Array("A", (s["nr"], s["nq"], s["np"])),
            Array("C4", (s["np"], s["np"])),
            Array("sum", (s["nr"], s["nq"], s["np"])))


def _doitgen_comps():
    z = C("z", acc("sum", "r", "q", "p"), [], ZERO)
    m = C("m", acc("sum", "r", "q", "p"), [acc("A", "r", "q", "s"), acc("C4", "s", "p")],
          Read(0) * Read(1), accumulate="+")
    cp = C("cp", acc("A", "r", "q", "p2"), [acc("sum", "r", "q", "p2")], Read(0))
    return z, m, cp


def doitgen_a(s):  # polybench: for r, q { for p {z; for s: m}; for p: copy }
    z, m, cp = _doitgen_comps()
    return Program("doitgen_a", _doitgen_arrays(s), (
        L("r", s["nr"], L("q", s["nq"],
          L("p", s["np"], z, L("s", s["np"], m)),
          L("p2", s["np"], cp))),
    ))


def doitgen_b(s):  # fissioned; contraction with s outer
    z, m, cp = _doitgen_comps()
    return Program("doitgen_b", _doitgen_arrays(s), (
        L("r", s["nr"], L("q", s["nq"], L("p", s["np"], z))),
        L("s", s["np"], L("r2", s["nr"], L("q2", s["nq"], L("p3", s["np"],
          m.rename({"r": "r2", "q": "q2", "p": "p3"})))),),
        L("r3", s["nr"], L("q3", s["nq"], L("p2", s["np"],
          cp.rename({"r": "r3", "q": "q3"})))),
    ))


_register("doitgen",
          {"mini": dict(nr=8, nq=10, np=12), "bench": dict(nr=64, nq=64, np=64)},
          "A", a=doitgen_a, b=doitgen_b, np=doitgen_b)


# ---------------------------------------------------------------------------
# jacobi-2d: T steps of 5-point smoothing A->Bt, Bt->A
# ---------------------------------------------------------------------------
def _jacobi_arrays(s):
    return (Array("A", (s["n"], s["n"])), Array("Bt", (s["n"], s["n"])))


def _stencil5(name, dst, src, i, j):
    return C(name, acc(dst, i, j),
             [acc(src, i, j),
              acc(src, i, aff(j, const=-1)), acc(src, i, aff(j, const=1)),
              acc(src, aff(i, const=1), j), acc(src, aff(i, const=-1), j)],
             0.2 * (Read(0) + Read(1) + Read(2) + Read(3) + Read(4)))


def jacobi2d_a(s):
    n = s["n"]
    s1 = _stencil5("s1", "Bt", "A", "i", "j")
    s2 = _stencil5("s2", "A", "Bt", "i2", "j2")
    return Program("jacobi2d_a", _jacobi_arrays(s), (
        Loop("t", s["t"], body=(
            Loop("i", n - 1, start=1, body=(Loop("j", n - 1, start=1, body=(s1,)),)),
            Loop("i2", n - 1, start=1, body=(Loop("j2", n - 1, start=1, body=(s2,)),)),
        )),
    ))


def jacobi2d_b(s):  # spatial loops transposed (j outer) — strided variant
    n = s["n"]
    s1 = _stencil5("s1", "Bt", "A", "i", "j")
    s2 = _stencil5("s2", "A", "Bt", "i2", "j2")
    return Program("jacobi2d_b", _jacobi_arrays(s), (
        Loop("t", s["t"], body=(
            Loop("j", n - 1, start=1, body=(Loop("i", n - 1, start=1, body=(s1,)),)),
            Loop("j2", n - 1, start=1, body=(Loop("i2", n - 1, start=1, body=(s2,)),)),
        )),
    ))


_register("jacobi-2d",
          {"mini": dict(n=14, t=4), "bench": dict(n=400, t=40)},
          "A", a=jacobi2d_a, b=jacobi2d_b, np=jacobi2d_a)


# ---------------------------------------------------------------------------
# heat-3d: T steps of 7-point 3D stencil, two-buffer
# ---------------------------------------------------------------------------
def _heat_arrays(s):
    n = s["n"]
    return (Array("A", (n, n, n)), Array("Bt", (n, n, n)))


def _stencil7(name, dst, src, i, j, k):
    return C(name, acc(dst, i, j, k),
             [acc(src, i, j, k),
              acc(src, aff(i, const=1), j, k), acc(src, aff(i, const=-1), j, k),
              acc(src, i, aff(j, const=1), k), acc(src, i, aff(j, const=-1), k),
              acc(src, i, j, aff(k, const=1)), acc(src, i, j, aff(k, const=-1))],
             Read(0) + 0.125 * (Read(1) - 2.0 * Read(0) + Read(2))
             + 0.125 * (Read(3) - 2.0 * Read(0) + Read(4))
             + 0.125 * (Read(5) - 2.0 * Read(0) + Read(6)))


def heat3d_a(s):
    n = s["n"]
    s1 = _stencil7("s1", "Bt", "A", "i", "j", "k")
    s2 = _stencil7("s2", "A", "Bt", "i2", "j2", "k2")
    return Program("heat3d_a", _heat_arrays(s), (
        Loop("t", s["t"], body=(
            Loop("i", n - 1, start=1, body=(Loop("j", n - 1, start=1, body=(
                Loop("k", n - 1, start=1, body=(s1,)),)),)),
            Loop("i2", n - 1, start=1, body=(Loop("j2", n - 1, start=1, body=(
                Loop("k2", n - 1, start=1, body=(s2,)),)),)),
        )),
    ))


def heat3d_b(s):  # (k,j,i) spatial order — fully strided
    n = s["n"]
    s1 = _stencil7("s1", "Bt", "A", "i", "j", "k")
    s2 = _stencil7("s2", "A", "Bt", "i2", "j2", "k2")
    return Program("heat3d_b", _heat_arrays(s), (
        Loop("t", s["t"], body=(
            Loop("k", n - 1, start=1, body=(Loop("j", n - 1, start=1, body=(
                Loop("i", n - 1, start=1, body=(s1,)),)),)),
            Loop("k2", n - 1, start=1, body=(Loop("j2", n - 1, start=1, body=(
                Loop("i2", n - 1, start=1, body=(s2,)),)),)),
        )),
    ))


_register("heat-3d",
          {"mini": dict(n=10, t=3), "bench": dict(n=80, t=20)},
          "A", a=heat3d_a, b=heat3d_b, np=heat3d_a)


# ---------------------------------------------------------------------------
# fdtd-2d: electromagnetic FDTD kernel, 4 statements under the time loop
# ---------------------------------------------------------------------------
def _fdtd_arrays(s):
    return (Array("ex", (s["nx"], s["ny"])), Array("ey", (s["nx"], s["ny"])),
            Array("hz", (s["nx"], s["ny"])), Array("fict", (s["t"],)))


def _fdtd_comps():
    s0 = C("s0", acc("ey", aff(const=0), "j0"), [acc("fict", "t")], Read(0))
    s1 = C("s1", acc("ey", "i1", "j1"),
           [acc("ey", "i1", "j1"), acc("hz", "i1", "j1"),
            acc("hz", aff("i1", const=-1), "j1")],
           Read(0) - 0.5 * (Read(1) - Read(2)))
    s2 = C("s2", acc("ex", "i2", "j2"),
           [acc("ex", "i2", "j2"), acc("hz", "i2", "j2"),
            acc("hz", "i2", aff("j2", const=-1))],
           Read(0) - 0.5 * (Read(1) - Read(2)))
    s3 = C("s3", acc("hz", "i3", "j3"),
           [acc("hz", "i3", "j3"), acc("ex", "i3", aff("j3", const=1)),
            acc("ex", "i3", "j3"), acc("ey", aff("i3", const=1), "j3"),
            acc("ey", "i3", "j3")],
           Read(0) - 0.7 * (Read(1) - Read(2) + Read(3) - Read(4)))
    return s0, s1, s2, s3


def fdtd2d_a(s):
    s0, s1, s2, s3 = _fdtd_comps()
    nx, ny = s["nx"], s["ny"]
    return Program("fdtd2d_a", _fdtd_arrays(s), (
        Loop("t", s["t"], body=(
            Loop("j0", ny, body=(s0,)),
            Loop("i1", nx, start=1, body=(Loop("j1", ny, body=(s1,)),)),
            Loop("i2", nx, body=(Loop("j2", ny, start=1, body=(s2,)),)),
            Loop("i3", nx - 1, body=(Loop("j3", ny - 1, body=(s3,)),)),
        )),
    ))


def fdtd2d_b(s):  # spatial loops transposed — the paper's pathological variant
    s0, s1, s2, s3 = _fdtd_comps()
    nx, ny = s["nx"], s["ny"]
    return Program("fdtd2d_b", _fdtd_arrays(s), (
        Loop("t", s["t"], body=(
            Loop("j0", ny, body=(s0,)),
            Loop("j1", ny, body=(Loop("i1", nx, start=1, body=(s1,)),)),
            Loop("j2", ny, start=1, body=(Loop("i2", nx, body=(s2,)),)),
            Loop("j3", ny - 1, body=(Loop("i3", nx - 1, body=(s3,)),)),
        )),
    ))


_register("fdtd-2d",
          {"mini": dict(nx=12, ny=14, t=4), "bench": dict(nx=400, ny=400, t=40)},
          "hz", a=fdtd2d_a, b=fdtd2d_b, np=fdtd2d_a)


# ---------------------------------------------------------------------------
# correlation / covariance
# ---------------------------------------------------------------------------
def _corr_arrays(s):
    m, n = s["m"], s["n"]
    return (Array("data", (n, m)), Array("mean", (m,)), Array("stddev", (m,)),
            Array("corr", (m, m)))


def finish_std(s_, n_float):
    """``sqrt(s/n)``, with a ~0 stddev replaced by 1.0 exactly like polybench
    (``<= 0.1 -> 1.0``); numpy for numpy/scalar operands, torch for tensors."""
    x = (s_ / n_float) ** 0.5
    if isinstance(s_, (float, np.floating, np.ndarray)):
        return np.where(x <= 0.1, 1.0, x)
    import torch

    return torch.where(x <= 0.1, 1.0, x)


# the device version the Triton nest kernel generates calls to
finish_std.device_source = """
@triton.jit
def finish_std(s, n_float):
    x = tl.sqrt(s / n_float)
    return tl.where(x <= 0.1, 1.0, x)
"""


def _corr_comps(n_float):
    zm = C("zm", acc("mean", "j"), [], ZERO)
    sm = C("sm", acc("mean", "j"), [acc("data", "i", "j")], Read(0),
           accumulate="+")
    dm = C("dm", acc("mean", "j2"), [acc("mean", "j2")], Read(0) / n_float)
    zs = C("zs", acc("stddev", "j3"), [], ZERO)
    ss = C("ss", acc("stddev", "j3"), [acc("data", "i3", "j3"), acc("mean", "j3")],
           (Read(0) - Read(1)) * (Read(0) - Read(1)), accumulate="+")
    ds = C("ds", acc("stddev", "j4"), [acc("stddev", "j4")],
           Call("finish_std", partial(finish_std, n_float=n_float), (Read(0),)))
    cn = C("cn", acc("data", "i5", "j5"),
           [acc("data", "i5", "j5"), acc("mean", "j5"), acc("stddev", "j5")],
           (Read(0) - Read(1)) / ((n_float ** 0.5) * Read(2)))
    zc = C("zc", acc("corr", "k1", "k2"), [], Const(1.0))
    cc = C("cc", acc("corr", "k3", "k4"),
           [acc("data", "i6", "k3"), acc("data", "i6", "k4")],
           Read(0) * Read(1), accumulate="+",
           guards=[aff("k4", ("k3", -1), const=-1)])  # k4 > k3
    sym = C("sym", acc("corr", "k6", "k5"), [acc("corr", "k5", "k6")],
            Read(0), guards=[aff("k6", ("k5", -1), const=-1)])
    return zm, sm, dm, zs, ss, ds, cn, zc, cc, sym


def correlation_a(s):
    m, n = s["m"], s["n"]
    zm, sm, dm, zs, ss, ds, cn, zc, cc, sym = _corr_comps(float(n))
    return Program("correlation_a", _corr_arrays(s), (
        L("j", m, zm, Loop("i", n, body=(sm,)), ),
        L("j2", m, dm),
        L("j3", m, zs, Loop("i3", n, body=(ss,))),
        L("j4", m, ds),
        L("i5", n, L("j5", m, cn)),
        L("k1", m, L("k2", m, zc)),
        L("k3", m, L("k4", m, L("i6", n, cc))),
        L("k5", m, L("k6", m, sym)),
    ))


def correlation_b(s):  # reductions in (i,j) order, corr in (i,k,k') order
    m, n = s["m"], s["n"]
    zm, sm, dm, zs, ss, ds, cn, zc, cc, sym = _corr_comps(float(n))
    return Program("correlation_b", _corr_arrays(s), (
        L("j", m, zm),
        L("i", n, L("jj", m, sm.rename({"j": "jj"}))),
        L("j2", m, dm),
        L("j3", m, zs),
        L("i3", n, L("jj3", m, ss.rename({"j3": "jj3"}))),
        L("j4", m, ds),
        L("j5", m, L("i5", n, cn)),
        L("k1", m, L("k2", m, zc)),
        L("i6", n, L("k3", m, L("k4", m, cc))),
        L("k5", m, L("k6", m, sym)),
    ))


_register("correlation",
          {"mini": dict(m=12, n=16), "bench": dict(m=240, n=260)},
          "corr", a=correlation_a, b=correlation_b, np=correlation_b)


def _cov_arrays(s):
    m, n = s["m"], s["n"]
    return (Array("data", (n, m)), Array("mean", (m,)), Array("cov", (m, m)))


def _cov_comps(n_float):
    zm = C("zm", acc("mean", "j"), [], ZERO)
    sm = C("sm", acc("mean", "j"), [acc("data", "i", "j")], Read(0),
           accumulate="+")
    dm = C("dm", acc("mean", "j2"), [acc("mean", "j2")], Read(0) / n_float)
    cn = C("cn", acc("data", "i5", "j5"), [acc("data", "i5", "j5"), acc("mean", "j5")],
           Read(0) - Read(1))
    zc = C("zc", acc("cov", "k1", "k2"), [], ZERO,
           guards=[aff("k2", ("k1", -1))])  # k2 >= k1
    cc = C("cc", acc("cov", "k3", "k4"),
           [acc("data", "i6", "k3"), acc("data", "i6", "k4")],
           Read(0) * Read(1) / (n_float - 1.0), accumulate="+",
           guards=[aff("k4", ("k3", -1))])
    sym = C("sym", acc("cov", "k6", "k5"), [acc("cov", "k5", "k6")],
            Read(0), guards=[aff("k6", ("k5", -1), const=-1)])
    return zm, sm, dm, cn, zc, cc, sym


def covariance_a(s):
    m, n = s["m"], s["n"]
    zm, sm, dm, cn, zc, cc, sym = _cov_comps(float(n))
    return Program("covariance_a", _cov_arrays(s), (
        L("j", m, zm, Loop("i", n, body=(sm,))),
        L("j2", m, dm),
        L("i5", n, L("j5", m, cn)),
        L("k1", m, L("k2", m, zc, Loop("i6", n, body=(cc.rename({"k3": "k1", "k4": "k2"}),)), )),
        L("k5", m, L("k6", m, sym)),
    ))


def covariance_b(s):
    m, n = s["m"], s["n"]
    zm, sm, dm, cn, zc, cc, sym = _cov_comps(float(n))
    return Program("covariance_b", _cov_arrays(s), (
        L("j", m, zm),
        L("i", n, L("jj", m, sm.rename({"j": "jj"}))),
        L("j2", m, dm),
        L("j5", m, L("i5", n, cn)),
        L("k1", m, L("k2", m, zc)),
        L("i6", n, L("k3", m, L("k4", m, cc))),
        L("k5", m, L("k6", m, sym)),
    ))


_register("covariance",
          {"mini": dict(m=12, n=16), "bench": dict(m=240, n=260)},
          "cov", a=covariance_a, b=covariance_b, np=covariance_b)


BENCHMARKS: dict[str, Benchmark] = dict(_B)
NAMES = tuple(BENCHMARKS)
assert len(NAMES) == 15, NAMES
