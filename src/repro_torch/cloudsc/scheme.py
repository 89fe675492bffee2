"""A mini CLOUDSC vertical scheme (paper §5.2 analogue).

Several physics stages inside one vertical loop, modeled after the structure
of the real scheme:

  1. saturation/erosion update (the Fig. 10 nest, scalar chain over JL),
  2. condensate source split into liquid/ice by the alpha weight,
  3. precipitation flux accumulated *down the column* — a genuine JK-carried
     recurrence (fluxes fall), which normalization must keep sequential,
  4. final tendency update from the flux divergence.

Stage 3 proves the normalizer's legality machinery on a real pattern: the
JK-carried SCC stays atomic while every JL loop fissions and vectorizes.

Port of ``repro/cloudsc/scheme.py``: the programs and their inputs,
``column_mesh`` (a 1-D mesh over a ``torch.distributed`` world) and
``compile_scheme`` (the scheme column-sharded over it).
"""
from __future__ import annotations

import numpy as np

from ..core.ir import (
    Array,
    Call,
    Computation,
    Expr,
    Loop,
    Program,
    Read,
    acc,
    aff,
    as_expr,
    emin,
)
from .erosion import foedem, foeewm, foeldcpm, RETV

RG_DT = 0.75     # g*dt/dp surrogate
RAUTO = 1.0e-3   # autoconversion rate
RFALL = 0.8      # fall-speed weight


def _call(fn, *args) -> Expr:
    """A symbolic ``Call`` of one of the IFS thermodynamic helpers."""
    return Call(fn.__name__, fn, tuple(as_expr(a) for a in args))


def mini_cloudsc_program(nproma: int = 128, klev: int = 137) -> Program:
    A = lambda n: acc(n, "JK", "JL")  # noqa: E731
    Am1 = lambda n: acc(n, aff("JK", const=-1), "JL")  # noqa: E731
    S = lambda n: acc(n)  # noqa: E731

    def comp(nm, write, reads, expr, accumulate=None, guards=()):
        return Computation(nm, write, tuple(reads), expr, accumulate, tuple(guards))

    # -- stage 1: saturation adjustment (scalar chain, as in erosion) --------
    _foel = _call(foeldcpm, Read(2))  # shared liquid-fraction weight
    sat = (
        comp("zqp", S("ZQP"), [A("PAP")], 1.0 / Read(0)),
        comp("qs", S("ZQSAT"), [A("ZTP1"), S("ZQP")],
             _call(foeewm, Read(0)) * Read(1)),
        comp("qsc", S("ZQSAT"), [S("ZQSAT")], emin(0.5, Read(0))),
        comp("cor", S("ZCOR"), [S("ZQSAT")], 1.0 / (1.0 - RETV * Read(0))),
        comp("qsm", S("ZQSAT"), [S("ZQSAT"), S("ZCOR")], Read(0) * Read(1)),
        comp(
            "cond",
            S("ZCOND"),
            [A("ZQSMIX"), S("ZQSAT"), S("ZCOR"), A("ZTP1")],
            (Read(0) - Read(1))
            / (1.0 + Read(1) * Read(2) * _call(foedem, Read(3))),
        ),
        comp("tu", A("ZTP1"), [A("ZTP1"), S("ZCOND")],
             Read(0) + _call(foeldcpm, Read(0)) * Read(1)),
        comp("qu", A("ZQSMIX"), [A("ZQSMIX"), S("ZCOND")], Read(0) - Read(1)),
    )
    # -- stage 2: split condensate into liquid & ice, autoconversion ---------
    split = (
        comp(
            "liq",
            A("ZQL"),
            [A("ZQL"), A("ZQSMIX"), A("ZTP1")],
            Read(0) + RAUTO * Read(1) * _foel / (_foel + 1.0),
        ),
        comp(
            "ice",
            A("ZQI"),
            [A("ZQI"), A("ZQSMIX"), A("ZTP1")],
            Read(0) + RAUTO * Read(1) * (1.0 - _foel / (_foel + 1.0)),
        ),
    )
    # -- stage 3: precipitation flux falls down the column (JK-carried) ------
    flux = (
        comp(
            "pfl",
            A("PFPLSL"),
            [Am1("PFPLSL"), A("ZQL")],
            RFALL * Read(0) + RAUTO * Read(1),
            guards=(aff("JK", const=-1),),  # JK >= 1 (no level above at JK=0)
        ),
        comp(
            "pfl0",
            A("PFPLSL"),
            [A("ZQL")],
            RAUTO * Read(0),
            guards=(aff(("JK", -1)),),  # JK == 0  (−JK >= 0)
        ),
    )
    # -- stage 4: tendency from flux divergence ------------------------------
    tend = (
        comp(
            "dq",
            A("TENDQ"),
            [A("PFPLSL"), A("ZQSMIX")],
            RG_DT * (Read(1) - Read(0)),
        ),
    )
    nest = Loop(
        "JK",
        klev,
        body=(
            Loop("JL", nproma, body=sat),
            Loop("JL2", nproma, body=tuple(c.rename({"JL": "JL2"}) for c in split)),
            Loop("JL3", nproma, body=tuple(c.rename({"JL": "JL3"}) for c in flux)),
            Loop("JL4", nproma, body=tuple(c.rename({"JL": "JL4"}) for c in tend)),
        ),
    )
    arrays = (
        Array("PAP", (klev, nproma)),
        Array("ZTP1", (klev, nproma)),
        Array("ZQSMIX", (klev, nproma)),
        Array("ZQL", (klev, nproma)),
        Array("ZQI", (klev, nproma)),
        Array("PFPLSL", (klev, nproma)),
        Array("TENDQ", (klev, nproma)),
        Array("ZQP", ()),
        Array("ZQSAT", ()),
        Array("ZCOR", ()),
        Array("ZCOND", ()),
    )
    return Program(
        "mini_cloudsc", arrays, (nest,),
        temps=("ZQP", "ZQSAT", "ZCOR", "ZCOND", "PFPLSL", "TENDQ"),
    )


# (name, fall-speed weight, band extent) per hydrometeor species.  The band
# extents deliberately differ so the per-species JK nests cannot fuse — each
# compiles to its own lax.scan, which is what defeats cross-scan sharing.
SPECIES = (("rain", 0.82, 2), ("snow", 0.64, 3), ("liq", 0.45, 4), ("ice", 0.31, 5))


def _sat_source(i_t: int, i_p: int, iters: int) -> Expr:
    """Wet-bulb relaxation source over reference fields — the hoist target.

    ``iters`` Newton-style corrections of the wet-bulb temperature
    (``tw -= (esat(tw)/p - q*) * dL/cp * k``), then the autoconversion
    source at the converged value.  Every iteration costs two ``exp``-based
    IFS calls, so the chain dominates the cheap flux recurrence around it.

    The reads are ``TREF``/``PREF`` level slices — per-step ``xs`` of the
    enclosing JK scan — so XLA's while-loop ICM *cannot* hoist the chain
    (it is syntactically step-dependent in HLO), and the four species scans
    are separate while ops, so XLA cannot share it across them either.
    ``LICMPass`` sees the band-axis (JM) invariance in the IR and computes
    the chain once into a shared ``(klev, nproma)`` temp.
    """
    tw, p = Read(i_t), Read(i_p)
    for _ in range(iters):
        tw = tw - (_call(foeewm, tw) / p - 0.01) * _call(foeldcpm, tw) * 1e-5
    return RAUTO * _call(foeewm, tw) / p


def saturation_chain_program(
    nproma: int = 128, klev: int = 137, iters: int = 3,
) -> Program:
    """A multi-species CLOUDSC saturation→flux chain (`bench_rewrite` gate).

    For each hydrometeor species in :data:`SPECIES`, a banded precipitation
    flux ``PFLUX_<sp>(JK, JL, JM)`` falls down the column — a genuine
    JK-carried recurrence (``lax.scan`` after normalization) whose source
    term :func:`_sat_source` reads only ``(JK, JL)`` fields, i.e. is
    invariant along the species band axis ``JM``.  A final nest folds the
    rain flux into a tendency.

    Without the rewrite passes the wet-bulb chain is recomputed for every
    band element of every species — ``sum(extents) = 14`` evaluations per
    grid point; ``LICMPass`` hoists it into one shared ``(klev, nproma)``
    temp (the reads are never-written inputs, so one temp serves all four
    nests), bit-identically.  XLA cannot recover this on its own: the chain
    reads per-step scan slices and spans four separate while ops.
    """
    body: list[Loop] = []
    arrays = [
        Array("TREF", (klev, nproma)),
        Array("PREF", (klev, nproma)),
        Array("QCOL", (klev, nproma)),
        Array("TEND", (klev, nproma)),
    ]
    temps = ["TEND"]
    for k, (nm, rfall, nb) in enumerate(SPECIES):
        JK, JL, JM = f"JK{k}", f"JL{k}", f"JM{k}"
        P, W = f"PFLUX_{nm}", f"W_{nm}"
        arrays += [Array(P, (klev, nproma, nb)), Array(W, (nb,))]
        temps.append(P)
        A3 = acc(P, JK, JL, JM)
        pfl = Computation(
            f"pfl_{nm}",
            A3,
            (acc(P, aff(JK, const=-1), JL, JM), acc("TREF", JK, JL),
             acc("PREF", JK, JL), acc(W, JM), acc("QCOL", JK, JL)),
            rfall * Read(0) + Read(3) * _sat_source(1, 2, iters) + RAUTO * Read(4),
            guards=(aff(JK, const=-1),),  # JK >= 1
        )
        pfl0 = Computation(
            f"pfl0_{nm}",
            A3,
            (acc("TREF", JK, JL), acc("PREF", JK, JL), acc(W, JM),
             acc("QCOL", JK, JL)),
            Read(2) * _sat_source(0, 1, iters) + RAUTO * Read(3),
            guards=(aff((JK, -1)),),  # JK == 0
        )
        body.append(Loop(JK, klev, body=(Loop(JL, nproma, body=(
            Loop(JM, nb, body=(pfl, pfl0)),)),)))
    dq = Computation(
        "dq",
        acc("TEND", "JKD", "JLD"),
        (acc("QCOL", "JKD", "JLD"),
         acc("PFLUX_rain", "JKD", "JLD", aff(const=0))),
        RG_DT * (Read(0) - Read(1)),
    )
    body.append(Loop("JKD", klev, body=(Loop("JLD", nproma, body=(dq,)),)))
    return Program(
        "saturation_chain", tuple(arrays), tuple(body), temps=tuple(temps))


def saturation_chain_inputs(
    nproma: int = 128, klev: int = 137, seed: int = 0,
) -> dict[str, np.ndarray]:
    """Random physical-range inputs for :func:`saturation_chain_program`."""
    rng = np.random.default_rng(seed)
    out = {
        "TREF": rng.uniform(250.0, 300.0, size=(klev, nproma)),
        "PREF": rng.uniform(5e3, 1e5, size=(klev, nproma)),
        "QCOL": rng.uniform(0.0, 0.02, size=(klev, nproma)),
    }
    for nm, _, nb in SPECIES:
        out[f"W_{nm}"] = rng.uniform(0.2, 1.0, size=(nb,))
    return out


def column_mesh(n_devices: int | None = None, axis: str = "data", device=None):
    """A 1-D mesh over the horizontal-column axis — the paper's NPROMA
    posture: CLOUDSC is embarrassingly parallel over grid columns (JL), so
    the whole scheme data-parallelizes across ``axis`` with zero collectives
    (the JK recurrence stays inside each shard).  ``n_devices`` defaults to
    the world's size when a process group is initialised, else 1 (a mesh of
    one, no process group).  ``device`` as in ``launch.mesh.make_mesh``."""
    import torch.distributed as dist

    from ..launch.mesh import make_mesh

    if n_devices is None:
        live = dist.is_available() and dist.is_initialized()
        n_devices = dist.get_world_size() if live else 1
    return make_mesh((n_devices,), (axis,), device=device)


def compile_scheme(
    nproma: int = 128,
    klev: int = 137,
    mesh=None,
    schedule=None,
    fuse: bool = True,
    device="cuda",
):
    """Normalize + compile the mini scheme, column-sharded when ``mesh`` is
    given.  Returns ``(fn, ProgramPartition | None)``; the partition planner
    discovers the JL column iterator of every canonical nest and shards it
    over the mesh's ``data`` axis (all (klev, nproma) fields split along
    columns, scalar-expanded temporaries along their JL extent).  The default
    schedule is the reference's: torch ops, no kernel.  Without a mesh it
    runs on ``device``, under one on the mesh's device."""
    from ..core.codegen import Schedule, compile_torch
    from ..core.fusion import optimization_pipeline
    from ..core.partition import compile_sharded

    prog = mini_cloudsc_program(nproma, klev)
    norm = optimization_pipeline(fuse=fuse).run(prog)
    sched = schedule if schedule is not None else Schedule(
        mode="canonical", use_idioms=False, scan=True, shard_axis="data")
    if mesh is None:
        return compile_torch(norm, sched, device=device), None
    return compile_sharded(norm, sched, mesh=mesh, axis="data")


def scheme_inputs(nproma: int = 128, klev: int = 137, seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        "PAP": rng.uniform(5e3, 1e5, size=(klev, nproma)),
        "ZTP1": rng.uniform(200.0, 300.0, size=(klev, nproma)),
        "ZQSMIX": rng.uniform(0.0, 0.02, size=(klev, nproma)),
        "ZQL": rng.uniform(0.0, 1e-3, size=(klev, nproma)),
        "ZQI": rng.uniform(0.0, 1e-3, size=(klev, nproma)),
    }
