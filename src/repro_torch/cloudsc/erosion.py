"""CLOUDSC §5.1 — the erosion-of-clouds loop nest (paper Fig. 10a) in the IR.

The nest updates ``ZTP1`` (temperature) and ``ZQSMIX`` (mixed saturation)
over the NPROMA dimension ``JL`` inside the vertical loop ``JK``, computing
several scalar intermediates per point via the IFS thermodynamic functions
FOEEWM / FOEDEM / FOELDCPM.  Constants are the published IFS values.

Memory layout note: the Fortran code accesses ``ZTP1(JL,JK)`` column-major,
so JL is the contiguous dimension.  The row-major IR therefore declares the
arrays ``(KLEV, NPROMA)`` and indexes ``[JK, JL]`` — identical locality.

The scalars (ZQP, ZQSAT, ZCOR, ZCOND, ZCOND1) are genuine 0-d containers;
the normalizer's scalar expansion promotes them to ``_0(JL)`` arrays exactly
as in Fig. 10b, which unlocks maximal fission and JL vectorization.

Port of ``repro/cloudsc/erosion.py``: the same builder; the IFS helpers
evaluate torch tensors instead of jax arrays.
"""
from __future__ import annotations

import numpy as np

from ..core.ir import Array, Call, Computation, Expr, Loop, Program, Read, acc, as_expr, emin

# IFS surrogate constants (physically plausible; ratios match the paper)
RTT = 273.16
R2ES = 611.21 * 0.621981
R3LES, R3IES = 17.502, 22.587
R4LES, R4IES = 32.19, -0.7
RTWAT = RTT
RTICE = RTT - 23.0
RTWAT_RTICE_R = 1.0 / (RTWAT - RTICE)
RETV = 0.608
RCPD = 1004.709
RLVTT, RLSTT = 2.5008e6, 2.8345e6
RALVDCP, RALSDCP = RLVTT / RCPD, RLSTT / RCPD
R5LES = R3LES * (RTT - R4LES)
R5IES = R3IES * (RTT - R4IES)
R5ALVCP = R5LES * RALVDCP
R5ALSCP = R5IES * RALSDCP


def _alpha(t, xp):
    """liquid fraction weight: MIN(1, ((MAX(RTICE,MIN(RTWAT,T))-RTICE)*R)**2)."""
    if xp is np:
        clip = np.maximum(RTICE, np.minimum(RTWAT, t))
        w = ((clip - RTICE) * RTWAT_RTICE_R) ** 2
        return np.minimum(1.0, w)
    clip = t.clamp(RTICE, RTWAT)  # RTICE < RTWAT: max(RTICE, min(RTWAT, t))
    w = ((clip - RTICE) * RTWAT_RTICE_R) ** 2
    return w.clamp(max=1.0)


def _xp(t):
    if isinstance(t, (float, np.floating, np.ndarray)):
        return np
    import torch

    return torch


def foeewm(t):
    xp = _xp(t)
    a = _alpha(t, xp)
    return R2ES * (
        a * xp.exp(R3LES * (t - RTT) / (t - R4LES))
        + (1.0 - a) * xp.exp(R3IES * (t - RTT) / (t - R4IES))
    )


def foedem(t):
    xp = _xp(t)
    a = _alpha(t, xp)
    return a * R5ALVCP * (1.0 / (t - R4LES) ** 2) + (1.0 - a) * R5ALSCP * (
        1.0 / (t - R4IES) ** 2
    )


def foeldcpm(t):
    xp = _xp(t)
    a = _alpha(t, xp)
    return a * RALVDCP + (1.0 - a) * RALSDCP


# Device versions for the Triton nest kernel (``repro_torch.kernels.nest_kernel``
# reads ``device_source``): the same formulas with the constants inlined.
_DEVICE_ALPHA = f"""
@triton.jit
def _ifs_alpha(t):
    clip = tl.minimum(tl.maximum(t, {RTICE!r}), {RTWAT!r})
    w = (clip - {RTICE!r}) * {RTWAT_RTICE_R!r}
    return tl.minimum(w * w, 1.0)
"""
foeewm.device_source = _DEVICE_ALPHA + f"""
@triton.jit
def foeewm(t):
    a = _ifs_alpha(t)
    return {R2ES!r} * (a * tl.exp({R3LES!r} * (t - {RTT!r}) / (t - {R4LES!r}))
                        + (1.0 - a) * tl.exp({R3IES!r} * (t - {RTT!r}) / (t - {R4IES!r})))
"""
foedem.device_source = _DEVICE_ALPHA + f"""
@triton.jit
def foedem(t):
    a = _ifs_alpha(t)
    dl = t - {R4LES!r}
    di = t - {R4IES!r}
    return a * {R5ALVCP!r} * (1.0 / (dl * dl)) + (1.0 - a) * {R5ALSCP!r} * (1.0 / (di * di))
"""
foeldcpm.device_source = _DEVICE_ALPHA + f"""
@triton.jit
def foeldcpm(t):
    a = _ifs_alpha(t)
    return a * {RALVDCP!r} + (1.0 - a) * {RALSDCP!r}
"""


def _ecall(fn, *args) -> Expr:
    """A symbolic ``Call`` node over one of the thermodynamic helpers."""
    return Call(fn.__name__, fn, tuple(as_expr(a) for a in args))


def erosion_program(nproma: int = 128, klev: int = 137, name: str = "cloudsc_erosion") -> Program:
    """The Fig. 10a loop nest: DO JK / DO JL / <scalar chain>."""
    A = lambda n: acc(n, "JK", "JL")  # noqa: E731
    S = lambda n: acc(n)  # 0-d scalar  # noqa: E731

    def comp(nm, write, reads, expr, accumulate=None):
        return Computation(nm, write, tuple(reads), expr, accumulate)

    qs_expr = _ecall(foeewm, Read(0)) * Read(1)
    cor_expr = 1.0 / (1.0 - RETV * Read(0))
    cond_expr = (Read(0) - Read(1)) / (
        1.0 + Read(1) * Read(2) * _ecall(foedem, Read(3)))
    tup_expr = Read(0) + _ecall(foeldcpm, Read(0)) * Read(1)
    body = (
        comp("zqp", S("ZQP"), [A("PAP")], 1.0 / Read(0)),
        # first saturation pass
        comp("qs1", S("ZQSAT"), [A("ZTP1"), S("ZQP")], qs_expr),
        comp("qs1c", S("ZQSAT"), [S("ZQSAT")], emin(0.5, Read(0))),
        comp("cor1", S("ZCOR"), [S("ZQSAT")], cor_expr),
        comp("qs1m", S("ZQSAT"), [S("ZQSAT"), S("ZCOR")], Read(0) * Read(1)),
        comp(
            "cond1",
            S("ZCOND"),
            [A("ZQSMIX"), S("ZQSAT"), S("ZCOR"), A("ZTP1")],
            cond_expr,
        ),
        comp("t1", A("ZTP1"), [A("ZTP1"), S("ZCOND")], tup_expr),
        comp("q1", A("ZQSMIX"), [A("ZQSMIX"), S("ZCOND")], Read(0) - Read(1)),
        # second saturation pass
        comp("qs2", S("ZQSAT"), [A("ZTP1"), S("ZQP")], qs_expr),
        comp("qs2c", S("ZQSAT"), [S("ZQSAT")], emin(0.5, Read(0))),
        comp("cor2", S("ZCOR"), [S("ZQSAT")], cor_expr),
        comp("qs2m", S("ZQSAT"), [S("ZQSAT"), S("ZCOR")], Read(0) * Read(1)),
        comp(
            "cond2",
            S("ZCOND1"),
            [A("ZQSMIX"), S("ZQSAT"), S("ZCOR"), A("ZTP1")],
            cond_expr,
        ),
        comp("t2", A("ZTP1"), [A("ZTP1"), S("ZCOND1")], tup_expr),
        comp("q2", A("ZQSMIX"), [A("ZQSMIX"), S("ZCOND1")], Read(0) - Read(1)),
    )
    nest = Loop("JK", klev, body=(Loop("JL", nproma, body=body),))
    arrays = (
        Array("PAP", (klev, nproma)),
        Array("ZTP1", (klev, nproma)),
        Array("ZQSMIX", (klev, nproma)),
        Array("ZQP", ()),
        Array("ZQSAT", ()),
        Array("ZCOR", ()),
        Array("ZCOND", ()),
        Array("ZCOND1", ()),
    )
    return Program(name, arrays, (nest,),
                   temps=("ZQP", "ZQSAT", "ZCOR", "ZCOND", "ZCOND1"))


def physical_inputs(nproma: int = 128, klev: int = 137, seed: int = 0) -> dict[str, np.ndarray]:
    """Physically plausible fields: T ~ 200-300K, p ~ 5e3-1e5 Pa, q ~ 0-0.02."""
    rng = np.random.default_rng(seed)
    return {
        "PAP": rng.uniform(5e3, 1e5, size=(klev, nproma)),
        "ZTP1": rng.uniform(200.0, 300.0, size=(klev, nproma)),
        "ZQSMIX": rng.uniform(0.0, 0.02, size=(klev, nproma)),
    }
