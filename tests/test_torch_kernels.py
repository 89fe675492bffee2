"""K1 (CUDA GEMM) and K2/K3 (Triton nest kernel) of the port, held against
the reference's Pallas kernels in interpret mode.

On the CPU every wrapper takes its plain version; ``test_torch_card.py``
runs the kernels themselves against those plain versions on a card.  K1's
float32 arithmetic (three TF32 passes over a big/small split) is emulated
here in torch and held against the fp64 product, and its choice of K
splits against the main path's shapes.
"""
import ast
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Schedule as RSchedule
from repro.core import ir as rir
from repro.core import plan_nest_tiling as r_plan
from repro.kernels import nest_kernel as r_nest
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.gemm import gemm as r_gemm
from repro_torch.core import Daisy, Schedule, compile_torch, execute_numpy
from repro_torch.core import codegen
from repro_torch.core import ir as pir
from repro_torch.core import plan_nest_tiling as p_plan
from repro_torch.core.scheduler import random_inputs
from repro_torch.core.tiling import TilingError
from repro_torch.kernels import gemm as p_gemm
from repro_torch.kernels import moe_gmm as p_gmm
from repro_torch.kernels import nest_kernel as p_nest
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import rmsnorm as p_rms
from test_torch_card import (CASES, accumulate, broadcast_update, fill, guarded_forward,
                             guarded_then_accumulated, halo_write, pointwise, reduce_op, stencil,
                             syrk1, triangle)

torch.set_num_threads(1)
RNG = np.random.default_rng(42)
MAX_REL = 2e-4  # fp32 kernels (tests/test_kernels.py)


def max_rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / max(1e-30, np.abs(ref).max()))


# ---------------------------------------------------------------------------
# K1: GEMM and einsum2
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,n,k", [(16, 16, 16), (100, 52, 36), (128, 256, 64),
                                   (33, 17, 9), (8, 8, 200)])
def test_gemm_fp32_matches_reference(m, n, k):
    x = RNG.normal(size=(m, k)).astype(np.float32)
    y = RNG.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(r_gemm(x, y, block_m=32, block_n=32, block_k=32, interpret=True))
    got = p_gemm.gemm(torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert max_rel(got.numpy(), want) < MAX_REL
    assert max_rel(got.numpy(), x.astype(np.float64) @ y) < MAX_REL


def test_gemm_bf16_matches_reference():
    x = RNG.normal(size=(64, 48)).astype(np.float32)
    y = RNG.normal(size=(48, 32)).astype(np.float32)
    xb, yb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16)
    want = np.asarray(r_gemm(xb, yb, block_m=32, block_n=32, block_k=16, interpret=True),
                      np.float32)
    got = p_gemm.gemm(torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-1)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(r_ref.matmul(xb, yb), np.float32),
                               rtol=5e-2, atol=5e-1)


# K1's float32 kernel on the tensor cores: error-compensated TF32 ("3xTF32"),
# emulated here in torch.  cvt.rna.tf32.f32 keeps 10 mantissa bits, rounding
# the magnitude to nearest, ties away from zero: add half a unit of the 13 bits
# it drops to the int32 pattern and clear them (``round_bits``; right for every
# value but NaN, whose payload the addition can carry into the exponent or the
# sign).  Products of TF32 values are exact in fp32, so an fp32 matmul of the
# split operands stands for the tensor cores' passes (up to the order of the
# fp32 sums).
TF32_NAN = 0x7FFFE000  # csrc/gemm.cu: a NaN's big


def round_bits(a: torch.Tensor) -> torch.Tensor:
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32(a: torch.Tensor) -> torch.Tensor:
    nan = torch.tensor(TF32_NAN, dtype=torch.int32).view(torch.float32)
    return torch.where(torch.isnan(a), nan, round_bits(a))


def split_tf32(a: torch.Tensor):
    """(big, small, cross) as csrc/gemm.cu's split_tf32 makes them."""
    big = tf32(a)
    d = a - big
    finite = d.abs() <= torch.finfo(torch.float32).max
    return big, tf32(torch.where(finite, d, 0.0)), torch.where(finite, big, 0.0)


def three_tf32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    (xb, xs, xc), (yb, ys, yc) = split_tf32(x), split_tf32(y)
    return xs @ yc + xc @ ys + xb @ yb


def polybench_like(m, n):
    i, j = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    return ((i * j % n) / n).astype(np.float32)


# chip_smoke.py's check_gemm fp32 shapes and the main path's (PolyBench LARGE
# gemm, 2mm, 3mm, doitgen)
THREE_TF32_SHAPES = [(16, 16, 16), (100, 52, 36), (128, 256, 64), (33, 17, 9), (8, 8, 200),
                     (1000, 1100, 1200), (800, 900, 1100), (800, 1200, 900), (800, 900, 1000),
                     (900, 1100, 1200), (800, 1100, 900), (21000, 160, 160)]


@pytest.mark.parametrize("data", ["randn", "polybench"])
@pytest.mark.parametrize("m,n,k", THREE_TF32_SHAPES)
def test_three_tf32_passes_meet_the_fp32_limit(m, n, k, data):
    rng = np.random.default_rng(m * n + k)
    if data == "randn":
        x, y = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    else:
        x, y = polybench_like(m, k), polybench_like(k, n)
    x, y = torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y.astype(np.float32))
    want = x.double() @ y.double()
    assert max_rel(three_tf32(x, y).numpy(), want.numpy()) <= MAX_REL / 100


def test_one_tf32_pass_misses_the_fp32_limit():
    """The limit tells one pass from three: big.big alone exceeds 2e-4 at
    the LARGE gemm on randn inputs."""
    rng = np.random.default_rng(1000 * 1100 + 1200)
    x = torch.from_numpy(rng.standard_normal((1000, 1200)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1200, 1100)).astype(np.float32))
    want = (x.double() @ y.double()).numpy()
    assert max_rel((tf32(x) @ tf32(y)).numpy(), want) > MAX_REL
    assert max_rel(three_tf32(x, y).numpy(), want) <= MAX_REL / 100


def test_three_tf32_passes_keep_an_inf():
    """An inf in x gives the fp32 product's inf, not NaN, also against y
    values that are exact in TF32 (small part 0): the inf's cross is 0."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (40, 24)).astype(np.float32))
    y = torch.from_numpy((rng.integers(1, 9, (24, 30)) / 4).astype(np.float32))
    x[3, 5], x[7, 0] = float("inf"), -float("inf")
    want = x @ y
    got = three_tf32(x, y)
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert bool(torch.isposinf(got[3]).all()) and not bool(torch.isnan(got).any())
    finite = torch.isfinite(want)
    assert max_rel(got[finite].numpy(), want[finite].numpy()) < MAX_REL
    xb, xs, _ = split_tf32(x)  # with big in the cross terms, inf * 0 makes NaN
    yb, ys, _ = split_tf32(y)
    assert bool(torch.isnan(xs @ yb + xb @ ys + xb @ yb).any())


# NaN bit patterns: the one CUDA's arithmetic makes, its negative, and one
# whose payload lies only in the 13 bits that TF32 drops
NAN_BITS = [0x7FFFFFFF, -1, 0x7F800001]


@pytest.mark.parametrize("bits", NAN_BITS)
def test_three_tf32_passes_keep_a_nan(bits):
    """A NaN in x gives its row NaN and leaves the rest of the product
    within the limit, for every NaN pattern; rounding its bits as a finite
    value's would lose it (0x7FFFFFFF becomes -0, -1 becomes +0, 0x7F800001
    becomes inf)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.uniform(0.5, 1.5, (40, 24)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((24, 30)).astype(np.float32))
    x.view(torch.int32)[3, 5] = bits
    assert bool(torch.isnan(x[3, 5]))
    got = three_tf32(x, y)
    assert bool(torch.isnan(got[3]).all())
    rest = torch.ones(40, dtype=torch.bool)
    rest[3] = False
    assert bool(torch.isfinite(got[rest]).all())
    want = x.double() @ y.double()
    assert max_rel(got[rest].numpy(), want[rest].numpy()) <= MAX_REL / 100
    assert not bool(torch.isnan(round_bits(x[3:4, 5:6])).any())


@pytest.mark.parametrize("m,n,k,want", [
    (1000, 1100, 1200, 4), (800, 1200, 900, 4), (900, 1100, 1200, 4),  # 144 or 133 tiles
    (800, 900, 1100, 1), (800, 900, 1000, 1), (800, 1100, 900, 1),    # 105-126 tiles
    (21000, 160, 160, 1), (8, 8, 200, 1), (64, 64, 4096, 4), (33, 17, 9, 1), (10, 10, 0, 1)])
def test_gemm_splits_at_the_main_path_shapes(m, n, k, want):
    """K splits on a 132-SM H100: where 144 tiles would load 12 SMs with two
    and the rest with one, 4 ranges; where the tiles fit the card once, or K
    is short (doitgen's 160 is 5 slices), none."""
    assert p_gemm.gemm_splits(1, m, n, k, 132) == want
    if want > 1:
        assert -(-k // p_gemm.SLICE_K) >= want * p_gemm.MIN_SLICES


@pytest.mark.parametrize("dtype,m,n,k,aligned,want", [
    (torch.float32, 1000, 1100, 1200, True, "tf32x3"),   # fp32, whatever the shape
    (torch.float32, 37, 70, 1, False, "tf32x3"),
    (torch.bfloat16, 2048, 4096, 4096, True, "wgmma"),   # LLaVA's q_proj
    (torch.bfloat16, 2048, 14336, 4096, True, "wgmma"),  # and ffn_in
    (torch.bfloat16, 32, 8, 8, True, "wgmma"),           # the smallest M it takes
    (torch.bfloat16, 31, 72, 40, True, "decode"),        # M < 32
    (torch.bfloat16, 1, 8, 8, True, "decode"),
    (torch.bfloat16, 1000, 1100, 1200, True, "mma"),     # LARGE: N % 8 == 4
    (torch.bfloat16, 300, 264, 130, True, "mma"),        # K % 8 == 2
    (torch.bfloat16, 37, 70, 1, True, "mma"),            # K = 1
    (torch.bfloat16, 64, 32, 0, True, "mma"),            # K = 0: zeros, masked
    (torch.bfloat16, 2048, 4096, 4096, False, "mma"),    # an unaligned view
    (torch.bfloat16, 16, 256, 512, False, "mma"),
])
def test_gemm_kernel_choice(dtype, m, n, k, aligned, want):
    """K1's kernel, decided before launch from the dtype, M, N, K and the
    operands' alignment: the wgmma/TMA kernel takes what TMA can address
    (K and N multiples of 8, 16-byte aligned) from M = 32, the decode kernel
    the same below it, the mma.sync kernel every other bf16 shape."""
    assert p_gemm.choose_kernel(dtype, m, n, k, aligned) == want
    assert p_gemm.WGMMA_MIN_M == p_gmm.WGMMA_MIN_C
    if want != "tf32x3":  # the same line K6 draws at E = 1
        assert p_gmm.choose_kernel(dtype, m, k, n, aligned) == (want if k else "mma")


def test_gemm_launch_refuses_cpu_tensors_and_unknown_kernels():
    x, y = torch.ones(40, 16, dtype=torch.bfloat16), torch.ones(16, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        p_gemm._launch("wgmma", x, y)  # the plain version is gemm's, for CPU tensors only
    with pytest.raises(ValueError):
        p_gemm._launch("simt", x, y)
    before = dict(p_gemm.PATHS), p_gemm.PLAIN["gemm"]
    p_gemm.gemm(x, y)
    assert (dict(p_gemm.PATHS), p_gemm.PLAIN["gemm"]) == (before[0], before[1] + 1)


def test_einsum2_contraction_patterns():
    a = RNG.normal(size=(24, 12)).astype(np.float32)
    b = RNG.normal(size=(12, 30)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for sa, sb, so, bb in [("ab", "bc", "ac", b), ("ab", "cb", "ca", b.T.copy())]:
        want = np.asarray(r_ops.einsum2(sa, sb, so, jnp.asarray(a), jnp.asarray(bb),
                                        tile=(16, 16, 16)))
        got = p_ops.einsum2(sa, sb, so, ta, torch.from_numpy(bb))
        assert max_rel(got.numpy(), want) < MAX_REL
    with pytest.raises(ValueError):
        r_ops.einsum2("ab", "bc", "abc", jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError):
        p_ops.einsum2("ab", "bc", "abc", ta, tb)  # batch letter


@pytest.mark.parametrize("subs,ok", [
    (("ab", "bc", "ac"), True), (("abc", "cd", "abd"), True), (("ij", "j", "i"), True),
    (("ab", "bc", "abc"), False), (("ab", "cd", "abcd"), False), (("abd", "bc", "ac"), False),
    (("aa", "ab", "b"), False),
])
def test_einsum2_classifier(subs, ok):
    assert (p_ops.einsum2_reject_reason(*subs) is None) == ok


def test_einsum2_batched_contraction_is_routed_before_launch():
    """A contraction the classifier rejects goes to torch.einsum, counted."""
    i, j, k = "i", "j", "k"
    mac = pir.Computation("m", pir.acc("C", i, j), (pir.acc("A", i, k), pir.acc("B", i, j, k)),
                          pir.Read(0) * pir.Read(1), accumulate="+")
    prog = pir.Program("batched", (pir.Array("A", (5, 6)), pir.Array("B", (5, 4, 6)),
                                   pir.Array("C", (5, 4))),
                       (pir.Loop(i, 5, body=(pir.Loop(j, 4, body=(pir.Loop(k, 6, body=(mac,)),)),)),))
    inp = random_inputs(prog, seed=1, dtype=np.float64)
    before_routed = sum(v for r, v in codegen.ROUTED.items() if r.startswith("einsum2"))
    before_plain = p_gemm.PLAIN["gemm"]
    out = compile_torch(prog, Schedule(pallas_gemm=True), device="cpu")(inp)
    assert sum(v for r, v in codegen.ROUTED.items() if r.startswith("einsum2")) == before_routed + 1
    assert p_gemm.PLAIN["gemm"] == before_plain
    assert max_rel(out["C"].numpy(), execute_numpy(prog, inp)["C"]) < 1e-5


# ---------------------------------------------------------------------------
# K2/K3: the nest kernel, on tests/test_tiling.py's edge cases (CASES) and on
# the cases where K2's old content decides the result (K2_REF_CASES)
# ---------------------------------------------------------------------------
K2_REF_CASES = [
    (f"{label}-{tile}", build, dict(pallas_nest=True, nest_tile=tile))
    for label, build, tiles in [
        ("pointwise", lambda ir: pointwise(ir, 9, 13), [None, (4, 8)]),
        ("fill", lambda ir: fill(ir, 9, 13), [None]),
        ("accumulate", lambda ir: accumulate(ir, 9, 13), [None, (4, 8)]),
        ("guarded-accumulate", lambda ir: accumulate(ir, 9, 13, True), [(4, 8)]),
        ("guarded-forward", lambda ir: guarded_forward(ir, 9, 13), [(4, 8)]),
        ("halo-write", lambda ir: halo_write(ir, 9, 13, rows=8), [(4, 8), (3, 5)]),
        ("guarded-then-accumulated", lambda ir: guarded_then_accumulated(ir, 9, 13), [(4, 8)]),
        ("broadcast-update", lambda ir: broadcast_update(ir, 9, 13), [None, (4, 8)]),
    ]
    for tile in tiles
]


@pytest.mark.parametrize("label,build,knobs", CASES + K2_REF_CASES,
                         ids=[c[0] for c in CASES + K2_REF_CASES])
def test_emit_nest_matches_reference(label, build, knobs):
    rprog, pprog = build(rir), build(pir)
    inp = random_inputs(pprog, seed=4, dtype=np.float64)
    want = r_nest.emit_nest(rprog, rprog.body[0],
                            {k: jnp.asarray(v, jnp.float32) for k, v in inp.items()},
                            RSchedule(mode="canonical", use_idioms=False, **knobs))
    env = {k: torch.tensor(v, dtype=torch.float32) for k, v in inp.items()}
    before = dict(p_nest.PLAIN)
    p_nest.emit_nest(pprog, pprog.body[0], env, Schedule(use_idioms=False, **knobs))
    kind = "pallas_reduce" if knobs.get("pallas_reduce") else "pallas_nest"
    assert p_nest.PLAIN[kind] == before[kind] + 1
    oracle = execute_numpy(pprog, inp)
    for name in inp:
        assert max_rel(env[name].numpy(), np.asarray(want[name])) < MAX_REL, name
        assert max_rel(env[name].numpy(), oracle[name]) < MAX_REL, name
    if label == "stencil-(4, 8)":  # untouched boundary rows keep their content
        np.testing.assert_array_equal(env["B"].numpy()[0], inp["B"][0].astype(np.float32))


@pytest.mark.parametrize("tile", [(4, 8), (3, 5)])
def test_halo_write_out_of_the_array_matches_reference(tile):
    """``B[i+1][j]`` for every row ``i`` of B, read back by ``C[i][j]``: on
    the row past B the slab forwards the new value, as the reference's
    does, so C matches the reference everywhere.  B's stored rows do not:
    the reference writes its output view back with
    ``lax.dynamic_update_slice``, which clamps a view that runs past the
    array, and stores B shifted by a row; the port stores B[1:] only (the
    sequential semantics stop at the write outside B)."""
    rprog, pprog = halo_write(rir, 9, 13), halo_write(pir, 9, 13)
    inp = random_inputs(pprog, seed=4, dtype=np.float64)
    want = r_nest.emit_nest(rprog, rprog.body[0],
                            {k: jnp.asarray(v, jnp.float32) for k, v in inp.items()},
                            RSchedule(mode="canonical", use_idioms=False, pallas_nest=True,
                                      nest_tile=tile))
    env = {k: torch.tensor(v, dtype=torch.float32) for k, v in inp.items()}
    p_nest.emit_nest(pprog, pprog.body[0], env, Schedule(use_idioms=False, pallas_nest=True,
                                                         nest_tile=tile))
    a, b = inp["A"].astype(np.float32), inp["B"].astype(np.float32)
    for name in ("A", "C"):
        assert max_rel(env[name].numpy(), np.asarray(want[name])) < MAX_REL, name
    np.testing.assert_allclose(env["C"].numpy()[-1], 3.0 * a[-1], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(want["B"]), 2.0 * a, rtol=1e-6)  # shifted
    np.testing.assert_array_equal(env["B"].numpy()[0], b[0])
    np.testing.assert_allclose(env["B"].numpy()[1:], 2.0 * a[:-1], rtol=1e-6)
    with pytest.raises(IndexError):
        execute_numpy(pprog, inp)


@pytest.mark.parametrize("build,tile", [
    (lambda ir: stencil(ir, 10), (4, 8)), (lambda ir: stencil(ir, 10), (3, 3)),
    (lambda ir: triangle(ir, 11), (4, 4)), (lambda ir: syrk1(ir, 9, 16), (4, 4, 8)),
    (lambda ir: reduce_op(ir, "+"), (4, 8)),
])
def test_tile_plan_roles_and_halos_match_reference(build, tile):
    rprog, pprog = build(rir), build(pir)
    rp = r_plan(rprog, rprog.body[0], tile=tile)
    pp = p_plan(pprog, pprog.body[0], tile=tile)
    roles = lambda plan: [(a.name, a.start, a.stop, a.tile, a.role) for a in plan.axes]  # noqa: E731
    assert (pp.kind, roles(pp), pp.grid, pp.halo) == (rp.kind, roles(rp), rp.grid, rp.halo)
    for a in pp.axes:  # Triton blocks: the tile rounded up to a power of two
        assert a.block >= a.tile and a.block & (a.block - 1) == 0


def test_opaque_callable_is_outside_the_tiled_class():
    """A lambda cannot be generated: TilingError at plan time, counted, and
    the nest runs through the generic lowering."""
    sc = pir.Computation("sc", pir.acc("C", "i", "j"), (pir.acc("C", "i", "j"),), lambda c: c * 3.0)
    prog = pir.Program("lam", (pir.Array("C", (6, 7)),),
                       (pir.Loop("i", 6, body=(pir.Loop("j", 7, body=(sc,)),)),))
    with pytest.raises(TilingError, match="opaque"):
        p_nest.plan_nest(prog, prog.body[0], Schedule(pallas_nest=True))
    routed = sum(v for r, v in codegen.ROUTED.items() if "opaque" in r)
    inp = random_inputs(prog, seed=2, dtype=np.float64)
    out = compile_torch(prog, Schedule(pallas_nest=True), device="cpu")(inp)
    assert sum(v for r, v in codegen.ROUTED.items() if "opaque" in r) == routed + 1
    np.testing.assert_allclose(out["C"].numpy(), 3.0 * inp["C"], rtol=1e-6)


def _eligible_nests():
    from repro_torch.cloudsc import erosion_program, mini_cloudsc_program, saturation_chain_program
    from repro_torch.polybench import BENCHMARKS, NAMES

    progs = [BENCHMARKS[n].make(v, "mini") for n in NAMES for v in ("a", "b", "np")]
    progs += [erosion_program(8, 6), mini_cloudsc_program(8, 6), saturation_chain_program(8, 6)]
    d = Daisy(backend="torch", device="cpu")
    out = []
    for prog in progs:
        norm = d.plan(prog).program
        for nest in norm.body:
            try:
                out.append(p_nest.plan_nest(norm, nest, Schedule(pallas_nest=True, pallas_reduce=True,
                                                                 unroll=2)))
            except TilingError:
                pass
    return out


def test_generated_triton_source_parses_for_every_eligible_nest():
    """Every nest's kernel source, and every reduction's split form
    (``nest_split``: partials, and their combine by the last to arrive)."""
    kernels = _eligible_nests()
    kinds = {nk.kind for nk in kernels}
    assert kinds == {"pallas_nest", "pallas_reduce"} and len(kernels) > 60
    calls = splits = 0
    for nk in kernels:
        sources = {"source": ("nest_kernel",)}
        if nk.kind == "pallas_reduce":
            sources["split_source"] = ("nest_split",)
        else:
            with pytest.raises(ValueError):
                nk.split_source
            # K2: the flattened form's constexprs; its branch only in a
            # pointwise nest (tests/test_torch_nest_kernel.py)
            fn = next(f for f in ast.parse(nk.source).body
                      if isinstance(f, ast.FunctionDef) and f.name == "nest_kernel")
            assert [a.arg for a in fn.args.args][-2:] == ["FLAT", "BLOCK"]
            assert ("if FLAT:" in nk.source) == nk.flat
        for attr, entries in sources.items():
            tree = ast.parse(getattr(nk, attr))
            fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
            assert all(e in fns for e in entries)
            assert all(any(ast.unparse(d) == "triton.jit" for d in f.decorator_list)
                       for f in fns.values())
            calls += any(name in fns for name in ("foeewm", "foedem", "foeldcpm", "finish_std"))
        if nk.kind == "pallas_reduce":
            splits += 1
            fns = {f.name: f for f in ast.parse(nk.split_source).body
                   if isinstance(f, ast.FunctionDef)}
            assert [a.arg for a in fns["nest_split"].args.args][-3:] == ["ws", "cnt", "per"]
            # the arrival counter is the only atomic: partials combine in a fixed order
            assert re.findall(r"atomic_\w+\(([^,]*),", nk.split_source) == ["cnt + prog"] * 2
    assert calls >= 3  # CLOUDSC thermodynamics and correlation's finish_std, split or not
    assert splits > 20


# ---------------------------------------------------------------------------
# K3's split form: its launch geometry (a pure function of the plan and the
# SM count) and its generated source
# ---------------------------------------------------------------------------
H100_SMS = 132
# PolyBench/C 4.2.1 LARGE_DATASET of the benchmarks whose reductions K3 runs
LARGE = {"atax": dict(m=1900, n=2100), "bicg": dict(n=2100, m=1900), "gemver": dict(n=2000),
         "gesummv": dict(n=1300), "correlation": dict(m=1200, n=1400),
         "covariance": dict(m=1200, n=1400), "syrk": dict(n=1200, m=1000),
         "syr2k": dict(n=1200, m=1000)}
# reductions whose parallel tiles alone are too few programs (matrix-vector
# products, the means and deviations), and those that fill the card already
SPLIT_NESTS = {"atax": {"t1", "t2"}, "bicg": {"cs", "cq"}, "gemver": {"x_up", "w_up"},
               "gesummv": {"ct", "cy"}, "correlation": {"sm", "ss"}, "covariance": {"sm"}}
FULL_NESTS = {"syrk": {"mac"}, "syr2k": {"mac1", "mac2"}, "correlation": {"cc"},
              "covariance": {"cc"}}


def _large_reductions(name):
    """{computation: planned kernel} of the A variant's reduction nests at
    LARGE, planned as the main path plans them (default tiles)."""
    from repro_torch.polybench import BENCHMARKS

    norm = Daisy(backend="torch", device="cpu").plan(
        BENCHMARKS[name].variants["a"](LARGE[name])).program
    out = {}
    for nest in norm.body:
        try:
            nk = p_nest.plan_nest(norm, nest, Schedule(pallas_nest=True, pallas_reduce=True))
        except TilingError:
            continue
        if nk.plan.kind == "reduce":
            out[nk.plan.comps[0].name] = nk
    return out


@pytest.mark.parametrize("name", sorted(SPLIT_NESTS))
def test_reduce_splits_fill_an_h100_at_large_matrix_vector_nests(name):
    nests = _large_reductions(name)
    for comp in SPLIT_NESTS[name]:
        plan = nests[comp].plan
        programs = int(np.prod([a.n_tiles for a in plan.parallel]))
        splits = p_nest.reduce_splits(plan, H100_SMS)
        assert 19 <= programs <= 33 and splits > 1, (comp, programs, splits)
        assert programs * splits >= p_nest.PROGRAMS_PER_SM * H100_SMS, (comp, programs, splits)
        per = p_nest.split_tiles(plan, splits)
        assert -(-plan.reduce_grid.n_tiles // per) == splits  # no empty range
        # loads stay wide: the tiles of the plan are the reference's, 64 lanes
        assert all(a.tile == 64 for a in plan.axes), comp


@pytest.mark.parametrize("name", sorted(FULL_NESTS))
def test_reduce_splits_leave_the_3d_products_alone(name):
    nests = _large_reductions(name)
    for comp in FULL_NESTS[name]:
        plan = nests[comp].plan
        assert int(np.prod([a.n_tiles for a in plan.parallel])) == 22800
        assert p_nest.reduce_splits(plan, H100_SMS) == 1


@pytest.mark.parametrize("n,m,sms", [(64, 4096, 132), (1900, 2100, 132), (1900, 2100, 16),
                                     (10, 12, 132), (4096, 64, 132), (8, 8, 132),
                                     (640, 900, 8), (64, 4096, 1), (300, 20000, 132)])
def test_reduce_splits_rule(n, m, sms):
    """A pure function of the plan and the SM count: no split once the
    parallel tiles give two programs per SM or there is one reduction tile;
    otherwise at least two programs per SM where the reduction tiles allow,
    in contiguous non-empty ranges."""
    prog = reduce_op(pir, "+", n, m)
    plan = p_plan(prog, prog.body[0])
    programs = int(np.prod([a.n_tiles for a in plan.parallel]))
    tiles = plan.reduce_grid.n_tiles
    splits = p_nest.reduce_splits(plan, sms)
    assert splits == p_nest.reduce_splits(plan, sms)
    assert 1 <= splits <= tiles
    if programs >= 2 * sms or tiles == 1:
        assert splits == 1
    else:
        assert programs * splits >= min(2 * sms, programs * tiles)
        per = p_nest.split_tiles(plan, splits)
        assert (splits - 1) * per < tiles <= splits * per


# ---------------------------------------------------------------------------
# K4-bwd's launch plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,rows,d,aligned,want", [
    # MiniCPM's microbatch: three warps a row (288 chunks, 3 a thread), five
    # rows a block, one block an SM: 132 partial rows (528 before)
    (torch.bfloat16, 8192, 2304, True, ("vec", 96, 3, 5, 132)),
    (torch.bfloat16, 2048, 3840, True, ("vec", 128, 4, 4, 132)),
    (torch.bfloat16, 2048, 4096, True, ("vec", 128, 4, 4, 132)),
    (torch.bfloat16, 2048, 8192, True, ("vec", 256, 4, 2, 132)),
    (torch.bfloat16, 2048, 1024, True, ("vec", 32, 4, 16, 128)),  # one warp a row, no barrier
    (torch.float32, 8192, 2304, True, ("vec", 160, 4, 3, 132)),
    (torch.float32, 2048, 8192, True, ("vec", 512, 4, 1, 132)),
    (torch.bfloat16, 300, 40, True, ("vec", 32, 1, 16, 19)),      # rows not a multiple of 16
    (torch.float32, 300, 100, True, ("vec", 32, 1, 16, 19)),
    (torch.bfloat16, 7, 2304, True, ("vec", 96, 3, 5, 2)),
    (torch.bfloat16, 300, 100, True, ("loop", 0, 0, 1, 300)),     # 100 bf16: off the chunk
    (torch.bfloat16, 8192, 2304, False, ("loop", 0, 0, 1, 528)),  # an unaligned view
    (torch.float32, 300, 42, True, ("loop", 0, 0, 1, 300)),
])
def test_rmsnorm_bwd_plan(dtype, rows, d, aligned, want):
    """K4-bwd's route, row groups and grid on a 132-SM H100, decided before
    launch: the vector kernel at the model widths (at most one block an SM,
    so at most 132 partial dgamma rows), the loop kernel off the 16-byte
    chunk or off 16-byte alignment (4 blocks an SM, at most a row each)."""
    plan = p_rms.bwd_plan(dtype, rows, d, aligned, 132)
    assert tuple(plan) == want
    if plan.route == "vec":
        per_chunk = 16 // dtype.itemsize
        assert plan.group % 32 == 0 and plan.slots * plan.group <= p_rms.BWD_BLOCK
        assert plan.group * plan.chunks * per_chunk >= d          # the row fits a group
        assert plan.chunks <= p_rms.BWD_CHUNKS
        assert plan.group == 32 or plan.slots <= 15               # named barriers 1..15
        assert (plan.blocks - 1) * plan.slots < rows <= plan.blocks * plan.slots \
            or plan.blocks == 132
