"""The port's kernels on a card, each against its plain version, and the
model stack's main path on the card against the fp32 plain forward.

Needs an NVIDIA card and imports nothing of jax, so it runs on a machine
with the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_card.py``.  Without a card every test skips (decided in a
fixture).  K1 runs at ragged M, N and K (K = 1, 7, 9, 200), with K split
into ranges (bit-identical run to run), with an inf or a NaN operand, and batched
through K6's float32 path; in bf16 through each of its kernels (wgmma, decode,
mma) as ``choose_kernel`` picks them, at ragged and unaligned shapes;
``test_torch_kernels.py`` holds its 3xTF32
arithmetic against fp64 in an emulation on the CPU.  The nest-kernel cases
are tests/test_tiling.py's edge cases, built from the port's IR, plus K3's
split form at every split count of a reduction with each op, with and
without a guard; ``test_torch_kernels.py`` runs the same cases through the
plain versions against the reference on the CPU.  K2's forms (``K2_CASES``)
run where the old content is elided and where it is kept (an accumulate, a
guard then a slab read), on a halo write out of the array, flattened (rows
not a multiple of 16; a range that its blocks divide and one they do not)
and tiled (tiles that divide the extent and ragged ones), and one planned
nest again on other strides;
``test_torch_nest_kernel.py`` holds their generated source on the CPU.  The K4/K5 cases are
tests/test_kernels.py's sweeps plus the head sizes the configs use (K4 also
at the decode rows, past its registers and off 16-byte alignment), K5
through each of its three kernels (``_launch``: the tensor-core kernel in
bf16, the SIMT kernel in fp32 and bf16, the split-KV decode kernel in bf16
at decode shapes: ragged slots, a slot at offset 0, one past the cache and
one with no key, a window, groups 1-16, several chunk sizes, bit-identical
over repeated launches); ``test_torch_model_kernels.py`` holds the plain
versions against the reference on the CPU; K5 also at Seamless's
cross-attention shapes (D = 64, group 1, non-causal over a longer memory, a
decode step at offset 0).  ``ops.matmul`` launches K1; the reduced vlm,
audio, hybrid and ssm models run ``forward`` and the engine on the card.  K6 runs at ragged shapes and at
each of its tile heights (C up to 32, up to 64, above), with and without
16-byte loads, each bf16 kernel (wgmma/TMA and mma.sync) named through
``_launch`` at ragged C, D and F with E = 3, the decode kernel at the decode
step's and warm-up's shapes and ragged small ones, unsplit and split (bit-
identical, the arrival counters back at zero), and the wrapper's routing of
buckets, decode steps and misaligned views; ``test_torch_moe.py`` holds its
plain versions against the reference.  The evolutionary search's
``measure_recipe`` times a K2 and a K3 nest on the card, and ``seed_nest``
seeds a mini program's nests there; ``test_torch_search.py`` holds the
search against the reference on the CPU.  Two ranks spawned on the card
(their collectives on gloo) run the column-sharded mini scheme,
bit-identical to the unsharded card run; ``test_torch_partition_world.py``
holds the sharded executor on the CPU.  Two ranks on the card serve the
reduced Danube and Mixtral over mesh (data 1, model 2) with the tokens of
the unsharded engine, and a row-parallel partial of bf16 operands leaves
its GEMM in fp32 (``-k sharded_engine``); ``test_torch_sharded_serve.py``
holds the sharded engine against the reference on the CPU.  The
row-parallel product's backward runs on the card, and two ranks on the card
take the reduced bf16 model's gradient with block remat (its recompute on
autograd's thread) as the unsharded model does (``-k sharded_train``);
``test_torch_sharded_train*.py`` hold sharded training on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Schedule
from repro_torch.core import ir as pir
from repro_torch.core.scheduler import random_inputs
from repro_torch.kernels import flash_attention as p_flash
from repro_torch.kernels import gemm as p_gemm
from repro_torch.kernels import moe_gmm as p_gmm
from repro_torch.kernels import nest_kernel as p_nest
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rmsnorm as p_rms

torch.set_num_threads(1)
MAX_REL = 2e-4  # fp32 kernels (tests/test_kernels.py)


def max_rel(out, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(out, np.float64) - ref).max() / max(1e-30, np.abs(ref).max()))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest -m cuda` on one")
    return torch.device("cuda")


def stencil(ir, n):
    R, acc, aff = ir.Read, ir.acc, ir.aff
    st = ir.Computation(
        "st", acc("B", "i", "j"),
        (acc("A", "i", "j"), acc("A", aff("i", const=-1), "j"), acc("A", aff("i", const=1), "j"),
         acc("A", "i", aff("j", const=-1)), acc("A", "i", aff("j", const=1))),
        R(0) + 0.2 * (R(1) + R(2) + R(3) + R(4)))
    return ir.Program("stencil", (ir.Array("A", (n, n)), ir.Array("B", (n, n))),
                      (ir.Loop("i", n - 1, start=1, body=(ir.Loop("j", n - 1, start=1, body=(st,)),)),))


def triangle(ir, n):
    sc = ir.Computation("sc", ir.acc("C", "i", "j"), (ir.acc("C", "i", "j"),),
                        ir.Read(0) * 3.0, guards=(ir.aff("i", ("j", -1)),))
    return ir.Program("tri", (ir.Array("C", (n, n)),),
                      (ir.Loop("i", n, body=(ir.Loop("j", n, body=(sc,)),)),))


def syrk1(ir, n, m):
    mac = ir.Computation("mac", ir.acc("C", "i", "j"), (ir.acc("A", "i", "k"), ir.acc("A", "j", "k")),
                         ir.Read(0) * ir.Read(1), accumulate="+", guards=(ir.aff("i", ("j", -1)),))
    return ir.Program("syrk1", (ir.Array("A", (n, m)), ir.Array("C", (n, n))),
                      (ir.Loop("i", n, body=(ir.Loop("j", n, body=(ir.Loop("k", m, body=(mac,)),)),)),))


def reduce_op(ir, op, n=10, m=12):
    c = ir.Computation("r", ir.acc("y", "i"), (ir.acc("A", "i", "k"), ir.acc("w", "k")),
                       ir.Read(0) * ir.Read(1) + 0.25, accumulate=op)
    return ir.Program(f"reduce{op}", (ir.Array("A", (n, m)), ir.Array("w", (m,)), ir.Array("y", (n,))),
                      (ir.Loop("i", n, body=(ir.Loop("k", m, body=(c,)),)),))


def guarded_reduce_op(ir, op, n, m):
    """``reduce_op`` under the guard ``k >= i``: masked lanes of every split
    must contribute the neutral element."""
    c = ir.Computation("r", ir.acc("y", "i"), (ir.acc("A", "i", "k"), ir.acc("w", "k")),
                       ir.Read(0) * ir.Read(1) + 0.25, accumulate=op,
                       guards=(ir.aff("k", ("i", -1)),))
    return ir.Program(f"greduce{op}", (ir.Array("A", (n, m)), ir.Array("w", (m,)),
                                       ir.Array("y", (n,))),
                      (ir.Loop("i", n, body=(ir.Loop("k", m, body=(c,)),)),))



def pointwise(ir, n, m):
    """A pointwise nest of three computations over arrays of its own shape
    (the mini CLOUDSC scheme's form): a temporary written first, an update
    that reads its own write index, and a read of both from the slab."""
    R, acc = ir.Read, ir.acc
    ij = ("i", "j")
    comps = (
        ir.Computation("t", acc("T", *ij), (acc("A", *ij),), R(0) * 2.0),
        ir.Computation("b", acc("B", *ij), (acc("B", *ij), acc("T", *ij), acc("A", *ij)),
                       R(0) + R(1) / (R(2) * R(2) + 1.5)),
        ir.Computation("c", acc("C", *ij), (acc("T", *ij), acc("B", *ij)), R(0) - R(1)))
    return ir.Program("pointwise", tuple(ir.Array(a, (n, m)) for a in "ABCT"),
                      (ir.Loop("i", n, body=(ir.Loop("j", m, body=comps),)),))


def fill(ir, n, m):
    """A constant fill (PolyBench's ``tmp[i][j] = 0``): nothing read."""
    z = ir.Computation("z", ir.acc("Z", "i", "j"), (), ir.Const(0.0))
    return ir.Program("fill", (ir.Array("Z", (n, m)),),
                      (ir.Loop("i", n, body=(ir.Loop("j", m, body=(z,)),)),))


def accumulate(ir, n, m, guarded=False):
    """``C[i][j] += A[i][j] * 0.5`` (where ``i >= j`` if ``guarded``): the
    old content is an operand."""
    c = ir.Computation("acc", ir.acc("C", "i", "j"), (ir.acc("A", "i", "j"),),
                       ir.Read(0) * 0.5, accumulate="+",
                       guards=(ir.aff("i", ("j", -1)),) if guarded else ())
    return ir.Program("accumulate", (ir.Array("A", (n, m)), ir.Array("C", (n, m))),
                      (ir.Loop("i", n, body=(ir.Loop("j", m, body=(c,)),)),))


def guarded_forward(ir, n, m):
    """A guarded write read back from the slab by a later computation: on
    the lanes the guard leaves, the slab holds the old content."""
    R, acc = ir.Read, ir.acc
    comps = (
        ir.Computation("g", acc("B", "i", "j"), (acc("A", "i", "j"),), R(0) * 2.0,
                       guards=(ir.aff("i", ("j", -1)),)),
        ir.Computation("f", acc("C", "i", "j"), (acc("B", "i", "j"),), R(0) + 1.0))
    return ir.Program("gforward", tuple(ir.Array(a, (n, m)) for a in "ABC"),
                      (ir.Loop("i", n, body=(ir.Loop("j", m, body=comps),)),))


def guarded_then_accumulated(ir, n, m):
    """A guarded write whose merged value the next computation accumulates
    onto: the guard's unselected lanes reach the store through the slab."""
    R, acc = ir.Read, ir.acc
    comps = (
        ir.Computation("g", acc("B", "i", "j"), (acc("A", "i", "j"),), R(0) * 2.0,
                       guards=(ir.aff("i", ("j", -1)),)),
        ir.Computation("a", acc("B", "i", "j"), (acc("A", "i", "j"),), R(0), accumulate="+"))
    return ir.Program("gacc", tuple(ir.Array(a, (n, m)) for a in "AB"),
                      (ir.Loop("i", n, body=(ir.Loop("j", m, body=comps),)),))


def halo_write(ir, n, m, rows=None):
    """``B[i+1][j]`` written for every ``i < rows`` and read back from the
    slab; at ``rows = n`` (the default) the last row lies outside B and is
    not stored."""
    R, acc, aff = ir.Read, ir.acc, ir.aff
    comps = (
        ir.Computation("h", acc("B", aff("i", const=1), "j"), (acc("A", "i", "j"),), R(0) * 2.0),
        ir.Computation("r", acc("C", "i", "j"), (acc("B", aff("i", const=1), "j"), acc("A", "i", "j")),
                       R(0) + R(1)))
    return ir.Program("halo", tuple(ir.Array(a, (n, m)) for a in "ABC"),
                      (ir.Loop("i", rows or n, body=(ir.Loop("j", m, body=comps),)),))


def broadcast_update(ir, n, m):
    """gemver's ``A[i][j] = A[i][j] + u[i] * v[j]``: a broadcast keeps the
    tiled form, and the write index is read once."""
    R, acc = ir.Read, ir.acc
    c = ir.Computation("up", acc("A", "i", "j"), (acc("A", "i", "j"), acc("u", "i"), acc("v", "j")),
                       R(0) + R(1) * R(2))
    return ir.Program("bcast", (ir.Array("A", (n, m)), ir.Array("u", (n,)), ir.Array("v", (m,))),
                      (ir.Loop("i", n, body=(ir.Loop("j", m, body=(c,)),)),))


# K2's forms on the card: (label, program, explicit tile or None)
K2_CASES = [
    ("pointwise 37x45 (rows of 45)", lambda ir: pointwise(ir, 37, 45), None),
    ("pointwise 64x128", lambda ir: pointwise(ir, 64, 128), None),
    ("pointwise 300x301 tile (8, 16)", lambda ir: pointwise(ir, 300, 301), (8, 16)),
    ("fill 37x45", lambda ir: fill(ir, 37, 45), None),
    ("accumulate 33x70", lambda ir: accumulate(ir, 33, 70), None),
    ("guarded accumulate 33x70 tile (8, 16)", lambda ir: accumulate(ir, 33, 70, True), (8, 16)),
    ("guard then slab read 19x23", lambda ir: guarded_forward(ir, 19, 23), (4, 8)),
    ("halo write out of the array 19x23", lambda ir: halo_write(ir, 19, 23), (4, 8)),
    ("broadcast 16x32, tiles divide", lambda ir: broadcast_update(ir, 16, 32), (4, 8)),
    ("broadcast 18x37, ragged tiles", lambda ir: broadcast_update(ir, 18, 37), (4, 8)),
    ("broadcast 200x3000 default tile", lambda ir: broadcast_update(ir, 200, 3000), None),
]

# tests/test_kernels.py's flash-attention sweep: (BHq, BHkv, Sq, Skv, causal, window, offset)
ATTN_SWEEP = [
    (4, 4, 32, 32, True, None, 0),
    (4, 2, 64, 64, True, None, 0),      # GQA group 2
    (8, 2, 40, 72, True, 16, 0),        # GQA group 4 + SWA
    (2, 1, 8, 128, True, None, 120),    # decode-like offset
    (2, 2, 48, 48, False, None, 0),     # bidirectional (encoder)
    (2, 2, 17, 33, True, 8, 0),         # ragged, non-multiple shapes
]
HEAD_SIZES = [32, 64, 120, 128]  # reduced configs, Danube (120), full MHA heads
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5  # tests/test_kernels.py (fp32)
RMS_TOL = 1e-5                     # tests/test_kernels.py (fp32)
# bf16 attention, held per q row by the relative L2 error of the output (a
# measure scaled to the output): both sides round their output to bf16 and
# the kernel also rounds P to bf16 before P.V, as the reference kernel does.
# The limit is chip_smoke.py's, set from its readings on an H100 (PERF.md).
BF16_ATTN_REL_L2 = 8e-3
# bf16 grouped matmul, held per output row by the relative L2 error against
# the fp32 product of the same bf16 inputs: one bf16 rounding of the output.
# The limit is chip_smoke.py's, set from its readings on an H100 (PERF.md).
BF16_GMM_REL_L2 = 5e-3


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place of each value of ``ref`` (8 bits of
    mantissa): the spacing an fp32 result may move by when it is rounded."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


CASES = (
    [(f"stencil-{t}", lambda ir: stencil(ir, 10), dict(pallas_nest=True, nest_tile=t))
     for t in [(3, 3), (4, 8), (16, 16)]]
    + [("triangle", lambda ir: triangle(ir, 11), dict(pallas_nest=True, nest_tile=(4, 4)))]
    + [(f"guarded-reduction-u{u}", lambda ir: syrk1(ir, 9, 16),
        dict(pallas_reduce=True, nest_tile=(4, 4, 8), unroll=u)) for u in (1, 2, 4)]
    + [(f"reduce{op}", lambda ir, op=op: reduce_op(ir, op),
        dict(pallas_reduce=True, nest_tile=(4, 8), unroll=2)) for op in ("+", "*", "max", "min")]
)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [
    (16, 16, 16), (100, 52, 36), (33, 17, 9), (1000, 1100, 1200),
    (37, 70, 1), (129, 65, 7), (130, 200, 9), (8, 8, 200), (131, 67, 200),  # ragged M/N; K % 8
    (800, 1200, 900), (1000, 1101, 1203)])  # K split in 4 (16-byte and 4-byte copies)
def test_gemm_kernel_on_card(card, m, n, k):
    x = torch.randn(m, k, device=card)
    y = torch.randn(k, n, device=card)
    before = p_gemm.LAUNCHES["gemm"]
    got = p_gemm.gemm(x, y)
    torch.cuda.synchronize()
    assert p_gemm.LAUNCHES["gemm"] == before + 1
    assert max_rel(got.cpu().numpy(), p_gemm.gemm_plain(x, y).cpu().numpy()) < MAX_REL


@pytest.mark.cuda
def test_gemm_split_is_bit_identical_run_to_run_on_card(card):
    """The LARGE gemm splits K in 4 on an H100; whichever block of a tile
    arrives last, the partials are added in range order."""
    m, n, k = 1000, 1100, 1200
    props = torch.cuda.get_device_properties(card)
    assert p_gemm.gemm_splits(1, m, n, k, props.multi_processor_count) > 1
    g = torch.Generator(device=card).manual_seed(5)
    x = torch.randn(m, k, generator=g, device=card)
    y = torch.randn(k, n, generator=g, device=card)
    first = p_gemm.gemm(x, y)
    for _ in range(3):
        assert torch.equal(p_gemm.gemm(x, y), first)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 48, 40), (1000, 1100, 1200)])
def test_gemm_keeps_inf_on_card(card, m, n, k):
    """An inf operand gives inf, not NaN (its small part is 0); the rest of
    the product is unchanged."""
    g = torch.Generator(device=card).manual_seed(6)
    x = torch.rand(m, k, generator=g, device=card) + 0.5
    y = torch.rand(k, n, generator=g, device=card) + 0.5
    x[3, 5] = float("inf")
    got = p_gemm.gemm(x, y)
    torch.cuda.synchronize()
    assert bool(torch.isposinf(got[3]).all())
    rest = torch.ones(m, dtype=torch.bool, device=card)
    rest[3] = False
    assert bool(torch.isfinite(got[rest]).all())
    assert max_rel(got[rest].cpu().numpy(), p_gemm.gemm_plain(x, y)[rest].cpu().numpy()) < MAX_REL


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(64, 48, 40), (1000, 1100, 1200)])
def test_gemm_keeps_nan_on_card(card, m, n, k):
    """A NaN operand gives its row NaN, for a NaN made on the card
    (``log(-1)``), its negative and one whose payload lies only in the bits
    TF32 drops; the rest of the product is unchanged."""
    g = torch.Generator(device=card).manual_seed(7)
    x = torch.rand(m, k, generator=g, device=card) + 0.5
    y = torch.randn(k, n, generator=g, device=card)
    x[3, 5] = torch.log(-torch.ones((), device=card))
    x[7, 0] = -x[3, 5]
    x.view(torch.int32)[11, k - 1] = 0x7F800001
    nan_rows = [3, 7, 11]
    assert bool(torch.isnan(x[nan_rows]).any(dim=1).all())
    got = p_gemm.gemm(x, y)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[nan_rows]).all())
    rest = torch.ones(m, dtype=torch.bool, device=card)
    rest[nan_rows] = False
    assert bool(torch.isfinite(got[rest]).all())
    assert max_rel(got[rest].cpu().numpy(), p_gemm.gemm_plain(x, y)[rest].cpu().numpy()) < MAX_REL


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,offset", [
    (64, 32, 48, 0), (300, 264, 136, 0), (2048, 512, 1024, 0), (130, 520, 64, 0),  # wgmma
    (16, 256, 512, 0), (31, 72, 40, 0), (1, 8, 8, 0),                             # decode
    (33, 17, 9, 0), (37, 70, 1, 0), (129, 65, 7, 0), (200, 90, 130, 0),            # mma: K, N
    (64, 32, 0, 0),                                                                # K = 0
    (64, 32, 48, 1), (300, 264, 136, 1), (16, 256, 512, 1),                        # unaligned
    (1000, 1100, 1200, 0)])                                                        # LARGE
def test_gemm_bf16_kernels_on_card(card, m, n, k, offset):
    """K1 in bf16 on ``choose_kernel``'s pick (its ``PATHS`` count it, K6's
    do not): ragged M and N past the 128 x 256 tiles, K = 1, K and N off 8,
    M < 32, views 2 bytes off 16, LARGE; within the bf16 limit of the plain
    version, bit-identical over two launches."""
    g = torch.Generator(device=card).manual_seed(m * n + k)

    def made(r, c):
        flat = torch.randn(r * c + offset, generator=g, device=card).bfloat16()
        return flat[offset:].view(r, c)

    x, y = made(m, k), made(k, n)
    kernel = p_gemm.choose_kernel(torch.bfloat16, m, n, k, offset == 0)
    before = dict(p_gemm.PATHS), dict(p_gmm.PATHS), p_gemm.LAUNCHES["gemm"]
    got, again = p_gemm.gemm(x, y), p_gemm.gemm(x, y)
    torch.cuda.synchronize()
    moved = {p: c - before[0][p] for p, c in p_gemm.PATHS.items() if c != before[0][p]}
    assert moved == {kernel: 2} and p_gemm.LAUNCHES["gemm"] == before[2] + 2
    assert dict(p_gmm.PATHS) == before[1]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), p_gemm.gemm_plain(x, y).float(), rtol=5e-2,
                               atol=5e-1)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(300, 1024, 136), (1100, 520, 256)])
def test_gemm_named_kernel_refuses_operands_on_card(card, m, n, k):
    """A kernel named to ``_launch`` that does not take the operands raises
    before launch, and the one ``choose_kernel`` picks gives ``gemm``'s
    bits."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.randn(m, k, generator=g, device=card).bfloat16()
    y = torch.randn(k, n, generator=g, device=card).bfloat16()
    assert torch.equal(p_gemm._launch("wgmma", x, y), p_gemm.gemm(x, y))
    with pytest.raises(ValueError):
        p_gemm._launch("decode", x, y)  # M > 32
    with pytest.raises(ValueError):
        p_gemm._launch("wgmma", x[:, :130].contiguous(), y[:130])  # K % 8 == 2
    with pytest.raises(TypeError):
        p_gemm._launch("tf32x3", x, y)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(3, 130, 1200, 200), (2, 45, 9, 70), (8, 640, 512, 256)])
def test_gemm_batched_through_grouped_matmul_on_card(card, e, c, d, f):
    """``repro_gemm_batched_f32`` (grid z over experts, K split where the
    tiles are few) through K6's float32 path."""
    g = torch.Generator(device=card).manual_seed(e * c * f)
    x = torch.randn(e, c, d, generator=g, device=card)
    w = torch.randn(e, d, f, generator=g, device=card)
    before = p_gmm.PATHS["gemm"]
    got = p_gmm._launch("gemm", x, w)
    torch.cuda.synchronize()
    assert p_gmm.PATHS["gemm"] == before + 1
    assert max_rel(got.cpu().numpy(), p_ref.grouped_matmul(x, w).cpu().numpy()) < MAX_REL
    assert torch.equal(p_gmm._launch("gemm", x, w), got)


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f,offset", [
    (3, 13, 37, 29, 0), (2, 33, 70, 17, 0), (3, 130, 264, 200, 0),  # ragged: loads one by one
    (8, 16, 4096, 512, 0), (8, 40, 520, 1000, 0), (2, 200, 128, 136, 0),  # 16-byte loads
    (4, 20, 64, 64, 1)])  # misaligned pointers: loads one by one
def test_grouped_matmul_kernel_on_card(card, e, c, d, f, offset):
    g = torch.Generator(device=card).manual_seed(e * c + d)
    x = torch.randn(e * c * d + offset, generator=g, device=card)[offset:].view(e, c, d)
    w = (torch.randn(e * d * f + offset, generator=g, device=card)[offset:].view(e, d, f)
         / d ** 0.5)
    before = p_gmm.LAUNCHES["grouped_matmul"]
    got = p_gmm.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert p_gmm.LAUNCHES["grouped_matmul"] == before + 1
    assert max_rel(got.cpu().numpy(), p_ref.grouped_matmul(x, w).cpu().numpy()) < MAX_REL
    xb, wb = x.bfloat16(), w.bfloat16()
    if offset:  # .bfloat16() copies into an aligned buffer: offset it again
        xb = torch.cat([xb.new_zeros(offset), xb.reshape(-1)])[offset:].view(e, c, d)
        wb = torch.cat([wb.new_zeros(offset), wb.reshape(-1)])[offset:].view(e, d, f)
        assert xb.data_ptr() % 16 and wb.data_ptr() % 16
    paths = dict(p_gmm.PATHS)
    got = p_gmm.grouped_matmul(xb, wb).float()
    want = p_ref.grouped_matmul(xb.float(), wb.float())
    row_err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(row_err.max()) <= BF16_GMM_REL_L2
    took = p_gmm.choose_kernel(torch.bfloat16, c, d, f, not offset)
    assert took == "mma" if offset else took in ("wgmma", "decode", "mma")
    assert p_gmm.PATHS[took] == paths[took] + 1  # a misaligned view takes the mma kernel


# ragged C, D and F at E = 3: past the wgmma kernel's 128 x 256 tile, its
# 64-deep slices and 64-column boxes, and the mma kernel's tile heights
GMM_RAGGED = [(3, 13, 40, 24), (3, 70, 96, 48), (3, 200, 1032, 264), (3, 333, 136, 72),
              (3, 129, 4096, 264), (3, 130, 264, 200), (3, 17, 520, 1000)]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wgmma", "mma"])
@pytest.mark.parametrize("e,c,d,f", GMM_RAGGED)
def test_grouped_matmul_both_kernels_on_card(card, kernel, e, c, d, f):
    """Each bf16 kernel, named through ``_launch``, against the fp32 product
    of the same bf16 inputs, whatever ``choose_kernel`` would pick."""
    g = torch.Generator(device=card).manual_seed(e * c + d * f)
    xb = torch.randn(e, c, d, generator=g, device=card).bfloat16()
    wb = (torch.randn(e, d, f, generator=g, device=card) / d ** 0.5).bfloat16()
    before = dict(p_gmm.PATHS)
    got = p_gmm._launch(kernel, xb, wb).float()
    torch.cuda.synchronize()
    assert p_gmm.PATHS[kernel] == before[kernel] + 1
    want = p_ref.grouped_matmul(xb.float(), wb.float())
    row_err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(row_err.max()) <= BF16_GMM_REL_L2


@pytest.mark.cuda
def test_grouped_matmul_routes_buckets_to_wgmma_and_decode_to_mma(card):
    """The public wrapper's choice on the card: a 640-row prefill bucket
    takes the wgmma kernel, a 16-row decode step the decode kernel, a
    misaligned view the mma kernel, fp32 K1's batched kernel; the wgmma and
    decode kernels refuse what they cannot take instead of falling back."""
    g = torch.Generator(device=card).manual_seed(8)
    w = torch.randn(8, 256, 512, generator=g, device=card).bfloat16()
    flat = torch.randn(8 * 640 * 256 + 1, generator=g, device=card).bfloat16()
    for x, wt, kernel in [(flat[:8 * 640 * 256].view(8, 640, 256), w, "wgmma"),
                          (flat[:8 * 16 * 256].view(8, 16, 256), w, "decode"),
                          (flat[1:8 * 16 * 256 + 1].view(8, 16, 256), w, "mma"),
                          (flat[1:].view(8, 640, 256), w, "mma"),
                          (flat[:8 * 640 * 256].view(8, 640, 256).float(), w.float(), "gemm")]:
        before = dict(p_gmm.PATHS)
        p_gmm.grouped_matmul(x, wt)
        assert p_gmm.PATHS[kernel] == before[kernel] + 1, kernel
        assert sum(p_gmm.PATHS.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError):
        p_gmm._launch("wgmma", flat[1:].view(8, 640, 256), w)
    with pytest.raises(ValueError):
        p_gmm._launch("wgmma", flat[:8 * 640 * 250].view(8, 640, 250), w[:, :250].contiguous())
    with pytest.raises(ValueError):
        p_gmm._launch("decode", flat[1:8 * 16 * 256 + 1].view(8, 16, 256), w)
    with pytest.raises(ValueError):
        p_gmm._launch("decode", flat[:8 * 40 * 256].view(8, 40, 256), w)  # C > 32


# the decode kernel's shapes: Mixtral's decode step (C = 16) and warm-up
# (C = 2) at gate/up and down, C 17-31 (two row tiles), ragged small shapes
GMM_DECODE = [(8, 16, 4096, 14336), (8, 16, 14336, 4096), (8, 2, 4096, 14336),
              (8, 2, 14336, 4096), (8, 31, 4096, 1024), (3, 17, 520, 1000), (3, 13, 40, 24),
              (2, 1, 8, 8), (3, 5, 200, 264)]


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", GMM_DECODE)
def test_grouped_matmul_decode_kernel_on_card(card, e, c, d, f):
    """The decode kernel against the fp32 product of the same bf16 inputs,
    bit-identical over repeated launches."""
    g = torch.Generator(device=card).manual_seed(e * c + d * f)
    xb = torch.randn(e, c, d, generator=g, device=card).bfloat16()
    wb = (torch.randn(e, d, f, generator=g, device=card) / d ** 0.5).bfloat16()
    want = p_ref.grouped_matmul(xb.float(), wb.float())
    before = p_gmm.PATHS["decode"]
    runs = [p_gmm._launch("decode", xb, wb) for _ in range(3)]
    torch.cuda.synchronize()
    assert p_gmm.PATHS["decode"] == before + 3
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    row_err = (runs[0].float() - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert float(row_err.max()) <= BF16_GMM_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("label,build,knobs", CASES, ids=[c[0] for c in CASES])
def test_nest_kernel_on_card(card, label, build, knobs):
    prog = build(pir)
    inp = random_inputs(prog, seed=4)
    env = {k: torch.tensor(v, device=card) for k, v in inp.items()}
    ref = {k: v.clone() for k, v in env.items()}
    nk = p_nest.plan_nest(prog, prog.body[0], Schedule(use_idioms=False, **knobs))
    before = dict(p_nest.EMITTED)
    p_nest.run_nest(nk, env)
    torch.cuda.synchronize()
    assert p_nest.EMITTED[nk.kind] == before[nk.kind] + 1
    p_nest.nest_plain(nk, ref)
    for name in env:
        assert max_rel(env[name].cpu().numpy(), ref[name].cpu().numpy()) < MAX_REL, name


@pytest.mark.cuda
@pytest.mark.parametrize("label,build,tile", K2_CASES, ids=[c[0] for c in K2_CASES])
def test_nest_kernel_forms_on_card(card, label, build, tile):
    """K2 against its plain version where it elides the old content and
    where it keeps it (accumulate, guard then slab read), on a halo write
    out of the array, flattened (rows not a multiple of 16; 64 x 128 runs
    only the unmasked body, 37 x 45 also the masked last block) and tiled,
    on tiles that divide the extent and ragged ones: one launch a run."""
    prog = build(pir)
    inp = random_inputs(prog, seed=5)
    env = {k: torch.tensor(v, device=card) for k, v in inp.items()}
    ref = {k: v.clone() for k, v in env.items()}
    nk = p_nest.plan_nest(prog, prog.body[0], Schedule(use_idioms=False, pallas_nest=True,
                                                       nest_tile=tile))
    before = p_nest.EMITTED["pallas_nest"], p_nest.FLAT["pallas_nest"]
    p_nest.run_nest(nk, env)
    torch.cuda.synchronize()
    assert p_nest.EMITTED["pallas_nest"] == before[0] + 1
    assert p_nest.FLAT["pallas_nest"] == before[1] + nk.flat
    p_nest.nest_plain(nk, ref)
    for name in env:
        assert max_rel(env[name].cpu().numpy(), ref[name].cpu().numpy()) < MAX_REL, name


def _strided(base: torch.Tensor, pad: int) -> torch.Tensor:
    """A copy of ``base`` in rows ``pad`` elements longer than its own."""
    n, m = base.shape
    out = torch.full((n, m + pad), float("nan"), device=base.device)[:, :m]
    out.copy_(base)
    return out


@pytest.mark.cuda
def test_nest_kernel_recalled_on_other_strides_on_card(card):
    """One planned nest called on contiguous arrays (flattened), then on rows
    padded to 64 elements and on column-major arrays (tiled), then on
    contiguous arrays again (the kernel bound at the first call, launched
    directly), each against the plain version; and arrays of one parameter
    group that disagree in strides raise."""
    prog = pointwise(pir, 37, 45)
    inp = random_inputs(prog, seed=6)
    base = {k: torch.tensor(v, device=card) for k, v in inp.items()}
    want = {k: v.clone() for k, v in base.items()}
    nk = p_nest.plan_nest(prog, prog.body[0], Schedule(use_idioms=False, pallas_nest=True))
    p_nest.nest_plain(nk, want)
    layouts = {
        "contiguous": lambda t: t.clone(),
        "rows of 64": lambda t: _strided(t, 64 - t.shape[1]),
        "column-major": lambda t: t.t().contiguous().t(),
    }
    for label, lay in [*layouts.items(), ("contiguous", layouts["contiguous"])]:
        env = {k: lay(v) for k, v in base.items()}
        before = p_nest.EMITTED["pallas_nest"], p_nest.FLAT["pallas_nest"]
        p_nest.run_nest(nk, env)
        torch.cuda.synchronize()
        assert p_nest.EMITTED["pallas_nest"] == before[0] + 1, label
        assert p_nest.FLAT["pallas_nest"] == before[1] + (label == "contiguous"), label
        for name in env:
            assert max_rel(env[name].cpu().numpy(), want[name].cpu().numpy()) < MAX_REL, (label, name)
    # one compiled kernel bound per layout; the second contiguous run reused its own
    assert len(nk.compiled) == 3
    mixed = {k: v.clone() for k, v in base.items()}
    mixed["B"] = _strided(base["B"], 3)
    with pytest.raises(ValueError, match="parameter group"):
        p_nest.run_nest(nk, mixed)


@pytest.mark.cuda
@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
@pytest.mark.parametrize("op", ["+", "*", "max", "min"])
def test_nest_kernel_split_form_on_card(card, op, guarded):
    """K3's split form against the plain version at every split count from
    1 to one range per reduction tile (the launch's own count among them),
    each bit-identical over two runs, the split runs counted and the
    arrival counters back at zero after every split launch."""
    build = guarded_reduce_op if guarded else reduce_op
    prog = build(pir, op, 40, 96)
    inp = random_inputs(prog, seed=9)
    base = {k: torch.tensor(v, device=card) for k, v in inp.items()}
    nk = p_nest.plan_nest(prog, prog.body[0],
                          Schedule(use_idioms=False, pallas_reduce=True, nest_tile=(8, 8)))
    tiles = nk.plan.reduce_grid.n_tiles
    chosen = p_nest.reduce_splits(nk.plan, p_nest.sm_count(card))
    assert tiles == 12 and chosen == tiles  # 5 parallel tiles: split as far as it goes
    want = {k: v.clone() for k, v in base.items()}
    p_nest.nest_plain(nk, want)
    for splits in sorted({1, 2, 5, chosen}):
        runs = []
        for _ in range(2):
            env = {k: v.clone() for k, v in base.items()}
            before = p_nest.SPLIT["pallas_reduce"], p_nest.EMITTED["pallas_reduce"]
            p_nest.nest_launch(nk, env, splits=splits)
            torch.cuda.synchronize()
            assert p_nest.SPLIT["pallas_reduce"] == before[0] + (splits > 1)
            assert p_nest.EMITTED["pallas_reduce"] == before[1] + 1
            if splits > 1:
                assert not p_nest._counters(env["y"].device, 5).any()
            runs.append(env)
        assert torch.equal(runs[0]["y"], runs[1]["y"]), splits
        assert max_rel(runs[0]["y"].cpu().numpy(), want["y"].cpu().numpy()) < MAX_REL, splits
    with pytest.raises(ValueError):
        p_nest.nest_launch(nk, {k: v.clone() for k, v in base.items()}, splits=tiles + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,offset", [
    (8, 64, 0), (100, 96, 0), (5, 32, 0), (1, 3840, 0), (2048, 3840, 0), (8, 12288, 0),
    (7, 30, 0), (8, 3840, 0), (16, 4096, 0), (4, 12288, 0), (3, 40000, 0),  # past the registers
    (8, 3840, 1), (16, 96, 3)])  # rows that start off 16-byte alignment
def test_rmsnorm_kernel_on_card(card, rows, d, offset, dtype):
    g = torch.Generator(device=card).manual_seed(rows * d)
    x = torch.randn(rows * d + offset, generator=g, device=card).to(dtype)[offset:].view(rows, d)
    gamma = (1 + 0.5 * torch.randn(d, generator=g, device=card)).to(dtype)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = p_rms.LAUNCHES["rmsnorm"]
    got = p_rms.rmsnorm(x, gamma, eps=1e-6)
    torch.cuda.synchronize()
    assert p_rms.LAUNCHES["rmsnorm"] == before + 1 and got.dtype == dtype
    want = p_ref.rmsnorm(x, gamma, eps=1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RMS_TOL, atol=RMS_TOL)
    else:  # both round one fp32 result to bf16: at most one ulp apart
        assert bool(((got.float() - want.float()).abs() <= bf16_ulp(want)).all())
    assert torch.equal(p_rms.rmsnorm(x, gamma, eps=1e-6), got)  # a fixed summation order


def _bf16_row_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float(((got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)).max())


def _hold_flash_kernel(kernel, q, k, v, **kw):
    """K5's ``kernel`` against the plain version: fp32 (SIMT only) by
    allclose, bf16 by each q row's relative L2 error; both launches counted."""
    before = p_flash.LAUNCHES["flash_attention"], p_flash.PATHS[kernel]
    n = 0
    if kernel == "simt":
        got = p_flash._launch(kernel, q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, p_ref.attention(q, k, v, **kw), rtol=ATTN_RTOL,
                                   atol=ATTN_ATOL)
        n += 1
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    got = p_flash._launch(kernel, qb, kb, vb, **kw)
    torch.cuda.synchronize()
    assert p_flash.LAUNCHES["flash_attention"] == before[0] + n + 1
    assert p_flash.PATHS[kernel] == before[1] + n + 1
    assert _bf16_row_err(got, p_ref.attention(qb, kb, vb, **kw)) <= BF16_ATTN_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["simt", "mma"])
@pytest.mark.parametrize("d", HEAD_SIZES)
@pytest.mark.parametrize("bh,bkv,sq,skv,causal,window,off", ATTN_SWEEP)
def test_flash_attention_kernel_on_card(card, bh, bkv, sq, skv, causal, window, off, d, kernel):
    g = torch.Generator(device=card).manual_seed(bh * sq + d)
    q = torch.randn(bh, sq, d, generator=g, device=card)
    k = torch.randn(bkv, skv, d, generator=g, device=card)
    v = torch.randn(bkv, skv, d, generator=g, device=card)
    _hold_flash_kernel(kernel, q, k, v, causal=causal, window=window, q_offset=off)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["simt", "mma"])
@pytest.mark.parametrize("causal,window", [(True, 64), (True, None), (False, None)])
def test_flash_attention_danube_head_ragged_on_card(card, causal, window, kernel):
    """Danube's head size 120 (padded to 128 in the mma kernel's shared
    memory) at Sq 200 over Skv 333: ragged q and key tiles, a window edge."""
    g = torch.Generator(device=card).manual_seed(120)
    q = torch.randn(8, 200, 120, generator=g, device=card)
    k = torch.randn(2, 333, 120, generator=g, device=card)
    v = torch.randn(2, 333, 120, generator=g, device=card)
    _hold_flash_kernel(kernel, q, k, v, causal=causal, window=window, q_offset=133)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["simt", "mma"])
def test_flash_attention_per_head_offsets_prefill_on_card(card, kernel):
    """One offset per q head with Sq > 1 (GQA group 2), rows near and past
    the end of the keys included."""
    g = torch.Generator(device=card).manual_seed(5)
    q = torch.randn(16, 40, 128, generator=g, device=card)
    k = torch.randn(8, 300, 128, generator=g, device=card)
    v = torch.randn(8, 300, 128, generator=g, device=card)
    offs = torch.tensor([0, 5, 100, 259, 260, 3, 70, 299, 1, 2, 150, 151, 0, 0, 280, 10],
                        dtype=torch.int32, device=card)
    _hold_flash_kernel(kernel, q, k, v, causal=True, q_offset=offs)
    _hold_flash_kernel(kernel, q, k, v, causal=True, window=32, q_offset=offs)


@pytest.mark.cuda
def test_flash_attention_routes_prefill_to_mma_and_decode_to_simt(card):
    """The public wrapper's choice on the card: a bf16 prefill bucket takes
    the tensor-core kernel, a bf16 decode step the split-KV decode kernel,
    fp32 (prefill or decode) the SIMT kernel."""
    g = torch.Generator(device=card).manual_seed(6)
    k = torch.randn(8, 512, 120, generator=g, device=card).bfloat16()
    for sq, dtype, kernel in [(256, torch.bfloat16, "mma"), (1, torch.bfloat16, "decode"),
                              (256, torch.float32, "simt"), (1, torch.float32, "simt")]:
        q = torch.randn(32, sq, 120, generator=g, device=card).to(dtype)
        before = dict(p_flash.PATHS)
        p_flash.flash_attention(q, k.to(dtype), k.to(dtype), q_offset=256)
        assert p_flash.PATHS[kernel] == before[kernel] + 1
        assert sum(p_flash.PATHS.values()) == sum(before.values()) + 1


@pytest.mark.cuda
def test_flash_attention_per_slot_offsets_on_card(card):
    """Decode over slots at different cache lengths: one offset per slot."""
    g = torch.Generator(device=card).manual_seed(3)
    slots, heads, kv, d, skv = 5, 8, 2, 120, 300
    q = torch.randn(slots * heads, 1, d, generator=g, device=card)
    k = torch.randn(slots * kv, skv, d, generator=g, device=card)
    v = torch.randn(slots * kv, skv, d, generator=g, device=card)
    lens = torch.tensor([0, 1, 37, 250, 299], dtype=torch.int32, device=card)
    got = p_flash.flash_attention(q, k, v, causal=True, q_offset=lens)
    want = p_ref.attention(q, k, v, causal=True,
                           q_offset=p_flash.expand_offsets(lens, slots * heads, card))
    torch.testing.assert_close(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    for i, n in enumerate(lens.tolist()):  # each slot alone, with an int offset
        rows = slice(i * heads, (i + 1) * heads)
        alone = p_flash.flash_attention(q[rows], k[i * kv:(i + 1) * kv], v[i * kv:(i + 1) * kv],
                                        causal=True, q_offset=n)
        torch.testing.assert_close(got[rows], alone, rtol=ATTN_RTOL, atol=ATTN_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "minicpm-2b", "mixtral-8x7b"])
def test_model_and_engine_on_card(card, arch):
    """The reduced model on the card (K4/K5, and K6 for Mixtral, inside)
    against the fp32 plain forward, and the engine's greedy tokens against
    the same model on the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import plain
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 100), generator=torch.Generator().manual_seed(1))
    launches = (p_rms.LAUNCHES["rmsnorm"], p_flash.LAUNCHES["flash_attention"],
                p_gmm.LAUNCHES["grouped_matmul"])
    got = M.forward(cfg, params, {"tokens": toks.to(card)})
    torch.cuda.synchronize()
    assert p_rms.LAUNCHES["rmsnorm"] == launches[0] + 2 * cfg.n_layers + 1
    assert p_flash.LAUNCHES["flash_attention"] == launches[1] + cfg.n_layers
    assert p_gmm.LAUNCHES["grouped_matmul"] == launches[2] + 3 * cfg.n_layers * cfg.is_moe
    want = plain.forward(cfg, params, toks[0].to(card))
    torch.testing.assert_close(got[0], want, rtol=2e-3, atol=2e-3)

    cpu_params = {k: ([{n: (vv.cpu() if isinstance(vv, torch.Tensor) else
                            {m: w.cpu() for m, w in vv.items()}) for n, vv in blk.items()}
                       for blk in v] if k == "layers" else v.cpu()) for k, v in params.items()}
    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([9, 8, 7], np.int32),
               np.array([2, 7, 1, 8, 2, 8, 1], np.int32)]
    out = []
    for p in (params, cpu_params):
        eng = ServingEngine(cfg, p, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=6))
        hs = [eng.submit(pr) for pr in prompts]
        eng.drain()
        out.append([h.tokens for h in hs])
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,sq,skv", [("mma", 300, 700), ("mma", 130, 4096),
                                           ("decode", 1, 4096), ("decode", 1, 333)])
def test_flash_attention_cross_attention_shapes_on_card(card, kernel, sq, skv):
    """Seamless's cross-attention: 16 heads of 64, a GQA group of 1,
    non-causal over a memory longer than the queries, offset 0 (8 slots at a
    decode step); the decode kernel walks every chunk without a causal
    bound."""
    g = torch.Generator(device=card).manual_seed(sq + skv)
    bh = 16 if sq > 1 else 8 * 16
    q = torch.randn(bh, sq, 64, generator=g, device=card)
    k = torch.randn(bh, skv, 64, generator=g, device=card)
    v = torch.randn(bh, skv, 64, generator=g, device=card)
    _hold_flash_kernel(kernel, q, k, v, causal=False, window=None, q_offset=0)
    assert p_flash.choose_kernel(torch.bfloat16, sq, 64, True, 1) == kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_matmul_launches_k1_on_card(card, dtype):
    """``ops.matmul`` on CUDA tensors launches K1 (the tile is ignored) and
    raises for what K1 does not take."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=card).manual_seed(7)
    x = torch.randn(200, 130, generator=g, device=card).to(dtype)
    y = torch.randn(130, 90, generator=g, device=card).to(dtype)
    before = p_gemm.LAUNCHES["gemm"], p_gemm.PLAIN["gemm"]
    got = ops.matmul(x, y, tile=(256, 256, 128))
    torch.cuda.synchronize()
    assert (p_gemm.LAUNCHES["gemm"], p_gemm.PLAIN["gemm"]) == (before[0] + 1, before[1])
    want = p_gemm.gemm_plain(x, y)
    if dtype == torch.float32:
        assert max_rel(got.cpu().numpy(), want.cpu().numpy()) < MAX_REL
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2, atol=5e-1)
    with pytest.raises(ValueError):
        ops.matmul(x[:, :64], y[:64])  # a strided view


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "seamless-m4t-large-v2"])
def test_family_model_and_engine_on_card(card, arch):
    """The reduced vlm and audio models on the card: ``forward`` with
    frontend embeddings against the fp32 plain forward, and the engine's
    greedy tokens (audio: over each request's encoded zero frames) against
    the same model on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import plain
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, 100), generator=gen)
    emb = torch.randn(1, cfg.frontend_len, cfg.d_model, generator=gen)
    got = M.forward(cfg, params, {"tokens": toks.to(card), "embeds": emb.to(card)})
    want = plain.forward(cfg, params, toks[0].to(card), embeds=emb[0].to(card))
    torch.testing.assert_close(got[0], want, rtol=2e-3, atol=2e-3)

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return [to_cpu(v) for v in t] if isinstance(t, list) else t.cpu()

    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([9, 8, 7], np.int32),
               np.array([2, 7, 1, 8, 2, 8, 1], np.int32)]
    out = []
    for p in (params, to_cpu(params)):
        eng = ServingEngine(cfg, p, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=6))
        hs = [eng.submit(pr) for pr in prompts]
        eng.drain()
        out.append([h.tokens for h in hs])
    assert out[0] == out[1]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_recurrent_model_and_engine_on_card(card, arch):
    """The reduced hybrid and ssm models (xLSTM with an sLSTM layer) on the
    card: ``forward`` and a stepwise decode against the fp32 plain forward,
    and the engine's greedy tokens (exact-length prefill) against the same
    model on the CPU."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import plain
    from repro_torch.serve import ServeConfig, ServingEngine

    cfg = get_config(arch).reduced()
    if cfg.family == "ssm":
        cfg = replace(cfg, block_pattern=("m", "s"), n_layers=4)
    params = M.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 40), generator=torch.Generator().manual_seed(1))
    got = M.forward(cfg, params, {"tokens": toks.to(card)})
    want = plain.forward(cfg, params, toks[0].to(card))
    torch.testing.assert_close(got[0], want, rtol=2e-3, atol=2e-3)
    state = M.init_decode_state(cfg, 1, 64, ring=False, device=card)
    steps = []
    for t in range(toks.shape[1]):
        logits, state = M.decode_step(cfg, params, state, toks[:, t:t + 1].to(card))
        steps.append(logits[0, 0])
    torch.testing.assert_close(torch.stack(steps), want, rtol=2e-3, atol=2e-3)

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return [to_cpu(v) for v in t] if isinstance(t, list) else t.cpu()

    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([9, 8, 7], np.int32),
               np.array([2, 7, 1, 8, 2, 8, 1], np.int32)]
    out = []
    for p in (params, to_cpu(params)):
        eng = ServingEngine(cfg, p, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=6))
        hs = [eng.submit(pr) for pr in prompts]
        eng.drain()
        out.append([h.tokens for h in hs])
    assert out[0] == out[1]


# the decode kernel's cases: (slots, q heads, KV heads, D, Skv, visible keys
# per slot, window); a slot at offset 0 (one key), one past Skv - 1, no key
DECODE_CASES = [
    (8, 32, 8, 120, 4096, [1, 300, 1111, 2047, 2500, 3333, 4000, 4095], None),  # Danube
    (16, 32, 8, 128, 4096, [1 + 4094 * i // 15 for i in range(16)], None),      # Mixtral
    (4, 32, 8, 128, 4096, [4096, 4096, 4096, 4096], None),                      # full caches
    (5, 8, 2, 120, 300, [1, 301, 0, 128, 129], None),   # offset 0, past the cache, no key
    (4, 4, 4, 64, 200, [0, 1, 64, 65], 16),             # MHA, a window
    (2, 16, 1, 128, 1000, [500, 1000], None),           # a group of 16
    (3, 6, 1, 32, 130, [64, 65, 130], 100),             # a group of 6 padded to 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("slots,heads,kvh,d,skv,lens,window", DECODE_CASES)
def test_flash_decode_kernel_on_card(card, slots, heads, kvh, d, skv, lens, window):
    """The split-KV decode kernel against the plain version at several chunk
    sizes (bf16, each q row's relative L2 error), bit-identical over repeated
    launches, and the arrival counters back at zero."""
    from repro_torch.kernels import runtime

    g = torch.Generator(device=card).manual_seed(slots * d + skv)
    q = torch.randn(slots * heads, 1, d, generator=g, device=card).bfloat16()
    k = torch.randn(slots * kvh, skv, d, generator=g, device=card).bfloat16()
    v = torch.randn(slots * kvh, skv, d, generator=g, device=card).bfloat16()
    off = torch.tensor([n - 1 for n in lens], dtype=torch.int32, device=card)
    offq = p_flash.expand_offsets(off, q.shape[0], card)
    want = p_ref.attention(q, k, v, causal=True, window=window, q_offset=offq)
    for chunk in (None, 64, 128, 512):
        if chunk is not None and -(-skv // chunk) > p_flash.DECODE_MAX_CHUNKS:
            continue
        before = p_flash.PATHS["decode"]
        runs = [p_flash._launch("decode", q, k, v, causal=True, window=window, q_offset=off,
                                chunk=chunk) for _ in range(3)]
        torch.cuda.synchronize()
        assert p_flash.PATHS["decode"] == before + 3
        assert all(torch.equal(runs[0], r) for r in runs[1:]), chunk
        assert _bf16_row_err(runs[0], want) <= BF16_ATTN_REL_L2, chunk
        for i, n in enumerate(lens):  # a slot that sees no key gives 0
            if n <= 0:
                assert not runs[0][i * heads:(i + 1) * heads].any()
    for cnt in runtime._COUNTERS.values():
        assert int(cnt.abs().sum()) == 0


# ---------------------------------------------------------------------------
# the evolutionary search's measurement on the card
# ---------------------------------------------------------------------------
def _atax_kernel_nests():
    """atax's canonical nests at mini size that the planner puts on K2 and
    on K3, as standalone nest programs."""
    from repro_torch.core import Daisy
    from repro_torch.core.scheduler import nest_program
    from repro_torch.core.tiling import TilingError, plan_nest_tiling
    from repro_torch.polybench import BENCHMARKS

    p = Daisy(device="cpu")._normalized(BENCHMARKS["atax"].make("a", "mini"))
    kinds = {}
    for nest in p.body:
        try:
            plan = plan_nest_tiling(p, nest)
        except TilingError:
            continue
        kinds.setdefault("pallas_nest" if plan.kind == "parallel" else "pallas_reduce",
                         nest_program(p, nest))
    assert set(kinds) == {"pallas_nest", "pallas_reduce"}
    return kinds


@pytest.mark.cuda
def test_measure_recipe_times_k2_and_k3_on_card(card):
    """``measure_recipe`` builds, launches and times a K2 and a K3 nest on the
    card (finite times; the launch counters move), and a preset tile too."""
    from repro_torch.core import Recipe
    from repro_torch.core.recipes import NEST_TILE_PRESETS, REDUCE_TILE_PRESETS
    from repro_torch.core.search import measure_recipe

    presets = {"pallas_nest": NEST_TILE_PRESETS[0], "pallas_reduce": REDUCE_TILE_PRESETS[0]}
    for kind, nprog in _atax_kernel_nests().items():
        for tile in (None, presets[kind]):
            before = p_nest.EMITTED[kind]
            t = measure_recipe(nprog, random_inputs(nprog), Recipe(kind=kind, tile=tile),
                               repeats=3, device=card)
            assert np.isfinite(t) and t > 0, (kind, tile)
            assert p_nest.EMITTED[kind] >= before + 4  # a warm-up and three timed runs


@pytest.mark.cuda
def test_seed_nest_on_card(card):
    """``Daisy.seed_nest`` on the card returns a finite time and a kernel or
    torch recipe for each of a mini program's nests."""
    from repro_torch.core import Daisy
    from repro_torch.polybench import BENCHMARKS

    d = Daisy(backend="cuda", device=card)
    p = d._normalized(BENCHMARKS["atax"].make("a", "mini"))
    for nest in p.body:
        fp, emb, recipe, t, prov = d.seed_nest(p, nest, search_iterations=1, population=4,
                                               repeats=2)
        assert np.isfinite(t) and t > 0 and prov.endswith((":search", ":idiom"))
        assert recipe.kind in ("einsum", "vectorize", "sequential", "pallas_gemm",
                               "pallas_nest", "pallas_reduce")


def _scheme_on_card_world(nproma: int, klev: int):
    """One rank of a world on the card: the column-sharded mini scheme."""
    from repro_torch.cloudsc import column_mesh, compile_scheme, scheme_inputs

    fn, plan = compile_scheme(nproma, klev, mesh=column_mesh())
    env = fn(scheme_inputs(nproma, klev))
    return plan, {k: v.cpu().numpy() for k, v in env.items()}


@pytest.mark.cuda
def test_sharded_scheme_on_card_is_bit_identical(card):
    """Two ranks on the one card (their collectives on gloo) run the mini
    scheme column-sharded at nproma 256: every nest sharded, none
    all-reducing, the outputs bit-identical to the unsharded card run."""
    from repro_torch.cloudsc import compile_scheme, scheme_inputs
    from repro_torch.launch.mesh import run_world

    plan, got = run_world(2, _scheme_on_card_world, (256, 137))
    assert plan.sharded and all(n.iterator is not None and not n.reduces for n in plan.nests)
    fn, _ = compile_scheme(256, 137, device=card)
    want = fn(scheme_inputs(256, 137))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.cpu().numpy(), err_msg=k)


def _engine_on_card_world(arch: str, prompts):
    """One rank of a world on the card: the reduced model (fp32, seeded on
    the card) served over mesh (data 1, model 2); its tokens and this
    rank's K4/K5 launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, ServingEngine

    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    before = p_rms.LAUNCHES["rmsnorm"], dict(p_flash.PATHS)
    eng = ServingEngine(cfg, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=6),
                        mesh=mesh)
    hs = [eng.submit(p) for p in prompts]
    eng.drain()
    k5 = {k: p_flash.PATHS[k] - before[1][k] for k in p_flash.PATHS}
    return [h.tokens for h in hs], p_rms.LAUNCHES["rmsnorm"] - before[0], k5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b"])
def test_sharded_engine_on_card_equals_unsharded(card, arch):
    """Two ranks on the one card (collectives on gloo) serve the reduced
    model over mesh (data 1, model 2) in fp32: heads, FFN columns and rows
    and the vocabulary (or the experts) over model, on K4 and K5.  Greedy
    tokens equal the unsharded engine's on the card."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, ServingEngine

    prompts = [np.arange(1, n + 1, dtype=np.int32) % 500 for n in (5, 23, 40)]
    tokens, k4, k5 = run_world(2, _engine_on_card_world, (arch, prompts))
    assert k4 > 0 and sum(k5.values()) > 0, (k4, k5)
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(cfg, params, ServeConfig(batch_slots=2, max_len=64, max_new_tokens=6))
    hs = [eng.submit(p) for p in prompts]
    eng.drain()
    assert tokens == [h.tokens for h in hs]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 1920, 3840), (300, 5120, 3840), (3, 72, 40)])
def test_sharded_engine_partial_keeps_fp32_on_card(card, m, k, n):
    """A row-parallel partial of bf16 operands leaves its GEMM in fp32
    (``layers._mm_f32``): within fp32 rounding of the same products summed
    in fp32 on the CPU, not rounded to bf16."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((2, m, k), generator=g).bfloat16()
    w = (torch.randn((k, n), generator=g) / k ** 0.5).bfloat16()
    got = L._mm_f32(x.to(card), w.to(card))
    want = L._mm_f32(x, w)
    assert got.dtype == want.dtype == torch.float32 and got.shape == (2, m, n)
    assert max_rel(got.cpu(), want) < 1e-5
    assert not torch.equal(got.cpu(), got.cpu().bfloat16().float())  # not rounded to bf16


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 1920, 3840), (300, 5120, 3840), (3, 72, 40)])
def test_sharded_train_row_parallel_backward_on_card(card, m, k, n):
    """The row-parallel product's backward (``layers._MmF32``) runs on the
    card: the two bf16 GEMMs of ``x @ w``'s own backward on the gradient of
    the fp32 sum, equal to autograd's of the bf16 ``x @ w``."""
    from repro_torch.models import layers as L

    g = torch.Generator().manual_seed(m + k + n)
    x = torch.randn((2, m, k), generator=g).bfloat16().to(card).requires_grad_()
    w = (torch.randn((k, n), generator=g) / k ** 0.5).bfloat16().to(card).requires_grad_()
    dy = torch.randn((2, m, n), generator=g).bfloat16().to(card)
    y = L._mm_f32(x, w)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    got = torch.autograd.grad(y.to(torch.bfloat16), [x, w], dy)
    want = torch.autograd.grad(x @ w, [x, w], dy)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        assert max_rel(a.float().cpu(), b.float().cpu()) < 1e-2


def _train_on_card_world(arch: str):
    """One rank of a world on the card: the reduced model in bf16 with block
    remat over mesh (data 1, model 2), the gradient of one batch gathered;
    the remat's recompute runs on autograd's thread for the card."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, LMDataPipeline
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves, tree_unflatten
    from repro_torch.train import train_loop as T

    mesh = make_mesh((1, 2), ("data", "model"))
    cfg = replace(get_config(arch).reduced(), dtype="bfloat16", remat="block")
    full = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    specs = SH.param_specs(full, mesh, cfg=cfg)
    local = SH.shard_params(full, specs, mesh)
    for t in tree_leaves(local):
        t.requires_grad_(True)
    raw = LMDataPipeline(DataConfig(seq_len=64, global_batch=2, vocab=cfg.vocab,
                                    seed=3)).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    before = p_rms.LAUNCHES["rmsnorm_bwd"], p_flash.LAUNCHES["flash_attention_bwd"]
    loss, grads = T.make_grads(cfg, 1, mesh)(local, batch)
    bwd = p_rms.LAUNCHES["rmsnorm_bwd"] - before[0], \
        p_flash.LAUNCHES["flash_attention_bwd"] - before[1]
    full = SH.gather_to_root(tree_unflatten(local, list(grads)), specs, mesh)
    return float(loss), None if full is None else [g.float() for g in tree_leaves(full)], bwd


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b"])
def test_sharded_train_on_card_equals_unsharded(card, arch):
    """Two ranks on the one card (collectives on gloo) take the gradient of
    the reduced bf16 model with block remat over mesh (data 1, model 2):
    K4-bwd and K5-bwd launched, the loss and every gathered gradient within
    bf16 rounding of the unsharded model's on the card (relative L2 2e-2)."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, LMDataPipeline
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import train_loop as T

    loss, grads, bwd = run_world(2, _train_on_card_world, (arch,))
    assert all(n > 0 for n in bwd), bwd
    cfg = replace(get_config(arch).reduced(), dtype="bfloat16", remat="block")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    for t in tree_leaves(params):
        t.requires_grad_(True)
    raw = LMDataPipeline(DataConfig(seq_len=64, global_batch=2, vocab=cfg.vocab,
                                    seed=3)).batch_at(0)
    want_loss, want = T.make_grads(cfg, 1)(params, {k: torch.from_numpy(v).cuda()
                                                    for k, v in raw.items()})
    assert loss == pytest.approx(float(want_loss), rel=1e-2)
    for i, (g, w) in enumerate(zip(grads, want)):
        w = w.float().cpu()
        assert float((g - w).norm()) <= 2e-2 * float(w.norm()) + 1e-6, i
