"""The port's kernels on a card, each against its plain version, and the
model stack's main path on the card against the fp32 plain forward.

Needs an NVIDIA card and imports nothing of jax, so it runs on a machine
with the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_card.py``.  Without a card every test skips (decided in a
fixture).  The nest-kernel cases are tests/test_tiling.py's edge cases,
built from the port's IR; ``test_torch_kernels.py`` runs the same cases
through the plain versions against the reference on the CPU.  The K4/K5
cases are tests/test_kernels.py's sweeps plus the head sizes the configs
use, K5 through each of its two kernels (``_launch``: the tensor-core kernel
in bf16, the SIMT kernel in fp32 and bf16); ``test_torch_model_kernels.py``
holds the plain versions against the reference on the CPU.  K6 runs at
ragged shapes and at each of its tile heights (C up to 32, up to 64, above),
with and without 16-byte loads; ``test_torch_moe.py`` holds its plain
version against the reference.
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
@pytest.mark.parametrize("m,n,k", [(16, 16, 16), (100, 52, 36), (33, 17, 9), (1000, 1100, 1200)])
def test_gemm_kernel_on_card(card, m, n, k):
    x = torch.randn(m, k, device=card)
    y = torch.randn(k, n, device=card)
    before = p_gemm.LAUNCHES["gemm"]
    got = p_gemm.gemm(x, y)
    torch.cuda.synchronize()
    assert p_gemm.LAUNCHES["gemm"] == before + 1
    assert max_rel(got.cpu().numpy(), p_gemm.gemm_plain(x, y).cpu().numpy()) < MAX_REL


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
    got = p_gmm.grouped_matmul(xb, wb).float()
    want = p_ref.grouped_matmul(xb.float(), wb.float())
    row_err = (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8, 64), (100, 96), (5, 32), (1, 3840), (2048, 3840),
                                    (8, 12288), (7, 30)])
def test_rmsnorm_kernel_on_card(card, rows, d, dtype):
    g = torch.Generator(device=card).manual_seed(rows * d)
    x = torch.randn(rows, d, generator=g, device=card).to(dtype)
    gamma = (1 + 0.5 * torch.randn(d, generator=g, device=card)).to(dtype)
    before = p_rms.LAUNCHES["rmsnorm"]
    got = p_rms.rmsnorm(x, gamma, eps=1e-6)
    torch.cuda.synchronize()
    assert p_rms.LAUNCHES["rmsnorm"] == before + 1 and got.dtype == dtype
    want = p_ref.rmsnorm(x, gamma, eps=1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=RMS_TOL, atol=RMS_TOL)
    else:  # both round one fp32 result to bf16: at most one ulp apart
        assert bool(((got.float() - want.float()).abs() <= bf16_ulp(want)).all())


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
    the tensor-core kernel, a decode step and fp32 the SIMT kernel."""
    g = torch.Generator(device=card).manual_seed(6)
    k = torch.randn(8, 512, 120, generator=g, device=card).bfloat16()
    for sq, dtype, kernel in [(256, torch.bfloat16, "mma"), (1, torch.bfloat16, "simt"),
                              (256, torch.float32, "simt")]:
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
