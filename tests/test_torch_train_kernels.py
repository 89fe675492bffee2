"""The gradients of K4 (RMSNorm), K5 (flash attention) and K6 (the grouped
matmul): the CPU path's against ``jax.vjp`` of the reference's
``repro/kernels/ref.py``, and K4-bwd, K5-bwd and K6-bwd against their plain
versions on a card.

On the CPU ``ops.rmsnorm``, ``ops.attention`` and ``ops.grouped_matmul`` take
the plain versions and autograd differentiates them; the reference trains on
XLA's gradient of the same functions.  fp32 tolerances: tests/test_kernels.py's
(RMSNorm 1e-5, attention rtol 2e-4 / atol 2e-5; the grouped matmul, an fp32
product over D of unit-scale inputs, rtol 1e-5 / atol 1e-4).

The ``cuda`` tests need a card and skip here; the reference is loaded in a
fixture (it needs jax), so this file also runs on a machine with a card and
no jax: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_train_kernels.py``.  Their limits are the ones
``chip_smoke.py`` holds the kernels to: bf16 gradients within 1e-2 relative
L2 per tensor of the plain version's fp32 autograd gradients of the same bf16
inputs (both sides round the inputs to bf16; the kernels also round their
outputs to bf16, 2^-9 relative, and the forward's output O, which the
backward reads for delta, was computed with P rounded to bf16), fp32 K4-bwd
within 1e-4 max-relative; every gradient bit-identical when the kernel runs
twice on the same inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as p_flash
from repro_torch.kernels import moe_gmm as p_gmm
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rmsnorm as p_rms

torch.set_num_threads(1)
RNG = np.random.default_rng(25)
RMS_TOL = 1e-5                    # tests/test_kernels.py (fp32)
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5  # tests/test_kernels.py (fp32)
BF16_GRAD_REL_L2 = 1e-2           # bf16 gradients against fp32 autograd (chip_smoke.py)
F32_RMS_GRAD_MAX_REL = 1e-4       # fp32 K4-bwd against fp32 autograd (chip_smoke.py)
# tests/test_kernels.py's flash-attention sweep: (BHq, BHkv, Sq, Skv, causal, window, offset)
ATTN_SWEEP = [(4, 4, 32, 32, True, None, 0), (4, 2, 64, 64, True, None, 0),
              (8, 2, 40, 72, True, 16, 0), (2, 1, 8, 128, True, None, 120),
              (2, 2, 48, 48, False, None, 0), (2, 2, 17, 33, True, 8, 0)]
MODEL_WIDTHS = (1024, 2304, 3840, 4096, 8192)  # Seamless, MiniCPM, Danube, Mixtral, Jamba
GMM_RTOL, GMM_ATOL = 1e-5, 1e-4  # fp32 products over D of unit-scale inputs
# K6-bwd's ragged shapes (E, C, D, F): C from 1 and past a 128-row tile, D and F
# multiples of 8 that are not multiples of the 128 x 256 tiles or 64-deep
# slices, so TMA zero-fills every edge of both products
GMM_BWD_SHAPES = [(3, 37, 40, 72), (2, 1, 8, 16), (1, 130, 136, 200), (4, 300, 264, 24),
                  (3, 5, 520, 136), (2, 200, 72, 600)]
# K5-bwd's emulation (``ref.attention_grad_mma``) at the sweep x D {64, 120,
# 128} and at one causal (4, 512, 64) case
MMA_GRAD_CASES = ([(*case, d) for case in ATTN_SWEEP for d in (64, 120, 128)]
                  + [(4, 4, 512, 512, True, None, 0, 64)])
# the kernels against their emulation given the same forward output and
# log-sum-exp: both round P and dS to bf16 at the same places and their
# outputs to bf16, so what remains is the order of fp32 sums and exp2.approx,
# which flip a few values by one bf16 step (2^-8); a fifth of the fp32 limit
MMA_EMULATION_REL_L2 = 2e-3


@pytest.fixture(scope="module")
def reference():
    jax = pytest.importorskip("jax")
    from repro.kernels import ref as r_ref

    return jax, r_ref


def _grads(out, inputs, dout):
    return torch.autograd.grad(out, inputs, dout)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


# ---------------------------------------------------------------------------
# the CPU path against the reference's gradients
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 96), (100, 128)])
def test_rmsnorm_grad_matches_reference(reference, shape):
    jax, r_ref = reference
    d = shape[-1]
    x = RNG.normal(size=shape).astype(np.float32)
    g = (1 + 0.5 * RNG.normal(size=(d,))).astype(np.float32)
    dy = RNG.normal(size=shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: r_ref.rmsnorm(a, b, eps=1e-6), x, g)
    want_dx, want_dg = (np.asarray(t) for t in vjp(dy))
    xt, gt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(g).requires_grad_()
    before = p_rms.PLAIN["rmsnorm"], p_rms.LAUNCHES["rmsnorm"], p_rms.LAUNCHES["rmsnorm_bwd"]
    dx, dg = _grads(p_ops.rmsnorm(xt, gt, eps=1e-6), (xt, gt), torch.from_numpy(dy))
    assert (p_rms.PLAIN["rmsnorm"], p_rms.LAUNCHES["rmsnorm"], p_rms.LAUNCHES["rmsnorm_bwd"]) \
        == (before[0] + 1, before[1], before[2])
    np.testing.assert_allclose(dx.numpy(), want_dx, rtol=RMS_TOL, atol=RMS_TOL)
    np.testing.assert_allclose(dg.numpy(), want_dg, rtol=RMS_TOL, atol=RMS_TOL * shape[0])


@pytest.mark.parametrize("d", (32, 64))
@pytest.mark.parametrize("bh,bkv,sq,skv,causal,window,off", ATTN_SWEEP)
def test_attention_grad_matches_reference(reference, bh, bkv, sq, skv, causal, window, off, d):
    jax, r_ref = reference
    q = RNG.normal(size=(bh, sq, d)).astype(np.float32)
    k, v = (RNG.normal(size=(bkv, skv, d)).astype(np.float32) for _ in range(2))
    do = RNG.normal(size=(bh, sq, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: r_ref.attention(a, b, c, causal=causal, window=window,
                                                     q_offset=off), q, k, v)
    want = [np.asarray(t) for t in vjp(do)]
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    before = p_flash.PLAIN["flash_attention"], dict(p_flash.LAUNCHES)
    out = p_ops.attention(qt, kt, vt, causal=causal, window=window, q_offset=off)
    got = _grads(out, (qt, kt, vt), torch.from_numpy(do))
    assert p_flash.PLAIN["flash_attention"] == before[0] + 1
    assert p_flash.LAUNCHES == before[1]
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=ATTN_RTOL, atol=ATTN_ATOL, err_msg=name)


@pytest.mark.parametrize("bh,bkv,sq,skv,causal,window,off,d", MMA_GRAD_CASES)
def test_attention_grad_mma_matches_autograd_and_reference(reference, bh, bkv, sq, skv, causal,
                                                           window, off, d):
    """K5-bwd's emulation (P and dS rounded to bf16 before their products,
    the kernels' tile order) within 1e-2 relative L2 per tensor of fp32
    autograd of ``ref.attention`` and of the reference's ``jax.vjp``: the
    limit the card holds the kernels to."""
    jax, r_ref = reference
    rng = np.random.default_rng(27)  # its own draws: the other tests' inputs stay as they were
    q = rng.normal(size=(bh, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(bkv, skv, d)).astype(np.float32) for _ in range(2))
    do = rng.normal(size=(bh, sq, d)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=off)
    _, vjp = jax.vjp(lambda a, b, c: r_ref.attention(a, b, c, **kw), q, k, v)
    from_jax = [torch.from_numpy(np.array(t)) for t in vjp(do)]
    qt, kt, vt, dot = (torch.from_numpy(t) for t in (q, k, v, do))
    got = p_ref.attention_grad_mma(qt, kt, vt, dot, **kw)
    want = p_ref.attention_grad(qt, kt, vt, dot, **kw)
    for name, g, w, r in zip("qkv", got, want, from_jax):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert 0 < rel_l2(g, w) <= BF16_GRAD_REL_L2, (name, rel_l2(g, w))
        assert rel_l2(g, r) <= BF16_GRAD_REL_L2, (name, rel_l2(g, r))


def test_attention_grad_in_tiles_matches_reference(reference, monkeypatch):
    """Above its threshold the CPU path takes the chunked plain version, as
    at long sequences: force that at 96 positions, blocks of 32 q rows."""
    jax, r_ref = reference
    import functools

    q, k, v, do = (RNG.normal(size=(4, 96, 32)).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda a, b, c: r_ref.attention(a, b, c, causal=True, window=40), q, k, v)
    want = [np.asarray(t) for t in vjp(do)]
    monkeypatch.setattr(p_ops, "CHUNKED_ATTN_THRESHOLD", 0)
    monkeypatch.setattr(p_ref, "attention_chunked",
                        functools.partial(p_ref.attention_chunked, block_q=32, block_k=32))
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    got = _grads(p_ops.attention(qt, kt, vt, causal=True, window=40), (qt, kt, vt),
                 torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=ATTN_RTOL, atol=ATTN_ATOL, err_msg=name)


@pytest.mark.parametrize("bh,bkv,sq,skv,causal,window,off", ATTN_SWEEP)
def test_backward_wrappers_take_the_plain_versions_on_cpu(bh, bkv, sq, skv, causal, window, off):
    """K4-bwd's and K5-bwd's wrappers on CPU tensors: their plain versions
    (autograd of ``kernels.ref``), counted in ``PLAIN``; the log-sum-exp of
    ``flash_attention_fwd`` is the masked ``logsumexp`` of the scaled scores."""
    d = 32
    q = torch.from_numpy(RNG.normal(size=(bh, sq, d)).astype(np.float32))
    k, v = (torch.from_numpy(RNG.normal(size=(bkv, skv, d)).astype(np.float32))
            for _ in range(2))
    do = torch.from_numpy(RNG.normal(size=(bh, sq, d)).astype(np.float32))
    kw = dict(causal=causal, window=window, q_offset=off)
    before = dict(p_flash.PLAIN), dict(p_flash.LAUNCHES)
    out, lse = p_flash.flash_attention_fwd(q, k, v, **kw)
    got = p_flash.flash_attention_bwd(q, k, v, out, do, lse, **kw)
    assert p_flash.PLAIN == {"flash_attention": before[0]["flash_attention"] + 1,
                             "flash_attention_bwd": before[0]["flash_attention_bwd"] + 1}
    assert p_flash.LAUNCHES == before[1]
    torch.testing.assert_close(out, p_ref.attention(q, k, v, **kw), rtol=0, atol=0)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    want = _grads(p_ref.attention(qr, kr, vr, **kw), (qr, kr, vr), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    kk = k.repeat_interleave(bh // bkv, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q, kk) / d ** 0.5
    pos = off + torch.arange(sq)[:, None]
    key = torch.arange(skv)[None, :]
    mask = (pos >= key) if causal else torch.ones(sq, skv, dtype=torch.bool)
    if window is not None:
        mask &= (pos - key) < window
    want_lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    want_lse = torch.where(torch.isneginf(want_lse), float("inf"), want_lse)
    torch.testing.assert_close(lse, want_lse, rtol=1e-6, atol=1e-6)


def test_rmsnorm_bwd_wrapper_on_cpu():
    x = torch.from_numpy(RNG.normal(size=(6, 40)).astype(np.float32))
    g = torch.from_numpy(RNG.normal(size=(40,)).astype(np.float32))
    dy = torch.from_numpy(RNG.normal(size=(6, 40)).astype(np.float32))
    before = p_rms.PLAIN["rmsnorm_bwd"], p_rms.LAUNCHES["rmsnorm_bwd"]
    dx, dg = p_rms.rmsnorm_bwd(x, g, dy, eps=1e-6)
    assert (p_rms.PLAIN["rmsnorm_bwd"], p_rms.LAUNCHES["rmsnorm_bwd"]) == \
        (before[0] + 1, before[1])
    xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
    want = _grads(p_ref.rmsnorm(xr, gr, eps=1e-6), (xr, gr), dy)
    torch.testing.assert_close((dx, dg), want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        p_rms.rmsnorm_bwd(x, g, dy[:5])
    with pytest.raises(TypeError):
        p_rms.rmsnorm_bwd(x, g.bfloat16(), dy)


def test_attention_bwd_wrapper_rejects_bad_shapes():
    q = torch.zeros(2, 4, 8)
    k = torch.zeros(2, 4, 8)
    lse = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        p_flash.flash_attention_bwd(q, k, k, q, q[:, :3], lse)
    with pytest.raises(ValueError):
        p_flash.flash_attention_bwd(q, k, k, q, q, lse[:, :3])


def test_no_grad_call_builds_no_autograd_function():
    """Without grad (the serving path) ``ops`` calls the forward wrappers
    alone; under grad on the CPU autograd records the plain version's ops,
    not the card's autograd function."""
    q = torch.randn(2, 8, 16, requires_grad=True)
    with torch.no_grad():
        assert p_ops.attention(q, q, q).grad_fn is None
    out = p_ops.attention(q, q, q)
    assert out.grad_fn is not None and "_Attention" not in type(out.grad_fn).__name__
    y = p_ops.rmsnorm(q, torch.ones(16))
    assert "_RMSNorm" not in type(y.grad_fn).__name__


@pytest.mark.parametrize("e,c,d,f", [(3, 11, 24, 40), (2, 37, 40, 72)])
def test_grouped_matmul_grad_matches_reference(reference, e, c, d, f):
    """``ops.grouped_matmul`` on the CPU: autograd of the plain version, the
    reference's gradient (``jax.vjp`` of its ``ref.grouped_matmul``), and
    ``ref.grouped_matmul_grad`` (K6-bwd's plain version) the same."""
    jax, r_ref = reference
    x = RNG.normal(size=(e, c, d)).astype(np.float32)
    w = RNG.normal(size=(e, d, f)).astype(np.float32)
    dy = RNG.normal(size=(e, c, f)).astype(np.float32)
    _, vjp = jax.vjp(r_ref.grouped_matmul, x, w)
    want = [np.asarray(t) for t in vjp(dy)]
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    before = dict(p_gmm.PLAIN), dict(p_gmm.LAUNCHES)
    got = _grads(p_ops.grouped_matmul(xt, wt), (xt, wt), torch.from_numpy(dy))
    assert p_gmm.PLAIN["grouped_matmul"] == before[0]["grouped_matmul"] + 1
    assert p_gmm.LAUNCHES == before[1]
    plain = p_ref.grouped_matmul_grad(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(dy))
    for name, g, p, wnt in zip(("dx", "dw"), got, plain, want):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=GMM_RTOL, atol=GMM_ATOL, err_msg=name)
        np.testing.assert_allclose(p.numpy(), wnt, rtol=GMM_RTOL, atol=GMM_ATOL, err_msg=name)


def test_grouped_matmul_bwd_wrapper_on_cpu():
    """K6-bwd's wrapper on CPU tensors: its plain version, counted in
    ``PLAIN``, in the inputs' types; wrong shapes and types raise."""
    x = torch.from_numpy(RNG.normal(size=(2, 9, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(RNG.normal(size=(2, 16, 24)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(RNG.normal(size=(2, 9, 24)).astype(np.float32)).bfloat16()
    before = p_gmm.PLAIN["grouped_matmul_bwd"], p_gmm.LAUNCHES["grouped_matmul_bwd"]
    dx, dw = p_gmm.grouped_matmul_bwd(x, w, dy)
    assert (p_gmm.PLAIN["grouped_matmul_bwd"], p_gmm.LAUNCHES["grouped_matmul_bwd"]) == \
        (before[0] + 1, before[1])
    assert dx.dtype == dw.dtype == torch.bfloat16
    want = p_ref.grouped_matmul_grad(x, w, dy)
    torch.testing.assert_close((dx, dw), want, rtol=0, atol=0)
    with pytest.raises(ValueError):
        p_gmm.grouped_matmul_bwd(x, w, dy[:, :8])
    with pytest.raises(ValueError):
        p_gmm.grouped_matmul_bwd(x, w, dy.float())
    with pytest.raises(TypeError):
        p_gmm.grouped_matmul_bwd(x, w.float(), dy)


# ---------------------------------------------------------------------------
# K4-bwd, K5-bwd and K6-bwd on a card, against their plain versions
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest -m cuda` on one")
    return torch.device("cuda")


def _on(card, *arrays, dtype):
    return [torch.from_numpy(a).to(card, dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(d, 0) for d in MODEL_WIDTHS + (40, 100)]
                         + [(2304, 1), (40, 1), (8192, 3)])
def test_rmsnorm_bwd_kernel_on_card(card, dtype, d, offset):
    """300 rows (not a multiple of any grid's row slots) at the model widths,
    40 and 100, and x and dy as views ``offset`` elements into their buffers
    (off 16 bytes: the loop kernel), each on ``bwd_plan``'s route."""
    rows = 300
    x, dy = (RNG.normal(size=(rows, d)).astype(np.float32) for _ in range(2))
    g = (0.5 + RNG.random(d)).astype(np.float32)
    xt, dyt, gt = _on(card, x, dy, g, dtype=dtype)
    if offset:  # copy into buffers that start `offset` elements in
        xt, dyt = (torch.cat([t.new_zeros(offset), t.flatten()])[offset:].view(rows, d)
                   for t in (xt, dyt))
        assert xt.data_ptr() % 16 and dyt.data_ptr() % 16
    plan = p_rms.bwd_plan(dtype, rows, d, offset == 0,
                          torch.cuda.get_device_properties(card).multi_processor_count)
    before = p_rms.LAUNCHES["rmsnorm_bwd"], p_rms.PLAIN["rmsnorm_bwd"], dict(p_rms.BWD_PATHS)
    dx, dg = p_rms.rmsnorm_bwd(xt, gt, dyt, eps=1e-6)
    dx2, dg2 = p_rms.rmsnorm_bwd(xt, gt, dyt, eps=1e-6)
    torch.cuda.synchronize()
    assert (p_rms.LAUNCHES["rmsnorm_bwd"], p_rms.PLAIN["rmsnorm_bwd"]) == \
        (before[0] + 2, before[1])
    assert {k: n - before[2][k] for k, n in p_rms.BWD_PATHS.items() if n != before[2][k]} == \
        {plan.route: 2}
    assert plan.route == ("loop" if offset or (dtype == torch.bfloat16 and d == 100) else "vec")
    assert dx.dtype == dg.dtype == dtype
    assert torch.equal(dx, dx2) and torch.equal(dg, dg2)
    want = p_ref.rmsnorm_grad(xt.float(), gt.float(), dyt.float(), eps=1e-6)
    for got, w in zip((dx, dg), want):
        if dtype == torch.float32:
            err = float((got - w).abs().max() / w.abs().max())
            assert err <= F32_RMS_GRAD_MAX_REL, err
        else:
            assert rel_l2(got, w) <= BF16_GRAD_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("d", (64, 120, 128))
@pytest.mark.parametrize("bh,bkv,sq,skv,causal,window,off", ATTN_SWEEP + [
    (16, 4, 200, 200, True, 64, 0), (4, 4, 130, 130, True, None, 0)])
def test_flash_bwd_kernel_on_card(card, bh, bkv, sq, skv, causal, window, off, d):
    q = RNG.normal(size=(bh, sq, d)).astype(np.float32)
    k, v = (RNG.normal(size=(bkv, skv, d)).astype(np.float32) for _ in range(2))
    do = RNG.normal(size=(bh, sq, d)).astype(np.float32)
    qt, kt, vt, dot = _on(card, q, k, v, do, dtype=torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=off)
    out, lse = p_flash.flash_attention_fwd(qt, kt, vt, **kw)
    before = p_flash.LAUNCHES["flash_attention_bwd"], dict(p_flash.BWD_PATHS)
    got = p_flash.flash_attention_bwd(qt, kt, vt, out, dot, lse, **kw)
    again = p_flash.flash_attention_bwd(qt, kt, vt, out, dot, lse, **kw)
    torch.cuda.synchronize()
    assert p_flash.LAUNCHES["flash_attention_bwd"] == before[0] + 2
    assert all(p_flash.BWD_PATHS[n] == before[1][n] + 2 for n in p_flash.BWD_PATHS)
    want_lse = p_ref.attention_lse(qt.float(), kt.float(), **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert not fin.any() or float((lse[fin] - want_lse[fin]).abs().max()) <= 1e-3
    want = p_ref.attention_grad(qt.float(), kt.float(), vt.float(), dot.float(), **kw)
    emulated = p_ref.attention_grad_mma(qt, kt, vt, dot, out=out, lse=lse, **kw)
    for name, g, g2, w, m in zip("qkv", got, again, want, emulated):
        assert g.dtype == torch.bfloat16 and torch.equal(g, g2), name
        assert rel_l2(g, w) <= BF16_GRAD_REL_L2, (name, rel_l2(g, w))
        assert rel_l2(g, m) <= MMA_EMULATION_REL_L2, (name, rel_l2(g, m))


@pytest.mark.cuda
def test_flash_bwd_refuses_what_it_does_not_take_on_card(card):
    q = torch.randn(2, 16, 64, device=card)
    lse = torch.zeros(2, 16, device=card)
    with pytest.raises(TypeError):
        p_flash.flash_attention_bwd(q, q, q, q, q, lse)
    wide = torch.randn(2, 16, 256, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        p_flash.flash_attention_bwd(wide, wide, wide, wide, wide, lse)
    with pytest.raises(ValueError):  # the log-sum-exp needs the tensor-core kernel
        p_flash.flash_attention_fwd(q, q, q)


@pytest.mark.cuda
def test_ops_autograd_launches_the_kernels_on_card(card):
    """Under grad ``ops.rmsnorm`` / ``ops.attention`` launch K4 / K5 forward
    and K4-bwd / K5-bwd backward, and never the plain versions; the
    gradients match autograd through the plain versions in fp32."""
    x = torch.randn(2, 128, 256, device=card, dtype=torch.bfloat16, requires_grad=True)
    g = (0.5 + torch.rand(256, device=card)).bfloat16().requires_grad_()
    plain = dict(p_rms.PLAIN), dict(p_flash.PLAIN)
    launches = dict(p_rms.LAUNCHES), dict(p_flash.LAUNCHES)
    y = p_ops.rmsnorm(x, g)
    q = y.view(2, 128, 4, 64).transpose(1, 2).reshape(8, 128, 64).contiguous()
    o = p_ops.attention(q, q, q, causal=True)
    loss = (o.float() ** 2).sum()
    dx, dg = torch.autograd.grad(loss, (x, g))
    torch.cuda.synchronize()
    assert (dict(p_rms.PLAIN), dict(p_flash.PLAIN)) == plain
    assert p_rms.LAUNCHES["rmsnorm"] == launches[0]["rmsnorm"] + 1
    assert p_rms.LAUNCHES["rmsnorm_bwd"] == launches[0]["rmsnorm_bwd"] + 1
    assert p_flash.LAUNCHES["flash_attention"] == launches[1]["flash_attention"] + 1
    assert p_flash.LAUNCHES["flash_attention_bwd"] == launches[1]["flash_attention_bwd"] + 1
    xr, gr = x.detach().float().requires_grad_(), g.detach().float().requires_grad_()
    qr = p_ref.rmsnorm(xr, gr).view(2, 128, 4, 64).transpose(1, 2).reshape(8, 128, 64)
    want = torch.autograd.grad((p_ref.attention(qr, qr, qr) ** 2).sum(), (xr, gr))
    assert rel_l2(dx, want[0]) <= 2e-2 and rel_l2(dg, want[1]) <= 2e-2


@pytest.mark.cuda
def test_trainer_steps_through_the_kernels_on_card(card, tmp_path):
    """A reduced MiniCPM in bf16 with block remat trains two steps on the
    card (accumulating two microbatches) through K4/K5 and their backward
    kernels, never their plain versions: per microbatch K4 2L + 1 forward
    launches plus 2L remat recomputes, K4-bwd 2L + 1, K5 L + L, K5-bwd L."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = replace(get_config("minicpm-2b").reduced(), dtype="bfloat16", remat="block")
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                 DataConfig(seq_len=64, global_batch=4, vocab=cfg.vocab, seed=3),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100, accum_steps=2))
    plain = dict(p_rms.PLAIN), dict(p_flash.PLAIN)
    launches = dict(p_rms.LAUNCHES), dict(p_flash.LAUNCHES)
    hist = tr.run(2)
    torch.cuda.synchronize()
    assert (dict(p_rms.PLAIN), dict(p_flash.PLAIN)) == plain
    n, mb = cfg.n_layers, 2 * 2
    moved = lambda now, was: {k: now[k] - was[k] for k in now}  # noqa: E731
    assert moved(p_rms.LAUNCHES, launches[0]) == {"rmsnorm": (4 * n + 1) * mb,
                                                  "rmsnorm_bwd": (2 * n + 1) * mb}
    assert moved(p_flash.LAUNCHES, launches[1]) == {"flash_attention": 2 * n * mb,
                                                    "flash_attention_bwd": n * mb}
    assert all(np.isfinite(h["loss"]) for h in hist) and not any(h["skipped"] for h in hist)


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", GMM_BWD_SHAPES)
def test_grouped_matmul_bwd_kernels_on_card(card, e, c, d, f):
    """K6-bwd's dx and dw kernels at ragged shapes: within 1e-2 relative L2
    per tensor of fp32 autograd of ``ref.grouped_matmul`` on the same bf16
    inputs (``ref.grouped_matmul_grad``), bit-identical over two launches."""
    x = RNG.normal(size=(e, c, d)).astype(np.float32)
    w = (RNG.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32)
    dy = RNG.normal(size=(e, c, f)).astype(np.float32)
    xt, wt, dyt = _on(card, x, w, dy, dtype=torch.bfloat16)
    before = p_gmm.LAUNCHES["grouped_matmul_bwd"], dict(p_gmm.PATHS), p_gmm.PLAIN["grouped_matmul_bwd"]
    got = p_gmm.grouped_matmul_bwd(xt, wt, dyt)
    again = p_gmm.grouped_matmul_bwd(xt, wt, dyt)
    torch.cuda.synchronize()
    assert p_gmm.LAUNCHES["grouped_matmul_bwd"] == before[0] + 2
    assert p_gmm.PLAIN["grouped_matmul_bwd"] == before[2]
    assert all(p_gmm.PATHS[k] == before[1][k] + 2 for k in ("dx", "dw"))
    xr, wr = xt.float().requires_grad_(), wt.float().requires_grad_()
    want = torch.autograd.grad(p_ref.grouped_matmul(xr, wr), (xr, wr), dyt.float())
    for name, g, g2, wnt in zip(("dx", "dw"), got, again, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, g2), name
        assert rel_l2(g, wnt) <= BF16_GRAD_REL_L2, (name, rel_l2(g, wnt))


@pytest.mark.cuda
def test_grouped_matmul_refuses_what_k6_bwd_does_not_take_on_card(card):
    """fp32 under grad is refused before the forward launches (training on
    the card is bf16 only), as are D or F not a multiple of 8; without grad
    fp32 still runs (K1's kernel)."""
    x = torch.randn(2, 16, 64, device=card, requires_grad=True)
    w = torch.randn(2, 64, 32, device=card)
    launches = dict(p_gmm.LAUNCHES)
    with pytest.raises(TypeError, match="bf16"):
        p_ops.grouped_matmul(x, w)
    assert p_gmm.LAUNCHES == launches
    with torch.no_grad():
        assert p_ops.grouped_matmul(x, w).dtype == torch.float32
    odd = torch.randn(2, 16, 60, device=card, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError):
        p_ops.grouped_matmul(odd, torch.randn(2, 60, 32, device=card, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        p_gmm.grouped_matmul_bwd(x.detach(), w, torch.randn(2, 16, 32, device=card))


@pytest.mark.cuda
def test_ops_grouped_matmul_autograd_launches_k6_bwd_on_card(card):
    """Under grad ``ops.grouped_matmul`` launches K6 forward and K6-bwd (dx
    and dw) backward, never the plain versions, and the gradients of a
    SwiGLU expert FFN match autograd through the plain version in fp32."""
    e, c, d, f = 4, 96, 256, 512
    x = (torch.randn(e, c, d, device=card) * 0.5).bfloat16().requires_grad_()
    wg, wu = ((torch.randn(e, d, f, device=card) / d ** 0.5).bfloat16().requires_grad_()
              for _ in range(2))
    wd = (torch.randn(e, f, d, device=card) / f ** 0.5).bfloat16().requires_grad_()
    plain = dict(p_gmm.PLAIN)
    launches, paths = dict(p_gmm.LAUNCHES), dict(p_gmm.PATHS)

    def ffn(ops_gmm, x, wg, wu, wd):
        return ops_gmm(torch.nn.functional.silu(ops_gmm(x, wg)) * ops_gmm(x, wu), wd)

    got = torch.autograd.grad((ffn(p_ops.grouped_matmul, x, wg, wu, wd).float() ** 2).sum(),
                              (x, wg, wu, wd))
    torch.cuda.synchronize()
    assert dict(p_gmm.PLAIN) == plain
    assert p_gmm.LAUNCHES["grouped_matmul"] == launches["grouped_matmul"] + 3
    assert p_gmm.LAUNCHES["grouped_matmul_bwd"] == launches["grouped_matmul_bwd"] + 3
    assert (p_gmm.PATHS["dx"], p_gmm.PATHS["dw"]) == (paths["dx"] + 3, paths["dw"] + 3)
    leaves = [t.detach().float().requires_grad_() for t in (x, wg, wu, wd)]
    want = torch.autograd.grad((ffn(p_ref.grouped_matmul, *leaves) ** 2).sum(), leaves)
    for name, g, wnt in zip(("x", "wg", "wu", "wd"), got, want):
        assert rel_l2(g, wnt) <= 2e-2, (name, rel_l2(g, wnt))


@pytest.mark.cuda
def test_trainer_steps_a_moe_model_through_the_kernels_on_card(card, tmp_path):
    """A reduced Mixtral in bf16 with block remat trains two steps on the
    card (two microbatches each) through K4/K5/K6 and their backward kernels,
    never a plain version: per microbatch K6 3 products a layer forward and
    3 again in the recompute, K6-bwd 3 a layer."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = replace(get_config("mixtral-8x7b").reduced(), dtype="bfloat16", remat="block")
    tr = Trainer(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4),
                 DataConfig(seq_len=64, global_batch=4, vocab=cfg.vocab, seed=3),
                 TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=100, accum_steps=2))
    plain = dict(p_rms.PLAIN), dict(p_flash.PLAIN), dict(p_gmm.PLAIN)
    launches = dict(p_gmm.LAUNCHES)
    hist = tr.run(2)
    torch.cuda.synchronize()
    assert (dict(p_rms.PLAIN), dict(p_flash.PLAIN), dict(p_gmm.PLAIN)) == plain
    n, mb = cfg.n_layers, 2 * 2
    assert {k: p_gmm.LAUNCHES[k] - launches[k] for k in launches} == {
        "grouped_matmul": 6 * n * mb, "grouped_matmul_bwd": 3 * n * mb}
    assert all(np.isfinite(h["loss"]) for h in hist) and not any(h["skipped"] for h in hist)
