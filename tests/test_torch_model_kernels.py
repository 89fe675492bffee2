"""K4 (RMSNorm) and K5 (flash attention) of the port, held against the
reference's Pallas kernels in interpret mode and its ``ref`` oracles.

On the CPU the wrappers take their plain versions (``repro_torch.kernels.ref``);
``test_torch_card.py`` runs the CUDA kernels against those plain versions on
a card.  Tolerances are tests/test_kernels.py's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.rmsnorm import rmsnorm as r_rmsnorm
from repro_torch.kernels import flash_attention as p_flash
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref
from repro_torch.kernels import rmsnorm as p_rms
from test_torch_card import ATTN_ATOL, ATTN_RTOL, ATTN_SWEEP, HEAD_SIZES, RMS_TOL, bf16_ulp

torch.set_num_threads(1)
RNG = np.random.default_rng(7)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,d", [(8, 64), (100, 96), (256, 128), (5, 32)])
def test_rmsnorm_matches_reference(r, d):
    x = RNG.normal(size=(r, d)).astype(np.float32)
    g = RNG.normal(size=(d,)).astype(np.float32)
    want = np.asarray(r_rmsnorm(x, g, block_r=32, interpret=True))
    before = p_rms.PLAIN["rmsnorm"], p_rms.LAUNCHES["rmsnorm"]
    got = p_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    assert (p_rms.PLAIN["rmsnorm"], p_rms.LAUNCHES["rmsnorm"]) == (before[0] + 1, before[1])
    np.testing.assert_allclose(got, want, rtol=RMS_TOL, atol=RMS_TOL)
    np.testing.assert_allclose(got, np.asarray(r_ref.rmsnorm(x, g)), rtol=RMS_TOL, atol=RMS_TOL)


def test_rmsnorm_any_leading_shape_and_eps():
    x = RNG.normal(size=(2, 3, 40)).astype(np.float32) * 1e-3
    g = RNG.normal(size=(40,)).astype(np.float32)
    for eps in (1e-6, 1e-5):
        want = np.asarray(r_ops.rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=eps,
                                        backend="pallas_interpret"))
        got = p_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), eps=eps).numpy()
        np.testing.assert_allclose(got, want, rtol=RMS_TOL, atol=RMS_TOL)


def test_rmsnorm_bf16_within_one_ulp_of_reference():
    """Both round the same fp32 value to bf16; the two fp32 values differ
    only in summation order, so at most one bf16 ulp apart."""
    x = RNG.normal(size=(16, 96)).astype(np.float32)
    g = (1 + 0.5 * RNG.normal(size=(96,))).astype(np.float32)
    want = np.asarray(r_ref.rmsnorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)),
                      np.float32)
    got = p_ops.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16())
    assert got.dtype == torch.bfloat16
    want_t = torch.from_numpy(want)
    assert bool(((got.float() - want_t).abs() <= bf16_ulp(want_t)).all())


def test_rmsnorm_rejects_bad_input():
    x = torch.ones(3, 8)
    with pytest.raises(ValueError):
        p_rms.rmsnorm(x, torch.ones(7))
    with pytest.raises(TypeError):
        p_rms.rmsnorm(x.double(), torch.ones(8).double())
    with pytest.raises(TypeError):
        p_rms.rmsnorm(x, torch.ones(8).bfloat16())


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------
def _qkv(bh, bkv, sq, skv, d):
    return (RNG.normal(size=(bh, sq, d)).astype(np.float32),
            RNG.normal(size=(bkv, skv, d)).astype(np.float32),
            RNG.normal(size=(bkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("d", HEAD_SIZES)
@pytest.mark.parametrize("bh,bkv,sq,skv,causal,window,off", ATTN_SWEEP)
def test_flash_attention_matches_reference(bh, bkv, sq, skv, causal, window, off, d):
    q, k, v = _qkv(bh, bkv, sq, skv, d)
    want = np.asarray(r_flash(q, k, v, causal=causal, window=window, q_offset=off,
                              block_q=16, block_k=16, interpret=True))
    before = p_flash.PLAIN["flash_attention"], p_flash.LAUNCHES["flash_attention"]
    got = p_ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, window=window, q_offset=off).numpy()
    assert (p_flash.PLAIN["flash_attention"], p_flash.LAUNCHES["flash_attention"]) == \
        (before[0] + 1, before[1])
    np.testing.assert_allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    want_ref = np.asarray(r_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window, q_offset=off))
    np.testing.assert_allclose(got, want_ref, rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_rows_with_no_visible_key_give_zero():
    q, k, v = _qkv(2, 1, 4, 8, 16)
    # window 1 with offset past the cache: only key pos itself is visible,
    # and it lies beyond Skv for every row
    got = p_ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, window=1, q_offset=20).numpy()
    want = np.asarray(r_ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, window=1, q_offset=20))
    assert not got.any() and not want.any()


def test_per_slot_offsets_match_reference_per_slot():
    """The serving path's per-slot ``q_offset``: one offset per slot, each
    slot's rows held against the reference called with that slot's int."""
    slots, heads, kv, d, skv = 4, 4, 2, 32, 40
    q, k, v = _qkv(slots * heads, slots * kv, 1, skv, d)
    lens = np.array([0, 5, 17, 39], np.int32)
    got = p_ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, q_offset=torch.from_numpy(lens)).numpy()
    for i, n in enumerate(lens):
        rows, kvr = slice(i * heads, (i + 1) * heads), slice(i * kv, (i + 1) * kv)
        want = np.asarray(r_ref.attention(jnp.asarray(q[rows]), jnp.asarray(k[kvr]),
                                          jnp.asarray(v[kvr]), causal=True, q_offset=int(n)))
        np.testing.assert_allclose(got[rows], want, rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_expand_offsets():
    assert p_flash.expand_offsets(7, 8, "cpu") == 7
    off = p_flash.expand_offsets(torch.tensor([1, 2]), 6, "cpu")
    assert off.dtype == torch.int32 and off.tolist() == [1, 1, 1, 2, 2, 2]
    with pytest.raises(ValueError):
        p_flash.expand_offsets(torch.tensor([1, 2, 3, 4]), 6, "cpu")


def test_flash_attention_rejects_bad_input():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 4, 4, 8))
    with pytest.raises(ValueError):
        p_flash.flash_attention(q, k, v)  # 3 q rows over 2 kv rows
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 4, 4, 8))
    with pytest.raises(TypeError):
        p_flash.flash_attention(q, k.double(), v)
    with pytest.raises(ValueError):
        p_flash.flash_attention(q, k, v[:, :3])


@pytest.mark.parametrize("sq,skv,causal,window,off", [
    (64, 64, True, None, 0), (100, 200, True, 32, 0),
    (33, 128, False, None, 0), (8, 96, True, None, 88),
])
def test_chunked_attention_matches_reference(sq, skv, causal, window, off):
    """tests/test_kernels.py's chunked cases, with small blocks so that KV
    blocks are skipped and rows are ragged."""
    q, k, v = _qkv(4, 2, sq, skv, 16)
    args = dict(causal=causal, window=window, q_offset=off, block_q=16, block_k=32)
    want = np.asarray(r_ref.attention_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              **args))
    got = p_ref.attention_chunked(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), **args).numpy()
    np.testing.assert_allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    plain = p_ref.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            causal=causal, window=window, q_offset=off).numpy()
    np.testing.assert_allclose(got, plain, rtol=ATTN_RTOL, atol=ATTN_ATOL)


def test_cpu_attention_switches_to_chunked_above_threshold(monkeypatch):
    """As the reference's xla path: above CHUNKED_ATTN_THRESHOLD score
    elements (and Sq > 1) the CPU takes the chunked plain version."""
    q, k, v = _qkv(2, 1, 96, 96, 16)
    calls = []
    real = p_ref.attention_chunked
    monkeypatch.setattr(p_ref, "attention_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(p_ops, "CHUNKED_ATTN_THRESHOLD", 64 * 64)
    monkeypatch.setattr(r_ops, "CHUNKED_ATTN_THRESHOLD", 64 * 64)
    got = p_ops.attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          window=40).numpy()
    want = np.asarray(r_ops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      window=40, backend="xla"))
    assert calls == [1]
    np.testing.assert_allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
    p_ops.attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k), torch.from_numpy(v),
                    q_offset=95)
    assert calls == [1]  # a single q row never goes chunked


# ---------------------------------------------------------------------------
# K5's choice between its two CUDA kernels (made before any launch)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,sq,d,aligned,want", [
    (torch.bfloat16, 2048, 120, True, "mma"),    # Danube prefill bucket / forward
    (torch.bfloat16, 8192, 120, True, "mma"),    # the windowed forward
    (torch.bfloat16, 2048, 128, True, "mma"),    # Mixtral prefill bucket
    (torch.bfloat16, 200, 64, True, "mma"),
    (torch.bfloat16, 40, 32, True, "mma"),       # a small head, padded to 128
    (torch.bfloat16, 16, 120, True, "mma"),      # the engine's shortest bucket
    (torch.bfloat16, 2, 64, True, "mma"),        # the shortest q the kernel takes
    (torch.bfloat16, 1, 64, True, "simt"),       # a decode step never takes it
    (torch.bfloat16, 1, 120, True, "simt"),      # decode
    (torch.bfloat16, 1, 128, True, "simt"),
    (torch.float32, 2048, 120, True, "simt"),    # fp32
    (torch.float32, 1, 64, True, "simt"),
    (torch.bfloat16, 2048, 136, True, "simt"),   # D > 128
    (torch.bfloat16, 2048, 256, True, "simt"),
    (torch.bfloat16, 2048, 30, True, "simt"),    # D % 8 != 0
    (torch.bfloat16, 2048, 4, True, "simt"),
    (torch.bfloat16, 2048, 120, False, "simt"),  # a pointer off 16 bytes
])
def test_flash_kernel_choice(dtype, sq, d, aligned, want):
    assert p_flash.choose_kernel(dtype, sq, d, aligned) == want


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x7b"])
def test_main_path_shapes_take_mma_and_decode_takes_simt(arch):
    """Every prefill bucket of the engine (against a 4096-position cache) and
    the 8192-token forward take the tensor-core kernel; a decode step the
    SIMT kernel."""
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import prefill_buckets

    dh = get_config(arch).head_dim
    for sq in [*prefill_buckets(4096), 8192]:
        assert p_flash.choose_kernel(torch.bfloat16, sq, dh, True) == "mma", sq
    assert p_flash.choose_kernel(torch.bfloat16, 1, dh, True) == "simt"


def test_named_kernel_entry_refuses_the_cpu_and_unknown_kernels():
    """No kernel runs on CPU tensors, and nothing falls back: the named entry
    raises instead of taking the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 8, 8, 16))
    before = dict(p_flash.PATHS), p_flash.PLAIN["flash_attention"]
    for kernel in ("mma", "simt"):
        with pytest.raises(ValueError):
            p_flash._launch(kernel, q, k, v)
    with pytest.raises(ValueError):
        p_flash._launch("sdpa", q, k, v)
    assert (dict(p_flash.PATHS), p_flash.PLAIN["flash_attention"]) == before
