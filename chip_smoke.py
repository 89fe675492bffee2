#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure exits nonzero):

1. device: the card's name and ``nvidia-smi``'s name and power limit;
2. build: the CUDA kernels K1 (GEMM), K4 (RMSNorm), K5 (flash attention) and
   K6 (grouped matmul) with ``nvcc`` from ``src/repro_torch/csrc``, one
   ``nvcc`` per source, all started together, with ptxas's register and
   spill lines;
3. kernels against their plain versions on the card: K1 at the kernel-test
   shapes and at 1000x1200 @ 1200x1100 in fp32, timed with its device time,
   and in bf16 through each of its kernels (wgmma, decode, mma: ragged, K =
   1, off 8, views off 16 bytes; bit-identical over two launches), timed at
   1000x1200 @ 1200x1100 beside ``torch.matmul``; the Triton nest
   kernel (K2 parallel, K3 reduction) on stencil halos, triangular guards, a
   guarded reduction with unroll 1/2/4 and each of + * max min, K3 in its
   split form too; K2 at six main-path nests (the mini CLOUDSC scheme's
   four-computation and ``dq`` nests and the saturation chain's first nest
   at 137 x 65,536, 2mm's fill and gemver's ``A`` update at LARGE,
   gesummv's 1-D combine), each timed on the device alone and a call
   beside its bound and plain version, the fill beside ``Tensor.fill_``; K3
   at every PolyBench LARGE reduction nest of the main path that splits
   (matrix-vector products, means, deviations: at least two programs per
   SM, within 2e-4 of the plain version, bit-identical over two runs),
   timed on the device beside the unsplit form, the bound and
   ``torch.addmv``, and the 3-D products' split count (1); K4 in fp32
   and bf16 over rows {1, 8, 16, 2048, 8192} x D {128, 3840, 4096, 12288},
   timed (one call and device time) at Danube's and Mixtral's decode steps
   and 2048-token buckets beside ``F.rms_norm``;
   K5's kernels (the tensor-core kernel in bf16, the SIMT kernel in fp32
   and bf16) over tests/test_kernels.py's sweep x D {32, 64, 120, 128},
   H2O-Danube3-4B's prefill (2048- and 256-token buckets against the
   engine's 4096-position cache) and 8192-token windowed forward and
   Mixtral 8x7B's prefill, and the split-KV decode kernel beside the SIMT
   kernel at both models' decode steps with per-slot offsets (bit-identical
   over repeated launches, timed as a CUDA graph beside SDPA) and at the
   edges of its grid; the kernels'
   errors and times at q lengths 1-64 over a 4096-position cache; K6 in
   fp32 and through each bf16 kernel (wgmma/TMA, decode, mma.sync) at
   ragged shapes (E = 3) and over C in {2, 16, 40, 80, 160, 320, 640} at
   Mixtral 8x7B's gate/up and down widths, the capacities of its warm-up,
   its 16-slot decode step and its 128-2048-token buckets, each timed beside
   ``torch.bmm`` and the bound (below C = 32 also as a CUDA graph, the
   decode kernel bit-identical over repeated launches);
   then each kernel's time at a main-path shape beside
   its plain version's, its bound and, where one torch call computes the
   same function, that call's time;
4. main path, PolyBench: ``Daisy(backend="cuda")`` on the 15 A variants and
   the three CLOUDSC programs at a small size against the float64 numpy
   oracle, then on the 15 benchmarks x {a, b, np} at ``bench`` size and the
   a/b variants at PolyBench/C 4.2.1 LARGE_DATASET sizes, each checked
   against ``Daisy(backend="torch")`` and timed (first and second call);
5. main path, CLOUDSC: erosion, the mini scheme and the saturation chain at
   137 levels x 65,536 columns, checked the same way;
6. counts: each kernel's launches over phases 4-5 (all must be > 0), K3's
   split runs and K2's flattened runs (each > 0), and the kernel recipes
   the planner or the contraction classifier sent to torch;
   then K1 (3xTF32) at every fp32 shape phase 4's LARGE programs handed it,
   within 2e-4 of the plain version, timed (one call and device time) beside
   full-fp32 ``torch.matmul`` and its 3xTF32 and fp32 bounds;
18. right after phase 6, the sharded Daisy path (``repro_torch.core.partition``):
   (a) ``Daisy(backend="cuda", mesh=column_mesh(1))`` over phase 5's three
   CLOUDSC programs: the plan all-replicated with its reasons, the outputs
   bit-identical to phase 5's; (b) a world of ``SHARD_RANKS`` = 2 ranks
   spawned on the one card (``launch.mesh.run_world``; their collectives on
   gloo, since NCCL refuses two ranks on one device): ``compile_scheme`` at
   137 x 65,536 column-sharded (every nest sharded, none all-reducing, each
   rank on 32,768 columns, bit-identical to the unsharded ``compile_scheme``
   on the card), the same scheme through ``Daisy(backend="cuda", mesh=)``
   with phase 5's kernel recipes (K2 launched in each rank, bit-identical to
   phase 5's run, or at the program tolerance with the reducing nests named),
   and PolyBench LARGE gemm (K1), bicg and atax (K3, one ``+`` all-reduce)
   against the unsharded card lowering (rtol 1e-3 / atol 1e-4, finite, of
   the declared shape); each rank's K1/K2/K3 launches, ``ROUTED`` and
   ``COLLECTIVES``, its shard-local, all-reduce and gather ms (2 ranks
   sharing one card: not a scaling figure);
7. main path, serving: H2O-Danube3-4B at its published widths, all 24
   layers, bf16, seeded random weights, through ``ServingEngine`` (8 slots,
   4096 positions, 32 new tokens): 16 requests with prompts of 128-2048
   tokens, served twice; from the first run, which records nothing, prefill
   tokens/s, time to first token, decode tokens/s; from the second, four
   requests' prefill and decode logits held against the fp32 plain forward
   (``models/plain.py``) within a relative L2 tolerance that fp8 weights,
   eps = 0 and gamma = 1 are each shown to exceed; a decode step's and a
   2048-token prefill bucket's device time by kernel group, and the decode
   step's again with K5's decode kernel swapped for the SIMT kernel, in
   turns; K4/K5 launches (> 0), K5's prefill only on the tensor-core kernel,
   its decode only on the decode kernel;
8. main path, forward: ``forward`` on one 8192-token sequence, so K5 runs
   with the 4096 window, held against the plain forward at 256 positions
   beyond 4096; K4/K5 launches (> 0), K5 only on the tensor-core kernel;
9. main path, MoE serving: Mixtral 8x7B at its published widths with all 8
   experts and top-2, cut in depth to 16 of its 32 layers (one stage of a
   two-stage pipeline over two cards), bf16, seeded weights, through
   ``ServingEngine`` (16 slots, 4096 positions, 32 new tokens): 32 requests
   with prompts of 128-2048 tokens, served twice as in phase 7; the serving
   metrics, dropped token-expert assignments per prefill, the tokens each
   expert keeps in each layer for the watched requests, a decode step's and
   a prefill bucket's breakdown; four requests' logits held against the fp32
   plain forward, which follows the engine's dispatch groups and its
   near-tie routing choices; the three mutants plus gates over all experts
   each exceed the tolerance; the decode step's device time with K5's and
   K6's decode kernels swapped for the kernels they replaced (K6 at C < 32
   on the wgmma and on the mma kernel), in turns; K4/K5/K6 launches (> 0),
   K5 split as in phase 7, every K6 launch on ``choose_kernel``'s pick
   (every launch below C = 32, the decode step's included, on the decode
   kernel, the buckets of 256 tokens and up on the wgmma kernel), the
   prefill bucket's K6 time by kernel; then the MoE layer alone on every
   layer's weights and random inputs, a
   2048-token bucket and a 16-slot decode step, against the plain fp32
   layer, every expert keeping tokens of the bucket;
10. seeding and transfer on the card: the tune CLI's ``tune`` in-process
   (one card, ``jobs=1``) with search (1 iteration, population 4) and the
   transfer epoch over the A variants of gemm, atax, jacobi-2d and
   correlation and CLOUDSC's erosion and scheme at ``bench``, every
   candidate built and timed on the card: its seconds, measurements, recipe
   kinds, K2/K3 launches (each > 0) and routing decisions, no nest
   quarantined or unmeasured; then ``Daisy.pretuned()`` over
   ``data/pretuned_cuda.json`` on the 15 benchmarks x {a, b, np} at
   ``bench``: every nest exact against the reference's
   ``data/pretuned_xla.json`` exact against it too, outputs against
   ``Daisy(backend="torch")``, first and second call beside phase 4's
   hand-seeded plan;
11. main path, LLaVA-NeXT-Mistral-7B (vlm) at its published widths, all 32
   layers, bf16, seeded weights: served through ``ServingEngine`` (8 slots,
   4096 positions) as in phase 7, 16 requests of 128-2048 prompt tokens,
   text-only as the reference serves it, with ``explain_kernels()`` printed;
   ``forward`` on 2880 seeded patch embeddings and 1216 text tokens, held
   against the fp32 plain forward at the last 256 text positions; then
   ``ops.matmul`` (K1) at the contraction plan's ``q_proj`` and ``ffn_in``
   products of a 2048-token bucket in fp32 and bf16, held against the plain
   version and timed beside ``torch.matmul`` (fp32 on the 3xTF32 kernel, bf16
   on the wgmma kernel); K4/K5 launches
   (> 0), K5's
   prefill only on the tensor-core kernel and its decode only on the decode
   kernel, the forward only on the tensor-core kernel;
12. main path, SeamlessM4T-large-v2 (audio) at its published widths, all 24
   encoder and 24 decoder layers, bf16, seeded: served (8 slots, 2048
   positions; 16 requests of 16-512 prompt tokens) as in phase 11, each
   request's encoder run over zero frames at prefill as the reference's
   stub frontend does, the watched logits held against the plain forward
   over the same memory; ``forward`` on 4096 seeded frames and 256 tokens;
   the same kernel routes, and every cross-attention launch of a decode
   step on K5's decode kernel (its prefill on the tensor-core kernel);
13. main path, Jamba-1.5-Large (hybrid) at its published widths with all 16
   experts and top-2, cut in depth to its first 4 of 72 layers (attention
   with a dense FFN; Mamba with MoE, with a dense FFN, with MoE: every kind
   of block in its period; 46 GB of bf16 weights, the first stage of an
   18-stage pipeline), bf16, seeded: served (8 slots, 4096 positions, 16
   requests of 128-2048 tokens prefilled at their exact length, 32 new
   tokens each) as in phase 9, its four watched requests' logits held
   against the fp32 plain forward (per-position Mamba recurrence) with the
   mutants each exceeding the limit; a request served alone against the same
   request served beside the others, token for token; ``forward`` on 4096
   tokens against the plain forward at the last 256 positions; K4, K5 and K6
   launched, K5's prefill and forward only on the tensor-core kernel and its
   decode (a GQA group of 8) only on the decode kernel, every K6 launch on
   ``choose_kernel``'s pick (C = 8 at decode, 24-320 at exact-length
   prefill); the peak device memory;
14. main path, xLSTM-350M (ssm) whole (24 layers: 21 mLSTM, 3 sLSTM, no FFN),
   seeded, the same traffic served first in fp32, its logits held against
   the plain forward (a recurrent mLSTM, the sLSTM recurrence) with the
   mutants, then in bf16 (the metrics, the request served alone), whose
   logits' distance from the plain forward is printed and not held: each
   mLSTM layer amplifies bf16's rounding (``layer_gate``'s comment), so the
   bf16 model is held one layer at a time on ``forward``'s 4096 tokens;
   K4 launched, K5 and K6 not (the family has neither attention nor an FFN);
15. online tuning inside serving, run right after phase 8 on phase 7's
   Danube weights: (a) the same kind of traffic (16 requests of 128-2048
   tokens, 32 new, 8 slots) served with the logit program
   (``autotune.logit_pipeline_program``, 32,000 x 8, B ~ N(0, 0.5), S 1.1,
   G 0.9, floor -1e9, cap 1e9) seeded to ``pallas_nest``: K2 launched once a
   decode step, in the flattened form; tokens not all equal; at one decode
   step ``Y`` bit-identical to K2's plain version and the torch-lowered
   program, K2 timed (graph and a call) beside its byte bound, the plain
   version and the torch-lowered program; the decode step's host and device
   ms without and with the program, in turns; the same traffic with
   ``program_backend="torch"`` token for token; (b) a sync
   ``SearchSupervisor`` from a stale ``vectorize`` entry (check every 4
   steps, margin 0.05, 1 iteration, population 4): every measured
   candidate, at least one swap, its generation and rollback watch, tokens
   equal to (a)'s, ``fold_back`` into a temporary file; (c) the same in
   ``mode="thread"`` (tokens equal, the thread ends, nothing quarantined);
   (d) a seeded fault plan on the greedy path (a NaN at one prefill, a failed
   step) and the sync path (temperature 1e-7, errors at one request's decode
   and another's logits): only the scheduled requests fail and the others
   generate (a)'s tokens; ``compile_resilient`` under an injected
   ``daisy.compile`` fault on ``cuda`` degrades to ``torch`` and is recorded,
   and without it stays on ``cuda``;
16. training: MiniCPM-2B (40 layers, every width, 2.72 B parameters)
   trains whole on the card through ``repro_torch.train.Trainer``, its
   forward on K4 and K5 (the tensor-core kernel, writing each row's
   log-sum-exp), its backward on K4-bwd and K5-bwd.  (a) K4-bwd in fp32 and
   bf16 at 8192 x 2304 (a microbatch) and 2048 rows at 3840, 4096, 8192 and
   1024 on its vector kernel, and on the route ``bwd_plan`` picks at 300
   rows of 40 and 100 and at views off 16 bytes, and K5-bwd at tests/test_kernels.py's sweep x D {64, 120, 128},
   MiniCPM's (144, 2048, 64), Danube's heads (D 120, group 4) at 2048 and at
   8192 with its 4096 window, and Mixtral's D 128: each gradient against the
   plain version's fp32 autograd gradients (bf16 relative L2 1e-2 per
   tensor, fp32 K4-bwd max-relative 1e-4), bit-identical over two launches,
   timed (a call and a CUDA graph) beside the bound, the plain version and
   the library's backward (``F.rms_norm``, SDPA) through autograd; (b) the
   whole model at 1 x 1024 tokens in bf16 on the kernels (block remat)
   against ``models/plain.py``'s fp32 forward and autograd on the same
   parameters: loss within 1e-2 relative, the global gradient within 5e-2
   relative L2, the five worst tensors printed; (c) six ``Trainer`` steps
   (WSD from the training CLI's 3e-4, one warm-up step, 8 x 2048 tokens in
   two microbatches): losses finite and no step skipped, every step's K4 /
   K5 / K4-bwd / K5-bwd launches exactly what the model implies (per
   microbatch 161 / 80 / 81 / 40), no plain version run, host ms a step, one
   step profiled (device ms by kernel group, idle share), tokens/s, peak
   memory, model FLOP/s as a share of 989 TFLOP/s, and
   ``explain_kernels()``; then six more steps of a fresh trainer at 3e-5,
   whose last loss must be below its first (at 3e-4 AdamW's first steps
   are too large for these widths: TRAIN_LR's comment); (d) four of its
   layers at full width:
   ``run_resilient(5, fail_at=3)`` with checkpoints every two steps against
   an uninterrupted run, losses, parameters and moments bit-identical
   (under ``torch.use_deterministic_algorithms``), the checkpoint's size
   and its save and restore seconds;
17. MoE and recurrent training, last: (a) K6-bwd (``grouped_matmul_bwd``,
   the dx and dw kernels) at Mixtral 8x7B's gate/up and down widths for C
   in {16, 40, 320, 2560}, Jamba's widths at E = 2, C = 2560 and E = 16, C =
   320, and a ragged case: dx and dw within 1e-2 relative L2 per tensor of
   fp32 autograd of ``ref.grouped_matmul`` on the same bf16 inputs,
   bit-identical over two launches, timed (a call, a CUDA graph) beside the
   bound, the plain version and ``torch.bmm`` on the transposed views; and
   K5-bwd at SeamlessM4T's non-causal D = 64 shapes (the encoder, the
   cross-attention); (b) gradient gates at 1 x 1024 tokens against the fp32
   plain model with autograd, which takes the model's expert choices: a
   2-layer Mixtral stage (every width, all 8 experts; two runs and
   ``block_save_moe`` bit-identical to ``block``), Jamba-1.5-Large's first 2
   layers with the MoE layer cut to 2 of 16 experts (these two held: loss
   within 1e-2 relative, global gradient within 5e-2 relative L2),
   xLSTM-350M whole in fp32 (the loss held; the global gradient measured
   beside the plain model's own gradient under a 1e-6 relative perturbation
   of its weights, since the model amplifies fp32 rounding past any fixed
   limit; each of its first 8 layers alone held at 5e-2) and in bf16
   (measured); (c) ``Trainer`` on the Mixtral stage,
   six steps of 8 x 2048 tokens in two microbatches at 3e-5: two runs of the
   first microbatch bit-identical, every step's K4 / K5 / K6 / K4-bwd /
   K5-bwd / K6-bwd launches exactly what the model implies, no plain
   version, the last loss below the first, host ms, one profiled step,
   tokens/s, peak memory, model FLOP/s (6 N_active T); then three steps
   each of the Jamba cut (1 x 2048) and xLSTM-350M in fp32 (4 x 256);
   (d) xLSTM-350M whole: ``run_resilient(3, fail_at=2)`` with a checkpoint
   in the reference's ``periods`` layout, bit-identical to an uninterrupted
   run;
19. sharded serving, last, with the earlier phases' models freed: (a)
   H2O-Danube3-4B on ``make_mesh((1, 1), ("data", "model"))`` serves phase
   7's traffic with its tokens and watched logits bit for bit; (b) Danube
   whole (24 layers, bf16) on mesh (data 2, model 2), 4 ranks spawned on
   the card (``run_world``, collectives on gloo), 8 slots x 4096, phase 7's
   first 8 prompts, 32 new tokens: tokens identical on every rank, the
   watched logits within LOGITS_REL_TOL of the fp32 plain forward and
   SHARD_VS_UNSHARDED_REL of the unsharded engine, on their prompts no
   further from the fp32 forward than SHARD_PLAIN_RATIO x the unsharded
   engine, greedy tokens equal the
   unsharded engine's up to its first near tie (SHARD_TIE_MARGIN), K4 and
   K5's mma and decode kernels launched on every rank, and ``wo``'s shards
   swapped between the model ranks caught by the logits gate; (c) Mixtral
   8x7B cut to 4 of 32 layers (every width, all 8 experts) on mesh (data
   1, model 2), 4 experts a rank, 16 requests through the same gates: the
   unsharded engine prefills with the sharded engine's routing (bf16 moves
   near ties of the router, and a token sent elsewhere changes by O(1)),
   so each request's dropped assignments equal the unsharded engine's and
   its prompt logits compare like with like; the decode steps route
   themselves and are compared up to the first row the two route apart;
   every kept assignment combined on exactly one rank; K6's wgmma and
   decode kernels on both ranks.  Each rank's placement, peak memory,
   prefill tok/s, decode-step host and stream ms, collective ms and
   launches are printed beside ``nvidia-smi``'s name and power limit:
   ranks sharing one card, collectives through the host, not a scaling
   figure.

In phases 4-5, kernel recipes are seeded by hand, per canonical nest, for
every nest the nest planner or the BLAS-3 idiom accepts (``pallas_gemm`` for BLAS-3 nests,
``pallas_nest`` / ``pallas_reduce`` for the rest), into a database without
nearest-neighbour transfer so each nest gets exactly its own recipe.

Phase 3 also holds K4, K5 and K6 at the shapes phases 13-14 add: K4 at
Jamba's width 8192 (a 2048-token prefill and an 8-slot decode step), K5 at
its 64 query and 8 KV heads of 128 (a 2048-token prefill into the 4096-row
cache, an 8-slot decode step: a GQA group of 8) and K6 at its expert widths
(16 experts, 8192 x 24576 and back) for C in {8, 24, 168, 320}, each against
its plain version and timed beside its bound and the torch call.

Phase 3 also holds K5 and K4 at the shapes phases 11-12 add (Seamless's
encoder and cross-attention at D = 64 and a GQA group of 1, in a bucket and
at a decode step, its self-attention decode step, LLaVA-NeXT's
4096-position causal forward, K4 at width 1024) and times each on the
device beside SDPA (``F.rms_norm``) and its bound.

K1-K3's rows in the kernels' JSON line carry ``launches_phase_18`` (the
mesh of one, and each rank of the world); K2's carries phase 18's record.
K4's, K5's and K6's rows (and their decode kernels') carry
``launches_phase_19`` per rank; K5's carries phase 19's record.

Phase 16's K4-bwd and K5-bwd rows join the kernels' JSON line; their
``launches`` are phase 16 (c)'s six steps.  Phase 17's K6-bwd row joins
it too; its ``launches`` are phase 17 (c)'s six Mixtral steps.

Output: progress lines, then a JSON line with every kernel's numbers, the
``nvidia-smi`` line with the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --k2 SRC`` runs only K2's main-path nests (and K3's
call at atax ``t1``) with the ``repro_torch`` package under SRC, so that two
trees are measured by one harness on one card, in turns, and counts the
global loads and stores in the SASS of the mini nest's kernel (``cuobjdump
-sass``); it ends with a JSON line and the ``nvidia-smi`` line.
``python3 chip_smoke.py --serve-shard SRC`` likewise runs only phase 7's
Danube traffic (which phase 19 (a) is held against) and phase 19 with the
package under SRC.
Without a card, or without ``src/repro_torch`` beside this file, it prints no
result and exits nonzero.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores,
# TF32 and bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
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
# K1's bf16 shapes in phase 3, (M, N, K, offset): each route of choose_kernel
# (wgmma: M >= 32 with K, N multiples of 8; decode: M < 32; mma: K or N not a
# multiple of 8, K = 1, views 2 bytes off 16, and LARGE, whose N is 1100)
K1_BF16_SHAPES = [(64, 32, 48, 0), (300, 264, 136, 0), (2048, 512, 1024, 0),
                  (16, 256, 512, 0), (31, 72, 40, 0), (1, 8, 8, 0),
                  (33, 17, 9, 0), (37, 70, 1, 0), (129, 65, 7, 0), (200, 90, 130, 0),
                  (64, 32, 48, 1), (300, 264, 136, 1), (1000, 1100, 1200, 0)]


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
    bf16_worst = 0.0
    for m, n, k, offset in K1_BF16_SHAPES:
        x, y = bf16_operands(torch, g, m, n, k, offset)
        kernel = kg.choose_kernel(torch.bfloat16, m, n, k, offset == 0)
        before = dict(kg.PATHS)
        out, again = kg.gemm(x, y), kg.gemm(x, y)
        torch.cuda.synchronize()
        moved = {p: kg.PATHS[p] - before[p] for p in kg.PATHS if kg.PATHS[p] != before[p]}
        if moved != {kernel: 2}:
            raise AssertionError(f"K1 bf16 {m}x{n}x{k} (offset {offset}): launched {moved}, "
                                 f"choose_kernel says {kernel}")
        if not torch.equal(out, again):
            raise AssertionError(f"K1 bf16 {m}x{n}x{k} ({kernel}): two launches differ")
        out, ref = out.float(), kg.gemm_plain(x, y).float()
        diff = float((out - ref).abs().max())
        bf16_worst = max(bf16_worst, diff)
        log(f"  K1 gemm bf16 {m}x{k} @ {k}x{n}{' (views 2 bytes off 16)' if offset else ''}: "
            f"{kernel}, max abs diff {diff:.3e}, bit-identical over two launches")
        if not torch.allclose(out, ref, rtol=BF16_RTOL, atol=BF16_ATOL):
            raise AssertionError(f"K1 bf16 {m}x{n}x{k} outside rtol {BF16_RTOL} atol {BF16_ATOL}")

    # time at the main path's shape (PolyBench LARGE gemm), fp32
    m, n, k = 1000, 1100, 1200
    x = torch.randn(m, k, generator=g, device="cuda")
    y = torch.randn(k, n, generator=g, device="cuda")
    row = time_gemm(torch, x, y)
    plain_ms = cuda_ms(lambda: kg.gemm_plain(x, y))
    log(f"  K1 gemm fp32 {m}x{k} @ {k}x{n}: kernel {row['ms']:.4f} ms (device "
        f"{fmt_ms(row['device_ms'])}, back to back {row['stream_ms']:.4f}, {row['splits']} K "
        f"ranges), plain {plain_ms:.4f} ms, "
        f"torch.matmul {row['library_ms']:.4f} ms (device {fmt_ms(row['library_device_ms'])}), "
        f"bound {row['bound_ms']:.4f} ms (3xTF32; fp32 SIMT {row['fp32_simt_bound_ms']:.4f})"
        + unsplit_note(row))
    results["gemm"] = dict(
        name="gemm", route="cuda", source="src/repro_torch/csrc/gemm.cu",
        replaces="src/repro/kernels/gemm.py:65", max_abs_err=worst, plain_ms=plain_ms, **row)

    # bf16 at the same shape (N = 1100: the mma kernel) beside torch.matmul
    x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    large = time_gemm_bf16(torch, x, y)
    log(f"  K1 gemm bf16 {m}x{k} @ {k}x{n} ({large['kernel']}): {large['ms']:.4f} ms a call, "
        f"back to back {large['stream_ms']:.4f}; plain {large['plain_ms']:.4f}; torch.matmul "
        f"{large['library_ms']:.4f} (back to back {large['library_stream_ms']:.4f}); bound "
        f"{large['bound_ms']:.4f} ms ({large['bound_by']}, bf16)")
    results["gemm_bf16"] = dict(
        name="gemm_bf16", route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/gemm.py:65", max_abs_err=bf16_worst, large=large)


def bf16_operands(torch, g, m: int, n: int, k: int, offset: int):
    """Seeded bf16 x (m, k) and y (k, n); with ``offset`` both are views
    that many elements into their buffers (2 bytes off 16 for offset 1)."""
    def made(r, c):
        flat = torch.randn(r * c + offset, generator=g, device="cuda").to(torch.bfloat16)
        return flat[offset:].view(r, c)

    return made(m, k), made(k, n)


def time_gemm_bf16(torch, x, y) -> dict:
    """K1 on bf16 x @ y (``choose_kernel``'s pick): one call under CUDA
    events (``ms``) and 20 back to back (``stream_ms``), beside the plain
    version and ``torch.matmul``; the bound is bf16 operations at 989
    TFLOP/s or the operands' and output's bytes at 3.35 TB/s, whichever is
    larger."""
    from repro_torch.kernels import gemm as kg

    (m, k), n = x.shape, y.shape[1]
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    kernel = kg.choose_kernel(x.dtype, m, n, k, aligned)
    call = lambda: kg.gemm(x, y)  # noqa: E731
    lib = lambda: torch.matmul(x, y)  # noqa: E731
    t_ops = 2.0 * m * n * k / PEAK_BF16 * 1e3
    t_bytes = 2.0 * (m * k + k * n + m * n) / PEAK_BYTES * 1e3
    return dict(shape=f"{m}x{k} @ {k}x{n} bf16", kernel=kernel, ms=cuda_ms(call),
                stream_ms=stream_ms(torch, call, n=20),
                plain_ms=cuda_ms(lambda: kg.gemm_plain(x, y), repeats=3),
                library_ms=cuda_ms(lib), library_stream_ms=stream_ms(torch, lib, n=20),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def time_gemm(torch, x, y) -> dict:
    """K1 on fp32 x @ y: one call under CUDA events (``ms``), its device
    time (``device_ms``) and its time a call back to back (``stream_ms``:
    the device's, as K1 takes 0.03-0.11 ms on the device and about 0.02
    ms of host a call), each beside ``torch.matmul``'s (full fp32); where
    ``gemm_splits`` splits K, the same product unsplit (``unsplit_*``); its
    error against the plain version (held to 2e-4), the K ranges it took,
    and the bounds: three TF32 passes at 495 TFLOP/s (``bound_ms``, the
    kernel's operations) and one fp32 pass at 67 TFLOP/s."""
    from repro_torch.kernels import gemm as kg

    (m, k), n = x.shape, y.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err = max_rel(kg.gemm(x, y), kg.gemm_plain(x, y))
    if not err <= KERNEL_MAX_REL:
        raise AssertionError(f"K1 fp32 {m}x{n}x{k}: max rel err {err} > {KERNEL_MAX_REL}")
    flops = 2.0 * m * n * k
    t_ops = 3 * flops / PEAK_TF32 * 1e3
    t_bytes = 4.0 * (m * k + k * n + m * n) / PEAK_BYTES * 1e3
    call, lib = (lambda: kg.gemm(x, y)), (lambda: torch.matmul(x, y))
    splits = kg.gemm_splits(1, m, n, k, sms)
    unsplit = dict(unsplit_ms=None, unsplit_device_ms=None, unsplit_stream_ms=None)
    if splits > 1:
        out = torch.empty(m, n, device="cuda")
        one = lambda: kg.launch_f32(x, y, out, 1, m, n, k, splits=1)  # noqa: E731
        one()
        err1 = max_rel(out, kg.gemm_plain(x, y))
        if not err1 <= KERNEL_MAX_REL:
            raise AssertionError(f"K1 fp32 {m}x{n}x{k} unsplit: max rel err {err1}")
        unsplit = dict(unsplit_ms=cuda_ms(one), unsplit_device_ms=device_ms(torch, one),
                       unsplit_stream_ms=stream_ms(torch, one))
    return dict(shape=f"{m}x{k} @ {k}x{n} fp32", max_rel_err=err, ms=cuda_ms(call),
                device_ms=device_ms(torch, call), stream_ms=stream_ms(torch, call),
                library_ms=cuda_ms(lib), library_device_ms=device_ms(torch, lib, kernels=None),
                library_stream_ms=stream_ms(torch, lib), bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                tf32_bound_ms=t_ops, fp32_simt_bound_ms=flops / PEAK_FP32 * 1e3,
                splits=splits, **unsplit)


def unsplit_note(row: dict) -> str:
    """The log's words for K1's unsplit time, where the product splits."""
    if row["unsplit_ms"] is None:
        return ""
    return (f"; unsplit {row['unsplit_ms']:.4f} ms (device {fmt_ms(row['unsplit_device_ms'])}, "
            f"back to back {row['unsplit_stream_ms']:.4f})")


def check_gemm_main_shapes(torch, shapes: dict) -> list:
    """K1 at every fp32 shape that phase 4's LARGE programs handed it, each
    beside ``torch.matmul`` and the bounds (``time_gemm``)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rows = []
    for (m, n, k), calls in sorted(shapes.items()):
        x = torch.randn(m, k, generator=g, device="cuda")
        y = torch.randn(k, n, generator=g, device="cuda")
        row = dict(time_gemm(torch, x, y), calls=calls)
        log(f"  K1 at {row['shape']} ({calls} calls in phase 4): {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}, back to back {row['stream_ms']:.4f}, {row['splits']} "
            f"K ranges, max rel err {row['max_rel_err']:.2e}); torch.matmul "
            f"{row['library_ms']:.4f} ms (device {fmt_ms(row['library_device_ms'])}, back to back "
            f"{row['library_stream_ms']:.4f}); bound {row['bound_ms']:.4f} ms, fp32 SIMT "
            f"{row['fp32_simt_bound_ms']:.4f}" + unsplit_note(row))
        rows.append(row)
    return rows


class GemmShapes:
    """While installed, the (M, N, K) of every fp32 product ``einsum2``
    hands to K1, with its count of calls."""

    def __init__(self, ops):
        self.ops = ops
        self.shapes: dict[tuple[int, int, int], int] = {}

    def gemm(self, x, y):
        if x.dtype == y.dtype and str(x.dtype) == "torch.float32":
            key = (x.shape[0], y.shape[1], x.shape[1])
            self.shapes[key] = self.shapes.get(key, 0) + 1
        return self.real(x, y)

    def __enter__(self):
        self.real, self.ops.gemm = self.ops.gemm, self.gemm
        return self

    def __exit__(self, *exc):
        self.ops.gemm = self.real


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
    # a guarded reduction whose 16 parallel tiles split its 64 reduction tiles
    cases.append(("guarded reduction 64x4096 tile=(16,16,64)", syrk1(64, 4096),
                  red((16, 16, 64), 2)))
    for op in ("+", "*", "max", "min"):
        cases.append((f"reduction {op} 4096x64", reduce_op(op, 4096, 64), red(None)))
        # one parallel tile over 64 reduction tiles: the split form
        cases.append((f"reduction {op} 64x4096", reduce_op(op, 64, 4096), red(None)))
    out = []
    for label, prog, sched in cases:
        inp = random_inputs(prog, seed=7)
        if prog.name == "reduce*":  # keep the product of the terms near 1
            inp["A"] = np.random.default_rng(7).uniform(0.99, 1.01, size=inp["A"].shape).astype(np.float32)
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


# PolyBench LARGE's reduction nests of the main path (A variants) that
# fill too few programs for the card alone: matrix-vector products and the
# means and deviations of correlation and covariance; and the 3-D products,
# whose parallel tiles already fill it
K3_SPLIT_NESTS = {"atax": ("t1", "t2"), "bicg": ("cs", "cq"), "gemver": ("x_up", "w_up"),
                  "gesummv": ("ct", "cy"), "correlation": ("sm", "ss"), "covariance": ("sm",)}
K3_FULL_NESTS = {"syrk": ("mac",), "syr2k": ("mac1", "mac2"), "correlation": ("cc",),
                 "covariance": ("cc",)}


def device_ms(torch, fn, kernels: int | None = 1, n: int = 20,
              tries: int = 3) -> float | None:
    """Device milliseconds per call of ``fn``: the kernels' own time summed
    over ``n`` calls under ``torch.profiler``, divided by ``n`` (host gaps
    and launch latency excluded, unlike ``cuda_ms``).  Only a profile that
    kept every kernel counts: ``kernels`` a call, or, where that count is not
    known beforehand (``None``, a library call), a multiple of ``n``.  On an
    H100 the profiler loses a kernel of most windows in some processes, more
    after phases 4-5, and once recorded no device time for a split K3 nest;
    such a profile is taken again, up to ``tries`` times, and the time is
    None (not measured) if none was whole."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kept = 0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        per_call, _, per_call_kernels = device_groups(torch, prof, n)
        kept = round(per_call_kernels * n)
        whole = kept == kernels * n if kernels is not None else kept > 0 and kept % n == 0
        if whole and sum(per_call.values()) > 0:
            return sum(per_call.values())
    want = f"{kernels * n}" if kernels is not None else f"a multiple of {n}"
    log(f"    (device time not measured: none of {tries} profiles of {n} calls was whole; the "
        f"last kept {kept} kernels, want {want}, and a device time)")
    return None


def stream_ms(torch, fn, n: int = 100) -> float:
    """Milliseconds per call of ``fn`` over ``n`` back-to-back calls between
    two CUDA events: the device's time per call wherever it exceeds the
    host's (the launches queue up), else the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(torch, fn, n: int = 20) -> float:
    """Device milliseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph and replayed between two CUDA events, after a warm-up call
    and a warm-up replay.  No host work runs between the kernels, so a call
    of a kernel that takes less time than the host's launch is timed on the
    card alone (``cuda_ms`` times the host's launch with it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def fmt_ms(ms: float | None) -> str:
    """A time in ms to 4 decimals, or "not measured"."""
    return "not measured" if ms is None else f"{ms:.4f}"


def _nest_bound(nk, base) -> tuple[float, float]:
    """(operation ms, byte ms) of a planned nest on these arrays: each input
    read once (an array read before the nest writes it, or the write array
    of an accumulate; a read the slab forwards is no input) and each output
    written once; a reduction's old output is an input, as it is combined
    with the result."""
    from repro_torch.core.ir import expr_ops

    points = math.prod(a.trip for a in nk.plan.axes)
    flops = float(points * sum(max(1, expr_ops(c.expr)) + (1 if c.accumulate else 0)
                               for c in nk.plan.comps))
    read, written = set(), set()
    for c in nk.plan.comps:
        read |= {r.array for r in c.reads if r.array not in written}
        if c.accumulate and c.write.array not in written:
            read.add(c.write.array)
        written.add(c.write.array)
    if nk.kind == "pallas_reduce":
        read |= written
    nbytes = 4.0 * (sum(base[a].numel() for a in read) + sum(base[a].numel() for a in written))
    return flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3


def _main_nests(nkm, prog, kind=None, names=None, device="cuda"):
    """(nest program, planned kernel) of each canonical nest of ``prog``
    the nest planner takes, as the main path plans it."""
    from repro_torch.core import Daisy, Schedule
    from repro_torch.core.scheduler import nest_program
    from repro_torch.core.tiling import TilingError

    norm = Daisy(backend="torch", device=device).plan(prog).program
    out = []
    for nest in norm.body:
        try:
            nk = nkm.plan_nest(norm, nest, Schedule(pallas_nest=True, pallas_reduce=True))
        except TilingError:
            continue
        if (kind is None or nk.plan.kind == kind) and (
                names is None or nk.plan.comps[0].name in names):
            out.append((nest_program(norm, nest), nk))
    return out


def check_nest_kernel(torch, results: dict) -> None:
    from repro_torch.core import ir
    from repro_torch.core.scheduler import random_inputs
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.polybench import BENCHMARKS

    sms = nkm.sm_count(torch.device("cuda"))
    worst = {"pallas_nest": 0.0, "pallas_reduce": 0.0}
    for label, prog, sched, inp in _nest_programs(ir):
        nk = nkm.plan_nest(prog, prog.body[0], sched)
        base = _env(torch, prog, inp)
        got, want = _copy(base), _copy(base)
        splits = nkm.reduce_splits(nk.plan, sms)
        t0 = time.perf_counter()
        nkm.run_nest(nk, got)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        nkm.nest_plain(nk, want)
        err, diff = _compare(got, want)
        worst[nk.kind] = max(worst[nk.kind], diff)
        forms = f"{splits} split{'s' if splits > 1 else ''}"
        if nk.kind == "pallas_reduce" and splits == 1 and nk.plan.reduce_grid.n_tiles > 1:
            # the split form too, where the launch would not take it
            forced = _copy(base)
            nkm.nest_launch(nk, forced, splits=nk.plan.reduce_grid.n_tiles)
            torch.cuda.synchronize()
            ferr, fdiff = _compare(forced, want)
            worst[nk.kind] = max(worst[nk.kind], fdiff)
            err = max(err, ferr)
            forms += f"; split into {nk.plan.reduce_grid.n_tiles} max rel err {ferr:.3e}"
        log(f"  {'K2' if nk.kind == 'pallas_nest' else 'K3'} {label}: blocks "
            f"{[a.block for a in nk.plan.axes]}, {forms}, max rel err {err:.3e} "
            f"(first launch incl. build {first:.2f} s)")
        if not err <= KERNEL_MAX_REL:
            raise AssertionError(f"nest kernel {label}: max rel err {err} > {KERNEL_MAX_REL}")

    results["pallas_nest"] = check_k2_nests(torch, nkm, worst["pallas_nest"])

    # K3 at every LARGE reduction nest of the main path: the launch's split
    # against the plain version, twice (bit-identical), then timed beside the
    # unsplit form, the bound and torch.addmv where it computes the same
    # function: CUDA events around one call (cuda_ms, every kernel's `ms`),
    # and the device time alone under the profiler (device_ms; the kernels
    # are microseconds long, so a timed call is mostly the host's launch)
    timings = {}
    for name, comps in K3_SPLIT_NESTS.items():
        prog = BENCHMARKS[name].variants["a"](LARGE[name])
        for nprog, nk in _main_nests(nkm, prog, "reduce", comps):
            label = f"{name} {nk.plan.comps[0].name}"
            splits = nkm.reduce_splits(nk.plan, sms)
            programs = math.prod(a.n_tiles for a in nk.plan.parallel)
            if programs * splits < nkm.PROGRAMS_PER_SM * sms:
                raise AssertionError(f"K3 {label}: {programs} x {splits} programs, fewer than "
                                     f"{nkm.PROGRAMS_PER_SM} per SM")
            base = _env(torch, nprog, random_inputs(nprog, seed=11))
            got, again, want = _copy(base), _copy(base), _copy(base)
            split_runs = nkm.SPLIT["pallas_reduce"]
            nkm.run_nest(nk, got)
            nkm.run_nest(nk, again)
            torch.cuda.synchronize()
            if nkm.SPLIT["pallas_reduce"] != split_runs + 2:
                raise AssertionError(f"K3 {label}: the launch did not take the split form")
            nkm.nest_plain(nk, want)
            err, diff = _compare(got, want)
            worst["pallas_reduce"] = max(worst["pallas_reduce"], diff)
            same = all(torch.equal(got[k], again[k]) for k in got)
            if not (err <= KERNEL_MAX_REL and same):
                raise AssertionError(f"K3 {label}: max rel err {err:.3e}, bit-identical {same}")
            work = _copy(base)
            split_call = lambda: nkm.run_nest(nk, work)  # noqa: E731
            unsplit_call = lambda: nkm.nest_launch(nk, work, splits=1)  # noqa: E731
            t = dict(splits=splits, programs=programs * splits, max_rel_err=err,
                     ms=cuda_ms(split_call), device_ms=device_ms(torch, split_call),
                     unsplit_ms=cuda_ms(unsplit_call),
                     unsplit_device_ms=device_ms(torch, unsplit_call),
                     plain_ms=cuda_ms(lambda: nkm.nest_plain(nk, work)))
            t_ops, t_bytes = _nest_bound(nk, base)
            t.update(bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes")
            t["library_ms"], t["library_device_ms"] = _addmv_library_ms(torch, nk, base, want)
            timings[label] = t
            lib = ("torch.addmv none" if t["library_ms"] is None else
                   f"torch.addmv {t['library_ms']:.4f} (device {fmt_ms(t['library_device_ms'])})")
            log(f"  K3 {label} {[a.trip for a in nk.plan.axes]}: {programs} parallel tiles x "
                f"{splits} splits = {programs * splits} programs; ms a call (device ms): split "
                f"{t['ms']:.4f} ({fmt_ms(t['device_ms'])}), unsplit {t['unsplit_ms']:.4f} "
                f"({fmt_ms(t['unsplit_device_ms'])}), {lib}, bound {t['bound_ms']:.4f} "
                f"({t['bound_by']}); plain {t['plain_ms']:.4f} ms; max rel err {err:.3e}, "
                "bit-identical over two runs")
    for name, comps in K3_FULL_NESTS.items():
        prog = BENCHMARKS[name].variants["a"](LARGE[name])
        for _, nk in _main_nests(nkm, prog, "reduce", comps):
            splits = nkm.reduce_splits(nk.plan, sms)
            programs = math.prod(a.n_tiles for a in nk.plan.parallel)
            log(f"  K3 {name} {nk.plan.comps[0].name} {[a.trip for a in nk.plan.axes]}: "
                f"{programs} programs, {splits} split (the parallel tiles fill the card)")
            if splits != 1:
                raise AssertionError(f"K3 {name}: {programs} programs split into {splits}")
    main = timings.pop("atax t1")
    results["pallas_reduce"] = dict(
        name="nest_kernel[reduce]", route="triton", source="src/repro_torch/kernels/nest_kernel.py",
        replaces="src/repro/kernels/nest_kernel.py:244 (_emit_reduce)",
        max_abs_err=worst["pallas_reduce"], ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"], library_ms=main["library_ms"],
        shape=f"atax tmp (t1) [1900, 2100], {main['splits']} splits",
        device_ms=main["device_ms"], unsplit_ms=main["unsplit_ms"],
        unsplit_device_ms=main["unsplit_device_ms"], library_device_ms=main["library_device_ms"],
        splits=main["splits"], programs=main["programs"], other_shapes=timings)


def _k2_nests(nkm):
    """(label, nest program, planned kernel) of K2's main-path nests: the
    mini CLOUDSC scheme's four-computation nest and its ``dq`` nest, the
    saturation chain's first nest (137 x 65,536), 2mm's fill and gemver's
    ``A`` update at LARGE, and gesummv's 1-D combine (1,300)."""
    from repro_torch.cloudsc import mini_cloudsc_program, saturation_chain_program
    from repro_torch.polybench import BENCHMARKS

    def pick(prog, test):
        return next(pn for pn in _main_nests(nkm, prog, "parallel") if test(pn[1]))

    def named(name):
        return lambda nk: nk.plan.comps[0].name == name

    mini = _main_nests(nkm, mini_cloudsc_program(NPROMA, KLEV), "parallel")
    large = lambda name: BENCHMARKS[name].variants["a"](LARGE[name])  # noqa: E731
    return [
        ("mini scheme nest", *max(mini, key=lambda pn: len(pn[1].plan.comps))),
        ("mini scheme dq", *next(pn for pn in mini if named("dq")(pn[1]))),
        ("saturation chain first nest",
         *pick(saturation_chain_program(NPROMA, KLEV), named("licm_pfl_rain"))),
        ("2mm fill", *pick(large("2mm"), lambda nk: not nk.plan.comps[0].reads)),
        ("gemver A update", *pick(large("gemver"), named("a_up"))),
        ("gesummv 1-D combine", *pick(large("gesummv"), named("fin"))),
    ]


def _k2_inputs(nprog):
    """Seeded inputs of a K2 nest; the CLOUDSC arrays in physical ranges."""
    from repro_torch.cloudsc import saturation_chain_inputs, scheme_inputs
    from repro_torch.core.scheduler import random_inputs

    inp = random_inputs(nprog, seed=11)
    if nprog.name.startswith(("mini_cloudsc", "saturation_chain")):
        phys = (scheme_inputs if nprog.name.startswith("mini") else saturation_chain_inputs)(
            NPROMA, KLEV)
        inp.update({k: v for k, v in phys.items() if k in inp})
    return inp


def sass_counts(cubins) -> dict | None:
    """Global loads and stores in the SASS of ``cubins`` (``cuobjdump
    -sass``): 128-bit ones and narrower ones, each with how many are
    predicated; None when there is no cubin or no ``cuobjdump``."""
    import os
    import re
    import shutil

    if not cubins:
        return None
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        import triton

        tool = str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump")
        if not os.path.exists(tool):
            return None
    counts = {f"{op} {w}{p}": 0 for op in ("LDG", "STG") for w in ("128", "narrower")
              for p in ("", " predicated")}
    for cub in sorted(cubins):
        sass = subprocess.run([tool, "-sass", str(cub)], capture_output=True, text=True,
                              timeout=120).stdout
        for m in re.finditer(r"^\s*/\*[0-9a-f]+\*/\s*(@!?U?P\w+\s+)?(LDG|STG)\.([\w.]*)", sass,
                             re.M):
            wide = "128" if re.search(r"(^|\.)128(\.|$)", m.group(3)) else "narrower"
            counts[f"{m.group(2)} {wide}{' predicated' if m.group(1) else ''}"] += 1
    return counts


def check_k2_nests(torch, nkm, worst: float, sass: bool = False) -> dict:
    """K2 at its main-path nests against the plain version (within
    ``KERNEL_MAX_REL``), each timed on the device alone (``graph_ms``) and
    a call (``cuda_ms``) beside its bound and the plain version, the fill
    beside ``Tensor.fill_``; with ``sass``, the global accesses in the SASS
    of the mini nest's kernel.  Returns K2's row of the kernels line."""
    rows = []
    counts = None
    for label, nprog, nk in _k2_nests(nkm):
        base = _env(torch, nprog, _k2_inputs(nprog))
        got, want = _copy(base), _copy(base)
        flat_runs = nkm.FLAT["pallas_nest"]
        nkm.run_nest(nk, got)
        torch.cuda.synchronize()
        flat = nkm.FLAT["pallas_nest"] > flat_runs
        if sass and label == "mini scheme nest":
            counts = sass_counts({Path(p) for ck in nk.compiled.values()
                                  for name, p in ck.metadata_group.items()
                                  if name.endswith(".cubin")})
        nkm.nest_plain(nk, want)
        err, diff = _compare(got, want)
        worst = max(worst, diff)
        if not err <= KERNEL_MAX_REL:
            raise AssertionError(f"K2 {label}: max rel err {err:.3e} > {KERNEL_MAX_REL}")
        work = _copy(base)
        call = lambda: nkm.run_nest(nk, work)  # noqa: E731
        t_ops, t_bytes = _nest_bound(nk, base)
        row = dict(nest=label, shape=[a.trip for a in nk.plan.axes], arrays=len(nk.arrays),
                   flat=flat, max_rel_err=err, graph_ms=graph_ms(torch, call), ms=cuda_ms(call),
                   plain_ms=cuda_ms(lambda: nkm.nest_plain(nk, work)),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library_ms=None, library_graph_ms=None)
        if not nk.plan.comps[0].reads:  # a constant fill: Tensor.fill_ on the same array
            arr = work[nk.plan.comps[0].write.array]
            value = float(nk.plan.comps[0].expr())
            row["library_ms"] = cuda_ms(lambda: arr.fill_(value))
            row["library_graph_ms"] = graph_ms(torch, lambda: arr.fill_(value))
        rows.append(row)
        lib = ("" if row["library_ms"] is None else
               f", fill_ {row['library_ms']:.4f} (device {row['library_graph_ms']:.4f})")
        log(f"  K2 {label} {row['shape']} ({row['arrays']} arrays, "
            f"{'flattened' if flat else 'tiled'}): device {row['graph_ms']:.4f} ms, a call "
            f"{row['ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}, "
            f"{row['bound_ms'] / row['graph_ms']:.0%} of it), plain {row['plain_ms']:.4f}{lib}; "
            f"max rel err {err:.3e}")
    if sass:
        log(f"  K2 mini scheme nest SASS: {counts if counts is not None else 'not read'}")
    main = rows[0]
    return dict(
        name="nest_kernel[parallel]", route="triton", source="src/repro_torch/kernels/nest_kernel.py",
        replaces="src/repro/kernels/nest_kernel.py:244 (_kernel)", max_abs_err=worst,
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None, graph_ms=main["graph_ms"],
        shape=f"{main['nest']} {main['shape']}", nests=rows,
        **({"sass": counts} if sass else {}))


def _addmv_library_ms(torch, nk, base, want):
    """``torch.addmv``'s (ms a call, device ms) when it reproduces the
    reduction ``y[i] += c * A[i,j] * x[j]`` (either orientation of A);
    (None, None) when it does not."""
    comp = nk.plan.comps[0]
    if comp.accumulate != "+" or comp.guards or len(comp.reads) != 2:
        return None, None
    y = base[comp.write.array]
    mats = [r for r in comp.reads if len(r.index) == 2]
    vecs = [r for r in comp.reads if len(r.index) == 1]
    if y.ndim != 1 or len(mats) != 1 or len(vecs) != 1:
        return None, None
    A, x = base[mats[0].array], base[vecs[0].array]
    scale = float(comp.expr(1.0, 1.0))
    for mat in (A, A.t()):
        if mat.shape == (y.shape[0], x.shape[0]):
            out = torch.addmv(y, mat, x, alpha=scale)
            if max_rel(out, want[comp.write.array]) <= KERNEL_MAX_REL:
                call = lambda: torch.addmv(y, mat, x, alpha=scale)  # noqa: E731
                return cuda_ms(call), device_ms(torch, call, kernels=None)
    return None, None


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


def run_program(torch, cuda_daisy, torch_daisy, program, inputs, outputs, label,
                keep: dict | None = None) -> tuple:
    """Returns ``backend="cuda"``'s first and second call, in seconds; with
    ``keep``, ``keep[label]`` holds the first call's ``outputs`` on the host."""
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
    if keep is not None:
        keep[label] = {name: env_k[name].cpu() for name in outputs}
    kinds = {}
    for n in plan.nests:
        kinds[n.recipe.kind] = kinds.get(n.recipe.kind, 0) + 1
    del env_k, env_t
    t_k = _timed(torch, fn_k, inputs)[1]
    t_t = _timed(torch, fn_t, inputs)[1]
    log(f"  {label}: ok (max rel vs torch {worst:.2e}); recipes {kinds}; "
        f"compile {t_compile:.2f} s; run: cuda {t_k:.4f} s (first {first_k:.3f} s), "
        f"torch {t_t:.4f} s (first {first_t:.3f} s)")
    return first_k, t_k


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


def main_path(torch) -> tuple[dict, dict, dict]:
    """Phases 4-5; returns the fp32 shapes K1 took in the LARGE programs,
    the hand-seeded plan's (first, second) call at ``bench`` by label and
    phase 5's CLOUDSC outputs on the host by label (phase 18 holds the
    sharded runs against them)."""
    from repro_torch.cloudsc import (erosion_program, mini_cloudsc_program, physical_inputs,
                                     saturation_chain_inputs, saturation_chain_program,
                                     scheme_inputs)
    from repro_torch.core import Daisy, TuningDatabase
    from repro_torch.core.scheduler import random_inputs
    from repro_torch.kernels import ops
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
    bench_times = {}
    for name in NAMES:
        b = BENCHMARKS[name]
        for var in ("a", "b", "np"):
            prog = b.make(var, BENCH_SIZE)
            label = f"{name}/{var} {BENCH_SIZE}"
            bench_times[label] = run_program(torch, cuda_daisy, torch_daisy, prog,
                                             random_inputs(prog, seed=3), [b.output], label)
    with GemmShapes(ops) as gemm_shapes:
        for name in NAMES:
            b = BENCHMARKS[name]
            for var in ("a", "b"):
                prog = b.variants[var](LARGE[name])
                run_program(torch, cuda_daisy, torch_daisy, prog, random_inputs(prog, seed=3),
                            [b.output], f"{name}/{var} LARGE {LARGE[name]}")

    log(f"phase 5: main path, CLOUDSC at klev={KLEV}, nproma={NPROMA}")
    phase5: dict = {}
    for label, prog, inputs, outputs in cloudsc_programs():
        run_program(torch, cuda_daisy, torch_daisy, prog, inputs, outputs, label, keep=phase5)
    return gemm_shapes.shapes, bench_times, phase5


def cloudsc_programs(nproma: int = NPROMA, klev: int = KLEV) -> list:
    """Phase 5's programs: (label, program, float32 inputs, outputs)."""
    import numpy as np

    from repro_torch.cloudsc import (erosion_program, mini_cloudsc_program, physical_inputs,
                                     saturation_chain_inputs, saturation_chain_program,
                                     scheme_inputs)

    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}  # noqa: E731
    return [("cloudsc erosion", erosion_program(nproma, klev),
             f32(physical_inputs(nproma, klev)), ["ZTP1", "ZQSMIX"]),
            ("cloudsc mini scheme", mini_cloudsc_program(nproma, klev),
             f32(scheme_inputs(nproma, klev)), ["ZTP1", "ZQSMIX", "ZQL", "ZQI", "TENDQ"]),
            ("cloudsc saturation chain", saturation_chain_program(nproma, klev),
             f32(saturation_chain_inputs(nproma, klev)), ["TEND"])]


# ---------------------------------------------------------------------------
# phase 18: the sharded Daisy path (partition planner + torch.distributed)
# ---------------------------------------------------------------------------
SHARD_RANKS = 2                            # ranks sharing the one card
SHARD_POLYBENCH = ("gemm", "bicg", "atax")  # K1; K3 with a ``+`` all-reduce
SHARD_WORLD_TIMEOUT_S = 300                # bounds each collective


def kernel_counts(kg, nkm, codegen, partition) -> dict:
    """The counters phases 4-6 read, and the executor's collectives."""
    return {"K1": kg.LAUNCHES["gemm"], "K1 by kernel": dict(kg.PATHS),
            "K2": nkm.EMITTED["pallas_nest"], "K2 flat": nkm.FLAT["pallas_nest"],
            "K3": nkm.EMITTED["pallas_reduce"], "K3 split": nkm.SPLIT["pallas_reduce"],
            "routed": dict(codegen.ROUTED),
            "collectives": {k: dict(v) for k, v in partition.COLLECTIVES.items()}}


def counts_delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            sub = counts_delta(v, before.get(k, {}))
            out[k] = {kk: vv for kk, vv in sub.items() if vv}
        else:
            out[k] = v - before.get(k, 0)
    return out


class CollectiveTimes:
    """While installed, the host-clock ms of every all-reduce and all-gather
    the executor runs, each between two synchronizations of the card."""

    def __init__(self, torch, partition):
        self.torch, self.partition = torch, partition
        self.ms = {"all_reduce": 0.0, "all_gather": 0.0}

    def _wrap(self, key, real):
        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                self.torch.cuda.synchronize()
                self.ms[key] += (time.perf_counter() - t0) * 1e3
        return timed

    def __enter__(self):
        p = self.partition
        self.real = p._all_reduce, p._all_gather
        p._all_reduce = self._wrap("all_reduce", self.real[0])
        p._all_gather = self._wrap("all_gather", self.real[1])
        return self

    def __exit__(self, *exc):
        self.partition._all_reduce, self.partition._all_gather = self.real


def sharded_run(torch, fn, inputs, kg, nkm, codegen, partition) -> tuple[dict, dict]:
    """Two calls of a sharded ``fn`` (the first compiles the shard-local
    Triton specializations); returns the first call's environment and the
    record: each call's ms, the second call's all-reduce and gather ms and
    shard-local ms (CUDA events around the call, less its collectives), and
    the counters over both calls."""
    before = kernel_counts(kg, nkm, codegen, partition)
    t0 = time.perf_counter()
    env = fn(inputs)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with CollectiveTimes(torch, partition) as coll:
        start.record()
        fn(inputs)
        end.record()
        torch.cuda.synchronize()
    call_ms = start.elapsed_time(end)
    rec = {"first_ms": first_ms, "call_ms": call_ms, "all_reduce_ms": coll.ms["all_reduce"],
           "gather_ms": coll.ms["all_gather"],
           "shard_local_ms": call_ms - coll.ms["all_reduce"] - coll.ms["all_gather"],
           "counts": counts_delta(kernel_counts(kg, nkm, codegen, partition), before)}
    return env, rec


def check_outputs(torch, label, prog, env, ref, outputs, bitwise: bool) -> float:
    """Outputs of the declared shape and finite, bit-identical to ``ref``
    or within the program tolerance; returns the largest relative error."""
    worst = 0.0
    for name in outputs:
        got, want = env[name], ref[name].to(env[name].device)
        if tuple(got.shape) != tuple(prog.array(name).shape) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"phase 18 {label}: {name} has shape {tuple(got.shape)} or "
                                 "non-finite values")
        if bitwise and not torch.equal(got, want):
            raise AssertionError(f"phase 18 {label}: {name} is not bit-identical to the "
                                 f"unsharded run (max rel {max_rel(got, want):.3e})")
        if not torch.allclose(got, want, rtol=PROGRAM_RTOL, atol=PROGRAM_ATOL):
            raise AssertionError(f"phase 18 {label}: {name} differs from the unsharded run "
                                 f"(max rel {max_rel(got, want):.3e})")
        worst = max(worst, max_rel(got, want))
    return worst


def shard_world(nproma: int, klev: int, phase5_path: str) -> list:
    """Phase 18 (b) on one rank of a world sharing the card; returns every
    rank's report (gathered to each).  Rank 0 also runs the unsharded
    references and holds the outputs against them."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.cloudsc import column_mesh, compile_scheme, mini_cloudsc_program, scheme_inputs
    from repro_torch.core import Daisy, TuningDatabase, codegen, partition
    from repro_torch.core.fusion import optimization_pipeline
    from repro_torch.core.scheduler import random_inputs
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.polybench import BENCHMARKS

    t_rank = time.perf_counter()
    mesh = column_mesh()
    rank = mesh.rank
    counters = (kg, nkm, codegen, partition)
    report = {"rank": rank, "device": str(mesh.device),
              "backend": dist.get_backend(mesh.get_group("data")),
              "columns": -(-nproma // mesh.size("data")), "runs": {}}

    def plan_of(plan) -> dict:
        return {"describe": plan.describe(), "sharded": plan.sharded,
                "reduces": [(k, r) for k, n in enumerate(plan.nests) for r in n.reduces]}

    # compile_scheme: the reference's schedule (torch ops, no kernel)
    inputs = {k: np.asarray(v, np.float32) for k, v in scheme_inputs(nproma, klev).items()}
    t0 = time.perf_counter()
    fn, plan = compile_scheme(nproma, klev, mesh=mesh)
    compile_s = time.perf_counter() - t0
    if not all(n.iterator is not None and not n.reduces for n in plan.nests):
        raise AssertionError(f"phase 18 compile_scheme: not every nest sharded without a "
                             f"collective:\n{plan.describe()}")
    env, rec = sharded_run(torch, fn, inputs, *counters)
    rec.update(plan=plan_of(plan), compile_s=compile_s)
    if rank == 0:
        ref = compile_scheme(nproma, klev, device=mesh.device)[0](inputs)
        prog = optimization_pipeline(fuse=True).run(mini_cloudsc_program(nproma, klev))
        rec["max_rel"] = check_outputs(torch, "compile_scheme", prog, env, ref,
                                       [a.name for a in prog.arrays], bitwise=True)
    report["runs"]["compile_scheme mini scheme"] = rec
    del env

    # Daisy(backend="cuda", mesh=...) with phase 5's kernel recipes: K2
    prog = mini_cloudsc_program(nproma, klev)
    d = Daisy(db=TuningDatabase(radius=-1.0), backend="cuda", mesh=mesh)
    seed_kernel_recipes(d, prog)
    t0 = time.perf_counter()
    fn, dplan = d.compile(prog)
    compile_s = time.perf_counter() - t0
    env, rec = sharded_run(torch, fn, inputs, *counters)
    rec.update(plan=plan_of(dplan.partition), compile_s=compile_s)
    if rec["counts"]["K2"] <= 0:
        raise AssertionError(f"phase 18 Daisy mini scheme: rank {rank} launched no K2")
    if rank == 0:
        phase5 = torch.load(phase5_path)
        reduces = rec["plan"]["reduces"]
        rec["max_rel"] = check_outputs(torch, "Daisy mini scheme", prog, env, phase5,
                                       list(phase5), bitwise=not reduces)
        rec["held"] = "program tolerance: nests " + str(reduces) if reduces else "bit-identical"
    report["runs"]["Daisy mini scheme"] = rec
    del env

    # PolyBench LARGE: gemm on K1, bicg and atax on K3 with a + all-reduce
    for name in SHARD_POLYBENCH:
        b = BENCHMARKS[name]
        prog = b.variants["a"](LARGE[name])
        label = f"Daisy {name}/a LARGE"
        d = Daisy(db=TuningDatabase(radius=-1.0), backend="cuda", mesh=mesh)
        seed_kernel_recipes(d, prog)
        t0 = time.perf_counter()
        fn, dplan = d.compile(prog)
        compile_s = time.perf_counter() - t0
        inputs = random_inputs(prog, seed=3)
        env, rec = sharded_run(torch, fn, inputs, *counters)
        rec.update(plan=plan_of(dplan.partition), compile_s=compile_s)
        want = {"gemm": "K1"}.get(name, "K3")
        if rec["counts"][want] <= 0:
            raise AssertionError(f"phase 18 {label}: rank {rank} launched no {want}")
        if name != "gemm" and not any(op == "+" for _, (_, op) in rec["plan"]["reduces"]):
            raise AssertionError(f"phase 18 {label}: no + all-reduce planned")
        if rank == 0:
            u = Daisy(db=d.db, backend="cuda", device=mesh.device)
            ref = u.compile(prog)[0](inputs)
            rec["max_rel"] = check_outputs(torch, label, prog, env, ref, [b.output],
                                           bitwise=False)
        report["runs"][label] = rec
        del env
    torch.cuda.synchronize()
    report["seconds"] = time.perf_counter() - t_rank
    reports = [None] * mesh.size("data")
    dist.all_gather_object(reports, report)
    return reports


def shard_phase(torch, smi: str, phase5: dict) -> dict:
    """Phase 18: (a) a mesh of one in this process, (b) ``SHARD_RANKS``
    ranks on the card (``run_world``; collectives on gloo, since NCCL
    refuses two ranks on one device); returns the phase's record."""
    import tempfile

    from repro_torch.cloudsc import column_mesh
    from repro_torch.core import Daisy, TuningDatabase, codegen, partition
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.launch.mesh import run_world

    t0 = time.perf_counter()
    out: dict = {"a": {}, "card": smi}
    d = Daisy(db=TuningDatabase(radius=-1.0), backend="cuda", mesh=column_mesh(1))
    before = kernel_counts(kg, nkm, codegen, partition)
    for label, prog, inputs, outputs in cloudsc_programs():
        seed_kernel_recipes(d, prog)
        fn, plan = d.compile(prog)
        if plan.partition is None or plan.partition.sharded:
            raise AssertionError(f"phase 18 (a) {label}: a mesh of one sharded:\n"
                                 f"{plan.partition and plan.partition.describe()}")
        env = fn(inputs)
        check_outputs(torch, f"(a) {label}", plan.program, env, phase5[label], outputs,
                      bitwise=True)
        reasons = sorted({n.reason for n in plan.partition.nests})
        out["a"][label] = {"nests": len(plan.partition.nests), "reasons": reasons}
        log(f"  (a) {label}: mesh of one, {len(plan.partition.nests)} nests replicated "
            f"({'; '.join(reasons)}); bit-identical to phase 5")
        del env
    torch.cuda.synchronize()
    out["a_counts"] = counts_delta(kernel_counts(kg, nkm, codegen, partition), before)
    if out["a_counts"]["K2"] <= 0:
        raise AssertionError("phase 18 (a): K2 was not launched")
    out["a_seconds"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip-smoke-shard-") as tmp:
        ref_path = str(Path(tmp) / "phase5_mini.pt")
        torch.save(phase5["cloudsc mini scheme"], ref_path)
        t1 = time.perf_counter()
        reports = run_world(SHARD_RANKS, shard_world, (NPROMA, KLEV, ref_path),
                            timeout_s=SHARD_WORLD_TIMEOUT_S)
        out["b_seconds"] = time.perf_counter() - t1
    if len(reports) != SHARD_RANKS or sorted(r["rank"] for r in reports) != list(range(SHARD_RANKS)):
        raise AssertionError(f"phase 18 (b): {len(reports)} reports for {SHARD_RANKS} ranks")
    out["b"] = reports
    log(f"  (b) {SHARD_RANKS} ranks sharing one H100 ({reports[0]['device']}, collectives on "
        f"{reports[0]['backend']}, {reports[0]['columns']} columns a rank), "
        f"{out['b_seconds']:.1f} s with the spawn; times below are 2 ranks sharing one H100: "
        f"not a scaling figure ({smi})")
    for label in reports[0]["runs"]:
        r0 = reports[0]["runs"][label]
        log(f"    {label}: {r0['plan']['describe'].splitlines()[0]} "
            f"{len(r0['plan']['describe'].splitlines()) - 2} nests; "
            f"all-reduces {r0['plan']['reduces']}; max rel vs unsharded {r0.get('max_rel', 0):.2e}"
            + (f" ({r0['held']})" if "held" in r0 else ""))
        for r in reports:
            x = r["runs"][label]
            c = x["counts"]
            log(f"      rank {r['rank']}: compile {x['compile_s']:.2f} s, first call "
                f"{x['first_ms']:.1f} ms; a call {x['call_ms']:.3f} ms = shard-local "
                f"{x['shard_local_ms']:.3f} + all-reduce {x['all_reduce_ms']:.3f} + gather "
                f"{x['gather_ms']:.3f}; launches over both calls K1 {c['K1']} "
                f"{c['K1 by kernel']}, K2 {c['K2']} ({c['K2 flat']} flat), K3 {c['K3']} "
                f"({c['K3 split']} split); routed {c['routed']}; collectives {c['collectives']}")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 18: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: seeding and transfer on the card
# ---------------------------------------------------------------------------
SEARCH_NAMES = ("gemm", "atax", "jacobi-2d", "correlation")  # with CLOUDSC's two programs


def seeding_path(torch, nkm, codegen, bench_times: dict) -> None:
    """Phase 10: (a) the tune CLI's ``tune`` in-process on the card, with
    search and transfer, over the A variants of ``SEARCH_NAMES`` and the two
    CLOUDSC programs at ``bench``; K2 and K3 must launch during the search and
    no nest may be quarantined or unmeasured.  (b) ``Daisy.pretuned()`` over
    ``data/pretuned_cuda.json`` on the 15 benchmarks x {a, b, np} at
    ``bench``: every nest that resolves exactly against the reference's
    ``pretuned_xla.json`` does so against it too, and the outputs agree with
    ``Daisy(backend="torch")``; each program's first and second call beside
    phase 4's hand-seeded plan."""
    import tempfile

    from repro_torch.core import Daisy, TuningDatabase
    from repro_torch.core.database import default_pretuned_path
    from repro_torch.core.scheduler import random_inputs
    from repro_torch.polybench import BENCHMARKS, NAMES
    from repro_torch.tools import tune as T

    t0 = time.perf_counter()
    emitted, routed = dict(nkm.EMITTED), dict(codegen.ROUTED)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-tune-") as tmp:
        db, _ = T.tune(suite="all", size=BENCH_SIZE, backend="cuda", device="cuda",
                       names=list(SEARCH_NAMES), out=Path(tmp) / "db.json", jobs=1,
                       iterations=1, population=4, repeats=3, verbose=False)
    torch.cuda.synchronize()
    launched = {k: nkm.EMITTED[k] - emitted[k] for k in emitted}
    routed = {k: n - routed.get(k, 0) for k, n in codegen.ROUTED.items() if n > routed.get(k, 0)}
    summary = db.summary()
    search_s = time.perf_counter() - t0
    log(f"  (a) tune: {summary['entries']} nests in {search_s:.1f} s, "
        f"{db.meta['measurements']} measurements; recipes {summary['kinds']}; provenance "
        f"{summary['provenance']}; launches K2 {launched['pallas_nest']}, K3 "
        f"{launched['pallas_reduce']}; routed to torch {sum(routed.values())}")
    for reason, n in sorted(routed.items()):
        log(f"    {n} x {reason}")
    if db.meta.get("quarantined"):
        raise AssertionError(f"phase 10: nests quarantined: {db.meta['quarantined']}")
    if summary["entries"] != db.meta["nests_tuned"] or summary["measured"] != summary["entries"]:
        raise AssertionError(f"phase 10: {db.meta['nests_tuned']} nests tuned, "
                             f"{summary['entries']} entries, {summary['measured']} measured")
    for k, n in launched.items():
        if n <= 0:
            raise AssertionError(f"phase 10: {k} was not launched during the search")

    t1 = time.perf_counter()
    pre = Daisy.pretuned()
    xla = Daisy(db=TuningDatabase.load(default_pretuned_path("xla")), backend="torch")
    plain = Daisy(backend="torch")
    n_exact = n_nests = 0
    kinds: dict[str, int] = {}
    by_idiom: dict[str, dict[str, set[str]]] = {}  # idiom -> kind -> fingerprints
    for name in NAMES:
        b = BENCHMARKS[name]
        for var in ("a", "b", "np"):
            prog = b.make(var, BENCH_SIZE)
            label = f"{name}/{var} {BENCH_SIZE}"
            want_exact = {n.fingerprint for n in xla.plan(prog).nests if n.source == "exact"}
            fn, plan = pre.compile(prog)
            lost = [n.fingerprint for n in plan.nests
                    if n.fingerprint in want_exact and n.source != "exact"]
            if lost:
                raise AssertionError(f"phase 10: {label}: {len(lost)} nests exact against "
                                     f"pretuned_xla.json are not exact against the cuda file")
            n_exact += sum(n.source == "exact" for n in plan.nests)
            n_nests += len(plan.nests)
            for n in plan.nests:
                kinds[n.recipe.kind] = kinds.get(n.recipe.kind, 0) + 1
                by_idiom.setdefault(n.idiom, {}).setdefault(n.recipe.kind, set()).add(n.fingerprint)
            inputs = random_inputs(prog, seed=3)
            env, first = _timed(torch, fn, inputs)
            ref = plain.compile(prog)[0](inputs)
            got, want = env[b.output], ref[b.output]
            if tuple(got.shape) != tuple(prog.array(b.output).shape) \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"phase 10: {label}: {b.output} has shape "
                                     f"{tuple(got.shape)} or non-finite values")
            if not torch.allclose(got, want, rtol=PROGRAM_RTOL, atol=PROGRAM_ATOL):
                raise AssertionError(f"phase 10: {label}: {b.output} differs from the torch "
                                     f"backend (max rel {max_rel(got, want):.3e})")
            del env, ref
            second = _timed(torch, fn, inputs)[1]
            hand = bench_times[label]
            log(f"  (b) {label}: ok (max rel vs torch {max_rel(got, want):.2e}); "
                f"pretuned first {first:.3f} s, second {second:.4f} s; hand-seeded "
                f"(phase 4) first {hand[0]:.3f} s, second {hand[1]:.4f} s")
    log(f"  (b) {n_exact} of {n_nests} nests exact; recipes {kinds}; "
        f"{time.perf_counter() - t1:.1f} s")
    distinct = {idiom: {k: len(fps) for k, fps in sorted(ks.items())}
                for idiom, ks in sorted(by_idiom.items())}
    log(f"  (b) recipes by idiom over the distinct nests: {distinct}")
    log(f"  phase 10: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 3, model stack: K4 and K5 against their plain versions
# ---------------------------------------------------------------------------
RMS_TOL = 1e-5                      # tests/test_kernels.py (fp32)
# K4's timed shapes: Danube's decode step (8 slots) and prefill bucket, Mixtral's
# decode step (16 slots) and prefill bucket
K4_SHAPES = [(8, 3840), (2048, 3840), (16, 4096), (2048, 4096)]
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5   # tests/test_kernels.py (fp32)
# bf16 attention, held per q row by the relative L2 error of the output, a
# measure scaled to the output (a row that sees 4096 keys has outputs of about
# 0.03, so an absolute limit would be as large as the output).  Both sides
# round their output to bf16 (2^-9 relative at most) and the kernel also
# rounds P to bf16 before P.V, as the reference kernel does, where the plain
# version keeps it in fp32.  The largest reading on an H100 over the sweep and
# Danube's shapes was 4.3e-3 (PERF.md); the limit is about twice that, so an
# error of 1% in a row (one key of 4096 too many or too few, a wrong merge of
# the warps' partial states) fails it.  fp32 is held tightly at every shape.
BF16_ATTN_REL_L2 = 8e-3
# tests/test_kernels.py's flash-attention sweep: (BHq, BHkv, Sq, Skv, causal, window, offset)
ATTN_SWEEP = [(4, 4, 32, 32, True, None, 0), (4, 2, 64, 64, True, None, 0),
              (8, 2, 40, 72, True, 16, 0), (2, 1, 8, 128, True, None, 120),
              (2, 2, 48, 48, False, None, 0), (2, 2, 17, 33, True, 8, 0)]
HEAD_SIZES = (32, 64, 120, 128)
DANUBE = "h2o-danube-3-4b"


def bf16_ulp(torch, ref):
    """One bf16 unit in the last place of each value of ``ref``."""
    mag = ref.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_rmsnorm(torch, results: dict) -> None:
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as kr

    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1, 8, 16, 2048, 8192):
            for d in (128, 3840, 4096, 12288):
                x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
                gamma = (0.5 + torch.rand(d, generator=g, device="cuda")).to(dtype)
                out = kr.rmsnorm(x, gamma, eps=1e-6)
                torch.cuda.synchronize()
                want = ref.rmsnorm(x, gamma, eps=1e-6)
                diff = (out.float() - want.float()).abs()
                worst = max(worst, float(diff.max()))
                if dtype == torch.float32:
                    ok = torch.allclose(out, want, rtol=RMS_TOL, atol=RMS_TOL)
                else:  # both round one fp32 value to bf16: at most one ulp apart
                    ok = bool((diff <= bf16_ulp(torch, want)).all())
                if not ok:
                    raise AssertionError(f"K4 rmsnorm {dtype} {rows}x{d}: max abs diff "
                                         f"{float(diff.max()):.3e}")
        log(f"  K4 rmsnorm {str(dtype)[6:]} rows {{1, 8, 16, 2048, 8192}} x D "
            f"{{128, 3840, 4096, 12288}}: "
            f"ok ({'rtol/atol 1e-5' if dtype == torch.float32 else 'within one bf16 ulp'})")

    # time at the main path's shapes: Danube's and Mixtral's decode steps and
    # 2048-token prefill buckets, bf16; the row's own numbers are Danube's bucket
    shapes = []
    for rows, d in K4_SHAPES:
        x = torch.randn(rows, d, generator=g, device="cuda").bfloat16()
        gamma = (0.5 + torch.rand(d, generator=g, device="cuda")).bfloat16()
        call = lambda: kr.rmsnorm(x, gamma, eps=1e-6)  # noqa: E731
        lib = (lambda: F.rms_norm(x, (d,), gamma, 1e-6)) if hasattr(F, "rms_norm") else None
        nbytes = 2.0 * (2 * rows * d + d)
        flops = 4.0 * rows * d  # square, sum, scale, gamma
        t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=f"{rows}x{d} bf16", ms=cuda_ms(call), device_ms=device_ms(torch, call),
                   plain_ms=cuda_ms(lambda: ref.rmsnorm(x, gamma, eps=1e-6)),
                   library_ms=cuda_ms(lib) if lib else None,
                   library_device_ms=device_ms(torch, lib, kernels=None) if lib else None,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"  K4 rmsnorm {row['shape']}: kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}), plain {row['plain_ms']:.4f} ms, F.rms_norm "
            f"{fmt_ms(row['library_ms'])} (device {fmt_ms(row['library_device_ms'])}), "
            f"bound {row['bound_ms']:.4f} ms")
        shapes.append(row)
    main = shapes[K4_SHAPES.index((2048, 3840))]
    results["rmsnorm"] = dict(
        name="rmsnorm", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:41", max_abs_err=worst, **main,
        other_shapes=[r for r in shapes if r is not main])


def _attn_bound(torch, q, k, q_offset, causal, window):
    """(operation ms, byte ms) of attention on these inputs: two products over
    the (query, key) pairs that are visible, and q, the KV rows that some
    query of their head sees and the output, each moved once."""
    bhq, sq, d = q.shape
    bhkv, skv, _ = k.shape
    off = (q_offset.to(torch.int64) if isinstance(q_offset, torch.Tensor)
           else torch.full((bhq,), int(q_offset), device=q.device))
    pos = off[:, None] + torch.arange(sq, device=q.device)[None, :]
    hi = (pos + 1).clamp(max=skv) if causal else torch.full_like(pos, skv)
    lo = (pos - window + 1).clamp(min=0) if window else torch.zeros_like(pos)
    seen = hi > lo
    pairs = int(torch.where(seen, hi - lo, 0).sum())
    lo_h = torch.where(seen, lo, skv).view(bhkv, -1).min(dim=1).values
    hi_h = torch.where(seen, hi, 0).view(bhkv, -1).max(dim=1).values
    kv_rows = int((hi_h - lo_h).clamp(min=0).sum())
    size = q.element_size()
    flops = 4.0 * pairs * d
    nbytes = size * (2.0 * q.numel() + 2.0 * kv_rows * d)
    return flops / (PEAK_BF16 if size == 2 else PEAK_FP32) * 1e3, nbytes / PEAK_BYTES * 1e3


def check_flash(torch, results: dict) -> None:
    """K5's two kernels against the plain version at every shape either can
    take, then their times at the main path's shapes beside the plain
    version's, SDPA's and the bound, and both kernels' errors and times over
    the short q lengths where ``kernels.flash_attention.choose_kernel`` draws
    the line."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    worst = 0.0

    def compare(label, kernel, q, k, v, want_fn, chunk=None, **kw):
        """(max abs diff, largest per-row relative L2 error) of K5's
        ``kernel`` (the decode kernel at ``chunk`` keys a block, None: its
        wrapper's pick) against ``want_fn``; fp32 is held by allclose, bf16
        by the row error."""
        nonlocal worst
        got = kf._launch(kernel, q, k, v, **kw, **({"chunk": chunk} if chunk else {}))
        torch.cuda.synchronize()
        want = want_fn(q, k, v, **kw)
        diff = float((got.float() - want.float()).abs().max())
        row_err = float(rel_l2(torch, got, want).max())
        worst = max(worst, diff)
        if q.dtype == torch.float32:
            ok = torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)
        else:
            ok = row_err <= BF16_ATTN_REL_L2
        if not ok:
            raise AssertionError(f"K5 {kernel} {label}: max abs diff {diff:.3e}, "
                                 f"row relative L2 {row_err:.3e}")
        return diff, row_err

    decode_rows = {}  # the decode kernel at the main path's decode steps

    def check_decode(label, q, k, v, kw, diff):
        """The decode kernel at a decode step: bit-identical over three
        launches, the arrival counters back at zero; device times of the
        kernel and of the SIMT kernel."""
        from repro_torch.kernels import runtime

        runs = [kf._launch("decode", q, k, v, **kw) for _ in range(3)]
        torch.cuda.synchronize()
        if not all(torch.equal(runs[0], r) for r in runs[1:]):
            raise AssertionError(f"K5 decode {label}: not bit-identical over three launches")
        if any(int(c.abs().sum()) for c in runtime._COUNTERS.values()):
            raise AssertionError(f"K5 decode {label}: arrival counters left nonzero")
        return dict(chunk=kf.decode_chunk(k.shape[1]), max_abs_err=diff,
                    graph_ms=graph_ms(torch, lambda: kf._launch("decode", q, k, v, **kw)),
                    simt_graph_ms=graph_ms(torch, lambda: kf._launch("simt", q, k, v, **kw)))

    def check_decode_edges() -> float:
        """The decode kernel at the edges its grid meets: a slot at offset 0
        (one key), one past Skv - 1, one that sees no key, a window, GQA
        groups 1, 6 and 16, Skv off the chunk and tile sizes; the largest
        max abs diff."""
        diff = 0.0
        for slots, heads, kvh, d, skv, lens, window in [
                (5, 8, 2, 120, 300, [1, 301, 0, 128, 129], None),
                (4, 4, 4, 64, 200, [0, 1, 64, 65], 16), (2, 16, 1, 128, 1000, [500, 1000], None),
                (3, 6, 1, 32, 130, [64, 65, 130], 100)]:
            q = rnd(slots * heads, 1, d).bfloat16()
            k, v = rnd(slots * kvh, skv, d).bfloat16(), rnd(slots * kvh, skv, d).bfloat16()
            off = kf.expand_offsets(torch.tensor([n - 1 for n in lens], dtype=torch.int32,
                                                 device="cuda"), q.shape[0], "cuda")
            kw = dict(causal=True, window=window, q_offset=off)
            for c in (64, 128, 512):
                got_diff, _ = compare(f"decode edges {lens} chunk {c}", "decode", q, k, v,
                                      ref.attention, chunk=c, **kw)
                diff = max(diff, got_diff)
            out = kf._launch("decode", q, k, v, **kw)
            for i, n in enumerate(lens):
                if n <= 0 and out[i * heads:(i + 1) * heads].any():
                    raise AssertionError(f"K5 decode: a slot that sees no key gave {out[i * heads]}")
        log("  K5 decode edges (offset 0, past Skv - 1, no key, a window, groups 1, 4, 6 and "
            f"16, chunks 64, 128 and 512): ok, max abs diff {diff:.3e}")
        return diff

    sweep_err = {"fp32 simt": 0.0, "bf16 simt": 0.0, "bf16 mma": 0.0}
    for d in HEAD_SIZES:
        for bh, bkv, sq, skv, causal, window, off in ATTN_SWEEP:
            q, k, v = rnd(bh, sq, d), rnd(bkv, skv, d), rnd(bkv, skv, d)
            kw = dict(causal=causal, window=window, q_offset=off)
            label = f"sweep {bh},{bkv},{sq},{skv},{causal},{window},{off} D={d}"
            _, err = compare(f"{label} fp32", "simt", q, k, v, ref.attention, **kw)
            sweep_err["fp32 simt"] = max(sweep_err["fp32 simt"], err)
            for kernel in ("simt", "mma"):
                _, err = compare(f"{label} bf16", kernel, q.bfloat16(), k.bfloat16(),
                                 v.bfloat16(), ref.attention, **kw)
                sweep_err[f"bf16 {kernel}"] = max(sweep_err[f"bf16 {kernel}"], err)
    log(f"  K5 flash attention: tests/test_kernels.py sweep x D {HEAD_SIZES}, fp32 on the SIMT "
        "kernel, bf16 on both: ok, largest row relative L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in sweep_err.items())
        + f" (bf16 limit {BF16_ATTN_REL_L2:g})")

    per_row = lambda q, k, v, **kw: ref.attention(  # noqa: E731
        q, k, v, causal=kw["causal"], q_offset=kf.expand_offsets(kw["q_offset"], q.shape[0],
                                                                  q.device))

    def prefill(heads, kvh, d, s, window=None, skv=None):
        return dict(kw=dict(causal=True, window=window, q_offset=0), q=(heads, s, d),
                    kv=(kvh, skv or s, d),
                    want=ref.attention if window is None else ref.attention_chunked,
                    kernels=("mma", "simt"))

    def decode(slots, heads, kvh, d, lens):
        # one offset per q row, as expand_offsets makes them from the slots'
        # (so a timed call is the kernel alone)
        slot_off = torch.tensor(lens, dtype=torch.int32, device="cuda")
        return dict(kw=dict(causal=True, q_offset=kf.expand_offsets(slot_off, slots * heads,
                                                                     "cuda")),
                    q=(slots * heads, 1, d), kv=(slots * kvh, 4096, d), want=per_row,
                    slots=slots, heads=heads, slot_off=slot_off, kernels=("decode", "simt"))

    # the shapes the serving paths give K5: a prefill bucket (2048 and 256
    # tokens) against the engine's whole 4096-position cache at offset 0, the
    # 8192-token forward (Danube) and a decode step over a 4096-position cache
    # with one offset per slot; prefill and forward through both kernels
    cases = {
        "Danube prefill": prefill(32, 8, 120, 2048, skv=4096),
        "Danube prefill 256": prefill(32, 8, 120, 256, skv=4096),
        "Danube forward": prefill(32, 8, 120, 8192, window=4096),
        "Danube decode": decode(8, 32, 8, 120, [1, 300, 1111, 2047, 2500, 3333, 4000, 4095]),
        # the lengths phase 7's slots have: prompts of 128-2048 tokens, 32 new
        "Danube decode 2k": decode(8, 32, 8, 120, [130, 500, 700, 1000, 1300, 1600, 1900, 2080]),
        "Mixtral prefill": prefill(32, 8, 128, 2048, skv=4096),
        "Mixtral decode": decode(16, 32, 8, 128, [1 + 4094 * i // 15 for i in range(16)]),
    }
    timings = {}
    for label, case in cases.items():
        kw, want_fn = case["kw"], case["want"]
        q32, k32, v32 = rnd(*case["q"]), rnd(*case["kv"]), rnd(*case["kv"])
        diff32, _ = compare(f"{label} fp32", "simt", q32, k32, v32, want_fn, **kw)
        q, k, v = q32.bfloat16(), k32.bfloat16(), v32.bfloat16()
        del q32, k32, v32
        group = q.shape[0] // k.shape[0]
        chosen = kf.choose_kernel(q.dtype, q.shape[1], q.shape[2], True, group)
        errs, ms = {}, {}
        for kernel in case["kernels"]:
            errs[kernel] = compare(f"{label} bf16", kernel, q, k, v, want_fn, **kw)
            ms[kernel] = cuda_ms(lambda: kf._launch(kernel, q, k, v, **kw))
        if "slots" in case:
            decode_rows[label] = check_decode(label, q, k, v, kw, errs["decode"][0])
        plain_ms = cuda_ms(lambda: want_fn(q, k, v, **kw), repeats=3)
        # yardstick: SDPA over the same inputs with the KV heads repeated
        if "slots" in case:
            slots, heads, d = case["slots"], case["heads"], q.shape[2]
            qq = q.view(slots, heads, 1, d)
            kk = k.repeat_interleave(group, 0).view(slots, heads, 4096, d)
            vv = v.repeat_interleave(group, 0).view(slots, heads, 4096, d)
            mask = (torch.arange(4096, device="cuda")[None, :]
                    <= case["slot_off"][:, None]).view(slots, 1, 1, 4096)
            lib = lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)  # noqa: E731
        else:
            s = q.shape[1]
            qq, kk, vv = (t.unsqueeze(0) for t in (q, k.repeat_interleave(group, 0),
                                                   v.repeat_interleave(group, 0)))
            if kw["window"] is None:
                lib = lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=True)  # noqa: E731
            else:
                pos = torch.arange(s, device="cuda")
                band = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < kw["window"])
                lib = lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=band)  # noqa: E731
        library_ms = cuda_ms(lib)
        if label in decode_rows:
            decode_rows[label]["library_graph_ms"] = graph_ms(torch, lib)
        del qq, kk, vv
        t_ops, t_bytes = _attn_bound(torch, q, k, kf.expand_offsets(kw["q_offset"], q.shape[0],
                                                                    q.device),
                                     kw["causal"], kw.get("window"))
        timings[label] = dict(kernel=chosen, ms=ms[chosen], simt_ms=ms["simt"], plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                              bound_by="operations" if t_ops >= t_bytes else "bytes",
                              row_rel_l2={k: e[1] for k, e in errs.items()})
        if label in decode_rows:
            decode_rows[label].update({k: timings[label][k] for k in (
                "ms", "simt_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
            row = decode_rows[label]
            log(f"  K5 {label}, device ms a call (CUDA graph of 20): decode "
                f"{row['graph_ms']:.4f} (chunk {row['chunk']}), simt {row['simt_graph_ms']:.4f}, "
                f"SDPA {row['library_graph_ms']:.4f}")
        log(f"  K5 {label} q {tuple(q.shape)} kv {tuple(k.shape)} bf16: "
            + ", ".join(f"{k} kernel {t:.4f} ms" for k, t in ms.items())
            + f" (the wrapper takes {chosen}), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
            f"bound {max(t_ops, t_bytes):.4f} ms ({timings[label]['bound_by']}); "
            + ", ".join(f"{k} max abs diff {e[0]:.3e}, row relative L2 {e[1]:.3e}"
                        for k, e in errs.items())
            + f"; fp32 (simt) max abs diff {diff32:.3e}")
        del q, k, v

    # where choose_kernel draws the line: Danube's heads over a 4096-position
    # cache (the engine's prefill bucket at cache length 0), short q; the
    # kernels held against the plain version, then timed (the decode kernel
    # at Sq = 1, which is all it takes)
    kv = [rnd(8, 4096, 120).bfloat16() for _ in range(2)]
    short, short_err = {}, {"mma": 0.0, "simt": 0.0, "decode": 0.0}
    for sq in (1, 2, 4, 8, 16, 32, 64):
        q = rnd(32, sq, 120).bfloat16()
        kernels = ("mma", "simt") + (("decode",) if sq == 1 else ())
        for kernel in kernels:
            _, err = compare(f"short q {sq}", kernel, q, *kv, ref.attention, causal=True)
            short_err[kernel] = max(short_err[kernel], err)
        short[sq] = {kernel: cuda_ms(lambda: kf._launch(kernel, q, *kv, causal=True))
                     for kernel in kernels}
    first_mma = min(sq for sq in short if kf.choose_kernel(torch.bfloat16, sq, 120, True) == "mma")
    log("  K5 short q, q (32, Sq, 120) kv (8, 4096, 120) bf16, offset 0, mma / simt ms: "
        + ", ".join(f"Sq {sq} {t['mma']:.4f} / {t['simt']:.4f}" for sq, t in short.items())
        + f" (decode at Sq 1: {short[1]['decode']:.4f}); the wrapper takes mma from Sq "
        f"{first_mma}; largest row relative L2 "
        + ", ".join(f"{k} {e:.3e}" for k, e in short_err.items()))
    del kv
    decode_worst = max(check_decode_edges(), *(r["max_abs_err"] for r in decode_rows.values()))

    main = timings.pop("Danube prefill")
    results["flash_attention"] = dict(
        name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:117", max_abs_err=worst, ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], kernel=main["kernel"], simt_ms=main["simt_ms"],
        shape="Danube prefill: q (32, 2048, 120), kv (8, 4096, 120), causal, offset 0, bf16",
        other_shapes=timings, short_q_ms=short, sweep_row_rel_l2=sweep_err)
    main = decode_rows.pop("Danube decode")
    results["flash_attention_decode"] = dict(
        name="flash_attention_decode", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:117", kernel="decode",
        **{k: v for k, v in main.items() if k != "max_abs_err"}, max_abs_err=decode_worst,
        shape="Danube decode: q (256, 1, 120), kv (64, 4096, 120), 8 slots at 1-4095 keys, bf16",
        other_shapes=decode_rows)


# K5 and K4 at the shapes phases 11-12 give them that no earlier phase runs:
# SeamlessM4T-large-v2's 16 heads of 64 (multi-head: a GQA group of 1) in its
# 4096-frame encoder (non-causal), its decoder's cross-attention over the
# 4096-frame memory (non-causal, offset 0) in a 2048-token bucket and at an
# 8-slot decode step, its self-attention decode step over a 2048-position
# cache, LLaVA-NeXT's 4096-position causal forward (2880 patches and 1216
# text tokens), and K4 at Seamless's width.  (q, kv, causal, kernel, slot
# lengths for a decode step, slots)
FAMILY_K5 = {
    "Seamless encoder": ((16, 4096, 64), (16, 4096, 64), False, "mma", None, 1),
    "Seamless cross prefill 2048": ((16, 2048, 64), (16, 4096, 64), False, "mma", None, 1),
    "Seamless cross decode": ((128, 1, 64), (128, 4096, 64), False, "decode", None, 8),
    # the lengths phase 12's slots reach: prompts of 16-512 tokens, 32 new
    "Seamless self decode": ((128, 1, 64), (128, 2048, 64), True, "decode",
                             [17, 60, 140, 230, 300, 390, 470, 543], 8),
    "LLaVA forward 4096": ((32, 4096, 128), (8, 4096, 128), True, "mma", None, 1),
}
FAMILY_K4 = {"Seamless 2048-token bucket": (2048, 1024)}
# Phase 13's: Jamba's 64 query and 8 KV heads of 128 (a GQA group of 8, no
# window) in a 2048-token exact-length prefill into the engine's 4096-row
# cache (causal, offset 0) and at an 8-slot decode step over that cache, with
# lengths its slots reach (prompts of 128-2048 tokens, 32 new); K4 at its
# width 8192 in that prefill and at that decode step.
RECURRENT_K5 = {
    "Jamba prefill 2048": ((64, 2048, 128), (8, 4096, 128), True, "mma", None, 1),
    "Jamba decode 8 slots": ((512, 1, 128), (64, 4096, 128), True, "decode",
                             [150, 420, 700, 1010, 1300, 1620, 1900, 2070], 8),
}
RECURRENT_K4 = {"Jamba 2048-token prefill": (2048, 8192), "Jamba 8-slot decode": (8, 8192)}


def check_family_kernels(torch, smi: str, results: dict, k5=FAMILY_K5, k4=FAMILY_K4,
                         key: str = "family_shapes", model: str = "Seamless") -> None:
    """K5 at ``k5``'s shapes and K4 at ``k4``'s, each held against its plain
    version (K5 bf16 by the row relative L2, K4 within one bf16 ulp) on the
    kernel ``choose_kernel`` picks, which must be the one named, then timed:
    a call (CUDA events), on the device alone (a CUDA graph of 20 calls, and
    for Sq > 1 and K4 also the profiler's device time) beside SDPA
    (``F.rms_norm``) timed the same way, the plain version and the bound;
    the rows go under ``key`` in each kernel's results."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as kr

    g = torch.Generator(device="cuda").manual_seed(5)
    rows = {"prefill": {}, "decode": {}}
    for label, (qs, kvs, causal, kernel, lens, slots) in k5.items():
        q = torch.randn(*qs, generator=g, device="cuda").bfloat16()
        k = torch.randn(*kvs, generator=g, device="cuda").bfloat16()
        v = torch.randn(*kvs, generator=g, device="cuda").bfloat16()
        group = qs[0] // kvs[0]
        chosen = kf.choose_kernel(q.dtype, qs[1], qs[2], True, group)
        if chosen != kernel:
            raise AssertionError(f"K5 {label}: choose_kernel takes {chosen}, not {kernel}")
        if lens is not None:  # one offset per slot, expanded to the q rows
            slot_off = torch.tensor(lens, dtype=torch.int32, device="cuda")
            off = kf.expand_offsets(slot_off, qs[0], "cuda")
        else:
            off = 0
        kw = dict(causal=causal, window=None, q_offset=off)
        call = lambda: kf._launch(None, q, k, v, **kw)  # noqa: E731
        plain = ref.attention_chunked if qs[1] * kvs[1] > 1 << 22 else ref.attention
        got = call()
        want = plain(q, k, v, **kw)
        err = float(rel_l2(torch, got, want).max())
        diff = float((got.float() - want.float()).abs().max())
        if not err <= BF16_ATTN_REL_L2:
            raise AssertionError(f"K5 {kernel} {label}: row relative L2 {err:.3e}")
        heads = qs[0] // slots
        qq = q.view(slots, heads, qs[1], qs[2])
        kk = k.repeat_interleave(group, 0).view(slots, heads, kvs[1], qs[2])
        vv = v.repeat_interleave(group, 0).view(slots, heads, kvs[1], qs[2])
        if lens is not None:
            mask = (torch.arange(kvs[1], device="cuda")[None, :]
                    <= slot_off[:, None]).view(slots, 1, 1, kvs[1])
            lib = lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)  # noqa: E731
        else:
            lib = lambda: F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal)  # noqa: E731
        t_ops, t_bytes = _attn_bound(torch, q, k, kf.expand_offsets(off, qs[0], q.device),
                                     causal, None)
        row = dict(shape=f"q {qs} kv {kvs} {'causal' if causal else 'non-causal'} bf16",
                   kernel=chosen, max_abs_err=diff, row_rel_l2=err, ms=cuda_ms(call),
                   plain_ms=cuda_ms(lambda: plain(q, k, v, **kw), repeats=3),
                   library_ms=cuda_ms(lib), bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", card=smi)
        row.update(graph_ms=graph_ms(torch, call), library_graph_ms=graph_ms(torch, lib))
        alone = f"graph {row['graph_ms']:.4f}, SDPA graph {row['library_graph_ms']:.4f}"
        if qs[1] > 1:  # also the profiler's device time, which may lose a kernel
            row.update(device_ms=device_ms(torch, call),
                       library_device_ms=device_ms(torch, lib, kernels=None))
            alone += (f"; device {fmt_ms(row['device_ms'])}, SDPA device "
                      f"{fmt_ms(row['library_device_ms'])}")
        log(f"  K5 {label} {row['shape']}: {chosen} {row['ms']:.4f} ms a call ({alone}), "
            f"plain {row['plain_ms']:.4f}, SDPA {row['library_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); row relative L2 {err:.3e}; {smi}")
        rows["decode" if qs[1] == 1 else "prefill"][label] = row
        del q, k, v, qq, kk, vv, got, want
    results["flash_attention"][key] = rows["prefill"]
    results["flash_attention_decode"][key] = rows["decode"]

    results["rmsnorm"][key] = {}
    for label, (n, d) in k4.items():
        x = torch.randn(n, d, generator=g, device="cuda").bfloat16()
        gamma = (0.5 + torch.rand(d, generator=g, device="cuda")).bfloat16()
        call = lambda: kr.rmsnorm(x, gamma, eps=1e-6)  # noqa: E731
        want = ref.rmsnorm(x, gamma, eps=1e-6)
        diff = (call().float() - want.float()).abs()
        if not bool((diff <= bf16_ulp(torch, want)).all()):
            raise AssertionError(f"K4 rmsnorm {n}x{d} bf16: max abs diff {float(diff.max()):.3e}")
        lib = (lambda: F.rms_norm(x, (d,), gamma, 1e-6)) if hasattr(F, "rms_norm") else None
        t_ops, t_bytes = 4.0 * n * d / PEAK_FP32 * 1e3, 2.0 * (2 * n * d + d) / PEAK_BYTES * 1e3
        row = dict(shape=f"{n}x{d} bf16", max_abs_err=float(diff.max()), ms=cuda_ms(call),
                   graph_ms=graph_ms(torch, call), device_ms=device_ms(torch, call),
                   plain_ms=cuda_ms(lambda: ref.rmsnorm(x, gamma, eps=1e-6)),
                   library_ms=cuda_ms(lib) if lib else None,
                   library_device_ms=device_ms(torch, lib, kernels=None) if lib else None,
                   library_graph_ms=graph_ms(torch, lib) if lib else None,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", card=smi)
        log(f"  K4 rmsnorm {row['shape']} ({model}'s width): {row['ms']:.4f} ms a call (graph "
            f"{row['graph_ms']:.4f}, device {fmt_ms(row['device_ms'])}), plain "
            f"{row['plain_ms']:.4f}, F.rms_norm {fmt_ms(row['library_ms'])} (graph "
            f"{fmt_ms(row['library_graph_ms'])}, device {fmt_ms(row['library_device_ms'])}), "
            f"bound {row['bound_ms']:.4f} ms; {smi}")
        results["rmsnorm"][key][label] = row


# ---------------------------------------------------------------------------
# phase 3, the MoE layer: K6 against its plain version
# ---------------------------------------------------------------------------
# bf16 grouped matmul, held per output row by the relative L2 error against
# the fp32 product of the same bf16 inputs.  Each kernel accumulates in fp32
# and rounds the output to bf16 once (2^-9 relative at most per value), so a
# row's error is that rounding alone: 1.68-2.25e-3 on an H100 over every shape
# below (PERF.md).  The limit is about twice that; a copy of the mma kernel
# that drops the last D slice of 32 exceeds it at every one of these shapes.
BF16_GMM_REL_L2 = 5e-3
MIXTRAL = "mixtral-8x7b"
# Mixtral 8x7B's expert products (E 8, D 4096, F 14336): gate/up and down of a
# 2048-token prefill bucket (capacity 640) and of a 16-slot decode step
# (capacity 16), gate/up of the engine's 2-token warm-up (capacity 2) and of a
# 128-token bucket (capacity 40)
GMM_SHAPES = {"prefill 2048 gate/up": (8, 640, 4096, 14336),
              "prefill 2048 down": (8, 640, 14336, 4096),
              "decode 16 slots gate/up": (8, 16, 4096, 14336),
              "decode 16 slots down": (8, 16, 14336, 4096),
              "warm-up 2 gate/up": (8, 2, 4096, 14336),
              "bucket 128 gate/up": (8, 40, 4096, 14336)}
# ragged and small shapes (E = 3): C, D, F not multiples of 16 or of the
# wgmma kernel's 128 x 256 tile and 64-deep slices, each mma tile height,
# loads one by one (D or F not a multiple of 8: mma only) and 16 bytes at a time
GMM_RAGGED = [(3, 13, 37, 29), (3, 70, 100, 45), (3, 130, 264, 200), (3, 50, 520, 1000),
              (3, 17, 4096, 14336 - 8), (3, 200, 1032, 264), (3, 333, 136, 72),
              (3, 129, 4096, 264), (3, 5, 200, 264), (3, 31, 1032, 1000)]
# the capacities of the warm-up, the 16-slot decode step and the 128-2048-token
# prefill buckets (models/layers.py moe_capacity), where choose_kernel draws
# its lines
GMM_SWEEP_C = (2, 16, 40, 80, 160, 320, 640)
GMM_WIDTHS = {"gate/up": (4096, 14336), "down": (14336, 4096)}


def check_grouped_matmul(torch, results: dict) -> None:
    """K6's kernels against the plain version: fp32 (K1's batched kernel)
    and the bf16 kernels through ``_launch`` at every ragged shape each one
    takes; then the bf16 kernels over the C sweep at Mixtral's widths, held
    and timed beside ``torch.bmm`` and the bound (below C = 32 also as a
    CUDA graph, the decode kernel bit-identical over repeated launches), and
    the plain version's time at the main path's shapes, where the public
    ``grouped_matmul`` is held and timed with the kernel it took."""
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(4)
    worst, worst_row = 0.0, {"wgmma": 0.0, "decode": 0.0, "mma": 0.0}
    decode_worst = 0.0

    def inputs(e, c, d, f):
        x = torch.randn(e, c, d, generator=g, device="cuda")
        w = torch.randn(e, d, f, generator=g, device="cuda") / d ** 0.5
        return x, w

    def bf16_row_err(kernel, xb, wb, want):
        nonlocal worst, decode_worst
        got = km._launch(kernel, xb, wb)
        torch.cuda.synchronize()
        diff = float((got.float() - want).abs().max())
        worst = max(worst, diff)
        if kernel == "decode":
            decode_worst = max(decode_worst, diff)
        err = float(rel_l2(torch, got, want).max())
        worst_row[kernel] = max(worst_row[kernel], err)
        if not err <= BF16_GMM_REL_L2:
            raise AssertionError(f"K6 {kernel} {tuple(xb.shape)} @ {tuple(wb.shape)}: bf16 "
                                 f"row relative L2 {err:.3e} > {BF16_GMM_REL_L2}")
        return err

    def takes(kernel, c, d, f):
        if kernel == "mma":
            return True
        return km._wgmma_takes(torch.bfloat16, d, f, True) and (
            kernel == "wgmma" or c <= km.WGMMA_MIN_C)

    def decode_repeats(xb, wb, label):
        """Three launches bit-identical."""
        runs = [km._launch("decode", xb, wb) for _ in range(3)]
        torch.cuda.synchronize()
        if not all(torch.equal(runs[0], r) for r in runs[1:]):
            raise AssertionError(f"K6 decode {label}: not bit-identical")

    for e, c, d, f in GMM_RAGGED:
        x, w = inputs(e, c, d, f)
        got = km.grouped_matmul(x, w)
        torch.cuda.synchronize()
        err32 = max_rel(got, ref.grouped_matmul(x, w))
        if not err32 <= KERNEL_MAX_REL:
            raise AssertionError(f"K6 fp32 ({e},{c},{d},{f}): max rel err {err32:.3e}")
        xb, wb = x.bfloat16(), w.bfloat16()
        want = ref.grouped_matmul(xb.float(), wb.float())
        errs = {k: bf16_row_err(k, xb, wb, want) for k in ("mma", "wgmma", "decode")
                if takes(k, c, d, f)}
        if "decode" in errs:
            decode_repeats(xb, wb, f"({e},{c},{d},{f})")
        log(f"  K6 grouped matmul ({e},{c},{d}) @ ({e},{d},{f}): fp32 max rel err {err32:.3e}, "
            "bf16 row relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))

    # the C sweep at Mixtral's widths: the kernels held and timed
    sweep = {}
    for width, (d, f) in GMM_WIDTHS.items():
        for c in GMM_SWEEP_C:
            x, w = inputs(8, c, d, f)
            xb, wb = x.bfloat16(), w.bfloat16()
            del x, w
            want = ref.grouped_matmul(xb.float(), wb.float())
            kernels = [k for k in ("wgmma", "decode", "mma") if takes(k, c, d, f)]
            errs = {k: bf16_row_err(k, xb, wb, want) for k in kernels}
            del want
            ms = {k: cuda_ms(lambda: km._launch(k, xb, wb)) for k in kernels}
            flops = 2.0 * 8 * c * d * f
            nbytes = 2.0 * (8 * c * d + 8 * d * f + 8 * c * f)
            t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
            lib = lambda: torch.bmm(xb, wb)  # noqa: E731
            row = dict({f"{k}_ms": t for k, t in ms.items()},
                       library_ms=cuda_ms(lib),
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       chosen=km.choose_kernel(xb.dtype, c, d, f, True),
                       row_rel_l2=errs, flops=flops)
            if "decode" in kernels:
                decode_repeats(xb, wb, f"{width} C={c}")
                row.update({f"{k}_graph_ms": graph_ms(torch, lambda: km._launch(k, xb, wb))
                            for k in kernels},
                           library_graph_ms=graph_ms(torch, lib))
            sweep[(width, c)] = row
            log(f"  K6 sweep {width} (8,{c},{d}) @ (8,{d},{f}) bf16: "
                + ", ".join(f"{k} {t:.4f} ms ({flops / t / 1e9:.1f} TFLOP/s)" for k, t in ms.items())
                + f", torch.bmm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); choose_kernel picks {row['chosen']}; row relative L2 "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            if "decode" in kernels:
                log(f"    device ms a call (CUDA graph of 20): "
                    + ", ".join(f"{k} {row[f'{k}_graph_ms']:.4f}" for k in kernels)
                    + f", torch.bmm {row['library_graph_ms']:.4f}")
            del xb, wb
    for width in GMM_WIDTHS:
        small = [c for c in GMM_SWEEP_C if c < km.WGMMA_MIN_C]
        log(f"  K6 sweep {width}: below C = {km.WGMMA_MIN_C} (the decode kernel's), device "
            "decode / wgmma / mma / torch.bmm ms: " + ", ".join(
                f"C {c} {sweep[(width, c)]['decode_graph_ms']:.4f} / "
                f"{sweep[(width, c)]['wgmma_graph_ms']:.4f} / "
                f"{sweep[(width, c)]['mma_graph_ms']:.4f} / "
                f"{sweep[(width, c)]['library_graph_ms']:.4f}" for c in small))
    faster = [c for c in GMM_SWEEP_C if c >= km.WGMMA_MIN_C
              and all(sweep[(wd, c2)]["wgmma_ms"] <= sweep[(wd, c2)]["mma_ms"]
                      for wd in GMM_WIDTHS for c2 in GMM_SWEEP_C if c2 >= c)]
    log(f"  K6 sweep: the wgmma kernel is as fast or faster than mma at both widths from C = "
        f"{min(faster) if faster else 'none'} of {GMM_SWEEP_C}; choose_kernel takes it from "
        f"C = {km.WGMMA_MIN_C}, the decode kernel below; largest bf16 row relative L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst_row.items()) + f" (limit {BF16_GMM_REL_L2:g})")

    # the main path's shapes through the public wrapper: held, the kernel it
    # took read from PATHS, that call timed beside the plain version
    timings = {}
    for label, (e, c, d, f) in GMM_SHAPES.items():
        row = sweep[(label.split()[-1], c)]
        x, w = inputs(e, c, d, f)
        xb, wb = x.bfloat16(), w.bfloat16()
        del x, w
        want = ref.grouped_matmul(xb.float(), wb.float())
        before = dict(km.PATHS)
        got = km.grouped_matmul(xb, wb)
        torch.cuda.synchronize()
        taken = [k for k in km.PATHS if km.PATHS[k] != before[k]]
        if len(taken) != 1 or km.PATHS[taken[0]] != before[taken[0]] + 1:
            raise AssertionError(f"K6 {label}: grouped_matmul launched {taken}, want one kernel")
        kernel = taken[0]
        diff = float((got.float() - want).abs().max())
        worst = max(worst, diff)
        if kernel == "decode":
            decode_worst = max(decode_worst, diff)
        err = float(rel_l2(torch, got, want).max())
        del got, want
        if not err <= BF16_GMM_REL_L2:
            raise AssertionError(f"K6 {label} ({kernel}): bf16 row relative L2 {err:.3e} > "
                                 f"{BF16_GMM_REL_L2}")
        ms = cuda_ms(lambda: km.grouped_matmul(xb, wb))
        plain_ms = cuda_ms(lambda: ref.grouped_matmul(xb, wb), repeats=3)
        del xb, wb
        timings[label] = dict(kernel=kernel, ms=ms, plain_ms=plain_ms, row_rel_l2=err,
                              **{k: v for k, v in row.items()
                                 if k not in ("chosen", "flops", "row_rel_l2")})
        log(f"  K6 {label} ({e},{c},{d}) @ ({e},{d},{f}) bf16: grouped_matmul took {kernel}, "
            f"{ms:.4f} ms, row relative L2 {err:.3e}; plain {plain_ms:.4f} ms, torch.bmm "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms")
    main = timings.pop("prefill 2048 gate/up")
    results["grouped_matmul"] = dict(
        name="grouped_matmul", route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:61", max_abs_err=worst, ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], kernel=main["kernel"], wgmma_ms=main["wgmma_ms"],
        mma_ms=main["mma_ms"],
        shape="Mixtral prefill 2048 gate/up: (8, 640, 4096) @ (8, 4096, 14336), bf16",
        other_shapes={k: v for k, v in timings.items() if v["kernel"] != "decode"},
        sweep={f"{wd} C={c}": {k: v for k, v in row.items() if k != "flops"}
               for (wd, c), row in sweep.items()},
        threshold_c=km.WGMMA_MIN_C, sweep_row_rel_l2=worst_row)
    main = timings.pop("decode 16 slots gate/up")
    results["grouped_matmul_decode"] = dict(
        name="grouped_matmul_decode", route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:61", max_abs_err=decode_worst,
        **{k: v for k, v in main.items() if k != "row_rel_l2"},
        shape="Mixtral decode 16 slots gate/up: (8, 16, 4096) @ (8, 4096, 14336), bf16",
        other_shapes={k: v for k, v in timings.items() if v["kernel"] == "decode"})


# Phase 13's expert products: Jamba-1.5-Large's 16 experts at D 8192 and F
# 24576 (gate/up) and back (down), at C = 8 (the 8-slot decode step) and the
# exact-length prefill's capacities 24, 168 and 320 (prompts of 128, 1072 and
# 2048 tokens: models/layers.py moe_capacity).
JAMBA_GMM_C = (8, 24, 168, 320)
JAMBA_GMM_WIDTHS = {"gate/up": (8192, 24576), "down": (24576, 8192)}


def check_jamba_gmm(torch, smi: str, results: dict) -> None:
    """K6 through the public ``grouped_matmul`` at JAMBA_GMM_C x
    JAMBA_GMM_WIDTHS in bf16, the kernel it took read from ``PATHS`` (it must
    be ``choose_kernel``'s pick), held against the plain version's fp32
    product by the row relative L2, then timed: a call (CUDA events), for the
    decode kernel also on the device alone (a CUDA graph of 20 calls), beside
    ``torch.bmm`` timed the same way, the plain version and the bound.  One
    weight tensor per width (6.4 GB of bf16) serves every C."""
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(7)
    rows, worst = {}, 0.0
    for width, (d, f) in JAMBA_GMM_WIDTHS.items():
        wb = torch.randn(16, d, f, generator=g, device="cuda", dtype=torch.bfloat16)
        wb.mul_(d ** -0.5)
        wf = wb.float()
        for c in JAMBA_GMM_C:
            xb = torch.randn(16, c, d, generator=g, device="cuda", dtype=torch.bfloat16)
            want = ref.grouped_matmul(xb.float(), wf)
            before = dict(km.PATHS)
            got = km.grouped_matmul(xb, wb)
            torch.cuda.synchronize()
            taken = [k for k in km.PATHS if km.PATHS[k] != before[k]]
            pick = km.choose_kernel(xb.dtype, c, d, f, True)
            if taken != [pick]:
                raise AssertionError(f"K6 Jamba {width} C={c}: launched {taken}, "
                                     f"choose_kernel picks {pick}")
            err = float(rel_l2(torch, got, want).max())
            diff = float((got.float() - want).abs().max())
            worst = max(worst, diff)
            if not err <= BF16_GMM_REL_L2:
                raise AssertionError(f"K6 Jamba {width} C={c} ({pick}): bf16 row relative L2 "
                                     f"{err:.3e} > {BF16_GMM_REL_L2}")
            del got, want
            call = lambda: km.grouped_matmul(xb, wb)  # noqa: E731
            lib = lambda: torch.bmm(xb, wb)  # noqa: E731
            flops = 2.0 * 16 * c * d * f
            t_ops = flops / PEAK_BF16 * 1e3
            t_bytes = 2.0 * (16 * c * d + 16 * d * f + 16 * c * f) / PEAK_BYTES * 1e3
            row = dict(shape=f"(16, {c}, {d}) @ (16, {d}, {f}) bf16", kernel=pick,
                       max_abs_err=diff, row_rel_l2=err, ms=cuda_ms(call),
                       plain_ms=cuda_ms(lambda: ref.grouped_matmul(xb, wb), repeats=3),
                       library_ms=cuda_ms(lib), bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes", card=smi)
            alone = ""
            if pick == "decode":
                row.update(graph_ms=graph_ms(torch, call), library_graph_ms=graph_ms(torch, lib))
                alone = (f" (graph {row['graph_ms']:.4f}, torch.bmm graph "
                         f"{row['library_graph_ms']:.4f})")
            rows[f"{width} C={c}"] = row
            log(f"  K6 Jamba {width} {row['shape']}: {pick} {row['ms']:.4f} ms a call{alone} "
                f"({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain {row['plain_ms']:.4f}, "
                f"torch.bmm {row['library_ms']:.4f}, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}); row relative L2 {err:.3e}; {smi}")
            del xb
        del wb, wf
        torch.cuda.empty_cache()
    for key in ("grouped_matmul", "grouped_matmul_decode"):
        results[key]["recurrent_shapes"] = {
            k: v for k, v in rows.items() if (v["kernel"] == "decode") == key.endswith("decode")}
    results["grouped_matmul"]["recurrent_max_abs_err"] = worst


# ---------------------------------------------------------------------------
# phases 7-9: the model stack's main path at full width: H2O-Danube3-4B
# (dense) and one pipeline stage of Mixtral 8x7B (MoE)
# ---------------------------------------------------------------------------
SEED = 0
N_REQUESTS = 16
WATCHED = (0, 5, 10, 15)  # requests whose logits are held against the plain forward
# Random weights: gamma drawn in [0.5, 1.5) instead of the reference's ones,
# so a norm that dropped gamma changes the logits; embeddings at std 1e-3, so
# mean(x^2) at the first norm (1e-6) equals eps and a norm that dropped eps
# scales the first layer's normalized input by about sqrt(2).
EMBED_STD = 1e-3
# Engine (bf16, K4/K5) against the fp32 plain forward: the largest relative
# L2 error of one position's logits.  Measured on the card before it was
# set (PERF.md); the check below also proves that fp8 weights,
# eps = 0 and gamma = 1 each exceed it.
LOGITS_REL_TOL = 5e-2
# Phase 9: Mixtral 8x7B cut in depth to 16 of its 32 layers, every width and
# all 8 experts kept: one stage of a two-stage pipeline over two H100s
# (46.97 GB of bf16 weights; the whole model, 93.4 GB, does not fit one card).
MIXTRAL_LAYERS = 16
MIXTRAL_SLOTS = 16
MIXTRAL_REQUESTS = 32
MIXTRAL_WATCHED = (0, 10, 21, 31)


def seeded_params(torch, cfg):
    """``init_params`` from SEED on the card, with every gamma (the blocks'
    norms, an encoder-decoder's cross-attention norm and both final norms)
    and the embeddings redrawn as described at EMBED_STD."""
    from repro_torch.models import model as M

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = M.init_params(cfg, gen)
    dt = M.dtype_of(cfg)
    gamma = lambda: (0.5 + torch.rand(cfg.d_model, generator=gen, device="cuda")).to(dt)  # noqa: E731
    for stack in ("layers", "encoder", "decoder"):
        for blk in params.get(stack, ()):
            for k in blk:
                if k.startswith("norm"):
                    blk[k] = gamma()
    for k in ("final_norm", "enc_final_norm"):
        if k in params:
            params[k] = gamma()
    params["embed"] = (torch.randn(cfg.vocab, cfg.d_model, generator=gen, device="cuda")
                       * EMBED_STD).to(dt)
    return params


def rel_l2(torch, got, want):
    """Relative L2 error of each row (position) of ``got`` against ``want``."""
    got, want = got.float(), want.float()
    return (got - want).norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)


class MappedLayers:
    """The layers of a parameter tree, each mapped by ``fn`` only as it is
    iterated: a changed copy of a 47 GB model does not fit beside it."""

    def __init__(self, layers, fn):
        self.layers, self.fn = layers, fn

    def __iter__(self):
        return (self.fn(b) for b in self.layers)


def fp8_round(torch, w):
    """``w`` rounded to fp8 (e4m3) with a power-of-two scale, 4096 rows at a
    time (a Jamba expert tensor is 12.9 GB in fp32); an all-zero tensor (a
    bias) keeps scale 1."""
    amax = w.abs().max().float()
    scale = torch.exp2(torch.ceil(torch.log2(torch.where(amax > 0, amax / 448.0, 1.0))))
    out = torch.empty_like(w)
    for o, i in zip(out.view(-1, w.shape[-1]).split(4096), w.reshape(-1, w.shape[-1]).split(4096)):
        o.copy_((i.float() / scale).to(torch.float8_e4m3fn).float() * scale)
    return out


def mutants(torch, cfg, params):
    """The model computed wrongly in ways the tolerance must catch: weights
    rounded to fp8 (e4m3, power-of-two scale per matrix), every norm without
    eps, every norm without gamma, and for MoE the gates taken from a softmax
    over all experts' logits instead of the top-k.  Yields (label, config,
    parameters, gate function for the plain forward or None)."""
    from dataclasses import replace

    fp8 = lambda w: fp8_round(torch, w)  # noqa: E731
    def mapped(fn_w, fn_norm):
        block = lambda b: {k: (fn_norm(v) if k.startswith("norm")  # noqa: E731
                               else {n: fn_w(w) for n, w in v.items()}) for k, v in b.items()}
        return {k: (MappedLayers(v, block) if isinstance(v, list)
                    else fn_norm(v) if k.endswith("final_norm") else fn_w(v))
                for k, v in params.items()}

    same = lambda t: t  # noqa: E731
    yield "fp8 weights", cfg, mapped(fp8, same), None
    yield "eps = 0", replace(cfg, norm_eps=0.0), params, None
    yield "gamma = 1", cfg, mapped(same, torch.ones_like), None
    if cfg.is_moe:
        yield ("gates over all experts", cfg, params,
               lambda logits, experts: torch.softmax(logits, dim=-1).gather(1, experts))


def logit_digest(torch, prefill, decode) -> str:
    """sha256 of a request's recorded logits (prefill positions, then each
    decode step), bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for t in [prefill, *decode]:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def plain_gate(torch, cfg, params, recs: dict) -> dict:
    """The fp32 plain forward over each watched request's prompt and
    generated tokens (all but the last) against the engine's logits there.
    ``recs``: rid -> ``prompt``, ``tokens``, ``prefill`` (the prompt
    positions' logits), ``decode`` (each step's), and for MoE
    ``prefill_routes`` (per MoE layer: the prefill's experts over the
    padded bucket and the watched request's router logits) and ``steps``
    (per decode step, per MoE layer: the slot's experts and router logits):
    the plain forward follows the engine's dispatch groups and near-ties.
    Returns the per-position relative L2 errors, the plain logits, the
    sequences and forward arguments, and the routing agreement."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.models import plain

    moe = cfg.is_moe
    seqs, engine_logits, fwd_kw = {}, {}, {}
    for rid, r in recs.items():
        p_len, g_len = r["prompt"].size, len(r["tokens"])
        seqs[rid] = torch.as_tensor(np.concatenate([r["prompt"], r["tokens"][:-1]]), device="cuda")
        engine_logits[rid] = torch.cat([r["prefill"].float().cuda(),
                                        torch.stack(r["decode"][:g_len - 1]).float().cuda()])
        if not (engine_logits[rid].shape[0] == p_len + g_len - 1
                and (cfg.window is None or p_len + g_len - 1 < cfg.window)):
            raise AssertionError(f"request {rid}: {engine_logits[rid].shape[0]} logits recorded "
                                 f"for {p_len} + {g_len} tokens")
        fwd_kw[rid] = {}
        if cfg.family == "audio":  # the engine's stub frontend: zero frames
            fwd_kw[rid]["embeds"] = torch.zeros((cfg.frontend_len, cfg.d_model),
                                                dtype=M.dtype_of(cfg), device="cuda")
        if moe:  # the engine's dispatch groups: the padded bucket, then one per token
            padded = int(r["prefill_routes"][0][0].shape[0])
            fwd_kw[rid]["moe_groups"] = (
                [(0, p_len, padded)]
                + [(t, t + 1, None) for t in range(p_len, p_len + g_len - 1)])
    errs, refs, ties, agree_gap = [], {}, 0, 0.0
    for rid, r in recs.items():
        kw = dict(fwd_kw[rid])
        p_len = r["prompt"].size
        if moe:
            steps = r["steps"][:len(r["tokens"]) - 1]
            routes = r["prefill_routes"]
            moe_layers = range(len(routes))  # the MoE layers, in order
            kw["routing"] = [torch.cat([routes[l][0][:p_len].cuda()]
                                       + [s[l][0][None].cuda() for s in steps])
                             for l in moe_layers]
            engine_router = [torch.cat([routes[l][1][:p_len].cuda()]
                                       + [s[l][1][None].cuda() for s in steps])
                             for l in moe_layers]
            kw["stats"] = fstats = {}
        refs[rid] = plain.forward(cfg, params, seqs[rid], **kw)
        err = rel_l2(torch, engine_logits[rid], refs[rid])
        errs.append(err)
        extra = ""
        if moe:
            gap = router_agreement(torch, cfg, engine_router, fstats)
            ties += fstats.get("near_ties", 0)
            agree_gap = max(agree_gap, gap)
            extra = (f"; routing: {fstats.get('near_ties', 0)} near-tie token-layers took the "
                     f"engine's choice (largest gap {fstats.get('max_tie_gap', 0.0):.4f}), "
                     f"largest |engine - plain| router logit where they agree {gap:.4f}")
        log(f"  request {rid} ({p_len} + {len(r['tokens'])} tokens): engine vs fp32 "
            f"plain, relative L2 per position: prefill max {float(err[:p_len].max()):.3e}, "
            f"decode max {float(err[p_len:].max()):.3e}, median {float(err.median()):.3e}"
            + extra)
    return dict(errs=errs, refs=refs, seqs=seqs, fwd_kw=fwd_kw, ties=ties, agree_gap=agree_gap,
                engine_logits=engine_logits)


def serve_path(torch, smi: str, cfg, params, *, slots: int, n_requests: int,
               watched: tuple[int, ...], seed: int, max_len: int = 4096,
               prompt_lens: tuple[int, int] = (128, 2048), bucket: int = 2048,
               gate: bool = True, breakdown: bool = True) -> dict:
    """Serve ``n_requests`` requests (prompts of ``prompt_lens`` tokens, all
    submitted at once) through ``ServingEngine`` with ``slots`` slots of
    ``max_len`` positions twice: a timed run, which adds only the first-token
    callback and a synchronized prefill timer, then a recorded run of the
    same traffic whose watched requests' prefill and decode logits are held
    against the fp32 plain forward (for audio over the engine's memory of
    zero frames).  For MoE the recorded run also keeps the engine's routing:
    the assignments each prefill drops and keeps, and the plain forward
    follows the engine's dispatch groups and near-ties.  ``bucket``: the
    prefill bucket ``prefill_breakdown`` profiles.  ``gate=False`` measures
    and prints the logits' distance from the plain forward without holding
    it to LOGITS_REL_TOL (and runs no mutant): for a model whose bf16
    rounding the layers amplify past any fixed limit (phase 14).
    ``breakdown=False`` skips ``explain_kernels`` and the decode-step and
    prefill-bucket breakdowns (phase 14's fp32 run, a check of the function
    and not a deployment)."""
    import numpy as np

    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import plain
    from repro_torch.serve import ServeConfig, ServingEngine

    moe = cfg.is_moe
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
        f"{cfg.window}" + (f", {cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
                           f"{cfg.capacity_factor}" if moe else "")
        + f"; {n_params / 1e9:.3f} B parameters in {cfg.dtype}")
    scfg = ServeConfig(batch_slots=slots, max_len=max_len, max_new_tokens=32)

    warm = ServingEngine(cfg, params, ServeConfig(batch_slots=2, max_len=256, max_new_tokens=4))
    warm.submit(np.arange(1, 100, dtype=np.int32))
    warm.drain()
    del warm

    rng = np.random.default_rng(seed)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, n_requests)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]

    def completed(handles):
        bad = [(h.rid, h.state.value, repr(h.error)) for h in handles
               if h.state.value != "completed" or len(h.tokens) != scfg.max_new_tokens]
        if bad:
            raise AssertionError(f"requests that did not complete: {bad}")

    # the timed run
    eng = ServingEngine(cfg, params, scfg)
    real_prefill, prefill_s, first_token = eng._prefill, [0.0], {}

    def timed_prefill(h):
        t0 = time.perf_counter()
        out = real_prefill(h)
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return out

    eng._prefill = timed_prefill
    t0 = time.perf_counter()
    handles = [eng.submit(p, on_token=lambda h, t: first_token.setdefault(
        h.rid, time.perf_counter())) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    completed(handles)
    timed_tokens = [list(h.tokens) for h in handles]
    del eng, real_prefill
    gc.collect()
    ttft = np.array([first_token[h.rid] - t0 for h in handles])
    prompt_tokens = int(lens.sum())
    decode_tokens = sum(len(h.tokens) - 1 for h in handles)
    all_tokens = sum(len(h.tokens) for h in handles)
    stats = dict(
        model=cfg.name, layers=cfg.n_layers, slots=slots,
        requests=n_requests, prompt_tokens=prompt_tokens, wall_s=wall, prefill_s=prefill_s[0],
        prefill_tok_s=prompt_tokens / prefill_s[0],
        ttft_p50_s=float(np.percentile(ttft, 50)), ttft_p99_s=float(np.percentile(ttft, 99)),
        decode_tok_s=decode_tokens / (wall - prefill_s[0]),
        total_tok_s=all_tokens / wall)
    log(f"  served {n_requests} requests (prompts {int(lens.min())}-{int(lens.max())} tokens, "
        f"{prompt_tokens} in all; {scfg.max_new_tokens} new tokens each; {slots} slots) in "
        f"{wall:.2f} s; {smi}")
    log(f"  prefill {stats['prefill_tok_s']:.0f} tok/s ({prefill_s[0]:.2f} s); TTFT p50 "
        f"{stats['ttft_p50_s']:.3f} s, p99 {stats['ttft_p99_s']:.3f} s (all submitted at once); "
        f"decode {stats['decode_tok_s']:.1f} tok/s; total {stats['total_tok_s']:.1f} tok/s; {smi}")

    # the recorded run: the watched requests' logits, taken where the engine
    # makes them, and for MoE every call's experts (and the watched calls'
    # fp32 router logits, for the margin's reading)
    eng = ServingEngine(cfg, params, scfg)
    real_step, real_slots, real_prefill = M.decode_step, M.decode_slots, eng._prefill
    real_route = L.moe_route
    last, rec_prefill, rec_decode = {}, {}, {rid: [] for rid in watched}
    route_log, prefill_routes, rec_route = [], {}, {rid: [] for rid in watched}
    prefill_lens = {}  # tokens of each request's prefill call

    def moe_route(x, router, k):
        gates, experts = real_route(x, router, k)
        route_log.append((experts, x.float() @ router))
        return gates, experts

    def decode_step(*args):
        logits, state = real_step(*args)
        last["logits"], last["tokens"] = logits, args[3].shape[1]
        return logits, state

    def decode_slots(*args):
        route_log.clear()
        logits, states = real_slots(*args)
        for i, h in enumerate(eng._slots):
            if h is not None and h.rid in rec_decode:
                rec_decode[h.rid].append(logits[i].clone())
                rec_route[h.rid].append([(e[i], lg[i]) for e, lg in route_log])
        return logits, states

    def prefill(h):
        route_log.clear()
        out = real_prefill(h)
        prefill_lens[h.rid] = last["tokens"]
        if h.rid in rec_decode:
            rec_prefill[h.rid] = last["logits"][0, :h.prompt.size].clone()
        if moe:  # every request's experts; the router logits of the watched ones
            prefill_routes[h.rid] = [(e, lg if h.rid in rec_decode else None)
                                     for e, lg in route_log]
        return out

    M.decode_step, M.decode_slots, eng._prefill = decode_step, decode_slots, prefill
    if moe:
        L.moe_route = moe_route
    try:
        t0 = time.perf_counter()
        handles = [eng.submit(p) for p in prompts]
        eng.drain()
        torch.cuda.synchronize()
        rec_wall = time.perf_counter() - t0
    finally:
        M.decode_step, M.decode_slots, L.moe_route = real_step, real_slots, real_route
    completed(handles)
    if cfg.family in M.RECURRENT_FAMILIES:  # no padded token may enter a recurrent state
        padded = {h.rid: (prefill_lens[h.rid], h.prompt.size) for h in handles
                  if prefill_lens[h.rid] != h.prompt.size}
        if padded:
            raise AssertionError(f"prefill not at the exact length (tokens, prompt): {padded}")
        log(f"  every prefill ran at the prompt's exact length ({len(handles)} requests)")
    same = sum(list(h.tokens) == t for h, t in zip(handles, timed_tokens))
    log(f"  recorded run: {rec_wall:.2f} s (timed run {wall:.2f} s); {same} of {n_requests} "
        "requests generated the timed run's tokens")
    stats["recorded_wall_s"] = rec_wall
    if moe:
        stats.update(prefill_drops(torch, cfg, handles, prefill_routes))
        stats.update(kept_per_expert(torch, cfg, handles, prefill_routes, watched))

    # correctness: prefill and decode logits against the fp32 plain forward
    recs = {rid: dict(prompt=handles[rid].prompt, tokens=list(handles[rid].tokens),
                      prefill=rec_prefill[rid], decode=rec_decode[rid],
                      prefill_routes=prefill_routes.get(rid), steps=rec_route[rid])
            for rid in watched}
    gate_out = plain_gate(torch, cfg, params, recs)
    errs, refs, seqs, fwd_kw = (gate_out[k] for k in ("errs", "refs", "seqs", "fwd_kw"))
    ties, agree_gap = gate_out["ties"], gate_out["agree_gap"]
    stats["logit_digests"] = {
        rid: logit_digest(torch, r["prefill"], r["decode"][:len(r["tokens"]) - 1])
        for rid, r in recs.items()}
    engine_err = float(torch.cat(errs).max())
    if moe:
        log(f"  routing over the watched requests: {ties} near-tie token-layers took the "
            f"engine's choice (ROUTER_MARGIN {plain.ROUTER_MARGIN}); largest |engine - plain| "
            f"router logit where the choices agree {agree_gap:.4f}")
        stats.update(near_ties=ties, router_logit_gap=agree_gap)
    stats["max_rel_l2"] = engine_err
    if not gate:
        log(f"  engine logits vs fp32 plain: relative L2 max {engine_err:.3e} (measured, not "
            f"held to {LOGITS_REL_TOL})")
    elif not engine_err <= LOGITS_REL_TOL:
        raise AssertionError(f"engine logits: relative L2 {engine_err:.3e} > {LOGITS_REL_TOL}")
    labels = []
    for label, mcfg, mparams, gate_fn in (mutants(torch, cfg, params) if gate else ()):
        real_gates = plain.gates
        plain.gates = gate_fn or real_gates
        try:
            merr = torch.cat([rel_l2(torch, plain.forward(mcfg, mparams, seqs[rid],
                                                          **fwd_kw[rid]), refs[rid])
                              for rid in watched])
        finally:
            plain.gates = real_gates
        del mparams
        log(f"  mutant '{label}' vs fp32 plain: relative L2 max {float(merr.max()):.3e}, "
            f"median {float(merr.median()):.3e}")
        if bool((merr <= LOGITS_REL_TOL).all()):  # NaN logits are caught
            raise AssertionError(f"tolerance {LOGITS_REL_TOL} does not catch '{label}'")
        labels.append(label)
    if gate:
        log(f"  engine logits within relative L2 {LOGITS_REL_TOL} (max {engine_err:.3e}); "
            f"{', '.join(labels)} each exceed it")
    if breakdown:
        log("  explain_kernels():\n" + "\n".join(
            "    " + line for line in eng.explain_kernels().splitlines()))
        stats.update(decode_breakdown(torch, cfg, params, eng._states, eng._tokens))
    del eng
    gc.collect()
    if breakdown:
        stats.update(prefill_breakdown(torch, cfg, params, bucket))
    log(f"  serving metrics: {json.dumps(stats)}")
    return dict(stats=stats, cfg=cfg, params=params, scfg=scfg, prompts=prompts,
                tokens=[list(h.tokens) for h in handles])


def prefill_drops(torch, cfg, handles, routes) -> dict:
    """Token-expert assignments of real prompt tokens that the prefill's
    capacity dropped: the padded bucket's tokens sort after the real ones of
    each expert, so an expert drops max(0, real assignments - capacity)."""
    from repro_torch.models import layers as L

    drops = []
    for h in handles:
        p_len, n = h.prompt.size, 0
        for experts, _ in routes[h.rid]:
            cap = L.moe_capacity(cfg, experts.shape[0])
            counts = torch.bincount(experts[:p_len].reshape(-1), minlength=cfg.n_experts)
            n += int((counts - cap).clamp(min=0).sum())
        drops.append(n)
    n_moe = sum(cfg.layer_is_moe(l) for l in range(cfg.n_layers))
    assignments = sum(h.prompt.size for h in handles) * cfg.top_k * n_moe
    log(f"  dropped token-expert assignments per prefill (real tokens, over {n_moe} MoE "
        f"layers): mean {sum(drops) / len(drops):.1f}, max {max(drops)}, "
        f"{sum(drops)} of {assignments} in all ({sum(drops) / assignments:.3%})")
    return dict(dropped_per_prefill=drops, dropped_share=sum(drops) / assignments)


def kept_per_expert(torch, cfg, handles, routes, watched) -> dict:
    """The real prompt tokens each expert keeps in each layer's prefill
    dispatch, for the watched requests: an expert's count clipped at the
    capacity (padding sorts after the real tokens)."""
    from repro_torch.models import layers as L

    idle = {}
    for rid in watched:
        p_len, rows = handles[rid].prompt.size, []
        for experts, _ in routes[rid]:
            counts = torch.bincount(experts[:p_len].reshape(-1), minlength=cfg.n_experts)
            rows.append(counts.clamp(max=L.moe_capacity(cfg, experts.shape[0])).tolist())
        idle[rid] = sum(n == 0 for row in rows for n in row)
        log(f"  request {rid} ({p_len} prompt tokens): kept per expert, layer by layer: "
            + " ".join("[" + ",".join(map(str, row)) + "]" for row in rows)
            + f"; {idle[rid]} of {len(rows) * cfg.n_experts} (layer, expert) pairs kept none")
    return dict(idle_expert_layers=idle)


def router_agreement(torch, cfg, engine_router, fstats) -> float:
    """The largest |engine - plain| fp32 router logit over the token-layers
    where the plain forward's own top-k equals the engine's choice."""
    gap = 0.0
    for eng_lg, own_lg, used in zip(engine_router, fstats["router_logits"], fstats["experts"]):
        own = torch.topk(own_lg, cfg.top_k, dim=-1).indices.sort(-1).values
        agree = (own == used.sort(-1).values).all(-1)
        if bool(agree.any()):
            gap = max(gap, float((eng_lg.float() - own_lg)[agree].abs().max()))
    return gap


# The engine's MoE layer alone (router, dispatch, three K6 products, combine)
# against the plain fp32 layer, held per token by the relative L2 error of its
# output.  bf16 rounds x, the two projections, their SwiGLU product, the expert
# outputs and the gated sum, each by up to 2^-9.  Readings on an H100:
# 5.15-5.72e-3 over the 16 layers at both shapes (PERF.md); the limit is about
# twice the largest.  A token sent to a wrong expert, dropped wrongly or
# combined with a wrong gate is off by O(1).
MOE_LAYER_REL_L2 = 1.2e-2


def check_moe_layer(torch, cfg, params) -> dict:
    """``layers.moe_ffn`` on every layer's weights at full width, on random
    inputs that load every expert, against ``plain.moe_ffn``: a 2048-token
    prefill bucket (capacity 640) and a 16-slot decode step (capacity 16, no
    drop).  The served prompts route their tokens alike (PERF.md), so this is
    where each expert's rows of the dispatch, K6 and the combine are held at
    the main path's shapes.  Fails if an expert keeps no token of the bucket."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import plain

    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    real_route, worst = L.moe_route, {}
    for label, t, capacity in (("2048-token bucket", 2048, None), ("16-slot decode", 16, 16)):
        x = torch.randn(t, cfg.d_model, generator=g, device="cuda").to(M.dtype_of(cfg))
        errs, kept = [], []
        for blk in params["layers"]:
            rec = []

            def route(x, router, k):
                gates, experts = real_route(x, router, k)
                rec.append(experts)
                return gates, experts

            L.moe_route = route
            try:
                got = L.moe_ffn(x, blk["ffn"], cfg, capacity=capacity)
            finally:
                L.moe_route = real_route
            want = plain.moe_ffn(cfg, x, blk["ffn"], None if capacity else t, routing=rec[0])
            errs.append(float(rel_l2(torch, got, want).max()))
            cap = plain.capacity(cfg, t) if capacity is None else t
            kept.append(torch.bincount(rec[0].reshape(-1), minlength=cfg.n_experts)
                        .clamp(max=cap).tolist())
        worst[label] = max(errs)
        log(f"  MoE layer, {label} ({t} x {cfg.d_model} bf16, random): largest per-token "
            f"relative L2 vs fp32 plain by layer " + " ".join(f"{e:.2e}" for e in errs)
            + f" (limit {MOE_LAYER_REL_L2:g}); kept per expert, fewest/most over layers "
            f"{min(min(k) for k in kept)}/{max(max(k) for k in kept)}")
        if not worst[label] <= MOE_LAYER_REL_L2:
            raise AssertionError(f"MoE layer {label}: relative L2 {worst[label]:.3e} > "
                                 f"{MOE_LAYER_REL_L2}")
        if capacity is None and min(min(k) for k in kept) == 0:
            raise AssertionError(f"MoE layer {label}: an expert kept no token: {kept}")
    return dict(moe_layer_rel_l2=worst)


# device-time groups of a profiled window: kernel-name fragments of each group
# (bf16 K1 runs K6's kernels at E = 1, so a profile files it under K6)
KERNEL_GROUPS = {"K1 gemm": ("gemm_tf32x3_kernel",),
                 "K6-bwd grouped_matmul_bwd": ("moe_gmm_dx", "moe_gmm_dw"),
                 "K6 grouped_matmul wgmma": ("moe_gmm_wgmma",),
                 "K6 grouped_matmul decode": ("moe_gmm_decode",),
                 "K6 grouped_matmul mma": ("moe_gmm_bf16",),
                 "K5 flash_attention": ("flash_kernel", "flash_mma_kernel", "flash_decode_kernel"),
                 "K5-bwd flash_attention_bwd": ("flash_bwd",),
                 "K4-bwd rmsnorm_bwd": ("rmsnorm_bwd", "rmsnorm_dgamma"),
                 "K4 rmsnorm": ("rmsnorm",),
                 "K2/K3 nest kernel": ("nest_kernel", "nest_split"),
                 "matmul (cuBLAS)": ("gemm", "gemv", "nvjet", "cutlass", "sm90_xmma", "matmul")}


def device_groups(torch, prof, n: int):
    """(device ms per call by group, launches per call by group, device ops
    per call) over ``n`` calls profiled in ``prof``."""
    groups = {k: 0.0 for k in [*KERNEL_GROUPS, "other"]}
    counts = {k: 0 for k in groups}
    n_kernels = 0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if not us or getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.key.lower()
        n_kernels += ev.count
        group = next((g for g, keys in KERNEL_GROUPS.items() if any(t in name for t in keys)),
                     "other")
        groups[group] += us
        counts[group] += ev.count
    return ({k: v / n / 1e3 for k, v in groups.items()}, {k: v / n for k, v in counts.items()},
            n_kernels / n)


def decode_breakdown(torch, cfg, params, states, tokens) -> dict:
    """Where one batched decode step's time goes: host-clock ms per step
    (synchronized), and the device time and launches of its kernels by group
    from ``torch.profiler``, over the engine's final slot states."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    def steps(n):
        nonlocal states, tokens
        for _ in range(n):
            tokens, states = M.decode_slots_greedy(cfg, params, states, tokens)
        torch.cuda.synchronize()

    steps(3)
    t0 = time.perf_counter()
    steps(10)
    step_ms = (time.perf_counter() - t0) / 10 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps(5)
    per_step, counts, n_ops = device_groups(torch, prof, 5)
    device_ms = sum(per_step.values())
    idle = 1 - device_ms / step_ms if device_ms else None
    log(f"  decode step ({tokens.shape[0]} slots): {step_ms:.3f} ms on the host clock; device "
        "time per step " + ", ".join(f"{k} {v:.3f} ms ({counts[k]:.0f} launches)"
                                     for k, v in per_step.items())
        + f"; {n_ops:.0f} device ops per step; device idle "
        + (f"{idle:.1%}" if idle is not None else "not measured (no device events)"))
    ab = decode_step_ab(torch, cfg, steps)
    return dict(decode_step_ms=step_ms, decode_device_ms=per_step,
                decode_launches_per_step=counts, decode_ops_per_step=n_ops,
                decode_idle_share=idle, decode_step_ab=ab)


def decode_step_ab(torch, cfg, steps) -> dict:
    """The decode step's device time by kernel group with each decode kernel
    swapped for the kernel it replaced, in turns (the port's choice, the
    others, the port's choice again): K5 on the SIMT kernel, and for an MoE
    model K6 below C = WGMMA_MIN_C on the wgmma and on the mma kernel.  Each
    is ``torch.profiler`` over 3 steps, with ``choose_kernel`` patched.  The
    launch counts (and a ``GmmPaths`` record and ``CrossPaths`` counts) are
    put back afterwards: these steps compare kernels and are not the main
    path's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import rmsnorm as kr
    from repro_torch.models import layers as L

    cross = getattr(getattr(L.attention, "__self__", None), "counts", {})
    counters = (kf.PATHS, kf.LAUNCHES, km.PATHS, km.LAUNCHES, kr.LAUNCHES, kg.LAUNCHES,
                *cross.values())
    saved = [dict(c) for c in counters]
    record = getattr(getattr(km._launch, "__self__", None), "launches", None)
    recorded = len(record) if record is not None else 0

    k5, k6 = kf.choose_kernel, km.choose_kernel
    variants = {"port": (k5, k6),
                "K5 simt": (lambda dtype, sq, *a, **kw: "simt" if sq == 1 else k5(dtype, sq, *a, **kw),
                            k6)}
    if cfg.is_moe:
        for kernel in ("wgmma", "mma"):
            variants[f"K6 {kernel}"] = (k5, lambda dtype, c, *a, kernel=kernel: (
                kernel if c < km.WGMMA_MIN_C and k6(dtype, c, *a) == "decode" else k6(dtype, c, *a)))
    order = [*variants, "port"]
    out = {}
    try:
        for name in order:
            kf.choose_kernel, km.choose_kernel = variants[name]
            steps(1)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                steps(3)
            per_step, _, _ = device_groups(torch, prof, 3)
            total = sum(per_step.values())
            out.setdefault(name, []).append(dict(total=total, **per_step))
            log(f"    step A/B, {name}: device {total:.3f} ms a step ("
                + ", ".join(f"{k} {v:.3f}" for k, v in per_step.items() if k.startswith("K"))
                + ")")
    finally:
        kf.choose_kernel, km.choose_kernel = k5, k6
        for c, before in zip(counters, saved):
            c.update(before)
        if record is not None:
            del record[recorded:]
    return out


def prefill_breakdown(torch, cfg, params, bucket: int = 2048) -> dict:
    """Where one prefill bucket's time goes: ``M.decode_step`` on ``bucket``
    tokens into an empty 4096-position cache (and empty recurrent states), as
    the engine prefills a request; host-clock ms (synchronized), and the
    device time and launches
    of its kernels by group from ``torch.profiler``; for audio also the
    encoder's host-clock ms over the engine's zero frames."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    toks = torch.as_tensor(np.random.default_rng(SEED + 2).integers(0, cfg.vocab, (1, bucket)),
                           device="cuda")
    state = M.init_decode_state(cfg, 1, 4096, ring=False, device="cuda")
    recurrent = cfg.family in M.RECURRENT_FAMILIES

    def calls(n):
        nonlocal state
        for _ in range(n):
            if recurrent:  # a fresh request: recurrent states start empty
                state = M.init_decode_state(cfg, 1, 4096, ring=False, device="cuda")
            state["len"] = 0
            M.decode_step(cfg, params, state, toks)
        torch.cuda.synchronize()

    calls(1)
    t0 = time.perf_counter()
    calls(3)
    call_ms = (time.perf_counter() - t0) / 3 * 1e3
    enc = {}
    if cfg.family == "audio":  # the engine encodes zero frames per request before the bucket
        frames = torch.zeros((1, cfg.frontend_len, cfg.d_model), dtype=M.dtype_of(cfg),
                             device="cuda")
        M.encode(cfg, params, frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            M.encode(cfg, params, frames)
        torch.cuda.synchronize()
        enc["encode_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        log(f"  the encoder over {cfg.frontend_len} zero frames (once per request at prefill): "
            f"{enc['encode_ms']:.3f} ms on the host clock, synchronized")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls(2)
    per_call, counts, n_ops = device_groups(torch, prof, 2)
    device_ms = sum(per_call.values())
    idle = 1 - device_ms / call_ms if device_ms else None
    log(f"  prefill of one {bucket}-token bucket: {call_ms:.3f} ms on the host clock "
        f"({bucket / call_ms * 1e3:.0f} tok/s); device time "
        + ", ".join(f"{k} {v:.3f} ms ({counts[k]:.0f} launches)" for k, v in per_call.items())
        + f"; {n_ops:.0f} device ops; device idle "
        + (f"{idle:.1%}" if idle is not None else "not measured (no device events)"))
    del state
    return dict(prefill_bucket=bucket, prefill_call_ms=call_ms, prefill_device_ms=per_call,
                prefill_launches=counts, prefill_ops=n_ops, prefill_idle_share=idle, **enc)


def _leaves(p):
    if isinstance(p, dict):
        for v in p.values():
            yield from _leaves(v)
    elif isinstance(p, list):
        for v in p:
            yield from _leaves(v)
    else:
        yield p


def forward_path(torch, cfg, params) -> None:
    """``forward`` on one 8192-token sequence (K5 with the 4096 window), held
    against the fp32 plain forward at 256 positions beyond the window."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.models import plain

    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab, 8192),
                           device="cuda")
    t0 = time.perf_counter()
    logits = M.forward(cfg, params, {"tokens": toks[None]})[0]
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    if tuple(logits.shape) != (8192, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} or non-finite")
    at = torch.arange(cfg.window, 8192, 16, device="cuda")
    want = plain.forward(cfg, params, toks)[at]
    err = float(rel_l2(torch, logits[at], want).max())
    log(f"  forward on 8192 tokens in {t_fwd:.2f} s; logits at {at.numel()} positions in "
        f"[{cfg.window}, 8192) vs fp32 plain: relative L2 max {err:.3e}")
    if not err <= LOGITS_REL_TOL:
        raise AssertionError(f"forward logits: relative L2 {err:.3e} > {LOGITS_REL_TOL}")


# ---------------------------------------------------------------------------
# Phase 15: online tuning inside serving, on phase 7's H2O-Danube3-4B weights.
# The engine runs the logit program (``autotune.logit_pipeline_program``: six
# pointwise stages over the step's vocab-major (32000, 8) logits against six
# per-vocab vectors) in every decode step.  (a) with the logit nest seeded to
# ``pallas_nest`` it is one K2 launch a step, in the flattened form; (b) and
# (c) start from a stale ``vectorize`` entry (the reference's stale
# ``sequential`` is a Python loop over the vocabulary, seconds a call at this
# width) and close the online loop: telemetry, search, validation, hot swap,
# the rollback watch, fold-back; (d) injects faults.
# ---------------------------------------------------------------------------
ONLINE_SLOTS = 8
ONLINE_NEW = 32
ONLINE_STALE = {"kind": "vectorize"}
# (d)'s sync path samples on the host at this temperature: every token but
# the largest gets probability exp(-gap / T), which is 0 in float32 for any
# gap above 1e-5, so sampling is greedy and no draw depends on which
# requests failed before it.
ONLINE_SYNC_T = 1e-7


def logit_operands(cfg) -> dict:
    """The logit program's operands as tests/test_autotune.py gives them:
    B ~ N(0, 0.5) seeded, S = 1.1, G = 0.9, a floor of -1e9 and a cap of 1e9
    (C zero-filled by the engine)."""
    import numpy as np

    v = cfg.vocab
    return {"B": np.random.default_rng(SEED + 15).normal(0, 0.5, v).astype(np.float32),
            "S": np.full(v, 1.1, np.float32), "G": np.full(v, 0.9, np.float32),
            "F": np.full(v, -1e9, np.float32), "K": np.full(v, 1e9, np.float32)}


def logit_db(prog, **recipe):
    """A database holding one exact recipe for the logit program's nest."""
    from repro_torch.core import Daisy, Recipe, TuningDatabase, fingerprint
    from repro_torch.core.embedding import embed_nest

    p = Daisy(device="cuda")._normalized(prog)
    db = TuningDatabase()
    for nest in p.body:
        db.add(fingerprint(nest), embed_nest(p, nest), Recipe(**recipe), provenance="chip_smoke")
    db.meta["backend"] = "cuda"
    return db


def serve_online(torch, cfg, params, prompts, prog, **kw):
    """Serve ``prompts`` (all at once) through ``ServingEngine`` with the
    logit program; returns (engine, handles, wall seconds)."""
    from repro_torch.serve import ServeConfig, ServingEngine

    scfg = ServeConfig(batch_slots=ONLINE_SLOTS, max_len=4096, max_new_tokens=ONLINE_NEW,
                       temperature=kw.pop("temperature", 0.0))
    eng = ServingEngine(cfg, params, scfg, logit_program=prog, logit_inputs=logit_operands(cfg),
                        **kw)
    t0 = time.perf_counter()
    handles = [eng.submit(p) for p in prompts]
    eng.drain()
    torch.cuda.synchronize()
    return eng, handles, time.perf_counter() - t0


def all_completed(label: str, handles) -> list:
    bad = [(h.rid, h.state.value, repr(h.error)) for h in handles
           if h.state.value != "completed" or len(h.tokens) != ONLINE_NEW]
    if bad:
        raise AssertionError(f"phase 15 {label}: requests that did not complete: {bad}")
    return [list(h.tokens) for h in handles]


class CandidateLog:
    """Records every recipe the search measures, with its time: the name is
    wrapped in both modules that hold it (the search's ``evolve_recipe`` and
    the scheduler's ``_measure_item``)."""

    def __init__(self):
        from repro_torch.core import scheduler, search

        self.mods, self.real, self.rows = (search, scheduler), search.measure_recipe, []

    def __enter__(self):
        def logged(nprog, inputs, recipe, *a, **kw):
            us = self.real(nprog, inputs, recipe, *a, **kw)
            self.rows.append((recipe.kind, recipe.vec_budget, recipe.tile, recipe.unroll, us))
            return us

        for m in self.mods:
            m.measure_recipe = logged
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.measure_recipe = self.real


def logit_step_ab(torch, cfg, params, states, tokens, with_program) -> dict:
    """The batched decode step without the logit program (phase 7's step) and
    with it (the engine's composite), in turns (without, with, without,
    with) on the same slot states: host-clock ms a step over 10 synchronized
    steps, and the device ms a step by kernel group over 5 under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import model as M

    fns = {"without": lambda p, s, t: M.decode_slots_greedy(cfg, p, s, t),
           "with": with_program}

    def steps(fn, n):
        nonlocal states, tokens
        for _ in range(n):
            tokens, states = fn(params, states, tokens)
        torch.cuda.synchronize()

    out: dict = {}
    for name in ("without", "with", "without", "with"):
        steps(fns[name], 2)
        t0 = time.perf_counter()
        steps(fns[name], 10)
        host = (time.perf_counter() - t0) / 10 * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps(fns[name], 5)
        per_step, counts, n_ops = device_groups(torch, prof, 5)
        device = sum(per_step.values())
        out.setdefault(name, []).append(dict(host_ms=host, device_ms=device, ops=n_ops,
                                             **{k: v for k, v in per_step.items() if v}))
        log(f"    decode step {name} the logit program: {host:.3f} ms on the host clock, device "
            f"{device:.3f} ms ({n_ops:.0f} device ops; "
            + ", ".join(f"{k} {v:.4f}" for k, v in per_step.items() if v) + ")")
    return out


def check_logit_nest(torch, cfg, params, states, tokens, prog, k2_db) -> dict:
    """At one decode step of the engine's slot states: the program's ``Y``
    through K2 against K2's plain version and the torch-lowered program on
    the same ``X``, bit for bit; then K2 timed alone (a CUDA graph and a
    call) beside the plain version, the whole program under each backend
    (the torch-lowered one is the library column) and the byte bound."""
    from repro_torch.core import Daisy, Recipe
    from repro_torch.core.search import schedule_from_recipe
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.models import model as M

    logits, _ = M.decode_slots(cfg, params, states, tokens)
    inputs = {k: torch.as_tensor(v, device="cuda") for k, v in logit_operands(cfg).items()}
    v, n = cfg.vocab, ONLINE_SLOTS
    inputs["C"] = torch.zeros(v, device="cuda")
    inputs["Y"] = torch.zeros((v, n), device="cuda")
    inputs["X"] = logits.T
    k2_fn, plan = Daisy(db=k2_db, backend="cuda", device="cuda").compile(prog)
    torch_fn, _ = Daisy(db=k2_db, backend="torch", device="cuda").compile(prog)
    if [np_.recipe.kind for np_ in plan.nests] != ["pallas_nest"]:
        raise AssertionError(f"phase 15: the logit nest planned {plan.nests}")
    y_k2 = k2_fn(inputs)["Y"]
    y_torch = torch_fn(inputs)["Y"]
    p = plan.program
    nk = nkm.plan_nest(p, p.body[0], schedule_from_recipe(Recipe(kind="pallas_nest")))
    env = {a.name: (inputs[a.name].float().contiguous().clone() if a.name in inputs
                    else torch.zeros(a.shape, device="cuda")) for a in p.arrays}
    plain_env = {k: t.clone() for k, t in env.items()}
    nkm.nest_plain(nk, plain_env)
    err = float((y_k2 - plain_env["Y"]).abs().max())
    if not (torch.equal(y_k2, plain_env["Y"]) and torch.equal(y_k2, y_torch)):
        raise AssertionError(f"phase 15: Y through K2 differs from the plain version "
                             f"(max |diff| {err}) or from the torch-lowered program")
    if not bool(torch.isfinite(y_k2).all()) or tuple(y_k2.shape) != (v, n):
        raise AssertionError(f"phase 15: Y {tuple(y_k2.shape)} or non-finite")
    args, _, flat = nkm.launch_args(nk, env)
    nbytes = 4 * (v * n + 6 * v) + 4 * 6 * v * n  # X and six vectors read; T1-T5, Y written
    row = dict(shape=[v, n], flat=flat, max_abs_err=err, bytes=nbytes,
               bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
               graph_ms=graph_ms(torch, lambda: nkm.run_nest(nk, env)),
               ms=cuda_ms(lambda: nkm.run_nest(nk, env)),
               plain_ms=cuda_ms(lambda: nkm.nest_plain(nk, env)),
               program_ms=cuda_ms(lambda: k2_fn(inputs)),
               program_stream_ms=stream_ms(torch, lambda: k2_fn(inputs)),
               library_ms=cuda_ms(lambda: torch_fn(inputs)),
               library_stream_ms=stream_ms(torch, lambda: torch_fn(inputs)),
               library="the torch-lowered program (Daisy backend 'torch', vectorize)")
    log(f"  K2 at the logit nest ({v} x {n}, {'flattened' if flat else 'tiled'}): Y bit-identical "
        f"to the plain version and the torch-lowered program; graph {row['graph_ms']:.4f} ms, a "
        f"call {row['ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({nbytes / 1e6:.2f} MB); plain "
        f"{row['plain_ms']:.4f} ms; the whole program a call {row['program_ms']:.4f} ms (back "
        f"to back {row['program_stream_ms']:.4f}) against the torch-lowered program's "
        f"{row['library_ms']:.4f} ms (back to back {row['library_stream_ms']:.4f})")
    return row


def online_phase(torch, smi: str, cfg, params) -> dict:
    """Phase 15 (a)-(d) on ``cfg``/``params`` (phase 7's Danube); returns the
    numbers and K2's launches in (a)."""
    import tempfile

    import numpy as np

    from repro_torch.autotune import SearchSupervisor, SwapPolicy, logit_pipeline_program
    from repro_torch.core import TuningDatabase
    from repro_torch.fault import Fault, FaultInjected, FaultPlan
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.models import model as M
    from repro_torch.serve import NonFiniteLogits

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    lens = rng.integers(128, 2049, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    prog = logit_pipeline_program(cfg.vocab, ONLINE_SLOTS)
    out: dict = {}

    # (a) served through K2: one flattened launch a decode step
    k2_db = logit_db(prog, kind="pallas_nest")
    steps = [0]
    real_slots = M.decode_slots

    def counted(*args):
        steps[0] += 1
        return real_slots(*args)

    for k in nkm.EMITTED:
        nkm.EMITTED[k] = 0
    nkm.FLAT["pallas_nest"] = 0
    M.decode_slots = counted
    try:
        eng, hs, wall = serve_online(torch, cfg, params, prompts, prog, tuning_db=k2_db)
    finally:
        M.decode_slots = real_slots
    launches, flat = nkm.EMITTED["pallas_nest"], nkm.FLAT["pallas_nest"]
    tokens = all_completed("(a)", hs)
    log(f"  (a) served {N_REQUESTS} requests (prompts {int(lens.min())}-{int(lens.max())} tokens, "
        f"{ONLINE_NEW} new each, {ONLINE_SLOTS} slots) with the logit program on K2 in {wall:.2f} "
        f"s: {steps[0]} decode steps, K2 {launches} launches ({flat} flattened), K3 "
        f"{nkm.EMITTED['pallas_reduce']}; {len({t for ts in tokens for t in ts})} distinct tokens")
    if not (launches == flat == steps[0] > 0) or nkm.EMITTED["pallas_reduce"]:
        raise AssertionError(f"phase 15: K2 should launch once a decode step, flattened: "
                             f"{launches} launches, {flat} flattened, {steps[0]} steps")
    if len({t for ts in tokens for t in ts}) < 2:
        raise AssertionError("phase 15: every served token is the same")
    if eng.degradations:
        raise AssertionError(f"phase 15: degradations nobody injected: {eng.degradations}")
    out.update(a_wall_s=wall, a_steps=steps[0], k2_launches=launches, k2_flat=flat)
    out["k2"] = check_logit_nest(torch, cfg, params, eng._states, eng._tokens, prog, k2_db)
    out["k2"].update(launches=launches, flat_runs=flat)
    out["step_ab"] = logit_step_ab(torch, cfg, params, eng._states, eng._tokens,
                                   eng._dispatch_greedy)
    res = eng.compile_resilient(prog)
    if res.backend != "cuda" or eng.degradations:
        raise AssertionError(f"phase 15: compile_resilient without a fault went to "
                             f"{res.backend}: {eng.degradations}")
    del eng
    eng, hs, wall = serve_online(torch, cfg, params, prompts, prog, tuning_db=k2_db,
                                 program_backend="torch")
    if all_completed("(a) torch", hs) != tokens:
        raise AssertionError("phase 15: program_backend='torch' served other tokens than K2")
    log(f"  (a) the same traffic with program_backend='torch' in {wall:.2f} s: the same tokens")
    del eng

    # (b), (c): the online loop from a stale entry, sync then on a thread
    def supervisor(mode):
        return SearchSupervisor(logit_db(prog, **ONLINE_STALE), backend="cuda", mode=mode,
                                check_every=4, iterations=1, population=4, repeats=3,
                                deadline_s=30.0,
                                policy=SwapPolicy(margin=0.05, min_observations=2),
                                device="cuda")

    for label, mode in (("(b)", "sync"), ("(c)", "thread")):
        sup = supervisor(mode)
        gen0 = sup.db.generation
        with CandidateLog() as cands:
            eng, hs, wall = serve_online(torch, cfg, params, prompts, prog, tuner=sup)
            if sup._thread is not None:
                sup._thread.join(timeout=300)
            alive = sup.busy
            late = sup.poll(engine=eng)
        got = all_completed(label, hs)
        log(f"  {label} {mode} tuner from a stale {ONLINE_STALE} entry: served in {wall:.2f} s, "
            f"{eng._step_count} steps, telemetry {sup.telemetry.snapshot()}")
        for kind, budget, tile, unroll, us in cands.rows:
            log(f"    measured {kind} (vec_budget {budget}, tile {tile}, unroll {unroll}): "
                f"{us:.1f} us")
        for s in sup.swaps:
            log(f"    swap {s.old_recipe.kind if s.old_recipe else None} -> {s.new_recipe.kind}: "
                f"candidate {s.candidate_us:.1f} us, incumbent {s.incumbent_us:.1f} us, generation "
                f"{gen0} -> {s.generation}, degraded to {s.degraded_to}, rolled back "
                f"{s.rolled_back}")
        for r in sup.rejected:
            log(f"    rejected: {r['reason']}")
        if got != tokens:
            raise AssertionError(f"phase 15 {label}: the tuned engine served other tokens than (a)")
        if alive or sup.quarantined or sup.degradations or eng.degradations:
            raise AssertionError(f"phase 15 {label}: search thread alive {alive}, quarantined "
                                 f"{sup.quarantined}, degradations {sup.degradations} "
                                 f"{eng.degradations}")
        row = dict(wall_s=wall, steps=eng._step_count, late_swaps=len(late),
                   candidates=[[*r[:4], r[4] if math.isfinite(r[4]) else None]
                               for r in cands.rows],
                   swaps=[dict(old=s.old_recipe.kind if s.old_recipe else None,
                               new=s.new_recipe.kind, candidate_us=s.candidate_us,
                               incumbent_us=s.incumbent_us, generation=s.generation,
                               rolled_back=s.rolled_back) for s in sup.swaps],
                   rejected=[r["reason"] for r in sup.rejected])
        if mode == "sync":
            if not sup.swaps:
                raise AssertionError(f"phase 15 (b): no swap landed: {sup.rejected}")
            with tempfile.TemporaryDirectory(prefix="repro-fleet-") as tmp:
                fleet = Path(tmp) / "fleet.json"
                report = sup.fold_back(fleet)
                disk = TuningDatabase.load(fleet)
                kinds = [e.recipe.kind for e in disk.entries]
            log(f"    fold_back: {report}; the fleet file holds {kinds}, online_swaps "
                f"{disk.meta.get('online_swaps')}")
            live = [e.recipe.kind for e in sup.db.entries]
            if kinds != live or report["added"] != len(live):
                raise AssertionError(f"phase 15 (b): fold_back wrote {kinds}, live {live}")
            row["fold_back"] = dict(report=report, kinds=kinds)
        out[label.strip("()")] = row
        del eng

    # (d) injected faults: the greedy path (a NaN at one prefill, a failed
    # step), then the sync path (an error at one request's decode, another's
    # logits); the survivors must generate (a)'s tokens
    class StepFault(FaultPlan):
        """``FaultPlan`` that also fails the ``at``-th ``serve.step``."""

        def __init__(self, faults, at):
            super().__init__(faults)
            self.at, self.steps = at, 0

        def fire(self, site, key=None):
            if site == "serve.step":
                self.steps += 1
                if self.steps == self.at:
                    self.fired.append((site, key, "error"))
                    return Fault(site, "error", key=key, times=0)
            return super().fire(site, key)

    runs = {"greedy": (StepFault([Fault("serve.prefill", "nan", key=3)], at=12), 0.0),
            "sync": (FaultPlan([Fault("serve.decode", "error", key=5),
                                Fault("serve.logits", "error", key=9)]), ONLINE_SYNC_T)}
    out["d"] = {}
    for name, (plan, temp) in runs.items():
        eng, hs, wall = serve_online(torch, cfg, params, prompts, prog, tuning_db=k2_db,
                                     fault_plan=plan, temperature=temp)
        failed = {h.rid: h.error for h in hs if h.failed}
        by_site = {}
        for rid, e in failed.items():
            site = ("nan" if isinstance(e, NonFiniteLogits) else
                    str(e).split(" at ")[1].split(" ")[0] if isinstance(e, FaultInjected) else
                    repr(e))
            by_site.setdefault(site, []).append(rid)
        log(f"  (d) {name}: fired {plan.fired}; failed by cause {by_site}; served in {wall:.2f} s")
        want = ({"nan": [3]} if name == "greedy" else
                {"serve.decode": [5], "serve.logits": [9]})
        if name == "greedy":
            stepped = by_site.pop("serve.step", [])
            if not 1 <= len(stepped) <= ONLINE_SLOTS or 3 in stepped:
                raise AssertionError(f"phase 15 (d): the failed step failed {stepped}")
            want = {"nan": [3]}
        if by_site != want:
            raise AssertionError(f"phase 15 (d) {name}: failures {by_site}, scheduled {want}")
        bad = [(h.rid, h.tokens, tokens[h.rid]) for h in hs
               if not h.failed and (h.state.value != "completed" or h.tokens != tokens[h.rid])]
        if bad or eng.degradations:
            raise AssertionError(f"phase 15 (d) {name}: survivors differ from (a): {bad[:2]}; "
                                 f"degradations {eng.degradations}")
        out["d"][name] = dict(failed=sorted(failed), survivors=len(hs) - len(failed),
                              fired=[list(f) for f in plan.fired], wall_s=wall)
        del eng
    eng = serve_online(torch, cfg, params, [], prog, tuning_db=k2_db,
                       fault_plan=FaultPlan([Fault("daisy.compile", "error", key="cuda")]))[0]
    res = eng.compile_resilient(prog)
    log(f"  (d) compile_resilient under an injected daisy.compile fault on 'cuda': backend "
        f"{res.backend}, errors {[(b, type(e).__name__) for b, e in res.errors]}, degradations "
        f"{eng.degradations}")
    if res.backend != "torch" or eng.degradations != [(prog.name, "cuda", "torch")]:
        raise AssertionError(f"phase 15 (d): compile_resilient did not degrade to torch: "
                             f"{res.backend}, {eng.degradations}")
    out["d"]["compile_resilient"] = dict(backend=res.backend, degradations=eng.degradations)
    del eng
    gc.collect()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 15: {out['seconds']:.1f} s; {smi}")
    return out


# Phases 11-12: the vlm and audio families at full width.  LLaVA-NeXT's
# forward takes its 2880 anyres patch positions and 1216 text tokens (4096 in
# all); Seamless's its 4096 frames and 256 text tokens.  Phase 12 serves
# prompts of 16-512 tokens from 2048-position slots.
LLAVA, SEAMLESS = "llava-next-mistral-7b", "seamless-m4t-large-v2"
LLAVA_TEXT, SEAMLESS_TEXT = 1216, 256
FORWARD_COMPARED = 256  # last text positions held against the plain forward


def family_forward(torch, cfg, params, n_text: int, gate: bool = True) -> dict:
    """``forward`` on one sequence of ``n_text`` seeded tokens with seeded
    frontend embeddings (vlm: ``frontend_len`` patch embeddings at the token
    embeddings' scale before the text; audio: ``frontend_len`` frames of
    unit scale into the encoder; none for a model without a frontend), held
    against the fp32 plain forward at the last FORWARD_COMPARED text
    positions; for MoE the plain forward dispatches the sequence in one group,
    as ``forward`` does, and follows its near-tie routing choices.
    ``gate=False`` measures the distance without holding it (as in
    ``serve_path``)."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.models import plain

    from repro_torch.models import layers as L

    toks = torch.as_tensor(np.random.default_rng(SEED + 3).integers(0, cfg.vocab, n_text),
                           device="cuda")
    batch, kw, front = {"tokens": toks[None]}, {}, ""
    routes, real_route = [], L.moe_route
    if cfg.is_moe:  # the plain forward follows the forward's near-tie routing choices

        def moe_route(x, router, k):
            gates, experts = real_route(x, router, k)
            routes.append(experts)
            return gates, experts

        L.moe_route = moe_route
        kw["routing"], kw["stats"] = routes, {}
    if cfg.frontend is not None:
        gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
        scale = EMBED_STD if cfg.family == "vlm" else 1.0
        emb = (torch.randn((cfg.frontend_len, cfg.d_model), generator=gen, device="cuda")
               * scale).to(M.dtype_of(cfg))
        batch["embeds"], kw["embeds"] = emb[None], emb
        front = f"{cfg.frontend_len} {cfg.frontend} positions + "
    try:
        t0 = time.perf_counter()
        logits = M.forward(cfg, params, batch)[0]
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
    finally:
        L.moe_route = real_route
    if tuple(logits.shape) != (n_text, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"forward: logits {tuple(logits.shape)} or non-finite")
    logits = logits[-FORWARD_COMPARED:].clone()
    want = plain.forward(cfg, params, toks, **kw)[-FORWARD_COMPARED:]
    err = float(rel_l2(torch, logits, want).max())
    ties = (f"; {kw['stats'].get('near_ties', 0)} near-tie token-layers took the forward's "
            "routing choice" if cfg.is_moe else "")
    log(f"  forward on {front}{n_text} tokens in {t_fwd:.3f} s; logits at the last "
        f"{FORWARD_COMPARED} text positions vs fp32 plain: relative L2 max {err:.3e}{ties}"
        + ("" if gate else f" (measured, not held to {LOGITS_REL_TOL})"))
    if gate and not err <= LOGITS_REL_TOL:
        raise AssertionError(f"forward logits: relative L2 {err:.3e} > {LOGITS_REL_TOL}")
    return dict(forward_s=t_fwd, forward_rel_l2=err)


def ops_matmul_path(torch, smi: str, cfg, bucket: int, counts) -> tuple[tuple, list]:
    """``ops.matmul`` (K1) at the contraction plan's ``q_proj`` and ``ffn_in``
    products of one ``bucket``-token sequence, fp32 and bf16, on seeded
    inputs: the launches of one call each (read by ``counts`` right after:
    K1's total and its ``PATHS``), then each product against the plain
    version (fp32 within 2e-4 relative to its largest value, bf16 within
    rtol 5e-2 / atol 5e-1) and timed, a call and 20 back to back (the
    profiler drops one of 20 such kernels), beside ``torch.matmul`` (full
    fp32 in fp32) and the bound."""
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import ops
    from repro_torch.models.lowering import plan_model

    plans = {p.name: p for p in plan_model(cfg, bucket, 1)}
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = []
    for name in ("q_proj", "ffn_in"):
        m, n, k = plans[name].mnk
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
            w = torch.randn(k, n, generator=g, device="cuda").to(dtype)
            before = dict(kg.PATHS)
            got = ops.matmul(x, w, tile=plans[name].recipe.tile)
            ran = [p for p in kg.PATHS if kg.PATHS[p] != before[p]]
            cases.append((name, plans[name].recipe.tile, x, w, got, ran))
    torch.cuda.synchronize()
    launches = counts()
    rows = []
    for name, tile, x, w, got, ran in cases:
        (m, k), n = x.shape, w.shape[1]
        fp32 = x.dtype == torch.float32
        want = kg.gemm_plain(x, w)
        if fp32:
            err = max_rel(got, want)
            ok = err <= KERNEL_MAX_REL
        else:
            err = float((got.float() - want.float()).abs().max())
            ok = torch.allclose(got.float(), want.float(), rtol=BF16_RTOL, atol=BF16_ATOL)
        if not ok:
            raise AssertionError(f"ops.matmul {name} {tuple(x.shape)} @ {tuple(w.shape)} "
                                 f"{x.dtype}: error {err:.3e}")
        flops = 2.0 * m * n * k
        t_ops = (3 * flops / PEAK_TF32 if fp32 else flops / PEAK_BF16) * 1e3
        t_bytes = x.element_size() * (m * k + k * n + m * n) / PEAK_BYTES * 1e3
        call = lambda: ops.matmul(x, w, tile=tile)  # noqa: E731
        lib = lambda: torch.matmul(x, w)  # noqa: E731
        row = dict(contraction=name, shape=f"{m}x{k} @ {k}x{n} {str(x.dtype)[6:]}",
                   plan_tile=list(tile), kernel=" ".join(kg.KERNELS[p] for p in ran),
                   error=err, ms=cuda_ms(call), stream_ms=stream_ms(torch, call, n=20),
                   plain_ms=cuda_ms(lambda: kg.gemm_plain(x, w), repeats=3),
                   library_ms=cuda_ms(lib), library_stream_ms=stream_ms(torch, lib, n=20),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", card=smi)
        log(f"  ops.matmul (K1) {name} {row['shape']} on {row['kernel']} (plan tile "
            f"{tuple(tile)}, ignored): {row['ms']:.4f} ms a call (back to back "
            f"{row['stream_ms']:.4f}, {row['bound_ms'] / row['stream_ms']:.1%} of the bound), "
            f"plain {row['plain_ms']:.4f}, torch.matmul {row['library_ms']:.4f} (back to back "
            f"{row['library_stream_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
            f"({'3xTF32' if fp32 else 'bf16'}); error {err:.3e}; {smi}")
        rows.append(row)
    return launches, rows


def family_phase(torch, smi: str, phase: int, arch: str, *, slots: int, max_len: int,
                 prompt_lens: tuple[int, int], n_text: int, bucket: int, reset_counts,
                 model_counts) -> dict:
    """Phases 11-12: ``arch`` at full width, bf16, seeded: served through
    ``ServingEngine`` (``serve_path``: 16 requests, 32 new tokens each), then
    ``family_forward``, then (vlm) ``ops_matmul_path``; each path's launches
    counted from 0 and checked: K4 and K5 launched, K5's prefill (encoder
    included) only on the tensor-core kernel and its decode steps only on the
    decode kernel, cross-attention (audio) likewise, and the forward only on
    the tensor-core kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    cfg = get_config(arch)
    params = seeded_params(torch, cfg)
    out = {}
    reset_counts()
    with PrefillPaths(M, kf) as prefill_paths, CrossPaths(L, kf) as cross:
        served = serve_path(torch, smi, cfg, params, slots=slots, n_requests=N_REQUESTS,
                            watched=WATCHED, seed=SEED + phase, max_len=max_len,
                            prompt_lens=prompt_lens, bucket=bucket)
    torch.cuda.synchronize()
    n = model_counts()
    decode = check_k5_paths(f"phase {phase}", n["k5"], prefill_paths.counts)
    log(f"  launches: K4 rmsnorm {n['rmsnorm']}, K5 flash attention {n['flash_attention']} "
        f"(K1 {n['gemm']}, K6 {n['grouped_matmul']}); cross-attention K5 {cross.counts}")
    if cfg.family == "audio":
        cx = cross.counts
        if (cx["decode"]["decode"] <= 0 or any(v for k, v in cx["decode"].items() if k != "decode")
                or cx["prefill"]["mma"] <= 0
                or any(v for k, v in cx["prefill"].items() if k != "mma")):
            raise AssertionError(f"phase {phase}: cross-attention should launch K5's decode "
                                 f"kernel at decode and its mma kernel at prefill: {cx}")
    out["serving"] = dict(rmsnorm=n["rmsnorm"], flash_attention=n["flash_attention"],
                          k5_prefill=dict(prefill_paths.counts), k5_decode=decode,
                          k5_cross=cross.counts, stats=served["stats"])
    del served

    reset_counts()
    fwd = family_forward(torch, cfg, params, n_text)
    torch.cuda.synchronize()
    n = model_counts()
    log(f"  launches: K4 rmsnorm {n['rmsnorm']}, K5 flash attention {n['flash_attention']} "
        f"(by kernel {n['k5']})")
    if n["k5"]["mma"] <= 0 or any(v for k, v in n["k5"].items() if k != "mma"):
        raise AssertionError(f"phase {phase}: the forward should launch only the mma K5 "
                             f"kernel: {n['k5']}")
    out["forward"] = dict(rmsnorm=n["rmsnorm"], flash_attention=n["flash_attention"],
                          k5=n["k5"], **fwd)
    for path in ("serving", "forward"):
        for k in ("rmsnorm", "flash_attention"):
            if out[path][k] <= 0:
                raise AssertionError(f"phase {phase}: kernel {k} was not launched on the "
                                     f"{path} path")
    if cfg.family == "vlm":
        reset_counts()
        (launched, paths), rows = ops_matmul_path(
            torch, smi, cfg, 2048, lambda: (model_counts()["gemm"], model_counts()["k1"]))
        log(f"  launches: K1 {launched} (by kernel {paths})")
        if launched <= 0 or paths["tf32x3"] <= 0 or paths["wgmma"] <= 0:
            raise AssertionError(f"phase {phase}: ops.matmul should launch K1's tf32x3 kernel "
                                 f"(fp32) and its wgmma kernel (bf16): {launched}, {paths}")
        out["ops_matmul"] = dict(gemm=launched, gemm_by_kernel=paths, rows=rows)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# Phases 13-14: the recurrent families.  Jamba-1.5-Large at every published
# width with all 16 experts does not fit one card: one MoE layer's experts are
# 16 x 3 x 8192 x 24576 bf16 = 19.3 GB, an 8-layer period (four MoE, seven
# Mamba, four dense FFNs, one attention) about 90.5 GB.  Its first 4 of 72
# layers hold every kind of block in the period (46 GB): the first stage of
# an 18-stage pipeline.  xLSTM-350M runs whole.
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-350m"
JAMBA_LAYERS = 4
RECURRENT_TEXT = 4096  # tokens of phases 13-14's forward
SOLO = 15  # the watched request also served alone (admitted into a refilled slot)


# Phase 14's bf16 check, layer by layer.  Each mLSTM layer of xLSTM-350M, seeded
# as here, amplifies a perturbation of its input 1.3-2.2 times (measured in
# fp32 on a CPU at d_model 512 and 1024), so bf16's rounding, about 5e-3 of a
# layer's output, grows through 21 of them past any fixed limit on the
# logits; the same model in fp32 stays within 4e-3 of the plain forward.  So
# the bf16 model is held one layer at a time: each layer's mixer output on
# the forward's own bf16 input against ``plain.layer``'s on that input, as a
# whole (relative L2 over the compared positions).  Per position, the
# mLSTM's normalizer cancels where its output is small, and bf16's relative
# error there reached 3.9-4.0e-2 on an H100 (PERF.md); over the block it is
# 0.6-0.8e-2 (CPU, d_model 1024), while fp8 weights give 6-8e-2 at the
# mLSTM layers.
LAYER_MUTANT_LAYERS = (0, 1, 7)  # the mLSTM on the embeddings, the next, an sLSTM


def layer_gate(torch, cfg, params, n_text: int) -> dict:
    """``forward`` on ``n_text`` seeded tokens (family_forward's) with every
    layer's input and mixer output kept; each mixer output (K4's norm and the
    scan, before the residual add) at the last FORWARD_COMPARED positions
    held against ``plain.layer``'s increment on the same input by the
    relative L2 over those positions, within LOGITS_REL_TOL (the largest
    per-position error is printed beside it); eps = 0, gamma = 1 and fp8
    weights, each on LAYER_MUTANT_LAYERS, must exceed it.  For a model
    without FFN sub-blocks, whose layers are their mixers."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.models import plain

    if cfg.d_ff:
        raise ValueError("layer_gate holds mixers: a model without FFN sub-blocks")
    toks = torch.as_tensor(np.random.default_rng(SEED + 3).integers(0, cfg.vocab, n_text),
                           device="cuda")
    real_block, real_mixers = M._apply_block, dict(M._RECURRENT_MIXERS)
    inputs, outputs = [], []

    def apply_block(x, *args, **kw):
        inputs.append(x[0].clone())
        return real_block(x, *args, **kw)

    def kept(fn):
        def mixer(x, *args, **kw):
            out, state = fn(x, *args, **kw)
            outputs.append(out[0, -FORWARD_COMPARED:].float())
            return out, state
        return mixer

    M._apply_block = apply_block
    M._RECURRENT_MIXERS.update({k: kept(fn) for k, fn in real_mixers.items()})
    try:
        M.forward(cfg, params, {"tokens": toks[None]})
    finally:
        M._apply_block = real_block
        M._RECURRENT_MIXERS.update(real_mixers)

    def increment(mcfg, blk, l):
        x_in = inputs[l]
        return (plain.layer(mcfg, blk, l, x_in)[-FORWARD_COMPARED:]
                - x_in[-FORWARD_COMPARED:].float())

    def block_err(got, want):
        return float((got - want).norm() / want.norm())

    wants = [increment(cfg, blk, l) for l, blk in enumerate(params["layers"])]
    errs = [block_err(got, want) for got, want in zip(outputs, wants)]
    per_position = max(float(rel_l2(torch, got, want).max()) for got, want in zip(outputs, wants))
    worst = max(errs)
    log(f"  each layer alone (the bf16 forward on {n_text} tokens, its own input): mixer output "
        f"vs the fp32 plain layer's, relative L2 over the last {FORWARD_COMPARED} positions: "
        + " ".join(f"{e:.2e}" for e in errs) + f"; max {worst:.3e} (limit {LOGITS_REL_TOL}); "
        f"largest at one position {per_position:.3e}")
    if not worst <= LOGITS_REL_TOL:
        raise AssertionError(f"layer outputs: relative L2 {worst:.3e} > {LOGITS_REL_TOL}")
    ones = lambda b: {k: (torch.ones_like(v) if k.startswith("norm") else v)  # noqa: E731
                      for k, v in b.items()}
    fp8 = lambda b: {k: (v if k.startswith("norm")  # noqa: E731
                         else {n: fp8_round(torch, w) for n, w in v.items()}) for k, v in b.items()}
    mutated = {}
    for label, mcfg, fn in (("eps = 0", replace(cfg, norm_eps=0.0), lambda b: b),
                            ("gamma = 1", cfg, ones), ("fp8 weights", cfg, fp8)):
        mutated[label] = max(block_err(increment(mcfg, fn(params["layers"][l]), l), wants[l])
                             for l in LAYER_MUTANT_LAYERS)
        log(f"  layer mutant '{label}' on layers {LAYER_MUTANT_LAYERS}: relative L2 max "
            f"{mutated[label]:.3e}")
        if mutated[label] <= LOGITS_REL_TOL:  # NaN is caught
            raise AssertionError(f"the layer limit {LOGITS_REL_TOL} does not catch '{label}'")
    return dict(layer_rel_l2=errs, layer_rel_l2_per_position=per_position,
                layer_mutants=mutated)


def recurrent_phase(torch, smi: str, phase: int, cfg, *, bucket: int, reset_counts,
                    model_counts, fp32_gate: bool = False) -> dict:
    """Phases 13-14: ``cfg`` (hybrid or ssm) bf16, seeded: served through
    ``ServingEngine`` (``serve_path``: 8 slots of 4096 positions, 16 requests
    of 128-2048 tokens prefilled at their exact length, 32 new tokens each);
    request SOLO served again alone, token for token against its tokens
    beside the others; then ``family_forward`` on RECURRENT_TEXT tokens.
    Each path's launches are counted from 0 and checked: hybrid launches K4,
    K5 (prefill and forward on the tensor-core kernel, decode on the decode
    kernel) and K6 (every launch on ``choose_kernel``'s pick: the decode
    kernel below C = 32, the wgmma kernel from there); ssm launches K4 and
    neither K5 nor K6.

    ``fp32_gate`` (phase 14): the same traffic is first served by the model
    in fp32 (the same seeded weights before rounding), whose logits are held
    to LOGITS_REL_TOL with the mutants; the bf16 serving and forward logits'
    distance from the plain forward is then measured, not held, and the bf16
    model is held layer by layer instead (``layer_gate``)."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.models import model as M
    from repro_torch.serve import ServingEngine

    hybrid = cfg.family == "hybrid"
    torch.cuda.reset_peak_memory_stats()
    out = {}
    if fp32_gate:
        cfg32 = replace(cfg, dtype="float32")
        log(f"  {cfg.name} in fp32, held to the logits limit:")
        params32 = seeded_params(torch, cfg32)
        reset_counts()
        served = serve_path(torch, smi, cfg32, params32, slots=8, n_requests=N_REQUESTS,
                            watched=WATCHED, seed=SEED + phase, bucket=bucket, breakdown=False)
        torch.cuda.synchronize()
        n = model_counts()
        log(f"  launches (fp32): K4 rmsnorm {n['rmsnorm']}, K5 {n['flash_attention']}, K6 "
            f"{n['grouped_matmul']}")
        if n["rmsnorm"] <= 0 or n["flash_attention"] or n["grouped_matmul"]:
            raise AssertionError(f"phase {phase} (fp32): K4 should launch, K5 and K6 not: {n}")
        out["fp32_serving"] = dict(rmsnorm=n["rmsnorm"], stats=served["stats"])
        del served, params32
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  {cfg.name} in {cfg.dtype}:")
    params = seeded_params(torch, cfg)
    log(f"  layers: " + ", ".join(f"{l} {cfg.layer_kind(l)}"
                                  + ("+moe" if cfg.layer_is_moe(l) else "+ffn" if cfg.d_ff else "")
                                  for l in range(cfg.n_layers)))
    reset_counts()
    with PrefillPaths(M, kf) as prefill_paths, GmmPaths(km) as gmm_paths:
        served = serve_path(torch, smi, cfg, params, slots=8, n_requests=N_REQUESTS,
                            watched=WATCHED, seed=SEED + phase, bucket=bucket,
                            gate=not fp32_gate)
    torch.cuda.synchronize()
    n = model_counts()
    log(f"  launches: K4 rmsnorm {n['rmsnorm']}, K5 flash attention {n['flash_attention']} "
        f"(by kernel {n['k5']}), K6 grouped matmul {n['grouped_matmul']} (K1 {n['gemm']}, "
        f"K2 {n['pallas_nest']}, K3 {n['pallas_reduce']})")
    serving = dict(rmsnorm=n["rmsnorm"], flash_attention=n["flash_attention"],
                   grouped_matmul=n["grouped_matmul"], stats=served["stats"])
    if n["rmsnorm"] <= 0:
        raise AssertionError(f"phase {phase}: K4 was not launched on the serving path")
    if hybrid:
        serving["k5_prefill"] = dict(prefill_paths.counts)
        serving["k5_decode"] = check_k5_paths(f"phase {phase}", n["k5"], prefill_paths.counts)
        serving["k6_by_c"] = check_k6_paths(f"phase {phase}", gmm_paths, 8, km.WGMMA_MIN_C)
        serving["grouped_matmul_decode"] = sum(v.get("decode", 0)
                                               for v in serving["k6_by_c"].values())
        if n["flash_attention"] <= 0 or n["grouped_matmul"] <= 0:
            raise AssertionError(f"phase {phase}: K5 or K6 was not launched on the serving path")
    elif n["flash_attention"] or n["grouped_matmul"]:
        raise AssertionError(f"phase {phase}: {cfg.family} has no attention or FFN, yet K5 "
                             f"launched {n['flash_attention']} and K6 {n['grouped_matmul']}")
    out["serving"] = serving

    # no padded token reaches a recurrent state: one request served alone
    # generates what it generated beside the others
    eng = ServingEngine(cfg, params, served["scfg"])
    alone = eng.submit(served["prompts"][SOLO]).result()
    del eng
    if alone != served["tokens"][SOLO]:
        raise AssertionError(f"phase {phase}: request {SOLO} alone {alone} != beside the others "
                             f"{served['tokens'][SOLO]}")
    log(f"  request {SOLO} ({served['prompts'][SOLO].size} prompt tokens) served alone: the "
        f"same {len(alone)} tokens as beside the others")
    del served
    gc.collect()

    reset_counts()
    with GmmPaths(km) as gmm_paths:
        fwd = family_forward(torch, cfg, params, RECURRENT_TEXT, gate=not fp32_gate)
    torch.cuda.synchronize()
    n = model_counts()
    if fp32_gate:
        fwd.update(layer_gate(torch, cfg, params, RECURRENT_TEXT))
    log(f"  launches: K4 rmsnorm {n['rmsnorm']}, K5 flash attention {n['flash_attention']} "
        f"(by kernel {n['k5']}), K6 grouped matmul {n['grouped_matmul']} (by C and kernel "
        f"{gmm_paths.by_c()})")
    if n["rmsnorm"] <= 0:
        raise AssertionError(f"phase {phase}: K4 was not launched on the forward path")
    if hybrid and (n["k5"]["mma"] <= 0 or any(v for k, v in n["k5"].items() if k != "mma")
                   or n["grouped_matmul"] <= 0
                   or any(set(v) != {"wgmma"} for v in gmm_paths.by_c().values())):
        raise AssertionError(f"phase {phase}: the forward should launch only the mma K5 kernel "
                             f"and the wgmma K6 kernel: {n['k5']}, K6 {gmm_paths.by_c()}")
    if not hybrid and (n["flash_attention"] or n["grouped_matmul"]):
        raise AssertionError(f"phase {phase}: the forward launched K5 or K6")
    out["forward"] = dict(rmsnorm=n["rmsnorm"], flash_attention=n["flash_attention"],
                          k5=n["k5"], grouped_matmul=n["grouped_matmul"], **fwd)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  peak device memory over phase {phase}: {out['peak_memory_gb']:.2f} GB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 16: training.  MiniCPM-2B (arXiv:2404.06395: 40 layers, d_model 2304,
# 36 heads of 64, d_ff 5760, vocab 122,753, tied embeddings; 2.72 B
# parameters) trains whole on one card through ``repro_torch.train.Trainer``:
# bf16 parameters and gradients (5.4 GB each), fp32 AdamW moments (21.8 GB),
# the fp32 gradient sum of two microbatches (10.9 GB), block remat.  Its
# forward runs K4 and K5 (the tensor-core kernel, writing the log-sum-exp),
# its backward K4-bwd and K5-bwd.
# ---------------------------------------------------------------------------
MINICPM = "minicpm-2b"
# bf16 gradients against the plain version's fp32 autograd gradients of the
# same bf16 inputs, relative L2 per tensor; fp32 K4-bwd max-relative
# (tests/test_torch_train_kernels.py states why; set from the first reading
# on the card, PERF.md)
BF16_GRAD_REL_L2 = 1e-2
F32_RMS_GRAD_MAX_REL = 1e-4
# (b): the bf16 model on the kernels against the fp32 plain forward + autograd
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2  # the serving gate's limit, on the global gradient
GATE_TOKENS = 1024
# K4-bwd's timed shapes: a MiniCPM microbatch (4 x 2048 tokens) and 2048 rows
# at the serving widths (Danube, Mixtral and LLaVA, Jamba, Seamless)
K4_BWD_SHAPES = [(8192, 2304), (2048, 3840), (2048, 4096), (2048, 8192), (2048, 1024)]
# and its edges, (rows, D, offset): rows not a multiple of the grid's row
# slots, D 40 and 100 (bf16's 100 off the 16-byte chunk: the loop kernel),
# views an element off 16 bytes (the loop kernel)
K4_BWD_EDGES = [(300, 40, 0), (300, 100, 0), (1001, 2304, 1), (37, 8192, 1)]
# K5-bwd's timed shapes: (label, BHq, BHkv, Sq = Skv, D, window); causal
K5_BWD_SHAPES = [("MiniCPM-2B microbatch", 144, 144, 2048, 64, None),
                 ("Danube heads, 2048", 32, 8, 2048, 120, 4096),
                 ("Danube heads, 8192, window 4096", 32, 8, 8192, 120, 4096),
                 ("Mixtral heads, 2048", 32, 8, 2048, 128, None)]
# graph ms of the backward kernels the tensor-core K5-bwd, the wgmma K6-bwd
# and the 16-byte K4-bwd replaced (K5-bwd on the CUDA cores, K6-bwd on
# mma.sync, K4-bwd on 2-byte loads with 528 partial rows; chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md), printed in brackets beside this
# run's; not in the kernels line, which holds this run's measurements only
REPLACED_GRAPH_MS = {"MiniCPM-2B microbatch": "11.93-11.95",
                     "Danube heads, 2048": "5.95-5.98",
                     "Danube heads, 8192, window 4096": "69.68-69.88",
                     "Mixtral heads, 2048": "5.95-5.96",
                     "Seamless encoder": "10.15-10.17", "Seamless cross-attention": "5.13-5.14",
                     "Mixtral gate/up C 2560": "20.51-20.55", "Mixtral down C 2560": "20.69-21.11",
                     "Jamba gate/up E 2 C 2560": "18.45-18.59",
                     "Jamba gate/up E 16 C 320": "21.76-22.06", "ragged": "0.011-0.012",
                     **{f"Mixtral {p} C {c}": "1.45-1.49" for p in ("gate/up", "down")
                        for c in (16, 40)},
                     **{f"Mixtral {p} C 320": "3.09-3.18" for p in ("gate/up", "down")},
                     "K4-bwd 8192x2304": "0.0855-0.0865", "K4-bwd 2048x3840": "0.0420-0.0453",
                     "K4-bwd 2048x4096": "0.0444-0.0473", "K4-bwd 2048x8192": "0.0900-0.0917",
                     "K4-bwd 2048x1024": "0.0204-0.0224"}


def replaced(label: str) -> str:
    """`` [replaced kernel: ...]`` for a timed shape of K4-bwd, K5-bwd or
    K6-bwd."""
    return (f" [replaced kernel: {REPLACED_GRAPH_MS[label]}]" if label in REPLACED_GRAPH_MS
            else "")


TRAIN_STEPS = 6
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM = 2048, 8, 2
# (c) runs at the training CLI's learning rate (`launch/train.py`, 3e-4 with
# WSD and one warm-up step for 6 steps), timed and profiled.  There AdamW's
# first steps (each weight moved by about lr, the sign of its gradient) are
# too large for MiniCPM's 2304-wide layers: on an H100 the loss went 11.86,
# 12.24, 20.39, 8.26, 19.07, 13.12 (PERF.md), and the reference does the
# same on the CPU at width 2304 (8 layers, vocab 8192: 9.62 -> 15.38 ->
# 10.39).  That the model learns is held at LEARN_LR, where the reference's
# loss falls at width 2304 (8 layers) and at depth 40 (width 1024).
TRAIN_LR, LEARN_LR = 3e-4, 3e-5
RESILIENT_LAYERS = 4  # (d): a full-width checkpoint of all 40 layers is ~27 GB of npz


def bwd_timing(torch, call, plain, library, library_graph=None) -> dict:
    """A backward's times: one call (CUDA events), a CUDA graph of calls,
    the plain version's call and the library's backward through autograd,
    and, where ``library_graph`` is given, that backward's graph ms from it."""
    return dict(ms=cuda_ms(call), graph_ms=graph_ms(torch, call, n=5),
                plain_ms=cuda_ms(plain, repeats=3),
                library_ms=cuda_ms(library) if library is not None else None,
                **({} if library_graph is None else {"library_graph_ms": library_graph()}))


def autograd_graph_ms(torch, forward, inputs, dout, n: int = 5,
                      tries: int = 2) -> float | None:
    """Device ms of one autograd backward of ``forward(*leaves)`` for the
    output gradient ``dout``: fresh leaves (copies of ``inputs``) and the
    forward are made on a side stream, so the backward's kernels and the
    leaves' gradient nodes live there too; two warm-up backwards, then
    ``n`` backwards (retaining the autograd graph) captured on that stream
    in one CUDA graph and replayed between CUDA events, as ``graph_ms``
    does.  A refused capture is tried again ``tries`` times in all, then
    None (not measured)."""
    for attempt in range(tries):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            leaves = [t.detach().clone().requires_grad_() for t in inputs]
            out = forward(*leaves)

            def backward():
                return torch.autograd.grad(out, leaves, dout, retain_graph=True)

            backward()
            backward()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side):
                for _ in range(n):
                    backward()
            break
        except RuntimeError as exc:
            log(f"    (library backward graph, capture {attempt + 1} of {tries} refused: "
                f"{str(exc).splitlines()[0]})")
            torch.cuda.synchronize()
    else:
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def check_rmsnorm_bwd(torch, smi: str) -> dict:
    """K4-bwd against its plain version (fp32 autograd of ``ref.rmsnorm`` on
    the same inputs) in fp32 and bf16 at K4_BWD_SHAPES and K4_BWD_EDGES,
    bit-identical over two launches, each on ``bwd_plan``'s route (the
    timed shapes on the vector kernel), then timed in bf16 at K4_BWD_SHAPES
    beside the bound (bytes: x and dy read, dx written), the plain version
    and ``F.rms_norm``'s backward (a call, and a CUDA graph)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as kr

    g = torch.Generator(device="cuda").manual_seed(16)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_abs = 0.0
    rows_out = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timed = [(rows, d, 0) for rows, d in K4_BWD_SHAPES]
    for rows, d, offset in timed + K4_BWD_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            def made(*shape):
                n = math.prod(shape)
                flat = torch.randn(n + offset, generator=g, device="cuda").to(dtype)
                return flat[offset:].view(shape)

            x, dy = made(rows, d), made(rows, d)
            gamma = (0.5 + torch.rand(d, generator=g, device="cuda")).to(dtype)
            plan = kr.bwd_plan(dtype, rows, d, offset == 0, sms)
            before = dict(kr.BWD_PATHS)
            dx, dg = kr.rmsnorm_bwd(x, gamma, dy)
            dx2, dg2 = kr.rmsnorm_bwd(x, gamma, dy)
            torch.cuda.synchronize()
            moved = {k: kr.BWD_PATHS[k] - before[k] for k in kr.BWD_PATHS
                     if kr.BWD_PATHS[k] != before[k]}
            if moved != {plan.route: 2} or ((rows, d, offset) in timed and plan.route != "vec"):
                raise AssertionError(f"K4-bwd {rows}x{d} {dtype} (offset {offset}): took "
                                     f"{moved}, the plan says {plan}")
            if not (torch.equal(dx, dx2) and torch.equal(dg, dg2)):
                raise AssertionError(f"K4-bwd {rows}x{d} {dtype}: two launches differ")
            want = ref.rmsnorm_grad(x.float(), gamma.float(), dy.float())
            for name, got, w in (("dx", dx, want[0]), ("dgamma", dg, want[1])):
                if dtype == torch.float32:
                    err = float((got - w).abs().max() / w.abs().max())
                    limit = F32_RMS_GRAD_MAX_REL
                else:
                    err = float((got.float() - w).norm() / w.norm())
                    limit = BF16_GRAD_REL_L2
                    worst_abs = max(worst_abs, float((got.float() - w).abs().max()))
                worst[dtype] = max(worst[dtype], err)
                if err > limit:
                    raise AssertionError(f"K4-bwd {rows}x{d} {dtype} {name}: {err:.3e} > {limit}")
            if (rows, d, offset) not in timed:
                off = " (views an element off 16 bytes)" if offset else ""
                log(f"  K4-bwd {rows}x{d} {str(dtype)[6:]}{off}: {plan.route}, within the "
                    "limit, bit-identical over two launches")
            if dtype != torch.bfloat16 or (rows, d, offset) not in timed:
                continue
            xr, gr = x.clone().requires_grad_(), gamma.clone().requires_grad_()
            lib_out = F.rms_norm(xr, (d,), gr, 1e-6) if hasattr(F, "rms_norm") else None
            library = (lambda: torch.autograd.grad(lib_out, (xr, gr), dy, retain_graph=True)) \
                if lib_out is not None else None
            library_graph = (lambda: autograd_graph_ms(
                torch, lambda a, b: F.rms_norm(a, (d,), b, 1e-6), (x, gamma), dy)) \
                if lib_out is not None else None
            t = bwd_timing(torch, lambda: kr.rmsnorm_bwd(x, gamma, dy),
                           lambda: ref.rmsnorm_grad(x, gamma, dy), library, library_graph)
            nbytes = 2.0 * (3 * rows * d + 2 * d)
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 10.0 * rows * d / PEAK_FP32 * 1e3
            row = dict(shape=f"{rows}x{d} bf16", plan=plan._asdict(),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations", **t)
            log(f"  K4-bwd {row['shape']} ({plan.route}: {plan.group} threads a row, "
                f"{plan.slots} rows a block, {plan.blocks} partial rows): {t['ms']:.4f} ms a "
                f"call, graph {t['graph_ms']:.4f}{replaced(f'K4-bwd {rows}x{d}')} "
                f"({row['bound_ms'] / t['graph_ms']:.1%} of the bound); bound "
                f"{row['bound_ms']:.4f} ({row['bound_by']}); plain {t['plain_ms']:.4f}; "
                f"F.rms_norm backward {fmt_ms(t['library_ms'])} a call, graph "
                f"{fmt_ms(t.get('library_graph_ms'))} ({smi})")
            rows_out.append(row)
    log(f"  K4-bwd against fp32 autograd: fp32 max-relative {worst[torch.float32]:.3e} "
        f"(limit {F32_RMS_GRAD_MAX_REL}), bf16 relative L2 {worst[torch.bfloat16]:.3e} (limit "
        f"{BF16_GRAD_REL_L2}); bit-identical over two launches at every shape")
    main = rows_out[0]
    return dict(name="rmsnorm_bwd", route="cuda", source="src/repro_torch/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:41 (its gradient: the TPU kernel has "
                         "none, the reference trains on XLA's gradient of kernels/ref.py)",
                max_abs_err=worst_abs, max_rel_l2_bf16=worst[torch.bfloat16],
                max_rel_f32=worst[torch.float32], **main,
                other_shapes=rows_out[1:])


def check_flash_bwd(torch, smi: str) -> dict:
    """K5-bwd against its plain version (fp32 autograd of ``ref.attention``
    on the same bf16 inputs, given the forward's own output and log-sum-exp)
    at tests/test_kernels.py's sweep x D {64, 120, 128} and at K5_BWD_SHAPES,
    bit-identical over two launches; each K5_BWD_SHAPES shape timed (a call,
    a CUDA graph) beside its bound (2.5x the forward's operations at 989
    TFLOP/s, or its bytes), the plain version and SDPA's backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(17)
    worst, worst_abs = 0.0, 0.0

    def check(label, bhq, bhkv, sq, skv, d, causal, window, off):
        nonlocal worst, worst_abs
        q = torch.randn(bhq, sq, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(bhkv, skv, d, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        do = torch.randn(bhq, sq, d, generator=g, device="cuda").bfloat16()
        kw = dict(causal=causal, window=window, q_offset=off)
        out, lse = kf.flash_attention_fwd(q, k, v, **kw)
        got = kf.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = kf.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        want = ref.attention_grad(q.float(), k.float(), v.float(), do.float(), **kw)
        errs = []
        for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"K5-bwd {label}: {name} differs over two launches")
            err = float((a.float() - w).norm() / w.norm().clamp_min(1e-30))
            worst_abs = max(worst_abs, float((a.float() - w).abs().max()))
            errs.append(err)
            if err > BF16_GRAD_REL_L2:
                raise AssertionError(f"K5-bwd {label} {name}: relative L2 {err:.3e} > "
                                     f"{BF16_GRAD_REL_L2}")
        worst = max(worst, *errs)
        del want
        return (q, k, v, out, do, lse, kw), errs

    n = 0
    for d in (64, 120, 128):
        for bhq, bhkv, sq, skv, causal, window, off in ATTN_SWEEP:
            check(f"sweep {bhq}/{bhkv} {sq}x{skv} D {d}", bhq, bhkv, sq, skv, d, causal, window,
                  off)
            n += 1
    log(f"  K5-bwd at tests/test_kernels.py's sweep x D {{64, 120, 128}} ({n} cases): within "
        f"{BF16_GRAD_REL_L2} relative L2 of fp32 autograd, bit-identical over two launches")
    rows_out = []
    for label, bhq, bhkv, s, d, window in K5_BWD_SHAPES:
        (q, k, v, out, do, lse, kw), errs = check(label, bhq, bhkv, s, s, d, True, window, 0)
        # SDPA's backward through autograd on the same bf16 inputs (the GQA
        # group spelled out; the window as a boolean mask)
        group = bhq // bhkv
        ql = q.view(1, bhq, s, d).clone().requires_grad_()
        kl = k.repeat_interleave(group, 0).view(1, bhq, s, d).clone().requires_grad_()
        vl = v.repeat_interleave(group, 0).view(1, bhq, s, d).clone().requires_grad_()
        if window is not None and window < s:
            pos = torch.arange(s, device="cuda")
            mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < window)
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask)
        else:
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        dol = do.view(1, bhq, s, d)
        t = bwd_timing(
            torch, lambda: kf.flash_attention_bwd(q, k, v, out, do, lse, **kw),
            lambda: ref.attention_grad(q, k, v, do, **kw),
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dol, retain_graph=True))
        t_ops, t_bytes = _attn_bound(torch, q, k, 0, True, window)
        t_ops *= 2.5          # five products over the visible pairs, the forward's two
        t_bytes *= 2.0        # q, k, v, out, dout read; dq, dk, dv written
        row = dict(shape=f"{label}: q ({bhq}, {s}, {d}), kv ({bhkv}, {s}, {d}), causal"
                         + (f", window {window}" if window else ""),
                   rel_l2=dict(zip(("dq", "dk", "dv"), errs)),
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", **t)
        log(f"  K5-bwd {row['shape']}: {t['ms']:.4f} ms a call, graph {t['graph_ms']:.4f}"
            f"{replaced(label)}; bound {row['bound_ms']:.4f} ({row['bound_by']}); plain "
            f"{t['plain_ms']:.4f}; SDPA backward {fmt_ms(t['library_ms'])}; relative L2 dq/dk/dv "
            + "/".join(f"{e:.2e}" for e in errs) + f" ({smi})")
        rows_out.append(row)
        del q, k, v, out, do, lse, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    main = rows_out[0]
    return dict(name="flash_attention_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:117 (its gradient: :14 names a "
                         "custom_vjp backward the reference does not have; it trains on XLA's "
                         "gradient of kernels/ref.py)",
                max_abs_err=worst_abs, max_rel_l2=worst, **main, other_shapes=rows_out[1:])


def _named_leaves(tree, prefix=""):
    """(name, leaf) of a parameter tree, depth first in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree) for x in _named_leaves(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def gradient_gate(torch, cfg, *, phase: str = "16", hold=True, bitwise: tuple = (),
                  layerwise: int = 0, perturb: float | None = None) -> dict:
    """(b): the model, seeded, one batch of 1 x GATE_TOKENS tokens: on the
    kernels (the config's dtype and remat) against ``models/plain.py``'s
    fp32 forward and autograd on the same parameters (an fp32 copy; the
    model's parameters are freed before it runs).  The plain forward takes
    the model's expert choices (``routing``: a choice that differs from its
    own fp32 top-k only by a near-tie within ``plain.ROUTER_MARGIN``), so
    both sides keep and drop the same token-expert assignments: bf16 flips
    about 1% of top-2 choices, and one flipped token would dominate a
    gradient comparison.

    ``hold``: True fails beyond the loss and the global gradient limits;
    ``"loss"`` holds the loss only and measures the gradient; False holds
    nothing.  ``bitwise`` names runs whose loss and gradients must equal the
    first run's bit for bit: ``"again"`` (the same run once more) and
    ``"block_save_moe"`` (that remat).  ``layerwise``: the first that many
    layers alone, each on its input from the model's forward with a seeded
    output gradient, their gradients (input and parameters) against
    ``plain.layer``'s, held at the global gradient's limit unless ``hold`` is
    False.  ``perturb``: the plain model's own gradient again with every
    parameter scaled by 1 + ``perturb`` N(0, 1), the distance printed: what
    a rounding-sized change of the weights does to the gradient."""
    from repro_torch.data import DataConfig, LMDataPipeline
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import plain
    from repro_torch.optim.adamw import tree_unflatten
    from repro_torch.train import train_loop as T

    params = seeded_params(torch, cfg)
    named = _named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    raw = LMDataPipeline(DataConfig(seq_len=GATE_TOKENS, global_batch=1, vocab=cfg.vocab,
                                    seed=SEED)).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    routes, inputs, real_route, real_block = [], [], L.moe_route, M._apply_block

    def recorded(x, router, k):
        gates, experts = real_route(x, router, k)
        routes.append(experts)
        return gates, experts

    forward_only = [False]

    def kept_input(x, *args, **kw):
        if forward_only[0] and len(inputs) < layerwise:
            inputs.append(x.detach().clone())
        return real_block(x, *args, **kw)

    def run(c, record: bool = False):
        """(loss, gradients); the forward's expert choices and layer inputs
        recorded, not the remat's recompute."""
        L.moe_route = recorded if record else real_route
        M._apply_block = kept_input if record else real_block
        forward_only[0] = record
        try:
            loss = T.loss_fn(c, params, batch)
        finally:
            L.moe_route, M._apply_block = real_route, real_block
            forward_only[0] = False
        return float(loss.detach()), torch.autograd.grad(loss, [t for _, t in named])

    def rel(pairs) -> float:
        num = den = 0.0
        for got, want in pairs:
            num += float((got.float() - want).norm()) ** 2
            den += float(want.norm()) ** 2
        return math.sqrt(num / max(den, 1e-60))

    t0 = time.perf_counter()
    loss, grads = run(cfg, record=True)
    torch.cuda.synchronize()
    t_kernels = time.perf_counter() - t0
    same = {}
    for what in bitwise:
        again, grads2 = run(cfg if what == "again" else replace(cfg, remat=what))
        same[what] = again == loss and all(torch.equal(a, b) for a, b in zip(grads, grads2))
        del grads2
    layer_errs = []
    positions = torch.arange(GATE_TOKENS, dtype=torch.int32, device="cuda")[None]
    g = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for l, x in enumerate(inputs):
        blk = params["layers"][l]
        leaves = [t for _, t in _named_leaves(blk)]
        x = x.requires_grad_()
        out, _ = real_block(x, blk, cfg, l, positions)
        dy = torch.randn(out.shape, generator=g, device="cuda").to(out.dtype)
        got = torch.autograd.grad(out, [x] + leaves, dy)
        x32 = x.detach()[0].float().requires_grad_()
        b32 = [t.detach().float().requires_grad_() for t in leaves]
        want = torch.autograd.grad(plain.layer(cfg, tree_unflatten(blk, b32), l, x32),
                                   [x32] + b32, dy[0].float())
        layer_errs.append(rel(zip([got[0][0]] + list(got[1:]), want)))
        del out, got, want, x32, b32
    inputs.clear()
    p32 = [t.detach().float().requires_grad_() for _, t in named]
    tree32 = tree_unflatten(params, p32)  # the order _named_leaves walks
    names = [n for n, _ in named]
    del params, named
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stats: dict = {}

    def plain_grads(leaves):
        logits = plain.forward(cfg, tree_unflatten(tree32, leaves), batch["tokens"][0],
                               routing=routes or None, stats=stats)
        loss32 = T.cross_entropy(logits[None], batch["labels"])
        del logits
        return float(loss32.detach()), torch.autograd.grad(loss32, leaves)

    loss32, grads32 = plain_grads(p32)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    sensitivity = None
    if perturb:
        gp = torch.Generator(device="cuda").manual_seed(SEED + 8)
        moved = [(t.detach() * (1 + perturb * torch.randn(t.shape, generator=gp, device="cuda"))
                  ).requires_grad_() for t in p32]
        sensitivity = rel(zip(plain_grads(moved)[1], grads32))
        del moved
    loss_err = abs(loss - loss32) / abs(loss32)
    per = [(rel([(gk, g32)]), name) for name, gk, g32 in zip(names, grads, grads32)]
    glob = rel(zip(grads, grads32))
    worst = sorted(per, reverse=True)[:5]
    ties = (f"; routing: {len(routes)} MoE layers, {stats.get('near_ties', 0)} near-tie choices "
            f"taken (largest gap {stats.get('max_tie_gap', 0.0):.4f})" if routes else "")
    held = {True: "held", "loss": "the loss held, the gradient measured", False: "measured"}[hold]
    log(f"  (b) gradient gate ({held}), {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}), 1 x "
        f"{GATE_TOKENS} tokens: loss {loss:.6f} (kernels, remat {cfg.remat!r}) vs {loss32:.6f} "
        f"(fp32 plain), relative {loss_err:.3e} (limit {TRAIN_LOSS_REL}); global gradient "
        f"relative L2 {glob:.3e} (limit {TRAIN_GRAD_REL_L2}); worst tensors "
        + ", ".join(f"{n} {e:.3e}" for e, n in worst)
        + f"{ties}; bit-identical: {same or 'not asked'}; {t_kernels:.2f} s (kernels) and "
        f"{t_plain:.2f} s (plain); peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if layer_errs:
        log(f"  (b) {cfg.name}, each of the first {len(layer_errs)} layers alone on its input, a "
            "seeded output gradient: input and parameter gradients against plain.layer's, "
            "relative L2 " + " ".join(f"{e:.2e}" for e in layer_errs)
            + f"; max {max(layer_errs):.3e} (limit {TRAIN_GRAD_REL_L2})")
    if sensitivity is not None:
        log(f"  (b) {cfg.name}: the plain model's own gradient with every weight scaled by 1 + "
            f"{perturb:g} N(0, 1) moves by {sensitivity:.3e} relative L2 (the kernels' distance "
            f"{glob:.3e})")
    out = dict(loss=loss, loss_plain=loss32, loss_rel=loss_err, grad_rel_l2=glob,
               worst_tensors=[(n, e) for e, n in worst], bit_identical=same, held=held,
               near_ties=stats.get("near_ties", 0), layer_grad_rel_l2=layer_errs,
               perturbed_plain_rel_l2=sensitivity)
    del grads, p32, tree32, grads32, routes
    gc.collect()
    torch.cuda.empty_cache()
    if hold and (loss_err > TRAIN_LOSS_REL
                 or (hold is True and not glob <= TRAIN_GRAD_REL_L2)
                 or not all(e <= TRAIN_GRAD_REL_L2 for e in layer_errs)):
        raise AssertionError(f"phase {phase} (b) {cfg.name}: loss {loss_err:.3e}, gradient "
                             f"{glob:.3e} or layers {layer_errs} beyond {TRAIN_LOSS_REL} / "
                             f"{TRAIN_GRAD_REL_L2}")
    if not all(same.values()):
        raise AssertionError(f"phase {phase} (b) {cfg.name}: gradients not bit-identical: {same}")
    return out


def train_counts() -> dict:
    """The model stack's launch and plain-version counters."""
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import rmsnorm as kr

    return {"K4": kr.LAUNCHES["rmsnorm"], "K4-bwd": kr.LAUNCHES["rmsnorm_bwd"],
            "K5": kf.LAUNCHES["flash_attention"], "K5-bwd": kf.LAUNCHES["flash_attention_bwd"],
            "K6": km.LAUNCHES["grouped_matmul"], "K6-bwd": km.LAUNCHES["grouped_matmul_bwd"],
            "K5 kernels": dict(kf.PATHS), "K5-bwd kernels": dict(kf.BWD_PATHS),
            "K4-bwd kernels": dict(kr.BWD_PATHS),
            "plain": {"K4": kr.PLAIN["rmsnorm"], "K4-bwd": kr.PLAIN["rmsnorm_bwd"],
                      "K5": kf.PLAIN["flash_attention"], "K5-bwd": kf.PLAIN["flash_attention_bwd"],
                      "K6": km.PLAIN["grouped_matmul"], "K6-bwd": km.PLAIN["grouped_matmul_bwd"]}}


def reset_train_counts() -> None:
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import rmsnorm as kr

    for d in (kr.LAUNCHES, kr.PLAIN, kr.BWD_PATHS, kf.LAUNCHES, kf.PLAIN, kf.PATHS,
              kf.BWD_PATHS, km.LAUNCHES, km.PLAIN, km.PATHS):
        for k in d:
            d[k] = 0


def train_launches(cfg) -> dict:
    """A microbatch's launches, as the model implies them: each block's
    norms (two, one without an FFN) and the final norm on K4, each attention
    layer on K5, each MoE layer's three expert products on K6, every one
    again in block remat's recompute, and each once backward."""
    n = cfg.n_layers
    attn = sum(cfg.layer_kind(l) == "attn" for l in range(n))
    moe = sum(cfg.layer_is_moe(l) for l in range(n))
    norms = n * (2 if cfg.d_ff else 1)
    again = 2 if cfg.remat != "none" else 1
    return {"K4": norms * again + 1, "K4-bwd": norms + 1, "K5": attn * again, "K5-bwd": attn,
            "K6": 3 * moe * again, "K6-bwd": 3 * moe}


def model_flops(cfg, params, tokens: int, seq: int) -> dict:
    """A step's model operations: 6 N T (N every parameter a token meets: an
    MoE layer's experts at top_k of n_experts, the tied head included),
    attention's two products over the causal pairs forward and 2.5x that
    backward, and block remat's recompute (the blocks' forward again) apart.
    The Mamba and xLSTM scans' elementwise work is not counted."""
    named = _named_leaves(params)

    def active(name, t):
        expert = cfg.n_experts and ".ffn.w" in name and t.dim() == 3
        return t.numel() * (cfg.top_k / cfg.n_experts if expert else 1)

    n = sum(active(nm, t) for nm, t in named)
    block = sum(active(nm, t) for nm, t in named if nm.startswith("layers."))
    attn = sum(cfg.layer_kind(l) == "attn" for l in range(cfg.n_layers))
    pairs = seq * (seq + 1) / 2 * cfg.n_heads * (tokens // seq)
    attn_fwd = 4.0 * pairs * cfg.head_dim * attn
    return dict(params=sum(t.numel() for _, t in named), active_params=n,
                model=6.0 * n * tokens + 3.5 * attn_fwd,
                recompute=2.0 * block * tokens + attn_fwd)


def trainer_path(torch, smi: str, cfg, tmp: Path, lr: float = TRAIN_LR,
                 measure: bool = True, *, phase: str = "16", steps: int = TRAIN_STEPS,
                 seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH, accum: int = TRAIN_ACCUM,
                 repeat: bool = False) -> dict:
    """(c): ``Trainer`` on ``cfg``, ``steps`` steps of ``batch`` x ``seq``
    tokens in ``accum`` microbatches, WSD from ``lr`` with one warm-up step;
    every step's launches checked against the counts the model implies
    (``train_launches``), no plain version run, losses finite and no step
    skipped, its host ms and the peak memory; with ``repeat``, first the
    gradients of the first microbatch twice, bit-identical; with
    ``measure``, one step profiled for device ms and the idle share, and
    ``explain_kernels()``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train import train_loop as T

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, AdamWConfig(schedule="wsd", lr=lr, total_steps=steps, warmup_steps=1),
                 DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab, seed=SEED),
                 TrainerConfig(ckpt_dir=str(tmp / "c"), accum_steps=accum, ckpt_every=100),
                 seed=SEED)
    torch.cuda.synchronize()
    log(f"  (c) Trainer on {cfg.name} ({cfg.n_layers} layers, {cfg.dtype}) built in "
        f"{time.perf_counter() - t0:.1f} s: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "(parameters, fp32 moments)")
    if repeat:
        micro = {k: torch.from_numpy(v[:batch // accum]).cuda()
                 for k, v in tr.data.batch_at(0).items()}
        runs = []
        for _ in range(2):
            loss = T.loss_fn(cfg, tr.params, micro)
            runs.append((loss.detach(), torch.autograd.grad(loss, tree_leaves(tr.params))))
        same = torch.equal(runs[0][0], runs[1][0]) and all(
            torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
        del runs, loss
        torch.cuda.empty_cache()
        log(f"  (c) two runs of step 1's first microbatch ({batch // accum} x {seq} tokens): "
            f"loss and every gradient {'bit-identical' if same else 'DIFFER'}")
        if not same:
            raise AssertionError(f"phase {phase} (c) {cfg.name}: two runs of one microbatch gave "
                                 "other gradients")
    want = {k: n * accum for k, n in train_launches(cfg).items()}
    reset_train_counts()
    records, total = [], {k: 0 for k in want}
    profiled = 3 if measure else -1
    for s in range(steps):
        before = train_counts()
        if s == profiled:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t_p = time.perf_counter()
                tr.run(1)
                torch.cuda.synchronize()
                t_p = time.perf_counter() - t_p
        else:
            tr.run(1)
        torch.cuda.synchronize()
        after = train_counts()
        moved = {k: after[k] - before[k] for k in want}
        if moved != want:
            raise AssertionError(f"phase {phase} (c) {cfg.name} step {s + 1}: launches {moved}, "
                                 f"the model implies {want}")
        for k in want:
            total[k] += moved[k]
        rec = dict(tr.history[-1])
        records.append(rec)
        log(f"  (c) step {rec['step']}: loss {rec['loss']:.4f}, lr {rec['lr']:.3e}, "
            f"{rec['dt'] * 1e3:.1f} host ms, launches {moved}")
    counts = train_counts()
    if any(counts["plain"].values()):
        raise AssertionError(f"phase {phase} (c): a plain version ran on the card: "
                             f"{counts['plain']}")
    if set(k for k, n in counts["K5 kernels"].items() if n) - {"mma"}:
        raise AssertionError(f"phase {phase} (c): K5 launched {counts['K5 kernels']}, want mma "
                             "only")
    log(f"  (c) K4-bwd calls by route: {counts['K4-bwd kernels']}")
    if phase == "16" and set(k for k, n in counts["K4-bwd kernels"].items() if n) != {"vec"}:
        raise AssertionError(f"phase 16 (c): K4-bwd took {counts['K4-bwd kernels']}, want the "
                             "vector kernel only (MiniCPM's rows are 2304 aligned values)")
    losses = [r["loss"] for r in records]
    if not all(math.isfinite(x) for x in losses) or any(r["skipped"] for r in records):
        raise AssertionError(f"phase {phase} (c) {cfg.name}: losses {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    host_ms = [r["dt"] * 1e3 for r in records]
    if not measure:
        log(f"  (c) {cfg.name} at lr {lr:g}: losses {' '.join(f'{x:.4f}' for x in losses)}; host "
            f"ms a step {' '.join(f'{x:.0f}' for x in host_ms)}; peak memory {peak:.2f} GB")
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return dict(lr=lr, losses=losses, launches=total, host_ms=host_ms, peak_memory_gb=peak,
                    tokens_per_step=seq * batch)
    per_group, group_launches, n_ops = device_groups(torch, prof, 1)
    device_ms = sum(per_group.values())
    tokens = seq * batch
    med_ms = sorted(host_ms[1:])[len(host_ms[1:]) // 2]
    fl = model_flops(cfg, tr.params, tokens, seq)
    out = dict(
        lr=lr, losses=losses, host_ms=host_ms, median_host_ms=med_ms,
        profiled_step=profiled + 1, profiled_host_ms=t_p * 1e3, device_ms=device_ms,
        device_ms_by_group=per_group, launches_by_group=group_launches, device_ops=n_ops,
        idle_share=1 - device_ms / (t_p * 1e3), tokens_per_s=tokens / (med_ms / 1e3),
        peak_memory_gb=peak, params=fl["params"], active_params=fl["active_params"],
        model_flops=fl["model"], recompute_flops=fl["recompute"],
        model_flops_share=fl["model"] / (med_ms / 1e3) / PEAK_BF16,
        with_recompute_share=(fl["model"] + fl["recompute"]) / (med_ms / 1e3) / PEAK_BF16,
        launches=total, launches_per_step=want, k4_bwd_routes=counts["K4-bwd kernels"],
        card=smi)
    log(f"  (c) {cfg.name}: {steps} steps, losses {' '.join(f'{x:.4f}' for x in losses)}; median "
        f"host {med_ms:.1f} ms a step (steps 2-{steps}), {out['tokens_per_s']:.0f} tokens/s; "
        f"step {profiled + 1} profiled: {t_p * 1e3:.1f} host ms, {device_ms:.1f} device ms "
        f"(idle {out['idle_share']:.1%}), by group "
        + ", ".join(f"{k} {v:.1f} ms ({group_launches[k]:.0f})" for k, v in per_group.items())
        + f"; peak memory {peak:.2f} GB; {fl['params'] / 1e9:.3f} B parameters "
        f"({fl['active_params'] / 1e9:.3f} B a token), model FLOP/s "
        f"{out['model_flops_share']:.1%} of 989 TFLOP/s (6NT + attention; "
        f"{out['with_recompute_share']:.1%} with remat's recompute) ({smi})")
    log("  (c) Trainer.explain_kernels():")
    for line in tr.explain_kernels().splitlines():
        log(f"    {line}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def resilience_path(torch, cfg, tmp: Path, *, phase: str = "16",
                    layers: int | None = RESILIENT_LAYERS, steps: int = 5, fail_at: int = 3,
                    every: int = 2, seq: int = TRAIN_SEQ, batch: int = 4) -> dict:
    """(d): ``layers`` of the model's layers (None: all) at full width: a run
    with checkpoints every ``every`` steps that fails at step ``fail_at`` and
    restores, against an uninterrupted run of ``steps`` steps: losses and
    final parameters and moments bit-identical.  A ``hybrid`` or ``ssm``
    model's checkpoint must hold the reference's ``periods`` layout.  Should
    the run differ in torch's default mode, it is repeated under
    ``torch.use_deterministic_algorithms`` (this check only), with the ops
    torch flags printed, and must be bit-identical there."""
    import warnings

    import numpy as np

    from repro_torch.data import DataConfig
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig

    c4 = replace(cfg, n_layers=layers) if layers else cfg
    ocfg = AdamWConfig(schedule="wsd", lr=3e-4, total_steps=steps, warmup_steps=1)
    dcfg = DataConfig(seq_len=seq, global_batch=batch, vocab=cfg.vocab, seed=SEED + int(phase))
    restored_at = fail_at // every * every

    def attempt(tag: str) -> dict:
        timed = {}

        def timing(name, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timed[name] = time.perf_counter() - t0
                return out
            return call

        plain_run = Trainer(c4, ocfg, dcfg, TrainerConfig(ckpt_dir=str(tmp / f"{tag}0"),
                                                          ckpt_every=100), seed=SEED)
        plain_run.run(steps)
        tr = Trainer(c4, ocfg, dcfg, TrainerConfig(ckpt_dir=str(tmp / f"{tag}1"),
                                                   ckpt_every=every), seed=SEED)
        tr.save, tr.try_restore = timing("save", tr.save), timing("restore", tr.try_restore)
        tr.run_resilient(steps, fail_at=fail_at)
        torch.cuda.synchronize()
        want = [r["loss"] for r in plain_run.history]
        got = [r["loss"] for r in tr.history]
        same = (got[:fail_at] == want[:fail_at] and got[fail_at:] == want[restored_at:]
                and all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params),
                                                          tree_leaves(plain_run.params)))
                and all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.opt_state),
                                                          tree_leaves(plain_run.opt_state))))
        saved = tr.ckpt._step_dir(restored_at)
        size = sum(f.stat().st_size for f in saved.iterdir())
        with np.load(saved / "proc_0.npz") as z:
            keys = list(z.files)
        periods = sum("['params']/['periods']/[" in k for k in keys)
        if M.layer_period(c4) and (not periods or any("['layers']" in k for k in keys)):
            raise AssertionError(f"phase {phase} (d): the checkpoint of {c4.name} does not hold "
                                 f"the periods layout: {keys[:6]}")
        log(f"  (d) {tag}: {c4.n_layers} of {cfg.n_layers} layers of {cfg.name} ({cfg.dtype}), "
            f"full width: run_resilient({steps}, fail_at={fail_at}) with checkpoints every "
            f"{every} steps, losses {' '.join(f'{x:.6f}' for x in got)} (restored at step "
            f"{restored_at}, steps {restored_at + 1}-{steps} again); "
            f"uninterrupted {' '.join(f'{x:.6f}' for x in want)}; losses, parameters and "
            f"moments {'bit-identical' if same else 'DIFFER'}; checkpoint {size / 1e9:.2f} GB, "
            f"save {timed.get('save', float('nan')):.2f} s, restore "
            f"{timed.get('restore', float('nan')):.2f} s; {len(keys)} arrays, {periods} of them "
            "under ['params']/['periods']")
        out = dict(losses=got, uninterrupted=want, bit_identical=same,
                   checkpoint_gb=size / 1e9, save_s=timed.get("save"),
                   restore_s=timed.get("restore"), period_arrays=periods)
        del tr, plain_run
        gc.collect()
        torch.cuda.empty_cache()
        return out

    out = attempt("default")
    if not out["bit_identical"]:  # find the op that is not deterministic
        was = torch.are_deterministic_algorithms_enabled()
        try:
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = dict(attempt("deterministic"), default_mode=out)
        finally:
            torch.use_deterministic_algorithms(was)
        out["flagged"] = sorted({str(w.message).split(".")[0][:160] for w in caught
                                 if "determinis" in str(w.message)})
        log(f"  (d) ops torch flags as without a deterministic implementation: "
            f"{out['flagged'] or 'none'}")
    if not out["bit_identical"]:
        raise AssertionError(f"phase {phase} (d): the resumed run differs: {out['losses']} vs "
                             f"{out['uninterrupted']}")
    return out


def training_phase(torch, smi: str) -> dict:
    """Phase 16 (a)-(d); returns the backward kernels' rows and the training
    numbers.  Temporary checkpoints go under the system's temporary
    directory and are removed."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(MINICPM)
    log("  (a) the backward kernels against their plain versions")
    rows = {"rmsnorm_bwd": check_rmsnorm_bwd(torch, smi),
            "flash_attention_bwd": check_flash_bwd(torch, smi)}
    gate = gradient_gate(torch, cfg)
    tmp = Path(tempfile.mkdtemp(prefix="repro_train_"))
    try:
        train = trainer_path(torch, smi, cfg, tmp)
        learn = trainer_path(torch, smi, cfg, tmp, lr=LEARN_LR, measure=False)
        resilient = resilience_path(torch, cfg, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not learn["losses"][-1] < learn["losses"][0]:
        raise AssertionError(f"phase 16 (c): at lr {LEARN_LR:g} the loss did not fall: "
                             f"{learn['losses']}")
    log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")
    return dict(rows=rows, gate=gate, train=train, learn=learn, resilient=resilient)


# ---------------------------------------------------------------------------
# Phase 17: MoE and recurrent training.  K6-bwd (``grouped_matmul_bwd``: the
# dx and dw kernels in csrc/moe_gmm.cu) joins K4-bwd and K5-bwd.  Mixtral
# 8x7B (arXiv:2401.04088) trains a 2-layer stage at every width with all 8
# experts, top-2 (3.16 B parameters: at the trainer's 16 bytes a parameter,
# bf16 weights and gradients, the fp32 gradient sum and fp32 AdamW moments,
# 51 GB; 3 layers' 4.62 B would be 74 GB before activations).  Jamba-1.5-
# Large's first 2 layers (attention with a dense FFN; Mamba with MoE) at
# every width, its MoE layer cut from 16 experts to 2 (top-2 kept; 3.46 B
# parameters: one layer's 16 experts are 9.66 B, 155 GB of training state).
# xLSTM-350M whole (24 layers), in fp32 as phase 14 holds it.
# ---------------------------------------------------------------------------
MOE_TRAIN_LAYERS = 2
JAMBA_TRAIN_LAYERS, JAMBA_TRAIN_EXPERTS = 2, 2
# K6-bwd's shapes (label, E, C, D, F): Mixtral's gate/up and down at the
# capacities of a 16-slot step (16), a 128-token bucket (40), the 1 x 1024
# gate (320) and an 8,192-token microbatch (2560); Jamba's widths at the
# cut's 2,048-token step (E 2, C 2560) and at 16 experts (C 320); a ragged case
K6_BWD_SHAPES = ([(f"Mixtral gate/up C {c}", 8, c, 4096, 14336) for c in (16, 40, 320, 2560)]
                 + [(f"Mixtral down C {c}", 8, c, 14336, 4096) for c in (16, 40, 320, 2560)]
                 + [("Jamba gate/up E 2 C 2560", 2, 2560, 8192, 24576),
                    ("Jamba gate/up E 16 C 320", 16, 320, 8192, 24576),
                    ("ragged", 3, 37, 40, 72)])
K6_BWD_MAIN = "Mixtral gate/up C 2560"  # the row the kernels line reports first
# K5-bwd at Seamless's non-causal D = 64: (label, BHq, BHkv, Sq, Skv, D)
SEAMLESS_K5_BWD = [("Seamless encoder", 16, 16, 4096, 4096, 64),
                   ("Seamless cross-attention", 16, 16, 2048, 4096, 64)]
# (b) xLSTM-350M amplifies fp32 rounding through its 24 layers and 1,024
# positions: on an H100 its fp32 gradient lay 0.35-0.56 relative L2 from
# the plain model's while the loss agreed to 2e-6, and scaling every weight
# of the plain model by 1 + 1e-6 N(0, 1) moved its own gradient 0.56
# (PERF.md).  So the whole model's gradient is measured beside that
# perturbation, and held one layer at a time over the first period (7
# mLSTM layers, 1 sLSTM), where the two agree to about 2e-6
XLSTM_LAYERWISE, XLSTM_PERTURB = 8, 1e-6
# (c)'s other models: a few steps each, one microbatch (the Jamba cut's
# Mamba chunk graph is 6.4 GB at 2,048 tokens beside 41 GB of training
# state); xLSTM's sLSTM loop launches 13 kernels a token and layer forward,
# so its steps (and (d)'s) are 256 tokens long
FAMILY_STEPS = 3
JAMBA_TRAIN_SEQ, XLSTM_TRAIN_SEQ, XLSTM_TRAIN_BATCH = 2048, 256, 4


def check_gmm_bwd(torch, smi: str) -> dict:
    """(a) K6-bwd against its plain version: at K6_BWD_SHAPES, dx and dw
    within BF16_GRAD_REL_L2 relative L2 per tensor of fp32 autograd of
    ``ref.grouped_matmul`` on the same bf16 inputs (one expert at a time),
    bit-identical over two launches; each timed (a call, a CUDA graph)
    beside its bound (both products' operations at 989 TFLOP/s, or x, w and
    dy read and dx and dw written once at 3.35 TB/s), the plain version
    (``ref.grouped_matmul_grad``) and ``torch.bmm`` on the transposed
    views."""
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(26)
    rows, worst, worst_abs = [], 0.0, 0.0
    for label, e, c, d, f in K6_BWD_SHAPES:
        x = torch.randn(e, c, d, generator=g, device="cuda").bfloat16()
        w = (torch.randn(e, d, f, generator=g, device="cuda") / d ** 0.5).bfloat16()
        dy = torch.randn(e, c, f, generator=g, device="cuda").bfloat16()
        dx, dw = km.grouped_matmul_bwd(x, w, dy)
        dx2, dw2 = km.grouped_matmul_bwd(x, w, dy)
        torch.cuda.synchronize()
        if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
            raise AssertionError(f"K6-bwd {label}: two launches differ")
        del dx2, dw2
        num, den = [0.0, 0.0], [0.0, 0.0]
        for i in range(e):
            xr = x[i:i + 1].float().requires_grad_()
            wr = w[i:i + 1].float().requires_grad_()
            want = torch.autograd.grad(ref.grouped_matmul(xr, wr), (xr, wr), dy[i:i + 1].float())
            for j, (got, wnt) in enumerate(zip((dx[i:i + 1], dw[i:i + 1]), want)):
                diff = got.float() - wnt
                num[j] += float(diff.norm()) ** 2
                den[j] += float(wnt.norm()) ** 2
                worst_abs = max(worst_abs, float(diff.abs().max()))
            del xr, wr, want
        errs = [math.sqrt(a / max(b, 1e-60)) for a, b in zip(num, den)]
        worst = max(worst, *errs)
        if max(errs) > BF16_GRAD_REL_L2:
            raise AssertionError(f"K6-bwd {label}: relative L2 dx {errs[0]:.3e}, dw {errs[1]:.3e} "
                                 f"> {BF16_GRAD_REL_L2}")
        del dx, dw
        torch.cuda.empty_cache()
        t = bwd_timing(torch, lambda: km.grouped_matmul_bwd(x, w, dy),
                       lambda: ref.grouped_matmul_grad(x, w, dy),
                       lambda: (torch.bmm(dy, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), dy)))
        flops = 4.0 * e * c * d * f
        t_ops = flops / PEAK_BF16 * 1e3
        t_bytes = 2.0 * (2 * e * c * d + 2 * e * d * f + e * c * f) / PEAK_BYTES * 1e3
        row = dict(shape=f"{label}: x ({e}, {c}, {d}), w ({e}, {d}, {f}), dy ({e}, {c}, {f}) bf16",
                   rel_l2=dict(dx=errs[0], dw=errs[1]), bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   graph_tflops=flops / t["graph_ms"] / 1e9, **t)
        log(f"  K6-bwd {row['shape']}: {t['ms']:.4f} ms a call, graph {t['graph_ms']:.4f} "
            f"({row['graph_tflops']:.0f} TFLOP/s){replaced(label)}; bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}); plain {t['plain_ms']:.4f}; torch.bmm x2 {fmt_ms(t['library_ms'])}; relative L2 "
            f"dx/dw {errs[0]:.2e}/{errs[1]:.2e} ({smi})")
        rows.append(row)
        del x, w, dy
        torch.cuda.empty_cache()
    log(f"  K6-bwd at {len(rows)} shapes: within {BF16_GRAD_REL_L2} relative L2 of fp32 autograd "
        f"(worst {worst:.3e}), bit-identical over two launches")
    main = next(r for r in rows if r["shape"].startswith(K6_BWD_MAIN + ":"))
    return dict(name="grouped_matmul_bwd", route="cuda", source="src/repro_torch/csrc/moe_gmm.cu",
                replaces="src/repro/kernels/moe_gmm.py:61 (its gradient: the TPU kernel has none, "
                         "the reference trains on XLA's gradient of kernels/ref.py)",
                max_abs_err=worst_abs, max_rel_l2=worst, **main,
                other_shapes=[r for r in rows if r is not main])


def check_flash_bwd_seamless(torch, smi: str) -> list:
    """(a) K5-bwd at SeamlessM4T's non-causal D = 64 shapes against its plain
    version (fp32 autograd of ``ref.attention``'s chunked form), bit-identical
    over two launches, timed beside its bound, the plain version and SDPA's
    backward."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(27)
    rows = []
    for label, bhq, bhkv, sq, skv, d in SEAMLESS_K5_BWD:
        q = torch.randn(bhq, sq, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(bhkv, skv, d, generator=g, device="cuda").bfloat16() for _ in range(2))
        do = torch.randn(bhq, sq, d, generator=g, device="cuda").bfloat16()
        kw = dict(causal=False, window=None, q_offset=0)
        out, lse = kf.flash_attention_fwd(q, k, v, **kw)
        got = kf.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        again = kf.flash_attention_bwd(q, k, v, out, do, lse, **kw)
        torch.cuda.synchronize()
        want = ref.attention_grad(q.float(), k.float(), v.float(), do.float(), **kw)
        errs = []
        for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(a, b):
                raise AssertionError(f"K5-bwd {label}: {name} differs over two launches")
            errs.append(float((a.float() - w).norm() / w.norm().clamp_min(1e-30)))
            if errs[-1] > BF16_GRAD_REL_L2:
                raise AssertionError(f"K5-bwd {label} {name}: relative L2 {errs[-1]:.3e} > "
                                     f"{BF16_GRAD_REL_L2}")
        del got, again, want
        ql = q.view(1, bhq, sq, d).clone().requires_grad_()
        kl = k.view(1, bhkv, skv, d).clone().requires_grad_()
        vl = v.view(1, bhkv, skv, d).clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(ql, kl, vl)
        dol = do.view(1, bhq, sq, d)
        t = bwd_timing(
            torch, lambda: kf.flash_attention_bwd(q, k, v, out, do, lse, **kw),
            lambda: ref.attention_grad(q, k, v, do, **kw),
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dol, retain_graph=True))
        t_ops, t_bytes = _attn_bound(torch, q, k, 0, False, None)
        t_ops *= 2.5
        t_bytes *= 2.0
        row = dict(shape=f"{label}: q ({bhq}, {sq}, {d}), kv ({bhkv}, {skv}, {d}), non-causal",
                   rel_l2=dict(zip(("dq", "dk", "dv"), errs)), bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", **t)
        log(f"  K5-bwd {row['shape']}: {t['ms']:.4f} ms a call, graph {t['graph_ms']:.4f}"
            f"{replaced(label)}; bound {row['bound_ms']:.4f} ({row['bound_by']}); plain "
            f"{t['plain_ms']:.4f}; SDPA backward {fmt_ms(t['library_ms'])}; relative L2 dq/dk/dv "
            + "/".join(f"{e:.2e}" for e in errs) + f" ({smi})")
        rows.append(row)
        del q, k, v, do, out, lse, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    return rows


def moe_training_phase(torch, smi: str) -> dict:
    """Phase 17 (a)-(d): K6-bwd's row and the training numbers.  Temporary
    checkpoints go under the system's temporary directory and are removed."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    log("  (a) K6-bwd against its plain version; K5-bwd at Seamless's non-causal D = 64")
    row = check_gmm_bwd(torch, smi)
    seamless = check_flash_bwd_seamless(torch, smi)
    mcfg = replace(get_config(MIXTRAL), n_layers=MOE_TRAIN_LAYERS)
    jcfg = replace(get_config(JAMBA), n_layers=JAMBA_TRAIN_LAYERS, n_experts=JAMBA_TRAIN_EXPERTS)
    xcfg = replace(get_config(XLSTM), dtype="float32")
    log("  (b) gradient gates: Mixtral's stage (block and block_save_moe, twice), the Jamba cut, "
        "xLSTM-350M in fp32 (the loss and each layer alone held) and bf16 (measured)")
    gates = {"mixtral": gradient_gate(torch, mcfg, phase="17", bitwise=("again", "block_save_moe")),
             "jamba": gradient_gate(torch, jcfg, phase="17"),
             "xlstm_fp32": gradient_gate(torch, xcfg, phase="17", hold="loss",
                                         layerwise=XLSTM_LAYERWISE, perturb=XLSTM_PERTURB),
             "xlstm_bf16": gradient_gate(torch, get_config(XLSTM), phase="17", hold=False)}
    tmp = Path(tempfile.mkdtemp(prefix="repro_train17_"))
    try:
        train = trainer_path(torch, smi, mcfg, tmp, lr=LEARN_LR, phase="17", repeat=True)
        families = {
            "jamba": trainer_path(torch, smi, jcfg, tmp, lr=LEARN_LR, measure=False, phase="17",
                                  steps=FAMILY_STEPS, seq=JAMBA_TRAIN_SEQ, batch=1, accum=1),
            "xlstm": trainer_path(torch, smi, xcfg, tmp, lr=LEARN_LR, measure=False, phase="17",
                                  steps=FAMILY_STEPS, seq=XLSTM_TRAIN_SEQ,
                                  batch=XLSTM_TRAIN_BATCH, accum=1)}
        resilient = resilience_path(torch, xcfg, tmp, phase="17", layers=None, steps=3,
                                    fail_at=2, every=2, seq=XLSTM_TRAIN_SEQ, batch=2)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not train["losses"][-1] < train["losses"][0]:
        raise AssertionError(f"phase 17 (c): at lr {LEARN_LR:g} the loss did not fall: "
                             f"{train['losses']}")
    log(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")
    return dict(row=row, seamless=seamless, gates=gates, train=train, families=families,
                resilient=resilient)


class PrefillPaths:
    """While installed, K5's launches per kernel inside ``M.decode_step``,
    which the engine calls once per prefill bucket (and ``prefill_breakdown``
    too), and inside ``M.encode``, the audio engine's encoder at prefill; a
    serving phase's other K5 launches are its decode steps'
    (``decode_slots``)."""

    def __init__(self, M, kf):
        self.M, self.kf = M, kf
        self.counts = {k: 0 for k in kf.PATHS}
        self.real = {}

    def _wrap(self, name):
        real = self.real[name]

        def call(*args, **kw):
            before = dict(self.kf.PATHS)
            try:
                return real(*args, **kw)
            finally:
                for k in self.counts:
                    self.counts[k] += self.kf.PATHS[k] - before[k]
        return call

    def __enter__(self):
        for name in ("decode_step", "encode"):
            self.real[name] = getattr(self.M, name)
            setattr(self.M, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, real in self.real.items():
            setattr(self.M, name, real)


class CrossPaths:
    """While installed, K5's launches per kernel inside the cross-attention
    sub-blocks (``L.attention`` given ``memory``), apart for decode steps
    (one query a slot) and prefill."""

    def __init__(self, L, kf):
        self.L, self.kf = L, kf
        self.counts = {"prefill": {k: 0 for k in kf.PATHS}, "decode": {k: 0 for k in kf.PATHS}}

    def attention(self, x, *args, memory=None, **kw):
        if memory is None:
            return self.real(x, *args, **kw)
        before = dict(self.kf.PATHS)
        try:
            return self.real(x, *args, memory=memory, **kw)
        finally:
            into = self.counts["decode" if x.shape[1] == 1 else "prefill"]
            for k in into:
                into[k] += self.kf.PATHS[k] - before[k]

    def __enter__(self):
        self.real, self.L.attention = self.L.attention, self.attention
        return self

    def __exit__(self, *exc):
        self.L.attention = self.real


class GmmPaths:
    """While installed, every K6 launch's C and the kernel it took (the
    ``PATHS`` entry that moved)."""

    def __init__(self, km):
        self.km = km
        self.launches: list[tuple[int, str]] = []  # (C, taken)

    def launch(self, kernel, x, w, **kw):
        before = dict(self.km.PATHS)
        try:
            return self.real(kernel, x, w, **kw)
        finally:
            taken = [k for k in before if self.km.PATHS[k] != before[k]]
            if taken:
                self.launches.append((x.shape[1], taken[0]))

    def __enter__(self):
        self.real, self.km._launch = self.km._launch, self.launch
        return self

    def __exit__(self, *exc):
        self.km._launch = self.real

    def by_c(self) -> dict:
        out: dict = {}
        for c, taken in self.launches:
            out.setdefault(c, {}).setdefault(taken, 0)
            out[c][taken] += 1
        return dict(sorted(out.items()))


# ---------------------------------------------------------------------------
# phase 19: sharded serving
# ---------------------------------------------------------------------------
SHARD_SERVE_RANKS, SHARD_SERVE_SHAPE = 4, (2, 2)  # (b): Danube over (data, model)
SHARD_SERVE_REQUESTS = 8                          # phase 7's first 8 prompts, 8 slots
SHARD_SERVE_WATCHED = (0, 3, 5, 7)                # slots of both data groups
SHARD_MOE_RANKS, SHARD_MOE_SHAPE = 2, (1, 2)      # (c): Mixtral, 4 experts a rank
SHARD_MOE_LAYERS = 4                              # of 32, every width, all 8 experts
SHARD_MOE_REQUESTS = 16
SHARD_MOE_WATCHED = (0, 5, 10, 15)
# The sharded engine leaves a row-parallel product's partials in fp32 (a
# bf16 GEMM's fp32 accumulator), sums them in fp32 and rounds once, as the
# unsharded GEMM rounds its own fp32 sum; but its other products run at
# other shapes (half the heads, half
# the FFN columns), where cuBLAS rounds otherwise, so past the first layers
# the two engines' bf16 roundings are independent.  Each engine is 1.5-1.8e-2
# from the fp32 model (phase 7), so they are up to sqrt(2) x 1.8e-2 = 2.6e-2
# apart (2.036-2.109e-2 read on an H100 80GB HBM3 at 700 W; PERF.md).
# Held: the logits within this relative L2 of the unsharded engine's at
# every position both engines reach from the same tokens ...
SHARD_VS_UNSHARDED_REL = 3e-2
# ... the sharded engine no further from the fp32 model than this multiple
# of the unsharded engine's distance, over the watched prompts' positions
# (the same inputs for both): sharding adds no error of its own ...
SHARD_PLAIN_RATIO = 1.15
# ... and its greedy tokens equal the unsharded engine's up to the first
# token the unsharded engine took by a top-2 gap under this share of the
# RMS of that position's logits (about 4 times the logit error that relative
# L2 allows): there the engines' roundings may pick the other token.
SHARD_TIE_MARGIN = 0.1


class EngineRecorder:
    """While installed on an engine (sharded or not): the whole-vocabulary
    logits of the watched requests, their prompt positions at prefill and
    each decode step; for MoE their routing (per MoE layer the experts and
    router logits); every request's dropped assignments over its prefill
    (padding included) and those this rank combined (``kept``), and its
    experts per MoE layer at prefill (the padded
    bucket) and at each decode step; with ``gaps``, every request's top-2 logit gap over
    the RMS of the logits at each token it sampled.  On a rank of a mesh
    the records are of the slots and prefills this rank runs; gathering the
    vocabulary is a collective over ``model``, entered by every rank that
    runs the call.  ``force`` (rid -> experts per MoE layer) routes those
    requests' prefills as given, with the gates over the given experts'
    router logits.  ``layer_drops`` holds each prefill's dropped
    assignments per MoE layer; with ``router``, ``router`` holds its router
    logits per MoE layer."""

    def __init__(self, torch, eng, watched, gaps: bool = False, force: dict | None = None,
                 router: bool = False):
        self.torch, self.eng, self.watched, self.gaps_on = torch, eng, set(watched), gaps
        self.force, self.router_on = force or {}, router
        self.prefill, self.prefill_routes = {}, {}
        self.decode = {r: [] for r in watched}
        self.steps = {r: [] for r in watched}
        self.gaps, self.drops, self.experts, self.decode_experts = {}, {}, {}, {}
        self.kept, self.layer_drops, self.router = {}, {}, {}
        self._route, self._cur = [], None

    def _gap(self, lf) -> float:
        top = lf.float().topk(2).values
        return float((top[0] - top[1]) / lf.float().square().mean().sqrt().clamp_min(1e-30))

    def _prefill(self, h):
        self._cur, self._plen, self._route = h.rid, h.prompt.size, []
        try:
            last, state = self.real_prefill(h)
        finally:
            self._cur = None
        if self.gaps_on:
            self.gaps.setdefault(h.rid, []).append(self._gap(last))
        return last, state

    def _decode_step(self, cfg, params, state, tokens):
        logits, state = self.real[0](cfg, params, state, tokens)
        rid = self._cur
        if rid in self.watched:
            self.prefill[rid] = self.M.full_vocab(cfg, logits[0, :self._plen]).clone()
            self.prefill_routes[rid] = list(self._route)
        if rid is not None and self._route:
            self.experts[rid] = [e.cpu() for e, _ in self._route]
            if self.router_on:
                self.router[rid] = [lg.cpu() for _, lg in self._route]
        return logits, state

    def _decode_slots(self, cfg, params, states, tokens):
        self._route = []
        logits, states = self.real[1](cfg, params, states, tokens)
        eng = self.eng
        mine = [(j, eng._slots[eng._base + j]) for j in range(logits.shape[0])]
        mine = [(j, h) for j, h in mine if h is not None]
        if self._route:
            layers = [e.cpu() for e, _ in self._route]
            for j, h in mine:
                self.decode_experts.setdefault(h.rid, []).append([e[j] for e in layers])
        if any(h.rid in self.watched for _, h in mine) or self.gaps_on:
            full = self.M.full_vocab(cfg, logits)
            for j, h in mine:
                if h.rid in self.watched:
                    self.decode[h.rid].append(full[j].clone())
                    self.steps[h.rid].append([(e[j], lg[j]) for e, lg in self._route])
                if self.gaps_on:
                    self.gaps.setdefault(h.rid, []).append(self._gap(full[j]))
        return logits, states

    def _moe_route(self, x, router, k):
        logits = x.float() @ router
        forced = self.force.get(self._cur) if self._cur is not None else None
        if forced is None:
            gates, experts = self.real[2](x, router, k)
        else:
            experts = forced[len(self._route)].to(x.device)
            gates = self.torch.softmax(logits.gather(1, experts), dim=-1).to(x.dtype)
        self._route.append((experts, logits))
        return gates, experts

    def _moe_combine(self, y, route, t):
        if self._cur is not None:  # the assignments this rank combines
            self.kept[self._cur] = self.kept.get(self._cur, 0) + int(route[-1].sum())
        return self.real[4](y, route, t)

    def _moe_dispatch(self, experts, e, c):
        order, dest, keep = self.real[3](experts, e, c)
        if self._cur is not None:
            n = int((~keep).sum())
            self.drops[self._cur] = self.drops.get(self._cur, 0) + n
            self.layer_drops.setdefault(self._cur, []).append(n)
        return order, dest, keep

    def __enter__(self):
        from repro_torch.models import layers as L
        from repro_torch.models import model as M

        self.M, self.L = M, L
        self.real = (M.decode_step, M.decode_slots, L.moe_route, L.moe_dispatch, L.moe_combine)
        M.decode_step, M.decode_slots = self._decode_step, self._decode_slots
        L.moe_route, L.moe_dispatch = self._moe_route, self._moe_dispatch
        L.moe_combine = self._moe_combine
        self.real_prefill, self.eng._prefill = self.eng._prefill, self._prefill
        return self

    def __exit__(self, *exc):
        self.M.decode_step, self.M.decode_slots = self.real[:2]
        self.L.moe_route, self.L.moe_dispatch, self.L.moe_combine = self.real[2:]
        self.eng._prefill = self.real_prefill

    def record(self, rid, prompt, tokens, device="cpu") -> dict:
        """The watched request's record in ``plain_gate``'s form."""
        move = lambda t: t.to(device)  # noqa: E731
        return dict(prompt=prompt, tokens=list(tokens), prefill=move(self.prefill[rid]),
                    decode=[move(t) for t in self.decode[rid]],
                    prefill_routes=[(move(e), move(lg)) for e, lg in self.prefill_routes[rid]],
                    steps=[[(move(e), move(lg)) for e, lg in s] for s in self.steps[rid]])


class StepClock:
    """While installed on an engine: each prefill's host seconds (the card
    synchronized) and tokens, and each decode step's host ms and CUDA-event
    ms (the step's stream time, the waits of gloo's host-staged collectives
    included)."""

    def __init__(self, torch, eng):
        self.torch, self.eng = torch, eng
        self.prefill_s, self.prefill_tokens, self.host_ms, self.stream_ms = 0.0, 0, [], []

    def _prefill(self, h):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real_prefill(h)
        self.torch.cuda.synchronize()
        self.prefill_s += time.perf_counter() - t0
        self.prefill_tokens += h.prompt.size
        return out

    def _step(self, *args):
        torch = self.torch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = self.real_step(*args)
        end.record()
        torch.cuda.synchronize()
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        self.stream_ms.append(start.elapsed_time(end))
        return out

    def __enter__(self):
        eng = self.eng
        self.real_prefill, eng._prefill = eng._prefill, self._prefill
        self.real_step, eng._dispatch_greedy = eng._dispatch_greedy, self._step
        return self

    def __exit__(self, *exc):
        self.eng._prefill, self.eng._dispatch_greedy = self.real_prefill, self.real_step


class CollectiveClock:
    """While installed: the host ms of the model stack's collectives
    (``sharding.all_reduce_sum``, ``all_gather_cat``) and of the engine's
    broadcasts, each between two synchronizations of the card."""

    def __init__(self, torch, SH, dist):
        self.torch, self.SH, self.dist = torch, SH, dist
        self.ms: dict[str, float] = {}

    def _wrap(self, owner, name):
        real = getattr(owner, name)

        def timed(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return real(*args, **kw)
            finally:
                self.torch.cuda.synchronize()
                self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return real, timed

    def __enter__(self):
        self.saved = []
        for owner, name in ((self.SH, "all_reduce_sum"), (self.SH, "all_gather_cat"),
                            (self.dist, "broadcast"), (self.dist, "broadcast_object_list")):
            real, timed = self._wrap(owner, name)
            self.saved.append((owner, name, real))
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, real in self.saved:
            setattr(owner, name, real)


def shard_launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import rmsnorm as kr

    return {"K4": kr.LAUNCHES["rmsnorm"], "K5": dict(kf.PATHS),
            "K6": dict(km.PATHS), "K6 launches": km.LAUNCHES["grouped_matmul"]}


def reset_shard_counts() -> None:
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import rmsnorm as kr

    kr.LAUNCHES["rmsnorm"] = km.LAUNCHES["grouped_matmul"] = 0
    for d in (kf.PATHS, km.PATHS):
        for k in d:
            d[k] = 0


def swap_wo_shards(torch, params) -> None:
    """The mutant: every layer's ``wo`` with its two row halves swapped, so
    that each rank of a model axis of 2 takes its neighbour's shard."""
    for blk in params["layers"]:
        wo = blk["mixer"]["wo"]
        half = wo.shape[0] // 2
        blk["mixer"]["wo"] = torch.cat([wo[half:], wo[:half]])
        del wo


def serve_shard_world(spec: dict) -> list:
    """Phase 19 (b)/(c) on one rank of a world sharing the card: the engine
    over ``spec["shape"]`` (data, model) serves the prompts; the watched
    requests' records go to ``spec["out"]`` from the rank of model
    coordinate 0 that ran them; returns every rank's report (gathered to
    each)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import model as M
    from repro_torch.serve import ServeConfig, ServingEngine

    t_rank = time.perf_counter()
    cfg = replace(get_config(spec["arch"]), n_layers=spec["layers"])
    mesh = make_mesh(spec["shape"], ("data", "model"), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    keeper = mesh.local_rank("model") == 0
    out = Path(spec["out"])
    scfg = ServeConfig(batch_slots=spec["slots"], max_len=spec["max_len"], max_new_tokens=32)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, seeded_params(torch, cfg), scfg, mesh=mesh)
    report = {"rank": mesh.rank, "data": mesh.local_rank("data"),
              "model": mesh.local_rank("model"), "device": str(mesh.device),
              "local_slots": (eng._n_local, eng._base), "place_s": time.perf_counter() - t0,
              "local_gb": sum(t.numel() * t.element_size() for t in _leaves(eng.params)) / 1e9}
    with set_mesh(mesh):  # warm-up: one short prefill and one decode step on every rank
        st = M.init_decode_state(cfg, 1, 256, ring=False, device="cuda")
        M.decode_step(cfg, eng.params, st, torch.arange(1, 65, device="cuda")[None])
        sl = M.init_slot_states(cfg, eng.scfg.batch_slots, 256, device="cuda")
        M.decode_slots_greedy(cfg, eng.params, sl, torch.ones(eng._n_local, dtype=torch.int32,
                                                               device="cuda"))
        del st, sl
    torch.cuda.synchronize()
    reset_shard_counts()
    SH.COLLECTIVES.clear()
    prompts = [np.asarray(p, np.int32) for p in spec["prompts"]]
    with EngineRecorder(torch, eng, spec["watched"]) as rec, StepClock(torch, eng) as clock, \
            CollectiveClock(torch, SH, dist) as coll:
        t0 = time.perf_counter()
        handles = [eng.submit(p) for p in prompts]
        eng.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report.update(
        wall_s=wall, tokens=[list(h.tokens) for h in handles],
        states=[h.state.value for h in handles], drops=dict(rec.drops),
        layer_drops=dict(rec.layer_drops),
        experts=dict(rec.experts), decode_experts=dict(rec.decode_experts),
        kept=dict(rec.kept),
        prefill_s=clock.prefill_s, prefill_tokens=clock.prefill_tokens,
        steps=len(clock.host_ms), step_host_ms=clock.host_ms, step_stream_ms=clock.stream_ms,
        collective_ms=dict(coll.ms),
        collectives={k: dict(v) for k, v in SH.COLLECTIVES.items()},
        counts=shard_launch_counts())
    if keeper:
        for rid in rec.prefill:
            torch.save(rec.record(rid, prompts[rid], handles[rid].tokens),
                       out / f"{spec['tag']}_{rid}.pt")
    del eng, rec, handles
    gc.collect()
    torch.cuda.empty_cache()
    if spec.get("mutant"):  # prefill only: each watched prompt alone
        params = seeded_params(torch, cfg)
        swap_wo_shards(torch, params)
        eng = ServingEngine(cfg, params, replace(scfg, max_new_tokens=1), mesh=mesh)
        del params
        with EngineRecorder(torch, eng, range(len(spec["watched"]))) as rec:
            for rid in spec["watched"]:
                eng.submit(prompts[rid])
            eng.drain()
        if keeper:
            for j, rid in enumerate(spec["watched"]):
                if j in rec.prefill:
                    torch.save(rec.prefill[j].cpu(), out / f"{spec['tag']}_mutant_{rid}.pt")
        del eng, rec
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["seconds"] = time.perf_counter() - t_rank
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, report)
    return reports


def unsharded_reference(torch, cfg, prompts, watched, scfg, force=None,
                        router: bool = False) -> tuple:
    """The unsharded engine on the same traffic, recorded (tokens, the
    watched logits, every token's top-2 gap, the prefill drops); ``force``
    and ``router`` as in ``EngineRecorder``."""
    from repro_torch.serve import ServingEngine

    eng = ServingEngine(cfg, seeded_params(torch, cfg), scfg)
    with EngineRecorder(torch, eng, watched, gaps=True, force=force, router=router) as rec:
        handles = [eng.submit(p) for p in prompts]
        eng.drain()
    torch.cuda.synchronize()
    tokens = [list(h.tokens) for h in handles]
    del eng
    return tokens, rec


def first_route_flip(prefill_a, decode_a, prefill_b, decode_b, p_len: int) -> int:
    """The first logits row (prompt positions, then decode steps) whose
    token two engines sent to different expert sets in some MoE layer;
    past the last row if none."""
    rows = [([e[t] for e in prefill_a], [e[t] for e in prefill_b]) for t in range(p_len)]
    rows += list(zip(decode_a, decode_b))
    for r, (a, b) in enumerate(rows):
        if any(set(x.tolist()) != set(y.tolist()) for x, y in zip(a, b)):
            return r
    return len(rows)


def check_free_routing(label: str, cfg, experts: dict, layer_drops: dict, free) -> dict:
    """The sharded engine's prefills against the unsharded engine routing
    itself (``free``, nothing forced).  Dropped assignments depend only on a
    layer's routing and the capacity, so every MoE layer that routed all
    rows of a request's bucket alike in both engines must drop alike.  A
    request's first layer that routes a row apart saw inputs that differ by
    rounding only, so each row routed apart there must be a near tie: the
    sharded engine's experts within ``plain.ROUTER_MARGIN`` of the unsharded
    router's k-th largest logit."""
    from repro_torch.models import plain

    rows = apart = alike = 0
    bad_drops, far, worst = [], [], 0.0
    for rid, layers in sorted(experts.items()):
        first = True
        for l, (a, b) in enumerate(zip(layers, free.experts[rid])):
            differ = (a.sort(-1).values != b.sort(-1).values).any(-1)
            rows, apart = rows + differ.numel(), apart + int(differ.sum())
            if not bool(differ.any()):
                alike += 1
                if layer_drops[rid][l] != free.layer_drops[rid][l]:
                    bad_drops.append((rid, l, layer_drops[rid][l], free.layer_drops[rid][l]))
                continue
            if first:
                first = False
                lg = free.router[rid][l]
                kth = lg.topk(cfg.top_k, dim=-1).values[:, -1:]
                gap = float((kth - lg.gather(1, a.long())).amax(-1)[differ].max())
                worst = max(worst, gap)
                if gap > plain.ROUTER_MARGIN:
                    far.append((rid, l, round(gap, 4)))
    log(f"  {label} free routing: the unsharded engine routing itself routes {apart} of "
        f"{rows} prefill token-layers apart from the sharded engine "
        f"({100 * apart / max(rows, 1):.2f}%); {alike} of "
        f"{sum(len(v) for v in experts.values())} (request, MoE layer) pairs routed alike, each "
        f"dropping alike; rows routed apart in a request's first such layer at most "
        f"{worst:.4f} below the unsharded router's k-th logit (<= ROUTER_MARGIN "
        f"{plain.ROUTER_MARGIN}); drops per request {dict(sorted(free.drops.items()))}")
    if bad_drops:
        raise AssertionError(f"phase 19 {label}: layers both engines routed alike, nothing "
                             f"forced, drop otherwise (request, layer, sharded, unsharded): "
                             f"{bad_drops}")
    if far:
        raise AssertionError(f"phase 19 {label}: rows routed apart from the unsharded engine "
                             f"at more than ROUTER_MARGIN (request, layer, gap): {far}")
    return dict(token_layers=rows, routed_apart=apart, layers_alike=alike,
                max_first_apart_gap=worst, drops_free=dict(free.drops))


def check_sharded_serving(torch, label: str, cfg, reports, tmp: Path, tag: str, prompts,
                          watched, scfg, mutant: bool) -> dict:
    """Phase 19 (b)/(c)'s gates on the world's reports and records."""
    ranks = len(reports)
    tokens = reports[0]["tokens"]
    if any(r["tokens"] != tokens for r in reports):
        raise AssertionError(f"phase 19 {label}: the ranks' tokens differ")
    if any(s != "completed" for r in reports for s in r["states"]):
        raise AssertionError(f"phase 19 {label}: a request did not complete")
    for r in reports:
        c = r["counts"]
        need = {"K4": c["K4"], "K5 mma": c["K5"]["mma"], "K5 decode": c["K5"]["decode"]}
        if cfg.is_moe:
            need.update({"K6 wgmma": c["K6"]["wgmma"], "K6 decode": c["K6"]["decode"]})
        if not all(n > 0 for n in need.values()):
            raise AssertionError(f"phase 19 {label}: rank {r['rank']} launches {need}")
    recs = {rid: torch.load(tmp / f"{tag}_{rid}.pt", weights_only=False) for rid in watched}
    # MoE: bf16 moves near ties of the router (the plain gate holds the
    # engine's choices to ROUTER_MARGIN of the fp32 router), and a token sent
    # to other experts changes by O(1).  So the unsharded engine runs twice:
    # routing itself (``check_free_routing``: drops layer by layer where the
    # two route alike, near ties where they part), and forced onto the
    # sharded engine's prefill routing, where its drops and prompt logits
    # are compared like with like; its decode steps route themselves, and
    # are compared up to the first row the two route apart.
    flip, experts = {rid: 1 << 30 for rid in range(len(prompts))}, None
    free = None
    if cfg.is_moe:
        experts, dexperts, layer_drops = {}, {}, {}
        for r in reports:
            experts.update(r["experts"])
            dexperts.update(r["decode_experts"])
            layer_drops.update(r["layer_drops"])
        _, frec = unsharded_reference(torch, cfg, prompts, (), scfg, router=True)
        free = check_free_routing(label, cfg, experts, layer_drops, frec)
        del frec
    u_tokens, urec = unsharded_reference(torch, cfg, prompts, watched, scfg, force=experts)
    if cfg.is_moe:
        flip = {rid: first_route_flip(experts[rid], dexperts.get(rid, []), urec.experts[rid],
                                      urec.decode_experts.get(rid, []), prompts[rid].size)
                for rid in range(len(prompts))}
    params = seeded_params(torch, cfg)
    gate = plain_gate(torch, cfg, params, recs)
    plain_err = float(torch.cat(gate["errs"]).max())
    if not plain_err <= LOGITS_REL_TOL:
        raise AssertionError(f"phase 19 {label}: logits vs fp32 plain, relative L2 "
                             f"{plain_err:.3e} > {LOGITS_REL_TOL}")
    # against the unsharded engine: every position both reach from the same tokens
    vs_unsharded, compared = 0.0, 0
    for rid in watched:
        mine = gate["engine_logits"][rid]
        p_len = prompts[rid].size
        theirs = [urec.prefill[rid].float()] + [t.float()[None] for t in urec.decode[rid]]
        theirs = torch.cat(theirs)[:mine.shape[0]]
        same = next((k for k, (a, b) in enumerate(zip(tokens[rid], u_tokens[rid])) if a != b),
                    len(tokens[rid]))
        n = min(p_len + same, theirs.shape[0], flip[rid])  # decode step k reads token k - 1
        err = rel_l2(torch, mine[:n], theirs[:n].cuda())
        routed = f", routing up to row {flip[rid]}" if cfg.is_moe else ""
        forced = " (its prefill forced onto the sharded routing)" if cfg.is_moe else ""
        log(f"  {label} request {rid}: vs the unsharded engine{forced} over {n} positions (tokens "
            f"equal up to {same}{routed}): prompt max {float(err[:p_len].max()):.3e}, decode max "
            f"{float(err[p_len:].max()) if n > p_len else 0.0:.3e}, worst at position "
            f"{int(err.argmax())}")
        vs_unsharded, compared = max(vs_unsharded, float(err.max())), compared + n
    if not vs_unsharded <= SHARD_VS_UNSHARDED_REL:
        raise AssertionError(f"phase 19 {label}: logits vs the unsharded engine, relative L2 "
                             f"{vs_unsharded:.3e} > {SHARD_VS_UNSHARDED_REL}")
    # both engines against the fp32 model on the prompts' positions
    mine_err = max(float(e[:prompts[rid].size].max()) for rid, e in zip(watched, gate["errs"]))
    their_err = max(float(rel_l2(torch, urec.prefill[rid].float(),
                                 gate["refs"][rid][:prompts[rid].size]).max()) for rid in watched)
    if not mine_err <= SHARD_PLAIN_RATIO * their_err:
        raise AssertionError(f"phase 19 {label}: prompt logits vs fp32 plain {mine_err:.3e}, "
                             f"more than {SHARD_PLAIN_RATIO} x the unsharded engine's "
                             f"{their_err:.3e}")
    # greedy tokens: equal up to the unsharded engine's first near tie
    agree, diverged = 0, []
    for rid, (a, b) in enumerate(zip(tokens, u_tokens)):
        k = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            agree += 1
            continue
        gap = urec.gaps[rid][k]
        if prompts[rid].size - 1 + k >= flip[rid]:  # routed apart at or before that row
            diverged.append((rid, k, "routing"))
            continue
        if not gap < SHARD_TIE_MARGIN:
            raise AssertionError(f"phase 19 {label}: request {rid} token {k}: {a[k]} sharded, "
                                 f"{b[k]} unsharded at a top-2 gap of {gap:.3f} x RMS "
                                 f">= {SHARD_TIE_MARGIN}")
        diverged.append((rid, k, round(gap, 4)))
    rec = dict(ranks=ranks, plain_rel_l2=plain_err, vs_unsharded_rel_l2=vs_unsharded,
               positions_compared=compared, prompt_plain_rel_l2=mine_err,
               unsharded_prompt_plain_rel_l2=their_err, requests_equal=agree,
               diverged_at_near_tie=diverged)
    log(f"  {label}: tokens identical on all {ranks} ranks; logits vs fp32 plain relative L2 "
        f"max {plain_err:.3e} (<= {LOGITS_REL_TOL}); vs the unsharded engine {vs_unsharded:.3e} "
        f"(<= {SHARD_VS_UNSHARDED_REL}, {compared} positions); on the prompts vs fp32 plain "
        f"{mine_err:.3e} against the unsharded engine's {their_err:.3e} (<= "
        f"{SHARD_PLAIN_RATIO} x); greedy tokens equal the "
        f"unsharded engine's in {agree} of {len(tokens)} requests, the others from a near tie "
        f"or a routing difference on (request, token, gap/RMS) {diverged}")
    if cfg.is_moe:
        # every rank routes all tokens at the unsharded capacity, so a
        # prefill routed alike drops exactly what the unsharded engine drops
        drops, kept = {}, {}
        for r in reports:
            drops.update(r["drops"])
            for rid, n in r["kept"].items():
                kept[rid] = kept.get(rid, 0) + n
        # expert parallelism combines every kept assignment on exactly one rank
        wrong = {rid: (kept[rid], drops[rid]) for rid in drops
                 if kept[rid] + drops[rid] != sum(e.numel() for e in experts[rid])}
        if wrong:
            raise AssertionError(f"phase 19 {label}: assignments combined over the ranks and "
                                 f"dropped do not add up to the routed ones: {wrong}")
        if drops != urec.drops:
            raise AssertionError(f"phase 19 {label}: dropped assignments per request, the "
                                 f"unsharded engine forced onto the sharded routing: {drops} "
                                 f"sharded, {dict(urec.drops)} unsharded")
        rec.update(drops=drops, first_route_flip_row={rid: flip[rid] for rid in watched},
                   free_routing=free)
        log(f"  {label}: every prefill's kept assignments combined on exactly one rank; "
            f"dropped assignments per request over its prefill (padding included) equal to "
            f"those of the unsharded engine forced onto the sharded routing: {drops}")
    if mutant:
        worst = 0.0
        for rid in watched:
            got = torch.load(tmp / f"{tag}_mutant_{rid}.pt").float().cuda()
            p_len = prompts[rid].size
            worst = max(worst, float(rel_l2(torch, got, gate["refs"][rid][:p_len]).max()))
        log(f"  {label}: mutant 'wo shards swapped between the model ranks' vs fp32 plain: "
            f"prefill relative L2 max {worst:.3e}")
        if not worst > LOGITS_REL_TOL:
            raise AssertionError(f"phase 19 {label}: the logits gate does not catch the "
                                 f"swapped wo shards ({worst:.3e})")
        rec["mutant_rel_l2"] = worst
    del params, gate, urec
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def log_shard_reports(label: str, reports, smi: str) -> None:
    for r in reports:
        host, stream = r["step_host_ms"], r["step_stream_ms"]
        coll = sum(r["collective_ms"].values())
        log(f"    {label} rank {r['rank']} (data {r['data']}, model {r['model']}; slots "
            f"{r['local_slots']}): weights {r['local_gb']:.2f} GB placed in {r['place_s']:.1f} "
            f"s, peak {r['peak_gb']:.2f} GB; prefill {r['prefill_tokens']} tokens in "
            f"{r['prefill_s']:.2f} s ({r['prefill_tokens'] / max(r['prefill_s'], 1e-9):.0f} "
            f"tok/s); {r['steps']} decode steps, host {sum(host) / len(host):.2f} ms, stream "
            f"{sum(stream) / len(stream):.2f} ms a step; collectives {coll:.0f} ms over the run "
            f"({', '.join(f'{k} {v:.0f}' for k, v in r['collective_ms'].items())}); launches "
            f"K4 {r['counts']['K4']}, K5 {r['counts']['K5']}, K6 {r['counts']['K6']}")
    log(f"    ({len(reports)} ranks sharing one card, collectives on gloo through the host: "
        f"not a scaling figure; {smi})")


def sharded_serve_phase(torch, smi: str, phase7: dict) -> dict:
    """Phase 19: (a) a mesh of one against phase 7, (b) Danube whole on 4
    ranks sharing the card, (c) a Mixtral cut under expert parallelism on 2."""
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, run_world
    from repro_torch.serve import ServeConfig, ServingEngine

    t_phase = time.perf_counter()
    out: dict = {"card": smi}
    cfg = get_config(DANUBE)
    # (a) a mesh of one: phase 7's traffic, bit for bit
    t0 = time.perf_counter()
    reset_shard_counts()
    eng = ServingEngine(cfg, seeded_params(torch, cfg), phase7["scfg"],
                        mesh=make_mesh((1, 1), ("data", "model"), device="cuda"))
    with EngineRecorder(torch, eng, phase7["watched"]) as rec:
        handles = [eng.submit(p) for p in phase7["prompts"]]
        eng.drain()
    torch.cuda.synchronize()
    tokens = [list(h.tokens) for h in handles]
    digests = {rid: logit_digest(torch, rec.prefill[rid], rec.decode[rid][:len(tokens[rid]) - 1])
               for rid in phase7["watched"]}
    if tokens != phase7["tokens"] or digests != phase7["digests"]:
        raise AssertionError(f"phase 19 (a): a mesh of one differs from phase 7: tokens "
                             f"{sum(a == b for a, b in zip(tokens, phase7['tokens']))} of "
                             f"{len(tokens)} equal, logits of requests "
                             f"{[r for r in digests if digests[r] != phase7['digests'][r]]} differ")
    counts = shard_launch_counts()
    if not (counts["K4"] > 0 and counts["K5"]["mma"] > 0 and counts["K5"]["decode"] > 0):
        raise AssertionError(f"phase 19 (a): launches {counts}")
    out["a"] = dict(requests=len(tokens), watched=list(phase7["watched"]), counts=counts,
                    seconds=time.perf_counter() - t0)
    log(f"  (a) mesh (data 1, model 1): {len(tokens)} requests, tokens and the watched "
        f"requests' logits bit-identical to phase 7; launches {counts}; "
        f"{out['a']['seconds']:.1f} s")
    del eng, rec, handles
    gc.collect()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as tmp:
        tmp = Path(tmp)
        # (b) Danube whole, (data 2, model 2)
        prompts = phase7["prompts"][:SHARD_SERVE_REQUESTS]
        scfg = replace(phase7["scfg"], batch_slots=SHARD_SERVE_REQUESTS)
        spec = dict(arch=DANUBE, layers=cfg.n_layers, shape=SHARD_SERVE_SHAPE,
                    slots=scfg.batch_slots, max_len=scfg.max_len, prompts=prompts,
                    watched=SHARD_SERVE_WATCHED, out=str(tmp), tag="b", mutant=True)
        t0 = time.perf_counter()
        reports = run_world(SHARD_SERVE_RANKS, serve_shard_world, (spec,),
                            timeout_s=SHARD_WORLD_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        log(f"  (b) {DANUBE} whole ({cfg.n_layers} layers, {cfg.dtype}) on mesh (data "
            f"{SHARD_SERVE_SHAPE[0]}, model {SHARD_SERVE_SHAPE[1]}): {SHARD_SERVE_RANKS} ranks "
            f"sharing the card, {len(prompts)} requests, {scfg.batch_slots} slots x "
            f"{scfg.max_len}; the world {world_s:.1f} s with the spawn")
        log_shard_reports("(b)", reports, smi)
        out["b"] = check_sharded_serving(torch, "(b)", cfg, reports, tmp, "b", prompts,
                                         SHARD_SERVE_WATCHED, scfg, mutant=True)
        out["b"].update(world_s=world_s, reports=reports)
        # (c) Mixtral cut to SHARD_MOE_LAYERS layers, (data 1, model 2): EP
        mcfg = replace(get_config(MIXTRAL), n_layers=SHARD_MOE_LAYERS)
        rng = np.random.default_rng(SEED + 19)
        lens = rng.integers(128, 2049, SHARD_MOE_REQUESTS)
        prompts = [rng.integers(0, mcfg.vocab, n).astype(np.int32) for n in lens]
        scfg = ServeConfig(batch_slots=SHARD_MOE_REQUESTS, max_len=4096, max_new_tokens=32)
        spec = dict(arch=MIXTRAL, layers=SHARD_MOE_LAYERS, shape=SHARD_MOE_SHAPE,
                    slots=scfg.batch_slots, max_len=scfg.max_len, prompts=prompts,
                    watched=SHARD_MOE_WATCHED, out=str(tmp), tag="c", mutant=False)
        t0 = time.perf_counter()
        reports = run_world(SHARD_MOE_RANKS, serve_shard_world, (spec,),
                            timeout_s=SHARD_WORLD_TIMEOUT_S)
        world_s = time.perf_counter() - t0
        log(f"  (c) {MIXTRAL} cut to {SHARD_MOE_LAYERS} of 32 layers (every width, all "
            f"{mcfg.n_experts} experts) on mesh (data {SHARD_MOE_SHAPE[0]}, model "
            f"{SHARD_MOE_SHAPE[1]}): {mcfg.n_experts // SHARD_MOE_SHAPE[1]} experts a rank, "
            f"{SHARD_MOE_RANKS} ranks sharing the card, {len(prompts)} requests; the world "
            f"{world_s:.1f} s with the spawn")
        log_shard_reports("(c)", reports, smi)
        out["c"] = check_sharded_serving(torch, "(c)", mcfg, reports, tmp, "c", prompts,
                                         SHARD_MOE_WATCHED, scfg, mutant=False)
        out["c"].update(world_s=world_s, reports=reports)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 19: {out['seconds']:.1f} s")
    return out


def check_k6_paths(phase: str, paths: GmmPaths, decode_c: int, min_c: int) -> dict:
    """Fail unless the decode step (C = ``decode_c``) and every other launch
    below C = ``min_c`` (the warm-up, the short buckets) launched only the
    decode kernel, every launch at C >= ``min_c`` (the buckets) only the
    wgmma kernel, and buckets of 256 tokens or more (C >= 80) ran; returns
    the launches by C and kernel."""
    by_c = paths.by_c()
    log(f"  K6 launches by C and kernel: {by_c}")
    small = {c: n for c, n in by_c.items() if c < min_c}
    if not by_c.get(decode_c, {}).get("decode") or any(set(n) != {"decode"}
                                                       for n in small.values()):
        raise AssertionError(f"{phase}: the decode step (C = {decode_c}) and every launch below "
                             f"C = {min_c} should launch only the decode K6 kernel: {small}")
    big = {c: n for c, n in by_c.items() if c >= min_c}
    if not any(c >= 80 for c in big) or any(set(n) != {"wgmma"} for n in big.values()):
        raise AssertionError(f"{phase}: the prefill buckets (C >= {min_c}, some >= 80) should "
                             f"launch only the wgmma K6 kernel: {big}")
    return {str(c): n for c, n in by_c.items()}


def check_k5_paths(phase: str, total: dict, prefill: dict) -> dict:
    """Fail unless the prefill launched only the tensor-core kernel and
    decode only the split-KV decode kernel; returns the decode's launches
    per kernel."""
    decode = {k: total[k] - prefill[k] for k in total}
    log(f"  K5 launches by kernel: prefill {prefill}, decode {decode}")
    if prefill["mma"] <= 0 or any(n for k, n in prefill.items() if k != "mma"):
        raise AssertionError(f"{phase}: the prefill should launch only the mma K5 kernel: "
                             f"{prefill}")
    if decode["decode"] <= 0 or any(n for k, n in decode.items() if k != "decode"):
        raise AssertionError(f"{phase}: decode should launch only the decode K5 kernel: {decode}")
    return decode


def k2_only(torch, smi: str) -> int:
    """``--k2 SRC``: K2 at its main-path nests and K3's call at atax ``t1``
    (LARGE), with the package under SRC (another tree's, to set two trees
    side by side on one card); prints one JSON line and the card's name and
    power limit."""
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.core.scheduler import random_inputs
    from repro_torch.polybench import BENCHMARKS

    log(f"K2 with {nkm.__file__}")
    row = check_k2_nests(torch, nkm, 0.0, sass=True)
    nprog, nk = _main_nests(nkm, BENCHMARKS["atax"].variants["a"](LARGE["atax"]), "reduce",
                            ("t1",))[0]
    work = _env(torch, nprog, random_inputs(nprog, seed=11))
    call = lambda: nkm.run_nest(nk, work)  # noqa: E731
    k3 = dict(ms=cuda_ms(call), graph_ms=graph_ms(torch, call))
    log(f"  K3 atax t1: a call {k3['ms']:.4f} ms, device {k3['graph_ms']:.4f} ms")
    print(json.dumps({"k2": row, "k3_atax_t1": k3}), flush=True)
    print(smi, flush=True)
    return 0


def serve_shard_only(torch, smi: str) -> int:
    """``--serve-shard SRC``: phase 7's Danube traffic, then phase 19, with
    the package under SRC; prints phase 19's record as one JSON line and
    the card's name and power limit."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(build.cuda_library, ["gemm", "rmsnorm", "flash_attention", "moe_gmm"]))
    log(f"serving with {build.__file__}; built in {time.perf_counter() - t0:.1f} s")
    cfg = get_config(DANUBE)
    served = serve_path(torch, smi, cfg, seeded_params(torch, cfg), slots=8,
                        n_requests=N_REQUESTS, watched=WATCHED, seed=SEED, breakdown=False)
    phase7 = dict(scfg=served["scfg"], prompts=served["prompts"], tokens=served["tokens"],
                  digests=served["stats"]["logit_digests"], watched=WATCHED)
    del served
    gc.collect()
    torch.cuda.empty_cache()
    out = sharded_serve_phase(torch, smi, phase7)
    for part in ("b", "c"):
        out[part].pop("reports")
    print(json.dumps(out, default=str), flush=True)
    print(smi, flush=True)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and (len(argv) != 2 or argv[0] not in ("--k2", "--serve-shard")):
        print(f"usage: {Path(__file__).name} [--k2 SRC | --serve-shard SRC]", file=sys.stderr)
        return 2
    src = Path(argv[1]).resolve() if argv else HERE / "src"
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (src / "repro_torch").is_dir():
        print(f"no repro_torch under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv:
        return (k2_only if argv[0] == "--k2" else serve_shard_only)(torch, nvidia_smi())

    from repro_torch.configs import get_config
    from repro_torch.core import codegen
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import moe_gmm as km
    from repro_torch.kernels import nest_kernel as nkm
    from repro_torch.kernels import rmsnorm as kr
    from repro_torch.models import model as M

    smi = nvidia_smi()
    log(f"phase 1: device {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()}); nvidia-smi: {smi}")

    log("phase 2: build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    sources = {"gemm": "K1", "rmsnorm": "K4", "flash_attention": "K5", "moe_gmm": "K6"}
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.cuda_library, sources))
    log(f"  built in {time.perf_counter() - t0:.2f} s")
    for name, k in sources.items():
        secs, report = build.BUILD_LOG.get(name, (0.0, ""))
        log(f"  {k} {name}.cu: nvcc {secs:.2f} s")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")

    results: dict[str, dict] = {}
    log("phase 3: kernels against their plain versions")
    check_gemm(torch, results)
    check_nest_kernel(torch, results)
    check_rmsnorm(torch, results)
    check_flash(torch, results)
    check_family_kernels(torch, smi, results)
    check_family_kernels(torch, smi, results, RECURRENT_K5, RECURRENT_K4, "recurrent_shapes",
                         "Jamba")
    check_grouped_matmul(torch, results)
    check_jamba_gmm(torch, smi, results)

    # the main path: every count starts at 0 here and is read right after
    kg.LAUNCHES["gemm"] = 0
    for k in nkm.EMITTED:
        nkm.EMITTED[k] = 0
    nkm.SPLIT["pallas_reduce"] = 0
    nkm.FLAT["pallas_nest"] = 0
    codegen.ROUTED.clear()
    gemm_shapes, bench_times, phase5 = main_path(torch)
    torch.cuda.synchronize()
    launches = {"gemm": kg.LAUNCHES["gemm"], "pallas_nest": nkm.EMITTED["pallas_nest"],
                "pallas_reduce": nkm.EMITTED["pallas_reduce"]}
    split_runs = nkm.SPLIT["pallas_reduce"]
    flat_runs = nkm.FLAT["pallas_nest"]
    routed = dict(codegen.ROUTED)

    log("phase 6: counts over phases 4-5")
    log(f"  launches: K1 gemm {launches['gemm']}, K2 nest {launches['pallas_nest']} "
        f"({flat_runs} of them flattened), K3 reduce {launches['pallas_reduce']} "
        f"({split_runs} of them split)")
    log(f"  kernel recipes routed to torch: {sum(routed.values())}")
    for reason, n in sorted(routed.items()):
        log(f"    {n} x {reason}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    if split_runs <= 0:
        raise AssertionError("no K3 run on the main path took the split form")
    if flat_runs <= 0:
        raise AssertionError("no K2 run on the main path took the flattened form")
    if not gemm_shapes:
        raise AssertionError("phase 4's LARGE programs handed K1 no fp32 product")
    results["gemm"]["main_path_shapes"] = check_gemm_main_shapes(torch, gemm_shapes)

    log(f"phase 18: the sharded Daisy path: (a) a mesh of one; (b) {SHARD_RANKS} ranks on the "
        f"card: CLOUDSC column-sharded at {KLEV} x {NPROMA} through compile_scheme and "
        "Daisy (K2), PolyBench LARGE gemm (K1), bicg and atax (K3, + all-reduce)")
    sharded = shard_phase(torch, smi, phase5)
    del phase5
    for key, name in (("gemm", "K1"), ("pallas_nest", "K2"), ("pallas_reduce", "K3")):
        results[key]["launches_phase_18"] = {
            "(a) mesh of one": sharded["a_counts"][name],
            **{f"(b) rank {r['rank']}": sum(x["counts"][name] for x in r["runs"].values())
               for r in sharded["b"]}}
    results["pallas_nest"]["phase_18"] = sharded

    # the model stack's paths: the counts start at 0 before each, read right after
    def model_counts():
        return {"rmsnorm": kr.LAUNCHES["rmsnorm"], "flash_attention": kf.LAUNCHES["flash_attention"],
                "k5": dict(kf.PATHS), "grouped_matmul": km.LAUNCHES["grouped_matmul"],
                "gemm": kg.LAUNCHES["gemm"], "k1": dict(kg.PATHS),
                "pallas_nest": nkm.EMITTED["pallas_nest"],
                "pallas_reduce": nkm.EMITTED["pallas_reduce"]}

    def reset_counts():
        kr.LAUNCHES["rmsnorm"] = kf.LAUNCHES["flash_attention"] = kg.LAUNCHES["gemm"] = 0
        km.LAUNCHES["grouped_matmul"] = 0
        for d in (kf.PATHS, kg.PATHS):
            for k in d:
                d[k] = 0
        for k in nkm.EMITTED:
            nkm.EMITTED[k] = 0

    log(f"phase 7: main path, serving {DANUBE} at full width through ServingEngine")
    reset_counts()
    with PrefillPaths(M, kf) as prefill_paths:
        served = serve_path(torch, smi, get_config(DANUBE),
                            seeded_params(torch, get_config(DANUBE)), slots=8,
                            n_requests=N_REQUESTS, watched=WATCHED, seed=SEED)
    torch.cuda.synchronize()
    serve_launches = model_counts()
    log(f"  launches: K4 rmsnorm {serve_launches['rmsnorm']}, K5 flash attention "
        f"{serve_launches['flash_attention']} (K1 {serve_launches['gemm']}, K2 "
        f"{serve_launches['pallas_nest']}, K3 {serve_launches['pallas_reduce']})")
    k5_paths = {"serving prefill": prefill_paths.counts,
                "serving decode": check_k5_paths("phase 7", serve_launches["k5"],
                                                 prefill_paths.counts)}
    for k in ("rmsnorm", "flash_attention"):
        launches[k] = serve_launches[k]
        if serve_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the serving path")
    phase7 = dict(scfg=served["scfg"], prompts=served["prompts"], tokens=served["tokens"],
                  digests=served["stats"]["logit_digests"], watched=WATCHED)

    log(f"phase 8: main path, forward of {DANUBE} on 8192 tokens (window {served['cfg'].window})")
    reset_counts()
    forward_path(torch, served["cfg"], served["params"])
    torch.cuda.synchronize()
    fwd_launches = model_counts()
    log(f"  launches: K4 rmsnorm {fwd_launches['rmsnorm']}, K5 flash attention "
        f"{fwd_launches['flash_attention']} (by kernel {fwd_launches['k5']})")
    for k in ("rmsnorm", "flash_attention"):
        if fwd_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the forward path")
    if fwd_launches["k5"]["mma"] <= 0 or any(n for k, n in fwd_launches["k5"].items()
                                             if k != "mma"):
        raise AssertionError(f"the forward should launch only the mma K5 kernel: "
                             f"{fwd_launches['k5']}")
    k5_paths["forward"] = fwd_launches["k5"]

    log(f"phase 15: online tuning inside serving on {DANUBE} (phase 7's weights): the logit "
        "program on K2 in every decode step, the online loop (sync, then on a thread), faults")
    reset_counts()
    online = online_phase(torch, smi, served["cfg"], served["params"])
    del served
    gc.collect()
    torch.cuda.empty_cache()

    mcfg = replace(get_config(MIXTRAL), n_layers=MIXTRAL_LAYERS)
    log(f"phase 9: main path, serving {MIXTRAL} cut in depth to {MIXTRAL_LAYERS} of 32 layers "
        f"(every width, all {mcfg.n_experts} experts, top-{mcfg.top_k}: one stage of a two-stage "
        f"pipeline over two H100s) through ServingEngine")
    torch.cuda.reset_peak_memory_stats()
    mparams = seeded_params(torch, mcfg)
    reset_counts()
    with PrefillPaths(M, kf) as prefill_paths, GmmPaths(km) as gmm_paths:
        served = serve_path(torch, smi, mcfg, mparams, slots=MIXTRAL_SLOTS,
                            n_requests=MIXTRAL_REQUESTS, watched=MIXTRAL_WATCHED, seed=SEED + 9)
    torch.cuda.synchronize()
    moe_launches = model_counts()
    k6_paths = check_k6_paths("phase 9", gmm_paths, MIXTRAL_SLOTS, km.WGMMA_MIN_C)
    k5_paths["MoE serving prefill"] = prefill_paths.counts
    k5_paths["MoE serving decode"] = check_k5_paths("phase 9", moe_launches["k5"],
                                                    prefill_paths.counts)
    log(f"  peak device memory over phase 9 (weights, caches, the fp32 yardstick): "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    per_step = served["stats"]["decode_launches_per_step"]
    log(f"  launches: K6 grouped matmul {moe_launches['grouped_matmul']}, K5 flash attention "
        f"{moe_launches['flash_attention']}, K4 rmsnorm {moe_launches['rmsnorm']} (K1 "
        f"{moe_launches['gemm']}, K2 {moe_launches['pallas_nest']}, K3 "
        f"{moe_launches['pallas_reduce']}); per profiled decode step K6 "
        f"{sum(n for k, n in per_step.items() if k.startswith('K6')):.0f} "
        f"(decode {per_step['K6 grouped_matmul decode']:.0f}), K5 "
        f"{per_step['K5 flash_attention']:.0f}, K4 "
        f"{per_step['K4 rmsnorm']:.0f}")
    launches["grouped_matmul"] = moe_launches["grouped_matmul"]
    for k in ("grouped_matmul", "rmsnorm", "flash_attention"):
        if moe_launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the MoE serving path")
    check_moe_layer(torch, mcfg, mparams)
    del served, mparams
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 10: seeding and transfer on the card (the tune CLI, then Daisy.pretuned())")
    seeding_path(torch, nkm, codegen, bench_times)

    families = {}
    log(f"phase 11: main path, {LLAVA} at full width (vlm): ServingEngine (text-only, as the "
        f"reference serves it), forward with {LLAVA_TEXT} tokens after the patch positions, "
        "ops.matmul (K1)")
    families["11"] = family_phase(torch, smi, 11, LLAVA, slots=8, max_len=4096,
                                  prompt_lens=(128, 2048), n_text=LLAVA_TEXT, bucket=2048,
                                  reset_counts=reset_counts, model_counts=model_counts)
    log(f"phase 12: main path, {SEAMLESS} at full width (audio): ServingEngine (the encoder "
        f"over zero frames per request, as the reference's stub), forward with {SEAMLESS_TEXT} "
        "tokens over 4096 seeded frames")
    families["12"] = family_phase(torch, smi, 12, SEAMLESS, slots=8, max_len=2048,
                                  prompt_lens=(16, 512), n_text=SEAMLESS_TEXT, bucket=512,
                                  reset_counts=reset_counts, model_counts=model_counts)
    results["gemm"]["ops_matmul"] = [r for r in families["11"]["ops_matmul"]["rows"]
                                     if r["shape"].endswith("float32")]
    bf16_rows = [r for r in families["11"]["ops_matmul"]["rows"]
                 if r["shape"].endswith("bfloat16")]
    # the bf16 row's numbers: the main path's first product (q_proj), the
    # rest beside them
    results["gemm_bf16"].update(
        {k: bf16_rows[0][k] for k in ("shape", "kernel", "ms", "stream_ms", "plain_ms",
                                      "library_ms", "library_stream_ms", "bound_ms", "bound_by")},
        ops_matmul=bf16_rows,
        max_abs_err=max([results["gemm_bf16"]["max_abs_err"], *(r["error"] for r in bf16_rows)]))
    launches["gemm_bf16"] = families["11"]["ops_matmul"]["gemm_by_kernel"]["wgmma"]
    for key, pick in (("rmsnorm", lambda p: p["rmsnorm"]),
                      ("flash_attention", lambda p: p["flash_attention"]),
                      ("flash_attention_decode", lambda p: p.get("k5_decode", {}).get("decode"))):
        results[key]["launches_phases_11_12"] = {
            f"{ph} {path}": pick(v) for ph, f in families.items()
            for path, v in f.items() if path != "ops_matmul" and pick(v) is not None}
    results["flash_attention"]["launches_phases_11_12_by_kernel"] = {
        ph: {"serving prefill": f["serving"]["k5_prefill"],
             "serving decode": f["serving"]["k5_decode"],
             "cross-attention": f["serving"]["k5_cross"], "forward": f["forward"]["k5"]}
        for ph, f in families.items()}
    results["gemm"]["launches_phase_11_ops_matmul"] = families["11"]["ops_matmul"]["gemm"]

    recurrent = {}
    jcfg = replace(get_config(JAMBA), n_layers=JAMBA_LAYERS)
    log(f"phase 13: main path, {JAMBA} (hybrid) cut in depth to its first {JAMBA_LAYERS} of 72 "
        f"layers (every width, all {jcfg.n_experts} experts, top-{jcfg.top_k}: the first stage "
        f"of an 18-stage pipeline): ServingEngine (exact-length prefill), forward on "
        f"{RECURRENT_TEXT} tokens")
    recurrent["13"] = recurrent_phase(torch, smi, 13, jcfg, bucket=2048,
                                      reset_counts=reset_counts, model_counts=model_counts)
    log(f"phase 14: main path, {XLSTM} (ssm) whole: ServingEngine (exact-length prefill), "
        f"forward on {RECURRENT_TEXT} tokens")
    recurrent["14"] = recurrent_phase(torch, smi, 14, get_config(XLSTM), bucket=512,
                                      reset_counts=reset_counts, model_counts=model_counts,
                                      fp32_gate=True)
    for key in ("rmsnorm", "flash_attention", "grouped_matmul"):
        results[key]["launches_phases_13_14"] = {
            f"{ph} {path}": f[path][key] for ph, f in recurrent.items()
            for path in ("serving", "forward")}
    j = recurrent["13"]["serving"]
    results["flash_attention"]["launches_phase_13_by_kernel"] = {
        "serving prefill": j["k5_prefill"], "serving decode": j["k5_decode"],
        "forward": recurrent["13"]["forward"]["k5"]}
    results["flash_attention_decode"]["launches_phases_13_14"] = {
        "13 serving": j["k5_decode"]["decode"]}
    results["grouped_matmul"]["launches_phase_13_by_c"] = j["k6_by_c"]
    results["grouped_matmul_decode"]["launches_phases_13_14"] = {
        "13 serving": j["grouped_matmul_decode"]}

    del recurrent
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 16: training {MINICPM} whole (40 layers, every width) through "
        "repro_torch.train.Trainer on K4/K5 and their backward kernels")
    training = training_phase(torch, smi)
    results.update(training["rows"])
    trained = training["train"]["launches"]
    launches["rmsnorm_bwd"] = trained["K4-bwd"]
    launches["flash_attention_bwd"] = trained["K5-bwd"]
    results["rmsnorm"]["launches_phase_16"] = trained["K4"]
    results["flash_attention"]["launches_phase_16"] = trained["K5"]
    results["flash_attention_bwd"]["phase_16"] = {k: v for k, v in training.items()
                                                  if k != "rows"}

    log(f"phase 17: MoE and recurrent training: K6-bwd; {MIXTRAL} cut to {MOE_TRAIN_LAYERS} of "
        f"32 layers (every width, all 8 experts) through Trainer; the {JAMBA} cut and {XLSTM}")
    moe_training = moe_training_phase(torch, smi)
    results["grouped_matmul_bwd"] = moe_training["row"]
    trained = moe_training["train"]["launches"]
    launches["grouped_matmul_bwd"] = trained["K6-bwd"]
    for key, name in (("rmsnorm", "K4"), ("flash_attention", "K5"), ("grouped_matmul", "K6"),
                      ("rmsnorm_bwd", "K4-bwd"), ("flash_attention_bwd", "K5-bwd")):
        results[key]["launches_phase_17"] = trained[name]
    results["flash_attention_bwd"]["seamless_shapes"] = moe_training["seamless"]
    results["grouped_matmul_bwd"]["phase_17"] = {k: v for k, v in moe_training.items()
                                                 if k not in ("row", "seamless")}

    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 19: sharded serving: (a) {DANUBE} on a mesh of one against phase 7; (b) "
        f"{DANUBE} whole on mesh (data {SHARD_SERVE_SHAPE[0]}, model {SHARD_SERVE_SHAPE[1]}), "
        f"{SHARD_SERVE_RANKS} ranks sharing the card; (c) {MIXTRAL} cut to {SHARD_MOE_LAYERS} "
        f"layers under expert parallelism, {SHARD_MOE_RANKS} ranks (collectives on gloo)")
    sharded_serve = sharded_serve_phase(torch, smi, phase7)
    for part in ("b", "c"):
        for r in sharded_serve[part]["reports"]:
            c, who = r["counts"], f"({part}) rank {r['rank']}"
            results["rmsnorm"].setdefault("launches_phase_19", {})[who] = c["K4"]
            results["flash_attention"].setdefault("launches_phase_19", {})[who] = c["K5"]["mma"]
            results["flash_attention_decode"].setdefault("launches_phase_19", {})[who] = \
                c["K5"]["decode"]
            if part == "c":
                results["grouped_matmul"].setdefault("launches_phase_19", {})[who] = \
                    c["K6"]["wgmma"]
                results["grouped_matmul_decode"].setdefault("launches_phase_19", {})[who] = \
                    c["K6"]["decode"]
    results["flash_attention"]["phase_19"] = {
        k: ({kk: vv for kk, vv in v.items() if kk != "reports"} if isinstance(v, dict) else v)
        for k, v in sharded_serve.items()}

    # the decode kernels' launches: phases 7 and 9 (K5), phase 9 (K6)
    launches["flash_attention_decode"] = (k5_paths["serving decode"]["decode"]
                                          + k5_paths["MoE serving decode"]["decode"])
    launches["grouped_matmul_decode"] = sum(n.get("decode", 0) for n in k6_paths.values())
    kernels = []
    for key in ("gemm", "gemm_bf16", "pallas_nest", "pallas_reduce", "rmsnorm", "flash_attention",
                "flash_attention_decode", "grouped_matmul", "grouped_matmul_decode",
                "rmsnorm_bwd", "flash_attention_bwd", "grouped_matmul_bwd"):
        row = dict(results[key])
        row["launches"] = launches[key]
        if key == "flash_attention":
            row["launches_by_kernel"] = k5_paths
        if key == "grouped_matmul":
            row["launches_by_c"] = k6_paths
        if key == "pallas_reduce":
            row["split_launches"] = split_runs
        if key == "pallas_nest":
            row["flat_runs"] = flat_runs
            row["launches_phase_15"] = online["k2"]["launches"]
            row["flat_runs_phase_15"] = online["k2"]["flat_runs"]
            row["logit_nest"] = online["k2"]
            row["online_phase_15"] = {k: v for k, v in online.items() if k != "k2"}
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
