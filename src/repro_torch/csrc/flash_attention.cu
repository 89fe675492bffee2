// K5: hand-written flash attention for Hopper (sm_90a): three forward kernels
// and K5-bwd, the backward's three.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (the Pallas TPU
// kernel, pl.pallas_call at flash_attention.py:117, body _flash_kernel at
// :31-82): q (BHq, Sq, D), k and v (BHkv, Skv, D), row-major, float32 or
// bfloat16; GQA reads KV row b / (BHq / BHkv); causal masking against
// q_pos = q_offset + i, an optional sliding window (q_pos - k_pos < window);
// an online softmax with m, l and the accumulator in fp32, NEG_INF = -1e30,
// P cast to v's type before P.V, and rows that see no key give 0.
//
// Differences from the TPU kernel, and why:
// * The TPU walks the KV blocks as a sequential grid axis with m/l/acc in
//   VMEM scratch.  Hopper blocks run in parallel, so the KV walk is a loop
//   inside the block.
// * q_offset may differ per q row (the serving path gives each slot its own
//   cache length), so every row computes its own visible key range
//   [lo, hi) and a block walks only the union of its rows' ranges: a slot at
//   length 300 does not walk a 4096-entry cache.  The reference's "live"
//   block test (skip KV blocks no row can see) is this range test.
// * Ragged Sq, Skv and D are masked inside the kernels; nothing is padded in
//   device memory.
//
// flash_kernel (SIMT; fp32, and whatever the other two kernels do not
// take).  A block owns R = 4 q rows that share one KV head (the GQA group's
// heads at a position first, then further positions), and its W warps split
// the KV range in chunks of 32 keys, chunk c going to warp c % W.  Within a
// chunk, lane j scores key j against all R rows (q rows staged in shared
// memory, 16-byte loads of K where D allows), the warp takes the chunk's
// max, rescales its running state, and then accumulates P.V with lanes
// spread over D.  At the end the W partial states are merged in shared
// memory in warp order, so results are deterministic.  W is 16 when there
// are few blocks (decode: one block per slot and KV head) and 4 otherwise.
// Any D <= 256.  A decode step over 8 slots reads ~63 MB of KV at length
// 2048, 19 us at 3.35 TB/s: decode is bound by bytes, and this kernel keeps
// every K/V row it reads to one pass.
//
// flash_mma_kernel (tensor cores; bf16 with Sq > 1: the bucketed prefill and
// forward).  Bound: at a Danube prefill (32 heads, 2048 tokens, causal,
// D = 120) the visible (q, k) pairs need 32.2 GFLOP, 33 us at 989 TFLOP/s
// bf16; the 8192-token forward with its 4096 window 387 GFLOP, 0.39 ms.  Both
// are bound by operations (each K/V row is reused by 2048 q rows), so the
// products run on the tensor cores in a FlashAttention-2 shape:
// * A block of 4 warps owns 128 consecutive q positions of one q head (grid
//   x the head, so a GQA group's heads run side by side and share K/V in L2;
//   grid y the q tile, heaviest causal tile first).  Each warp owns 32 rows
//   as two m16 tiles, so every K and V fragment read from shared memory
//   feeds two mma.sync, and a warp has twice the independent products
//   between barriers (one m16 tile per warp, 64 rows per block with Q held
//   in registers, was slower on an H100 at the prefill and forward shapes).
//   The Q tile is staged once in shared memory with D padded to DP = 128
//   (Danube's 120 becomes 128) by cp.async's zero fill, and its
//   ldmatrix A fragments are reloaded per k step: both tiles' would not fit
//   in registers beside O and S.
// * K/V tiles of 64 keys x DP stream through a 2-stage cp.async ring in
//   dynamic shared memory (104 KB with Q at DP = 128, so two blocks fit an
//   SM): tile t + 1 loads while tile t is multiplied.  Only tiles in the
//   union of the block's rows' visible ranges are loaded (the reference's
//   "live" pruning: the windowed forward skips the masked half); only tiles
//   that cross the diagonal, the window edge, Skv or an empty row test a mask.
// * S = Q.K^T on mma.sync.aligned.m16n8k16 (bf16 in, fp32 accumulate), K's
//   B fragments by ldmatrix from row-major K.  The online softmax runs in
//   registers in the log2 domain (ex2.approx), the row max and sum over the
//   quad of lanes that holds a row (two __shfl_xor_sync).  P is rounded to
//   bf16 in registers and used directly as the A fragments of P.V; V's B
//   fragments come by ldmatrix.trans.  O is 32 x DP fp32 per warp.
// * Epilogue: O / l (0 when l is 0), rounded to bf16, the D real columns
//   stored with guarded 4-byte stores.
// ptxas (sm_90a): 255 registers with 100 bytes of spill stores and 116 of
// loads per thread (chip_smoke.py prints these lines at every build).  One
// DP serves every head: no main-path head is narrower than 120.
// It takes D % 8 == 0, D <= 128 and 16-byte aligned pointers (rows then
// start on 16 bytes, as cp.async needs); kernels/flash_attention.py sends
// everything else to flash_kernel.  wgmma, TMA and warp specialisation are
// later work.
//
// flash_decode_kernel (bf16 decode, Sq == 1: every served token).  Bound: a
// Danube step over 8 slots at 1-4095 keys reads 66.8 MB of K/V, 20 us at
// 3.35 TB/s (Mixtral's 16 slots 134.7 MB, 40 us); the arithmetic is 4
// multiply-adds a K/V value, so decode is bound by bytes.  flash_kernel gives
// a slot's KV head one block that walks every key: 64 or 128 blocks on 132
// SMs, each paced by its longest row.  Here the key range is split across
// blocks (flash-decoding):
// * A block owns one KV head, all of its GQA group's q rows (padded to G =
//   4, 8 or 16 rows, so each K/V byte is read once for the group) and one
//   chunk of keys (kernels/flash_attention.py::decode_chunk: 256, or more
//   where a head would have over 64 chunks).  The grid covers the whole
//   cache; the offsets stay on the device, and a block whose chunk no row of
//   its group can see exits at once.
// * One thread streams the chunk's 64-key K and V tiles into a 2-stage ring
//   with bulk copies (cp.async.bulk, the TMA's 1-D form: a tile of one KV
//   head is one contiguous run of 64 D-value rows) completing on mbarriers;
//   the waits trap after ~10 s, so a fault is a launch error.  With 2
//   stages (66 KB of shared memory at G = 4) three blocks fit an SM, 180 KB
//   of K/V in flight an SM: on an H100 this beat 3 stages with two blocks
//   an SM (the same bytes in flight) and 32-key tiles with four or more
//   blocks (PERF.md).
// * 4 warps split a tile's keys, 16 each.  Scores: 8 lanes a key, each over
//   16 of its columns from shared memory (conflict-free 16-byte reads), q
//   in registers, summed by 3 xor shuffles.  Each warp keeps its own online
//   softmax (fp32 m, l; P rounded to bf16 before P.V, as the reference) and
//   accumulator (4 columns a lane); the block merges the warps in warp
//   order.
// * A chunk that is its head's only live one stores O / l.  Otherwise it
//   stores (m, l, acc) in fp32 to a workspace, fences, and counts itself on
//   its head's arrival counter (kernels/runtime.py); the last live chunk to
//   arrive merges them all in chunk order with the factors exp(m_c - M),
//   stores O / l (0 when l is 0) and resets the counter.  The sum order is
//   fixed by the chunk size, so results are bit-identical run to run.
// It takes bf16 with D % 8 == 0, D <= 128, a group of at most 16 and
// 16-byte aligned pointers; everything else stays on flash_kernel.
//
// Training.  flash_mma_kernel also writes each row's log-sum-exp of its
// scaled scores, m ln 2 + ln l from its log2-domain m, when given an fp32
// (BHq, Sq) buffer (Params::lse; +inf for a row that sees no key, so its
// backward P is 0).  Serving passes null: its launches do not change.
//
// K5-bwd (no TPU kernel: repro/kernels/flash_attention.py:14 names a
// custom_vjp backward that the reference does not have; it trains on XLA's
// gradient of its plain version).  FlashAttention-2's two-pass form, three
// kernels, no atomics:
// * flash_bwd_delta_kernel: delta = rowsum(dO * O) in fp32, 8 lanes a row,
//   16-byte loads;
// * flash_bwd_dkdv_kernel: a block per (KV head, 64 keys) holds K and V,
//   walks every q head of its GQA group and, 64 rows at a time, the rows that
//   can see its keys (the forward's range rule for causal, window and
//   q_offset), recomputes P = exp(S scale - lse) and dP = dO V^T, and sums
//   dV += P^T dO and dK += scale dS^T Q with dS = P (dP - delta);
// * flash_bwd_dq_kernel: a block per (q head, 64 rows) walks the union of
//   its rows' visible keys, 64 at a time, and sums dQ += scale dS K.
// Bound: operations.  Five products over the visible (q, k) pairs against
// the forward's two: at MiniCPM-2B's 144 heads of 64 over a causal 2048 that
// is 2.5 x 77 GFLOP, 0.20 ms at 989 TFLOP/s.  The first version ran them as
// fp32 FMA on the CUDA cores (67 TFLOP/s at most) from element-by-element
// loads, 61x the bound.  Here every product runs on the tensor cores, with
// the forward's building blocks (mma.sync m16n8k16, bf16 in, fp32
// accumulators; ldmatrix; cp.async):
// * Tiles stay bf16 in shared memory at the forward's stride (DP + 8, DP =
//   64 or 128; D = 120 padded by cp.async's zero fill).  dkdv loads its K and
//   V once and streams the Q and dO tiles (with their lse and delta) of each
//   q head through a 2-stage cp.async ring, the next tile loading while the
//   current one is multiplied; dq keeps Q, dO, lse and delta resident and
//   streams K and V the same way.  Six tiles: 104 KB at DP = 128, two blocks
//   an SM (the fp32 tiles took 162 KB, one block).
// * dkdv: a warp owns 16 keys.  S^T = K Q^T and dP^T = V dO^T with K and V
//   as A fragments (ldmatrix) and Q and dO rows as B fragments, then P^T and
//   dS^T in registers, rounded to bf16 and used from the accumulator
//   registers as the A fragments of dV += P^T dO and dK += dS^T Q (FA2's
//   register reuse), dO and Q as B fragments by ldmatrix.trans.  dK and dV
//   stay in fp32 registers over the whole q range; at DP = 128 a warp takes
//   32 of a tile's rows at a time so S^T and dP^T fit beside them.
// * dq: a warp owns 16 q rows: S = Q K^T and dP = dO V^T, dS rounded to bf16
//   in registers, dQ += dS K with K's B fragments by ldmatrix.trans.
// * A warp skips a tile none of whose (row, key) pairs is visible and tests
//   the mask only on tiles that cross the diagonal, the window edge, Sq or
//   Skv.
// P and dS in bf16 are the one rounding the fp32 version did not have (the
// forward rounds P the same way); kernels/ref.py::attention_grad_mma follows
// it on the CPU.  Each output element is summed by one warp in a fixed order,
// so the gradients are bit-identical run to run.  On an H100 (700 W) the
// three kernels took 1.28 graph ms at MiniCPM-2B's shape beside SDPA's
// backward's 0.72 (PERF.md).  A GQA group's heads are walked by one dkdv
// block, so at 8 KV heads a causal key tile 0 holds 4 x 32 q tiles while the
// last holds 4.  It takes bf16 with D % 8 == 0, D <= 128, Skv >= Sq and
// 16-byte aligned pointers; kernels/flash_attention.py raises on anything
// else.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int R = 4;          // q rows per block
constexpr int DMAX = 256;     // largest head size
constexpr int MAXW = 16;      // most warps per block
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

struct Params {
  const int* offs;  // per-q-row offsets (BHq entries), or null: off0 for every row
  int off0;
  int bhq, bhkv, sq, skv, d;
  int causal, has_window, window;
  float scale;
  float* lse = nullptr;  // flash_mma_kernel: each row's log-sum-exp (BHq, Sq), or null
};

struct Row {
  size_t q_index;  // row index into q/out viewed as (BHq * Sq, D)
  int lo, hi;      // visible keys [lo, hi); empty when lo >= hi
  bool valid;
};

__device__ __forceinline__ Row row_info(const Params& p, int bkv, int r) {
  const int group = p.bhq / p.bhkv;
  const int rg = blockIdx.x * R + r;
  Row row;
  row.valid = rg < group * p.sq;
  if (!row.valid) {
    row.q_index = 0;
    row.lo = 1;
    row.hi = 0;
    return row;
  }
  const int head = bkv * group + rg % group;
  const int i = rg / group;
  const int pos = (p.offs ? p.offs[head] : p.off0) + i;
  row.q_index = static_cast<size_t>(head) * p.sq + i;
  row.hi = p.causal ? min(p.skv, pos + 1) : p.skv;
  row.lo = p.has_window ? max(0, pos - p.window + 1) : 0;
  return row;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// TM: registers per row for the accumulator (D <= 32 * TM); VEC: 16-byte K loads
template <typename T, int TM, bool VEC>
__global__ void __launch_bounds__(MAXW * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, Params p) {
  __shared__ __align__(16) float q_s[DMAX][R];  // q rows, transposed: one float4 per d
  __shared__ float acc_s[R][DMAX];
  __shared__ float m_s[MAXW][R];
  __shared__ float l_s[MAXW][R];

  const int bkv = blockIdx.y;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int d = p.d;

  Row rows[R];
  int lo_b = p.skv, hi_b = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rows[r] = row_info(p, bkv, r);
    if (rows[r].lo < rows[r].hi) {
      lo_b = min(lo_b, rows[r].lo);
      hi_b = max(hi_b, rows[r].hi);
    }
  }

  for (int idx = threadIdx.x; idx < R * DMAX; idx += blockDim.x) {
    const int r = idx / DMAX, c = idx % DMAX;
    const Row row = row_info(p, bkv, r);
    q_s[c][r] = (row.valid && c < d) ? to_f32(q[row.q_index * d + c]) : 0.f;
  }
  __syncthreads();

  float m[R], l[R], acc[R][TM];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int t = 0; t < TM; ++t) acc[r][t] = 0.f;
  }

  const T* kb = k + static_cast<size_t>(bkv) * p.skv * d;
  const T* vb = v + static_cast<size_t>(bkv) * p.skv * d;
  const int c_end = (hi_b + 31) / 32;
  for (int c = lo_b / 32 + warp; c < c_end; c += nwarps) {
    const int key = c * 32 + lane;
    float s[R] = {0.f, 0.f, 0.f, 0.f};
    if (key < hi_b) {
      if (VEC) {
        constexpr int N = Vec<T>::N;
        const Vec<T>* kr = reinterpret_cast<const Vec<T>*>(kb + static_cast<size_t>(key) * d);
        for (int c8 = 0; c8 < d / N; ++c8) {
          const Vec<T> kv = kr[c8];
#pragma unroll
          for (int e = 0; e < N; ++e) {
            const float kf = to_f32(kv.v[e]);
            const float4 qv = *reinterpret_cast<const float4*>(&q_s[c8 * N + e][0]);
            s[0] = fmaf(qv.x, kf, s[0]);
            s[1] = fmaf(qv.y, kf, s[1]);
            s[2] = fmaf(qv.z, kf, s[2]);
            s[3] = fmaf(qv.w, kf, s[3]);
          }
        }
      } else {
        const T* kr = kb + static_cast<size_t>(key) * d;
        for (int e = 0; e < d; ++e) {
          const float kf = to_f32(kr[e]);
          const float4 qv = *reinterpret_cast<const float4*>(&q_s[e][0]);
          s[0] = fmaf(qv.x, kf, s[0]);
          s[1] = fmaf(qv.y, kf, s[1]);
          s[2] = fmaf(qv.z, kf, s[2]);
          s[3] = fmaf(qv.w, kf, s[3]);
        }
      }
    }

    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool vis = key >= rows[r].lo && key < rows[r].hi;
      const float sc = vis ? s[r] * p.scale : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float pr = vis ? __expf(sc - m_new) : 0.f;
      const float alpha = __expf(m[r] - m_new);
      l[r] = alpha * l[r] + pr;  // per-lane partial sum, reduced after the loop
#pragma unroll
      for (int t = 0; t < TM; ++t) acc[r][t] *= alpha;
      m[r] = m_new;
      pv[r] = to_f32(from_f32<T>(pr));  // P in v's type, as the reference casts it
    }

    const int nk = min(32, hi_b - c * 32);
    for (int j = 0; j < nk; ++j) {
      const T* vr = vb + static_cast<size_t>(c * 32 + j) * d;
      float vv[TM];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        const int dd = lane + 32 * t;
        vv[t] = dd < d ? to_f32(vr[dd]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pv[r], j);
#pragma unroll
        for (int t = 0; t < TM; ++t) acc[r][t] = fmaf(pj, vv[t], acc[r][t]);
      }
    }
  }

  // merge the warps' partial states, in warp order
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lw = warp_sum(l[r]);
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = lw;
    }
  }
  __syncthreads();
  float mtot[R], ltot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mtot[r] = NEG_INF;
    for (int w = 0; w < nwarps; ++w) mtot[r] = fmaxf(mtot[r], m_s[w][r]);
    ltot[r] = 0.f;
    for (int w = 0; w < nwarps; ++w) ltot[r] += l_s[w][r] * __expf(m_s[w][r] - mtot[r]);
  }
  for (int w = 0; w < nwarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float f = __expf(m[r] - mtot[r]);
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          const int dd = lane + 32 * t;
          if (dd < d) acc_s[r][dd] = (w == 0 ? 0.f : acc_s[r][dd]) + acc[r][t] * f;
        }
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < R * d; idx += blockDim.x) {
    const int r = idx / d, c = idx % d;
    const Row row = row_info(p, bkv, r);
    if (!row.valid) continue;
    float lr = 0.f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr)
      if (rr == r) lr = ltot[rr];
    out[row.q_index * d + c] = from_f32<T>(acc_s[r][c] / (lr == 0.f ? 1.f : lr));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const Params& p, int nwarps,
           void* stream) {
  const int group = p.bhq / p.bhkv;
  const dim3 grid((group * p.sq + R - 1) / R, p.bhkv);
  const dim3 block(32 * nwarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  const bool vec = p.d % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0;
  if (p.d <= 128) {
    if (vec)
      flash_kernel<T, 4, true><<<grid, block, 0, s>>>(qp, kp, vp, op, p);
    else
      flash_kernel<T, 4, false><<<grid, block, 0, s>>>(qp, kp, vp, op, p);
  } else {
    if (vec)
      flash_kernel<T, 8, true><<<grid, block, 0, s>>>(qp, kp, vp, op, p);
    else
      flash_kernel<T, 8, false><<<grid, block, 0, s>>>(qp, kp, vp, op, p);
  }
  return static_cast<int>(cudaGetLastError());
}

int run(int dtype, const void* q, const void* k, const void* v, void* out, const int* offs,
        int off0, int bhq, int bhkv, int sq, int skv, int d, int causal, int has_window,
        int window, float scale, int nwarps, void* stream) {
  if (d < 1 || d > DMAX || nwarps < 1 || nwarps > MAXW || bhkv < 1 || bhq % bhkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{offs, off0, bhq, bhkv, sq, skv, d, causal, has_window, window, scale};
  return dtype == 0 ? launch<float>(q, k, v, out, p, nwarps, stream)
                    : launch<__nv_bfloat16>(q, k, v, out, p, nwarps, stream);
}

// ---------------------------------------------------------------------------
// flash_mma_kernel: bf16 on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int MMA_MT = 2;                // m16 row tiles per warp
constexpr int MMA_BM = 4 * 16 * MMA_MT;  // q rows per block: 4 warps x 32
constexpr int MMA_BN = 64;               // keys per K/V tile
constexpr int MMA_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>
__host__ __device__ constexpr int mma_stride() {  // rows 16 bytes apart mod 128: no bank conflict
  return DP + 8;
}

template <int DP>
constexpr int mma_smem_bytes() {  // Q tile + 2 stages of K and V tiles
  return (MMA_BM + 4 * MMA_BN) * mma_stride<DP>() * 2;
}

// cp.async, ldmatrix and mma.sync helpers, as in csrc/moe_gmm.cu: copied,
// not shared through a header, because kernels/build.py keys each library on
// the bytes of its one .cu file, so a changed header would not rebuild it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<const unsigned*>(&v);
}

// ROWS rows x DP columns of a row-major (rows, d) bf16 matrix into shared
// memory, 16 bytes per cp.async; rows >= nrows and columns >= d (the pad up
// to DP) are zero-filled.  d % 8 == 0, so a group of 8 is in or out whole.
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int nrows, int d) {
  constexpr int CH = DP / 8;
  for (int ch = threadIdx.x; ch < ROWS * CH; ch += MMA_THREADS) {
    const int r = ch / CH, c = (ch % CH) * 8;
    const bool in = row0 + r < nrows && c < d;
    cp_async16(dst + r * mma_stride<DP>() + c,
               in ? src + static_cast<size_t>(row0 + r) * d + c : src, in ? 16 : 0);
  }
}

// One K/V tile of this warp's 32 rows (MMA_MT tiles of 16): S = Q.K^T, the
// online softmax update (m in the log2 domain, l a per-lane partial sum),
// O = alpha * O + P.V.  Each K and V fragment feeds both row tiles.  MASK:
// test each (row, key) against the row's [lo, hi); otherwise every key of
// the tile is visible to every row of the block.
template <int DP, bool MASK>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                         const __nv_bfloat16* vs, float (&o)[MMA_MT][DP / 8][4],
                                         float (&m)[MMA_MT][2], float (&l)[MMA_MT][2],
                                         const int (&lo)[MMA_MT][2], const int (&hi)[MMA_MT][2],
                                         int k0, float scale_log2) {
  constexpr int ST = mma_stride<DP>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float s[MMA_MT][MMA_BN / 8][4];
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
    for (int j = 0; j < MMA_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // Q's A fragments, reloaded per k step: both tiles' kept in registers
    // would not fit beside O and S
    unsigned a[MMA_MT][4];
#pragma unroll
    for (int i = 0; i < MMA_MT; ++i)
      ldmatrix_x4(a[i], qs + ((warp * MMA_MT + i) * 16 + (lane % 16)) * ST + kk * 16 +
                            (lane / 16) * 8);
#pragma unroll
    for (int jp = 0; jp < MMA_BN / 16; ++jp) {
      unsigned b[4];  // {b0, b1} of key tiles 2jp and 2jp + 1
      ldmatrix_x4(b, ks + (jp * 16 + (lane % 8) + (lane / 16) * 8) * ST + kk * 16 +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < MMA_MT; ++i) {
        mma_bf16(s[i][2 * jp], a[i], b[0], b[1]);
        mma_bf16(s[i][2 * jp + 1], a[i], b[2], b[3]);
      }
    }
  }

  // s[i][j][e]: row 16i + lane/4 (e < 2) or + 8 (e >= 2) of the warp's rows,
  // key k0 + 8j + 2(lane%4) + e%2
  unsigned pf[MMA_MT][MMA_BN / 16][4];  // P in bf16 as the A fragments of P.V
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i) {
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < MMA_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[i][j][e] * scale_log2;
        if (MASK) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + (e % 2);
          if (!(key >= lo[i][e / 2] && key < hi[i][e / 2])) x = NEG_INF;
        }
        s[i][j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[i][h], mx[h]);
      alpha[h] = fast_exp2(m[i][h] - m_new);
      m[i][h] = m_new;
      l[i][h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < MMA_BN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = fast_exp2(s[i][j][e] - m[i][e / 2]);
        if (MASK) {  // a masked key adds nothing, also to a row that has seen none yet
          const int key = k0 + 8 * j + 2 * (lane % 4) + (e % 2);
          if (!(key >= lo[i][e / 2] && key < hi[i][e / 2])) p[e] = 0.f;
        }
        l[i][e / 2] += p[e];
      }
      pf[i][j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);      // row 16i + lane/4
      pf[i][j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);  // row 16i + lane/4 + 8
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] *= alpha[e / 2];
  }
#pragma unroll
  for (int kk = 0; kk < MMA_BN / 16; ++kk) {
#pragma unroll
    for (int jp = 0; jp < DP / 16; ++jp) {
      unsigned b[4];  // {b0, b1} of column tiles 2jp and 2jp + 1
      ldmatrix_x4_trans(b, vs + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * ST + jp * 16 +
                               (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < MMA_MT; ++i) {
        mma_bf16(o[i][2 * jp], pf[i][kk], b[0], b[1]);
        mma_bf16(o[i][2 * jp + 1], pf[i][kk], b[2], b[3]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, Params p) {
  constexpr int ST = mma_stride<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [MMA_BM][ST]
  __nv_bfloat16* kvs = qs + MMA_BM * ST;  // [stage][K, V][MMA_BN][ST]

  const int head = blockIdx.x;
  const int tile = gridDim.y - 1 - blockIdx.y;  // the causal heaviest tile first
  const int row0 = tile * MMA_BM;
  const int bkv = head / (p.bhq / p.bhkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d = p.d;
  const int off = p.offs ? p.offs[head] : p.off0;

  // each row's visible keys [lo, hi); rows past Sq see none
  auto range = [&](int i, int& lo, int& hi) {
    if (i >= p.sq) {
      lo = 1;
      hi = 0;
      return;
    }
    const int pos = off + i;
    hi = p.causal ? min(p.skv, pos + 1) : p.skv;
    lo = p.has_window ? max(0, pos - p.window + 1) : 0;
  };
  // the block's tiles: the union of its rows' ranges; a tile needs no mask
  // when it lies inside every real row's range
  int lo_b = p.skv, hi_b = 0, lo_max = 0, hi_min = p.skv;
  for (int r = 0; r < MMA_BM && row0 + r < p.sq; ++r) {
    int lo, hi;
    range(row0 + r, lo, hi);
    lo_max = max(lo_max, lo);
    hi_min = min(hi_min, hi);
    if (lo < hi) {
      lo_b = min(lo_b, lo);
      hi_b = max(hi_b, hi);
    }
  }
  int lo[MMA_MT][2], hi[MMA_MT][2];  // this lane's rows: 16i + lane/4 (+ 8) of its warp's
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      range(row0 + (warp * MMA_MT + i) * 16 + lane / 4 + 8 * h, lo[i][h], hi[i][h]);
  const bool warp_live = row0 + warp * MMA_MT * 16 < p.sq;

  const __nv_bfloat16* kb = k + static_cast<size_t>(bkv) * p.skv * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bkv) * p.skv * d;
  const int t0 = lo_b / MMA_BN;
  const int t1 = hi_b > lo_b ? (hi_b + MMA_BN - 1) / MMA_BN : t0;

  float o[MMA_MT][DP / 8][4];
  float m[MMA_MT][2], l[MMA_MT][2];
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][j][e] = 0.f;
    m[i][0] = m[i][1] = NEG_INF;
    l[i][0] = l[i][1] = 0.f;
  }

  if (t0 < t1) {
    load_tile<DP, MMA_BM>(qs, q + static_cast<size_t>(head) * p.sq * d, row0, p.sq, d);
    load_tile<DP, MMA_BN>(kvs, kb, t0 * MMA_BN, p.skv, d);
    load_tile<DP, MMA_BN>(kvs + MMA_BN * ST, vb, t0 * MMA_BN, p.skv, d);
    cp_async_commit();
    const float scale_log2 = p.scale * LOG2E;

    for (int t = t0; t < t1; ++t) {
      cp_async_wait<0>();
      __syncthreads();  // tile t (and Q) has landed, and every warp is done with tile t - 1
      if (t + 1 < t1) {
        __nv_bfloat16* nxt = kvs + ((t + 1 - t0) % 2) * 2 * MMA_BN * ST;
        load_tile<DP, MMA_BN>(nxt, kb, (t + 1) * MMA_BN, p.skv, d);
        load_tile<DP, MMA_BN>(nxt + MMA_BN * ST, vb, (t + 1) * MMA_BN, p.skv, d);
      }
      cp_async_commit();
      if (!warp_live) continue;
      const __nv_bfloat16* ks = kvs + ((t - t0) % 2) * 2 * MMA_BN * ST;
      const int k0 = t * MMA_BN;
      if (k0 >= lo_max && k0 + MMA_BN <= hi_min)
        mma_tile<DP, false>(qs, ks, ks + MMA_BN * ST, o, m, l, lo, hi, k0, scale_log2);
      else
        mma_tile<DP, true>(qs, ks, ks + MMA_BN * ST, o, m, l, lo, hi, k0, scale_log2);
    }
    cp_async_wait<0>();
  }

  // epilogue: the quad's partial sums, O / l (0 for a row that saw no key)
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[i][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int r = row0 + (warp * MMA_MT + i) * 16 + lane / 4 + h * 8;
      if (r >= p.sq) continue;
      if (p.lse != nullptr && lane % 4 == 0)  // natural log: m is log2-scaled
        p.lse[static_cast<size_t>(head) * p.sq + r] =
            lt == 0.f ? INFINITY : m[i][h] * LN2 + logf(lt);
      const float safe = lt == 0.f ? 1.f : lt;
      __nv_bfloat16* orow = out + (static_cast<size_t>(head) * p.sq + r) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * (lane % 4);
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[i][j][2 * h] / safe, o[i][j][2 * h + 1] / safe);
      }
    }
}

template <int DP>
int launch_mma_dp(const void* q, const void* k, const void* v, void* out, const Params& p,
                  cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DP>();
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(p.bhq, (p.sq + MMA_BM - 1) / MMA_BM);
  flash_mma_kernel<DP><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

int run_mma(const void* q, const void* k, const void* v, void* out, const Params& p,
            void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
                           16 == 0;
  if (p.d < 8 || p.d > 128 || p.d % 8 != 0 || !aligned || p.bhkv < 1 || p.bhq % p.bhkv != 0 ||
      p.sq < 1 || p.sq > 65535 * MMA_BM)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mma_dp<128>(q, k, v, out, p, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// flash_decode_kernel: bf16 decode, the KV range split across blocks (see the
// note at the top)
// ---------------------------------------------------------------------------
constexpr int DEC_TK = 64;                    // keys per K/V tile
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_KW = DEC_TK / DEC_WARPS;    // keys of a tile per warp
constexpr int DEC_STAGES = 2;                 // TMA ring depth
constexpr int DEC_DP = 128;                   // largest head
constexpr int DEC_TILE_BYTES = DEC_TK * DEC_DP * 2;  // room for one K or V tile
constexpr int DEC_STAGE_BYTES = 2 * DEC_TILE_BYTES;
constexpr int DEC_MAX_CHUNKS = DEC_WARPS * DEC_KW;  // the merge's factors fill the score buffer

// G: q rows per block, the GQA group padded to 4, 8 or 16
template <int G>
__host__ __device__ constexpr int dec_smem_bytes() {
  return DEC_STAGES * DEC_STAGE_BYTES  // the K/V ring
         + G * DEC_DP * 4              // q rows in fp32, later the block's merged acc
         + DEC_WARPS * DEC_KW * G * 4  // each warp's scores, then its P
         + 2 * DEC_WARPS * G * 4       // each warp's m and l
         + 2 * G * 4                   // each row's visible keys [lo, hi)
         + DEC_STAGES * 8;             // mbarriers
}

// mbarrier and bulk-copy helpers, as in csrc/moe_gmm.cu (copied, not shared
// through a header: see the note above cp_async16)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of `bar` with this parity to complete.  A wait that
// lasts about 10 seconds traps, so a fault in the pipeline surfaces as a
// launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  const long long t0 = clock64();
  while (!done) {
    if (clock64() - t0 > 20000000000ll) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// `bytes` (a multiple of 16) of contiguous global memory into shared memory
// by the copy engine; their arrival completes a transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// One block: KV head blockIdx.y (all of its GQA group's q rows) over chunk
// blockIdx.x of `chunk` keys.  ws holds, per (KV head, chunk), G rows of
// (m, l) then G rows of DEC_DP accumulator values; cnt one arrival counter
// per KV head.
template <int G>
__global__ void __launch_bounds__(DEC_THREADS, 3)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    Params p, int chunk, float* __restrict__ ws, int* __restrict__ cnt) {
  extern __shared__ __align__(128) unsigned char dec_smem[];
  float* q_s = reinterpret_cast<float*>(dec_smem + DEC_STAGES * DEC_STAGE_BYTES);  // [G][DP]
  float* sc = q_s + G * DEC_DP;              // [warp][key][G]
  float* m_s = sc + DEC_WARPS * DEC_KW * G;  // [warp][G]
  float* l_s = m_s + DEC_WARPS * G;          // [warp][G]
  int* lo_s = reinterpret_cast<int*>(l_s + DEC_WARPS * G);  // [G]
  int* hi_s = lo_s + G;                                      // [G]
  uint64_t* full = reinterpret_cast<uint64_t*>(hi_s + G);   // [DEC_STAGES]
  __shared__ int last;

  const int group = p.bhq / p.bhkv;
  const int bkv = blockIdx.y, c = blockIdx.x;
  const int d = p.d;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = static_cast<size_t>(bkv) * group;  // the group's first q row

  // the union of the rows' visible keys decides which chunks are live; no
  // offset is read on the host
  int lo_b = p.skv, hi_b = 0;
  for (int r = 0; r < group; ++r) {
    const int pos = p.offs ? p.offs[row0 + r] : p.off0;
    const int hi = p.causal ? min(p.skv, pos + 1) : p.skv;
    const int lo = p.has_window ? max(0, pos - p.window + 1) : 0;
    if (lo < hi) {
      lo_b = min(lo_b, lo);
      hi_b = max(hi_b, hi);
    }
    if (tid == 0) {
      lo_s[r] = lo;
      hi_s[r] = hi;
    }
  }
  const int c0 = lo_b / chunk;
  const int live = hi_b > lo_b ? (hi_b - 1) / chunk + 1 - c0 : 0;
  if (live == 0) {  // no row sees a key: chunk 0 writes the zeros
    if (c == 0)
      for (int i = tid; i < group * d; i += DEC_THREADS)
        out[row0 * d + i] = __float2bfloat16(0.f);
    return;
  }
  if (c < c0 || c >= c0 + live) return;  // a chunk no row can see

  const int k_lo = max(c * chunk, lo_b), k_hi = min((c + 1) * chunk, hi_b);
  const int ntiles = (k_hi - k_lo + DEC_TK - 1) / DEC_TK;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bkv) * p.skv * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bkv) * p.skv * d;
  // tile i: keys [k_lo + 64 i, ...), rows of D values, contiguous in the cache
  auto fetch = [&](int i) {
    const int key0 = k_lo + i * DEC_TK;
    const unsigned bytes = static_cast<unsigned>(min(DEC_TK, k_hi - key0) * d * 2);
    unsigned char* st = dec_smem + (i % DEC_STAGES) * DEC_STAGE_BYTES;
    uint64_t* bar = &full[i % DEC_STAGES];
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(st, kb + static_cast<size_t>(key0) * d, bytes, bar);
    bulk_load(st + DEC_TILE_BYTES, vb + static_cast<size_t>(key0) * d, bytes, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < DEC_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    for (int i = 0; i < min(DEC_STAGES, ntiles); ++i) fetch(i);
  }
  // q rows in fp32, zero past D and for the rows past the group
  for (int i = tid; i < G * DEC_DP; i += DEC_THREADS) {
    const int r = i / DEC_DP, col = i % DEC_DP;
    q_s[i] = r < group && col < d ? __bfloat162float(q[(row0 + r) * d + col]) : 0.f;
  }
  for (int r = group + tid; r < G; r += DEC_THREADS) {
    lo_s[r] = 1;
    hi_s[r] = 0;
  }
  __syncthreads();

  // each warp's running state over its keys: m, l for every row (the same in
  // every lane), and the accumulator's columns 4 lane .. 4 lane + 3
  float m[G], l[G], acc[G][4];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  const int g8 = lane / 8, t8 = lane % 8;  // scoring: 8 lanes a key, 16 columns a lane
  const int col = 4 * lane;                // P.V: 4 columns a lane
  float* scw = sc + warp * DEC_KW * G;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % DEC_STAGES;
    mbar_wait(&full[s], (i / DEC_STAGES) & 1);
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(dec_smem + s * DEC_STAGE_BYTES);
    const __nv_bfloat16* vs = ks + DEC_TILE_BYTES / 2;
    const int key0 = k_lo + i * DEC_TK;
    const int nk = min(DEC_TK, k_hi - key0);

    // scores of the warp's 16 keys, 4 rows at a time: lanes 8 g .. 8 g + 7
    // take key 4 it + g, each over columns 8 t .. 8 t + 7 and 64 + 8 t ..,
    // and sum over the 8 lanes
#pragma unroll
    for (int rp = 0; rp < G; rp += 4) {
      float qv[4][16];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4* src =
              reinterpret_cast<const float4*>(q_s + (rp + rr) * DEC_DP + 8 * t8 + 64 * h);
          const float4 a = src[0], b = src[1];
          qv[rr][8 * h + 0] = a.x;
          qv[rr][8 * h + 1] = a.y;
          qv[rr][8 * h + 2] = a.z;
          qv[rr][8 * h + 3] = a.w;
          qv[rr][8 * h + 4] = b.x;
          qv[rr][8 * h + 5] = b.y;
          qv[rr][8 * h + 6] = b.z;
          qv[rr][8 * h + 7] = b.w;
        }
#pragma unroll
      for (int it = 0; it < DEC_KW / 4; ++it) {
        const int kl = warp * DEC_KW + 4 * it + g8;  // key within the tile
        float sr[4] = {0.f, 0.f, 0.f, 0.f};
        if (kl < nk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c8 = 8 * t8 + 64 * h;
            if (c8 < d) {
              float kf[8];
              bf16x8_to_f32(*reinterpret_cast<const uint4*>(ks + kl * d + c8), kf);
#pragma unroll
              for (int e = 0; e < 8; ++e)
#pragma unroll
                for (int rr = 0; rr < 4; ++rr) sr[rr] = fmaf(qv[rr][8 * h + e], kf[e], sr[rr]);
            }
          }
        }
#pragma unroll
        for (int o = 1; o < 8; o <<= 1)
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) sr[rr] += __shfl_xor_sync(0xffffffffu, sr[rr], o);
        if (t8 < 4) {  // lane t of the 8 stores row rp + t's score
          const int r = rp + t8;
          const float mine = t8 == 0 ? sr[0] : t8 == 1 ? sr[1] : t8 == 2 ? sr[2] : sr[3];
          const int key = key0 + kl;
          const bool vis = kl < nk && key >= lo_s[r] && key < hi_s[r];
          scw[(4 * it + g8) * G + r] = vis ? mine * p.scale : NEG_INF;
        }
      }
    }
    __syncwarp();

    // online softmax over the warp's DEC_KW keys: lane j takes key
    // j % DEC_KW for every row; P rounded to bf16 replaces the score
    const int j = lane % DEC_KW;
    float alpha[G];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const float sv = scw[j * G + r];
      float mx = sv;
#pragma unroll
      for (int o = DEC_KW / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = __expf(m[r] - m_new);  // 1 while the row has seen no key (l, acc are 0)
      const float pr = sv == NEG_INF ? 0.f : __expf(sv - m_new);
      float ps = pr;
#pragma unroll
      for (int o = DEC_KW / 2; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = alpha[r] * l[r] + ps;
      m[r] = m_new;
      if (lane < DEC_KW) scw[j * G + r] = __bfloat162float(__float2bfloat16(pr));  // P in v's type
    }
    __syncwarp();

    // O = alpha O + P.V over the warp's keys that are in the tile
#pragma unroll
    for (int r = 0; r < G; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha[r];
    const int nkw = min(DEC_KW, nk - warp * DEC_KW);
    if (col < d) {
      for (int jj = 0; jj < nkw; ++jj) {
        const uint2 raw =
            *reinterpret_cast<const uint2*>(vs + (warp * DEC_KW + jj) * d + col);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 v01 = __bfloat1622float2(h[0]), v23 = __bfloat1622float2(h[1]);
#pragma unroll
        for (int r = 0; r < G; r += 4) {
          const float4 pr = *reinterpret_cast<const float4*>(scw + jj * G + r);
          const float pj[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            acc[r + rr][0] = fmaf(pj[rr], v01.x, acc[r + rr][0]);
            acc[r + rr][1] = fmaf(pj[rr], v01.y, acc[r + rr][1]);
            acc[r + rr][2] = fmaf(pj[rr], v23.x, acc[r + rr][2]);
            acc[r + rr][3] = fmaf(pj[rr], v23.y, acc[r + rr][3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + DEC_STAGES < ntiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fetch(i + DEC_STAGES);
    }
  }

  // the block's state: the warps' merged in warp order
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < G; ++r) {
      m_s[warp * G + r] = m[r];
      l_s[warp * G + r] = l[r];
    }
  __syncthreads();
  float mb[G], lb[G];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    mb[r] = NEG_INF;
    for (int w = 0; w < DEC_WARPS; ++w) mb[r] = fmaxf(mb[r], m_s[w * G + r]);
    lb[r] = 0.f;
    for (int w = 0; w < DEC_WARPS; ++w) lb[r] += l_s[w * G + r] * __expf(m_s[w * G + r] - mb[r]);
  }
  float* acc_s = q_s;  // [G][DP]; q is not read again
  for (int w = 0; w < DEC_WARPS; ++w) {
    if (warp == w && col < d)
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float f = __expf(m[r] - mb[r]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc_s[r * DEC_DP + col + e] = (w == 0 ? 0.f : acc_s[r * DEC_DP + col + e]) + acc[r][e] * f;
      }
    __syncthreads();
  }

  if (live == 1) {  // the only live chunk: no partials
    for (int i = tid; i < group * d; i += DEC_THREADS) {
      const int r = i / d, cc = i % d;
      float lr = 0.f;
#pragma unroll
      for (int rr = 0; rr < G; ++rr)
        if (rr == r) lr = lb[rr];
      out[(row0 + r) * d + cc] = __float2bfloat16(acc_s[r * DEC_DP + cc] / (lr == 0.f ? 1.f : lr));
    }
    return;
  }

  // this chunk's partial to the workspace; the last live chunk to arrive
  // merges them all in chunk order
  const size_t per_chunk = static_cast<size_t>(G) * (2 + DEC_DP);
  float* part = ws + (static_cast<size_t>(bkv) * gridDim.x + c) * per_chunk;
  if (tid < G) {
#pragma unroll
    for (int rr = 0; rr < G; ++rr)
      if (rr == tid) {
        part[2 * rr] = mb[rr];
        part[2 * rr + 1] = lb[rr];
      }
  }
  for (int i = tid; i < G * DEC_DP; i += DEC_THREADS) part[2 * G + i] = acc_s[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&cnt[bkv], 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every live chunk's factor exp(m_x - M) per row (at most DEC_MAX_CHUNKS:
  // sc holds that many rows of G floats), then l and the accumulator summed in chunk order,
  // whichever block arrived last
  const float* first = ws + (static_cast<size_t>(bkv) * gridDim.x + c0) * per_chunk;
  float* fx = sc;      // [chunk][G]
  float* mt = m_s;     // [G]: M, then L
  for (int i = tid; i < live * G; i += DEC_THREADS)
    fx[i] = __ldcg(first + (i / G) * per_chunk + 2 * (i % G));
  __syncthreads();
  if (tid < G) {
    float mx = NEG_INF;
    for (int x = 0; x < live; ++x) mx = fmaxf(mx, fx[x * G + tid]);
    mt[tid] = mx;
  }
  __syncthreads();
  for (int i = tid; i < live * G; i += DEC_THREADS) fx[i] = __expf(fx[i] - mt[i % G]);
  __syncthreads();
  if (tid < G) {
    float lt = 0.f;
#pragma unroll 8
    for (int x = 0; x < live; ++x) lt += __ldcg(first + x * per_chunk + 2 * tid + 1) * fx[x * G + tid];
    l_s[tid] = lt;
  }
  __syncthreads();
  for (int i = tid; i < group * d / 4; i += DEC_THREADS) {  // 4 columns a thread
    const int r = 4 * i / d, cc = 4 * i % d;
    float4 at = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int x = 0; x < live; ++x) {
      const float4 a =
          __ldcg(reinterpret_cast<const float4*>(first + x * per_chunk + 2 * G + r * DEC_DP + cc));
      const float f = fx[x * G + r];
      at.x += a.x * f;
      at.y += a.y * f;
      at.z += a.z * f;
      at.w += a.w * f;
    }
    const float lt = l_s[r] == 0.f ? 1.f : l_s[r];
    __nv_bfloat162 o2[2] = {__floats2bfloat162_rn(at.x / lt, at.y / lt),
                            __floats2bfloat162_rn(at.z / lt, at.w / lt)};
    *reinterpret_cast<uint2*>(out + (row0 + r) * d + cc) = *reinterpret_cast<const uint2*>(o2);
  }
  if (tid == 0) cnt[bkv] = 0;  // ready for the next launch on this stream
}

template <int G>
int launch_decode_g(const void* q, const void* k, const void* v, void* out, const Params& p,
                    int chunk, float* ws, int* cnt, cudaStream_t stream) {
  constexpr int bytes = dec_smem_bytes<G>();
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(p.skv > 0 ? (p.skv + chunk - 1) / chunk : 1, p.bhkv);
  flash_decode_kernel<G><<<grid, DEC_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), p, chunk, ws, cnt);
  return static_cast<int>(cudaGetLastError());
}

int run_decode(const void* q, const void* k, const void* v, void* out, const Params& p,
               int chunk, float* ws, int* cnt, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
                           16 == 0;
  if (p.d < 8 || p.d > DEC_DP || p.d % 8 != 0 || !aligned || p.bhkv < 1 || p.bhkv > 65535 ||
      p.bhq % p.bhkv != 0 || p.bhq / p.bhkv > 16 || p.skv < 0 || chunk < DEC_TK ||
      chunk % DEC_TK != 0 || (p.skv + chunk - 1) / chunk > DEC_MAX_CHUNKS || ws == nullptr ||
      cnt == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = p.bhq / p.bhkv;
  auto s = static_cast<cudaStream_t>(stream);
  if (group <= 4) return launch_decode_g<4>(q, k, v, out, p, chunk, ws, cnt, s);
  if (group <= 8) return launch_decode_g<8>(q, k, v, out, p, chunk, ws, cnt, s);
  return launch_decode_g<16>(q, k, v, out, p, chunk, ws, cnt, s);
}

// ---------------------------------------------------------------------------
// K5-bwd: the backward of attention, FlashAttention-2's two-pass form on the
// tensor cores (see the note at the top)
// ---------------------------------------------------------------------------
constexpr int BWD_TILE = 64;   // q rows or keys of a tile: a dkdv block's keys, a dq block's rows
constexpr int BWD_WARPS = 4;   // 16 keys (dkdv) or 16 q rows (dq) a warp
constexpr int BWD_THREADS = 32 * BWD_WARPS;
static_assert(16 * BWD_WARPS == BWD_TILE, "a warp owns 16 of a block's keys or rows");
static_assert(BWD_THREADS == MMA_THREADS, "load_tile strides by MMA_THREADS");

template <int DP>
constexpr int bwd_smem_bytes() {  // 6 bf16 tiles of (64, DP + 8); dkdv also 2 stages of lse, delta
  return 6 * BWD_TILE * mma_stride<DP>() * 2 + 4 * BWD_TILE * 4;
}

// 4 bytes by cp.async (rows of lse and delta, whose length need not keep 16
// bytes of alignment); bytes = 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// visible keys [lo, hi) of a q row at absolute position pos
__device__ __forceinline__ void key_range(const Params& p, int pos, int& lo, int& hi) {
  hi = p.causal ? min(p.skv, pos + 1) : p.skv;
  lo = p.has_window ? max(0, pos - p.window + 1) : 0;
}

__device__ __forceinline__ bool key_visible(const Params& p, int pos, int key) {
  return key < p.skv && (!p.causal || key <= pos) && (!p.has_window || pos - key < p.window);
}

// rows [lo, hi) of q head `head` that can see a key of [k0, kend): causal
// needs off + i >= k0, a window off + i - window + 1 < kend
__device__ __forceinline__ void q_range(const Params& p, int head, int k0, int kend, int& lo,
                                        int& hi) {
  const int off = p.offs ? p.offs[head] : p.off0;
  lo = p.causal ? max(0, k0 - off) : 0;
  hi = p.has_window ? min(p.sq, kend + p.window - 1 - off) : p.sq;
}

// Advances (gi, q0) to the next q tile of KV head bkv's GQA group that can
// see keys [k0, kend): further tiles of head gi, then the next heads' (gi =
// -1 starts).  False past the last.
__device__ __forceinline__ bool next_q_tile(const Params& p, int bkv, int group, int k0, int kend,
                                            int& gi, int& q0) {
  int lo, hi;
  if (gi >= 0) {
    q_range(p, bkv * group + gi, k0, kend, lo, hi);
    if (q0 + BWD_TILE < hi) {
      q0 += BWD_TILE;
      return true;
    }
  }
  for (++gi; gi < group; ++gi) {
    q_range(p, bkv * group + gi, k0, kend, lo, hi);
    if (lo < hi) {
      q0 = lo / BWD_TILE * BWD_TILE;
      return true;
    }
  }
  return false;
}

// delta = rowsum(dO * O) in fp32: 8 lanes a row, 16-byte loads 64 values
// apart, summed by 3 xor shuffles; 32 rows a block
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int d) {
  const int row = blockIdx.x * 32 + threadIdx.x / 8, t = threadIdx.x % 8;
  float acc = 0.f;
  if (row < rows) {
    const __nv_bfloat16* orow = o + static_cast<size_t>(row) * d;
    const __nv_bfloat16* drow = dout + static_cast<size_t>(row) * d;
    for (int c = 8 * t; c < d; c += 64) {
      float a[8], b[8];
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(orow + c), a);
      bf16x8_to_f32(*reinterpret_cast<const uint4*>(drow + c), b);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(a[e], b[e], acc);
    }
  }
#pragma unroll
  for (int m = 1; m < 8; m <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && t == 0) delta[row] = acc;
}

// One q tile against this warp's 16 keys, QC of its rows (the columns of
// S^T) from column c0: S^T = K Q^T and dP^T = V dO^T on the tensor cores,
// P^T = exp(S^T scale - lse) (0 where MASK finds the key hidden from the row
// or the row past Sq), dS^T = P^T (dP^T - delta), both rounded to bf16 as
// the A fragments of dV += P^T dO and dK += dS^T Q.  The forward's helpers:
// K and V rows give A fragments by ldmatrix, Q and dO rows B fragments
// (S^T's by ldmatrix, dV's and dK's by ldmatrix.trans).
template <int DP, int QC, bool MASK>
__device__ __forceinline__ void dkdv_part(const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                          const __nv_bfloat16* qs, const __nv_bfloat16* dos,
                                          const float* lse_s, const float* del_s,
                                          float (&dk)[DP / 8][4], float (&dv)[DP / 8][4],
                                          const Params& p, int pos0, int rows, int c0, int key0,
                                          float scale_log2) {
  constexpr int ST = mma_stride<DP>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float s[QC / 8][4], dp[QC / 8][4];
#pragma unroll
  for (int j = 0; j < QC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    unsigned ka[4], va[4];
    const int arow = (warp * 16 + lane % 16) * ST + kk * 16 + (lane / 16) * 8;
    ldmatrix_x4(ka, ks + arow);
    ldmatrix_x4(va, vs + arow);
#pragma unroll
    for (int jp = 0; jp < QC / 16; ++jp) {
      unsigned b[4];  // {b0, b1} of q tiles 2jp and 2jp + 1
      const int brow = (c0 + jp * 16 + lane % 8 + (lane / 16) * 8) * ST + kk * 16 +
                       ((lane / 8) % 2) * 8;
      ldmatrix_x4(b, qs + brow);
      mma_bf16(s[2 * jp], ka, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], ka, b[2], b[3]);
      ldmatrix_x4(b, dos + brow);
      mma_bf16(dp[2 * jp], va, b[0], b[1]);
      mma_bf16(dp[2 * jp + 1], va, b[2], b[3]);
    }
  }
  // s[j][e]: key key0 + lane/4 (+ 8 for e >= 2), q row c0 + 8j + 2(lane%4) + e%2
  unsigned pa[QC / 16][4], sa[QC / 16][4];
#pragma unroll
  for (int j = 0; j < QC / 8; ++j) {
    const int qc = c0 + 8 * j + 2 * (lane % 4);
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + qc);
    const float2 dl = *reinterpret_cast<const float2*>(del_s + qc);
    float pv[4], dsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fast_exp2(fmaf(s[j][e], scale_log2, -(e % 2 ? l2.y : l2.x) * LOG2E));
      if (MASK) {
        const int r = qc + e % 2;
        if (!(r < rows && key_visible(p, pos0 + r, key0 + lane / 4 + 8 * (e / 2)))) x = 0.f;
      }
      pv[e] = x;
      dsv[e] = x * (dp[j][e] - (e % 2 ? dl.y : dl.x));
    }
    pa[j / 2][(j % 2) * 2] = pack_bf16(pv[0], pv[1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    sa[j / 2][(j % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
    sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
  }
#pragma unroll
  for (int kk = 0; kk < QC / 16; ++kk) {
    const int brow = (c0 + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ST + (lane / 16) * 8;
#pragma unroll
    for (int jp = 0; jp < DP / 16; ++jp) {
      unsigned b[4];  // {b0, b1} of column tiles 2jp and 2jp + 1
      ldmatrix_x4_trans(b, dos + brow + jp * 16);
      mma_bf16(dv[2 * jp], pa[kk], b[0], b[1]);
      mma_bf16(dv[2 * jp + 1], pa[kk], b[2], b[3]);
      ldmatrix_x4_trans(b, qs + brow + jp * 16);
      mma_bf16(dk[2 * jp], sa[kk], b[0], b[1]);
      mma_bf16(dk[2 * jp + 1], sa[kk], b[2], b[3]);
    }
  }
}

// dK and dV of 64 keys of one KV head: K and V stay in shared memory, the Q
// and dO tiles (with lse and delta) of every q head of the GQA group that
// sees those keys stream through a 2-stage cp.async ring; dK and dV stay in
// fp32 registers, 16 keys a warp.  QC: q rows a warp takes at once (32 at
// DP = 128 keep S^T and dP^T in registers beside dK and dV).
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, 2)
flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Params p) {
  constexpr int ST = mma_stride<DP>();
  constexpr int QC = DP > 64 ? 32 : 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][ST]
  __nv_bfloat16* vs = ks + BWD_TILE * ST;                           // [64][ST]
  __nv_bfloat16* ring = vs + BWD_TILE * ST;                         // [stage][Q, dO][64][ST]
  float* rows_s = reinterpret_cast<float*>(ring + 4 * BWD_TILE * ST);  // [stage][lse, delta][64]
  const int bkv = blockIdx.x, k0 = blockIdx.y * BWD_TILE;
  const int group = p.bhq / p.bhkv, d = p.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kend = min(k0 + BWD_TILE, p.skv);
  const int key0 = k0 + warp * 16;  // this warp's keys
  const bool warp_live = key0 < p.skv;

  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  auto fetch = [&](int stage, int gi, int q0) {
    const size_t base = static_cast<size_t>(bkv * group + gi) * p.sq;
    __nv_bfloat16* st = ring + stage * 2 * BWD_TILE * ST;
    float* rs = rows_s + stage * 2 * BWD_TILE;
    load_tile<DP, BWD_TILE>(st, q + base * d, q0, p.sq, d);
    load_tile<DP, BWD_TILE>(st + BWD_TILE * ST, dout + base * d, q0, p.sq, d);
    for (int r = threadIdx.x; r < BWD_TILE; r += BWD_THREADS) {
      const bool in = q0 + r < p.sq;
      cp_async4(rs + r, in ? lse + base + q0 + r : lse, in ? 4 : 0);
      cp_async4(rs + BWD_TILE + r, in ? delta + base + q0 + r : delta, in ? 4 : 0);
    }
  };
  const size_t kv0 = static_cast<size_t>(bkv) * p.skv * d;
  load_tile<DP, BWD_TILE>(ks, k + kv0, k0, p.skv, d);
  load_tile<DP, BWD_TILE>(vs, v + kv0, k0, p.skv, d);
  int gi = -1, q0 = 0;
  bool have = next_q_tile(p, bkv, group, k0, kend, gi, q0);
  if (have) fetch(0, gi, q0);
  cp_async_commit();
  const float scale_log2 = p.scale * LOG2E;

  for (int n = 0; have; ++n) {
    int gn = gi, qn = q0;
    const bool more = next_q_tile(p, bkv, group, k0, kend, gn, qn);
    cp_async_wait<0>();
    __syncthreads();  // tile n (and K, V) has landed, and every warp is done with tile n - 1
    if (more) fetch((n + 1) % 2, gn, qn);
    cp_async_commit();
    if (warp_live) {
      const __nv_bfloat16* qs = ring + (n % 2) * 2 * BWD_TILE * ST;
      const float* lse_s = rows_s + (n % 2) * 2 * BWD_TILE;
      const int pos0 = (p.offs ? p.offs[bkv * group + gi] : p.off0) + q0;
      const int rows = min(BWD_TILE, p.sq - q0);
      // the warp's 16 keys against the tile's first and last real rows: none
      // visible to any row (skipped), or all to every row (no mask)
      int lo_first, hi_first, lo_last, hi_last;
      key_range(p, pos0, lo_first, hi_first);
      key_range(p, pos0 + rows - 1, lo_last, hi_last);
      if (hi_last > key0 && lo_first < key0 + 16) {
        const bool full = rows == BWD_TILE && lo_last <= key0 && hi_first >= key0 + 16;
#pragma unroll
        for (int c0 = 0; c0 < BWD_TILE; c0 += QC) {
          if (full)
            dkdv_part<DP, QC, false>(ks, vs, qs, qs + BWD_TILE * ST, lse_s, lse_s + BWD_TILE,
                                     dk_acc, dv_acc, p, pos0, rows, c0, key0, scale_log2);
          else
            dkdv_part<DP, QC, true>(ks, vs, qs, qs + BWD_TILE * ST, lse_s, lse_s + BWD_TILE,
                                    dk_acc, dv_acc, p, pos0, rows, c0, key0, scale_log2);
        }
      }
    }
    gi = gn;
    q0 = qn;
    have = more;
  }
  cp_async_wait<0>();

  // dk_acc[j][e]: key key0 + lane/4 (+ 8 for e >= 2), column 8j + 2(lane%4) + e%2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + lane / 4 + 8 * h;
    if (key >= p.skv) continue;
    const size_t at = kv0 + static_cast<size_t>(key) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < d) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) = __floats2bfloat162_rn(
            dk_acc[j][2 * h] * p.scale, dk_acc[j][2 * h + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(dv_acc[j][2 * h], dv_acc[j][2 * h + 1]);
      }
    }
  }
}

// One K/V tile of 64 keys against this warp's 16 q rows: S = Q K^T and dP =
// dO V^T on the tensor cores, P = exp(S scale - lse) (0 where MASK finds the
// key hidden), dS = P (dP - delta) rounded to bf16 as the A fragments of dQ
// += dS K (K's B fragments by ldmatrix.trans).  lse2: the lane's two rows'
// lse in the log2 domain (+inf past Sq), del their delta.
template <int DP, bool MASK>
__device__ __forceinline__ void dq_tile(const __nv_bfloat16* qs, const __nv_bfloat16* dos,
                                        const __nv_bfloat16* ks, const __nv_bfloat16* vs,
                                        const float (&lse2)[2], const float (&del)[2],
                                        float (&dq)[DP / 8][4], const Params& p,
                                        const int (&pos)[2], const bool (&in)[2], int kt0,
                                        float scale_log2) {
  constexpr int ST = mma_stride<DP>();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float s[BWD_TILE / 8][4], dp[BWD_TILE / 8][4];
#pragma unroll
  for (int j = 0; j < BWD_TILE / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    unsigned qa[4], oa[4];
    const int arow = (warp * 16 + lane % 16) * ST + kk * 16 + (lane / 16) * 8;
    ldmatrix_x4(qa, qs + arow);
    ldmatrix_x4(oa, dos + arow);
#pragma unroll
    for (int jp = 0; jp < BWD_TILE / 16; ++jp) {
      unsigned b[4];  // {b0, b1} of key tiles 2jp and 2jp + 1
      const int brow = (jp * 16 + lane % 8 + (lane / 16) * 8) * ST + kk * 16 + ((lane / 8) % 2) * 8;
      ldmatrix_x4(b, ks + brow);
      mma_bf16(s[2 * jp], qa, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
      ldmatrix_x4(b, vs + brow);
      mma_bf16(dp[2 * jp], oa, b[0], b[1]);
      mma_bf16(dp[2 * jp + 1], oa, b[2], b[3]);
    }
  }
  // s[j][e]: row lane/4 (+ 8 for e >= 2) of the warp's, key kt0 + 8j + 2(lane%4) + e%2
  unsigned sa[BWD_TILE / 16][4];
#pragma unroll
  for (int j = 0; j < BWD_TILE / 8; ++j) {
    float dsv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e / 2;
      float x = fast_exp2(fmaf(s[j][e], scale_log2, -lse2[h]));
      if (MASK && !(in[h] && key_visible(p, pos[h], kt0 + 8 * j + 2 * (lane % 4) + e % 2)))
        x = 0.f;
      dsv[e] = x * (dp[j][e] - del[h]);
    }
    sa[j / 2][(j % 2) * 2] = pack_bf16(dsv[0], dsv[1]);
    sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
  }
#pragma unroll
  for (int kk = 0; kk < BWD_TILE / 16; ++kk) {
    const int brow = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * ST + (lane / 16) * 8;
#pragma unroll
    for (int jp = 0; jp < DP / 16; ++jp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, ks + brow + jp * 16);
      mma_bf16(dq[2 * jp], sa[kk], b[0], b[1]);
      mma_bf16(dq[2 * jp + 1], sa[kk], b[2], b[3]);
    }
  }
}

// dQ of 64 rows of one q head: Q, dO, lse and delta stay resident; the K/V
// tiles of the union of the rows' visible keys stream through a 2-stage
// cp.async ring; dQ stays in fp32 registers, 16 rows a warp.
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, Params p) {
  constexpr int ST = mma_stride<DP>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][ST]
  __nv_bfloat16* dos = qs + BWD_TILE * ST;                          // [64][ST]
  __nv_bfloat16* kvs = dos + BWD_TILE * ST;                         // [stage][K, V][64][ST]
  const int head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BWD_TILE;  // the causal heaviest tile first
  const int group = p.bhq / p.bhkv, d = p.d;
  const int bkv = head / group;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int off = p.offs ? p.offs[head] : p.off0;
  const size_t base = static_cast<size_t>(head) * p.sq;
  const int last = min(q0 + BWD_TILE, p.sq) - 1;

  // the union of the block's rows' visible keys: a window's lower end and the
  // causal upper end rise with the row
  int lo_b, hi_b, unused;
  key_range(p, off + q0, lo_b, unused);
  key_range(p, off + last, unused, hi_b);
  // this warp's rows, and this lane's two of them
  const int w0 = q0 + warp * 16, w1 = min(w0 + 15, p.sq - 1);
  const bool warp_live = w0 < p.sq;
  int pos[2];
  bool in[2];
  float lse2[2], del[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = w0 + lane / 4 + 8 * h;
    in[h] = r < p.sq;
    pos[h] = off + r;
    lse2[h] = in[h] ? lse[base + r] * LOG2E : INFINITY;
    del[h] = in[h] ? delta[base + r] : 0.f;
  }
  int lo_first, hi_first, lo_last, hi_last;
  key_range(p, off + w0, lo_first, hi_first);
  key_range(p, off + w1, lo_last, hi_last);

  float acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const __nv_bfloat16* kb = k + static_cast<size_t>(bkv) * p.skv * d;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bkv) * p.skv * d;
  const int t0 = lo_b / BWD_TILE;
  const int t1 = hi_b > lo_b ? (hi_b + BWD_TILE - 1) / BWD_TILE : t0;
  if (t0 < t1) {
    load_tile<DP, BWD_TILE>(qs, q + base * d, q0, p.sq, d);
    load_tile<DP, BWD_TILE>(dos, dout + base * d, q0, p.sq, d);
    load_tile<DP, BWD_TILE>(kvs, kb, t0 * BWD_TILE, p.skv, d);
    load_tile<DP, BWD_TILE>(kvs + BWD_TILE * ST, vb, t0 * BWD_TILE, p.skv, d);
    cp_async_commit();
    const float scale_log2 = p.scale * LOG2E;
    for (int t = t0; t < t1; ++t) {
      cp_async_wait<0>();
      __syncthreads();  // tile t (and Q, dO) has landed, and every warp is done with tile t - 1
      if (t + 1 < t1) {
        __nv_bfloat16* nxt = kvs + ((t + 1 - t0) % 2) * 2 * BWD_TILE * ST;
        load_tile<DP, BWD_TILE>(nxt, kb, (t + 1) * BWD_TILE, p.skv, d);
        load_tile<DP, BWD_TILE>(nxt + BWD_TILE * ST, vb, (t + 1) * BWD_TILE, p.skv, d);
      }
      cp_async_commit();
      const int kt0 = t * BWD_TILE;
      // the tile's keys against the warp's first and last rows: none visible
      // (skipped), or all to every row (no mask)
      if (!warp_live || hi_last <= kt0 || lo_first >= kt0 + BWD_TILE) continue;
      const __nv_bfloat16* ks = kvs + ((t - t0) % 2) * 2 * BWD_TILE * ST;
      if (w1 == w0 + 15 && lo_last <= kt0 && hi_first >= kt0 + BWD_TILE)
        dq_tile<DP, false>(qs, dos, ks, ks + BWD_TILE * ST, lse2, del, acc, p, pos, in, kt0,
                           scale_log2);
      else
        dq_tile<DP, true>(qs, dos, ks, ks + BWD_TILE * ST, lse2, del, acc, p, pos, in, kt0,
                          scale_log2);
    }
    cp_async_wait<0>();
  }

  // acc[j][e]: row lane/4 (+ 8 for e >= 2) of the warp's, column 8j + 2(lane%4) + e%2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!in[h]) continue;
    __nv_bfloat16* row = dq + (base + w0 + lane / 4 + 8 * h) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[j][2 * h] * p.scale, acc[j][2 * h + 1] * p.scale);
    }
  }
}

template <int DP>
int launch_bwd_dp(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                  const float* delta, void* dq, void* dk, void* dv, const Params& p,
                  cudaStream_t stream) {
  constexpr int bytes = bwd_smem_bytes<DP>();
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  using bf = __nv_bfloat16;
  const auto* qp = static_cast<const bf*>(q);
  const auto* kp = static_cast<const bf*>(k);
  const auto* vp = static_cast<const bf*>(v);
  const auto* dop = static_cast<const bf*>(dout);
  // the causal heaviest key tiles (the first) are the first blocks
  const dim3 kv_grid(p.bhkv, (p.skv + BWD_TILE - 1) / BWD_TILE);
  flash_bwd_dkdv_kernel<DP><<<kv_grid, BWD_THREADS, bytes, stream>>>(
      qp, kp, vp, dop, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid(p.bhq, (p.sq + BWD_TILE - 1) / BWD_TILE);
  flash_bwd_dq_kernel<DP><<<q_grid, BWD_THREADS, bytes, stream>>>(qp, kp, vp, dop, lse, delta,
                                                                   static_cast<bf*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

int run_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
            const float* lse, void* dq, void* dk, void* dv, float* delta, const Params& p,
            void* stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
       reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) % 16 == 0;
  if (p.d < 8 || p.d > 128 || p.d % 8 != 0 || !aligned || p.bhkv < 1 || p.bhkv > 65535 ||
      p.bhq % p.bhkv != 0 || p.bhq > 65535 || p.sq < 1 || p.skv < p.sq ||
      (p.skv + BWD_TILE - 1) / BWD_TILE > 65535 || (p.sq + BWD_TILE - 1) / BWD_TILE > 65535 ||
      lse == nullptr || delta == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int rows = p.bhq * p.sq;
  flash_bwd_delta_kernel<<<(rows + 31) / 32, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, rows,
      p.d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return p.d <= 64 ? launch_bwd_dp<64>(q, k, v, dout, lse, delta, dq, dk, dv, p, s)
                   : launch_bwd_dp<128>(q, k, v, dout, lse, delta, dq, dk, dv, p, s);
}

}  // namespace

extern "C" int repro_flash_f32(const void* q, const void* k, const void* v, void* out,
                               const int* offs, int off0, int bhq, int bhkv, int sq, int skv,
                               int d, int causal, int has_window, int window, float scale,
                               int nwarps, void* stream) {
  return run(0, q, k, v, out, offs, off0, bhq, bhkv, sq, skv, d, causal, has_window, window,
             scale, nwarps, stream);
}

extern "C" int repro_flash_bf16(const void* q, const void* k, const void* v, void* out,
                                const int* offs, int off0, int bhq, int bhkv, int sq, int skv,
                                int d, int causal, int has_window, int window, float scale,
                                int nwarps, void* stream) {
  return run(1, q, k, v, out, offs, off0, bhq, bhkv, sq, skv, d, causal, has_window, window,
             scale, nwarps, stream);
}

// lse: null (serving), or fp32 (BHq, Sq) to receive each row's log-sum-exp of its scaled
// scores (+inf for a row that sees no key), what the backward needs.
extern "C" int repro_flash_mma_bf16(const void* q, const void* k, const void* v, void* out,
                                    const int* offs, int off0, int bhq, int bhkv, int sq, int skv,
                                    int d, int causal, int has_window, int window, float scale,
                                    void* lse, void* stream) {
  const Params p{offs,       off0,   bhq,    bhkv, sq, skv, d, causal, has_window,
                 window,     scale,  static_cast<float*>(lse)};
  return run_mma(q, k, v, out, p, stream);
}

// q (BHq, 1, D), k and v (BHkv, Skv, D) bf16 with D % 8 == 0, D <= 128, BHq / BHkv <= 16
// and 16-byte aligned pointers; chunk keys per block (a multiple of 64); ws and cnt as
// kernels/flash_attention.py allocates them (decode_workspace, arrival_counters).
extern "C" int repro_flash_decode_bf16(const void* q, const void* k, const void* v, void* out,
                                       const int* offs, int off0, int bhq, int bhkv, int skv,
                                       int d, int causal, int has_window, int window,
                                       float scale, int chunk, void* ws, void* cnt,
                                       void* stream) {
  const Params p{offs, off0, bhq, bhkv, 1, skv, d, causal, has_window, window, scale};
  return run_decode(q, k, v, out, p, chunk, static_cast<float*>(ws), static_cast<int*>(cnt),
                    stream);
}

// K5-bwd: q (BHq, Sq, D), k and v (BHkv, Skv, D), the forward's out and lse, the output
// gradient dout -> dq, dk, dv (bf16); delta is an fp32 (BHq, Sq) workspace.  bf16 with
// D % 8 == 0, D <= 128, Skv >= Sq and 16-byte aligned q, k, v, out, dout and outputs.
extern "C" int repro_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* out,
                                    const void* dout, const void* lse, void* dq, void* dk,
                                    void* dv, void* delta, const int* offs, int off0, int bhq,
                                    int bhkv, int sq, int skv, int d, int causal, int has_window,
                                    int window, float scale, void* stream) {
  const Params p{offs, off0, bhq, bhkv, sq, skv, d, causal, has_window, window, scale};
  return run_bwd(q, k, v, out, dout, static_cast<const float*>(lse), dq, dk, dv,
                 static_cast<float*>(delta), p, stream);
}
