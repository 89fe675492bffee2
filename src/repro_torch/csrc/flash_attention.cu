// K5: hand-written forward flash attention for Hopper (sm_90a): two kernels.
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
// flash_kernel (SIMT; decode, fp32, and whatever flash_mma_kernel does not
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
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

extern "C" int repro_flash_mma_bf16(const void* q, const void* k, const void* v, void* out,
                                    const int* offs, int off0, int bhq, int bhkv, int sq, int skv,
                                    int d, int causal, int has_window, int window, float scale,
                                    void* stream) {
  const Params p{offs, off0, bhq, bhkv, sq, skv, d, causal, has_window, window, scale};
  return run_mma(q, k, v, out, p, stream);
}
