// K5: hand-written forward flash attention for Hopper (sm_90a).
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
// * D is any size up to 256 (Danube's head is 120 wide): rows are handled
//   with masked loops over D, never padded in device memory.
//
// Design (a simple SIMT kernel; wgmma/TMA are later work): a block owns R = 4
// q rows that share one KV head (the GQA group's heads at a position first,
// then further positions), and its W warps split the KV range in chunks of
// 32 keys, chunk c going to warp c % W.  Within a chunk, lane j scores key j
// against all R rows (q rows staged in shared memory, 16-byte loads of K
// where D allows), the warp takes the chunk's max, rescales its running
// state, and then accumulates P.V with lanes spread over D.  At the end the
// W partial states are merged in shared memory in warp order, so results are
// deterministic.  W is 16 when there are few blocks (decode: one block per
// slot and KV head) and 4 otherwise.
//
// Bound: at a Danube prefill (32 heads, 2048 tokens, causal, D = 120) the
// work is ~32 GFLOP, 33 us at 989 TFLOP/s bf16; a decode step over 8 slots
// reads ~63 MB of KV at length 2048, 19 us at 3.35 TB/s.  This kernel runs
// on the CUDA cores and is far from the operation bound.
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
