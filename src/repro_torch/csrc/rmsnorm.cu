// K4: hand-written RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * gamma.
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm (the Pallas TPU kernel,
// pl.pallas_call at rmsnorm.py:41): x (R, D) row-major in float32 or bfloat16,
// gamma (D,) in x's type, all arithmetic in fp32 with gamma applied in fp32,
// the output in x's type.
//
// Bound: memory.  Each row is read and written once, so the least time is
// 2 * bytes(x) over 3.35 TB/s (2048 x 3840 bf16 at a Danube prefill bucket:
// 31.5 MB, 9.4 us).  A decode step's 8-16 rows move 0.1-0.3 MB: there the time
// is the latency of one row's loads, not bandwidth.
//
// rmsnorm_kernel (the model widths): a block owns a row at a time, so a
// decode step's rows land on as many SMs.  The row is cut into 16-byte
// chunks (8 bf16 or 4 fp32 values); thread i holds chunks i, i + T, i + 2T
// and i + 3T of the row and of gamma in registers (T threads, a multiple of
// 32, the fewest that cover the row with 4 chunks each: 128 for D = 3840 or
// 4096 in bf16, 256 for 4096 fp32), loaded with 16-byte loads.  Each thread
// sums its squares in chunk order, the warp by a shuffle tree, and warp 0
// adds the warps' sums in warp order, so the row's sum has one fixed order
// and every thread scales by the same r.  The row is read from device
// memory once and written once.  The grid is capped at 8 blocks an SM
// (BLOCKS_PER_SM); a block walks rows blockIdx.x, + gridDim.x, ..., keeps
// gamma in registers across them and has the next row's loads in flight
// while it reduces and writes this one.  It takes D a multiple of 8 (bf16)
// or 4 (fp32), at most 4 * 512 chunks (16,384 bf16 / 8,192 fp32 values), and
// 16-byte aligned x, gamma and out.
//
// rmsnorm_loop_kernel (everything else: D not a multiple of the chunk, an
// unaligned pointer, wider rows such as 12,288 fp32): one block of up to 256
// threads per row loops over the row element by element twice, summing then
// scaling (the second read comes from L1/L2), with the same fixed reduction.
//
// launch() picks the kernel and the block size before launch from D, the
// dtype and the pointers' alignment.
//
// K4-bwd, the gradient (no TPU kernel: the reference trains on XLA's gradient
// of its plain version, repro/kernels/ref.py; the card needs one for
// loss.backward()).  With r = rsqrt(mean(x^2) + eps) recomputed per row:
//   dx     = r * (gamma * dy) - x * r^3 * mean(x * gamma * dy)
//   dgamma = sum over rows of dy * x * r
// Bound: memory.  x and dy are read once and dx written once (MiniCPM-2B's
// 8192 x 2304 bf16 microbatch: 113 MB, 34 us at 3.35 TB/s); gamma and dgamma
// are one row each.  kernels/rmsnorm.py::bwd_plan picks the route, the row
// groups and the grid before launch.
// rmsnorm_bwd_vec_kernel (D a multiple of the 16-byte chunk, 16-byte aligned
// tensors: the model widths).  Its first version gave thread t the columns
// t + k * T as 2-byte loads, took one row at a time a block with three
// barriers between a row's loads and the next row's, and left 4 partial
// dgamma rows an SM (528, 4.9 MB of fp32 at D = 2304) for 9 blocks to add:
// 0.0855 ms at 8192 x 2304 bf16, 40% of the bound.  Now, as the forward:
// * A row is cut into 16-byte chunks (8 bf16 or 4 fp32) and a group of G
//   threads (G / 32 warps, the fewest at most 4 chunks a thread: one warp
//   at D = 1024 bf16, three at 2304, eight at 8192) holds its x and dy
//   chunks in registers, loaded and stored 16 bytes at a time.
// * A block is 512 / G such groups (row slots); slot s walks rows
//   blockIdx.x * slots + s, + gridDim.x * slots, ..., with the next row's x
//   and dy in flight while this row is reduced and written.
// * The two row sums (x^2, x * gamma * dy) go through a shuffle butterfly
//   (the same bits in every lane) and, over a slot's warps, one named
//   barrier a row on a double-buffered shared array that every thread reads
//   in warp order: one barrier a row, none at one warp.
// * gamma and dgamma's column sums live in shared memory, not registers,
//   so that two rows of chunks stay in flight within 128 registers (with
//   gamma in registers too, 4 chunks a thread spilled); the sums go over a
//   slot's rows in row order, and at the end the block adds its slots in
//   slot order into one partial row, so the grid (at most one block an SM)
//   leaves at most as many partial rows as SMs (132: 1.2 MB at D = 2304).
// rmsnorm_bwd_dgamma_kernel then spreads the last sum over the card: a block
// owns 32 columns, its 8 warps add every 8th partial row in order and warp 0
// adds the 8 sums in warp order.  Every order is fixed for a given shape and
// SM count, so dx and dgamma are bit-identical run to run; no float atomics.
// rmsnorm_bwd_kernel (everything else: D not a multiple of the chunk, an
// unaligned tensor): a block of T threads (T * 8 >= D) walks rows
// blockIdx.x, + gridDim.x, ...; thread t holds columns t + k * T (k < 8) in
// registers, the fixed-order block reduction, dgamma summed in registers over
// the block's rows, 4 blocks an SM, one partial row each, added by
// rmsnorm_bwd_dgamma_kernel.  Both take D <= 8192 (the model widths:
// 1024-8192).
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int CHUNKS = 4;          // 16-byte chunks of the row a thread holds
constexpr int MAX_THREADS = 512;   // threads of one row's block (128 registers each)
constexpr int BLOCKS_PER_SM = 8;   // grid cap, in blocks per SM
constexpr int LOOP_THREADS = 256;

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

// 16 bytes of T
template <typename T>
struct __align__(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// The block's sum of v in a fixed order (each warp by a shuffle tree, then
// warp 0 over the warps' sums in warp order); every thread gets the same value.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[MAX_THREADS / 32];
  __shared__ float total;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
    float s = lane < warps ? part[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

template <typename T>
__device__ __forceinline__ void load_row(Vec<T> (&r)[CHUNKS], const Vec<T>* v, int chunks) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) r[i] = v[c];
  }
}

// rows blockIdx.x, blockIdx.x + gridDim.x, ...: gamma is loaded once, and the
// next row's loads are in flight while this row is reduced and written.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
               int rows, int d, float eps) {
  constexpr int N = Vec<T>::N;
  const int chunks = d / N;
  Vec<T> xr[CHUNKS], xn[CHUNKS], gr[CHUNKS];
  load_row(gr, reinterpret_cast<const Vec<T>*>(gamma), chunks);
  size_t row = blockIdx.x;
  load_row(xr, reinterpret_cast<const Vec<T>*>(x + row * d), chunks);
  for (; row < static_cast<size_t>(rows); row += gridDim.x) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      if (threadIdx.x + i * blockDim.x < chunks) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float f = to_f32(xr[i].v[e]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    const size_t next = row + gridDim.x;
    if (next < static_cast<size_t>(rows))
      load_row(xn, reinterpret_cast<const Vec<T>*>(x + next * d), chunks);
    const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(out + row * d);
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        Vec<T> res;
#pragma unroll
        for (int e = 0; e < N; ++e)
          res.v[e] = from_f32<T>(to_f32(xr[i].v[e]) * r * to_f32(gr[i].v[e]));
        ov[c] = res;
      }
      xr[i] = xn[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(LOOP_THREADS)
rmsnorm_loop_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
                    int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* outr = out + row * d;
  float ss = 0.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float f = to_f32(xr[c]);
    ss = fmaf(f, f, ss);
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(d) + eps);
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    outr[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(gamma[c]));
}

template <typename T>
int launch(const void* x, const void* gamma, void* out, int rows, int d, float eps,
           void* stream) {
  constexpr int N = Vec<T>::N;
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const T*>(gamma);
  auto* op = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = d / N;
  const bool vec = d % N == 0 && chunks <= CHUNKS * MAX_THREADS &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gamma) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    const int per = (chunks + CHUNKS - 1) / CHUNKS;       // threads that cover the row
    const int threads = per < 32 ? 32 : (per + 31) / 32 * 32;
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int cap = sms * BLOCKS_PER_SM;
    rmsnorm_kernel<T><<<rows < cap ? rows : cap, threads, 0, s>>>(xp, gp, op, rows, d, eps);
  } else {
    const int threads = d >= LOOP_THREADS ? LOOP_THREADS : (d + 31) / 32 * 32;
    rmsnorm_loop_kernel<T><<<rows, threads, 0, s>>>(xp, gp, op, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr int BWD_COLS = 8;          // columns of the row a thread holds (K4-bwd)
constexpr int BWD_MAX_THREADS = 1024;

// The block's sums of a and b, in the fixed order of block_sum.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[BWD_MAX_THREADS / 32];
  __shared__ float2 total;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x / 32;
    float sa = lane < warps ? part[lane].x : 0.f;
    float sb = lane < warps ? part[lane].y : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sa += __shfl_down_sync(0xffffffffu, sa, o);
      sb += __shfl_down_sync(0xffffffffu, sb, o);
    }
    if (lane == 0) total = make_float2(sa, sb);
  }
  __syncthreads();
  const float2 t = total;
  __syncthreads();  // total is read by every thread before the next row overwrites it
  return t;
}

template <typename T>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part, int rows, int d, float eps) {
  float g[BWD_COLS], acc[BWD_COLS];
#pragma unroll
  for (int k = 0; k < BWD_COLS; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    g[k] = c < d ? to_f32(gamma[c]) : 0.f;
    acc[k] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (size_t row = blockIdx.x; row < static_cast<size_t>(rows); row += gridDim.x) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    float xv[BWD_COLS], dv[BWD_COLS];
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < BWD_COLS; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      xv[k] = c < d ? to_f32(xr[c]) : 0.f;
      dv[k] = c < d ? to_f32(dyr[c]) : 0.f;
      ss = fmaf(xv[k], xv[k], ss);
      sd = fmaf(xv[k] * g[k], dv[k], sd);
    }
    const float2 tot = block_sum2(ss, sd);
    const float r = rsqrtf(tot.x * inv_d + eps);
    const float c3 = r * r * r * (tot.y * inv_d);
    T* dxr = dx + row * d;
#pragma unroll
    for (int k = 0; k < BWD_COLS; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c < d) {
        dxr[c] = from_f32<T>(r * (g[k] * dv[k]) - xv[k] * c3);
        acc[k] = fmaf(dv[k], xv[k] * r, acc[k]);
      }
    }
  }
  float* pr = part + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int k = 0; k < BWD_COLS; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c < d) pr[c] = acc[k];
  }
}

constexpr int BWD_BLOCK = 512;   // threads of a rmsnorm_bwd_vec_kernel block: its row slots
constexpr int BWD_CHUNKS = 4;    // 16-byte chunks of a row a thread holds, at most
constexpr int DG_WARPS = 8;      // rmsnorm_bwd_dgamma_kernel: warps a block, 32 columns

// one row's chunks of x and dy
template <typename T, int CH>
__device__ __forceinline__ void load_pair(Vec<T> (&xr)[CH], Vec<T> (&dr)[CH], const T* x,
                                          const T* dy, size_t row, int d, int t, int group,
                                          int chunks) {
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x + row * d);
  const Vec<T>* dv = reinterpret_cast<const Vec<T>*>(dy + row * d);
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + i * group;
    if (c < chunks) {
      xr[i] = xv[c];
      dr[i] = dv[c];
    }
  }
}

// rows of slot s: blockIdx.x * slots + s, + gridDim.x * slots, ...; part
// gets the block's dgamma row (its slots added in slot order).
template <typename T, int CH>
__global__ void __launch_bounds__(BWD_BLOCK, 1)
rmsnorm_bwd_vec_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
                       int rows, int d, int group, float eps) {
  constexpr int N = Vec<T>::N;
  // shared: [slots][d] fp32 dgamma sums, gamma's d values, [slots][2][warps] row sums
  extern __shared__ __align__(16) float bwd_smem[];
  const int slots = blockDim.x / group, slot = threadIdx.x / group, t = threadIdx.x % group;
  const int warps = group / 32, warp = t / 32, lane = t % 32;
  const int chunks = d / N;
  float* acc = bwd_smem + static_cast<size_t>(slot) * d;
  Vec<T>* gs = reinterpret_cast<Vec<T>*>(bwd_smem + static_cast<size_t>(slots) * d);
  float2* red = reinterpret_cast<float2*>(gs + chunks) + 2 * slot * warps;

  // gamma in shared memory, not registers: two rows of chunks stay in flight
  // within 128 registers at 4 chunks a thread
  const Vec<T>* gv = reinterpret_cast<const Vec<T>*>(gamma);
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) gs[c] = gv[c];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = t + i * group;
    if (c < chunks) {
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(acc + c * N + j) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const float inv_d = 1.f / static_cast<float>(d);
  const size_t stride = static_cast<size_t>(gridDim.x) * slots;
  size_t row = static_cast<size_t>(blockIdx.x) * slots + slot;
  Vec<T> xr[CH], dr[CH], xn[CH], dn[CH];
  if (row < static_cast<size_t>(rows)) load_pair(xr, dr, x, dy, row, d, t, group, chunks);
  for (int it = 0; row < static_cast<size_t>(rows); row += stride, ++it) {
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      if (t + i * group < chunks) {
        const Vec<T> g = gs[t + i * group];
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xf = to_f32(xr[i].v[e]);
          ss = fmaf(xf, xf, ss);
          sd = fmaf(xf * to_f32(g.v[e]), to_f32(dr[i].v[e]), sd);
        }
      }
    }
    const size_t next = row + stride;
    if (next < static_cast<size_t>(rows)) load_pair(xn, dn, x, dy, next, d, t, group, chunks);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {  // a butterfly: every lane ends with the same bits
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      sd += __shfl_xor_sync(0xffffffffu, sd, o);
    }
    if (warps > 1) {  // the slot's warps in warp order; the buffer alternates by row
      float2* buf = red + (it & 1) * warps;
      if (lane == 0) buf[warp] = make_float2(ss, sd);
      asm volatile("bar.sync %0, %1;\n" ::"r"(slot + 1), "r"(group) : "memory");
      float2 tot = buf[0];
      for (int w = 1; w < warps; ++w) {
        const float2 b = buf[w];
        tot.x += b.x;
        tot.y += b.y;
      }
      ss = tot.x;
      sd = tot.y;
    }
    const float r = rsqrtf(ss * inv_d + eps);
    const float c3 = r * r * r * (sd * inv_d);
    Vec<T>* dxv = reinterpret_cast<Vec<T>*>(dx + row * d);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = t + i * group;
      if (c < chunks) {
        float a[N];
#pragma unroll
        for (int j = 0; j < N; j += 4) {
          const float4 v = *reinterpret_cast<const float4*>(acc + c * N + j);
          a[j] = v.x;
          a[j + 1] = v.y;
          a[j + 2] = v.z;
          a[j + 3] = v.w;
        }
        const Vec<T> g = gs[c];
        Vec<T> res;
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float xf = to_f32(xr[i].v[e]), df = to_f32(dr[i].v[e]);
          res.v[e] = from_f32<T>(r * (to_f32(g.v[e]) * df) - xf * c3);
          a[e] = fmaf(df, xf * r, a[e]);
        }
        dxv[c] = res;
#pragma unroll
        for (int j = 0; j < N; j += 4)
          *reinterpret_cast<float4*>(acc + c * N + j) =
              make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
      }
      xr[i] = xn[i];
      dr[i] = dn[i];
    }
  }
  __syncthreads();  // every slot's dgamma row is in shared memory
  float* pr = part + static_cast<size_t>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = bwd_smem[c];
    for (int q = 1; q < slots; ++q) sum += bwd_smem[static_cast<size_t>(q) * d + c];
    pr[c] = sum;
  }
}

// dgamma[c] = the partial rows' column c, warp w adding rows w, w + 8, ... in
// order, then warp 0 the 8 sums in warp order: a block owns 32 columns.
template <typename T>
__global__ void __launch_bounds__(DG_WARPS * 32)
rmsnorm_bwd_dgamma_kernel(const float* __restrict__ part, T* __restrict__ dgamma, int blocks,
                          int d) {
  __shared__ float sums[DG_WARPS][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += DG_WARPS) s += part[static_cast<size_t>(b) * d + c];
  }
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float tot = sums[0][lane];
#pragma unroll
    for (int w = 1; w < DG_WARPS; ++w) tot += sums[w][lane];
    dgamma[c] = from_f32<T>(tot);
  }
}

template <typename T, int CH>
int launch_bwd_vec(const T* x, const T* gamma, const T* dy, T* dx, float* part, int rows, int d,
                   int group, int blocks, float eps, cudaStream_t s) {
  constexpr int most_d = BWD_BLOCK * BWD_CHUNKS * Vec<T>::N;  // slots * d and d at most
  constexpr int most = most_d * 4 + most_d * static_cast<int>(sizeof(T)) + BWD_BLOCK / 32 * 2 * 8;
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_vec_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int slots = BWD_BLOCK / group;
  const size_t bytes = static_cast<size_t>(slots) * d * 4 + static_cast<size_t>(d) * sizeof(T) +
                       slots * 2 * (group / 32) * 8;
  rmsnorm_bwd_vec_kernel<T, CH><<<blocks, slots * group, bytes, s>>>(x, gamma, dy, dx, part, rows,
                                                                     d, group, eps);
  return static_cast<int>(cudaGetLastError());
}

// group 0: rmsnorm_bwd_kernel; else rmsnorm_bwd_vec_kernel with row groups of
// `group` threads, BWD_BLOCK / group of them a block.  blocks partial rows.
template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* dy, void* dx, void* dgamma,
               void* part, int rows, int d, int blocks, int group, float eps, void* stream) {
  constexpr int N = Vec<T>::N;
  if (d < 1 || d > BWD_COLS * BWD_MAX_THREADS || rows < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const T*>(gamma);
  const auto* dyp = static_cast<const T*>(dy);
  auto* dxp = static_cast<T*>(dx);
  auto* pp = static_cast<float*>(part);
  int err;
  if (group == 0) {
    if (blocks > rows) return static_cast<int>(cudaErrorInvalidValue);
    const int per = (d + BWD_COLS - 1) / BWD_COLS;
    const int threads = (per + 31) / 32 * 32;
    rmsnorm_bwd_kernel<T><<<blocks, threads, 0, s>>>(xp, gp, dyp, dxp, pp, rows, d, eps);
    err = static_cast<int>(cudaGetLastError());
  } else {
    const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(gamma) |
                          reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx)) %
                             16 == 0;
    const int chunks = d / N;
    const int ch = (chunks + group - 1) / group;
    const int slots = group <= BWD_BLOCK ? BWD_BLOCK / group : 0;
    if (!aligned || d % N != 0 || group % 32 != 0 || slots < 1 || ch < 1 || ch > BWD_CHUNKS ||
        (group > 32 && slots > 15) || blocks > (rows + slots - 1) / slots)
      return static_cast<int>(cudaErrorInvalidValue);
    const auto vec = ch == 1 ? &launch_bwd_vec<T, 1>
                     : ch == 2 ? &launch_bwd_vec<T, 2>
                     : ch == 3 ? &launch_bwd_vec<T, 3>
                               : &launch_bwd_vec<T, 4>;
    err = vec(xp, gp, dyp, dxp, pp, rows, d, group, blocks, eps, s);
  }
  if (err != 0) return err;
  rmsnorm_bwd_dgamma_kernel<T><<<(d + 31) / 32, DG_WARPS * 32, 0, s>>>(
      pp, static_cast<T*>(dgamma), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4-bwd: x, gamma, dy -> dx, dgamma; part is an fp32 workspace of blocks x d
// (kernels/rmsnorm.py allocates it and bwd_plan picks blocks and group: 0
// for rmsnorm_bwd_kernel, else the vector kernel's threads a row).
extern "C" int repro_rmsnorm_bwd_f32(const void* x, const void* g, const void* dy, void* dx,
                                     void* dg, void* part, int rows, int d, int blocks, int group,
                                     float eps, void* stream) {
  return launch_bwd<float>(x, g, dy, dx, dg, part, rows, d, blocks, group, eps, stream);
}

extern "C" int repro_rmsnorm_bwd_bf16(const void* x, const void* g, const void* dy, void* dx,
                                      void* dg, void* part, int rows, int d, int blocks,
                                      int group, float eps, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dy, dx, dg, part, rows, d, blocks, group, eps, stream);
}

extern "C" int repro_rmsnorm_f32(const void* x, const void* g, void* out, int rows, int d,
                                 float eps, void* stream) {
  return launch<float>(x, g, out, rows, d, eps, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* g, void* out, int rows, int d,
                                  float eps, void* stream) {
  return launch<__nv_bfloat16>(x, g, out, rows, d, eps, stream);
}
