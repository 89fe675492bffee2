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
// are one row each.
// rmsnorm_bwd_kernel: a block of T threads (a multiple of 32, T * 8 >= D)
// walks rows blockIdx.x, + gridDim.x, ...; thread t holds columns t + k * T
// (k < 8) of x, dy and gamma in registers, the two row sums (x^2 and
// x * gamma * dy) go through the same fixed-order block reduction as the
// forward, and its dgamma columns are summed in registers over the block's
// rows, in row order.  Each block then stores its partial dgamma row to an
// fp32 workspace, and rmsnorm_dgamma_kernel adds the partials of each column
// in block order and writes dgamma in gamma's type: the sum has one order for
// a given shape and SM count, so dgamma is bit-identical run to run, and no
// float atomics are used.  It takes any D <= 8 * 1024 = 8192 (the model
// widths: 1024-8192) and any alignment.
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

// dgamma[c] = the blocks' partials of column c, added in block order
template <typename T>
__global__ void rmsnorm_dgamma_kernel(const float* __restrict__ part, T* __restrict__ dgamma,
                                      int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<size_t>(b) * d + c];
  dgamma[c] = from_f32<T>(s);
}

template <typename T>
int launch_bwd(const void* x, const void* gamma, const void* dy, void* dx, void* dgamma,
               void* part, int rows, int d, int blocks, float eps, void* stream) {
  if (d < 1 || d > BWD_COLS * BWD_MAX_THREADS || rows < 1 || blocks < 1 || blocks > rows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (d + BWD_COLS - 1) / BWD_COLS;
  const int threads = (per + 31) / 32 * 32;
  rmsnorm_bwd_kernel<T><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(part), rows, d, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dgamma_kernel<T><<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                           static_cast<T*>(dgamma), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4-bwd: x, gamma, dy -> dx, dgamma; part is an fp32 workspace of blocks x d
// (kernels/rmsnorm.py allocates it), blocks <= rows.
extern "C" int repro_rmsnorm_bwd_f32(const void* x, const void* g, const void* dy, void* dx,
                                     void* dg, void* part, int rows, int d, int blocks,
                                     float eps, void* stream) {
  return launch_bwd<float>(x, g, dy, dx, dg, part, rows, d, blocks, eps, stream);
}

extern "C" int repro_rmsnorm_bwd_bf16(const void* x, const void* g, const void* dy, void* dx,
                                      void* dg, void* part, int rows, int d, int blocks,
                                      float eps, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g, dy, dx, dg, part, rows, d, blocks, eps, stream);
}

extern "C" int repro_rmsnorm_f32(const void* x, const void* g, void* out, int rows, int d,
                                 float eps, void* stream) {
  return launch<float>(x, g, out, rows, d, eps, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* g, void* out, int rows, int d,
                                  float eps, void* stream) {
  return launch<__nv_bfloat16>(x, g, out, rows, d, eps, stream);
}
