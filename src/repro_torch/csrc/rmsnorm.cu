// K4: hand-written RMSNorm for Hopper (sm_90a): out = x * rsqrt(mean(x^2) + eps) * gamma.
//
// Replaces repro/kernels/rmsnorm.py::rmsnorm (the Pallas TPU kernel,
// pl.pallas_call at rmsnorm.py:41): x (R, D) row-major in float32 or bfloat16,
// gamma (D,) in x's type, all arithmetic in fp32 with gamma applied in fp32,
// the output in x's type.
//
// Bound: memory.  Each row is read and written once, so the least time is
// 2 * bytes(x) over 3.35 TB/s (2048 x 3840 bf16 at a Danube prefill: 31.5 MB,
// 9.4 us).  The TPU kernel kept a whole (256, D) row block in VMEM; here one
// warp owns one row and a block holds ROWS warps.  Pass 1 sums x^2 with
// 16-byte loads where the row allows them (D a multiple of 4 fp32 / 8 bf16
// values) and reduces across the warp with shuffles; pass 2 reads the row
// again (from L1/L2: a row is at most 48 KB) and writes x * r * gamma.  The
// warp's sum order is fixed, so results are deterministic.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int ROWS = 8;  // warps (rows) per block

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
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(ROWS * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma, T* __restrict__ out,
               int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* outr = out + static_cast<size_t>(row) * d;
  constexpr int N = Vec<T>::N;

  float ss = 0.f;
  if (VEC) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    for (int c = lane; c < d / N; c += 32) {
      const Vec<T> chunk = xv[c];
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float f = to_f32(chunk.v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = to_f32(xr[c]);
      ss = fmaf(f, f, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (VEC) {
    const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(xr);
    Vec<T>* ov = reinterpret_cast<Vec<T>*>(outr);
    for (int c = lane; c < d / N; c += 32) {
      const Vec<T> chunk = xv[c];
      Vec<T> res;
#pragma unroll
      for (int e = 0; e < N; ++e)
        res.v[e] = from_f32<T>(to_f32(chunk.v[e]) * r * to_f32(gamma[c * N + e]));
      ov[c] = res;
    }
  } else {
    for (int c = lane; c < d; c += 32)
      outr[c] = from_f32<T>(to_f32(xr[c]) * r * to_f32(gamma[c]));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, void* out, int rows, int d, float eps,
           void* stream) {
  const dim3 grid((rows + ROWS - 1) / ROWS);
  const auto* xp = static_cast<const T*>(x);
  const auto* gp = static_cast<const T*>(gamma);
  auto* op = static_cast<T*>(out);
  const bool vec = d % Vec<T>::N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    rmsnorm_kernel<T, true><<<grid, ROWS * 32, 0, s>>>(xp, gp, op, rows, d, eps);
  else
    rmsnorm_kernel<T, false><<<grid, ROWS * 32, 0, s>>>(xp, gp, op, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_rmsnorm_f32(const void* x, const void* g, void* out, int rows, int d,
                                 float eps, void* stream) {
  return launch<float>(x, g, out, rows, d, eps, stream);
}

extern "C" int repro_rmsnorm_bf16(const void* x, const void* g, void* out, int rows, int d,
                                  float eps, void* stream) {
  return launch<__nv_bfloat16>(x, g, out, rows, d, eps, stream);
}
