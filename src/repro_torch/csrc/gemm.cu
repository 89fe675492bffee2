// K1: hand-written GEMM for Hopper (sm_90a), out = x @ y.
//
// Replaces repro/kernels/gemm.py::gemm (the Pallas TPU GEMM, pl.pallas_call at
// gemm.py:65): row-major x (M, K) and y (K, N) in float32 or bfloat16, an fp32
// accumulator, the output in the input type.
//
// Design: a tiled SIMT GEMM.  Each block of 256 threads owns a 64x64 output
// tile; K is walked in slices of 16 staged through shared memory (x stored
// transposed so a thread's column of x is contiguous), and each thread keeps a
// 4x4 register tile, its rows and columns strided by 16 so that neighbouring
// threads store neighbouring output columns.  Ragged edges are masked inside
// the kernel (zero fill on load, no store out of range), so no padded copies
// are made.  Products accumulate with fmaf in full fp32, in K order: there is
// no TF32 path, so fp32 results meet the reference's 2e-4 tolerance.
//
// Bound: at the PolyBench LARGE gemm (1000 x 1100 x 1200, 2.64 GFLOP) the work
// is compute bound.  Outside the tensor cores the H100 SXM peaks at 67 TFLOP/s
// fp32, about 39 us for this product; its operands and output move 14.5 MB,
// about 4.3 us at 3.35 TB/s.  This simple kernel does not approach that peak: wgmma, TMA and
// pipelining are left to later work.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;                          // keeps shared rows off one bank

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
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
            int m, int n, int k) {
  __shared__ float xs[BK][BM + PAD];  // x tile, transposed: xs[kk][row]
  __shared__ float ys[BK][BN + PAD];  // y tile: ys[kk][col]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < m && gc < k) ? to_f32(x[static_cast<size_t>(gr) * k + gc]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r, gc = col0 + c;
      ys[r][c] = (gr < k && gc < n) ? to_f32(y[static_cast<size_t>(gr) * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + (BM / TM) * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[kk][tx + (BN / TN) * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + (BM / TM) * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + (BN / TN) * j;
      if (c < n) out[static_cast<size_t>(r) * n + c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* y, void* out, int m, int n, int k, void* stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  gemm_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_gemm_f32(const void* x, const void* y, void* out, int m, int n, int k,
                              void* stream) {
  return launch<float>(x, y, out, m, n, k, stream);
}

extern "C" int repro_gemm_bf16(const void* x, const void* y, void* out, int m, int n, int k,
                               void* stream) {
  return launch<__nv_bfloat16>(x, y, out, m, n, k, stream);
}
