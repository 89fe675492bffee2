// K1: hand-written GEMM for Hopper (sm_90a), out = x @ y.
//
// Replaces repro/kernels/gemm.py::gemm (the Pallas TPU GEMM, pl.pallas_call at
// gemm.py:65): row-major x (M, K) and y (K, N) in float32 or bfloat16, an fp32
// accumulator, the output in the input type.
//
// float32: gemm_tf32x3_kernel, on the tensor cores with error-compensated TF32.
//
// Bound: at the PolyBench LARGE gemm (1000 x 1100 x 1200, 2.64 GFLOP) the work
// is bound by operations.  One TF32 pass (10 mantissa bits) misses the
// reference's 2e-4 tolerance on random data, so each operand a is split into
// big = tf32(a) and small = tf32(a - big), and three passes, small.big,
// big.small, then big.big, go into one fp32 accumulator ("3xTF32"; within
// about 1e-6 of the fp64 product).  Three passes at the H100's 495 TFLOP/s
// dense TF32 take at least 16 us for this product; the fp32 pipes outside the
// tensor cores (67 TFLOP/s) at least 39 us; the operands and output move
// 14.5 MB, 4.3 us at 3.35 TB/s.
//
// Design: mma.sync.aligned.m16n8k8 (tf32 in, fp32 accumulate).  wgmma would
// take TF32 only with both operands K-major, and y is (K, N) row-major, so it
// would need a transposed copy of y.  A block of 8 warps owns a 128 x 64
// output tile, each warp 32 x 32 (2 x 4 fragments of 16 x 8).  x and y are
// staged through a ring of 3 shared-memory stages of 32-deep K slices with
// cp.async, 16-byte copies when K and N are multiples of 4 and the pointers
// 16-byte aligned, 4-byte copies otherwise; cp.async zero-fills rows and
// columns past M, N and K, so K need not be a multiple of 8 and no padded
// copy is made.  Rows of the stages are padded (x by 4 floats, y by 8) so a
// warp's fragment loads hit 32 distinct banks.  The big/small split is made
// once per fragment element as it is loaded from shared memory; an element
// that is not finite gets small = 0 and takes no part in the cross terms, so
// an inf operand gives inf and not NaN (split_tf32).
//
// What bounds it here: the split costs about 10 integer and fp32 instructions
// per fragment element, which compete with the loads and the mma for issue
// slots.  Warps are 32 x 32 because 64 x 32 needs more than 255 registers for
// the three values of each fragment element, and spills.
//
// Filling the card: 128 x 64 tiles (not 128 x 128) because the main path's
// products are small for 132 SMs: 1000 x 1100 gives 144 tiles (72 at
// 128 x 128), and a 64-wide N tile wastes 17% at doitgen's N = 160 (a
// 128-wide one 37.5%).  When the tiles leave SMs idle or unevenly loaded, K is
// split into S contiguous ranges of slices (kernels/gemm.py::gemm_splits picks
// S before launch: 4 at the LARGE gemm's 144 tiles, 1 at doitgen's 495).
// Each range writes its fp32 partial tile to a workspace, and the last block
// of a tile to arrive (an int32 arrival counter per tile, the only atomic,
// reset by that block) adds the S partials in range order and writes the
// output: the result is the same bits from run to run whichever block
// arrives last.
//
// bfloat16 does not come here: kernels/gemm.py launches K6's bf16 kernels in
// moe_gmm.cu at E = 1, a dense product being a grouped product with one
// expert (as K6's float32 path launches this file's kernel with the expert
// as its batch).  That route, and not a header shared by two sources, keeps
// one copy of the tile code, one nvcc per source, and the build's key (a
// hash of the .cu) complete.  Bound: at LLaVA's 2048-token q_proj (2048 x
// 4096 @ 4096 x 4096, 68.7 GFLOP) 0.0695 ms at 989 TFLOP/s bf16, bound by
// operations.  The SIMT kernel it replaces (fmaf on the CUDA cores, 67
// TFLOP/s at best, operands through shared memory with no asynchronous
// copies) took 3.52 ms there, 2% of the bound.  moe_gmm_wgmma_kernel (M >=
// 32; K and N multiples of 8, 16-byte aligned operands: TMA's strides and
// addresses) runs K6's prefill pipeline: wgmma m64n256k16 with fp32
// accumulators, 128 x 256 tiles, a TMA producer warp, a 4-stage mbarrier
// ring, the 128-byte swizzle, y (K, N) read as an MN-major B through the
// transpose bit, one block a tile over all of K (bit-identical run to run),
// every M tile of one N tile before the next (grouped rasters of 8 or 4 M
// tiles were no faster at LLaVA's q_proj and ffn_in, PERF.md).
// moe_gmm_decode_kernel (M < 32) streams y by TMA; moe_gmm_bf16_kernel (K or
// N not a multiple of 8, an unaligned operand, K = 0) masks any shape on
// mma.sync.
//
// Batches: grid z walks a batch of independent products of one shape
// (x (B, M, K), y (B, K, N), out (B, M, N), each row-major and contiguous),
// times the K ranges in fp32.  K1 launches one; K6's float32 path
// (kernels/moe_gmm.py) launches one per expert.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync
// ---------------------------------------------------------------------------
constexpr int TBM = 128;          // block tile rows (M)
constexpr int TBN = 64;           // block tile columns (N)
constexpr int TBK = 32;           // K slice per stage
constexpr int TSTAGES = 3;        // cp.async ring depth
constexpr int TWM = 32;           // warp tile rows
constexpr int TWN = 32;           // warp tile columns
constexpr int MI = TWM / 16;      // m16 fragments per warp
constexpr int NI = TWN / 8;       // n8 fragments per warp
constexpr int TWARPS = (TBM / TWM) * (TBN / TWN);  // 8
constexpr int TTHREADS = TWARPS * 32;              // 256
constexpr int XS = TBK + 4;       // x stage row stride (floats): 4g + t hits 32 banks
constexpr int YS = TBN + 8;       // y stage row stride (floats): 8t + g hits 32 banks
constexpr int X_STAGE = TBM * XS;
constexpr int Y_STAGE = TBK * YS;
constexpr size_t TF32_SMEM = sizeof(float) * TSTAGES * (X_STAGE + Y_STAGE);  // 82,944 B

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// big = tf32(a), small = tf32(a - big), and cross, the big that the cross
// terms (small.big, big.small) take.  tf32() rounds as cvt.rna.tf32.f32 does
// (the magnitude to 10 mantissa bits, to nearest, ties away from zero), by
// adding half a unit of the 13 dropped bits to the bit pattern and clearing
// them, in integer instructions, which issue at a higher rate than cvt's:
// the same bits as cvt for every value but NaN, whose payload the addition
// can carry into the exponent or the sign (0x7fffffff, the NaN that CUDA's
// arithmetic makes, would become -0), so a NaN's big is TF32_NAN instead.
// Where a - big is not finite (a = +-inf or NaN, or a rounding up past the
// largest finite value) small = cross = 0: the cross terms then add 0, and
// inf times another operand's small part, which is 0 wherever that operand
// is exact in TF32, cannot make a NaN; big.big alone carries the inf or NaN.
constexpr unsigned TF32_NAN = 0x7fffe000u;  // a NaN with the 13 low bits clear

__device__ __forceinline__ unsigned tf32(float a) {  // a not NaN
  return (__float_as_uint(a) + 0x1000u) & ~0x1fffu;
}

__device__ __forceinline__ void split_tf32(float a, unsigned& big, unsigned& small,
                                           unsigned& cross) {
  big = a != a ? TF32_NAN : tf32(a);
  const float d = a - __uint_as_float(big);
  const bool finite = fabsf(d) <= FLT_MAX;
  small = tf32(finite ? d : 0.f);
  cross = finite ? big : 0u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage K slice [k0, k0 + TBK) of x's rows [row0, row0 + TBM) and y's columns
// [col0, col0 + TBN); out-of-range elements are zero-filled.
template <bool VEC>
__device__ __forceinline__ void load_slice(float* xs, float* ys, const float* x, const float* y,
                                           int m, int n, int k, int row0, int col0, int k0) {
  const int tid = threadIdx.x;
  if (VEC) {  // K % 4 == 0 and N % 4 == 0: a 16-byte chunk is all in or all out
#pragma unroll
    for (int i = 0; i < TBM * TBK / 4 / TTHREADS; ++i) {
      const int id = tid + i * TTHREADS;
      const int r = id / (TBK / 4), c = (id % (TBK / 4)) * 4;
      const bool in = row0 + r < m && k0 + c < k;
      cp_async16(xs + r * XS + c, in ? x + static_cast<size_t>(row0 + r) * k + k0 + c : x, in);
    }
#pragma unroll
    for (int i = 0; i < TBK * TBN / 4 / TTHREADS; ++i) {
      const int id = tid + i * TTHREADS;
      const int r = id / (TBN / 4), c = (id % (TBN / 4)) * 4;
      const bool in = k0 + r < k && col0 + c < n;
      cp_async16(ys + r * YS + c, in ? y + static_cast<size_t>(k0 + r) * n + col0 + c : y, in);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < TBM * TBK / TTHREADS; ++i) {
      const int id = tid + i * TTHREADS;
      const int r = id / TBK, c = id % TBK;
      const bool in = row0 + r < m && k0 + c < k;
      cp_async4(xs + r * XS + c, in ? x + static_cast<size_t>(row0 + r) * k + k0 + c : x, in);
    }
#pragma unroll 4
    for (int i = 0; i < TBK * TBN / TTHREADS; ++i) {
      const int id = tid + i * TTHREADS;
      const int r = id / TBN, c = id % TBN;
      const bool in = k0 + r < k && col0 + c < n;
      cp_async4(ys + r * YS + c, in ? y + static_cast<size_t>(k0 + r) * n + col0 + c : y, in);
    }
  }
}

// grid (N tiles, M tiles, batch * splits); z = blockIdx.z / splits is the
// product, blockIdx.z % splits the K range.  ws holds splits * batch partial
// products (M, N) and cnt one counter per (product, tile) when splits > 1.
template <bool VEC>
__global__ void __launch_bounds__(TTHREADS, 2)
gemm_tf32x3_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out, int m, int n, int k, int splits,
                   float* __restrict__ ws, int* __restrict__ cnt) {
  extern __shared__ __align__(16) float smem[];
  float* xs0 = smem;
  float* ys0 = smem + TSTAGES * X_STAGE;
  __shared__ int last;

  const int batch = gridDim.z / splits;
  const int z = blockIdx.z / splits, split = blockIdx.z % splits;
  x += static_cast<size_t>(z) * m * k;
  y += static_cast<size_t>(z) * k * n;
  const size_t plane = static_cast<size_t>(m) * n;
  out += z * plane;

  const int row0 = blockIdx.y * TBM, col0 = blockIdx.x * TBN;
  const int k_tiles = (k + TBK - 1) / TBK;
  const int kt0 = static_cast<int>(static_cast<long long>(k_tiles) * split / splits);
  const int kt1 = static_cast<int>(static_cast<long long>(k_tiles) * (split + 1) / splits);
  const int nk = kt1 - kt0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / (TBN / TWN)) * TWM, wn = (warp % (TBN / TWN)) * TWN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TSTAGES - 1; ++s) {
    if (s < nk)
      load_slice<VEC>(xs0 + s * X_STAGE, ys0 + s * Y_STAGE, x, y, m, n, k, row0, col0,
                      (kt0 + s) * TBK);
    cp_async_commit();
  }

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<TSTAGES - 2>();
    __syncthreads();  // slice it has landed; every warp is done with slice it - 1
    const int next = it + TSTAGES - 1;
    if (next < nk)
      load_slice<VEC>(xs0 + (next % TSTAGES) * X_STAGE, ys0 + (next % TSTAGES) * Y_STAGE, x, y,
                      m, n, k, row0, col0, (kt0 + next) * TBK);
    cp_async_commit();

    const float* xs = xs0 + (it % TSTAGES) * X_STAGE;
    const float* ys = ys0 + (it % TSTAGES) * Y_STAGE;
#pragma unroll
    for (int kk = 0; kk < TBK; kk += 8) {
      // fragments: x (16 x 8, row) element e at row g (+8 for e odd), column
      // t (+4 for e >= 2); y (8 x 8, col) element e at row t (+4 for e = 1), column g
      unsigned ab[MI][4], as[MI][4], ac[MI][4], bb[NI][2], bs[NI][2], bc[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float* p = ys + (kk + t) * YS + wn + j * 8 + g;
        split_tf32(p[0], bb[j][0], bs[j][0], bc[j][0]);
        split_tf32(p[4 * YS], bb[j][1], bs[j][1], bc[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const float* p = xs + (wm + i * 16 + g) * XS + kk + t;
        split_tf32(p[0], ab[i][0], as[i][0], ac[i][0]);
        split_tf32(p[8 * XS], ab[i][1], as[i][1], ac[i][1]);
        split_tf32(p[4], ab[i][2], as[i][2], ac[i][2]);
        split_tf32(p[8 * XS + 4], ab[i][3], as[i][3], ac[i][3]);
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma_tf32(acc[i][j], as[i], bc[j]);
          mma_tf32(acc[i][j], ac[i], bs[j]);
          mma_tf32(acc[i][j], ab[i], bb[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // fragment element e of (i, j): row g (+8 for e >= 2), columns 2t, 2t + 1
  if (splits > 1) {
    float* part = ws + (static_cast<size_t>(split) * batch + z) * plane;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wm + i * 16 + g + (e / 2) * 8;
          const int c = col0 + wn + j * 8 + 2 * t + e % 2;
          if (r < m && c < n) part[static_cast<size_t>(r) * n + c] = acc[i][j][e];
        }
    __threadfence();
    __syncthreads();
    int* arrived = cnt + (static_cast<size_t>(z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0) last = atomicAdd(arrived, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = row0 + wm + i * 16 + g + (e / 2) * 8;
          const int c = col0 + wn + j * 8 + 2 * t + e % 2;
          if (r >= m || c >= n) continue;
          const size_t at = static_cast<size_t>(r) * n + c;
          float v = 0.f;
          for (int s = 0; s < splits; ++s) {  // range order, whichever block arrived last
            const float* part_s = ws + (static_cast<size_t>(s) * batch + z) * plane;
            const float p = s == split ? acc[i][j][e] : __ldcg(part_s + at);
            v = s == 0 ? p : v + p;
          }
          acc[i][j][e] = v;
        }
    if (threadIdx.x == 0) *arrived = 0;  // ready for the next launch on this stream
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm + i * 16 + g + h * 8;
        const int c = col0 + wn + j * 8 + 2 * t;
        if (r >= m) continue;
        float* o = out + static_cast<size_t>(r) * n + c;
        if (VEC) {  // N % 4 == 0 and c even: both columns are in or out, 8-byte aligned
          if (c < n)
            *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (c < n) o[0] = acc[i][j][2 * h];
          if (c + 1 < n) o[1] = acc[i][j][2 * h + 1];
        }
      }
}

template <bool VEC>
int launch_tf32x3(const float* x, const float* y, float* out, int batch, int m, int n, int k,
                  int splits, float* ws, int* cnt, cudaStream_t stream) {
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tf32x3_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(TF32_SMEM));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((n + TBN - 1) / TBN, (m + TBM - 1) / TBM, batch * splits);
  gemm_tf32x3_kernel<VEC><<<grid, TTHREADS, TF32_SMEM, stream>>>(x, y, out, m, n, k, splits, ws,
                                                                  cnt);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* x, const void* y, void* out, int batch, int m, int n, int k,
               int splits, void* ws, void* cnt, void* stream) {
  const int k_tiles = (k + TBK - 1) / TBK;
  if (splits < 1 || splits > (k_tiles > 0 ? k_tiles : 1) ||
      (splits > 1 && (ws == nullptr || cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xp = static_cast<const float*>(x);
  const auto* yp = static_cast<const float*>(y);
  auto* op = static_cast<float*>(out);
  const bool vec = k % 4 == 0 && n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto* wsp = static_cast<float*>(ws);
  auto* cp = static_cast<int*>(cnt);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_tf32x3<true>(xp, yp, op, batch, m, n, k, splits, wsp, cp, s)
             : launch_tf32x3<false>(xp, yp, op, batch, m, n, k, splits, wsp, cp, s);
}

}  // namespace

// x, y, out, M, N, K; splits K ranges (1: no workspace), ws (splits * M * N
// floats) and cnt (one zeroed int32 per output tile) when splits > 1
extern "C" int repro_gemm_f32(const void* x, const void* y, void* out, int m, int n, int k,
                              int splits, void* ws, void* cnt, void* stream) {
  return launch_f32(x, y, out, 1, m, n, k, splits, ws, cnt, stream);
}

extern "C" int repro_gemm_batched_f32(const void* x, const void* y, void* out, int batch, int m,
                                      int n, int k, int splits, void* ws, void* cnt,
                                      void* stream) {
  return launch_f32(x, y, out, batch, m, n, k, splits, ws, cnt, stream);
}
