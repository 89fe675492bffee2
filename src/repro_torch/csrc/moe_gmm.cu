// K6: hand-written grouped matmul for Hopper (sm_90a), out[e] = x[e] @ w[e].
//
// Replaces repro/kernels/moe_gmm.py::grouped_matmul (the Pallas TPU kernel,
// pl.pallas_call at moe_gmm.py:61): the expert FFN of an MoE layer over
// capacity buckets, x (E, C, D) and w (E, D, F) row-major, an fp32 accumulator
// over D, the output (E, C, F) in the input type.
//
// Bound: at Mixtral 8x7B's widths (D 4096, F 14336) one projection moves
// 939.5 MB of expert weights.  A decode step (C = 16 for 16 slots) is bound by
// those bytes, 0.28 ms at 3.35 TB/s; a 2048-token prefill bucket (C = 640) does
// 601 GFLOP, 0.61 ms at 989 TFLOP/s bf16, and is bound by operations.
//
// Design (bf16): tensor-core fragments, mma.sync.aligned.m16n8k16 with fp32
// accumulators.  The expert is the grid's outer (z) axis; a block owns a
// (32 * MT) x 128 output tile of one expert and 8 warps (2 along C, 4 along F),
// each warp (16 * MT) x 32.  The TPU kernel's sequential D grid axis becomes a
// loop inside the block over slices of 32, staged through shared memory in a
// ring of 3 with cp.async, so the next two slices load while one is
// multiplied; fragments come from shared memory by ldmatrix (B transposed).
// MT (1, 2 or 4) follows C, so a 16-slot decode step does not spend 8x the
// operations a 128-row tile would.  Ragged C, D and F are masked in the kernel
// (cp.async zero-fills a slice out of range, stores are guarded); when D or F
// is not a multiple of 8 (or a pointer is not 16-byte aligned) the slices are
// loaded element by element instead.  No padded copy is made.  wgmma/TMA are
// left to later work.
//
// float32 does not come here: kernels/moe_gmm.py launches K1's tiling in
// gemm.cu with the expert as its batch (grid z) axis.
//
// Interface: plain C, loaded with ctypes.  The entry point launches on the
// given stream and returns cudaGetLastError(); the Python wrapper raises when
// it is nonzero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BN = 128;          // output columns (F) per block
constexpr int BK = 32;           // D slice per stage
constexpr int STAGES = 3;        // cp.async ring depth
constexpr int THREADS = 256;     // 8 warps: 2 (C) x 4 (F)
constexpr int A_STRIDE = BK + 8;  // 80-byte rows: ldmatrix rows on distinct banks
constexpr int B_STRIDE = BN + 8;  // 272-byte rows

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

template <int MT>
constexpr int smem_bytes() {
  return STAGES * (32 * MT * A_STRIDE + BK * B_STRIDE) * 2;
}

// One D slice of x (BM x BK) and of w (BK x BN) into ring stage `st`.  VEC:
// 16-byte cp.async per 8 values (D, F multiples of 8, so a group of 8 is in
// range or out of it as a whole; out of range is zero-filled).  Otherwise
// element by element with zero fill.
template <int MT, bool VEC>
__device__ __forceinline__ void load_slice(__nv_bfloat16* as, __nv_bfloat16* bs,
                                           const __nv_bfloat16* __restrict__ xe,
                                           const __nv_bfloat16* __restrict__ we, int row0,
                                           int col0, int k0, int c, int d, int f) {
  constexpr int BM = 32 * MT;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int ch = threadIdx.x; ch < BM * (BK / 8); ch += THREADS) {
    const int r = ch / (BK / 8), cc = (ch % (BK / 8)) * 8;
    const int gr = row0 + r, gk = k0 + cc;
    __nv_bfloat16* dst = as + r * A_STRIDE + cc;
    if (VEC) {
      const bool in = gr < c && gk < d;
      cp_async16(dst, in ? xe + static_cast<size_t>(gr) * d + gk : xe, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gr < c && gk + j < d) ? xe[static_cast<size_t>(gr) * d + gk + j] : zero;
    }
  }
  for (int ch = threadIdx.x; ch < BK * (BN / 8); ch += THREADS) {
    const int r = ch / (BN / 8), cc = (ch % (BN / 8)) * 8;
    const int gk = k0 + r, gc = col0 + cc;
    __nv_bfloat16* dst = bs + r * B_STRIDE + cc;
    if (VEC) {
      const bool in = gk < d && gc < f;
      cp_async16(dst, in ? we + static_cast<size_t>(gk) * f + gc : we, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gk < d && gc + j < f) ? we[static_cast<size_t>(gk) * f + gc + j] : zero;
    }
  }
}

template <int MT, bool VEC>
__global__ void __launch_bounds__(THREADS)
moe_gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ out, int c, int d, int f) {
  constexpr int BM = 32 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][A_STRIDE]
  __nv_bfloat16* bs = as + STAGES * BM * A_STRIDE;               // [STAGES][BK][B_STRIDE]

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * c * d;
  const __nv_bfloat16* we = w + static_cast<size_t>(e) * d * f;
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * c * f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;  // this warp's (16*MT) x 32 sub-tile

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int slices = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices)
      load_slice<MT, VEC>(as + s * BM * A_STRIDE, bs + s * BK * B_STRIDE, xe, we, row0, col0,
                          s * BK, c, d, f);
    cp_async_commit();
  }

  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt has landed, and every warp is done with slice kt - 1
    const int next = kt + STAGES - 1;
    if (next < slices)
      load_slice<MT, VEC>(as + (next % STAGES) * BM * A_STRIDE,
                          bs + (next % STAGES) * BK * B_STRIDE, xe, we, row0, col0, next * BK,
                          c, d, f);
    cp_async_commit();

    const __nv_bfloat16* a_st = as + (kt % STAGES) * BM * A_STRIDE;
    const __nv_bfloat16* b_st = bs + (kt % STAGES) * BK * B_STRIDE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = wm * 16 * MT + i * 16 + (lane % 16);
        ldmatrix_x4(a[i], a_st + r * A_STRIDE + kk + (lane / 16) * 8);
      }
      unsigned b[2][4];  // b[p]: {b0, b1} of n8 tiles 2p and 2p + 1
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int kr = kk + (lane % 8) + ((lane / 8) % 2) * 8;
        const int nc = wn * 32 + p * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(b[p], b_st + kr * B_STRIDE + nc);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator (row lane/4 [+8], columns 2*(lane%4) + {0, 1}) -> bf16
  const bool pairs = (f % 2) == 0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + wn * 32 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 16 * MT + i * 16 + lane / 4 + h * 8;
        if (row >= c) continue;
        __nv_bfloat16* o = oe + static_cast<size_t>(row) * f + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (pairs && col + 1 < f) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < f) o[0] = __float2bfloat16(v0);
          if (col + 1 < f) o[1] = __float2bfloat16(v1);
        }
      }
    }
}

template <int MT, bool VEC>
int launch_bf16_tile(const void* x, const void* w, void* out, int e, int c, int d, int f,
                     cudaStream_t stream) {
  constexpr int bytes = smem_bytes<MT>();
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_bf16_kernel<MT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((f + BN - 1) / BN, (c + 32 * MT - 1) / (32 * MT), e);
  moe_gmm_bf16_kernel<MT, VEC><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), c, d, f);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_bf16(const void* x, const void* w, void* out, int e, int c, int d, int f,
                cudaStream_t stream) {
  if (c <= 32) return launch_bf16_tile<1, VEC>(x, w, out, e, c, d, f, stream);
  if (c <= 64) return launch_bf16_tile<2, VEC>(x, w, out, e, c, d, f, stream);
  return launch_bf16_tile<4, VEC>(x, w, out, e, c, d, f, stream);
}

}  // namespace

extern "C" int repro_moe_gmm_bf16(const void* x, const void* w, void* out, int e, int c, int d,
                                  int f, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bf16<true>(x, w, out, e, c, d, f, s)
             : launch_bf16<false>(x, w, out, e, c, d, f, s);
}
