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
// Three kernels compute it in bf16; kernels/moe_gmm.py::choose_kernel picks one
// before launch from the dtype, C, D, F and the pointers' alignment.
//
// moe_gmm_wgmma_kernel (prefill, operation bound): Hopper's warpgroup MMA fed
// by the Tensor Memory Accelerator (gmm_tile, shared with K6-bwd below).  A
// block owns a 128 x 256 output tile of one expert: two consumer warpgroups
// of 64 rows each run
// wgmma.mma_async.m64n256k16 with fp32 accumulators in registers (128 a
// thread), and one producer warp starts TMA copies of the D slices (64 deep)
// into a ring of 4 stages behind full/empty mbarriers, so the copies need no
// thread's registers or address arithmetic.  Both operands land in shared
// memory with the 128-byte swizzle: x's (128 x 64) tile is K-major, w's
// (64 x 256) tile is read as four 64-column boxes, MN-major (F contiguous),
// and wgmma reads it with its transpose bit.  The tensor maps are rank 3 with
// the expert as a coordinate, so TMA zero-fills rows past C, columns past F
// and the slice past D without crossing into the next expert; stores are
// guarded.  Blocks walk the C tiles of one F tile first, so the expert
// weights, the bytes that dominate, come from device memory about once.  The
// tensor maps are built on the host by cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda).  It takes D % 8 == 0, F % 8 == 0 and
// 16-byte aligned pointers (TMA's strides and addresses).
//
// moe_gmm_decode_kernel (decode, C < 32: bound by the expert weights' bytes,
// 99.9% of what it moves).  moe_gmm_bf16_kernel gave C = 16 a 32-row tile
// whose second warp row computed padding, kept two 8 KB slices in flight per
// block, and ran gate/up in 1.7 waves; it lost to torch.bmm.  Here:
// * A block owns one or two m16 row tiles (C <= 16 or <= 32) and a 256-column
//   tile of one expert; each of its 8 consumer warps owns 32 distinct columns
//   (mma.sync m16n8k16, fp32 accumulators), so no warp works on padding.
// * One producer warp streams the 64-deep D slices by TMA, with the rank-3
//   tensor maps of moe_gmm_wgmma_kernel: x's 16-row slice and four 64-column
//   boxes of w (32 KB of weights, rows of 512 contiguous bytes) per stage,
//   128-byte swizzled, into a 4-stage ring behind full/empty mbarriers, so
//   up to 128 KB of weights are in flight an SM while the consumers work.
//   The consumers read A and B fragments by ldmatrix from the swizzled
//   tiles; TMA zero-fills rows past C, columns past F and D past its end.
//   On an H100 the same tiles fed by a cp.async ring (two blocks an SM) lost
//   to the wgmma kernel at gate/up; fed this way they beat it (PERF.md).
// * The grid is (F tiles, E), tiles fastest, so the blocks in flight read
//   neighbouring columns of the same weight rows.  Each block walks all of
//   D, so the sum order is fixed and results are bit-identical run to run.
//   D is not split across blocks: at Mixtral's decode shapes (448 and 128
//   tiles on 132 SMs) a split into fp32 partials measured slower than one
//   range (PERF.md).
// It takes bf16 with C <= 32, D % 8 == 0, F % 8 == 0 and 16-byte aligned
// pointers.
//
// moe_gmm_bf16_kernel (whatever the other two do not take: D or F not a
// multiple of 8, an unaligned view): tensor-core fragments, mma.sync.aligned.m16n8k16 with fp32
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
// loaded element by element instead.  No padded copy is made.
//
// float32 does not come here: kernels/moe_gmm.py launches K1's 3xTF32 kernel
// in gemm.cu with the expert as its batch (grid z) axis.
//
// K6-bwd, the gradient (the TPU kernel has none: the reference trains on
// XLA's gradient of kernels/ref.py; the card needs a kernel for backward()):
// moe_gmm_dx_wgmma_kernel computes dx = dy . w^T and moe_gmm_dw_wgmma_kernel
// dw = x^T . dy per expert, bf16 in, fp32 accumulators, bf16 out.  Bound: at
// Mixtral 8x7B's widths and C = 2560 (an 8,192-token microbatch) each
// product is 2.4 TFLOP, 2.43 ms at 989 TFLOP/s, bound by operations; at
// decode-sized C the bytes of w or dw bound it.  The first version ran these
// on mma.sync from a cp.async ring fed by all 256 threads (233 TFLOP/s at
// C = 2560, PERF.md), which cannot reach the wgmma rate.  Both now run the
// forward's pipeline (gmm_tile): 128 x 256 output tiles, two consumer
// warpgroups on wgmma m64n256k16, one producer warp keeping TMA copies of
// 64-deep k slices in the 4-stage full/empty mbarrier ring, 128-byte
// swizzle, rank-3 maps with the expert as a coordinate, so TMA zero-fills a
// ragged C, D or F.  They differ from the forward in their operands' major
// order only, which wgmma's transpose bits absorb:
// * dx (M = C, N = D, k = F): dy's (128 x 64) tile is the K-major A, as x is
//   in the forward; w's rows are read in place as a K-major B (F is
//   contiguous in them), four 64-row boxes, so no transposed copy is made.
// * dw (M = D, N = F, k = C): x^T is an MN-major A, two 64-column boxes of
//   x's rows for 128 rows of D, read with imm-trans-a = 1 (allowed for
//   bf16); dy is an MN-major B, as w is in the forward.
// Each block walks its whole k range in order, so nothing is split across
// blocks, there are no atomics, and the gradients are bit-identical run to
// run.  They take any C >= 1, D and F multiples of 8 and 16-byte aligned
// tensors (TMA's strides and addresses).  On an H100 (700 W) both products at
// Mixtral's gate/up and C = 2560 took 7.5 graph ms, 638 TFLOP/s, beside two
// torch.bmm calls' 6.9 (PERF.md); at C <= 40 dw's blocks each run one or two
// k slices, and their prologue and epilogue (one block an SM) dominate.
//
// Interface: plain C, loaded with ctypes.  Each entry point launches on the
// given stream and returns cudaGetLastError(), or WGMMA_MAP_ERROR plus the
// CUresult when a tensor map cannot be encoded; the Python wrapper
// raises when it is nonzero.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
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

// ---------------------------------------------------------------------------
// moe_gmm_wgmma_kernel (prefill) and K6-bwd's moe_gmm_dx_wgmma_kernel and
// moe_gmm_dw_wgmma_kernel: wgmma + TMA on the same tiles (gmm_tile)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;          // output rows (M) per block: two consumer warpgroups of 64
constexpr int BN = 256;          // output columns (N) per block
constexpr int BK = 64;           // k slice per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;        // TMA ring depth
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK * 2;     // 16 KB: A's tile
constexpr int BOX_BYTES = BK * 64 * 2;   // 8 KB: one 64 x 64 box
constexpr int B_BYTES = (BN / 64) * BOX_BYTES;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;  // + barriers, alignment

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// One box of a rank-3 tensor map (coordinates innermost first) into shared
// memory; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo, unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 256, fp32, 128 registers a thread) = A (64 x 16) . B (16 x 256),
// both from shared memory, plus D itself when `accumulate` (scale-d) is
// nonzero.  TA, TB: imm-trans-a, imm-trans-b, 1 for an MN-major operand
// (M or N contiguous), 0 for a K-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// One 128 x 256 tile of out[e] (M x N) = A[e] (M x K) . B[e] (K x N), the
// block's (blockIdx.x, blockIdx.y, expert blockIdx.z).  The producer warp
// streams 64-deep k slices by TMA; a box wholly past M or N is not loaded
// (the rows or columns it would give are not stored), a box partly past M,
// N or K is zero-filled by TMA.  Operands (both 128-byte swizzled):
// * A K-major (A_MN false: rows of K contiguous): one (128 x 64) box of an
//   (E, M, K) map; warpgroup g reads its 64 rows, 8 KB in.
// * A MN-major (A_MN: M contiguous): two (64 k x 64 m) boxes of an (E, K, M)
//   map; warpgroup g reads box g with the transpose bit.
// * B K-major (B_MN false): four (64 n x 64 k) boxes of an (E, N, K) map,
//   stacked into 256 rows of 128 bytes.
// * B MN-major (B_MN): four (64 k x 64 n) boxes of an (E, K, N) map, read
//   with the transpose bit.
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void gmm_tile(const CUtensorMap* amap, const CUtensorMap* bmap,
                                         __nv_bfloat16* __restrict__ out, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stage buffers start on 1024
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int slices = (k + BK - 1) / BK;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);               // the producer's arrive, plus the bytes
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread starts every copy
    if (threadIdx.x == CONSUMERS) {
      const int a_boxes = A_MN ? min(BM / 64, (m - m0 + 63) / 64) : 1;
      const int b_boxes = min(BN / 64, (n - n0 + 63) / 64);
      const unsigned bytes = (A_MN ? a_boxes * BOX_BYTES : A_BYTES) + b_boxes * BOX_BYTES;
      for (int kt = 0; kt < slices; ++kt) {
        const int s = kt % STAGES, k0 = kt * BK;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // the first round passes at once
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], bytes);
        if (A_MN)
          for (int i = 0; i < a_boxes; ++i)
            tma_load(st + i * BOX_BYTES, amap, &full[s], m0 + 64 * i, k0, e);
        else
          tma_load(st, amap, &full[s], k0, m0, e);
        for (int j = 0; j < b_boxes; ++j) {
          if (B_MN)
            tma_load(st + A_BYTES + j * BOX_BYTES, bmap, &full[s], n0 + 64 * j, k0, e);
          else
            tma_load(st + A_BYTES + j * BOX_BYTES, bmap, &full[s], k0, n0 + 64 * j, e);
        }
      }
    }
    return;
  }

  // consumers: warpgroup g owns rows m0 + 64 g .. + 63 of the tile
  const int g = threadIdx.x / 128;
  // no instruction but wgmma defines the accumulator (the first product
  // overwrites it), so ptxas keeps the products of a slice in flight together
  float acc[BN / 2];

  for (int kt = 0; kt < slices; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a = smem + s * STAGE_BYTES + g * BOX_BYTES;
    const unsigned char* b = smem + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // K-major: 16 values = 32 bytes along a 128-byte row, 8-row groups 1024
      // apart.  MN-major: 16 rows of 128 bytes = 2048 bytes deeper, 8-row
      // groups 1024 apart, 64-wide boxes BOX_BYTES apart.
      const uint64_t ad = A_MN ? smem_desc(a + kk * 2048, BOX_BYTES, 1024)
                               : smem_desc(a + kk * 32, 16, 1024);
      const uint64_t bd = B_MN ? smem_desc(b + kk * 2048, BOX_BYTES, 1024)
                               : smem_desc(b + kk * 32, 16, 1024);
      wgmma_m64n256<A_MN, B_MN>(acc, ad, bd, kt > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done: release its stage
    if (kt > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // epilogue: accumulator (row 16 * warp + lane / 4 [+ 8], columns
  // 8 j + 2 (lane % 4) + {0, 1}) -> bf16; N % 8 == 0, so a pair is in or out
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = m0 + g * 64 + warp * 16 + lane / 4;
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * m * n;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h >= m) continue;
      *reinterpret_cast<__nv_bfloat162*>(oe + static_cast<size_t>(row + 8 * h) * n + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out (E, C, F) = x (E, C, D) . w (E, D, F): x K-major, w MN-major (F contiguous)
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                     int m, int n, int k) {
  gmm_tile<false, true>(&xmap, &wmap, out, m, n, k);
}

// K6-bwd: dx (E, C, D) = dy (E, C, F) . w^T: M = C, N = D, k = F.  dy is a
// K-major A as x is in the forward; w's rows are a K-major B read in place
// (F contiguous in them), so no transposed copy is made.
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap dymap,
                        const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ dx,
                        int m, int n, int k) {
  gmm_tile<false, false>(&dymap, &wmap, dx, m, n, k);
}

// K6-bwd: dw (E, D, F) = x^T . dy: M = D, N = F, k = C.  x^T is an MN-major
// A (two 64-column boxes of x for 128 rows of D), dy an MN-major B as w is
// in the forward.
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap dymap, __nv_bfloat16* __restrict__ dw,
                        int m, int n, int k) {
  gmm_tile<true, true>(&xmap, &dymap, dw, m, n, k);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int WGMMA_MAP_ERROR = 10000;

// A rank-3 bf16 tensor map over (outer, rows, inner), inner contiguous, with
// boxes of (1, box_rows, 64) and the 128-byte swizzle; 0 or WGMMA_MAP_ERROR +
// its CUresult.
int make_map(CUtensorMap* map, const void* base, int outer, int rows, int inner, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return WGMMA_MAP_ERROR + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(inner) * 2,
                                 static_cast<cuuint64_t>(inner) * rows * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : WGMMA_MAP_ERROR + static_cast<int>(r);
}

// out (E, M, N) from A's and B's maps, 128 x 256 tiles, M tiles fastest (the
// blocks in flight share B's tile: the expert weights in the forward and
// dx, dy in dw)
template <typename Kernel>
int launch_tiles(Kernel kernel, bool& configured, const CUtensorMap& amap, const CUtensorMap& bmap,
                 void* out, int e, int m, int n, int k, cudaStream_t stream) {
  if (!configured) {  // above 48 KB only after this attribute is set
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN, e);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(amap, bmap, static_cast<__nv_bfloat16*>(out), m,
                                                n, k);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
           cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = make_map(&xmap, x, e, c, d, BM);
  if (err == 0) err = make_map(&wmap, w, e, d, f, BK);
  if (err != 0) return err;
  static bool configured = false;
  return launch_tiles(moe_gmm_wgmma_kernel, configured, xmap, wmap, out, e, c, f, d, stream);
}

bool bwd_takes(const void* a, const void* b, const void* out, int e, int c, int d, int f) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return aligned && e >= 1 && e <= 65535 && c >= 1 && d >= 8 && d % 8 == 0 && f >= 8 &&
         f % 8 == 0 && (c + BM - 1) / BM <= 65535 && (d + BM - 1) / BM <= 65535;
}

// dx = dy . w^T: dy's map as x's in the forward (rows C, 64-deep F slices), w's
// as 64-row boxes of its (D, F) rows
int launch_dx(const void* dy, const void* w, void* dx, int e, int c, int d, int f,
              cudaStream_t stream) {
  if (!bwd_takes(dy, w, dx, e, c, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap dymap, wmap;
  int err = make_map(&dymap, dy, e, c, f, BM);
  if (err == 0) err = make_map(&wmap, w, e, d, f, 64);
  if (err != 0) return err;
  static bool configured = false;
  return launch_tiles(moe_gmm_dx_wgmma_kernel, configured, dymap, wmap, dx, e, c, d, f, stream);
}

// dw = x^T . dy: 64-deep C slices of x (64 columns of D a box) and of dy
int launch_dw(const void* x, const void* dy, void* dw, int e, int c, int d, int f,
              cudaStream_t stream) {
  if (!bwd_takes(x, dy, dw, e, c, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, dymap;
  int err = make_map(&xmap, x, e, c, d, BK);
  if (err == 0) err = make_map(&dymap, dy, e, c, f, BK);
  if (err != 0) return err;
  static bool configured = false;
  return launch_tiles(moe_gmm_dw_wgmma_kernel, configured, xmap, dymap, dw, e, d, f, c, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// moe_gmm_decode_kernel: small C, the expert weights streamed (decode)
// ---------------------------------------------------------------------------
namespace dec {

constexpr int BN = 256;           // output columns (F) per block: four 64-column boxes of w
constexpr int BK = 64;            // D slice per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;         // TMA ring depth
constexpr int CONSUMERS = 256;    // 8 warps, 32 columns each
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int BOX_BYTES = BK * 64 * 2;   // 8 KB: one 64-column box of w's slice
constexpr int B_BYTES = (BN / 64) * BOX_BYTES;

template <int MT>
__host__ __device__ constexpr int a_bytes() {  // x's slice: 16 MT rows of 128 bytes
  return 16 * MT * BK * 2;
}
template <int MT>
__host__ __device__ constexpr int stage_bytes() {
  return a_bytes<MT>() + B_BYTES;
}
template <int MT>
constexpr int smem_bytes() {  // the ring, its barriers, and room to align it on 1024
  return STAGES * stage_bytes<MT>() + 2 * STAGES * 8 + 1024;
}

// Byte offset of 16-byte chunk j of row r in a tile of 128-byte rows stored
// with the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): the chunk
// index is XORed with the row's index within its 8-row group.
__device__ __forceinline__ unsigned swz(int r, int j) {
  return static_cast<unsigned>(r * 128 + ((j ^ (r % 8)) << 4));
}

// grid (F tiles, E): expert blockIdx.y, columns blockIdx.x * BN .., all of D.
template <int MT>
__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_decode_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                      int c, int d, int f) {
  constexpr int A_BYTES = a_bytes<MT>(), STAGE_BYTES = stage_bytes<MT>();
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stage buffers start on 1024
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int e = blockIdx.y, col0 = blockIdx.x * BN;
  const int n = (d + BK - 1) / BK;  // D's slices
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);                // the producer's arrive, plus the bytes
      wg::mbar_init(&empty[s], CONSUMERS / 32);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread starts every copy
    if (threadIdx.x == CONSUMERS) {
      const int boxes = min(BN / 64, (f - col0 + 63) / 64);  // boxes wholly past F are not loaded
      const unsigned bytes = A_BYTES + boxes * BOX_BYTES;
      for (int kt = 0; kt < n; ++kt) {
        const int s = kt % STAGES;
        wg::mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // the first round passes at once
        unsigned char* st = smem + s * STAGE_BYTES;
        const int k0 = kt * BK;
        wg::mbar_expect_tx(&full[s], bytes);
        wg::tma_load(st, &xmap, &full[s], k0, 0, e);
        for (int j = 0; j < boxes; ++j)
          wg::tma_load(st + A_BYTES + j * BOX_BYTES, &wmap, &full[s], col0 + 64 * j, k0, e);
      }
    }
    return;
  }

  // consumers: warp w owns columns col0 + 32 w .. + 31, in box w / 2
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[MT][4][4];  // [m16 tile][n8 tile of the warp's 32 columns][fragment]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  for (int kt = 0; kt < n; ++kt) {
    const int s = kt % STAGES;
    wg::mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* a_st = smem + s * STAGE_BYTES;
    const unsigned char* b_st = a_st + A_BYTES + (warp / 2) * BOX_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int r = i * 16 + lane % 16;
        ldmatrix_x4(a[i], a_st + swz(r, 2 * kk + lane / 16));
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        unsigned b[4];  // {b0, b1} of n8 tiles 2 p and 2 p + 1 of the warp's columns
        const int kr = 16 * kk + lane % 8 + ((lane / 8) % 2) * 8;
        ldmatrix_x4_trans(b, b_st + swz(kr, (warp % 2) * 4 + p * 2 + lane / 16));
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * p], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(&empty[s]);  // this warp is done with stage s
  }

  // fragment element t of (i, j): row 16 i + lane / 4 (+ 8 for t >= 2),
  // columns 2 (lane % 4) + {0, 1} of n8 tile j
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * c * f;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i * 16 + lane / 4 + h * 8;
        const int col = col0 + warp * 32 + j * 8 + (lane % 4) * 2;
        if (row < c && col < f)  // F % 8 == 0: a pair is in or out whole
          *reinterpret_cast<__nv_bfloat162*>(oe + static_cast<size_t>(row) * f + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

template <int MT>
int launch_mt(const void* x, const void* w, void* out, int e, int c, int d, int f,
              cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = wg::make_map(&xmap, x, e, c, d, 16 * MT);
  if (err == 0) err = wg::make_map(&wmap, w, e, d, f, BK);
  if (err != 0) return err;
  constexpr int bytes = smem_bytes<MT>();
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t e2 = cudaFuncSetAttribute(
        moe_gmm_decode_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    configured = true;
  }
  const dim3 grid((f + BN - 1) / BN, e);
  moe_gmm_decode_kernel<MT><<<grid, THREADS, bytes, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), c, d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
           cudaStream_t stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (c < 1 || c > 32 || d < 8 || d % 8 != 0 || f < 8 || f % 8 != 0 || !aligned || e < 1 ||
      e > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return c <= 16 ? launch_mt<1>(x, w, out, e, c, d, f, stream)
                 : launch_mt<2>(x, w, out, e, c, d, f, stream);
}

}  // namespace dec

extern "C" int repro_moe_gmm_bf16(const void* x, const void* w, void* out, int e, int c, int d,
                                  int f, int vec, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bf16<true>(x, w, out, e, c, d, f, s)
             : launch_bf16<false>(x, w, out, e, c, d, f, s);
}

// bf16 with D % 8 == 0, F % 8 == 0 and 16-byte aligned x, w (the wrapper checks).
extern "C" int repro_moe_gmm_wgmma_bf16(const void* x, const void* w, void* out, int e, int c,
                                        int d, int f, void* stream) {
  return wg::launch(x, w, out, e, c, d, f, static_cast<cudaStream_t>(stream));
}

// bf16 with C <= 32, D % 8 == 0, F % 8 == 0 and 16-byte aligned x, w, out.
extern "C" int repro_moe_gmm_decode_bf16(const void* x, const void* w, void* out, int e, int c,
                                         int d, int f, void* stream) {
  return dec::launch(x, w, out, e, c, d, f, static_cast<cudaStream_t>(stream));
}

// K6-bwd, bf16 with C >= 1, D % 8 == 0, F % 8 == 0 and 16-byte aligned,
// contiguous tensors (the wrapper checks; the entries return
// cudaErrorInvalidValue otherwise): dx (E, C, D) = dy . w^T per expert.
extern "C" int repro_moe_gmm_dx_bf16(const void* dy, const void* w, void* dx, int e, int c, int d,
                                     int f, void* stream) {
  return wg::launch_dx(dy, w, dx, e, c, d, f, static_cast<cudaStream_t>(stream));
}

// dw (E, D, F) = x^T . dy per expert.
extern "C" int repro_moe_gmm_dw_bf16(const void* x, const void* dy, void* dw, int e, int c, int d,
                                     int f, void* stream) {
  return wg::launch_dw(x, dy, dw, e, c, d, f, static_cast<cudaStream_t>(stream));
}
