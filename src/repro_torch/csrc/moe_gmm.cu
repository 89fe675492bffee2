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
// by the Tensor Memory Accelerator.  A block owns a 128 x 256 output tile of
// one expert: two consumer warpgroups of 64 rows each run
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
// moe_gmm_dx_kernel computes dx = dy . w^T and moe_gmm_dw_kernel dw = x^T .
// dy per expert, bf16 in, fp32 accumulators on mma.sync m16n8k16, bf16 out.
// Bound: at Mixtral 8x7B's widths and C = 2560 (an 8,192-token microbatch)
// each product is 2.4 TFLOP, 2.43 ms at 989 TFLOP/s, bound by operations;
// at decode-sized C the bytes of w or dw bound it.  Both kernels keep the
// mma kernel's shape: a block owns one 128 x 128 output tile of one expert,
// 8 warps of 64 x 32, and walks the whole k range through a 3-stage
// cp.async ring of 32-deep slices, so nothing is split across blocks and
// there are no atomics: the gradients are bit-identical run to run.  dx
// reads w's rows in place as the B operand (k = F is contiguous in them), so
// no transposed copy of the weights is made; dw loads x's rows and turns
// them with ldmatrix.trans.  D and F must be multiples of 8 and the tensors
// 16-byte aligned; ragged C, D and F tiles are zero-filled and masked.
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
// moe_gmm_wgmma_kernel: wgmma + TMA (prefill)
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;          // output rows (C) per block: two consumer warpgroups of 64
constexpr int BN = 256;          // output columns (F) per block
constexpr int BK = 64;           // D slice per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 4;        // TMA ring depth
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int A_BYTES = BM * BK * 2;     // 16 KB: x's tile, K-major
constexpr int BOX_BYTES = BK * 64 * 2;   // 8 KB: one 64-column box of w's tile, MN-major
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

// D (64 x 256, fp32, 128 registers a thread) = A (64 x 16, K-major) . B
// (16 x 256, MN-major: imm-trans-b = 1), both from shared memory, plus D
// itself when `accumulate` (scale-d) is nonzero.
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
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

__global__ void __launch_bounds__(THREADS, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, __nv_bfloat16* __restrict__ out,
                     int c, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: stage buffers start on 1024
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, e = blockIdx.z;
  const int slices = (d + BK - 1) / BK;
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
      const int boxes = min(BN / 64, (f - n0 + 63) / 64);  // boxes wholly past F are not loaded
      const unsigned bytes = A_BYTES + boxes * BOX_BYTES;
      for (int kt = 0; kt < slices; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);  // the first round passes at once
        unsigned char* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], bytes);
        tma_load(st, &xmap, &full[s], kt * BK, m0, e);
        for (int j = 0; j < boxes; ++j)
          tma_load(st + A_BYTES + j * BOX_BYTES, &wmap, &full[s], n0 + 64 * j, kt * BK, e);
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
    const unsigned char* a = smem + s * STAGE_BYTES + g * 64 * 128;
    const unsigned char* b = smem + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      // A: 16 values = 32 bytes along a 128-byte row, 8-row groups 1024 apart.
      // B: 16 rows of 128 bytes = 2048 bytes deeper; 8-row groups 1024 apart,
      //    64-column boxes BOX_BYTES apart.
      wgmma_m64n256(acc, smem_desc(a + kk * 32, 16, 1024),
                    smem_desc(b + kk * 2048, BOX_BYTES, 1024), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous slice's products are done: release its stage
    if (kt > 0 && threadIdx.x % 32 == 0) mbar_arrive(&empty[(kt - 1) % STAGES]);
  }
  wgmma_wait<0>();

  // epilogue: accumulator (row 16 * warp + lane / 4 [+ 8], columns
  // 8 j + 2 (lane % 4) + {0, 1}) -> bf16; F % 8 == 0, so a pair is in or out
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = m0 + g * 64 + warp * 16 + lane / 4;
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * c * f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + (lane % 4) * 2;
    if (col >= f) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h >= c) continue;
      *reinterpret_cast<__nv_bfloat162*>(oe + static_cast<size_t>(row + 8 * h) * f + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
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

int launch(const void* x, const void* w, void* out, int e, int c, int d, int f,
           cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  int err = make_map(&xmap, x, e, c, d, BM);
  if (err == 0) err = make_map(&wmap, w, e, d, f, BK);
  if (err != 0) return err;
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t e2 = cudaFuncSetAttribute(
        moe_gmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    configured = true;
  }
  const dim3 grid((c + BM - 1) / BM, (f + BN - 1) / BN, e);  // C tiles fastest: w read ~once
  moe_gmm_wgmma_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), c, d, f);
  return static_cast<int>(cudaGetLastError());
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

// ---------------------------------------------------------------------------
// K6-bwd: moe_gmm_dx_kernel and moe_gmm_dw_kernel (the gradient of K6)
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int BM = 128;       // output rows per block
constexpr int BN = 128;       // output columns per block
constexpr int BK = 32;        // k slice per stage
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 2 along the rows x 4 along the columns, each 64 x 32
constexpr int KSTR = BK + 8;  // [row][k] tiles: 80-byte rows, ldmatrix rows on distinct banks
constexpr int MNSTR = BM + 8;  // [k][row or column] tiles: 272-byte rows (BM == BN)
constexpr int DX_SMEM = STAGES * (BM + BN) * KSTR * 2;  // 61,440 bytes
constexpr int DW_SMEM = STAGES * 2 * BK * MNSTR * 2;    // 52,224 bytes

// Rows [r0, r0 + R) x k [k0, k0 + BK) of a row-major (nrows x kdim) matrix
// into a [R][KSTR] tile, 16 bytes a cp.async; kdim % 8 == 0, so a chunk of 8
// is in the matrix or out of it whole, and out of it is zero-filled.
template <int R>
__device__ __forceinline__ void load_rows_k(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                            int r0, int k0, int nrows, int kdim) {
  for (int ch = threadIdx.x; ch < R * (BK / 8); ch += THREADS) {
    const int r = ch / (BK / 8), cc = (ch % (BK / 8)) * 8;
    const int gr = r0 + r, gk = k0 + cc;
    const bool in = gr < nrows && gk < kdim;
    cp_async16(dst + r * KSTR + cc, in ? src + static_cast<size_t>(gr) * kdim + gk : src,
               in ? 16 : 0);
  }
}

// k rows [k0, k0 + BK) x columns [c0, c0 + W) of a row-major (kdim x ncols)
// matrix into a [BK][MNSTR] tile; ncols % 8 == 0, rows past kdim zero-filled.
template <int W>
__device__ __forceinline__ void load_k_cols(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src,
                                            int k0, int c0, int kdim, int ncols) {
  for (int ch = threadIdx.x; ch < BK * (W / 8); ch += THREADS) {
    const int r = ch / (W / 8), cc = (ch % (W / 8)) * 8;
    const int gk = k0 + r, gc = c0 + cc;
    const bool in = gk < kdim && gc < ncols;
    cp_async16(dst + r * MNSTR + cc, in ? src + static_cast<size_t>(gk) * ncols + gc : src,
               in ? 16 : 0);
  }
}

// A warp's 64 x 32 accumulator (4 m16 x 4 n8 tiles) -> bf16 rows < nrows,
// columns < ncols of a row-major (nrows x ncols) output; ncols % 8 == 0, so
// a column pair is in or out whole.
__device__ __forceinline__ void store_tile(__nv_bfloat16* __restrict__ out, const float (&acc)[4][4][4],
                                           int row0, int col0, int nrows, int ncols) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + wn * 32 + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + wm * 64 + i * 16 + lane / 4 + h * 8;
        if (row < nrows && col < ncols)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * ncols + col) =
              __floats2bfloat162_rn(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// dx (E, C, D) = dy (E, C, F) . w (E, D, F)^T: M = C, N = D, k = F.  k is
// contiguous in both operands, so dy's rows are the A tile [m][k] and w's
// rows, read in place, the B tile [n][k]: ldmatrix without .trans gives the
// .col B fragment of mma.sync.  grid (D tiles, C tiles, E).
__global__ void __launch_bounds__(THREADS, 2)
moe_gmm_dx_kernel(const __nv_bfloat16* __restrict__ dy, const __nv_bfloat16* __restrict__ w,
                  __nv_bfloat16* __restrict__ dx, int c, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][KSTR]: dy
  __nv_bfloat16* bs = as + STAGES * BM * KSTR;                   // [STAGES][BN][KSTR]: w

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const __nv_bfloat16* dye = dy + static_cast<size_t>(e) * c * f;
  const __nv_bfloat16* we = w + static_cast<size_t>(e) * d * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int slices = (f + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) {
      load_rows_k<BM>(as + s * BM * KSTR, dye, row0, s * BK, c, f);
      load_rows_k<BN>(bs + s * BN * KSTR, we, col0, s * BK, d, f);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt has landed, and every warp is done with slice kt - 1
    const int next = kt + STAGES - 1;
    if (next < slices) {
      load_rows_k<BM>(as + (next % STAGES) * BM * KSTR, dye, row0, next * BK, c, f);
      load_rows_k<BN>(bs + (next % STAGES) * BN * KSTR, we, col0, next * BK, d, f);
    }
    cp_async_commit();
    const __nv_bfloat16* a_st = as + (kt % STAGES) * BM * KSTR;
    const __nv_bfloat16* b_st = bs + (kt % STAGES) * BN * KSTR;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], a_st + (wm * 64 + i * 16 + lane % 16) * KSTR + kk + (lane / 16) * 8);
      unsigned b[2][4];  // b[p]: {b0, b1} of n8 tiles 2p and 2p + 1
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int mi = lane / 8;
        const int n = wn * 32 + p * 16 + (mi / 2) * 8 + lane % 8;
        ldmatrix_x4(b[p], b_st + n * KSTR + kk + (mi % 2) * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  store_tile(dx + static_cast<size_t>(e) * c * d, acc, row0, col0, c, d);
}

// dw (E, D, F) = x (E, C, D)^T . dy (E, C, F): M = D, N = F, k = C.  Both
// operands are read as rows of C: x's rows land as a [k][m] tile, and
// ldmatrix.trans turns them into the row-major A fragment; dy's rows are
// the B tile [k][n], read the way moe_gmm_bf16_kernel reads w.  Rows past C
// are zero-filled, so any C >= 1 is taken.  grid (F tiles, D tiles, E).
__global__ void __launch_bounds__(THREADS, 2)
moe_gmm_dw_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                  __nv_bfloat16* __restrict__ dw, int c, int d, int f) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BK][MNSTR]: x
  __nv_bfloat16* bs = as + STAGES * BK * MNSTR;                  // [STAGES][BK][MNSTR]: dy

  const int e = blockIdx.z;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const __nv_bfloat16* xe = x + static_cast<size_t>(e) * c * d;
  const __nv_bfloat16* dye = dy + static_cast<size_t>(e) * c * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[i][j][t] = 0.f;

  const int slices = (c + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slices) {
      load_k_cols<BM>(as + s * BK * MNSTR, xe, s * BK, row0, c, d);
      load_k_cols<BN>(bs + s * BK * MNSTR, dye, s * BK, col0, c, f);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < slices; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kt + STAGES - 1;
    if (next < slices) {
      load_k_cols<BM>(as + (next % STAGES) * BK * MNSTR, xe, next * BK, row0, c, d);
      load_k_cols<BN>(bs + (next % STAGES) * BK * MNSTR, dye, next * BK, col0, c, f);
    }
    cp_async_commit();
    const __nv_bfloat16* a_st = as + (kt % STAGES) * BK * MNSTR;
    const __nv_bfloat16* b_st = bs + (kt % STAGES) * BK * MNSTR;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[4][4];  // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15, k 8-15)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mi = lane / 8;
        const int k = kk + (mi / 2) * 8 + lane % 8;
        ldmatrix_x4_trans(a[i], a_st + k * MNSTR + wm * 64 + i * 16 + (mi % 2) * 8);
      }
      unsigned b[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int kr = kk + (lane % 8) + ((lane / 8) % 2) * 8;
        const int nc = wn * 32 + p * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(b[p], b_st + kr * MNSTR + nc);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j / 2][(j % 2) * 2], b[j / 2][(j % 2) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  store_tile(dw + static_cast<size_t>(e) * d * f, acc, row0, col0, d, f);
}

bool takes(const void* a, const void* b, const void* out, int e, int c, int d, int f) {
  const bool aligned = (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return aligned && e >= 1 && e <= 65535 && c >= 1 && d >= 8 && d % 8 == 0 && f >= 8 &&
         f % 8 == 0 && (c + BM - 1) / BM <= 65535 && (d + BM - 1) / BM <= 65535;
}

int launch_dx(const void* dy, const void* w, void* dx, int e, int c, int d, int f,
              cudaStream_t stream) {
  if (!takes(dy, w, dx, e, c, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // above 48 KB only after this attribute is set
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((d + BN - 1) / BN, (c + BM - 1) / BM, e);
  moe_gmm_dx_kernel<<<grid, THREADS, DX_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(dy), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(dx), c, d, f);
  return static_cast<int>(cudaGetLastError());
}

int launch_dw(const void* x, const void* dy, void* dw, int e, int c, int d, int f,
              cudaStream_t stream) {
  if (!takes(x, dy, dw, e, c, d, f)) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gmm_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((f + BN - 1) / BN, (d + BM - 1) / BM, e);
  moe_gmm_dw_kernel<<<grid, THREADS, DW_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(dy),
      static_cast<__nv_bfloat16*>(dw), c, d, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd

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
  return bwd::launch_dx(dy, w, dx, e, c, d, f, static_cast<cudaStream_t>(stream));
}

// dw (E, D, F) = x^T . dy per expert.
extern "C" int repro_moe_gmm_dw_bf16(const void* x, const void* dy, void* dw, int e, int c, int d,
                                     int f, void* stream) {
  return bwd::launch_dw(x, dy, dw, e, c, d, f, static_cast<cudaStream_t>(stream));
}
