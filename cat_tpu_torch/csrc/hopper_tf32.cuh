// A Hopper GEMM mainloop in 3xTF32 for the port's float32 kernels, beside
// the bf16 one of hopper_gemm.cuh and built from its barriers, TMA loads,
// descriptors and host side: TMA tiles in a ring of shared-memory stages
// under mbarriers, one producer warp, two consumer warpgroups issuing
// wgmma.mma_async (tf32 x tf32 -> f32) on cooperative tiles of 128 rows x
// 128 columns, and an epilogue that each caller supplies. First used by
// the float32 FF backward (ffn_f32.cu, the f32 route of
// `_ff_bwd_kernel`, cat_tpu/ops/ffn_pallas.py:104), whose reference is
// exact float32.
//
// Why 3xTF32: a tensor core reads a TF32 operand's top 19 bits (1 sign, 8
// exponent, 10 mantissa), so one TF32 product keeps about three decimal
// digits. Each f32 operand is split as x = hi + lo, both TF32 values, and
// a product sums lo·hi + hi·lo + hi·hi in f32, the small terms first
// (lo·lo, below 2^-22 of the product, is dropped). The
// rounding rule, `split`: hi = rna(x), lo = rna(x - hi), where rna rounds
// to nearest with ties away from zero at TF32's 10 mantissa bits, done on
// the bit pattern as (bits + 0x1000) & 0xFFFFE000 (the rule of
// cvt.rna.tf32.f32 on finite values); x - hi is exact in f32. hi + lo
// then equals x within 2^-22 relative, or within 2^-137 (half the TF32
// step of f32's subnormals) where lo is subnormal, |x| below about
// 2^-115. `ops/ffn.py` `tf32_split` is its plain twin. The tensor cores
// run at 495 TFLOP/s TF32 on an H100 SXM, so three products reach 165
// TFLOP/s of float32 work, 2.5x the 67 of the CUDA cores.
//
// TF32 wgmma takes both operands K-major from shared memory (the
// transpose bits of the 16-bit types do not exist for it), so every
// operand reaches a stage K-major: one TMA box of 128 rows x 32 K values
// (128 bytes a row), 128-byte swizzle in 8-row atoms of 1 KB, the layout
// and descriptors of the bf16 mainloop's K-major tiles (a k8 step of TF32
// is 32 bytes, as a k16 step of bf16). A stage holds four tiles of 16 KB:
//   A   the A rows as loaded (then, in place, their hi parts),
//   Alo the A rows' lo parts, written by the consumers,
//   Bhi, Blo  B's hi and lo parts, loaded as the caller split them in
//             device memory beforehand (weights, or small (D, R) planes).
// Each consumer warpgroup splits its own 64 rows of A after the stage
// arrives (16 values a thread), fences the writes for the async proxy,
// syncs its 128 threads and issues the stage's 12 products into a fresh
// fragment, the small terms Alo·Bhi and A·Blo of its four k8 steps
// first, then A·Bhi. Once they are done it frees the stage and adds the
// fragment into an f32 accumulator in registers: the tensor cores' own
// accumulation (whose rounding of aligned sums is not specified as IEEE
// round to nearest) runs over one stage only, and the long sum over K, up
// to the R rows of a weight gradient, is a chain of f32 additions
// rounded to nearest, as the plain float32 version's. Two variants
// measured slower on the H100 (PERF.md §6): splitting the next stage
// while a stage's products run, which leaves the TMA loads STAGES - 2
// stages of lead instead of STAGES - 1, and issuing the next tile's
// first products before a tile's epilogue, which spills registers.
// Ragged edges: TMA fills every element outside a tensor with zeros and
// still counts the whole box's bytes; the epilogue masks its stores.
#pragma once

#include "hopper_gemm.cuh"

namespace tc {

constexpr int ROWS = 128;        // rows of a tile: warpgroup w has 64w ..
constexpr int BN = hg::BN;       // columns of a tile (one m64n128 fragment)
constexpr int BK = 32;           // K values of a stage: 128 bytes of f32
constexpr int TILE = 128 * 128;  // bytes of an A or B tile
constexpr int OP = 4 * TILE;     // a stage: A, Alo, Bhi, Blo

// Dynamic shared memory of a kernel built on `run`.
__host__ __device__ constexpr int smem_bytes(int stages) {
  return 1024 + stages * OP + 2 * stages * 8;
}

// ---- the split (see the header note)
__device__ __forceinline__ float rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = rna(x);
  lo = rna(x - hi);
}

// d (64 x 128 f32 fragment) += A (64 x 8) . B (8 x 128), both TF32 from
// shared memory, K-major; scale_d = 0 overwrites.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// A stage's three TMA boxes: the A tile of rows m0.. at K column k, the B
// tiles (hi, lo) of rows n0.. at k.
__device__ __forceinline__ void load3(uint32_t dst, uint32_t bar,
                                      const CUtensorMap* a,
                                      const CUtensorMap* bhi,
                                      const CUtensorMap* blo, int m0, int n0,
                                      int k) {
  hg::tma_load(dst, a, bar, k, m0);
  hg::tma_load(dst + 2 * TILE, bhi, bar, k, n0);
  hg::tma_load(dst + 3 * TILE, blo, bar, k, n0);
}

// The mainloop. Every thread of a block of hg::THREADS calls it once, with
// `ntiles` tiles; tile(t) gives tile t (an `hg::Tile`, nk stages of BK).
// The producer thread calls load(tile, kb, dst, bar) for kb < tile.nk,
// which issues the stage's A, Bhi and Blo boxes on `bar` (`load3`). The
// consumers then call epi(tile, acc, wg) with acc warpgroup wg's 64 x 128
// fragment (rows 64·wg + hg::frag_row(r), columns hg::frag_col(r)).
template <int STAGES, class TileF, class Load, class Epi>
__device__ __forceinline__ void run(int ntiles, const TileF& tile,
                                    const Load& load, const Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t full = base + STAGES * OP;  // STAGES barriers of 8 B
  const uint32_t empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full + 8 * s, 1);
      hg::mbar_init(empty + 8 * s, 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // producer
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const hg::Tile tl = tile(t);
        for (int kb = 0; kb < tl.nk; ++kb) {
          hg::mbar_wait(empty + 8 * st, ph ^ 1);
          hg::mbar_expect_tx(full + 8 * st, 3 * TILE);
          load(tl, kb, base + st * OP, full + 8 * st);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x & 127;
  float acc[64], part[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) part[r] = 0.f;
  int st = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const hg::Tile tl = tile(t);
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    for (int kb = 0; kb < tl.nk; ++kb) {
      hg::mbar_wait(full + 8 * st, ph);
      // split this warpgroup's 64 rows of A (8 KB) into A (hi) and Alo
      float4* a = reinterpret_cast<float4*>(gbase + st * OP + wg * 8192);
      float4* alo = reinterpret_cast<float4*>(gbase + st * OP + TILE +
                                              wg * 8192);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = a[tid + 128 * i];
        float4 h, l;
        split(v.x, h.x, l.x);
        split(v.y, h.y, l.y);
        split(v.z, h.z, l.z);
        split(v.w, h.w, l.w);
        a[tid + 128 * i] = h;
        alo[tid + 128 * i] = l;
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      const uint32_t s0 = base + st * OP;
      const uint64_t ah = hg::desc(s0 + wg * 8192, 16, 1024);
      const uint64_t al = hg::desc(s0 + TILE + wg * 8192, 16, 1024);
      const uint64_t bh = hg::desc(s0 + 2 * TILE, 16, 1024);
      const uint64_t bl = hg::desc(s0 + 3 * TILE, 16, 1024);
      hg::fence_acc(part);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      // the stage's partial: the small terms of its four k8 steps (32
      // bytes each) first, then the large ones
#pragma unroll
      for (int k = 0; k < BK / 8; ++k) {
        wgmma_tf32(part, al + 2 * k, bh + 2 * k, k != 0);
        wgmma_tf32(part, ah + 2 * k, bl + 2 * k, 1);
      }
#pragma unroll
      for (int k = 0; k < BK / 8; ++k)
        wgmma_tf32(part, ah + 2 * k, bh + 2 * k, 1);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(part);
      if (tid == 0) hg::mbar_arrive(empty + 8 * st);  // the stage is free
      // promoted into the f32 accumulator, rounded to nearest: the
      // tensor cores' own sum runs over the 12 products of one stage
#pragma unroll
      for (int r = 0; r < 64; ++r) acc[r] += part[r];
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    epi(tl, acc, wg);
  }
}

// Tensor map of a row-major f32 (rows, cols) matrix of leading dimension
// ld (a multiple of 4), boxes of 128 rows x 32 columns, 128-byte swizzle,
// zeros outside the matrix; `ptr` 16-byte aligned.
static inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr,
                                     int rows, int cols, int ld) {
  const hg::EncodeTiled fn = hg::encode_tiled();
  if (fn == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)ROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace tc
