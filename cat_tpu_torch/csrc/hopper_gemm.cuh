// One Hopper GEMM mainloop for the port's kernels: TMA tiles in a ring of
// shared-memory stages under mbarriers, one producer warp, two consumer
// warpgroups issuing wgmma.mma_async (bf16 x bf16 -> f32), and an epilogue
// that each caller supplies. First used by ffn_bwd.cu, whose products
// replace the tensor-core work of the TPU kernel `_ff_bwd_kernel`
// (cat_tpu/ops/ffn_pallas.py:104). Its barriers, TMA loads, wgmma
// wrappers (m64n128 and m64n64, A from shared memory or registers) and
// host side also serve relpos_attention_fwd.cu's flash kernel, which runs
// a loop of its own.
//
// What bounds a product on the H100: 2·M·N·K operations at 989 TFLOP/s
// bf16 against each operand read once at 3.35 TB/s; the FF backward's
// products (K = 512 or 2048, or the R rows) lie far above the 295
// operations per byte where the tensor cores, not the memory, set the
// pace. What keeps a simple kernel from that bound is feeding the tensor
// cores: legacy `wmma` reads fragments through registers and stalls on
// every load. Here the producer keeps STAGES tiles in flight by TMA (one
// instruction a tile, addresses and 128-byte swizzle computed by the copy
// engine), and the consumers read their operands straight from shared
// memory with wgmma while the next tiles arrive.
//
// A block computes output tiles of BN = 128 columns one after another
// (persistent: block b takes tiles b, b + gridDim.x, ...), each as NOPS
// products of its own, each an f32 accumulator of 64 registers per
// consumer thread (a 64 x 128 wgmma fragment). Two schedules:
//  - cooperative: a tile has 128 rows, consumer warpgroup w owns rows
//    64w .. 64w + 63; for long K and light epilogues;
//  - ping-pong (PP): a tile has 64 rows and the two consumer warpgroups
//    take alternate tiles, so that one's epilogue runs while the other's
//    products keep the tensor cores busy; for heavy epilogues.
// A stage holds, for each product i, its A tile (rows x 64 of K) and its B
// tile (128 x 64 of K), 1024-byte aligned, in one of two layouts each
// (bit i of MN_A, MN_B):
//  - K-major (the K index contiguous in memory, as for rows of activations
//    times a weight read by its rows): one TMA box of rows x 64 K values;
//    128-byte rows swizzled in 8-row atoms of 1 KB. Descriptor: stride
//    byte offset 1 KB (the next 8 rows); a k16 slice starts 32 bytes
//    further.
//  - MN-major (the M or N index contiguous, as for a weight read by its
//    columns or when both operands are (R, .) activations and the sum runs
//    over R): TMA boxes of 64 K rows x 64 M (or N) values, each 8 KB after
//    the last. Descriptor: leading byte offset 8 KB (the next 64 M or N
//    values), stride byte offset 1 KB (the next 8 K rows), transpose bit
//    set; a k16 slice starts 2 KB further.
// Ragged edges: TMA fills every element outside the tensor with zeros (and
// still counts the whole box's bytes), so the products need no masks; the
// epilogue masks its stores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

// Returns from the enclosing host function with the CUDA error of `expr`
// unless it is cudaSuccess.
#define CATK_TRY(expr)                        \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

namespace hg {

constexpr int BN = 128, BK = 64;
constexpr int SMS = 132;  // streaming multiprocessors of an H100 SXM

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
constexpr int TILE_BYTES = BN * BK * 2;  // a B tile: 128 x 64 bf16
constexpr int THREADS = 384;  // two consumer warpgroups, one producer
constexpr int EPI_BYTES = 8 * BN * 4;  // epilogue scratch: 8 warps x BN f32

// Rows of a tile, and the bytes of one product's A tile and of its A and
// B tiles together, by schedule.
template <bool PP>
struct Shape {
  static constexpr int ROWS = PP ? 64 : 128;
  static constexpr int A = ROWS * BK * 2;
  static constexpr int OP = A + TILE_BYTES;
};

// Dynamic shared memory of a kernel built on `run`.
template <bool PP>
__host__ __device__ constexpr int smem_bytes(int nops, int stages) {
  return 1024 + stages * nops * Shape<PP>::OP + 2 * stages * 8 + 16 +
         EPI_BYTES;
}

// A tile: its first row and column, its blocks of K (nk > 0) and the
// first of them, and which of a kernel's products it belongs to.
struct Tile {
  int m0, n0, nk, k0, which;
};

// What an epilogue gets besides the tile and the fragments: the first row
// of its warpgroup's 64 rows within the tile, shared scratch, this warp's
// slot of the `nslots` warps that share it, and a barrier over them.
struct Ctx {
  int rows;
  float* scratch;
  int slot, nslots, bar;
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * nslots) : "memory");
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.b32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits for the phase of `parity` to complete. A wait of more than 4 s
// means a lost copy or a broken pipeline: trap, so that the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > 4000000000ull) __trap();
  }
}

// ---- TMA: one 2-D box of `map` at (column c0, row c1) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32 fragment) += A (64 x 16) . B (16 x 128), both from
// shared memory; TA, TB = 1 for MN-major operands; scale_d = 0 overwrites.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n\t}"
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
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64 f32 fragment) += A (64 x 16) . B (16 x 64), both from shared
// memory; TA, TB = 1 for MN-major operands; scale_d = 0 overwrites.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d (64 x 64 f32 fragment) += A (64 x 16, registers) . B (16 x 64, shared
// memory); TB = 1 for an MN-major B; scale_d = 0 overwrites. A register i
// of a thread holds the bf16 pair of row frag_row(2i), columns
// frag_col(2i), + 1 of the 16: the layout of the accumulator registers
// 8j + 2i, + 1 of a product whose 16-column slice j becomes the A operand
// (`pack_bf16`).
template <int TB>
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

// Two f32 values as the bf16 pair of a 32-bit A register (lo: the lower
// column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator register r of a consumer thread holds row frag_row(r) of its
// warpgroup's 64 rows and column frag_col(r) of the tile's 128: warp w of
// the warpgroup owns rows 16w .. 16w + 15, lane l rows l/4 and l/4 + 8 of
// those and columns 2(l%4), 2(l%4) + 1 of every 8.
__device__ __forceinline__ int frag_row(int r) {
  const int t = threadIdx.x & 127;
  return (t >> 5) * 16 + ((t & 31) >> 2) + ((r >> 1) & 1) * 8;
}

__device__ __forceinline__ int frag_col(int r) {
  return (r >> 2) * 8 + (threadIdx.x & 3) * 2 + (r & 1);
}

// The mainloop. Every thread of a block of THREADS calls it once, with
// `ntiles` tiles; tile(t) gives tile t (an `hg::Tile`). The producer thread
// calls load(tile, kb, dst, bar) for kb < tile.nk, which issues the
// stage's tiles by tma_load on `bar`: the A tile of product i at
// dst + i·Shape<PP>::OP, its B tile Shape<PP>::A bytes further. The
// consumers then call epi(tile, acc, ctx) with acc[i] the fragment of
// product i. REGS moves registers from the producer to the consumers
// (setmaxnreg 40 / 232; the kernel must be compiled with 168 registers a
// thread, which `prepare` checks).
template <int NOPS, int STAGES, int MN_A, int MN_B, bool PP, bool REGS,
          class TileF, class Load, class Epi>
__device__ __forceinline__ void run(int ntiles, const TileF& tile,
                                    const Load& load, const Epi& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  using S = Shape<PP>;
  constexpr uint32_t STAGE = NOPS * S::OP;
  const uint32_t full = base + STAGES * STAGE;  // STAGES barriers of 8 B
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t order = empty + 8 * STAGES;  // ping-pong: 2 barriers
  float* scratch = reinterpret_cast<float*>(smem_raw + (order + 16 - raw));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      // one arrival per consumer warpgroup that reads the stage
      mbar_init(empty + 8 * s, PP ? 1 : 2);
    }
    mbar_init(order, 1);
    mbar_init(order + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 2) {  // producer
    if constexpr (REGS) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 256) {
      int st = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const Tile tl = tile(t);
        for (int kb = 0; kb < tl.nk; ++kb) {
          mbar_wait(empty + 8 * st, ph ^ 1);
          mbar_expect_tx(full + 8 * st, STAGE);
          load(tl, kb, base + st * STAGE, full + 8 * st);
          if (++st == STAGES) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  if constexpr (REGS) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const Ctx ctx = PP ? Ctx{0, scratch + wg * 4 * BN, (threadIdx.x >> 5) & 3,
                           4, 2 + wg}
                     : Ctx{64 * wg, scratch, threadIdx.x >> 5, 8, 1};
  float acc[NOPS][64];
#pragma unroll
  for (int i = 0; i < NOPS; ++i)
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[i][r] = 0.f;
  // Ping-pong: warpgroup w takes the block's tiles q = w, w + 2, ...; the
  // j-th one starts its products only after the other warpgroup's
  // products of tile q - 1 have been issued (barrier order + 8·(1 - w)
  // completes one phase per tile of the other warpgroup). So the two
  // take turns on the tensor cores, and a warpgroup never waits for a
  // stage more than one phase of its barrier ahead.
  int st = 0, j = 0;
  uint32_t ph = 0;
  for (int t = blockIdx.x, q = 0; t < ntiles; t += gridDim.x, ++q) {
    const Tile tl = tile(t);
    if (PP && (q & 1) != wg) {  // the other warpgroup's tile: skip its stages
      st += tl.nk;
      ph ^= (st / STAGES) & 1;
      st %= STAGES;
      continue;
    }
    if (PP && q > 0) mbar_wait(order + 8 * (1 - wg), (wg ? j : j - 1) & 1);
    int prev = 0;
    for (int kb = 0; kb < tl.nk; ++kb) {
      mbar_wait(full + 8 * st, ph);
      const uint32_t s0 = base + st * STAGE;
#pragma unroll
      for (int i = 0; i < NOPS; ++i) fence_acc(acc[i]);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < NOPS; ++i) {
        const bool ma = (MN_A >> i) & 1, mb = (MN_B >> i) & 1;
        // A: this warpgroup's 64 rows (K-major) or columns (MN-major, the
        // second box) lie 8 KB further in a cooperative tile
        const uint64_t da = desc(s0 + i * S::OP + (PP ? 0 : wg * 8192),
                                 ma ? 8192 : 16, 1024);
        const uint64_t db = desc(s0 + i * S::OP + S::A, mb ? 8192 : 16, 1024);
#pragma unroll
        for (int k = 0; k < BK / 16; ++k) {
          const uint64_t a = da + ((k * (ma ? 2048 : 32)) >> 4);
          const uint64_t b = db + ((k * (mb ? 2048 : 32)) >> 4);
          const int sc = (kb | k) != 0;
          if (ma && mb)
            wgmma_n128<1, 1>(acc[i], a, b, sc);
          else if (ma)
            wgmma_n128<1, 0>(acc[i], a, b, sc);
          else if (mb)
            wgmma_n128<0, 1>(acc[i], a, b, sc);
          else
            wgmma_n128<0, 0>(acc[i], a, b, sc);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
      for (int i = 0; i < NOPS; ++i) fence_acc(acc[i]);
      // the products of the previous stage are done: release it
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      if (kb > 0 && (threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * prev);
      prev = st;
      if (++st == STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    if (PP && (threadIdx.x & 127) == 0) mbar_arrive(order + 8 * wg);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
    for (int i = 0; i < NOPS; ++i) fence_acc(acc[i]);
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * prev);
    epi(tl, acc, ctx);
    ++j;
  }
}

// The schedule of a product of R rows and n column tiles: ping-pong
// tiles of 64 rows where the SM with the most tiles would take fewer
// 64-row steps than with cooperative tiles of 128 rows (short R).
static inline bool pingpong(int R, int n) {
  return cdiv(cdiv(R, 64) * n, SMS) < 2 * cdiv(cdiv(R, 128) * n, SMS);
}

// Blocks of a persistent launch over `ntiles` tiles: one per SM at most.
static inline int grid_for(int ntiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return ntiles < sms ? ntiles : sms;
}

// ---- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which the libraries do not
// link; the CUDA runtime hands out its entry point.
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 (rows, cols) matrix whose boxes are
// box_rows x 64 columns, 128-byte swizzle, zeros outside the matrix. cols
// must be a multiple of 8 and `ptr` 16-byte aligned.
static inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr,
                                     int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Sets the kernel's dynamic shared memory; with `regs`, refuses a kernel
// that ptxas did not give the 168 registers a thread that setmaxnreg's
// 40 / 232 split needs (setmaxnreg.inc would wait for ever). Each is done
// once per device and kernel (by its address: several kernels share one
// function type), and again only for a larger shared-memory size: the
// host cost of a call is then the launch and its tensor maps.
static inline cudaError_t prepare_fn(const void* kernel, int smem,
                                     bool regs) {
  struct Done {
    int dev;
    const void* kernel;
    int smem;
    bool regs;
  };
  static std::mutex mu;
  static Done done[32];
  static int ndone = 0;
  int dev = 0;
  CATK_TRY(cudaGetDevice(&dev));
  std::lock_guard<std::mutex> lock(mu);
  Done* d = nullptr;
  for (int i = 0; i < ndone; ++i)
    if (done[i].dev == dev && done[i].kernel == kernel) d = &done[i];
  if (d != nullptr && d->smem >= smem && (d->regs || !regs))
    return cudaSuccess;
  if (d != nullptr) {
    smem = smem > d->smem ? smem : d->smem;
    regs = regs || d->regs;
  }
  CATK_TRY(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  if (regs) {
    cudaFuncAttributes attr;
    CATK_TRY(cudaFuncGetAttributes(&attr, kernel));
    if (attr.numRegs * THREADS < 128 * 40 + 256 * 232)
      return cudaErrorInvalidConfiguration;
  }
  if (d == nullptr && ndone < 32) d = &done[ndone++];
  if (d != nullptr) *d = Done{dev, kernel, smem, regs};
  return cudaSuccess;
}

template <class K>
static inline cudaError_t prepare(K kernel, int smem, bool regs) {
  return prepare_fn(reinterpret_cast<const void*>(kernel), smem, regs);
}

}  // namespace hg
