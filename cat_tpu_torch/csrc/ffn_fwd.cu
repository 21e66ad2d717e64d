// Fused conformer feed-forward module, forward. Replaces the TPU kernel
// `_ff_fwd_kernel` of cat_tpu/ops/ffn_pallas.py (:76, `pallas_call` at
// :203):
//   out = x + alpha * drop1(drop0(SiLU(LN(x) . W1 + b1)) . W2 + b2)
// x, out (R, D) bf16; W1 (D, F), W2 (F, D) bf16 row-major; gamma, beta,
// b1, b2 f32. LN eps 1e-6. Rounding points as `ff_reference` (ops/ffn.py):
// h = LN(x) and a1 = drop0(SiLU(h1)) bf16, every sum f32. Dropout stream 0
// masks the (R, F) hidden, stream 1 the (R, D) output, both keyed by
// (row, column) as common_math.cuh defines (rate 0: no Philox at all), so
// that ffn_bwd.cu recomputes the same masks.
//
// What bounds it on the H100: 4·R·D·F operations, 51 GFLOP over the
// 12,664 valid rows of the training batch (R = 15,776, D = 512, F = 2048),
// 0.054 ms at 989 TFLOP/s bf16 (66 GFLOP, 0.067 ms over all R rows). The
// bytes of the staged design below (x read twice, h and a1 written once
// and read once, out written) are about 0.21 GB, 0.063 ms at 3.35 TB/s:
// the two bounds lie close together, and what keeps a simple kernel from
// them is feeding the tensor cores. So the products run on the Hopper GEMM
// mainloop of hopper_gemm.cuh (TMA ring under mbarriers, wgmma from
// shared memory, each weight tile loaded once per output tile), in three
// launches inside the one `ffn_fwd` call:
//   1. ln (one warp a row): h = LN(x), bf16, to scratch;
//   2. up (M = R, N = F, K = D): h . W1, W1 read by its columns
//      (MN-major), on cooperative tiles of 128 x 128; epilogue: bias,
//      SiLU (with the fast reciprocal, as ffn_bwd.cu recomputes it), drop0
//      and a1 to bf16 scratch. With K = D only 8 blocks of K deep, the
//      epilogue is as long as a tile's products unless it is lean: the 16
//      Philox draws of a thread are made before any of its shuffles, so
//      that they interleave, and each warp stages its 16 rows of a1 in
//      shared memory and stores whole 256-byte row segments;
//   3. down (M = R, N = D, K = F): a1 . W2, W2 as stored read MN-major
//      (its rows are the K index); epilogue: bias, drop1, alpha, the
//      residual x, the bf16 store of out. Cooperative tiles of 128 x 128,
//      or ping-pong tiles of 64 x 128 where the 128-row tiles would leave
//      the busiest SM with more 64-row steps (`hg::pingpong`: short R, as
//      the serving batch's 4,792 rows give 152 tiles of 128 rows on 132
//      SMs).
// Ping-pong up tiles, where one warpgroup's epilogue overlaps the other's
// products, measured no faster (tools/torch_ffn_ablate.py). The (R, F)
// hidden goes through device memory (65 MB each way at the training
// batch), which the TPU kernel keeps in VMEM. There are no atomics: two
// calls on the same inputs give the same bits. Every stage masks its own
// ragged edge: TMA reads zeros past R and F, the epilogues store only rows
// < R and columns < F.
#include "common_math.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace catk;

constexpr int LN_WARPS = 8;  // rows of an ln block, one a warp
constexpr int UP_STAGES = 5, DOWN_STAGES = 5;

using hg::cdiv;

// ---- 1. ln: h = LN(x) in bf16. Lane l of a warp holds columns
// 4(l + 32j) .. + 3.
template <int D>
__global__ void __launch_bounds__(LN_WARPS * 32)
    ffn_fwd_ln(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, bf16* __restrict__ h, int R) {
  constexpr int V = D / 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const size_t o = (size_t)row * D;
  float v[V][4];
#pragma unroll
  for (int j = 0; j < V; ++j) load4(x + o + 4 * (lane + 32 * j), v[j]);
  float mean, rstd;
  row_stats<V>(v, 1e-6f, mean, rstd);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = 4 * (lane + 32 * j);
    const float4 g = *reinterpret_cast<const float4*>(gamma + c);
    const float4 b = *reinterpret_cast<const float4*>(beta + c);
    const float gv[4] = {g.x, g.y, g.z, g.w}, bv[4] = {b.x, b.y, b.z, b.w};
    float hv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) hv[e] = (v[j][e] - mean) * rstd * gv[e] + bv[e];
    store4(h + o + c, hv);
  }
}

// ---- 2. up: a1 = drop0(SiLU(h . W1 + b1)) on tiles of 64 (PP) or 128
// rows x 128 columns of (R, F), tile t at rows ROWS·(t / nf), columns
// 128·(t % nf). Each consumer warp stages its 16 rows of a1 in shared
// memory (8-column chunks of a row XOR-swizzled by the row, so that
// neither side conflicts on banks) and stores them as whole 256-byte row
// segments, 16 bytes a lane.
template <bool PP>
__global__ void __launch_bounds__(hg::THREADS, 1)
    ffn_fwd_up(const __grid_constant__ CUtensorMap mh,
               const __grid_constant__ CUtensorMap mw1,
               const float* __restrict__ b1, bf16* __restrict__ a1, int R,
               int D, int F, Drop dr) {
  using S = hg::Shape<PP>;
  __shared__ __align__(16) bf16 stage[8][16 * hg::BN];
  bf16* const staged = &stage[0][0];
  const int nf = cdiv(F, hg::BN);
  const CUtensorMap *ph = &mh, *pw1 = &mw1;
  hg::run<1, UP_STAGES, 0, 1, PP, false>(
      cdiv(R, S::ROWS) * nf,
      [=](int t) {
        return hg::Tile{t / nf * S::ROWS, t % nf * hg::BN, D / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, ph, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pw1, bar, tl.n0, k);
        hg::tma_load(dst + S::A + 8192, pw1, bar, tl.n0 + 64, k);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        const int lane = threadIdx.x & 31, odd = lane & 1;
        bf16* st = staged + (threadIdx.x >> 5) * 16 * hg::BN;
        // the warp's first row; this thread holds rows q and q + 8 of its 16
        const int wrow = tl.m0 + ctx.rows + ((threadIdx.x & 127) >> 5) * 16;
        const int q = lane >> 2;
        uint32_t kb[2][2];
        hg::keep_tile(dr, 0, wrow + q, tl.n0 + hg::frag_col(0), kb);
#pragma unroll
        for (int n = 0; n < hg::BN / 8; ++n) {
          const int cl = hg::frag_col(4 * n), c = tl.n0 + cl;
          const float2 bias = c < F ? *reinterpret_cast<const float2*>(b1 + c)
                                    : make_float2(0.f, 0.f);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = q + 8 * i;
            const unsigned bits = hg::keep_bits(kb, i, n);
            float av[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float v = acc[0][4 * n + 2 * i + j] + (j ? bias.y : bias.x);
              const float sg = __fdividef(1.f, 1.f + __expf(-v));
              av[j] = v * sg * keep_scale(dr, bits, 2 * odd + j);
            }
            *reinterpret_cast<__nv_bfloat162*>(
                st + r * hg::BN + 8 * (n ^ (r & 7)) + (cl & 7)) =
                __floats2bfloat162_rn(av[0], av[1]);
          }
        }
        __syncwarp();
#pragma unroll
        for (int it = 0; it < 8; ++it) {
          const int r = 2 * it + (lane >> 4), j = lane & 15;
          const int row = wrow + r, c = tl.n0 + 8 * j;
          if (row < R && c < F)
            *reinterpret_cast<uint4*>(a1 + (size_t)row * F + c) =
                *reinterpret_cast<const uint4*>(st + r * hg::BN +
                                                8 * (j ^ (r & 7)));
        }
        __syncwarp();  // the stage is free for the next tile
      });
}

// ---- 3. down: out = x + alpha · drop1(a1 . W2 + b2) on tiles of 64 (PP)
// or 128 rows x 128 columns of (R, D), tile t at rows ROWS·(t / nd),
// columns 128·(t % nd).
template <bool PP>
__global__ void __launch_bounds__(hg::THREADS, 1)
    ffn_fwd_down(const __grid_constant__ CUtensorMap ma1,
                 const __grid_constant__ CUtensorMap mw2,
                 const bf16* __restrict__ x, const float* __restrict__ b2,
                 bf16* __restrict__ out, int R, int D, int F, float alpha,
                 Drop dr) {
  using S = hg::Shape<PP>;
  const int nd = D / hg::BN;
  const CUtensorMap *pa1 = &ma1, *pw2 = &mw2;
  hg::run<1, DOWN_STAGES, 0, 1, PP, false>(
      cdiv(R, S::ROWS) * nd,
      [=](int t) {
        return hg::Tile{t / nd * S::ROWS, t % nd * hg::BN, F / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, pa1, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pw2, bar, tl.n0, k);
        hg::tma_load(dst + S::A + 8192, pw2, bar, tl.n0 + 64, k);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        const int odd = threadIdx.x & 1;
        const int row0 = tl.m0 + ctx.rows + hg::frag_row(0);  // and row0 + 8
        uint32_t kb[2][2];
        hg::keep_tile(dr, 1, row0, tl.n0 + hg::frag_col(0), kb);
#pragma unroll
        for (int n = 0; n < hg::BN / 8; ++n) {
          const int c = tl.n0 + hg::frag_col(4 * n);
          const float2 bias = *reinterpret_cast<const float2*>(b2 + c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            if (row >= R) continue;
            const size_t o = (size_t)row * D + c;
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(x + o));
            const unsigned bits = hg::keep_bits(kb, i, n);
            float ov[2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              ov[j] = (acc[0][4 * n + 2 * i + j] + (j ? bias.y : bias.x)) *
                      keep_scale(dr, bits, 2 * odd + j);
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(xv.x + alpha * ov[0],
                                      xv.y + alpha * ov[1]);
          }
        }
      });
}

template <bool PP>
cudaError_t launch_down(const bf16* a1, const bf16* w2, const bf16* x,
                        const float* b2, bf16* out, int R, int D, int F,
                        float alpha, Drop dr, cudaStream_t s) {
  CUtensorMap ma1, mw2;
  CATK_TRY(hg::tensor_map(&ma1, a1, R, F, hg::Shape<PP>::ROWS));
  CATK_TRY(hg::tensor_map(&mw2, w2, F, D, 64));
  constexpr int smem = hg::smem_bytes<PP>(1, DOWN_STAGES);
  CATK_TRY(hg::prepare(ffn_fwd_down<PP>, smem, false));
  ffn_fwd_down<PP>
      <<<hg::grid_for(cdiv(R, hg::Shape<PP>::ROWS) * (D / hg::BN)),
         hg::THREADS, smem, s>>>(ma1, mw2, x, b2, out, R, D, F, alpha, dr);
  return cudaGetLastError();
}

template <bool PP>
cudaError_t launch_up(const bf16* h, const bf16* w1, const float* b1,
                      bf16* a1, int R, int D, int F, Drop dr,
                      cudaStream_t s) {
  CUtensorMap mh, mw1;
  CATK_TRY(hg::tensor_map(&mh, h, R, D, hg::Shape<PP>::ROWS));
  CATK_TRY(hg::tensor_map(&mw1, w1, D, F, 64));
  constexpr int smem = hg::smem_bytes<PP>(1, UP_STAGES);
  CATK_TRY(hg::prepare(ffn_fwd_up<PP>, smem, false));
  ffn_fwd_up<PP>
      <<<hg::grid_for(cdiv(R, hg::Shape<PP>::ROWS) * cdiv(F, hg::BN)),
         hg::THREADS, smem, s>>>(mh, mw1, b1, a1, R, D, F, dr);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const bf16* x, const float* gamma, const float* beta,
                   const bf16* w1, const float* b1, const bf16* w2,
                   const float* b2, bf16* out, bf16* h, bf16* a1, int R,
                   int F, float alpha, Drop dr, cudaStream_t s) {
  ffn_fwd_ln<D><<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(x, gamma, beta,
                                                            h, R);
  CATK_TRY(cudaGetLastError());
  CATK_TRY(launch_up<false>(h, w1, b1, a1, R, D, F, dr, s));
  return hg::pingpong(R, D / hg::BN)
             ? launch_down<true>(a1, w2, x, b2, out, R, D, F, alpha, dr, s)
             : launch_down<false>(a1, w2, x, b2, out, R, D, F, alpha, dr, s);
}

}  // namespace

// Returns the CUDA error of the launches (0 on success). x, out and h
// (R, D), a1 (R, F) bf16 (h and a1 are scratch, written whole); w1 (D, F)
// and w2 (F, D) bf16; gamma, beta, b1, b2 f32. D must be 128, 256, 384 or
// 512 and F a multiple of 64, every pointer 16-byte aligned; the Python
// wrapper checks both. seed0, seed1, thr: the dropout seed words and keep
// threshold as uint32 bit patterns; inv = 1 / (1 - rate).
extern "C" int ffn_fwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, void* h, void* a1, int R,
                       int D, int F, int seed0, int seed1, int thr,
                       float alpha, float inv, void* stream) {
  if (R <= 0) return cudaSuccess;
  if (F <= 0 || F % hg::BK != 0) return cudaErrorInvalidValue;
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto w1b = static_cast<const bf16*>(w1);
  auto w2b = static_cast<const bf16*>(w2);
  auto g = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto b1f = static_cast<const float*>(b1);
  auto b2f = static_cast<const float*>(b2);
  auto o = static_cast<bf16*>(out);
  auto hb = static_cast<bf16*>(h);
  auto a1b = static_cast<bf16*>(a1);
  switch (D) {
    case 128: return launch<128>(xb, g, be, w1b, b1f, w2b, b2f, o, hb, a1b, R, F, alpha, dr, s);
    case 256: return launch<256>(xb, g, be, w1b, b1f, w2b, b2f, o, hb, a1b, R, F, alpha, dr, s);
    case 384: return launch<384>(xb, g, be, w1b, b1f, w2b, b2f, o, hb, a1b, R, F, alpha, dr, s);
    case 512: return launch<512>(xb, g, be, w1b, b1f, w2b, b2f, o, hb, a1b, R, F, alpha, dr, s);
    default: return cudaErrorInvalidValue;
  }
}
