// The conformer convolution module's exit stage, bn_out, forward and
// backward (the entry stage, glu_in, is glu_in.cu). Replaces the TPU
// kernels `_bn_out_fwd_kernel` (cat_tpu/ops/conv_module_pallas.py:237,
// `pallas_call` at :330) and `_bn_out_bwd_kernel` (:261, `pallas_call` at
// :364):
//   forward:  xn = (c - mu) · rstd, rstd = rsqrt(var + 1e-5),
//             y0 = xn · s + t, y = SiLU(y0) (bf16),
//             out = x + mask · drop(y . W + b)
//   backward, given dO: dh = drop(dO · mask), db = sum_rows dh (before
//             dh is rounded to bf16), dW = y^T . dh,
//             dy0 = (dh . W^T) · SiLU'(y0), dconv = dy0 · s · rstd (bf16),
//             dbias = sum_rows dy0, dscale = sum_rows dy0 · xn, and for the
//             batch statistics dmu = -s · rstd · sum dy0 and
//             dvar = -0.5 · s · rstd² · sum dy0 · xn, so that autograd
//             completes the statistics -> conv output chain outside the
//             kernel; dx = dO (the residual) is the wrapper's.
// conv, x, out, dconv (R, D) bf16; W (D, D) bf16 row-major; mask (R,),
// mu, var, s, t, b f32. mu and var are the running statistics in eval and
// the masked batch statistics in training. The dropout is stream 0 of
// common_math.cuh by (row, column) (rate 0: no Philox at all), the mask
// `dropout_scale(seed, 0, 1, R, D, rate)` draws in ops/dropout.py.
// Rounding points as `bn_out_reference` and `bn_out_backward_reference`
// (ops/conv_module.py).
//
// What bounds them on the H100, at the training batch (R = 15,776 rows,
// 12,664 valid, D = 512): the forward does 2·R·D² operations (6.6 GFLOP
// over the valid rows, 0.0067 ms at 989 TFLOP/s bf16) and moves at least
// c and x in and out, 39 MB (0.0118 ms at 3.35 TB/s); the backward
// 4·R·D² (dy and dW, 0.0134 ms). The TPU kernel keeps W in VMEM and
// carries its sums across the grid; here blocks run in no order, so the
// products run on the Hopper GEMM mainloop of hopper_gemm.cuh (TMA ring
// under mbarriers, a producer warp, two wgmma consumer warpgroups, each W
// tile loaded once per output tile into shared memory) and every sum
// across blocks goes through partials summed in a fixed order. Forward,
// two launches inside the one `bn_out_fwd` call:
//   1. rows (one warp a row): y = SiLU(BN(c)), bf16, to scratch;
//   2. product (M = R, N = D, K = D): y . W, W read by its columns
//      (MN-major); epilogue: bias, the dropout, the mask and the residual
//      x, the bf16 store of out. Ping-pong tiles of 64 rows whatever R
//      is: with at most D / 64 = 8 blocks of K a tile's epilogue (x
//      read, Philox drawn) is as long as its products, and one
//      warpgroup's epilogue runs while the other's products keep the
//      tensor cores busy (tools/torch_bn_out_ablate.py times the
//      cooperative 128-row tiles, `launch_fwd_product<false>`).
// Backward, four launches inside the one `bn_out_bwd` call:
//   1. prep (64-row blocks, 4 rows a warp): y to scratch, dh in bf16 to
//      scratch, and the db column partials of the block from dh before its
//      rounding;
//   2. down (M = R, N = D, K = D): dy = dh . W^T, W as stored K-major, on
//      ping-pong tiles of 64 rows (one warpgroup's heavy epilogue runs
//      while the other's products keep the tensor cores busy); epilogue:
//      c read back, xn, y0 and sigmoid(y0) recomputed, dy0, dconv in bf16,
//      and the column partials sum dy0 and sum dy0 · xn of the tile's 64
//      rows;
//   3. wgrad (K = R): dW = y^T . dh, (D, D), both operands MN-major, R
//      split so that the (D/128)² output tiles of 128 x 128 fill the 132
//      SMs; a split writes its f32 partial to the workspace (or dW when R
//      is not split);
//   4. reduce: the weight partials and the column partials summed in a
//      fixed order, then dmu and dvar from the sums.
// The split and the workspace are planned in Python (`bn_out_plan`,
// ops/conv_module.py); `bn_out_bwd` refuses a plan that does not cover
// every row block exactly once. There are no atomics: two calls on the
// same inputs give the same bits, and every gradient output is written
// whole (zeros at R = 0). Every stage masks its own ragged edge: TMA reads
// zeros past R, the epilogues store only rows < R, and rows past R give
// dh = 0 and dy0 = 0 and so add nothing to the sums.
#include "common_math.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace catk;

constexpr int ROWS = 64;        // rows of a partial block: prep block, down tile
constexpr int RW = 256;         // threads of the forward's row pass: 8 warps
// warps of a 64-row block of the backward's prep pass, 4 rows each
// (tools/torch_bn_out_ablate.py times 8)
constexpr int PREP_WARPS = 16;
constexpr int MAX_SPLITS = 16;  // splits of R in the wgrad stage
// stages of the rings (the products are at most D / 64 = 8 blocks of K
// deep; tools/torch_bn_out_ablate.py times 3, 6 and 8)
constexpr int FWD_STAGES = 4, FWD_STAGES_PP = 4;
constexpr int DOWN_STAGES = 4, WGRAD_STAGES = 4;

using hg::cdiv;
using hg::SMS;

// y0 = (c - mu) · rsqrt(var + 1e-5) · s + t of the four columns c0 .. c0
// + 3.
__device__ __forceinline__ void bn4(const float (&cv)[4],
                                    const float* __restrict__ mu,
                                    const float* __restrict__ var,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias, int c0,
                                    float (&y0)[4]) {
  const float4 m = *reinterpret_cast<const float4*>(mu + c0);
  const float4 v = *reinterpret_cast<const float4*>(var + c0);
  const float4 s = *reinterpret_cast<const float4*>(scale + c0);
  const float4 t = *reinterpret_cast<const float4*>(bias + c0);
  const float mv[4] = {m.x, m.y, m.z, m.w}, vv[4] = {v.x, v.y, v.z, v.w};
  const float sv[4] = {s.x, s.y, s.z, s.w}, tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    y0[e] = (cv[e] - mv[e]) * rsqrtf(vv[e] + 1e-5f) * sv[e] + tv[e];
}

// The bf16 pairs of (R, D) rows that a consumer thread's share of a 64 x
// 128 fragment covers: rows row0 and row0 + 8 (zeros past R), columns
// n0 + frag_col(4n), + 1. An epilogue loads them all before its first
// store, so that their latencies overlap (the compiler may not move a
// load past a store to another array it cannot prove apart).
__device__ __forceinline__ void load_pairs(const bf16* __restrict__ p,
                                           int row0, int n0, int R, int D,
                                           uint32_t (&v)[2][hg::BN / 8]) {
#pragma unroll
  for (int n = 0; n < hg::BN / 8; ++n)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      v[i][n] = row < R ? *reinterpret_cast<const uint32_t*>(
                              p + (size_t)row * D + n0 + hg::frag_col(4 * n))
                        : 0u;
    }
}

__device__ __forceinline__ float2 pair(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---- forward 1. rows: y = SiLU(BN(c)) in bf16, one warp a row, 8 rows a
// block. Lane l of a warp holds columns 4(l + 32j) .. + 3.
template <int D>
__global__ void __launch_bounds__(RW)
    bn_out_fwd_rows(const bf16* __restrict__ conv,
                    const float* __restrict__ mu,
                    const float* __restrict__ var,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, bf16* __restrict__ y,
                    int R) {
  constexpr int V = D / 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (RW / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const size_t o = (size_t)row * D;
  float cv[V][4];
#pragma unroll
  for (int j = 0; j < V; ++j) load4(conv + o + 4 * (lane + 32 * j), cv[j]);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = 4 * (lane + 32 * j);
    float yv[4];
    bn4(cv[j], mu, var, scale, bias, c, yv);
#pragma unroll
    for (int e = 0; e < 4; ++e) yv[e] *= sigmoid(yv[e]);
    store4(y + o + c, yv);
  }
}

// ---- forward 2. product: out = x + mask · drop(y . W + b) on tiles of 64
// (PP) or 128 rows x 128 columns of (R, D), tile t at rows ROWS·(t / nd),
// columns 128·(t % nd).
template <bool PP>
__global__ void __launch_bounds__(hg::THREADS, 1)
    bn_out_fwd_product(const __grid_constant__ CUtensorMap my,
                       const __grid_constant__ CUtensorMap mw,
                       const bf16* __restrict__ x,
                       const float* __restrict__ mask,
                       const float* __restrict__ bw, bf16* __restrict__ out,
                       int R, int D, Drop dr) {
  using S = hg::Shape<PP>;
  const int nd = D / hg::BN;
  const CUtensorMap *py = &my, *pw = &mw;
  hg::run<1, PP ? FWD_STAGES_PP : FWD_STAGES, 0, 1, PP, false>(
      cdiv(R, S::ROWS) * nd,
      [=](int t) {
        return hg::Tile{t / nd * S::ROWS, t % nd * hg::BN, D / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, py, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pw, bar, tl.n0, k);
        hg::tma_load(dst + S::A + 8192, pw, bar, tl.n0 + 64, k);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        const int odd = threadIdx.x & 1;
        const int row0 = tl.m0 + ctx.rows + hg::frag_row(0);  // and row0 + 8
        const float mk[2] = {row0 < R ? mask[row0] : 0.f,
                             row0 + 8 < R ? mask[row0 + 8] : 0.f};
        uint32_t xr[2][hg::BN / 8];
        load_pairs(x, row0, tl.n0, R, D, xr);
        uint32_t kb[2][2];
        hg::keep_tile(dr, 0, row0, tl.n0 + hg::frag_col(0), kb);
#pragma unroll
        for (int n = 0; n < hg::BN / 8; ++n) {
          const int c = tl.n0 + hg::frag_col(4 * n);
          const float2 bias = *reinterpret_cast<const float2*>(bw + c);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            if (row >= R) continue;
            const size_t o = (size_t)row * D + c;
            const float2 xv = pair(xr[i][n]);
            const unsigned bits = hg::keep_bits(kb, i, n);
            float hv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j)
              hv[j] = (acc[0][4 * n + 2 * i + j] + (j ? bias.y : bias.x)) *
                      keep_scale(dr, bits, 2 * odd + j);
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(xv.x + mk[i] * hv[0],
                                      xv.y + mk[i] * hv[1]);
          }
        }
      });
}

// ---- backward 1. prep: y and dh = drop(dO · mask) in bf16 to scratch, and
// the db column partials of each 64-row block, pdb (blocks, D): warp w of
// PREP_WARPS takes rows w, w + PREP_WARPS, ... of the block (a row's c and
// dO loaded before its first store), sums its rows in order, and the warp
// sums are then added in order. Lane l holds columns 4(l + 32j) .. + 3.
template <int D>
__global__ void __launch_bounds__(PREP_WARPS * 32)
    bn_out_bwd_prep(const bf16* __restrict__ conv,
                    const float* __restrict__ mask,
                    const float* __restrict__ mu,
                    const float* __restrict__ var,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ dout, bf16* __restrict__ y,
                    bf16* __restrict__ dh, float* __restrict__ pdb, int R,
                    Drop dr) {
  constexpr int V = D / 128;
  __shared__ float red[PREP_WARPS][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[V][4] = {};
  for (int r = warp; r < ROWS; r += PREP_WARPS) {
    const int row = blockIdx.x * ROWS + r;
    if (row >= R) break;
    const size_t o = (size_t)row * D;
    const float mk = mask[row];
    // the row's c and dO as loaded, converted only where they are used
    uint2 cu[V], du[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      cu[j] = *reinterpret_cast<const uint2*>(conv + o + 4 * (lane + 32 * j));
      du[j] = *reinterpret_cast<const uint2*>(dout + o + 4 * (lane + 32 * j));
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int g = lane + 32 * j, c = 4 * g;
      float cv[4], dv[4], yv[4], hv[4];
      unpack4(cu[j], cv);
      unpack4(du[j], dv);
      bn4(cv, mu, var, scale, bias, c, yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) yv[e] *= sigmoid(yv[e]);
      store4(y + o + c, yv);
      const unsigned kb = keep4(dr, 0, 0, row, g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hv[e] = dv[e] * mk * keep_scale(dr, kb, e);
        acc[j][e] += hv[e];
      }
      store4(dh + o + c, hv);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * (lane + 32 * j) + e] = acc[j][e];
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += PREP_WARPS * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < PREP_WARPS; ++w) s += red[w][c];
    pdb[(size_t)blockIdx.x * D + c] = s;
  }
}

// ---- backward 2. down: dy = dh . W^T on ping-pong tiles of 64 x 128 of
// (R, D), tile t at rows 64·(t / nd), columns 128·(t % nd); dh and W both
// K-major (the sum runs along their rows). Epilogue: dy0, dconv, and the
// column partials of the tile's 64 rows, pdy (sum dy0) and pdx (sum
// dy0 · xn), (blocks, D) each, summed over each warp's 16 rows by shuffles
// and then over the warpgroup's 4 warps in order through `red`.
__global__ void __launch_bounds__(hg::THREADS, 1)
    bn_out_bwd_down(const __grid_constant__ CUtensorMap mdh,
                    const __grid_constant__ CUtensorMap mwk,
                    const bf16* __restrict__ conv,
                    const float* __restrict__ mu,
                    const float* __restrict__ var,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    bf16* __restrict__ dconv, float* __restrict__ pdy,
                    float* __restrict__ pdx, int R, int D) {
  using S = hg::Shape<true>;
  __shared__ float red[8][2 * hg::BN];
  float* const redp = &red[0][0];
  const int nd = D / hg::BN;
  const CUtensorMap *pdh = &mdh, *pwk = &mwk;
  hg::run<1, DOWN_STAGES, 0, 0, true, false>(
      cdiv(R, S::ROWS) * nd,
      [=](int t) {
        return hg::Tile{t / nd * S::ROWS, t % nd * hg::BN, D / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, pdh, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pwk, bar, k, tl.n0);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        const int lane = threadIdx.x & 31;
        const int row0 = tl.m0 + ctx.rows + hg::frag_row(0);  // and row0 + 8
        float* const mine = redp + (threadIdx.x >> 5) * 2 * hg::BN;
        uint32_t cr[2][hg::BN / 8];
        load_pairs(conv, row0, tl.n0, R, D, cr);
#pragma unroll
        for (int n = 0; n < hg::BN / 8; ++n) {
          const int cl = hg::frag_col(4 * n), c = tl.n0 + cl;
          const float2 m2 = *reinterpret_cast<const float2*>(mu + c);
          const float2 v2 = *reinterpret_cast<const float2*>(var + c);
          const float2 s2 = *reinterpret_cast<const float2*>(scale + c);
          const float2 t2 = *reinterpret_cast<const float2*>(bias + c);
          const float rs[2] = {rsqrtf(v2.x + 1e-5f), rsqrtf(v2.y + 1e-5f)};
          float sb[2] = {0.f, 0.f}, sx[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            if (row >= R) continue;  // dy0 = 0 there: nothing to add
            const size_t o = (size_t)row * D + c;
            const float2 cv = pair(cr[i][n]);
            float dc[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float xn = ((j ? cv.y : cv.x) - (j ? m2.y : m2.x)) * rs[j];
              const float sc = j ? s2.y : s2.x;
              const float y0 = xn * sc + (j ? t2.y : t2.x);
              // the fast reciprocal: 1 / inf is 0 there too
              const float sg = __fdividef(1.f, 1.f + __expf(-y0));
              const float dy0 =
                  acc[0][4 * n + 2 * i + j] * sg * (1.f + y0 * (1.f - sg));
              dc[j] = dy0 * sc * rs[j];
              sb[j] += dy0;
              sx[j] += dy0 * xn;
            }
            *reinterpret_cast<__nv_bfloat162*>(dconv + o) =
                __floats2bfloat162_rn(dc[0], dc[1]);
          }
          // the four sums (sb, sx) over the warp's 16 rows, i.e. over the
          // 8 lanes of equal lane % 4, by halving exchanges: across lane
          // bit 4 a lane keeps the pair b = bit 4 (sb or sx), across bit 3
          // the value cb = bit 3 of it, across bit 2 both add; lanes with
          // bit 2 clear then hold value 2b + cb of their column pair
          const int b = (lane >> 4) & 1, cb = (lane >> 3) & 1;
          const float k0 = (b ? sx[0] : sb[0]) +
                           __shfl_xor_sync(0xffffffffu, b ? sb[0] : sx[0], 16);
          const float k1 = (b ? sx[1] : sb[1]) +
                           __shfl_xor_sync(0xffffffffu, b ? sb[1] : sx[1], 16);
          float z = (cb ? k1 : k0) +
                    __shfl_xor_sync(0xffffffffu, cb ? k0 : k1, 8);
          z += __shfl_xor_sync(0xffffffffu, z, 4);
          if ((lane & 4) == 0) mine[b * hg::BN + cl + cb] = z;
        }
        ctx.sync();
        // the warpgroup's warps are nslots consecutive ones, this one at slot
        const float* first =
            redp + ((threadIdx.x >> 5) - ctx.slot) * 2 * hg::BN;
        const int nt = 32 * ctx.nslots;
        const size_t prow = (size_t)(tl.m0 / S::ROWS) * D + tl.n0;
        for (int col = threadIdx.x & (nt - 1); col < 2 * hg::BN; col += nt) {
          float s = 0.f;
          for (int w = 0; w < ctx.nslots; ++w) s += first[w * 2 * hg::BN + col];
          if (col < hg::BN)
            pdy[prow + col] = s;
          else
            pdx[prow + col - hg::BN] = s;
        }
        ctx.sync();  // `red` is free for the next tile
      });
}

// ---- backward 3. wgrad: dW = y^T . dh on cooperative tiles of 128 x 128
// of (D, D), MN-major operands. Tile t is split t / tiles of R (`per`
// blocks of 64 rows each, written at out + split · D²) of output tile
// t % tiles.
__global__ void __launch_bounds__(hg::THREADS, 1)
    bn_out_bwd_wgrad(const __grid_constant__ CUtensorMap my,
                     const __grid_constant__ CUtensorMap mdh,
                     float* __restrict__ out, int R, int D, int splits,
                     int per) {
  using S = hg::Shape<false>;
  const int nn = D / hg::BN, tiles = nn * nn;
  const int kbs = cdiv(R, hg::BK);
  const CUtensorMap *py = &my, *pdh = &mdh;
  hg::run<1, WGRAD_STAGES, 1, 1, false, false>(
      tiles * splits,
      [=](int t) {
        const int b = t % tiles, split = t / tiles;
        return hg::Tile{b / nn * S::ROWS, b % nn * hg::BN,
                        min(per, kbs - split * per), split * per, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int r = (tl.k0 + kb) * hg::BK;
        hg::tma_load(dst, py, bar, tl.m0, r);
        hg::tma_load(dst + 8192, py, bar, tl.m0 + 64, r);
        hg::tma_load(dst + S::A, pdh, bar, tl.n0, r);
        hg::tma_load(dst + S::A + 8192, pdh, bar, tl.n0 + 64, r);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        float* o = out + (size_t)(tl.k0 / per) * D * D;
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int row = tl.m0 + ctx.rows + hg::frag_row(r);
          const int col = tl.n0 + hg::frag_col(r);
          *reinterpret_cast<float2*>(o + (size_t)row * D + col) =
              make_float2(acc[0][r], acc[0][r + 1]);
        }
      });
}

// ---- backward 4. reduce: blocks below `chunks` sum the column partials
// of 32 columns of (db | sum dy0 | sum dy0 · xn), 8 warps over the row
// blocks in turn and then the 8 warp sums in order, and write db, dbias
// and dmu, or dscale and dvar; the others sum the weight partials when R
// is split, in the order of the splits.
__global__ void __launch_bounds__(256)
    bn_out_bwd_reduce(const float* __restrict__ ws, int splits,
                      float* __restrict__ dw, const float* __restrict__ pdb,
                      const float* __restrict__ pdy,
                      const float* __restrict__ pdx,
                      const float* __restrict__ var,
                      const float* __restrict__ scale,
                      float* __restrict__ dbw, float* __restrict__ dbias,
                      float* __restrict__ dscale, float* __restrict__ dmu,
                      float* __restrict__ dvar, int R, int D) {
  __shared__ float red[8][32];
  const int chunks = 3 * D / 32;
  if ((int)blockIdx.x < chunks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int part = blockIdx.x * 32 / D;  // D is a multiple of 32
    const int c = blockIdx.x * 32 % D + lane;
    const float* p = part == 0 ? pdb : part == 1 ? pdy : pdx;
    float s = 0.f;
#pragma unroll 4
    for (int b = warp; b < cdiv(R, ROWS); b += 8) s += p[(size_t)b * D + c];
    red[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w][lane];
      const float rs = rsqrtf(var[c] + 1e-5f), sc = scale[c];
      if (part == 0) {
        dbw[c] = t;
      } else if (part == 1) {
        dbias[c] = t;
        dmu[c] = -sc * rs * t;
      } else {
        dscale[c] = t;
        dvar[c] = -0.5f * sc * rs * rs * t;
      }
    }
    return;
  }
  const size_t DW = (size_t)D * D;
  for (size_t i = (size_t)(blockIdx.x - chunks) * blockDim.x + threadIdx.x;
       i < DW; i += (size_t)(gridDim.x - chunks) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * DW + i];
    dw[i] = s;
  }
}

template <bool PP>
cudaError_t launch_fwd_product(const bf16* y, const bf16* w, const bf16* x,
                               const float* mask, const float* bw, bf16* out,
                               int R, int D, Drop dr, cudaStream_t s) {
  CUtensorMap my, mw;
  CATK_TRY(hg::tensor_map(&my, y, R, D, hg::Shape<PP>::ROWS));
  CATK_TRY(hg::tensor_map(&mw, w, D, D, 64));
  constexpr int smem =
      hg::smem_bytes<PP>(1, PP ? FWD_STAGES_PP : FWD_STAGES);
  CATK_TRY(hg::prepare(bn_out_fwd_product<PP>, smem, false));
  bn_out_fwd_product<PP>
      <<<hg::grid_for(cdiv(R, hg::Shape<PP>::ROWS) * (D / hg::BN)),
         hg::THREADS, smem, s>>>(my, mw, x, mask, bw, out, R, D, dr);
  return cudaGetLastError();
}

struct Args {
  const bf16 *conv, *x, *w, *dout;
  const float *mask, *mu, *var, *scale, *bias, *bw;
  bf16 *out, *y, *dconv, *dh;
  float *dmu, *dvar, *dscale, *dbias, *dw, *dbw, *ws;
  int R, splits, per;
  Drop dr;
};

template <int D>
cudaError_t launch_fwd(const Args& a, cudaStream_t s) {
  const int R = a.R;
  bn_out_fwd_rows<D><<<cdiv(R, RW / 32), RW, 0, s>>>(a.conv, a.mu, a.var,
                                                     a.scale, a.bias, a.y, R);
  CATK_TRY(cudaGetLastError());
  return launch_fwd_product<true>(a.y, a.w, a.x, a.mask, a.bw, a.out, R,
                                  D, a.dr, s);
}

// The f32 workspace: the three column partials (blocks, D) each, then the
// weight partials (splits, D, D) when R is split. `bn_out_plan` in
// ops/conv_module.py sizes it the same way.
size_t ws_floats(int R, int D, int splits) {
  return 3 * (size_t)cdiv(R, ROWS) * D +
         (splits > 1 ? (size_t)splits * D * D : 0);
}

template <int D>
cudaError_t launch_bwd(const Args& a, cudaStream_t s) {
  const int R = a.R, rb = cdiv(R, ROWS);
  float* const pdb = a.ws;
  float* const pdy = pdb + (size_t)rb * D;
  float* const pdx = pdy + (size_t)rb * D;
  float* const wsp = pdx + (size_t)rb * D;
  // boxes of 64 or 128 rows x 64 columns
  CUtensorMap mdh, mwk, my;
  CATK_TRY(hg::tensor_map(&mdh, a.dh, R, D, 64));
  CATK_TRY(hg::tensor_map(&mwk, a.w, D, D, 128));
  CATK_TRY(hg::tensor_map(&my, a.y, R, D, 64));

  bn_out_bwd_prep<D><<<rb, PREP_WARPS * 32, 0, s>>>(a.conv, a.mask, a.mu, a.var, a.scale,
                                       a.bias, a.dout, a.y, a.dh, pdb, R,
                                       a.dr);
  CATK_TRY(cudaGetLastError());

  constexpr int down_smem = hg::smem_bytes<true>(1, DOWN_STAGES);
  CATK_TRY(hg::prepare(bn_out_bwd_down, down_smem, false));
  bn_out_bwd_down<<<hg::grid_for(rb * (D / hg::BN)), hg::THREADS, down_smem,
                    s>>>(mdh, mwk, a.conv, a.mu, a.var, a.scale, a.bias,
                         a.dconv, pdy, pdx, R, D);
  CATK_TRY(cudaGetLastError());

  const int tiles = (D / hg::BN) * (D / hg::BN);
  constexpr int wg_smem = hg::smem_bytes<false>(1, WGRAD_STAGES);
  CATK_TRY(hg::prepare(bn_out_bwd_wgrad, wg_smem, false));
  bn_out_bwd_wgrad<<<hg::grid_for(tiles * a.splits), hg::THREADS, wg_smem,
                     s>>>(my, mdh, a.splits > 1 ? wsp : a.dw, R, D, a.splits,
                          a.per);
  CATK_TRY(cudaGetLastError());

  const int chunks = 3 * D / 32;
  const int wblocks = a.splits > 1 ? 4 * SMS : 0;
  bn_out_bwd_reduce<<<chunks + wblocks, 256, 0, s>>>(
      wsp, a.splits, a.dw, pdb, pdy, pdx, a.var, a.scale, a.dbw, a.dbias,
      a.dscale, a.dmu, a.dvar, R, D);
  return cudaGetLastError();
}

bool supported(int D) {
  return D == 128 || D == 256 || D == 384 || D == 512;
}

}  // namespace

// Returns the CUDA error of the launches (0 on success). conv, x, out and
// y (R, D) bf16 (y is scratch, written whole); mask (R,), mu, var, scale,
// bias and bw (D,) f32; w (D, D) bf16. D must be 128, 256, 384 or 512 and
// every pointer 16-byte aligned; the Python wrapper checks both. seed0,
// seed1, thr: the dropout seed words and keep threshold as uint32 bit
// patterns; inv = 1 / (1 - rate).
extern "C" int bn_out_fwd(const void* conv, const void* x, const void* mask,
                          const void* mu, const void* var, const void* scale,
                          const void* bias, const void* w, const void* bw,
                          void* out, void* y, int R, int D, int seed0,
                          int seed1, int thr, float inv, void* stream) {
  if (!supported(D)) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  Args a{};
  a.conv = static_cast<const bf16*>(conv);
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.mask = static_cast<const float*>(mask);
  a.mu = static_cast<const float*>(mu);
  a.var = static_cast<const float*>(var);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.bw = static_cast<const float*>(bw);
  a.out = static_cast<bf16*>(out);
  a.y = static_cast<bf16*>(y);
  a.R = R;
  a.dr = Drop{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  switch (D) {
    case 128: return launch_fwd<128>(a, s);
    case 256: return launch_fwd<256>(a, s);
    case 384: return launch_fwd<384>(a, s);
    default: return launch_fwd<512>(a, s);
  }
}

// Returns the CUDA error of the launches (0 on success). conv, dout, dconv,
// y and dh (R, D) bf16 (y and dh are scratch); mask, mu, var, scale, bias,
// w and bw as in bn_out_fwd; the gradient outputs dmu, dvar, dscale, dbias,
// dbw (D,) and dw (D, D) f32, written whole; ws an f32 workspace of
// ws_units · 64 floats. splits and per: the wgrad stage's splits of R and
// 64-row blocks a split (`bn_out_plan`); refused unless every block of R
// falls in exactly one split. D and the pointers as in bn_out_fwd; seed0,
// seed1, thr, inv as there (the same mask).
extern "C" int bn_out_bwd(const void* conv, const void* mask, const void* mu,
                          const void* var, const void* scale,
                          const void* bias, const void* w, const void* dout,
                          void* dconv, void* y, void* dh, void* dmu,
                          void* dvar, void* dscale, void* dbias, void* dw,
                          void* dbw, void* ws, int R, int D, int splits,
                          int per, int ws_units, int seed0, int seed1,
                          int thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (!supported(D)) return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[6] = {dmu, dvar, dscale, dbias, dw, dbw};
    for (int i = 0; i < 6; ++i)
      CATK_TRY(cudaMemsetAsync(outs[i], 0,
                               (i == 4 ? (size_t)D * D : (size_t)D) * 4, s));
    return cudaSuccess;
  }
  const int kbs = cdiv(R, hg::BK);
  if (splits < 1 || splits > MAX_SPLITS || per < 1 ||
      (size_t)splits * per < (size_t)kbs || (splits - 1) * per >= kbs ||
      ws_floats(R, D, splits) > (size_t)ws_units * 64)
    return cudaErrorInvalidValue;
  Args a{};
  a.conv = static_cast<const bf16*>(conv);
  a.w = static_cast<const bf16*>(w);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = static_cast<const float*>(mask);
  a.mu = static_cast<const float*>(mu);
  a.var = static_cast<const float*>(var);
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.dconv = static_cast<bf16*>(dconv);
  a.y = static_cast<bf16*>(y);
  a.dh = static_cast<bf16*>(dh);
  a.dmu = static_cast<float*>(dmu);
  a.dvar = static_cast<float*>(dvar);
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.dw = static_cast<float*>(dw);
  a.dbw = static_cast<float*>(dbw);
  a.ws = static_cast<float*>(ws);
  a.R = R;
  a.splits = splits;
  a.per = per;
  a.dr = Drop{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  switch (D) {
    case 128: return launch_bwd<128>(a, s);
    case 256: return launch_bwd<256>(a, s);
    case 384: return launch_bwd<384>(a, s);
    default: return launch_bwd<512>(a, s);
  }
}
