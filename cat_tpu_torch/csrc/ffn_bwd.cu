// Fused conformer feed-forward module, backward. Replaces the TPU kernel
// `_ff_bwd_kernel` of cat_tpu/ops/ffn_pallas.py (:104, `pallas_call` at
// :238).
//
// Forward (ffn_fwd.cu):
//   h = LN(x) (bf16), h1 = h . W1 + b1, a1 = drop0(SiLU(h1)) (bf16),
//   out = x + alpha * drop1(a1 . W2 + b2)
// Backward, given dO (R, D) bf16, recomputing the forward from x:
//   dh2 = alpha * drop1(dO) (bf16)      db2 = sum_rows dh2
//   da1 = drop0(dh2 . W2^T)
//   dh1 = da1 * SiLU'(h1) (bf16)        db1 = sum_rows dh1
//   dW2 = a1^T . dh2                    dW1 = h^T . dh1
//   dh = dh1 . W1^T, then the LayerNorm backward:
//   dgamma = sum_rows dh * xhat, dbeta = sum_rows dh,
//   dx = dO + rstd * (dh*gamma - mean(dh*gamma) - xhat * mean(dh*gamma*xhat))
// Rounding points as `ff_backward_reference` (ops/ffn.py): h, a1, dh2 and
// dh1 bf16, every sum f32, db1 summed from dh1 before its rounding.
//
// What bounds it on the H100: 10·R·D·F operations (h1 and da1 recomputed,
// dh, dW1, dW2), 133 GFLOP over the 12,664 valid rows of the training
// batch (R = 15,776, D = 512, F = 2048): 0.134 ms at 989 TFLOP/s bf16.
// The bytes every staged design must move are its inputs and outputs plus
// the scratch between the stages: h, dh2 (R x D bf16) and a1, dh1 (R x F
// bf16) written once and read twice, dh (R x D f32) once each way, about
// 0.58 GB at that batch, 0.17 ms at 3.35 TB/s, close to the operation
// bound. The design below is that staged one: six launches, four of them
// memory-bound passes and the products on the Hopper GEMM mainloop of
// hopper_gemm.cuh (TMA ring, wgmma from shared memory), each product with
// the elementwise work fused into its epilogue so that no stage reads
// what it could compute:
//   1. prep (one warp a row): LN statistics (mean, rstd to scratch), h,
//      dh2 = alpha * drop1(dO), db2 column partials of each 64-row block;
//   2. up (M = R, N = F, K = D, two products a tile): acc_h = h . W1 and
//      acc_d = dh2 . W2^T, W1 read by its columns (MN-major) and W2 by
//      its rows (K-major); epilogue: bias, SiLU and its derivative, drop0,
//      a1 and dh1 (bf16), db1 column partials of each 64-row tile. The
//      epilogue takes about half as long as the products, most of it the
//      two bf16 stores of every element, so the two consumer warpgroups
//      take alternate 64-row tiles (ping-pong): one's epilogue runs while
//      the other's products keep the tensor cores busy;
//   3. down (M = R, N = D, K = F): dh = dh1 . W1^T (W1 as stored is
//      K-major), f32;
//   4. ln (one warp a row): LayerNorm backward to dx, dgamma and dbeta
//      column partials of each 64-row block;
//   5. wgrad (K = R): dW1 = h^T . dh1 and dW2 = a1^T . dh2 in one grid,
//      MN-major operands (both are (R, .) row-major), R split so that the
//      2 x 64 output tiles of 128 x 128 fill the 132 SMs; a split writes
//      its f32 partial tile to the workspace (or the output when R is not
//      split);
//   6. reduce: the weight partials and the column partials summed in a
//      fixed order. There are no atomics: two calls on the same inputs
//      give the same bits.
// Every stage masks its own ragged edge: TMA reads zeros past R and F,
// the epilogues store only rows < R and columns < F (or D).
#include <algorithm>

#include "common_math.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace catk;

constexpr int ROWS = 64;       // rows of a prep or ln block, 8 rows a warp
constexpr int RW = 256;        // threads of a prep or ln block
constexpr int MAX_SPLITS = 8;  // splits of R in the wgrad stage
constexpr int UP_STAGES = 4, DOWN_STAGES = 4, WGRAD_STAGES = 4;
constexpr int SMS = 132;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sums red[0..7][c] in order into out[c], c < D (the block's threads).
template <int D>
__device__ __forceinline__ void sum8(const float (*red)[D], float* out) {
  for (int c = threadIdx.x; c < D; c += RW) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w][c];
    out[c] = s;
  }
}

// ---- 1. prep: LN statistics, h, dh2, db2 partials. Lane l of a warp
// holds columns 4(l + 32j) .. + 3, one Philox group of 4.
template <int D>
__global__ void __launch_bounds__(RW)
    ffn_bwd_prep(const bf16* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta,
                 const bf16* __restrict__ dout, bf16* __restrict__ h,
                 bf16* __restrict__ dh2, float* __restrict__ stats,
                 float* __restrict__ pdb2, int R, float alpha, Drop dr) {
  constexpr int V = D / 128;
  __shared__ float red[8][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[V][4] = {};
  for (int r = warp; r < ROWS; r += 8) {
    const int row = blockIdx.x * ROWS + r;
    if (row >= R) break;
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
      float hv[4], dv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) hv[e] = (v[j][e] - mean) * rstd * gv[e] + bv[e];
      store4(h + o + c, hv);
      load4(dout + o + c, dv);
      const unsigned kb = keep4(dr, 1, 0, row, c >> 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dv[e] = alpha * dv[e] * keep_scale(dr, kb, e);
        acc[j][e] += dv[e];
      }
      store4(dh2 + o + c, dv);
    }
    if (lane == 0) {
      stats[row] = mean;
      stats[R + row] = rstd;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * (lane + 32 * j) + e] = acc[j][e];
  __syncthreads();
  sum8<D>(red, pdb2 + (size_t)blockIdx.x * D);
}

// ---- 2. up: acc_h = h . W1 and acc_d = dh2 . W2^T on ping-pong tiles of
// 64 rows x 128 columns of (R, F), tile t at rows 64·(t / nf), columns
// 128·(t % nf); W1 (D, F) is read by its columns (MN-major), W2 (F, D) by
// its rows (K-major).
__global__ void __launch_bounds__(hg::THREADS, 1)
    ffn_bwd_up(const __grid_constant__ CUtensorMap mh,
               const __grid_constant__ CUtensorMap md2,
               const __grid_constant__ CUtensorMap mw1,
               const __grid_constant__ CUtensorMap mw2,
               const float* __restrict__ b1, bf16* __restrict__ a1,
               bf16* __restrict__ dh1, float* __restrict__ pdb1, int R,
               int D, int F, Drop dr) {
  using S = hg::Shape<true>;
  const int nf = cdiv(F, hg::BN);
  const CUtensorMap *ph = &mh, *pd2 = &md2, *pw1 = &mw1, *pw2 = &mw2;
  hg::run<2, UP_STAGES, 0, 1, true, true>(
      cdiv(R, S::ROWS) * nf,
      [=](int t) {
        return hg::Tile{t / nf * S::ROWS, t % nf * hg::BN, D / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, ph, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pw1, bar, tl.n0, k);
        hg::tma_load(dst + S::A + 8192, pw1, bar, tl.n0 + 64, k);
        hg::tma_load(dst + S::OP, pd2, bar, k, tl.m0);
        hg::tma_load(dst + S::OP + S::A, pw2, bar, k, tl.n0);
      },
      [=](const hg::Tile& tl, float (&acc)[2][64], const hg::Ctx& ctx) {
        const int lane = threadIdx.x & 31, odd = lane & 1;
        const int row0 = tl.m0 + ctx.rows + hg::frag_row(0);  // and row0 + 8
#pragma unroll
        for (int n = 0; n < hg::BN / 8; ++n) {
          // this thread's columns c, c + 1 lie in one Philox group, which
          // it shares with lane ^ 1: each of the two draws one row's bits
          const int c = tl.n0 + hg::frag_col(4 * n);
          const unsigned mine = keep4(dr, 0, 0, row0 + 8 * odd, c >> 2);
          const unsigned other = __shfl_xor_sync(0xffffffffu, mine, 1);
          const bool cv = c < F;
          const float bias[2] = {cv ? b1[c] : 0.f, cv ? b1[c + 1] : 0.f};
          float cs[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            const unsigned kbits = i == odd ? mine : other;
            float av[2], dv[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = 4 * n + 2 * i + j;
              const float v = acc[0][r] + bias[j];
              const float sg = __fdividef(1.f, 1.f + __expf(-v));
              const float ks = keep_scale(dr, kbits, 2 * odd + j);
              av[j] = v * sg * ks;
              dv[j] = acc[1][r] * ks * sg * (1.f + v * (1.f - sg));
              cs[j] += dv[j];  // rows past R hold zeros
            }
            if (row < R && cv) {
              const size_t o = (size_t)row * F + c;
              *reinterpret_cast<__nv_bfloat162*>(a1 + o) =
                  __floats2bfloat162_rn(av[0], av[1]);
              *reinterpret_cast<__nv_bfloat162*>(dh1 + o) =
                  __floats2bfloat162_rn(dv[0], dv[1]);
            }
          }
          // db1: sum over the warp's 16 rows (lanes of equal lane % 4)
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1) {
            cs[0] += __shfl_xor_sync(0xffffffffu, cs[0], sh);
            cs[1] += __shfl_xor_sync(0xffffffffu, cs[1], sh);
          }
          if (lane < 4) {
            float* dst = ctx.scratch + ctx.slot * hg::BN + 8 * n + 2 * lane;
            dst[0] = cs[0];
            dst[1] = cs[1];
          }
        }
        ctx.sync();
        const int c = threadIdx.x & (32 * ctx.nslots - 1);
        if (c < hg::BN && tl.n0 + c < F) {
          float s = 0.f;
          for (int w = 0; w < ctx.nslots; ++w) s += ctx.scratch[w * hg::BN + c];
          pdb1[(size_t)(tl.m0 / S::ROWS) * F + tl.n0 + c] = s;
        }
        ctx.sync();  // the scratch is free for the next tile
      });
}

// ---- 3. down: dh = dh1 . W1^T on cooperative tiles of 128 x 128 of
// (R, D), tile t at rows 128·(t / nd), columns 128·(t % nd).
__global__ void __launch_bounds__(hg::THREADS, 1)
    ffn_bwd_down(const __grid_constant__ CUtensorMap md1,
                 const __grid_constant__ CUtensorMap mw1,
                 float* __restrict__ dh, int R, int D, int F) {
  using S = hg::Shape<false>;
  const int nd = D / hg::BN;
  const CUtensorMap *pd1 = &md1, *pw1 = &mw1;
  hg::run<1, DOWN_STAGES, 0, 0, false, false>(
      cdiv(R, S::ROWS) * nd,
      [=](int t) {
        return hg::Tile{t / nd * S::ROWS, t % nd * hg::BN, F / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, pd1, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pw1, bar, k, tl.n0);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int row = tl.m0 + ctx.rows + hg::frag_row(r);
          const int col = tl.n0 + hg::frag_col(r);
          if (row < R)
            *reinterpret_cast<float2*>(dh + (size_t)row * D + col) =
                make_float2(acc[0][r], acc[0][r + 1]);
        }
      });
}

// ---- 4. ln: the LayerNorm backward, dgamma and dbeta partials
template <int D>
__global__ void __launch_bounds__(RW)
    ffn_bwd_ln(const bf16* __restrict__ x, const float* __restrict__ gamma,
               const bf16* __restrict__ dout, const float* __restrict__ dh,
               const float* __restrict__ stats, bf16* __restrict__ dx,
               float* __restrict__ pdg, float* __restrict__ pdb, int R) {
  constexpr int V = D / 128;
  __shared__ float red[2][8][D];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float ag[V][4] = {}, ab[V][4] = {};
  for (int r = warp; r < ROWS; r += 8) {
    const int row = blockIdx.x * ROWS + r;
    if (row >= R) break;
    const size_t o = (size_t)row * D;
    const float mu = stats[row], rs = stats[R + row];
    float xh[V][4], dxh[V][4];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = 4 * (lane + 32 * j);
      float xv[4];
      load4(x + o + c, xv);
      const float4 d4 = *reinterpret_cast<const float4*>(dh + o + c);
      const float4 g4 = *reinterpret_cast<const float4*>(gamma + c);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xh[j][e] = (xv[e] - mu) * rs;
        dxh[j][e] = dv[e] * gv[e];
        s1 += dxh[j][e];
        s2 += dxh[j][e] * xh[j][e];
        ag[j][e] += dv[e] * xh[j][e];
        ab[j][e] += dv[e];
      }
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = 4 * (lane + 32 * j);
      float ov[4];
      load4(dout + o + c, ov);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ov[e] += rs * (dxh[j][e] - m1 - xh[j][e] * m2);
      store4(dx + o + c, ov);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[0][warp][4 * (lane + 32 * j) + e] = ag[j][e];
      red[1][warp][4 * (lane + 32 * j) + e] = ab[j][e];
    }
  __syncthreads();
  sum8<D>(red[0], pdg + (size_t)blockIdx.x * D);
  sum8<D>(red[1], pdb + (size_t)blockIdx.x * D);
}

// ---- 5. wgrad: cooperative tiles of 128 x 128, MN-major operands. Tile
// t is split t / tiles of R (`per` blocks of 64 rows each, written at
// out + split · stride) of output tile b = t % tiles: b < t1 a tile of
// dW1 = h^T . dh1 (D x F), the others one of dW2 = a1^T . dh2 (F x D).
__global__ void __launch_bounds__(hg::THREADS, 1)
    ffn_bwd_wgrad(const __grid_constant__ CUtensorMap mh,
                  const __grid_constant__ CUtensorMap md1,
                  const __grid_constant__ CUtensorMap ma1,
                  const __grid_constant__ CUtensorMap md2,
                  float* __restrict__ out1, float* __restrict__ out2,
                  size_t stride, int R, int D, int F, int splits, int per) {
  using S = hg::Shape<false>;
  const int t1 = cdiv(D, S::ROWS) * cdiv(F, hg::BN), tiles = 2 * t1;
  const int kbs = cdiv(R, hg::BK);
  const CUtensorMap *ph = &mh, *pd1 = &md1, *pa1 = &ma1, *pd2 = &md2;
  hg::run<1, WGRAD_STAGES, 1, 1, false, false>(
      tiles * splits,
      [=](int t) {
        const int b = t % tiles, split = t / tiles;
        const int which = b >= t1, bb = which ? b - t1 : b;
        const int nn = cdiv(which ? D : F, hg::BN);
        return hg::Tile{bb / nn * S::ROWS, bb % nn * hg::BN,
                        min(per, kbs - split * per), split * per, which};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const CUtensorMap* pa = tl.which ? pa1 : ph;
        const CUtensorMap* pb = tl.which ? pd2 : pd1;
        const int r = (tl.k0 + kb) * hg::BK;
        hg::tma_load(dst, pa, bar, tl.m0, r);
        hg::tma_load(dst + 8192, pa, bar, tl.m0 + 64, r);
        hg::tma_load(dst + S::A, pb, bar, tl.n0, r);
        hg::tma_load(dst + S::A + 8192, pb, bar, tl.n0 + 64, r);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        const int M = tl.which ? F : D, N = tl.which ? D : F;
        float* out = (tl.which ? out2 : out1) + (size_t)(tl.k0 / per) * stride;
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int row = tl.m0 + ctx.rows + hg::frag_row(r);
          const int col = tl.n0 + hg::frag_col(r);
          if (row < M && col < N)
            *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
                make_float2(acc[0][r], acc[0][r + 1]);
        }
      });
}

// ---- 6. reduce: blocks below `chunks` sum the column partials of 32
// columns of (db1 | db2 | dgamma | dbeta), 8 warps over the row blocks in
// turn and then the 8 warp sums in order; the others sum the weight
// partials when R is split, in the order of the splits.
__global__ void __launch_bounds__(256)
    ffn_bwd_reduce(const float* __restrict__ ws, int splits,
                   float* __restrict__ dw1, float* __restrict__ dw2,
                   const float* __restrict__ pdb1,
                   const float* __restrict__ pdb2,
                   const float* __restrict__ pdg,
                   const float* __restrict__ pdb, float* __restrict__ db1,
                   float* __restrict__ db2, float* __restrict__ dgamma,
                   float* __restrict__ dbeta, int R, int D, int F) {
  __shared__ float red[8][32];
  const int chunks = (F + 3 * D) / 32;
  if ((int)blockIdx.x < chunks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int c = blockIdx.x * 32 + lane;  // F and D are multiples of 32
    const float* p = pdb1;
    float* out = db1;
    int ld = F;
    if (c >= F) {
      c -= F;
      const int which = c / D;
      c %= D;
      p = which == 0 ? pdb2 : which == 1 ? pdg : pdb;
      out = which == 0 ? db2 : which == 1 ? dgamma : dbeta;
      ld = D;
    }
    float s = 0.f;
#pragma unroll 4
    for (int b = warp; b < cdiv(R, ROWS); b += 8) s += p[(size_t)b * ld + c];
    red[warp][lane] = s;
    __syncthreads();
    if (warp == 0) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) t += red[w][lane];
      out[c] = t;
    }
    return;
  }
  const size_t DF = (size_t)D * F;
  for (size_t i = (size_t)(blockIdx.x - chunks) * blockDim.x + threadIdx.x;
       i < 2 * DF; i += (size_t)(gridDim.x - chunks) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * 2 * DF + i];
    if (i < DF)
      dw1[i] = s;
    else
      dw2[i - DF] = s;
  }
}

// Splits of R in the wgrad stage: as many as fill the SMs once with the
// 2·(D/128)·(F/128) tiles, at most MAX_SPLITS, none empty.
int wgrad_splits(int R, int D, int F) {
  const int tiles = 2 * cdiv(D, hg::BN) * cdiv(F, hg::BN);
  const int kb = cdiv(R, hg::BK);
  if (kb <= 1) return 1;
  const int s = std::max(1, std::min(std::min(MAX_SPLITS, SMS / tiles), kb));
  return cdiv(kb, cdiv(kb, s));
}

// The f32 workspace: dh, LN statistics, column partials, weight partials.
struct Work {
  float *dh, *stats, *pdb1, *pdb2, *pdg, *pdb, *ws;
  size_t floats;
};

Work carve(float* base, int R, int D, int F) {
  Work w;
  size_t o = 0;
  auto take = [&](size_t n) {
    float* p = base == nullptr ? nullptr : base + o;
    o += (n + 63) / 64 * 64;
    return p;
  };
  const int splits = wgrad_splits(R, D, F);
  w.dh = take((size_t)R * D);
  w.stats = take(2 * (size_t)R);
  w.pdb1 = take((size_t)cdiv(R, ROWS) * F);
  w.pdb2 = take((size_t)cdiv(R, ROWS) * D);
  w.pdg = take((size_t)cdiv(R, ROWS) * D);
  w.pdb = take((size_t)cdiv(R, ROWS) * D);
  w.ws = take(splits > 1 ? (size_t)splits * 2 * D * F : 0);
  w.floats = o;
  return w;
}

struct Args {
  const bf16 *x, *w1, *w2, *dout;
  const float *gamma, *beta, *b1;
  bf16 *dx, *h, *dh2, *a1, *dh1;
  float *dgamma, *dbeta, *dw1, *db1, *dw2, *db2;
  Work w;
  int R, D, F;
  float alpha;
  Drop dr;
};

#define CATK_TRY(expr)                        \
  do {                                        \
    const cudaError_t e_ = (expr);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

template <int D>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int R = a.R, F = a.F;
  const Work& w = a.w;
  // boxes of 64 or 128 rows x 64 columns
  CUtensorMap mh, md2, mw1, mw2, md1, mw1k, md1_64, ma1;
  CATK_TRY(hg::tensor_map(&mh, a.h, R, D, 64));
  CATK_TRY(hg::tensor_map(&md2, a.dh2, R, D, 64));
  CATK_TRY(hg::tensor_map(&mw1, a.w1, D, F, 64));
  CATK_TRY(hg::tensor_map(&mw2, a.w2, F, D, 128));
  CATK_TRY(hg::tensor_map(&md1, a.dh1, R, F, 128));
  CATK_TRY(hg::tensor_map(&mw1k, a.w1, D, F, 128));
  CATK_TRY(hg::tensor_map(&md1_64, a.dh1, R, F, 64));
  CATK_TRY(hg::tensor_map(&ma1, a.a1, R, F, 64));

  const int rb = cdiv(R, ROWS);
  ffn_bwd_prep<D><<<rb, RW, 0, s>>>(a.x, a.gamma, a.beta, a.dout, a.h,
                                    a.dh2, w.stats, w.pdb2, R, a.alpha, a.dr);
  CATK_TRY(cudaGetLastError());

  constexpr int up_smem = hg::smem_bytes<true>(2, UP_STAGES);
  CATK_TRY(hg::prepare(ffn_bwd_up, up_smem, true));
  ffn_bwd_up<<<hg::grid_for(rb * cdiv(F, hg::BN)), hg::THREADS, up_smem,
               s>>>(mh, md2, mw1, mw2, a.b1, a.a1, a.dh1, w.pdb1, R, D, F,
                    a.dr);
  CATK_TRY(cudaGetLastError());

  constexpr int down_smem = hg::smem_bytes<false>(1, DOWN_STAGES);
  CATK_TRY(hg::prepare(ffn_bwd_down, down_smem, false));
  ffn_bwd_down<<<hg::grid_for(cdiv(R, 128) * (D / hg::BN)), hg::THREADS,
                 down_smem, s>>>(md1, mw1k, w.dh, R, D, F);
  CATK_TRY(cudaGetLastError());

  ffn_bwd_ln<D><<<rb, RW, 0, s>>>(a.x, a.gamma, a.dout, w.dh, w.stats, a.dx,
                                  w.pdg, w.pdb, R);
  CATK_TRY(cudaGetLastError());

  const int splits = wgrad_splits(R, D, F);
  const int tiles = 2 * cdiv(D, hg::BN) * cdiv(F, hg::BN);
  const size_t DF = (size_t)D * F;
  constexpr int wg_smem = hg::smem_bytes<false>(1, WGRAD_STAGES);
  CATK_TRY(hg::prepare(ffn_bwd_wgrad, wg_smem, false));
  ffn_bwd_wgrad<<<hg::grid_for(tiles * splits), hg::THREADS, wg_smem, s>>>(
      mh, md1_64, ma1, md2, splits > 1 ? w.ws : a.dw1,
      splits > 1 ? w.ws + DF : a.dw2, 2 * DF, R, D, F, splits,
      cdiv(cdiv(R, hg::BK), splits));
  CATK_TRY(cudaGetLastError());

  const int chunks = (F + 3 * D) / 32;
  const int wblocks = splits > 1 ? 4 * SMS : 0;
  ffn_bwd_reduce<<<chunks + wblocks, 256, 0, s>>>(
      w.ws, splits, a.dw1, a.dw2, w.pdb1, w.pdb2, w.pdg, w.pdb, a.db1, a.db2,
      a.dgamma, a.dbeta, R, D, F);
  return cudaGetLastError();
}

}  // namespace

// The f32 workspace `ffn_bwd` needs for R rows, in units of 64 floats
// (256 bytes). The stream is not used.
extern "C" int ffn_bwd_workspace(int R, int D, int F, void*) {
  return R <= 0 ? 0 : (int)(carve(nullptr, R, D, F).floats / 64);
}

// Returns the CUDA error of the launches (0 on success). x, dout, dx,
// h, dh2 (R, D) and a1, dh1 (R, F) bf16 (h, dh2, a1, dh1 are scratch);
// w1 (D, F) and w2 (F, D) bf16; gamma, beta,
// b1 and the gradient outputs dgamma, dbeta, dw1, db1, dw2, db2 f32,
// written whole; ws an f32 workspace of ws_units · 64 floats
// (`ffn_bwd_workspace`). D must be 128, 256, 384 or 512 and F a multiple
// of 64, every pointer 16-byte aligned; the Python wrapper checks both.
// Dropout as in ffn_fwd.
extern "C" int ffn_bwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* dout, void* dx, void* h, void* dh2,
                       void* a1, void* dh1, void* dgamma, void* dbeta,
                       void* dw1, void* db1, void* dw2, void* db2, void* ws,
                       int R, int D, int F, int seed0, int seed1, int thr,
                       int ws_units, float alpha, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (F <= 0 || F % hg::BK != 0) return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[6] = {dgamma, dbeta, dw1, db1, dw2, db2};
    const size_t n[6] = {(size_t)D, (size_t)D, (size_t)D * F, (size_t)F,
                         (size_t)D * F, (size_t)D};
    for (int i = 0; i < 6; ++i)
      CATK_TRY(cudaMemsetAsync(outs[i], 0, n[i] * 4, s));
    return cudaSuccess;
  }
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w1 = static_cast<const bf16*>(w1);
  a.w2 = static_cast<const bf16*>(w2);
  a.dout = static_cast<const bf16*>(dout);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.b1 = static_cast<const float*>(b1);
  a.dx = static_cast<bf16*>(dx);
  a.h = static_cast<bf16*>(h);
  a.dh2 = static_cast<bf16*>(dh2);
  a.a1 = static_cast<bf16*>(a1);
  a.dh1 = static_cast<bf16*>(dh1);
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.dw1 = static_cast<float*>(dw1);
  a.db1 = static_cast<float*>(db1);
  a.dw2 = static_cast<float*>(dw2);
  a.db2 = static_cast<float*>(db2);
  a.w = carve(static_cast<float*>(ws), R, D, F);
  if (a.w.floats > (size_t)ws_units * 64) return cudaErrorInvalidValue;
  a.R = R;
  a.D = D;
  a.F = F;
  a.alpha = alpha;
  a.dr = Drop{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  switch (D) {
    case 128: return launch<128>(a, s);
    case 256: return launch<256>(a, s);
    case 384: return launch<384>(a, s);
    case 512: return launch<512>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
