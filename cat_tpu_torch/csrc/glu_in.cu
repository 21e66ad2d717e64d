// The conformer convolution module's entry stage, glu_in, forward and
// backward. Replaces the TPU kernels `_glu_in_fwd_kernel`
// (cat_tpu/ops/conv_module_pallas.py:53, `pallas_call` at :130) and
// `_glu_in_bwd_kernel` (:71, `pallas_call` at :158):
//   forward:  h = LN(x) (bf16), [u | g] = h . W + b,
//             out = mask * u * sigmoid(g)
//   backward, given dO, recomputing [u | g] from x:
//             da = dO * mask, du = da * sigmoid(g),
//             dg = da * u * sigmoid(g) * (1 - sigmoid(g)),
//             dh2 = [du | dg] (bf16), db = sum_rows dh2,
//             dW = h^T . dh2, dh = dh2 . W^T, then the LayerNorm backward:
//             dgamma = sum_rows dh * xhat, dbeta = sum_rows dh,
//             dx = rstd * (dh*gamma - mean(dh*gamma)
//                          - xhat * mean(dh*gamma*xhat))
// x, out, dx (R, D) bf16; W (D, 2D) bf16 row-major; mask (R,), gamma, beta,
// b f32; LN eps 1e-6. Rounding points as `glu_in_reference` and
// `glu_in_backward_reference` (ops/conv_module.py): h and dh2 bf16, db
// summed from dh2 before its rounding, every sum f32.
//
// What bounds them on the H100, at the training batch (R = 15,776 rows,
// 12,664 valid, D = 512): the forward does 4·R·D² operations, 13.3 GFLOP
// over the valid rows (0.0134 ms at 989 TFLOP/s bf16); the backward
// 12·R·D² (the product recomputed, dh, dW), 40 GFLOP (0.040 ms). The
// staged designs below move more: the forward about 65 MB (x read, h
// written and read, out written; 0.019 ms at 3.35 TB/s), the backward
// about 0.27 GB (x twice, h, dh2 and the f32 dh through device memory;
// 0.081 ms). What kept the earlier kernels (legacy wmma, 32-row blocks)
// far from either bound was feeding the tensor cores: every block read
// all of W from L2 through registers. Here every product runs on the
// Hopper GEMM mainloop of hopper_gemm.cuh (TMA ring under mbarriers, a
// producer warp, two wgmma consumer warpgroups), each W tile loaded once
// per output tile into shared memory. Forward, two launches inside the one
// `glu_in_fwd` call:
//   1. ln (one warp a row): h = LN(x), bf16, to scratch;
//   2. up (M = R, N = D, K = D, two products of one h tile a tile): the u
//      columns c .. c + 127 and the g columns D + c .. of h . W, W read by
//      its columns (MN-major); epilogue: bias, out = mask · u · sigmoid(g),
//      bf16. Cooperative tiles of 128 rows, or ping-pong tiles of 64 rows
//      where those leave the busiest SM fewer 64-row steps (short R: the
//      serving batch).
// Backward, six launches inside the one `glu_in_bwd` call:
//   1. prep: the ln pass, also writing the LN statistics (mean, rstd);
//   2. up: the forward's product on ping-pong tiles of 64 rows (one
//      warpgroup's epilogue runs while the other's products keep the
//      tensor cores busy); epilogue: bias, da = dO · mask, du, dg, dh2 =
//      [du | dg] to bf16 scratch, and the db column partials of each
//      64-row tile from dh2 before its rounding;
//   3. down (M = R, N = D, K = 2D): dh = dh2 . W^T in f32 (W as stored is
//      K-major for this product);
//   4. ln (one warp a row): the LayerNorm backward to dx, and the dgamma
//      and dbeta column partials of each 64-row block;
//   5. wgrad (K = R): dW = h^T . dh2, (D, 2D), both operands MN-major, R
//      split so that the output tiles of 128 x 128 fill the 132 SMs; a
//      split writes its f32 partial to the workspace (or the output when R
//      is not split);
//   6. reduce: the weight partials and the column partials summed in a
//      fixed order.
// There are no atomics: two calls on the same inputs give the same bits,
// and every gradient output is written whole. Every stage masks its own
// ragged edge: TMA reads zeros past R, the epilogues store only rows < R,
// and rows past R give da = 0 and so add nothing to the sums.
#include <algorithm>

#include "common_math.cuh"
#include "hopper_gemm.cuh"

namespace {

using namespace catk;

constexpr int ROWS = 64;        // rows of a backward ln block, 8 a warp
constexpr int RW = 256;         // threads of an ln block
constexpr int MAX_SPLITS = 16;  // splits of R in the wgrad stage
// up: 3 stages of two 32 KB products (cooperative) or 4 of two 24 KB ones
// (ping-pong) fill the 227 KB of shared memory
constexpr int UP_STAGES = 3, UP_STAGES_PP = 4;
constexpr int DOWN_STAGES = 4, WGRAD_STAGES = 4;

using hg::cdiv;
using hg::SMS;

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

// ---- ln: h = LN(x) in bf16, one warp a row, 8 rows a block; with
// `stats`, also the row's mean and rstd (stats[row], stats[R + row]).
// Lane l of a warp holds columns 4(l + 32j) .. + 3.
template <int D>
__device__ __forceinline__ void ln_rows(const bf16* __restrict__ x,
                                        const float* __restrict__ gamma,
                                        const float* __restrict__ beta,
                                        bf16* __restrict__ h,
                                        float* __restrict__ stats, int R) {
  constexpr int V = D / 128;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (RW / 32) + (threadIdx.x >> 5);
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
  if (stats != nullptr && lane == 0) {
    stats[row] = mean;
    stats[R + row] = rstd;
  }
}

template <int D>
__global__ void __launch_bounds__(RW)
    glu_in_fwd_ln(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, bf16* __restrict__ h,
                  int R) {
  ln_rows<D>(x, gamma, beta, h, nullptr, R);
}

template <int D>
__global__ void __launch_bounds__(RW)
    glu_in_bwd_prep(const bf16* __restrict__ x,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta, bf16* __restrict__ h,
                    float* __restrict__ stats, int R) {
  ln_rows<D>(x, gamma, beta, h, stats, R);
}

// ---- up: [u | g] = h . W + b on tiles of 64 (PP) or 128 rows x 128
// columns: tile t at rows ROWS·(t / nd) holds the u columns
// c = 128·(t % nd) .. c + 127 (product 0) and the g columns D + c ..
// (product 1), both from one h tile, W (D, 2D) read by its columns
// (MN-major). BWD false: out = mask · u · sigmoid(g). BWD true (PP only):
// dh2 = [du | dg] and the db column partials of the tile's 64 rows, pdb
// (cdiv(R, 64), 2D), summed over each warp's 16 rows by shuffles and then
// over the tile's warps in order through `red`.
template <bool BWD, bool PP>
__device__ __forceinline__ void up_stage(const CUtensorMap* ph,
                                         const CUtensorMap* pw,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ bw,
                                         const bf16* __restrict__ dout,
                                         bf16* __restrict__ out,
                                         float* __restrict__ pdb, int R,
                                         int D) {
  static_assert(PP || !BWD, "the backward's db partials are by 64 rows");
  using S = hg::Shape<PP>;
  __shared__ float red[BWD ? 8 : 1][2 * hg::BN];
  float* const redp = &red[0][0];
  const int nd = D / hg::BN;
  hg::run<2, PP ? UP_STAGES_PP : UP_STAGES, 0, 3, PP, true>(
      cdiv(R, S::ROWS) * nd,
      [=](int t) {
        return hg::Tile{t / nd * S::ROWS, t % nd * hg::BN, D / hg::BK, 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t d = dst + i * S::OP;
          const int n = tl.n0 + i * D;
          hg::tma_load(d, ph, bar, k, tl.m0);
          hg::tma_load(d + S::A, pw, bar, n, k);
          hg::tma_load(d + S::A + 8192, pw, bar, n + 64, k);
        }
      },
      [=](const hg::Tile& tl, float (&acc)[2][64], const hg::Ctx& ctx) {
        const int lane = threadIdx.x & 31;
        const int row0 = tl.m0 + ctx.rows + hg::frag_row(0);  // and row0 + 8
        const float mk[2] = {row0 < R ? mask[row0] : 0.f,
                             row0 + 8 < R ? mask[row0 + 8] : 0.f};
        float* const mine = redp + (BWD ? (threadIdx.x >> 5) : 0) * 2 * hg::BN;
#pragma unroll
        for (int n = 0; n < hg::BN / 8; ++n) {
          const int cl = hg::frag_col(4 * n), c = tl.n0 + cl;
          const float2 bu = *reinterpret_cast<const float2*>(bw + c);
          const float2 bg = *reinterpret_cast<const float2*>(bw + D + c);
          float su[2] = {0.f, 0.f}, sg[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = row0 + 8 * i;
            const bool rv = row < R;
            if (!BWD && !rv) continue;
            float2 dv = make_float2(0.f, 0.f);
            if (BWD && rv)
              dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                  dout + (size_t)row * D + c));
            float o0[2], o1[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int r = 4 * n + 2 * i + j;
              const float u = acc[0][r] + (j ? bu.y : bu.x);
              // the fast reciprocal: 1 / inf is 0 there too
              const float s = __fdividef(
                  1.f, 1.f + __expf(-(acc[1][r] + (j ? bg.y : bg.x))));
              if (BWD) {
                const float da = (j ? dv.y : dv.x) * mk[i];
                o0[j] = da * s;
                o1[j] = da * u * s * (1.f - s);
                su[j] += o0[j];  // rows past R hold zeros
                sg[j] += o1[j];
              } else {
                o0[j] = u * s * mk[i];
              }
            }
            if (!rv) continue;
            if (BWD) {
              const size_t o = (size_t)row * 2 * D + c;
              *reinterpret_cast<__nv_bfloat162*>(out + o) =
                  __floats2bfloat162_rn(o0[0], o0[1]);
              *reinterpret_cast<__nv_bfloat162*>(out + o + D) =
                  __floats2bfloat162_rn(o1[0], o1[1]);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + c) =
                  __floats2bfloat162_rn(o0[0], o0[1]);
            }
          }
          if (!BWD) continue;
          // db: the four sums (su, sg) over the warp's 16 rows, i.e. over
          // the 8 lanes of equal lane % 4, by halving exchanges: across
          // lane bit 4 a lane keeps the pair b = bit 4 (su or sg), across
          // bit 3 the value c = bit 3 of it, across bit 2 both add; lanes
          // with bit 2 clear then hold value 2b + c of their column pair
          const int b = (lane >> 4) & 1, cb = (lane >> 3) & 1;
          const float k0 = (b ? sg[0] : su[0]) +
                           __shfl_xor_sync(0xffffffffu, b ? su[0] : sg[0], 16);
          const float k1 = (b ? sg[1] : su[1]) +
                           __shfl_xor_sync(0xffffffffu, b ? su[1] : sg[1], 16);
          float z = (cb ? k1 : k0) +
                    __shfl_xor_sync(0xffffffffu, cb ? k0 : k1, 8);
          z += __shfl_xor_sync(0xffffffffu, z, 4);
          if ((lane & 4) == 0) mine[b * hg::BN + cl + cb] = z;
        }
        if constexpr (BWD) {
          ctx.sync();
          // the tile's warps are nslots consecutive ones, this one at slot
          const float* first = redp + ((threadIdx.x >> 5) - ctx.slot) * 2 * hg::BN;
          const int nt = 32 * ctx.nslots;
          float* const prow = pdb + (size_t)(tl.m0 / S::ROWS) * 2 * D + tl.n0;
          for (int col = threadIdx.x & (nt - 1); col < 2 * hg::BN; col += nt) {
            float s = 0.f;
            for (int w = 0; w < ctx.nslots; ++w) s += first[w * 2 * hg::BN + col];
            prow[col < hg::BN ? col : D + col - hg::BN] = s;
          }
          ctx.sync();  // `red` is free for the next tile
        }
      });
}

template <bool PP>
__global__ void __launch_bounds__(hg::THREADS, 1)
    glu_in_fwd_up(const __grid_constant__ CUtensorMap mh,
                  const __grid_constant__ CUtensorMap mw,
                  const float* __restrict__ mask,
                  const float* __restrict__ bw, bf16* __restrict__ out, int R,
                  int D) {
  up_stage<false, PP>(&mh, &mw, mask, bw, nullptr, out, nullptr, R, D);
}

__global__ void __launch_bounds__(hg::THREADS, 1)
    glu_in_bwd_up(const __grid_constant__ CUtensorMap mh,
                  const __grid_constant__ CUtensorMap mw,
                  const float* __restrict__ mask,
                  const float* __restrict__ bw,
                  const bf16* __restrict__ dout, bf16* __restrict__ dh2,
                  float* __restrict__ pdb, int R, int D) {
  up_stage<true, true>(&mh, &mw, mask, bw, dout, dh2, pdb, R, D);
}

// ---- down: dh = dh2 . W^T on cooperative tiles of 128 x 128 of (R, D),
// tile t at rows 128·(t / nd), columns 128·(t % nd); dh2 and W both
// K-major (the sum runs along their rows).
__global__ void __launch_bounds__(hg::THREADS, 1)
    glu_in_bwd_down(const __grid_constant__ CUtensorMap md2,
                    const __grid_constant__ CUtensorMap mwk,
                    float* __restrict__ dh, int R, int D) {
  using S = hg::Shape<false>;
  const int nd = D / hg::BN;
  const CUtensorMap *pd2 = &md2, *pwk = &mwk;
  hg::run<1, DOWN_STAGES, 0, 0, false, false>(
      cdiv(R, S::ROWS) * nd,
      [=](int t) {
        return hg::Tile{t / nd * S::ROWS, t % nd * hg::BN, 2 * D / hg::BK, 0,
                        0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = kb * hg::BK;
        hg::tma_load(dst, pd2, bar, k, tl.m0);
        hg::tma_load(dst + S::A, pwk, bar, k, tl.n0);
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

// ---- ln: the LayerNorm backward, dgamma and dbeta partials of each
// 64-row block (8 warps, rows warp, warp + 8, ...)
template <int D>
__global__ void __launch_bounds__(RW)
    glu_in_bwd_ln(const bf16* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ dh,
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
      float ov[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ov[e] = rs * (dxh[j][e] - m1 - xh[j][e] * m2);
      store4(dx + o + 4 * (lane + 32 * j), ov);
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

// ---- wgrad: dW = h^T . dh2 on cooperative tiles of 128 x 128 of (D, 2D),
// MN-major operands. Tile t is split t / tiles of R (`per` blocks of 64
// rows each, written at out + split · stride) of output tile t % tiles.
__global__ void __launch_bounds__(hg::THREADS, 1)
    glu_in_bwd_wgrad(const __grid_constant__ CUtensorMap mh,
                     const __grid_constant__ CUtensorMap md2,
                     float* __restrict__ out, size_t stride, int R, int D,
                     int splits, int per) {
  using S = hg::Shape<false>;
  const int nn = 2 * D / hg::BN, tiles = D / S::ROWS * nn;
  const int kbs = cdiv(R, hg::BK);
  const CUtensorMap *ph = &mh, *pd2 = &md2;
  hg::run<1, WGRAD_STAGES, 1, 1, false, false>(
      tiles * splits,
      [=](int t) {
        const int b = t % tiles, split = t / tiles;
        return hg::Tile{b / nn * S::ROWS, b % nn * hg::BN,
                        min(per, kbs - split * per), split * per, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int r = (tl.k0 + kb) * hg::BK;
        hg::tma_load(dst, ph, bar, tl.m0, r);
        hg::tma_load(dst + 8192, ph, bar, tl.m0 + 64, r);
        hg::tma_load(dst + S::A, pd2, bar, tl.n0, r);
        hg::tma_load(dst + S::A + 8192, pd2, bar, tl.n0 + 64, r);
      },
      [=](const hg::Tile& tl, float (&acc)[1][64], const hg::Ctx& ctx) {
        float* o = out + (size_t)(tl.k0 / per) * stride;
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int row = tl.m0 + ctx.rows + hg::frag_row(r);
          const int col = tl.n0 + hg::frag_col(r);
          *reinterpret_cast<float2*>(o + (size_t)row * 2 * D + col) =
              make_float2(acc[0][r], acc[0][r + 1]);
        }
      });
}

// ---- reduce: blocks below `chunks` sum the column partials of 32
// columns of (db | dgamma | dbeta), 8 warps over the row blocks in turn and
// then the 8 warp sums in order; the others sum the weight partials when R
// is split, in the order of the splits.
__global__ void __launch_bounds__(256)
    glu_in_bwd_reduce(const float* __restrict__ ws, int splits,
                      float* __restrict__ dw, const float* __restrict__ pdbw,
                      const float* __restrict__ pdg,
                      const float* __restrict__ pdb, float* __restrict__ dbw,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      int R, int D) {
  __shared__ float red[8][32];
  const int chunks = 4 * D / 32;
  if ((int)blockIdx.x < chunks) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int c = blockIdx.x * 32 + lane;  // D is a multiple of 32
    const float* p = pdbw;
    float* out = dbw;
    int ld = 2 * D;
    if (c >= 2 * D) {
      c -= 2 * D;
      const bool beta = c >= D;
      c %= D;
      p = beta ? pdb : pdg;
      out = beta ? dbeta : dgamma;
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
  const size_t DW = (size_t)D * 2 * D;
  for (size_t i = (size_t)(blockIdx.x - chunks) * blockDim.x + threadIdx.x;
       i < DW; i += (size_t)(gridDim.x - chunks) * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[sp * DW + i];
    dw[i] = s;
  }
}

// Splits of R in the wgrad stage: as many as fill the SMs once with the
// (D/128)·(2D/128) output tiles, at most MAX_SPLITS, none empty.
int wgrad_splits(int R, int D) {
  const int tiles = (D / hg::BN) * (2 * D / hg::BN);
  const int kb = cdiv(R, hg::BK);
  if (kb <= 1) return 1;
  const int s = std::max(1, std::min(std::min(MAX_SPLITS, SMS / tiles), kb));
  return cdiv(kb, cdiv(kb, s));
}

// The f32 workspace: dh, LN statistics, column partials, weight partials.
struct Work {
  float *dh, *stats, *pdbw, *pdg, *pdb, *ws;
  size_t floats;
};

Work carve(float* base, int R, int D) {
  Work w;
  size_t o = 0;
  auto take = [&](size_t n) {
    float* p = base == nullptr ? nullptr : base + o;
    o += (n + 63) / 64 * 64;
    return p;
  };
  const int splits = wgrad_splits(R, D);
  const size_t rb = cdiv(R, ROWS);
  w.dh = take((size_t)R * D);
  w.stats = take(2 * (size_t)R);
  w.pdbw = take(rb * 2 * D);
  w.pdg = take(rb * D);
  w.pdb = take(rb * D);
  w.ws = take(splits > 1 ? (size_t)splits * 2 * D * D : 0);
  w.floats = o;
  return w;
}

template <bool PP>
cudaError_t launch_fwd_up(const bf16* h, const bf16* w, const float* mask,
                          const float* bw, bf16* out, int R, int D,
                          cudaStream_t s) {
  CUtensorMap mh, mw;
  CATK_TRY(hg::tensor_map(&mh, h, R, D, hg::Shape<PP>::ROWS));
  CATK_TRY(hg::tensor_map(&mw, w, D, 2 * D, 64));
  constexpr int smem =
      hg::smem_bytes<PP>(2, PP ? UP_STAGES_PP : UP_STAGES);
  CATK_TRY(hg::prepare(glu_in_fwd_up<PP>, smem, true));
  glu_in_fwd_up<PP>
      <<<hg::grid_for(cdiv(R, hg::Shape<PP>::ROWS) * (D / hg::BN)),
         hg::THREADS, smem, s>>>(mh, mw, mask, bw, out, R, D);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd(const bf16* x, const float* mask, const float* gamma,
                       const float* beta, const bf16* w, const float* bw,
                       bf16* out, bf16* h, int R, cudaStream_t s) {
  glu_in_fwd_ln<D><<<cdiv(R, RW / 32), RW, 0, s>>>(x, gamma, beta, h, R);
  CATK_TRY(cudaGetLastError());
  return hg::pingpong(R, D / hg::BN)
             ? launch_fwd_up<true>(h, w, mask, bw, out, R, D, s)
             : launch_fwd_up<false>(h, w, mask, bw, out, R, D, s);
}

struct Args {
  const bf16 *x, *w, *dout;
  const float *mask, *gamma, *beta, *bw;
  bf16 *dx, *h, *dh2;
  float *dgamma, *dbeta, *dw, *dbw;
  Work ws;
  int R;
};

template <int D>
cudaError_t launch_bwd(const Args& a, cudaStream_t s) {
  const int R = a.R;
  const Work& w = a.ws;
  // boxes of 64 or 128 rows x 64 columns
  CUtensorMap mh, mw, md2_128, mwk, md2_64;
  CATK_TRY(hg::tensor_map(&mh, a.h, R, D, 64));
  CATK_TRY(hg::tensor_map(&mw, a.w, D, 2 * D, 64));
  CATK_TRY(hg::tensor_map(&md2_128, a.dh2, R, 2 * D, 128));
  CATK_TRY(hg::tensor_map(&mwk, a.w, D, 2 * D, 128));
  CATK_TRY(hg::tensor_map(&md2_64, a.dh2, R, 2 * D, 64));

  glu_in_bwd_prep<D><<<cdiv(R, RW / 32), RW, 0, s>>>(a.x, a.gamma, a.beta,
                                                      a.h, w.stats, R);
  CATK_TRY(cudaGetLastError());

  const int rb = cdiv(R, ROWS);
  constexpr int up_smem = hg::smem_bytes<true>(2, UP_STAGES_PP);
  CATK_TRY(hg::prepare(glu_in_bwd_up, up_smem, true));
  glu_in_bwd_up<<<hg::grid_for(rb * (D / hg::BN)), hg::THREADS, up_smem,
                  s>>>(mh, mw, a.mask, a.bw, a.dout, a.dh2, w.pdbw, R, D);
  CATK_TRY(cudaGetLastError());

  constexpr int down_smem = hg::smem_bytes<false>(1, DOWN_STAGES);
  CATK_TRY(hg::prepare(glu_in_bwd_down, down_smem, false));
  glu_in_bwd_down<<<hg::grid_for(cdiv(R, 128) * (D / hg::BN)), hg::THREADS,
                    down_smem, s>>>(md2_128, mwk, w.dh, R, D);
  CATK_TRY(cudaGetLastError());

  glu_in_bwd_ln<D><<<rb, RW, 0, s>>>(a.x, a.gamma, w.dh, w.stats, a.dx,
                                     w.pdg, w.pdb, R);
  CATK_TRY(cudaGetLastError());

  const int splits = wgrad_splits(R, D);
  const int tiles = (D / hg::BN) * (2 * D / hg::BN);
  constexpr int wg_smem = hg::smem_bytes<false>(1, WGRAD_STAGES);
  CATK_TRY(hg::prepare(glu_in_bwd_wgrad, wg_smem, false));
  glu_in_bwd_wgrad<<<hg::grid_for(tiles * splits), hg::THREADS, wg_smem,
                     s>>>(mh, md2_64, splits > 1 ? w.ws : a.dw,
                          (size_t)2 * D * D, R, D, splits,
                          cdiv(cdiv(R, hg::BK), splits));
  CATK_TRY(cudaGetLastError());

  const int chunks = 4 * D / 32;
  const int wblocks = splits > 1 ? 4 * SMS : 0;
  glu_in_bwd_reduce<<<chunks + wblocks, 256, 0, s>>>(
      w.ws, splits, a.dw, w.pdbw, w.pdg, w.pdb, a.dbw, a.dgamma, a.dbeta, R,
      D);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launches (0 on success). x, out and h (R,
// D) bf16 (h is scratch, written whole); mask (R,), gamma, beta (D,) and
// bw (2D,) f32; w (D, 2D) bf16. D must be 128, 256, 384 or 512 and every
// pointer 16-byte aligned; the Python wrapper checks both.
extern "C" int glu_in_fwd(const void* x, const void* mask, const void* gamma,
                          const void* beta, const void* w, const void* bw,
                          void* out, void* h, int R, int D, void* stream) {
  if (R <= 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto m = static_cast<const float*>(mask);
  auto g = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto wb = static_cast<const bf16*>(w);
  auto bf = static_cast<const float*>(bw);
  auto o = static_cast<bf16*>(out);
  auto hb = static_cast<bf16*>(h);
  switch (D) {
    case 128: return launch_fwd<128>(xb, m, g, be, wb, bf, o, hb, R, s);
    case 256: return launch_fwd<256>(xb, m, g, be, wb, bf, o, hb, R, s);
    case 384: return launch_fwd<384>(xb, m, g, be, wb, bf, o, hb, R, s);
    case 512: return launch_fwd<512>(xb, m, g, be, wb, bf, o, hb, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// The f32 workspace `glu_in_bwd` needs for R rows, in units of 64 floats
// (256 bytes). The stream is not used.
extern "C" int glu_in_bwd_workspace(int R, int D, void*) {
  return R <= 0 ? 0 : (int)(carve(nullptr, R, D).floats / 64);
}

// Returns the CUDA error of the launches (0 on success). x, dout, dx, h
// (R, D) and dh2 (R, 2D) bf16 (h and dh2 are scratch); mask, gamma, beta,
// bw as in glu_in_fwd; the gradient outputs dgamma, dbeta (D,), dw (D, 2D)
// and dbw (2D,) f32, written whole; ws an f32 workspace of ws_units · 64
// floats (`glu_in_bwd_workspace`). D and the pointers as in glu_in_fwd.
extern "C" int glu_in_bwd(const void* x, const void* mask, const void* gamma,
                          const void* beta, const void* w, const void* bw,
                          const void* dout, void* dx, void* h, void* dh2,
                          void* dgamma, void* dbeta, void* dw, void* dbw,
                          void* ws, int R, int D, int ws_units,
                          void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D != 128 && D != 256 && D != 384 && D != 512)
    return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[4] = {dgamma, dbeta, dw, dbw};
    const size_t n[4] = {(size_t)D, (size_t)D, (size_t)2 * D * D,
                         (size_t)2 * D};
    for (int i = 0; i < 4; ++i)
      CATK_TRY(cudaMemsetAsync(outs[i], 0, n[i] * 4, s));
    return cudaSuccess;
  }
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.w = static_cast<const bf16*>(w);
  a.dout = static_cast<const bf16*>(dout);
  a.mask = static_cast<const float*>(mask);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.bw = static_cast<const float*>(bw);
  a.dx = static_cast<bf16*>(dx);
  a.h = static_cast<bf16*>(h);
  a.dh2 = static_cast<bf16*>(dh2);
  a.dgamma = static_cast<float*>(dgamma);
  a.dbeta = static_cast<float*>(dbeta);
  a.dw = static_cast<float*>(dw);
  a.dbw = static_cast<float*>(dbw);
  a.ws = carve(static_cast<float*>(ws), R, D);
  if (a.ws.floats > (size_t)ws_units * 64) return cudaErrorInvalidValue;
  a.R = R;
  switch (D) {
    case 128: return launch_bwd<128>(a, s);
    case 256: return launch_bwd<256>(a, s);
    case 384: return launch_bwd<384>(a, s);
    default: return launch_bwd<512>(a, s);
  }
}
