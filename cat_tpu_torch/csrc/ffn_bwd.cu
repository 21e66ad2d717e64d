// Fused conformer feed-forward module, backward. Replaces the TPU kernel
// `_ff_bwd_kernel` of cat_tpu/ops/ffn_pallas.py.
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
//
// Three launches, all in this file. (1) The row pass: one block of 8 warps
// owns 32 rows; it recomputes LN(x), walks F in chunks of 64 (h1 and da1
// chunks by wmma from shared-memory rows and L2-resident weights, the
// elementwise SiLU/dropout backward in shared memory, dh accumulated in
// registers as the forward accumulates its output), then runs the
// LayerNorm backward. It writes dx and, as bf16 scratch for the weight
// gradients, h (R, D), dh2 (R, D), a1 (R, F) and dh1 (R, F). The vector
// gradients are column sums: each block adds its 32-row partial with f32
// atomics. (2, 3) dW1 = h^T . dh1 and dW2 = a1^T . dh2 by `atb_kernel`
// (common.cuh): a sum over all R rows, which no block can carry as the
// TPU's sequential grid carries it in VMEM scratch, so the rows are split
// over blocks whose f32 partials meet in atomics.
//
// What bounds it on the H100: about 10·R·D·F FLOP (h1 and da1 recomputed,
// dh, dW1, dW2), 165 GFLOP at the training batch (R = 15,776, D = 512,
// F = 2048): 0.17 ms at 989 TFLOP/s, against ~0.3 GB of scratch traffic
// (0.1 ms at 3.35 TB/s): operations bound it. The design is the simple
// one: wmma fragments straight from L2 and one tile per warp between
// barriers, far from that bound.
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BM = 32;
constexpr int FC = 64;
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;

template <int D>
struct BwdSmem {
  static constexpr int LDX = D + 8;    // bf16 rows: LN(x), dh2
  static constexpr int LDD = D + 4;    // f32 dh rows (after the F loop)
  static constexpr int LDH = FC + 4;   // f32 chunk
  static constexpr int LDHB = FC + 8;  // bf16 chunk
  static constexpr int OFF_D2 = align128(BM * LDX * 2);
  static constexpr int OFF_H = OFF_D2 + align128(BM * LDX * 2);
  static constexpr int OFF_DA = OFF_H + align128(BM * LDH * 4);
  static constexpr int OFF_D1 = OFF_DA + align128(BM * LDH * 4);
  static constexpr int OFF_ST = OFF_D1 + align128(BM * LDHB * 2);
  static constexpr int BYTES = OFF_ST + align128(2 * BM * 4);
  static_assert(BM * LDD * 4 <= OFF_H, "dh aliases the LN(x) and dh2 rows");
};

template <int D>
__global__ void __launch_bounds__(NT)
    ffn_bwd_rows_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const bf16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const bf16* __restrict__ dout, bf16* __restrict__ dx,
                        bf16* __restrict__ h_out, bf16* __restrict__ dh2_out,
                        bf16* __restrict__ a1_out, bf16* __restrict__ dh1_out,
                        float* __restrict__ dgamma, float* __restrict__ dbeta,
                        float* __restrict__ db1, float* __restrict__ db2,
                        int R, int F, float alpha, Drop dr) {
  using S = BwdSmem<D>;
  constexpr int NJ = D / (16 * NWARPS);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* d2s = reinterpret_cast<bf16*>(smem + S::OFF_D2);
  float* hcs = reinterpret_cast<float*>(smem + S::OFF_H);
  float* dac = reinterpret_cast<float*>(smem + S::OFF_DA);
  bf16* d1s = reinterpret_cast<bf16*>(smem + S::OFF_D1);
  float* mean_s = reinterpret_cast<float*>(smem + S::OFF_ST);
  float* rstd_s = mean_s + BM;
  float* dhs = reinterpret_cast<float*>(smem);  // after the F loop

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += NWARPS) {
    const int row = r0 + r;
    float mu, rs;
    layer_norm_row_stats<D>(x + (size_t)row * D, row < R, gamma, beta, 1e-6f,
                            xs + r * S::LDX,
                            row < R ? h_out + (size_t)row * D : nullptr,
                            lane, mu, rs);
    if (lane == 0) {
      mean_s[r] = mu;
      rstd_s[r] = rs;
    }
  }
  // dh2 = alpha * drop1(dO), 4 columns per thread; db2 partial sums
  for (int c4 = threadIdx.x; c4 < D / 4; c4 += NT) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; ++r) {
      const int row = r0 + r;
      const unsigned kb = row < R ? keep4(dr, 1, 0, row, c4) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c4 * 4 + e;
        const float v =
            row < R ? alpha * __bfloat162float(dout[(size_t)row * D + c]) *
                          keep_scale(dr, kb, e)
                    : 0.f;
        acc[e] += v;
        const bf16 vb = __float2bfloat16(v);
        d2s[r * S::LDX + c] = vb;
        if (row < R) dh2_out[(size_t)row * D + c] = vb;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) atomicAdd(db2 + c4 * 4 + e, acc[e]);
  }
  __syncthreads();

  FragC acc[2][NJ];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[g][j], 0.f);

  const int rg = warp >> 2, cg = warp & 3;  // this warp's tile of a chunk
  const int col0 = warp * (D / NWARPS);     // this warp's columns of dh
  for (int f0 = 0; f0 < F; f0 += FC) {
    {
      FragC h, da;
      wmma::fill_fragment(h, 0.f);
      wmma::fill_fragment(da, 0.f);
      mma_rows16<D>(h, xs + rg * 16 * S::LDX, S::LDX, w1 + f0 + cg * 16, F);
      // da1 = dh2 . W2^T: W2 (F, D) read as the transpose of its rows
      mma_rows16_bt<D>(da, d2s + rg * 16 * S::LDX, S::LDX,
                       w2 + (size_t)(f0 + cg * 16) * D, D);
      wmma::store_matrix_sync(hcs + rg * 16 * S::LDH + cg * 16, h, S::LDH,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dac + rg * 16 * S::LDH + cg * 16, da, S::LDH,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int g = threadIdx.x; g < BM * FC / 4; g += NT) {
      const int r = g / (FC / 4), c = (g % (FC / 4)) * 4, row = r0 + r;
      const unsigned kb = row < R ? keep4(dr, 0, 0, row, (f0 + c) >> 2) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = hcs[r * S::LDH + c + e] + b1[f0 + c + e];
        const float sg = sigmoid(v);
        const float ks = keep_scale(dr, kb, e);
        const float dh1 =
            dac[r * S::LDH + c + e] * ks * sg * (1.f + v * (1.f - sg));
        dac[r * S::LDH + c + e] = dh1;  // kept in f32 for db1
        const bf16 d1b = __float2bfloat16(dh1);
        d1s[r * S::LDHB + c + e] = d1b;
        if (row < R) {
          const size_t o = (size_t)row * F + f0 + c + e;
          a1_out[o] = __float2bfloat16(v * sg * ks);
          dh1_out[o] = d1b;
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < FC) {
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += dac[r * S::LDH + threadIdx.x];
      atomicAdd(db1 + f0 + threadIdx.x, s);
    }
    // dh += dh1 . W1^T: W1 (D, F) read as the transpose of its rows
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      FragA a0, a1;
      wmma::load_matrix_sync(a0, d1s + kk, S::LDHB);
      wmma::load_matrix_sync(a1, d1s + 16 * S::LDHB + kk, S::LDHB);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragBT b;
        wmma::load_matrix_sync(b, w1 + (size_t)(col0 + j * 16) * F + f0 + kk,
                               F);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      wmma::store_matrix_sync(dhs + g * 16 * S::LDD + col0 + j * 16,
                              acc[g][j], S::LDD, wmma::mem_row_major);
  __syncthreads();

  // LayerNorm backward, one warp per row
  constexpr int PER = D / 32;
  for (int r = warp; r < BM; r += NWARPS) {
    const int row = r0 + r;
    if (row >= R) continue;
    const float mu = mean_s[r], rs = rstd_s[r];
    float xh[PER], dxh[PER];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = lane + 32 * i;
      xh[i] = (__bfloat162float(x[(size_t)row * D + c]) - mu) * rs;
      dxh[i] = dhs[r * S::LDD + c] * gamma[c];
      s1 += dxh[i];
      s2 += dxh[i] * xh[i];
    }
    const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const size_t o = (size_t)row * D + lane + 32 * i;
      dx[o] = __float2bfloat16(__bfloat162float(dout[o]) +
                               rs * (dxh[i] - m1 - xh[i] * m2));
    }
  }
  for (int c = threadIdx.x; c < D; c += NT) {
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < BM && r0 + r < R; ++r) {
      const float dh = dhs[r * S::LDD + c];
      const float xh =
          (__bfloat162float(x[(size_t)(r0 + r) * D + c]) - mean_s[r]) *
          rstd_s[r];
      sg += dh * xh;
      sb += dh;
    }
    atomicAdd(dgamma + c, sg);
    atomicAdd(dbeta + c, sb);
  }
}

template <int D>
cudaError_t launch(const bf16* x, const float* gamma, const float* beta,
                   const bf16* w1, const float* b1, const bf16* w2,
                   const bf16* dout, bf16* dx, bf16* h, bf16* dh2, bf16* a1,
                   bf16* dh1, float* dgamma, float* dbeta, float* dw1,
                   float* db1, float* dw2, float* db2, int R, int F,
                   float alpha, Drop dr, cudaStream_t stream) {
  using S = BwdSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::BYTES);
  if (err != cudaSuccess) return err;
  ffn_bwd_rows_kernel<D><<<(R + BM - 1) / BM, NT, S::BYTES, stream>>>(
      x, gamma, beta, w1, b1, w2, dout, dx, h, dh2, a1, dh1, dgamma, dbeta,
      db1, db2, R, F, alpha, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_atb(h, D, dh1, F, dw1, D, F, R, stream);  // dW1 = h^T . dh1
  if (err != cudaSuccess) return err;
  return launch_atb(a1, F, dh2, D, dw2, F, D, R, stream);  // dW2 = a1^T . dh2
}

}  // namespace

// Returns the CUDA error of the launches (0 on success). x, dout, dx,
// h, dh2 (R, D) and a1, dh1 (R, F) bf16; the gradient outputs dgamma,
// dbeta, dw1, db1, dw2, db2 f32, zeroed by the caller (the kernels add
// into them). D must be 128, 256, 384 or 512 and F a multiple of 64; the
// Python wrapper checks both. Dropout as in ffn_fwd.
extern "C" int ffn_bwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* dout, void* dx, void* h, void* dh2,
                       void* a1, void* dh1, void* dgamma, void* dbeta,
                       void* dw1, void* db1, void* dw2, void* db2, int R,
                       int D, int F, int seed0, int seed1, int thr,
                       float alpha, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (R <= 0) return cudaSuccess;
  if (F % FC != 0) return cudaErrorInvalidValue;
#define CATK_FFN_BWD(DD)                                                    \
  launch<DD>(static_cast<const bf16*>(x), static_cast<const float*>(gamma), \
             static_cast<const float*>(beta), static_cast<const bf16*>(w1), \
             static_cast<const float*>(b1), static_cast<const bf16*>(w2),   \
             static_cast<const bf16*>(dout), static_cast<bf16*>(dx),        \
             static_cast<bf16*>(h), static_cast<bf16*>(dh2),                \
             static_cast<bf16*>(a1), static_cast<bf16*>(dh1),               \
             static_cast<float*>(dgamma), static_cast<float*>(dbeta),       \
             static_cast<float*>(dw1), static_cast<float*>(db1),            \
             static_cast<float*>(dw2), static_cast<float*>(db2), R, F,      \
             alpha, dr, s)
  switch (D) {
    case 128: return CATK_FFN_BWD(128);
    case 256: return CATK_FFN_BWD(256);
    case 384: return CATK_FFN_BWD(384);
    case 512: return CATK_FFN_BWD(512);
    default: return cudaErrorInvalidValue;
  }
#undef CATK_FFN_BWD
}
