// Conformer convolution module, backward of the two fused stages.
// Replaces the TPU kernels `_glu_in_bwd_kernel` and `_bn_out_bwd_kernel`
// of cat_tpu/ops/conv_module_pallas.py.
//
// glu_in (forward: out = mask * GLU(LN(x) . W + b), W (D, 2D)), given dO:
//   [u | g] = LN(x) . W + b;  da = dO * mask
//   du = da * sigmoid(g), dg = da * u * sigmoid'(g); dh2 = [du | dg] (bf16)
//   db = sum_rows dh2, dW = LN(x)^T . dh2, dh = dh2 . W^T, then the
//   LayerNorm backward gives dx, dgamma, dbeta.
// bn_out (forward: out = x + mask * drop(SiLU(y0) . W + b),
//   y0 = (c - mu) * rstd * scale + bias, rstd = rsqrt(var + 1e-5)):
//   dh = drop(dO * mask) (bf16), db = sum_rows dh, dW = SiLU(y0)^T . dh,
//   dy0 = (dh . W^T) * SiLU'(y0), dc = dy0 * scale * rstd,
//   dscale = sum dy0 * xn, dbias = sum dy0, and for the batch statistics
//   dmu = -scale * rstd * sum dy0, dvar = -0.5 * scale * rstd^2 * sum dy0*xn,
//   so that autograd completes the statistics -> conv output chain outside
//   the kernel. dx = dO (the residual) is the wrapper's.
//
// Each stage is a row pass plus one weight-gradient launch, as in
// ffn_bwd.cu: one block of 8 warps owns 32 rows, produces its output in
// chunks of 64 columns with the elementwise backward applied in shared
// memory, adds its column-sum partials with f32 atomics, and writes the
// bf16 operands of dW as scratch; `atb_kernel` (common.cuh) then sums
// dW over all rows.
//
// What bounds them on the H100, at the training batch (R = 15,776,
// D = 512): glu_in backward is 12·R·D² FLOP (recomputed forward, dh, dW),
// 50 GFLOP, 0.05 ms at 989 TFLOP/s; bn_out backward 4·R·D², 17 GFLOP,
// 0.017 ms, against ~0.1 GB of rows and scratch (0.03 ms at 3.35 TB/s).
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BM = 32;
constexpr int NC = 64;
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int LDC = NC + 4;  // f32 chunk
constexpr int LDB = NC + 8;  // bf16 chunk

template <int D>
struct GluSmem {
  static constexpr int LDX = D + 8;
  static constexpr int LDD = D + 4;
  static constexpr int ROWS = align128(BM * LDD * 4);  // >= bf16 LN rows
  static constexpr int OFF_U = ROWS;
  static constexpr int OFF_G = OFF_U + align128(BM * LDC * 4);
  static constexpr int OFF_DU = OFF_G + align128(BM * LDC * 4);
  static constexpr int OFF_DG = OFF_DU + align128(BM * LDB * 2);
  static constexpr int OFF_ST = OFF_DG + align128(BM * LDB * 2);
  static constexpr int BYTES = OFF_ST + align128(2 * BM * 4);
};

template <int D>
__global__ void __launch_bounds__(NT)
    glu_in_bwd_rows_kernel(const bf16* __restrict__ x,
                           const float* __restrict__ mask,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           const bf16* __restrict__ w,
                           const float* __restrict__ bw,
                           const bf16* __restrict__ dout,
                           bf16* __restrict__ dx, bf16* __restrict__ h_out,
                           bf16* __restrict__ dh2_out,
                           float* __restrict__ dgamma,
                           float* __restrict__ dbeta,
                           float* __restrict__ dbw, int R) {
  using S = GluSmem<D>;
  constexpr int NJ = D / (16 * NWARPS);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* dhs = reinterpret_cast<float*>(smem);  // after the chunk loop
  float* us = reinterpret_cast<float*>(smem + S::OFF_U);
  float* gs = reinterpret_cast<float*>(smem + S::OFF_G);
  bf16* dus = reinterpret_cast<bf16*>(smem + S::OFF_DU);
  bf16* dgs = reinterpret_cast<bf16*>(smem + S::OFF_DG);
  float* mean_s = reinterpret_cast<float*>(smem + S::OFF_ST);
  float* rstd_s = mean_s + BM;
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
  __syncthreads();

  FragC acc[2][NJ];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[g][j], 0.f);
  const int rg = warp >> 2, cg = warp & 3;
  const int col0 = warp * (D / NWARPS);
  for (int c0 = 0; c0 < D; c0 += NC) {
    {
      FragC u, g;
      wmma::fill_fragment(u, 0.f);
      wmma::fill_fragment(g, 0.f);
      const bf16* a = xs + rg * 16 * S::LDX;
      mma_rows16<D>(u, a, S::LDX, w + c0 + cg * 16, 2 * D);
      mma_rows16<D>(g, a, S::LDX, w + D + c0 + cg * 16, 2 * D);
      wmma::store_matrix_sync(us + rg * 16 * LDC + cg * 16, u, LDC,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(gs + rg * 16 * LDC + cg * 16, g, LDC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * NC; i += NT) {
      const int r = i / NC, c = i % NC, row = r0 + r;
      const float da =
          row < R ? __bfloat162float(dout[(size_t)row * D + c0 + c]) * mask[row]
                  : 0.f;
      const float uv = us[r * LDC + c] + bw[c0 + c];
      const float gv = gs[r * LDC + c] + bw[D + c0 + c];
      const float sg = sigmoid(gv);
      const float du = da * sg;
      const float dg = da * uv * sg * (1.f - sg);
      us[r * LDC + c] = du;
      gs[r * LDC + c] = dg;
      const bf16 dub = __float2bfloat16(du), dgb = __float2bfloat16(dg);
      dus[r * LDB + c] = dub;
      dgs[r * LDB + c] = dgb;
      if (row < R) {
        dh2_out[(size_t)row * 2 * D + c0 + c] = dub;
        dh2_out[(size_t)row * 2 * D + D + c0 + c] = dgb;
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * NC) {
      const int c = threadIdx.x % NC;
      const float* src = threadIdx.x < NC ? us : gs;
      float s = 0.f;
      for (int r = 0; r < BM; ++r) s += src[r * LDC + c];
      atomicAdd(dbw + (threadIdx.x < NC ? 0 : D) + c0 + c, s);
    }
    // dh += du . W[:, c0:]^T + dg . W[:, D + c0:]^T
#pragma unroll
    for (int kk = 0; kk < NC; kk += 16) {
      FragA u0, u1, g0, g1;
      wmma::load_matrix_sync(u0, dus + kk, LDB);
      wmma::load_matrix_sync(u1, dus + 16 * LDB + kk, LDB);
      wmma::load_matrix_sync(g0, dgs + kk, LDB);
      wmma::load_matrix_sync(g1, dgs + 16 * LDB + kk, LDB);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bf16* wr = w + (size_t)(col0 + j * 16) * 2 * D + c0 + kk;
        FragBT bu, bg;
        wmma::load_matrix_sync(bu, wr, 2 * D);
        wmma::load_matrix_sync(bg, wr + D, 2 * D);
        wmma::mma_sync(acc[0][j], u0, bu, acc[0][j]);
        wmma::mma_sync(acc[1][j], u1, bu, acc[1][j]);
        wmma::mma_sync(acc[0][j], g0, bg, acc[0][j]);
        wmma::mma_sync(acc[1][j], g1, bg, acc[1][j]);
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
    for (int i = 0; i < PER; ++i)
      dx[(size_t)row * D + lane + 32 * i] =
          __float2bfloat16(rs * (dxh[i] - m1 - xh[i] * m2));
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
struct BnSmem {
  static constexpr int LDX = D + 8;
  static constexpr int OFF_DY = align128(BM * LDX * 2);
  static constexpr int OFF_XN = OFF_DY + align128(BM * LDC * 4);
  static constexpr int BYTES = OFF_XN + align128(BM * LDC * 4);
};

template <int D>
__global__ void __launch_bounds__(NT)
    bn_out_bwd_rows_kernel(const bf16* __restrict__ conv,
                           const float* __restrict__ mask,
                           const float* __restrict__ mu,
                           const float* __restrict__ var,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const bf16* __restrict__ w,
                           const bf16* __restrict__ dout,
                           bf16* __restrict__ dconv, bf16* __restrict__ y_out,
                           bf16* __restrict__ dh_out, float* __restrict__ dmu,
                           float* __restrict__ dvar,
                           float* __restrict__ dscale,
                           float* __restrict__ dbias,
                           float* __restrict__ dbw, int R, Drop dr) {
  using S = BnSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* dhs = reinterpret_cast<bf16*>(smem);
  float* dys = reinterpret_cast<float*>(smem + S::OFF_DY);
  float* xns = reinterpret_cast<float*>(smem + S::OFF_XN);
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * BM;

  // dh = drop(dO * mask) and y = SiLU(y0), 4 columns per thread
  for (int c4 = threadIdx.x; c4 < D / 4; c4 += NT) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < BM; ++r) {
      const int row = r0 + r;
      const unsigned kb = row < R ? keep4(dr, 0, 0, row, c4) : 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c4 * 4 + e;
        float dh = 0.f;
        if (row < R) {
          const size_t o = (size_t)row * D + c;
          dh = __bfloat162float(dout[o]) * mask[row] * keep_scale(dr, kb, e);
          const float y0 = (__bfloat162float(conv[o]) - mu[c]) *
                               rsqrtf(var[c] + 1e-5f) * scale[c] + bias[c];
          y_out[o] = __float2bfloat16(y0 * sigmoid(y0));
        }
        acc[e] += dh;
        const bf16 db = __float2bfloat16(dh);
        dhs[r * S::LDX + c] = db;
        if (row < R) dh_out[(size_t)row * D + c] = db;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) atomicAdd(dbw + c4 * 4 + e, acc[e]);
  }
  __syncthreads();

  const int rg = warp >> 2, cg = warp & 3;
  for (int c0 = 0; c0 < D; c0 += NC) {
    {
      FragC dy;
      wmma::fill_fragment(dy, 0.f);
      // dy = dh . W^T: W (D, D) read as the transpose of its rows
      mma_rows16_bt<D>(dy, dhs + rg * 16 * S::LDX, S::LDX,
                       w + (size_t)(c0 + cg * 16) * D, D);
      wmma::store_matrix_sync(dys + rg * 16 * LDC + cg * 16, dy, LDC,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BM * NC; i += NT) {
      const int r = i / NC, cc = i % NC, row = r0 + r, c = c0 + cc;
      float dy0 = 0.f, xn = 0.f;
      if (row < R) {
        const float rs = rsqrtf(var[c] + 1e-5f);
        xn = (__bfloat162float(conv[(size_t)row * D + c]) - mu[c]) * rs;
        const float y0 = xn * scale[c] + bias[c];
        const float sg = sigmoid(y0);
        dy0 = dys[r * LDC + cc] * sg * (1.f + y0 * (1.f - sg));
        dconv[(size_t)row * D + c] = __float2bfloat16(dy0 * scale[c] * rs);
      }
      dys[r * LDC + cc] = dy0;
      xns[r * LDC + cc] = dy0 * xn;
    }
    __syncthreads();
    if (threadIdx.x < NC) {
      const int c = c0 + threadIdx.x;
      float sb = 0.f, ss = 0.f;
      for (int r = 0; r < BM; ++r) {
        sb += dys[r * LDC + threadIdx.x];
        ss += xns[r * LDC + threadIdx.x];
      }
      const float rs = rsqrtf(var[c] + 1e-5f), sc = scale[c];
      atomicAdd(dbias + c, sb);
      atomicAdd(dscale + c, ss);
      atomicAdd(dmu + c, -sc * rs * sb);
      atomicAdd(dvar + c, -0.5f * sc * rs * rs * ss);
    }
    __syncthreads();
  }
}

template <int D>
cudaError_t launch_glu(const void* x, const void* mask, const void* gamma,
                       const void* beta, const void* w, const void* bw,
                       const void* dout, void* dx, void* h, void* dh2,
                       void* dgamma, void* dbeta, void* dw, void* dbw, int R,
                       cudaStream_t stream) {
  constexpr int bytes = GluSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      glu_in_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  glu_in_bwd_rows_kernel<D><<<(R + BM - 1) / BM, NT, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(w), static_cast<const float*>(bw),
      static_cast<const bf16*>(dout), static_cast<bf16*>(dx),
      static_cast<bf16*>(h), static_cast<bf16*>(dh2),
      static_cast<float*>(dgamma), static_cast<float*>(dbeta),
      static_cast<float*>(dbw), R);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_atb(static_cast<const bf16*>(h), D,
                    static_cast<const bf16*>(dh2), 2 * D,
                    static_cast<float*>(dw), D, 2 * D, R, stream);
}

template <int D>
cudaError_t launch_bn(const void* conv, const void* mask, const void* mu,
                      const void* var, const void* scale, const void* bias,
                      const void* w, const void* dout, void* dconv, void* y,
                      void* dh, void* dmu, void* dvar, void* dscale,
                      void* dbias, void* dw, void* dbw, int R, Drop dr,
                      cudaStream_t stream) {
  constexpr int bytes = BnSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      bn_out_bwd_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  bn_out_bwd_rows_kernel<D><<<(R + BM - 1) / BM, NT, bytes, stream>>>(
      static_cast<const bf16*>(conv), static_cast<const float*>(mask),
      static_cast<const float*>(mu), static_cast<const float*>(var),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const bf16*>(w), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dconv), static_cast<bf16*>(y),
      static_cast<bf16*>(dh), static_cast<float*>(dmu),
      static_cast<float*>(dvar), static_cast<float*>(dscale),
      static_cast<float*>(dbias), static_cast<float*>(dbw), R, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_atb(static_cast<const bf16*>(y), D,
                    static_cast<const bf16*>(dh), D, static_cast<float*>(dw),
                    D, D, R, stream);
}

}  // namespace

// Each returns the CUDA error of its launches (0 on success). Row tensors
// (R, D) bf16 (dh2 (R, 2D)), mask (R,) f32, vectors f32, W bf16; every
// gradient output in f32 is zeroed by the caller (the kernels add into
// it). D must be 128, 256, 384 or 512; the Python wrappers check it.
extern "C" int glu_in_bwd(const void* x, const void* mask, const void* gamma,
                          const void* beta, const void* w, const void* bw,
                          const void* dout, void* dx, void* h, void* dh2,
                          void* dgamma, void* dbeta, void* dw, void* dbw,
                          int R, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaSuccess;
  switch (D) {
    case 128: return launch_glu<128>(x, mask, gamma, beta, w, bw, dout, dx, h, dh2, dgamma, dbeta, dw, dbw, R, s);
    case 256: return launch_glu<256>(x, mask, gamma, beta, w, bw, dout, dx, h, dh2, dgamma, dbeta, dw, dbw, R, s);
    case 384: return launch_glu<384>(x, mask, gamma, beta, w, bw, dout, dx, h, dh2, dgamma, dbeta, dw, dbw, R, s);
    case 512: return launch_glu<512>(x, mask, gamma, beta, w, bw, dout, dx, h, dh2, dgamma, dbeta, dw, dbw, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// bn_out: seed0, seed1, thr, inv as in bn_out_fwd (the same mask).
extern "C" int bn_out_bwd(const void* conv, const void* mask, const void* mu,
                          const void* var, const void* scale,
                          const void* bias, const void* w, const void* dout,
                          void* dconv, void* y, void* dh, void* dmu,
                          void* dvar, void* dscale, void* dbias, void* dw,
                          void* dbw, int R, int D, int seed0, int seed1,
                          int thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (R <= 0) return cudaSuccess;
  switch (D) {
    case 128: return launch_bn<128>(conv, mask, mu, var, scale, bias, w, dout, dconv, y, dh, dmu, dvar, dscale, dbias, dw, dbw, R, dr, s);
    case 256: return launch_bn<256>(conv, mask, mu, var, scale, bias, w, dout, dconv, y, dh, dmu, dvar, dscale, dbias, dw, dbw, R, dr, s);
    case 384: return launch_bn<384>(conv, mask, mu, var, scale, bias, w, dout, dconv, y, dh, dmu, dvar, dscale, dbias, dw, dbw, R, dr, s);
    case 512: return launch_bn<512>(conv, mask, mu, var, scale, bias, w, dout, dconv, y, dh, dmu, dvar, dscale, dbias, dw, dbw, R, dr, s);
    default: return cudaErrorInvalidValue;
  }
}
