// Conformer convolution module's exit stage, bn_out, backward (the entry
// stage, glu_in, is glu_in.cu). Replaces the TPU kernel
// `_bn_out_bwd_kernel` of cat_tpu/ops/conv_module_pallas.py.
//
// Forward: out = x + mask * drop(SiLU(y0) . W + b),
//   y0 = (c - mu) * rstd * scale + bias, rstd = rsqrt(var + 1e-5).
// Backward: dh = drop(dO * mask) (bf16), db = sum_rows dh,
//   dW = SiLU(y0)^T . dh, dy0 = (dh . W^T) * SiLU'(y0),
//   dc = dy0 * scale * rstd, dscale = sum dy0 * xn, dbias = sum dy0, and
//   for the batch statistics dmu = -scale * rstd * sum dy0,
//   dvar = -0.5 * scale * rstd^2 * sum dy0*xn, so that autograd completes
//   the statistics -> conv output chain outside the kernel. dx = dO (the
//   residual) is the wrapper's.
//
// A row pass plus one weight-gradient launch: one block of 8 warps owns
// 32 rows, produces its output in chunks of 64 columns with the
// elementwise backward applied in shared memory, adds its column-sum
// partials with f32 atomics, and writes the bf16 operands of dW as
// scratch; `atb_kernel` (common.cuh) then sums dW over all rows.
//
// What bounds it on the H100, at the training batch (R = 15,776,
// D = 512): 4·R·D² FLOP, 17 GFLOP, 0.017 ms at 989 TFLOP/s, against ~0.1
// GB of rows and scratch (0.03 ms at 3.35 TB/s).
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BM = 32;
constexpr int NC = 64;
constexpr int NWARPS = 8;
constexpr int NT = NWARPS * 32;
constexpr int LDC = NC + 4;  // f32 chunk

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

// Returns the CUDA error of its launches (0 on success). Row tensors (R, D)
// bf16, mask (R,) f32, vectors f32, W bf16; every gradient output in f32
// is zeroed by the caller (the kernels add into it). D must be 128, 256,
// 384 or 512; the Python wrapper checks it. seed0, seed1, thr, inv as in
// bn_out_fwd (the same mask).
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
