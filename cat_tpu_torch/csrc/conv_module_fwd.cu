// Conformer convolution module: the two fused stages around the depthwise
// conv, forward.
//
//   glu_in: out = mask * GLU(LN(x) . W + b)       W (D, 2D), LN eps 1e-6
//   bn_out: out = x + mask * drop(SiLU((c - mu) * rsqrt(var + 1e-5) * s + t)
//                                 . W + b)        W (D, D)
// mu and var are the running statistics in eval and the masked batch
// statistics in training; the dropout (stream 0, by (row, column), see
// common.cuh) is the identity at rate 0.
//
// Rows are (R, D) bf16, mask (R,) f32, vectors f32, weights bf16
// row-major. One block of 8 warps owns BM = 32 rows: the normalised rows
// go to shared memory as bf16 once, then the output is produced in
// chunks of 64 columns (each warp one 16x16 tile of the 32x64 chunk, the
// full depth D), with the elementwise epilogue applied from shared memory
// before the chunk is stored. Only the inputs are read and the output
// written to device memory.
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BM = 32;
constexpr int NC = 64;
constexpr int NWARPS = 8;
constexpr int LDC = NC + 4;  // f32 chunk

template <int D>
struct Smem {
  static constexpr int LDX = D + 8;
  static constexpr int OFF_C = align128(BM * LDX * 2);
  static constexpr int BYTES_GLU = OFF_C + 2 * align128(BM * LDC * 4);
  static constexpr int BYTES_BN = OFF_C + align128(BM * LDC * 4);
};

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    glu_in_kernel(const bf16* __restrict__ x, const float* __restrict__ mask,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta, const bf16* __restrict__ w,
                  const float* __restrict__ bw, bf16* __restrict__ out,
                  int R) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* us = reinterpret_cast<float*>(smem + S::OFF_C);
  float* gs = us + align128(BM * LDC * 4) / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += NWARPS) {
    const int row = r0 + r;
    layer_norm_row<D>(x + (size_t)row * D, row < R, gamma, beta, 1e-6f,
                      xs + r * S::LDX, lane);
  }
  __syncthreads();

  const int rg = warp >> 2, cg = warp & 3;
  for (int c0 = 0; c0 < D; c0 += NC) {
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
    __syncthreads();
    for (int i = threadIdx.x; i < BM * NC; i += NWARPS * 32) {
      const int r = i / NC, c = i % NC, row = r0 + r;
      if (row < R) {
        const float uv = us[r * LDC + c] + bw[c0 + c];
        const float gv = gs[r * LDC + c] + bw[D + c0 + c];
        out[(size_t)row * D + c0 + c] =
            __float2bfloat16(mask[row] * (uv * sigmoid(gv)));
      }
    }
    __syncthreads();
  }
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    bn_out_kernel(const bf16* __restrict__ conv, const bf16* __restrict__ x,
                  const float* __restrict__ mask, const float* __restrict__ mu,
                  const float* __restrict__ var,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, const bf16* __restrict__ w,
                  const float* __restrict__ bw, bf16* __restrict__ out,
                  int R, Drop dr) {
  using S = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ys = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(smem + S::OFF_C);
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * BM;

  for (int i = threadIdx.x; i < BM * D; i += NWARPS * 32) {
    const int r = i / D, c = i % D, row = r0 + r;
    const float cv =
        row < R ? __bfloat162float(conv[(size_t)row * D + c]) : 0.f;
    float y = (cv - mu[c]) * rsqrtf(var[c] + 1e-5f) * scale[c] + bias[c];
    y = y * sigmoid(y);
    ys[r * S::LDX + c] = __float2bfloat16(y);
  }
  __syncthreads();

  const int rg = warp >> 2, cg = warp & 3;
  for (int c0 = 0; c0 < D; c0 += NC) {
    FragC h;
    wmma::fill_fragment(h, 0.f);
    mma_rows16<D>(h, ys + rg * 16 * S::LDX, S::LDX, w + c0 + cg * 16, D);
    wmma::store_matrix_sync(hs + rg * 16 * LDC + cg * 16, h, LDC,
                            wmma::mem_row_major);
    __syncthreads();
    for (int g = threadIdx.x; g < BM * NC / 4; g += NWARPS * 32) {
      const int r = g / (NC / 4), c = (g % (NC / 4)) * 4, row = r0 + r;
      if (row < R) {
        const unsigned kb = keep4(dr, 0, 0, row, (c0 + c) >> 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const size_t o = (size_t)row * D + c0 + c + e;
          const float hv = (hs[r * LDC + c + e] + bw[c0 + c + e]) *
                           keep_scale(dr, kb, e);
          out[o] = __float2bfloat16(__bfloat162float(x[o]) + mask[row] * hv);
        }
      }
    }
    __syncthreads();
  }
}

template <int D>
cudaError_t launch_glu(const void* x, const void* mask, const void* gamma,
                       const void* beta, const void* w, const void* bw,
                       void* out, int R, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES_GLU;
  cudaError_t err = cudaFuncSetAttribute(
      glu_in_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  glu_in_kernel<D><<<(R + BM - 1) / BM, NWARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<const bf16*>(w), static_cast<const float*>(bw),
      static_cast<bf16*>(out), R);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bn(const void* conv, const void* x, const void* mask,
                      const void* mu, const void* var, const void* scale,
                      const void* bias, const void* w, const void* bw,
                      void* out, int R, Drop dr, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES_BN;
  cudaError_t err = cudaFuncSetAttribute(
      bn_out_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  bn_out_kernel<D><<<(R + BM - 1) / BM, NWARPS * 32, bytes, stream>>>(
      static_cast<const bf16*>(conv), static_cast<const bf16*>(x),
      static_cast<const float*>(mask), static_cast<const float*>(mu),
      static_cast<const float*>(var), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<const bf16*>(w),
      static_cast<const float*>(bw), static_cast<bf16*>(out), R, dr);
  return cudaGetLastError();
}

}  // namespace

// Each returns the CUDA error of its launch (0 on success). D must be 128,
// 256, 384 or 512; the Python wrappers check it.
extern "C" int glu_in_fwd(const void* x, const void* mask, const void* gamma,
                          const void* beta, const void* w, const void* bw,
                          void* out, int R, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaSuccess;
  switch (D) {
    case 128: return launch_glu<128>(x, mask, gamma, beta, w, bw, out, R, s);
    case 256: return launch_glu<256>(x, mask, gamma, beta, w, bw, out, R, s);
    case 384: return launch_glu<384>(x, mask, gamma, beta, w, bw, out, R, s);
    case 512: return launch_glu<512>(x, mask, gamma, beta, w, bw, out, R, s);
    default: return cudaErrorInvalidValue;
  }
}

// bn_out: seed0, seed1, thr are the dropout seed words and keep threshold
// as uint32 bit patterns, inv = 1 / (1 - rate).
extern "C" int bn_out_fwd(const void* conv, const void* x, const void* mask,
                          const void* mu, const void* var, const void* scale,
                          const void* bias, const void* w, const void* bw,
                          void* out, int R, int D, int seed0, int seed1,
                          int thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (R <= 0) return cudaSuccess;
  switch (D) {
    case 128:
      return launch_bn<128>(conv, x, mask, mu, var, scale, bias, w, bw, out, R, dr, s);
    case 256:
      return launch_bn<256>(conv, x, mask, mu, var, scale, bias, w, bw, out, R, dr, s);
    case 384:
      return launch_bn<384>(conv, x, mask, mu, var, scale, bias, w, bw, out, R, dr, s);
    case 512:
      return launch_bn<512>(conv, x, mask, mu, var, scale, bias, w, bw, out, R, dr, s);
    default: return cudaErrorInvalidValue;
  }
}
