// Helpers shared by the port's forward kernels (bf16 operands, f32 sums).
//
// Products use the warp-level `nvcuda::wmma` bf16 16x16x16 fragments;
// each kernel keeps its activation tiles in shared memory and reads the
// weight fragments straight from global memory (they stay in L2).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace catk {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
// B given as its transpose, row-major: B[k][n] = src[n * ld + k].
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + __expf(-x));
}

// One warp: LayerNorm of one row of D values (f32 statistics, two-pass
// variance), times gamma plus beta, written as bf16 to `dst`. A row past
// the end (`valid` false) is normalised from zeros, so it stays finite.
template <int D>
__device__ __forceinline__ void layer_norm_row(const bf16* __restrict__ x,
                                               bool valid,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               float eps, bf16* dst,
                                               int lane) {
  constexpr int PER = D / 32;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = valid ? __bfloat162float(x[lane + 32 * i]) : 0.f;
    s += v[i];
  }
  const float mean = warp_sum(s) / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = v[i] - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    dst[c] = __float2bfloat16((v[i] - mean) * rstd * gamma[c] + beta[c]);
  }
}

// acc += A(16 x K, shared, row-major, lda) . B(K x 16, global, row-major, ldb)
template <int K>
__device__ __forceinline__ void mma_rows16(FragC& acc,
                                           const bf16* __restrict__ a, int lda,
                                           const bf16* __restrict__ b,
                                           int ldb) {
#pragma unroll 4
  for (int k = 0; k < K; k += 16) {
    FragA fa;
    FragB fb;
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, b + (size_t)k * ldb, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

}  // namespace catk
