// Helpers shared by the port's wmma kernels (bf16 operands, f32 sums).
//
// Products use the warp-level `nvcuda::wmma` bf16 16x16x16 fragments;
// each kernel keeps its activation tiles in shared memory and reads the
// weight fragments straight from global memory (they stay in L2). The
// Philox dropout bits, warp sums and the sigmoid are in common_math.cuh.
#pragma once

#include <mma.h>

#include "common_math.cuh"

namespace catk {

using namespace nvcuda;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
// B given as its transpose, row-major: B[k][n] = src[n * ld + k].
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
// A given as its transpose, row-major: A[i][k] = src[k * ld + i].
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
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

// acc += A(16 x K, shared, row-major, lda) . Bt^T, where Bt (16 x K) is
// row-major in global memory with row stride ldbt (a weight read as its
// transpose).
template <int K>
__device__ __forceinline__ void mma_rows16_bt(FragC& acc,
                                              const bf16* __restrict__ a,
                                              int lda,
                                              const bf16* __restrict__ bt,
                                              int ldbt) {
#pragma unroll 4
  for (int k = 0; k < K; k += 16) {
    FragA fa;
    FragBT fb;
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, bt + k, ldbt);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// One warp: LayerNorm statistics of one row of D values (f32, two-pass);
// writes LN(x) * gamma + beta as bf16 to `dst` (and to `gdst` when not
// null) and returns mean and rstd. A row past the end is normalised from
// zeros.
template <int D>
__device__ __forceinline__ void layer_norm_row_stats(
    const bf16* __restrict__ x, bool valid, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, bf16* dst, bf16* gdst,
    int lane, float& mean_out, float& rstd_out) {
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
    const bf16 h = __float2bfloat16((v[i] - mean) * rstd * gamma[c] + beta[c]);
    dst[c] = h;
    if (gdst != nullptr) gdst[c] = h;
  }
  mean_out = mean;
  rstd_out = rstd;
}

// ---- weight gradients: C (M x N, f32) += A^T . B, summed over R rows ----
//
// A (R x M) and B (R x N) bf16 row-major with row strides lda, ldb (both
// multiples of 8); M and N multiples of 64. A block of 4 warps owns a
// 64 x 64 tile of C (each warp 32 x 32 in registers) and walks its split
// of the rows 32 at a time through shared memory, the next 32 rows
// fetched into registers while the current ones are multiplied. Splits
// (grid z) add their partial tiles into C with f32 atomics, so C must be
// zeroed first and the order of the sum varies from run to run.
constexpr int ATB_T = 64;
constexpr int ATB_K = 32;
constexpr int ATB_LD = ATB_T + 8;

static __global__ void __launch_bounds__(128)
    atb_kernel(const bf16* __restrict__ A, int lda,
               const bf16* __restrict__ B, int ldb, float* __restrict__ C,
               int ldc, int R, int rows_per) {
  __shared__ __align__(128) bf16 as[ATB_K * ATB_LD];
  __shared__ __align__(128) bf16 bs[ATB_K * ATB_LD];
  const int m0 = blockIdx.y * ATB_T, n0 = blockIdx.x * ATB_T;
  const int rbeg = blockIdx.z * rows_per;
  const int rend = min(R, rbeg + rows_per);
  if (rbeg >= rend) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  uint4 ra[2], rb[2];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * 128, r = i >> 3, c = (i & 7) * 8;
      const int row = r0 + r;
      ra[q] = make_uint4(0, 0, 0, 0);
      rb[q] = make_uint4(0, 0, 0, 0);
      if (row < rend) {
        ra[q] = *reinterpret_cast<const uint4*>(A + (size_t)row * lda + m0 + c);
        rb[q] = *reinterpret_cast<const uint4*>(B + (size_t)row * ldb + n0 + c);
      }
    }
  };
  fetch(rbeg);
  for (int r0 = rbeg; r0 < rend; r0 += ATB_K) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int i = threadIdx.x + q * 128, r = i >> 3, c = (i & 7) * 8;
      *reinterpret_cast<uint4*>(as + r * ATB_LD + c) = ra[q];
      *reinterpret_cast<uint4*>(bs + r * ATB_LD + c) = rb[q];
    }
    __syncthreads();
    if (r0 + ATB_K < rend) fetch(r0 + ATB_K);
#pragma unroll
    for (int kk = 0; kk < ATB_K; kk += 16) {
      FragAT a[2];
      FragB b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + kk * ATB_LD + wm + i * 16, ATB_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * ATB_LD + wn + j * 16, ATB_LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* scr = reinterpret_cast<float*>(as) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        atomicAdd(C + (size_t)(m0 + wm + i * 16 + e / 16) * ldc + n0 + wn +
                      j * 16 + e % 16,
                  scr[e]);
      __syncwarp();
    }
}

// C (M x N, zeroed by the caller) += A^T . B over R rows; see atb_kernel.
static inline cudaError_t launch_atb(const bf16* A, int lda, const bf16* B,
                                     int ldb, float* C, int M, int N, int R,
                                     cudaStream_t stream) {
  if (M % ATB_T || N % ATB_T || lda % 8 || ldb % 8)
    return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const int tiles = (M / ATB_T) * (N / ATB_T);
  // about four blocks per SM of the 132, each split at least 256 rows
  int splits = (4 * 132 + tiles - 1) / tiles;
  splits = max(1, min(splits, (R + 255) / 256));
  const int rows_per = ((R + splits - 1) / splits + ATB_K - 1) / ATB_K * ATB_K;
  splits = (R + rows_per - 1) / rows_per;
  atb_kernel<<<dim3(N / ATB_T, M / ATB_T, splits), 128, 0, stream>>>(
      A, lda, B, ldb, C, N, R, rows_per);
  return cudaGetLastError();
}

}  // namespace catk
