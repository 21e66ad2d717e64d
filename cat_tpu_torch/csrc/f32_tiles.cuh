// Building blocks of the port's float32 kernels (ffn_f32.cu,
// relpos_attention_f32.cu, conv_module_f32.cu), which serve the float32
// models (a ConformerNet at its default dtype, the token encoders of
// JSA-SPG and LLM-P2G): a tiled matrix product on the CUDA cores with a
// fused epilogue, LayerNorm row passes, and a column sum in two passes.
// The product here is a full float32 FMA (no TF32, no bf16 rounding); it
// serves the FF forward, the attention and conv module kernels and the FF
// backward at widths TMA cannot take, while the FF backward's products
// otherwise run in 3xTF32 on the tensor cores (hopper_tf32.cuh), whose
// LayerNorm and column-sum passes are these. Every output is summed by
// one thread in one fixed order, without atomics, so two calls on the
// same inputs give the same bits.
#pragma once

#include "common_math.cuh"

namespace catk {
namespace f32 {

// gemm tiles: 64 x 64 outputs a block, 16 deep a stage, 256 threads, each
// thread 4 x 4 outputs strided by 16 rows and 16 columns
constexpr int GM = 64, GN = 64, GK = 16, GTHREADS = 256;
// rows a partial sum of `colsum_partial` covers
constexpr int COL_ROWS = 64;

__host__ __device__ constexpr int cdiv(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Accurate logistic function (expf, not __expf), as torch computes it.
__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.f / (1.f + expf(-x));
}

// The keep factor of the Philox mask at (stream, plane, row, col): 1 /
// (1 - rate) or 0 (common_math.cuh).
__device__ __forceinline__ float keep_at(const Drop& d, uint32_t stream,
                                         uint32_t plane, uint32_t row,
                                         uint32_t col) {
  return keep_scale(d, keep4(d, stream, plane, row, col >> 2), col & 3);
}

// The identity map of B's columns.
struct SameCols {
  __device__ int operator()(int n) const { return n; }
};

// The mainloop of `gemm`: acc[i][j] += op(A)(m, k) · op(B)(k, bcol(n)) for
// m = m0 + ty + 16·i, n = n0 + tx + 16·j (tx = tid & 15, ty = tid >> 4)
// over k in [kb, ke), on 64 x 64 tiles of shared memory, 16 deep a stage.
// op(A)(m, k) = A[m·lda + k], or A[k·lda + m] with TA; op(B)(k, c) =
// B[k·ldb + c], or B[c·ldb + k] with TB. Rows m >= M and columns n >= N
// read zeros. Every block thread must call it.
template <bool TA, bool TB, class BCol>
__device__ __forceinline__ void tile_product(
    const float* __restrict__ A, const float* __restrict__ B, int M, int N,
    int lda, int ldb, int m0, int n0, int kb, int ke, BCol bcol,
    float (&acc)[4][4]) {
  __shared__ float As[GK][GM + 1];
  __shared__ float Bs[GK][GN + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = kb; k0 < ke; k0 += GK) {
#pragma unroll
    for (int l = 0; l < GM * GK / GTHREADS; ++l) {
      const int idx = tid + GTHREADS * l;
      const int m = TA ? idx % GM : idx / GK, k = TA ? idx / GM : idx % GK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = gm < M && gk < ke
                     ? (TA ? A[(size_t)gk * lda + gm] : A[(size_t)gm * lda + gk])
                     : 0.f;
    }
#pragma unroll
    for (int l = 0; l < GN * GK / GTHREADS; ++l) {
      const int idx = tid + GTHREADS * l;
      const int n = TB ? idx / GK : idx % GN, k = TB ? idx % GK : idx / GN;
      const int gn = n0 + n, gk = k0 + k;
      Bs[k][n] = gn < N && gk < ke
                     ? (TB ? B[(size_t)bcol(gn) * ldb + gk]
                           : B[(size_t)gk * ldb + bcol(gn)])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// C (M x N) = op(A) . op(B) over k in the block's split [z·k_split,
// min(K, (z+1)·k_split)), handed to epi(m, n, value, z) for every output
// inside M x N (operands as `tile_product`'s, B's columns unmapped).
// Grid: (cdiv(N, GN), cdiv(M, GM), splits).
template <bool TA, bool TB, class Epi>
__global__ void __launch_bounds__(GTHREADS)
    gemm(const float* __restrict__ A, const float* __restrict__ B, int M,
         int N, int K, int lda, int ldb, int k_split, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  const int kb = blockIdx.z * k_split;
  float acc[4][4] = {};
  tile_product<TA, TB>(A, B, M, N, lda, ldb, m0, n0, kb, min(K, kb + k_split),
                       SameCols{}, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) epi(m, n, acc[i][j], (int)blockIdx.z);
    }
}

template <bool TA, bool TB, class Epi>
cudaError_t launch_gemm(const float* A, const float* B, int M, int N, int K,
                        int lda, int ldb, int splits, Epi epi,
                        cudaStream_t s) {
  const int k_split = cdiv(cdiv(K, splits), GK) * GK;
  const dim3 grid(cdiv(N, GN), cdiv(M, GM), cdiv(K, k_split));
  gemm<TA, TB, Epi><<<grid, GTHREADS, 0, s>>>(A, B, M, N, K, lda, ldb,
                                               k_split, epi);
  return cudaGetLastError();
}

// LayerNorm row passes: one warp a row, eps 1e-6, the variance from a
// second pass over the row (E[(x - mean)^2]).
constexpr int LN_WARPS = 8;
constexpr float LN_EPS = 1e-6f;

// h = LN(x) (one warp a row); with stats, the row's mean and rstd; with
// dh2, dh2 = alpha * drop1(dout) (the FF backward's output gradient).
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_rows(const float* __restrict__ x, const float* __restrict__ g,
            const float* __restrict__ b, int R, int D, float* __restrict__ h,
            float* __restrict__ stats, const float* __restrict__ dout,
            float* __restrict__ dh2, Drop d, float alpha) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const float* xr = x + (size_t)r * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += xr[c];
  const float mean = warp_sum(s) / D;
  float ss = 0.f;
  for (int c = lane; c < D; c += 32) ss += (xr[c] - mean) * (xr[c] - mean);
  const float rstd = rsqrtf(warp_sum(ss) / D + LN_EPS);
  for (int c = lane; c < D; c += 32)
    h[(size_t)r * D + c] = (xr[c] - mean) * rstd * g[c] + b[c];
  if (stats != nullptr && lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
  if (dh2 != nullptr)
    for (int c = lane; c < D; c += 32)
      dh2[(size_t)r * D + c] =
          alpha * dout[(size_t)r * D + c] * keep_at(d, 1, 0, r, c);
}

// The LayerNorm backward of a row (one warp a row): dx = dO + rstd·(dh·g -
// mean(dh·g) - xhat·mean(dh·g·xhat)), dO 0 when dout is null (no residual
// around the LayerNorm), and hx = dh·xhat for dgamma.
__global__ void __launch_bounds__(LN_WARPS * 32)
    ln_backward(const float* __restrict__ x, const float* __restrict__ g,
                const float* __restrict__ stats, const float* __restrict__ dh,
                const float* __restrict__ dout, int R, int D,
                float* __restrict__ dx, float* __restrict__ hx) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (r >= R) return;
  const float mean = stats[2 * r], rstd = stats[2 * r + 1];
  const size_t o = (size_t)r * D;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float xh = (x[o + c] - mean) * rstd, dxh = dh[o + c] * g[c];
    s1 += dxh;
    s2 += dxh * xh;
    hx[o + c] = dh[o + c] * xh;
  }
  const float m1 = warp_sum(s1) / D, m2 = warp_sum(s2) / D;
  for (int c = lane; c < D; c += 32) {
    const float xh = (x[o + c] - mean) * rstd, dxh = dh[o + c] * g[c];
    dx[o + c] = dout != nullptr ? dout[o + c] + rstd * (dxh - m1 - xh * m2)
                                : rstd * (dxh - m1 - xh * m2);
  }
}

// Epilogue: the plain store C[m·N + n] (split z at C + z·M·N).
struct Store {
  float* C;
  int N;
  long long plane;
  __device__ void operator()(int m, int n, float v, int z) const {
    C[z * plane + (size_t)m * N + n] = v;
  }
};

// out[i] = sum over the splits z, in order, of ws[z·count + i].
__global__ void sum_splits(const float* __restrict__ ws, int splits,
                           long long count, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * count + i];
  out[i] = s;
}

// A matrix product whose K (the rows of a batch) is split over `splits`
// slices into the workspace ws (splits·M·N floats), then summed in order
// into C.
template <bool TA, bool TB>
cudaError_t gemm_split_k(const float* A, const float* B, int M, int N, int K,
                         int lda, int ldb, int splits, float* ws, float* C,
                         cudaStream_t s) {
  const int k_split = cdiv(cdiv(K, splits), GK) * GK;
  splits = cdiv(K, k_split);
  const long long count = (long long)M * N;
  cudaError_t err = launch_gemm<TA, TB>(A, B, M, N, K, lda, ldb, splits,
                                        Store{ws, N, count}, s);
  if (err != cudaSuccess) return err;
  sum_splits<<<cdiv(count, 256), 256, 0, s>>>(ws, splits, count, C);
  return cudaGetLastError();
}

// Up to four column sums in one launch pair: out[c] = sum over rows r of
// x[r·C + c] (times y[r·C + c] when y is given), C columns.
struct ColJob {
  const float* x;
  const float* y;
  float* out;
  int C;
};
struct ColJobs {
  ColJob job[4];
};

// Pass 1: the sum of rows [COL_ROWS·blockIdx.y, ...) of column c of job
// blockIdx.z, in row order, into part[z][blockIdx.y][c] (part holds
// cdiv(R, COL_ROWS) x cmax floats a job).
__global__ void colsum_partial(ColJobs jobs, int R, int cmax,
                               float* __restrict__ part) {
  const ColJob jb = jobs.job[blockIdx.z];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= jb.C) return;
  const int r0 = blockIdx.y * COL_ROWS, r1 = min(R, r0 + COL_ROWS);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) {
    const size_t i = (size_t)r * jb.C + c;
    s += jb.y ? jb.x[i] * jb.y[i] : jb.x[i];
  }
  part[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * cmax + c] = s;
}

// Pass 2: out[c] = the partial sums of column c in chunk order.
__global__ void colsum_final(ColJobs jobs, int chunks, int cmax,
                             const float* __restrict__ part) {
  const ColJob jb = jobs.job[blockIdx.z];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= jb.C) return;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k)
    s += part[((size_t)blockIdx.z * chunks + k) * cmax + c];
  jb.out[c] = s;
}

// Floats of the partials `colsum` needs for n jobs over R rows, the widest
// of C columns.
__host__ __device__ inline long long colsum_floats(int n, int R, int cmax) {
  return (long long)n * cdiv(R, COL_ROWS) * cmax;
}

inline cudaError_t colsum(const ColJobs& jobs, int n, int R, float* part,
                   cudaStream_t s) {
  int cmax = 1;
  for (int i = 0; i < n; ++i) cmax = max(cmax, jobs.job[i].C);
  const int chunks = cdiv(R, COL_ROWS);
  if (chunks == 0) return cudaErrorInvalidValue;
  colsum_partial<<<dim3(cdiv(cmax, 256), chunks, n), 256, 0, s>>>(jobs, R,
                                                                  cmax, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  colsum_final<<<dim3(cdiv(cmax, 256), 1, n), 256, 0, s>>>(jobs, chunks, cmax,
                                                          part);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace catk
