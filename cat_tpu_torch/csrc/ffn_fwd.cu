// Fused conformer feed-forward module, forward (eval, no dropout):
//   out = x + alpha * (SiLU(LN(x) . W1 + b1) . W2 + b2)
// x, out (R, D) bf16; W1 (D, F), W2 (F, D) bf16 row-major; gamma, beta,
// b1, b2 f32. LN eps 1e-6, statistics and sums in f32.
//
// One block of 8 warps owns BM = 32 rows. LN(x) goes to shared memory as
// bf16. The hidden layer is walked in chunks of FC = 64 columns: the
// chunk h = SiLU(LN(x) . W1[:, chunk] + b1) lives in shared memory only,
// and h . W2[chunk, :] is added to the (32 x D) f32 accumulator that the
// 8 warps keep in registers (warp w owns columns [w*D/8, (w+1)*D/8)). So
// the (R, F) hidden activation never reaches device memory.
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BM = 32;
constexpr int FC = 64;
constexpr int NWARPS = 8;

template <int D>
struct FfnSmem {
  static constexpr int LDX = D + 8;   // bf16 LN(x) rows
  static constexpr int LDH = FC + 4;  // f32 hidden chunk
  static constexpr int LDHB = FC + 8; // bf16 SiLU(hidden chunk)
  static constexpr int OFF_H = align128(BM * LDX * 2);
  static constexpr int OFF_HB = OFF_H + align128(BM * LDH * 4);
  static constexpr int BYTES = OFF_HB + align128(BM * LDHB * 2);
};

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    ffn_fwd_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, const bf16* __restrict__ w1,
                   const float* __restrict__ b1, const bf16* __restrict__ w2,
                   const float* __restrict__ b2, bf16* __restrict__ out, int R,
                   int F, float alpha) {
  using S = FfnSmem<D>;
  constexpr int NJ = D / (16 * NWARPS);  // 16-wide column tiles per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  float* hs = reinterpret_cast<float*>(smem + S::OFF_H);
  bf16* hb = reinterpret_cast<bf16*>(smem + S::OFF_HB);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * BM;

  for (int r = warp; r < BM; r += NWARPS) {
    const int row = r0 + r;
    layer_norm_row<D>(x + (size_t)row * D, row < R, gamma, beta, 1e-6f,
                      xs + r * S::LDX, lane);
  }
  __syncthreads();

  FragC acc[2][NJ];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j) wmma::fill_fragment(acc[g][j], 0.f);

  const int rg = warp >> 2, cg = warp & 3;  // this warp's tile of the chunk
  const int col0 = warp * (D / NWARPS);
  for (int f0 = 0; f0 < F; f0 += FC) {
    FragC h;
    wmma::fill_fragment(h, 0.f);
    mma_rows16<D>(h, xs + rg * 16 * S::LDX, S::LDX, w1 + f0 + cg * 16, F);
    wmma::store_matrix_sync(hs + rg * 16 * S::LDH + cg * 16, h, S::LDH,
                            wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * FC; i += NWARPS * 32) {
      const int r = i / FC, c = i % FC;
      const float v = hs[r * S::LDH + c] + b1[f0 + c];
      hb[r * S::LDHB + c] = __float2bfloat16(v * sigmoid(v));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FC; kk += 16) {
      FragA a0, a1;
      wmma::load_matrix_sync(a0, hb + kk, S::LDHB);
      wmma::load_matrix_sync(a1, hb + 16 * S::LDHB + kk, S::LDHB);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragB b;
        wmma::load_matrix_sync(b, w2 + (size_t)(f0 + kk) * D + col0 + j * 16,
                               D);
        wmma::mma_sync(acc[0][j], a0, b, acc[0][j]);
        wmma::mma_sync(acc[1][j], a1, b, acc[1][j]);
      }
    }
  }
  __syncthreads();  // the hidden-chunk buffer becomes per-warp scratch

  float* scr = hs + warp * 256;
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      wmma::store_matrix_sync(scr, acc[g][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = r0 + g * 16 + e / 16;
        const int col = col0 + j * 16 + e % 16;
        if (row < R) {
          const size_t o = (size_t)row * D + col;
          out[o] = __float2bfloat16(__bfloat162float(x[o]) +
                                    alpha * (scr[e] + b2[col]));
        }
      }
      __syncwarp();
    }
}

template <int D>
cudaError_t launch(const bf16* x, const float* gamma, const float* beta,
                   const bf16* w1, const float* b1, const bf16* w2,
                   const float* b2, bf16* out, int R, int F, float alpha,
                   cudaStream_t stream) {
  using S = FfnSmem<D>;
  static_assert(BM * S::LDH * 4 >= NWARPS * 256 * 4,
                "the epilogue reuses the hidden-chunk buffer as scratch");
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::BYTES);
  if (err != cudaSuccess) return err;
  const int blocks = (R + BM - 1) / BM;
  ffn_fwd_kernel<D><<<blocks, NWARPS * 32, S::BYTES, stream>>>(
      x, gamma, beta, w1, b1, w2, b2, out, R, F, alpha);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). D must be 128, 256,
// 384 or 512 and F a multiple of 64; the Python wrapper checks both.
extern "C" int ffn_fwd(const void* x, const void* gamma, const void* beta,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, void* out, int R, int D, int F,
                       float alpha, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xb = static_cast<const bf16*>(x);
  auto w1b = static_cast<const bf16*>(w1);
  auto w2b = static_cast<const bf16*>(w2);
  auto g = static_cast<const float*>(gamma);
  auto be = static_cast<const float*>(beta);
  auto b1f = static_cast<const float*>(b1);
  auto b2f = static_cast<const float*>(b2);
  auto o = static_cast<bf16*>(out);
  if (R <= 0) return cudaSuccess;
  if (F % FC != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 128: return launch<128>(xb, g, be, w1b, b1f, w2b, b2f, o, R, F, alpha, s);
    case 256: return launch<256>(xb, g, be, w1b, b1f, w2b, b2f, o, R, F, alpha, s);
    case 384: return launch<384>(xb, g, be, w1b, b1f, w2b, b2f, o, R, F, alpha, s);
    case 512: return launch<512>(xb, g, be, w1b, b1f, w2b, b2f, o, R, F, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}
