// Fused conformer feed-forward module in float32, forward and backward:
// the f32 route of the TPU kernels `_ff_fwd_kernel` and `_ff_bwd_kernel`
// of cat_tpu/ops/ffn_pallas.py (:76 and :104, `pallas_call` at :203 and
// :238), which the float32 token encoders of JSA-SPG (`EmbeddingEncoder`,
// cat_tpu/models/encoders.py, D = 256, F = 1024) reach. The TPU kernel
// casts every operand to x.dtype before its products, so at f32 every
// product here is a full float32 FMA: no TF32, no bf16 rounding.
//   out = x + alpha * drop1(drop0(SiLU(LN(x) . W1 + b1)) . W2 + b2)
// x, out (R, D), W1 (D, F), W2 (F, D) row-major, every tensor f32. LN eps
// 1e-6. Dropout stream 0 masks the (R, F) hidden and stream 1 the (R, D)
// output with the Philox mask of common_math.cuh, the bf16 kernels' mask
// for the same seed (rate 0: no Philox at all).
//
// What bounds it on the H100: 4·Rv·D·F operations forward and 10·Rv·D·F
// backward over the Rv valid rows, at 67 TFLOP/s f32 outside the tensor
// cores (jsa-spg's P2G step, 16 x 256 rows of which Rv = 3136 are valid,
// lengths 256, 248, ..., 136; D = 256, F = 1024: 3.3 GFLOP, 0.049 ms
// forward; 0.123 ms backward); its inputs and outputs are a few MB, far
// below. The kernels run every row, padding included. The
// design is the simple one: the products on `f32::gemm` (f32_tiles.cuh,
// 64 x 64 tiles of shared memory, 4 x 4 outputs a thread on the CUDA
// cores), the elementwise work in their epilogues, the (R, F) hidden
// through device memory. Forward, three launches: ln (a warp a row) to h;
// up, h . W1 with bias, SiLU and drop0 to a1; down, a1 . W2 with bias,
// drop1, alpha and the residual to out. Backward, recomputing the forward
// from x: ln_in (LN statistics, h and dh2 = alpha·drop1(dO)); up (h . W1:
// a1 and the SiLU-and-drop0 derivative factor); da1 (dh1 = dh2 . W2^T
// times that factor); dh = dh1 . W1^T; dW2 = a1^T . dh2 and dW1 =
// h^T . dh1 with the R rows split into slices whose partials are summed in
// order; ln_out (the LayerNorm backward to dx and dh·xhat); the column
// sums db2, db1, dbeta and dgamma in two passes. No atomics: every output
// is one thread's sum in a fixed order, so two calls give the same bits.
#include "f32_tiles.cuh"

namespace {

using namespace catk;
using namespace catk::f32;

// forward up: a1 = drop0(SiLU(acc + b1))
struct UpFwd {
  const float* b1;
  float* a1;
  int F;
  Drop d;
  __device__ void operator()(int m, int n, float v, int) const {
    const float h1 = v + b1[n];
    a1[(size_t)m * F + n] = h1 / (1.f + expf(-h1)) * keep_at(d, 0, 0, m, n);
  }
};

// forward down: out = x + alpha · drop1(acc + b2)
struct DownFwd {
  const float* b2;
  const float* x;
  float* out;
  int D;
  Drop d;
  float alpha;
  __device__ void operator()(int m, int n, float v, int) const {
    const size_t i = (size_t)m * D + n;
    out[i] = x[i] + alpha * ((v + b2[n]) * keep_at(d, 1, 0, m, n));
  }
};

// backward up: a1 = SiLU(h1)·k and sp = k·SiLU'(h1), h1 = acc + b1
struct UpBwd {
  const float* b1;
  float* a1;
  float* sp;
  int F;
  Drop d;
  __device__ void operator()(int m, int n, float v, int) const {
    const float h1 = v + b1[n], sig = sigmoid_f32(h1);
    const float k = keep_at(d, 0, 0, m, n);
    const size_t i = (size_t)m * F + n;
    a1[i] = h1 * sig * k;
    sp[i] = k * sig * (1.f + h1 * (1.f - sig));
  }
};

// backward da1: dh1 = acc · sp
struct Da1 {
  const float* sp;
  float* dh1;
  int F;
  __device__ void operator()(int m, int n, float v, int) const {
    const size_t i = (size_t)m * F + n;
    dh1[i] = v * sp[i];
  }
};

// The backward's f32 workspace, in 64-float units: h, dh2, dh, hx (R x D),
// a1, sp, dh1 (R x F), the row statistics (2R), the weight partials
// (splits x D x F) and the column partials.
struct Carve {
  float *h, *dh2, *dh, *hx, *a1, *sp, *dh1, *stats, *wpart, *cpart;
  long long floats;
};

Carve carve(float* base, int R, int D, int F, int splits) {
  Carve c{};
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 63) / 64 * 64;
    return p;
  };
  const long long RD = (long long)R * D, RF = (long long)R * F;
  c.h = take(RD);
  c.dh2 = take(RD);
  c.dh = take(RD);
  c.hx = take(RD);
  c.a1 = take(RF);
  c.sp = take(RF);
  c.dh1 = take(RF);
  c.stats = take(2LL * R);
  c.wpart = take((long long)splits * D * F);
  c.cpart = take(colsum_floats(4, R, D > F ? D : F));
  c.floats = off;
  return c;
}

#define CATK_TRY(expr)                           \
  do {                                           \
    cudaError_t err_ = (expr);                   \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

}  // namespace

// x, out, h (R, D) and a1 (R, F) f32 (h and a1 are scratch); w1 (D, F),
// w2 (F, D), gamma, beta, b1, b2 f32; seed0, seed1, thr the dropout's seed
// words and keep threshold as uint32 bit patterns (thr 0: no dropout), inv
// = 1 / (1 - rate). Returns the CUDA error of the launches.
extern "C" int ffn_f32_fwd(const void* x, const void* gamma,
                           const void* beta, const void* w1, const void* b1,
                           const void* w2, const void* b2, void* out, void* h,
                           void* a1, int R, int D, int F, int seed0,
                           int seed1, int thr, float alpha, float inv,
                           void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (R <= 0) return cudaSuccess;
  if (D <= 0 || F <= 0) return cudaErrorInvalidValue;
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  const float* xf = static_cast<const float*>(x);
  float* hf = static_cast<float*>(h);
  float* a1f = static_cast<float*>(a1);
  ln_rows<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, static_cast<const float*>(gamma), static_cast<const float*>(beta),
      R, D, hf, nullptr, nullptr, nullptr, d, alpha);
  CATK_TRY(cudaGetLastError());
  CATK_TRY((launch_gemm<false, false>(
      hf, static_cast<const float*>(w1), R, F, D, D, F, 1,
      UpFwd{static_cast<const float*>(b1), a1f, F, d}, s)));
  return launch_gemm<false, false>(
      a1f, static_cast<const float*>(w2), R, D, F, F, D, 1,
      DownFwd{static_cast<const float*>(b2), xf, static_cast<float*>(out), D,
              d, alpha},
      s);
}

// The workspace `ffn_f32_bwd` takes, in units of 64 floats.
extern "C" int ffn_f32_bwd_workspace(int R, int D, int F, int splits, void*) {
  return R <= 0 ? 0 : (int)(carve(nullptr, R, D, F, splits).floats / 64);
}

// x, dout, dx (R, D) f32; w1 (D, F), w2 (F, D), gamma, beta, b1 f32; the
// gradients dgamma, dbeta (D), dw1 (D, F), db1 (F), dw2 (F, D), db2 (D)
// f32, written whole; ws an f32 workspace of `ffn_f32_bwd_workspace(R, D,
// F, splits)` units of 64 floats; splits: the slices of R that the weight
// gradients are summed over. Dropout as in ffn_f32_fwd.
extern "C" int ffn_f32_bwd(const void* x, const void* gamma,
                           const void* beta, const void* w1, const void* b1,
                           const void* w2, const void* dout, void* dx,
                           void* dgamma, void* dbeta, void* dw1, void* db1,
                           void* dw2, void* db2, void* ws, int R, int D, int F,
                           int seed0, int seed1, int thr, int splits,
                           float alpha, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || F <= 0 || splits <= 0) return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[6] = {dgamma, dbeta, dw1, db1, dw2, db2};
    const size_t n[6] = {(size_t)D, (size_t)D, (size_t)D * F, (size_t)F,
                         (size_t)D * F, (size_t)D};
    for (int i = 0; i < 6; ++i)
      CATK_TRY(cudaMemsetAsync(outs[i], 0, n[i] * 4, s));
    return cudaSuccess;
  }
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  const Carve w = carve(static_cast<float*>(ws), R, D, F, splits);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gamma);
  const float* w1f = static_cast<const float*>(w1);
  const float* w2f = static_cast<const float*>(w2);
  const float* dof = static_cast<const float*>(dout);
  ln_rows<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, gf, static_cast<const float*>(beta), R, D, w.h, w.stats, dof, w.dh2,
      d, alpha);
  CATK_TRY(cudaGetLastError());
  // up: h1 = h . W1 + b1 -> a1, sp
  CATK_TRY((launch_gemm<false, false>(
      w.h, w1f, R, F, D, D, F, 1,
      UpBwd{static_cast<const float*>(b1), w.a1, w.sp, F, d}, s)));
  // da1: dh1 = (dh2 . W2^T) · sp; W2^T(k, n) = W2[n·D + k]
  CATK_TRY((launch_gemm<false, true>(w.dh2, w2f, R, F, D, D, D, 1,
                                     Da1{w.sp, w.dh1, F}, s)));
  // dh = dh1 . W1^T; W1^T(k, n) = W1[n·F + k]
  CATK_TRY((launch_gemm<false, true>(w.dh1, w1f, R, D, F, F, F, 1,
                                     Store{w.dh, D, 0}, s)));
  // dW2 = a1^T . dh2 (F x D), dW1 = h^T . dh1 (D x F), K = R
  CATK_TRY((gemm_split_k<true, false>(w.a1, w.dh2, F, D, R, F, D, splits,
                                      w.wpart, static_cast<float*>(dw2), s)));
  CATK_TRY((gemm_split_k<true, false>(w.h, w.dh1, D, F, R, D, F, splits,
                                      w.wpart, static_cast<float*>(dw1), s)));
  ln_backward<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, gf, w.stats, w.dh, dof, R, D, static_cast<float*>(dx), w.hx);
  CATK_TRY(cudaGetLastError());
  ColJobs jobs{{{w.dh2, nullptr, static_cast<float*>(db2), D},
                {w.dh1, nullptr, static_cast<float*>(db1), F},
                {w.dh, nullptr, static_cast<float*>(dbeta), D},
                {w.hx, nullptr, static_cast<float*>(dgamma), D}}};
  return colsum(jobs, 4, R, w.cpart, s);
}
