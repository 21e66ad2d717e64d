// The conformer convolution module's two fused stages in float32, forward
// and backward: the f32 route of the TPU kernels `_glu_in_fwd_kernel`,
// `_glu_in_bwd_kernel`, `_bn_out_fwd_kernel` and `_bn_out_bwd_kernel` of
// cat_tpu/ops/conv_module_pallas.py (:53, :71, :237, :261; `pallas_call`
// at :130, :158, :330 and :364), which a batch-normalised ConformerNet at
// its default dtype, float32, reaches (cat_tpu/models/encoders.py,
// cat_tpu/models/layers.py `ConvModule`, D a multiple of 128). The TPU
// kernels cast every operand to x.dtype before their products, so at f32
// every product here is a full float32 FMA: no TF32, no bf16 rounding.
//   glu_in: out = mask * GLU(LN(x) . W + b)                    W (D, 2D)
//   bn_out: out = x + mask * drop(SiLU(BN(c)) . W + b)         W (D, D)
// with LN eps 1e-6 and BN(c) = (c - mean) * rsqrt(var + 1e-5) * scale +
// bias over the statistics the caller passes (running or masked batch);
// every tensor f32, row-major; the dropout is the Philox mask of
// common_math.cuh, stream 0 by row and column (the bf16 kernel's mask for
// the same seed; rate 0: no Philox at all). Any D that is a multiple of
// 32.
//
// What bounds them on the H100 at crf-v1's training batch (R = 15,776
// rows, 12,664 valid, D = 512), at 67 TFLOP/s f32 outside the tensor
// cores over the valid rows: glu_in 4·R·D² operations forward (0.198 ms)
// and 12·R·D² backward (0.595 ms); bn_out 2·R·D² forward (0.099 ms) and
// 4·R·D² backward (0.198 ms); their rows (32 MB a tensor) are below that
// at 3.35 TB/s. The design is the simple one, as ffn_f32.cu's: the
// products on `f32::tile_product` (f32_tiles.cuh, 64 x 64 tiles of shared
// memory, 4 x 4 outputs a thread on the CUDA cores), the elementwise work
// in their epilogues, every intermediate through device memory.
//
// glu_in forward, two launches: the LayerNorm row pass to h; the product
// h . W with bias, GLU and mask in its epilogue. The GLU pairs column j
// with column j + D: the product's 64-wide tile t takes the value columns
// 32t .. 32t + 31 and the gate columns D + 32t .. D + 32t + 31, so that a
// thread's outputs j and j + 2 (16·2 columns apart) are a value and its
// gate. Backward, recomputing the forward from x: the row pass (h and its
// statistics); the product again, its epilogue writing dh2 = [du | dg];
// dh = dh2 . W^T; dW = h^T . dh2 with the R rows split into slices whose
// partials are summed in order; the LayerNorm backward to dx and dh·xhat;
// the column sums db, dbeta and dgamma in two passes.
//
// bn_out forward, two launches: the BN + SiLU pass to y; the product
// y . W with bias, dropout, mask and residual in its epilogue. Backward:
// the row pass (y, and dh = drop(dO · mask)); dy = dh . W^T with the SiLU
// and BN backward in its epilogue (dconv = dy0 · scale · rstd, and dy0 and
// dy0 · xn for the column sums); dW = y^T . dh split over rows; the column
// sums db, dbias = sum dy0 and dscale = sum dy0·xn; then d(mean) = -rstd ·
// scale · dbias and d(var) = -scale · rstd² · dscale / 2, which let
// autograd complete the batch statistics' chain outside the kernel, as
// the TPU kernel does. dx of bn_out is dO itself (the residual). No
// atomics: every output is one thread's sum in a fixed order, so two
// calls on the same inputs give the same bits.
#include "f32_tiles.cuh"

namespace {

using namespace catk;
using namespace catk::f32;

constexpr float BN_EPS = 1e-5f;
constexpr int EW_THREADS = 256;

// The GLU product's column map: virtual column v of tile t = v / 64 is
// value column 32t + v % 64 below 32 and gate column D + 32t + v % 64 - 32
// from 32 on.
struct GluCols {
  int D;
  __device__ int operator()(int v) const {
    const int t = v >> 6, c = v & 63;
    return c < 32 ? 32 * t + c : D + 32 * t + c - 32;
  }
};

// h2 = h . W + b (R x 2D), the value u and the gate g of every (row m,
// value column c < D) handed to epi(m, c, u, g). Grid: (D / 32, cdiv(R,
// 64)), 256 threads.
template <class Epi>
__global__ void __launch_bounds__(GTHREADS)
    glu_product(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, int R, int D, Epi epi) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  float acc[4][4] = {};
  tile_product<false, false>(h, w, R, 2 * D, D, 2 * D, m0, n0, 0, D,
                             GluCols{D}, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= R) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 32 * blockIdx.x + tx + 16 * j;
      epi(m, c, acc[i][j] + b[c], acc[i][j + 2] + b[D + c]);
    }
  }
}

// forward: out = mask · u · sigmoid(g)
struct GluFwd {
  const float* mask;
  float* out;
  int D;
  __device__ void operator()(int m, int c, float u, float g) const {
    out[(size_t)m * D + c] = mask[m] * (u * sigmoid_f32(g));
  }
};

// backward: da = dO · mask; dh2 = [da · s | da · u · s · (1 - s)], s =
// sigmoid(g)
struct GluBwd {
  const float* mask;
  const float* dout;
  float* dh2;
  int D;
  __device__ void operator()(int m, int c, float u, float g) const {
    const float s = sigmoid_f32(g);
    const float da = dout[(size_t)m * D + c] * mask[m];
    dh2[(size_t)m * 2 * D + c] = da * s;
    dh2[(size_t)m * 2 * D + D + c] = da * u * s * (1.f - s);
  }
};

// The BN of c at flat index i (column n): xn, y0 = xn·scale + bias and
// rstd.
struct BnIn {
  const float* c;
  const float* mean;
  const float* var;
  const float* scale;
  const float* bias;
  __device__ float y0(size_t i, int n, float& xn, float& rstd) const {
    rstd = rsqrtf(var[n] + BN_EPS);
    xn = (c[i] - mean[n]) * rstd;
    return xn * scale[n] + bias[n];
  }
};

// y = SiLU(BN(c)); with dout, dh = drop(dO · mask) (the backward's row
// pass). R·D elements, one a thread.
__global__ void __launch_bounds__(EW_THREADS)
    bn_rows(BnIn bn, const float* __restrict__ mask, long long count, int D,
            float* __restrict__ y, const float* __restrict__ dout,
            float* __restrict__ dh, Drop d) {
  const long long i = (long long)blockIdx.x * EW_THREADS + threadIdx.x;
  if (i >= count) return;
  const int m = (int)(i / D), n = (int)(i % D);
  float xn, rstd;
  const float y0 = bn.y0(i, n, xn, rstd);
  y[i] = y0 * sigmoid_f32(y0);
  if (dh != nullptr) dh[i] = dout[i] * mask[m] * keep_at(d, 0, 0, m, n);
}

// forward product: out = x + mask · drop(acc + b)
struct BnFwd {
  const float* b;
  const float* x;
  const float* mask;
  float* out;
  int D;
  Drop d;
  __device__ void operator()(int m, int n, float v, int) const {
    const size_t i = (size_t)m * D + n;
    out[i] = x[i] + mask[m] * ((v + b[n]) * keep_at(d, 0, 0, m, n));
  }
};

// backward down: dy0 = acc · SiLU'(y0); dconv = dy0 · scale · rstd; g0 =
// dy0 and g1 = dy0 · xn for the column sums
struct BnDown {
  BnIn bn;
  float* dconv;
  float* g0;
  float* g1;
  int D;
  __device__ void operator()(int m, int n, float v, int) const {
    const size_t i = (size_t)m * D + n;
    float xn, rstd;
    const float y0 = bn.y0(i, n, xn, rstd);
    const float s = sigmoid_f32(y0);
    const float dy0 = v * s * (1.f + y0 * (1.f - s));
    dconv[i] = dy0 * bn.scale[n] * rstd;
    g0[i] = dy0;
    g1[i] = dy0 * xn;
  }
};

// d(mean) and d(var) from dbias = sum dy0 and dscale = sum dy0·xn:
// dxn = dy0·scale, so sum -dxn·rstd = -rstd·scale·dbias and
// sum dxn·(c - mean) · (-rstd³/2) = -scale·rstd²·dscale / 2.
__global__ void bn_stat_grads(const float* __restrict__ var,
                              const float* __restrict__ scale,
                              const float* __restrict__ dbias,
                              const float* __restrict__ dscale, int D,
                              float* __restrict__ dmean,
                              float* __restrict__ dvar) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= D) return;
  const float rstd = rsqrtf(var[n] + BN_EPS);
  dmean[n] = -rstd * scale[n] * dbias[n];
  dvar[n] = -0.5f * scale[n] * rstd * rstd * dscale[n];
}

// The glu_in backward's f32 workspace, in 64-float units: h, dh, hx (R x
// D), dh2 (R x 2D), the row statistics (2R), the weight partials (splits x
// D x 2D) and the column partials.
struct GluCarve {
  float *h, *dh, *hx, *dh2, *stats, *wpart, *cpart;
  long long floats;
};

// The bn_out backward's: y, dh, g0, g1 (R x D), the weight partials
// (splits x D x D) and the column partials.
struct BnCarve {
  float *y, *dh, *g0, *g1, *wpart, *cpart;
  long long floats;
};

struct Taker {
  float* base;
  long long off = 0;
  float* operator()(long long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 63) / 64 * 64;
    return p;
  }
};

GluCarve glu_carve(float* base, int R, int D, int splits) {
  Taker take{base};
  const long long RD = (long long)R * D;
  GluCarve c{};
  c.h = take(RD);
  c.dh = take(RD);
  c.hx = take(RD);
  c.dh2 = take(2 * RD);
  c.stats = take(2LL * R);
  c.wpart = take((long long)splits * D * 2 * D);
  c.cpart = take(colsum_floats(3, R, 2 * D));
  c.floats = take.off;
  return c;
}

BnCarve bn_carve(float* base, int R, int D, int splits) {
  Taker take{base};
  const long long RD = (long long)R * D;
  BnCarve c{};
  c.y = take(RD);
  c.dh = take(RD);
  c.g0 = take(RD);
  c.g1 = take(RD);
  c.wpart = take((long long)splits * D * D);
  c.cpart = take(colsum_floats(3, R, D));
  c.floats = take.off;
  return c;
}

cudaError_t zero(void* const* outs, const size_t* n, int count,
                 cudaStream_t s) {
  for (int i = 0; i < count; ++i) {
    const cudaError_t err = cudaMemsetAsync(outs[i], 0, n[i] * 4, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

#define CATK_TRY(expr)                           \
  do {                                           \
    cudaError_t err_ = (expr);                   \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

}  // namespace

// x, out, h (R, D) f32 (h is scratch), mask (R) f32 0/1; gamma, beta (D),
// w (D, 2D), b (2D) f32. D a multiple of 32. Returns the CUDA error of the
// launches.
extern "C" int glu_in_f32_fwd(const void* x, const void* mask,
                              const void* gamma, const void* beta,
                              const void* w, const void* b, void* out,
                              void* h, int R, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  float* hf = static_cast<float*>(h);
  ln_rows<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), R, D, hf, nullptr, nullptr, nullptr,
      Drop{}, 0.f);
  CATK_TRY(cudaGetLastError());
  glu_product<<<dim3(D / 32, cdiv(R, GM)), GTHREADS, 0, s>>>(
      hf, static_cast<const float*>(w), static_cast<const float*>(b), R, D,
      GluFwd{static_cast<const float*>(mask), static_cast<float*>(out), D});
  return cudaGetLastError();
}

// The workspace `glu_in_f32_bwd` takes, in units of 64 floats.
extern "C" int glu_in_f32_bwd_workspace(int R, int D, int splits, void*) {
  return R <= 0 ? 0 : (int)(glu_carve(nullptr, R, D, splits).floats / 64);
}

// x, dout, dx (R, D) f32; mask, gamma, beta, w, b as glu_in_f32_fwd; the
// gradients dgamma, dbeta (D), dw (D, 2D), db (2D) f32, written whole; ws
// an f32 workspace of `glu_in_f32_bwd_workspace(R, D, splits)` units of 64
// floats; splits: the slices of R that dW is summed over.
extern "C" int glu_in_f32_bwd(const void* x, const void* mask,
                              const void* gamma, const void* beta,
                              const void* w, const void* b, const void* dout,
                              void* dx, void* dgamma, void* dbeta, void* dw,
                              void* db, void* ws, int R, int D, int splits,
                              void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 32 || splits <= 0) return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[4] = {dgamma, dbeta, dw, db};
    const size_t n[4] = {(size_t)D, (size_t)D, (size_t)D * 2 * D,
                         (size_t)2 * D};
    return (int)zero(outs, n, 4, s);
  }
  const GluCarve c = glu_carve(static_cast<float*>(ws), R, D, splits);
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gamma);
  const float* wf = static_cast<const float*>(w);
  ln_rows<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, gf, static_cast<const float*>(beta), R, D, c.h, c.stats, nullptr,
      nullptr, Drop{}, 0.f);
  CATK_TRY(cudaGetLastError());
  glu_product<<<dim3(D / 32, cdiv(R, GM)), GTHREADS, 0, s>>>(
      c.h, wf, static_cast<const float*>(b), R, D,
      GluBwd{static_cast<const float*>(mask), static_cast<const float*>(dout),
             c.dh2, D});
  CATK_TRY(cudaGetLastError());
  // dh = dh2 . W^T; W^T(k, n) = W[n·2D + k]
  CATK_TRY((launch_gemm<false, true>(c.dh2, wf, R, D, 2 * D, 2 * D, 2 * D, 1,
                                     Store{c.dh, D, 0}, s)));
  // dW = h^T . dh2 (D x 2D), K = R
  CATK_TRY((gemm_split_k<true, false>(c.h, c.dh2, D, 2 * D, R, D, 2 * D,
                                      splits, c.wpart,
                                      static_cast<float*>(dw), s)));
  ln_backward<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, gf, c.stats, c.dh, nullptr, R, D, static_cast<float*>(dx), c.hx);
  CATK_TRY(cudaGetLastError());
  ColJobs jobs{{{c.dh2, nullptr, static_cast<float*>(db), 2 * D},
                {c.dh, nullptr, static_cast<float*>(dbeta), D},
                {c.hx, nullptr, static_cast<float*>(dgamma), D}}};
  return colsum(jobs, 3, R, c.cpart, s);
}

// conv, x, out, y (R, D) f32 (y is scratch); mask (R) f32 0/1; mean, var,
// scale, bias, b (D), w (D, D) f32; seed0, seed1, thr the dropout's seed
// words and keep threshold as uint32 bit patterns (thr 0: no dropout), inv
// = 1 / (1 - rate). Returns the CUDA error of the launches.
extern "C" int bn_out_f32_fwd(const void* conv, const void* x,
                              const void* mask, const void* mean,
                              const void* var, const void* scale,
                              const void* bias, const void* w, const void* b,
                              void* out, void* y, int R, int D, int seed0,
                              int seed1, int thr, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 32) return cudaErrorInvalidValue;
  if (R <= 0) return cudaSuccess;
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  const BnIn bn{static_cast<const float*>(conv),
                static_cast<const float*>(mean),
                static_cast<const float*>(var),
                static_cast<const float*>(scale),
                static_cast<const float*>(bias)};
  const float* mf = static_cast<const float*>(mask);
  float* yf = static_cast<float*>(y);
  const long long count = (long long)R * D;
  bn_rows<<<cdiv(count, EW_THREADS), EW_THREADS, 0, s>>>(
      bn, mf, count, D, yf, nullptr, nullptr, d);
  CATK_TRY(cudaGetLastError());
  return launch_gemm<false, false>(
      yf, static_cast<const float*>(w), R, D, D, D, D, 1,
      BnFwd{static_cast<const float*>(b), static_cast<const float*>(x), mf,
            static_cast<float*>(out), D, d},
      s);
}

// The workspace `bn_out_f32_bwd` takes, in units of 64 floats.
extern "C" int bn_out_f32_bwd_workspace(int R, int D, int splits, void*) {
  return R <= 0 ? 0 : (int)(bn_carve(nullptr, R, D, splits).floats / 64);
}

// conv, mask, mean, var, scale, bias, w as bn_out_f32_fwd; dout, dconv (R,
// D) f32; the gradients dmean, dvar, dscale, dbias (D), dw (D, D), db (D)
// f32, written whole; ws an f32 workspace of `bn_out_f32_bwd_workspace(R,
// D, splits)` units of 64 floats; splits: the slices of R that dW is
// summed over. Dropout as in bn_out_f32_fwd.
extern "C" int bn_out_f32_bwd(const void* conv, const void* mask,
                              const void* mean, const void* var,
                              const void* scale, const void* bias,
                              const void* w, const void* dout, void* dconv,
                              void* dmean, void* dvar, void* dscale,
                              void* dbias, void* dw, void* db, void* ws, int R,
                              int D, int seed0, int seed1, int thr,
                              int splits, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 32 || splits <= 0) return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[6] = {dmean, dvar, dscale, dbias, dw, db};
    const size_t n[6] = {(size_t)D, (size_t)D, (size_t)D, (size_t)D,
                         (size_t)D * D, (size_t)D};
    return (int)zero(outs, n, 6, s);
  }
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  const BnIn bn{static_cast<const float*>(conv),
                static_cast<const float*>(mean),
                static_cast<const float*>(var),
                static_cast<const float*>(scale),
                static_cast<const float*>(bias)};
  const BnCarve c = bn_carve(static_cast<float*>(ws), R, D, splits);
  const long long count = (long long)R * D;
  bn_rows<<<cdiv(count, EW_THREADS), EW_THREADS, 0, s>>>(
      bn, static_cast<const float*>(mask), count, D, c.y,
      static_cast<const float*>(dout), c.dh, d);
  CATK_TRY(cudaGetLastError());
  // dy = dh . W^T; W^T(k, n) = W[n·D + k]
  CATK_TRY((launch_gemm<false, true>(
      c.dh, static_cast<const float*>(w), R, D, D, D, D, 1,
      BnDown{bn, static_cast<float*>(dconv), c.g0, c.g1, D}, s)));
  // dW = y^T . dh (D x D), K = R
  CATK_TRY((gemm_split_k<true, false>(c.y, c.dh, D, D, R, D, D, splits,
                                      c.wpart, static_cast<float*>(dw), s)));
  ColJobs jobs{{{c.dh, nullptr, static_cast<float*>(db), D},
                {c.g0, nullptr, static_cast<float*>(dbias), D},
                {c.g1, nullptr, static_cast<float*>(dscale), D}}};
  CATK_TRY(colsum(jobs, 3, R, c.cpart, s));
  bn_stat_grads<<<cdiv(D, 256), 256, 0, s>>>(
      static_cast<const float*>(var), static_cast<const float*>(scale),
      static_cast<const float*>(dbias), static_cast<const float*>(dscale), D,
      static_cast<float*>(dmean), static_cast<float*>(dvar));
  return cudaGetLastError();
}
