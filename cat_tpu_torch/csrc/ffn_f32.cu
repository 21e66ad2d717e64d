// Fused conformer feed-forward module in float32, forward and backward:
// the f32 route of the TPU kernels `_ff_fwd_kernel` and `_ff_bwd_kernel`
// of cat_tpu/ops/ffn_pallas.py (:76 and :104, `pallas_call` at :203 and
// :238), which the float32 models reach (the token encoders of JSA-SPG
// and LLM-P2G, a ConformerNet at float32). The TPU kernel casts every
// operand to x.dtype before its products, so at f32 every product here
// keeps float32 accuracy: full float32 FMAs, or 3xTF32 on the tensor
// cores (hopper_tf32.cuh); single-pass TF32 and bf16 appear nowhere.
//   out = x + alpha * drop1(drop0(SiLU(LN(x) . W1 + b1)) . W2 + b2)
// x, out (R, D), W1 (D, F), W2 (F, D) row-major, every tensor f32. LN eps
// 1e-6. Dropout stream 0 masks the (R, F) hidden and stream 1 the (R, D)
// output with the Philox mask of common_math.cuh, the bf16 kernels' mask
// for the same seed (rate 0: no Philox at all). No atomics: every output
// is one thread's sum in a fixed order, so two calls give the same bits.
//
// Forward (`ffn_f32_fwd`), on `f32::gemm` (f32_tiles.cuh: 64 x 64 tiles of
// shared memory, 4 x 4 outputs a thread on the CUDA cores), three
// launches: ln (a warp a row) to h; up, h . W1 with bias, SiLU and drop0
// to a1; down, a1 . W2 with bias, drop1, alpha and the residual to out.
// Bound: 4·Rv·D·F operations over the Rv valid rows at 67 TFLOP/s.
//
// Backward, two routes by shape (`ops/ffn.py` `f32_bwd_route`), both
// recomputing the forward from x:
// - `ffn_f32_bwd_tc`, D and F multiples of 4 (every width the port runs):
//   the five products on TMA-fed wgmma in 3xTF32 (hopper_tf32.cuh), 10·Rv·
//   D·F operations at 3 x 10·Rv·D·F / 495 TFLOP/s of TF32 (0.805 ms at
//   crf-v1's width, 12,664 valid rows, D = 512, F = 2048). TF32 wgmma
//   reads both operands K-major, so the operands whose K runs over the R
//   rows are written transposed by the passes that produce them. Launches:
//   1. ln (f32_tiles.cuh `ln_rows`): h, LN statistics, dh2 = alpha·drop1(dO);
//   2. split: hi and lo (TF32) of W1, of W1^T and of W2, and of h^T and
//      dh2^T (D x Rp, Rp = R rounded up to 32), through 32 x 32 tiles;
//   3. up, h . W1 (B = W1^T hi/lo): a1 = SiLU(h1)·k written transposed
//      (a1^T, F x Rp), sp = k·SiLU'(h1);
//   4. da1, dh2 . W2^T (B = W2 hi/lo): dh1 = acc·sp, row-major and
//      transposed (dh1^T);
//   5. dh = dh1 . W1^T (B = W1 hi/lo);
//   6. wgrad, one grid of two products with K = R: dW1^T = dh1^T . h (B =
//      h^T hi/lo) and dW2 = a1^T . dh2 (B = dh2^T hi/lo), R split into
//      slices so that the tiles fill the SMs; unsplit, dW1 is stored
//      transposed from the fragments;
//   7. reduce (only when R is split): the slices summed in order, dW1
//      transposed through shared memory;
//   8. ln_out (`ln_backward`): dx and dh·xhat;
//   9-10. the column sums db2, db1, dbeta, dgamma (`colsum`, two passes).
// - `ffn_f32_bwd`, any D and F: the products on `f32::gemm` (CUDA-core
//   tiles, full f32 FMAs): ln_in, up (a1 and the SiLU-and-drop0 factor),
//   da1, dh, dW2 and dW1 split over row slices and their sums in order,
//   ln_out, column sums (11 launches); 10·Rv·D·F at 67 TFLOP/s.
#include <algorithm>

#include "f32_tiles.cuh"
#include "hopper_tf32.cuh"

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

// ---- the 3xTF32 backward (`ffn_f32_bwd_tc`)

constexpr int TC_STAGES = 3;      // 3 x 64 KB of shared memory
constexpr int TC_MAX_SPLITS = 16;  // slices of R in the wgrad launch

// hi and lo of up to five matrices: in (rows, cols) of leading dimension
// ld_in to hi, lo (rows, cols), or transposed (cols, rows), of leading
// dimension ld_out.
struct SplitJob {
  const float* in;
  float *hi, *lo;
  int rows, cols, ld_in, ld_out, transpose;
};
struct SplitJobs {
  SplitJob job[5];
};

// Job blockIdx.y, its 32 x 32 tiles strided over blockIdx.x; a transposed
// job goes through shared memory, so that reads and writes both run
// along rows.
__global__ void __launch_bounds__(256) tf32_split(SplitJobs jobs) {
  __shared__ float t[32][33];
  const SplitJob j = jobs.job[blockIdx.y];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tc_ = cdiv(j.cols, 32), tiles = cdiv(j.rows, 32) * tc_;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile / tc_ * 32, c0 = tile % tc_ * 32;
    if (!j.transpose) {
      for (int i = ty; i < 32; i += 8) {
        const int r = r0 + i, c = c0 + tx;
        if (r < j.rows && c < j.cols) {
          float h, l;
          tc::split(j.in[(size_t)r * j.ld_in + c], h, l);
          j.hi[(size_t)r * j.ld_out + c] = h;
          j.lo[(size_t)r * j.ld_out + c] = l;
        }
      }
      continue;
    }
    for (int i = ty; i < 32; i += 8) {
      const int r = r0 + i, c = c0 + tx;
      t[i][tx] = r < j.rows && c < j.cols ? j.in[(size_t)r * j.ld_in + c]
                                          : 0.f;
    }
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int c = c0 + i, r = r0 + tx;
      if (c < j.cols && r < j.rows) {
        float h, l;
        tc::split(t[tx][i], h, l);
        j.hi[(size_t)c * j.ld_out + r] = h;
        j.lo[(size_t)c * j.ld_out + r] = l;
      }
    }
    __syncthreads();
  }
}

// Epilogues of `tc_product`: columns n, n + 1 (n even) of row m.
// up: a1 = SiLU(h1)·k to a1^T, sp = k·SiLU'(h1), h1 = acc + b1
struct TcUp {
  const float* b1;
  float *a1t, *sp;
  int Rp, F;
  Drop d;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const unsigned kb = keep4(d, 0, 0, m, n >> 2);
    float spv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float h1 = (j ? v1 : v0) + b1[n + j], sig = sigmoid_f32(h1);
      const float k = keep_scale(d, kb, (n & 3) + j);
      a1t[(size_t)(n + j) * Rp + m] = h1 * sig * k;
      spv[j] = k * sig * (1.f + h1 * (1.f - sig));
    }
    *reinterpret_cast<float2*>(sp + (size_t)m * F + n) =
        make_float2(spv[0], spv[1]);
  }
};

// da1: dh1 = acc · sp, row-major and to dh1^T
struct TcDa1 {
  const float* sp;
  float *dh1, *dh1t;
  int Rp, F;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    const size_t i = (size_t)m * F + n;
    const float2 k = *reinterpret_cast<const float2*>(sp + i);
    const float a = v0 * k.x, b = v1 * k.y;
    *reinterpret_cast<float2*>(dh1 + i) = make_float2(a, b);
    dh1t[(size_t)n * Rp + m] = a;
    dh1t[(size_t)(n + 1) * Rp + m] = b;
  }
};

// dh: the plain store
struct TcStore {
  float* out;
  int N;
  __device__ void operator()(int m, int n, float v0, float v1) const {
    *reinterpret_cast<float2*>(out + (size_t)m * N + n) = make_float2(v0, v1);
  }
};

// C (M x N) = A . B^T over K, A (M, K) from `ma`, B (N, K) as its hi and
// lo planes; tile t at rows 128·(t / nn), columns 128·(t % nn).
template <class Epi>
__global__ void __launch_bounds__(hg::THREADS, 1)
    tc_product(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mbh,
               const __grid_constant__ CUtensorMap mbl, int M, int N, int K,
               Epi epi) {
  const int nn = hg::cdiv(N, tc::BN);
  const CUtensorMap *pa = &ma, *ph = &mbh, *pl = &mbl;
  tc::run<TC_STAGES>(
      hg::cdiv(M, tc::ROWS) * nn,
      [=](int t) {
        return hg::Tile{t / nn * tc::ROWS, t % nn * tc::BN,
                        hg::cdiv(K, tc::BK), 0, 0};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        tc::load3(dst, bar, pa, ph, pl, tl.m0, tl.n0, kb * tc::BK);
      },
      [=](const hg::Tile& tl, float (&acc)[64], int wg) {
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int m = tl.m0 + 64 * wg + hg::frag_row(r);
          const int n = tl.n0 + hg::frag_col(r);
          if (m < M && n < N) epi(m, n, acc[r], acc[r + 1]);
        }
      });
}

// wgrad: tile t is split t / tiles of R (`per` stages of BK rows each) of
// output tile b = t % tiles: b < t1 a tile of dW1^T = dh1^T . h (F x D),
// the others one of dW2 = a1^T . dh2 (F x D). Split s writes its partial
// to ws + s·2·D·F (+ D·F for dW2); unsplit, the tiles go to dw1
// (transposed) and dw2.
__global__ void __launch_bounds__(hg::THREADS, 1)
    tc_wgrad(const __grid_constant__ CUtensorMap md1t,
             const __grid_constant__ CUtensorMap mhth,
             const __grid_constant__ CUtensorMap mhtl,
             const __grid_constant__ CUtensorMap ma1t,
             const __grid_constant__ CUtensorMap md2th,
             const __grid_constant__ CUtensorMap md2tl,
             float* __restrict__ dw1, float* __restrict__ dw2,
             float* __restrict__ ws, int R, int D, int F, int splits,
             int per) {
  const int nt = hg::cdiv(D, tc::BN);
  const int t1 = hg::cdiv(F, tc::ROWS) * nt, tiles = 2 * t1;
  const int kbs = hg::cdiv(R, tc::BK);
  const CUtensorMap *pd1t = &md1t, *phth = &mhth, *phtl = &mhtl,
                    *pa1t = &ma1t, *pd2th = &md2th, *pd2tl = &md2tl;
  tc::run<TC_STAGES>(
      tiles * splits,
      [=](int t) {
        const int b = t % tiles, sp = t / tiles;
        const int which = b >= t1, bb = which ? b - t1 : b;
        return hg::Tile{bb / nt * tc::ROWS, bb % nt * tc::BN,
                        min(per, kbs - sp * per), sp * per, which};
      },
      [=](const hg::Tile& tl, int kb, uint32_t dst, uint32_t bar) {
        const int k = (tl.k0 + kb) * tc::BK;
        if (tl.which)
          tc::load3(dst, bar, pa1t, pd2th, pd2tl, tl.m0, tl.n0, k);
        else
          tc::load3(dst, bar, pd1t, phth, phtl, tl.m0, tl.n0, k);
      },
      [=](const hg::Tile& tl, float (&acc)[64], int wg) {
        const size_t DF = (size_t)D * F;
        float* part = ws + (size_t)(tl.k0 / per) * 2 * DF + tl.which * DF;
#pragma unroll
        for (int r = 0; r < 64; r += 2) {
          const int f = tl.m0 + 64 * wg + hg::frag_row(r);
          const int d = tl.n0 + hg::frag_col(r);
          if (f >= F || d >= D) continue;
          const size_t i = (size_t)f * D + d;
          if (splits > 1) {
            *reinterpret_cast<float2*>(part + i) =
                make_float2(acc[r], acc[r + 1]);
          } else if (tl.which) {
            *reinterpret_cast<float2*>(dw2 + i) =
                make_float2(acc[r], acc[r + 1]);
          } else {
            dw1[(size_t)d * F + f] = acc[r];
            dw1[(size_t)(d + 1) * F + f] = acc[r + 1];
          }
        }
      });
}

// The weight partials of `splits` slices summed in slice order: blockIdx.y
// 0 into dW1 (the partials are dW1^T, transposed through shared memory),
// 1 into dW2; 32 x 32 tiles of the (F, D) partials strided over blockIdx.x.
__global__ void __launch_bounds__(256)
    tc_reduce(const float* __restrict__ ws, int splits,
              float* __restrict__ dw1, float* __restrict__ dw2, int D,
              int F) {
  __shared__ float t[32][33];
  const size_t DF = (size_t)D * F;
  const int which = blockIdx.y, tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int tcols = cdiv(D, 32), tiles = cdiv(F, 32) * tcols;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int f0 = tile / tcols * 32, d0 = tile % tcols * 32;
    for (int i = ty; i < 32; i += 8) {
      const int f = f0 + i, d = d0 + tx;
      float s = 0.f;
      if (f < F && d < D)
        for (int sp = 0; sp < splits; ++sp)
          s += ws[sp * 2 * DF + which * DF + (size_t)f * D + d];
      if (which) {
        if (f < F && d < D) dw2[(size_t)f * D + d] = s;
      } else {
        t[i][tx] = s;
      }
    }
    if (which) continue;
    __syncthreads();
    for (int i = ty; i < 32; i += 8) {
      const int d = d0 + i, f = f0 + tx;
      if (d < D && f < F) dw1[(size_t)d * F + f] = t[tx][i];
    }
    __syncthreads();
  }
}

// Slices of R in the wgrad launch: as many as fill the SMs once with the
// 2·ceil(F/128)·ceil(D/128) tiles, at most TC_MAX_SPLITS, none empty.
int tc_splits(int R, int D, int F) {
  const int tiles = 2 * hg::cdiv(F, tc::ROWS) * hg::cdiv(D, tc::BN);
  const int kbs = hg::cdiv(R, tc::BK);
  const int s =
      std::max(1, std::min(std::min(TC_MAX_SPLITS, hg::SMS / tiles), kbs));
  return hg::cdiv(kbs, hg::cdiv(kbs, s));
}

// The 3xTF32 backward's f32 workspace: h, dh2, dh, hx (R x D); the hi and
// lo planes of h^T, dh2^T (D x Rp), of W1^T, W2 (F x D) and of W1 (D x
// F); sp, dh1 (R x F); a1^T, dh1^T (F x Rp); the LN statistics; the
// weight partials of the wgrad slices; the column partials.
struct TcWork {
  float *h, *dh2, *dh, *hx, *hth, *htl, *d2th, *d2tl, *w1th, *w1tl, *w2h,
      *w2l, *w1h, *w1l, *sp, *dh1, *a1t, *dh1t, *stats, *wpart, *cpart;
  int Rp, splits;
  long long floats;
};

TcWork tc_carve(float* base, int R, int D, int F) {
  TcWork w{};
  long long off = 0;
  auto take = [&](long long n) {
    float* p = base ? base + off : nullptr;
    off += (n + 63) / 64 * 64;
    return p;
  };
  w.Rp = (R + 31) / 32 * 32;
  w.splits = tc_splits(R, D, F);
  const long long RD = (long long)R * D, RF = (long long)R * F;
  const long long DRp = (long long)D * w.Rp, FRp = (long long)F * w.Rp;
  const long long DF = (long long)D * F;
  for (float** p : {&w.h, &w.dh2, &w.dh, &w.hx}) *p = take(RD);
  for (float** p : {&w.hth, &w.htl, &w.d2th, &w.d2tl}) *p = take(DRp);
  for (float** p : {&w.w1th, &w.w1tl, &w.w2h, &w.w2l, &w.w1h, &w.w1l})
    *p = take(DF);
  w.sp = take(RF);
  w.dh1 = take(RF);
  w.a1t = take(FRp);
  w.dh1t = take(FRp);
  w.stats = take(2LL * R);
  w.wpart = take(w.splits > 1 ? 2LL * w.splits * DF : 0);
  w.cpart = take(colsum_floats(4, R, D > F ? D : F));
  w.floats = off;
  return w;
}

template <class Epi>
cudaError_t tc_launch(const CUtensorMap& a, const CUtensorMap& bh,
                      const CUtensorMap& bl, int M, int N, int K, Epi epi,
                      cudaStream_t s) {
  constexpr int smem = tc::smem_bytes(TC_STAGES);
  CATK_TRY(hg::prepare(tc_product<Epi>, smem, false));
  tc_product<Epi><<<hg::grid_for(hg::cdiv(M, tc::ROWS) *
                                 hg::cdiv(N, tc::BN)),
                    hg::THREADS, smem, s>>>(a, bh, bl, M, N, K, epi);
  return cudaGetLastError();
}

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

// The workspace `ffn_f32_bwd_tc` takes, in units of 64 floats.
extern "C" int ffn_f32_bwd_tc_workspace(int R, int D, int F, void*) {
  return R <= 0 ? 0 : (int)(tc_carve(nullptr, R, D, F).floats / 64);
}

// The 3xTF32 backward: arguments as `ffn_f32_bwd`'s, but ws an f32
// workspace of ws_units units of 64 floats (`ffn_f32_bwd_tc_workspace`)
// and the row slices of the weight gradients chosen here (`tc_splits`).
// D and F must be multiples of 4 (TMA's 16-byte row strides).
extern "C" int ffn_f32_bwd_tc(const void* x, const void* gamma,
                              const void* beta, const void* w1,
                              const void* b1, const void* w2,
                              const void* dout, void* dx, void* dgamma,
                              void* dbeta, void* dw1, void* db1, void* dw2,
                              void* db2, void* ws, int R, int D, int F,
                              int seed0, int seed1, int thr, int ws_units,
                              float alpha, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || F <= 0 || D % 4 || F % 4) return cudaErrorInvalidValue;
  if (R <= 0) {  // no rows: every gradient is zero
    void* outs[6] = {dgamma, dbeta, dw1, db1, dw2, db2};
    const size_t n[6] = {(size_t)D, (size_t)D, (size_t)D * F, (size_t)F,
                         (size_t)D * F, (size_t)D};
    for (int i = 0; i < 6; ++i)
      CATK_TRY(cudaMemsetAsync(outs[i], 0, n[i] * 4, s));
    return cudaSuccess;
  }
  const TcWork w = tc_carve(static_cast<float*>(ws), R, D, F);
  if (w.floats > (long long)ws_units * 64) return cudaErrorInvalidValue;
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(gamma);
  const float* w1f = static_cast<const float*>(w1);
  const float* dof = static_cast<const float*>(dout);
  const int Rp = w.Rp;

  ln_rows<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, gf, static_cast<const float*>(beta), R, D, w.h, w.stats, dof, w.dh2,
      d, alpha);
  CATK_TRY(cudaGetLastError());
  const SplitJobs jobs{{{w1f, w.w1h, w.w1l, D, F, F, F, 0},
                        {w1f, w.w1th, w.w1tl, D, F, F, D, 1},
                        {static_cast<const float*>(w2), w.w2h, w.w2l, F, D, D,
                         D, 0},
                        {w.h, w.hth, w.htl, R, D, D, Rp, 1},
                        {w.dh2, w.d2th, w.d2tl, R, D, D, Rp, 1}}};
  const int split_tiles = std::max(cdiv(D, 32) * cdiv(F, 32),
                                   cdiv(R, 32) * cdiv(D, 32));
  tf32_split<<<dim3(std::min(split_tiles, 8 * hg::SMS), 5), 256, 0, s>>>(
      jobs);
  CATK_TRY(cudaGetLastError());

  // boxes of 128 rows x 32 columns
  CUtensorMap mh, md2, md1, mw1th, mw1tl, mw2h, mw2l, mw1h, mw1l, md1t, ma1t,
      mhth, mhtl, md2th, md2tl;
  CATK_TRY(tc::tensor_map(&mh, w.h, R, D, D));
  CATK_TRY(tc::tensor_map(&md2, w.dh2, R, D, D));
  CATK_TRY(tc::tensor_map(&md1, w.dh1, R, F, F));
  CATK_TRY(tc::tensor_map(&mw1th, w.w1th, F, D, D));
  CATK_TRY(tc::tensor_map(&mw1tl, w.w1tl, F, D, D));
  CATK_TRY(tc::tensor_map(&mw2h, w.w2h, F, D, D));
  CATK_TRY(tc::tensor_map(&mw2l, w.w2l, F, D, D));
  CATK_TRY(tc::tensor_map(&mw1h, w.w1h, D, F, F));
  CATK_TRY(tc::tensor_map(&mw1l, w.w1l, D, F, F));
  CATK_TRY(tc::tensor_map(&md1t, w.dh1t, F, R, Rp));
  CATK_TRY(tc::tensor_map(&ma1t, w.a1t, F, R, Rp));
  CATK_TRY(tc::tensor_map(&mhth, w.hth, D, R, Rp));
  CATK_TRY(tc::tensor_map(&mhtl, w.htl, D, R, Rp));
  CATK_TRY(tc::tensor_map(&md2th, w.d2th, D, R, Rp));
  CATK_TRY(tc::tensor_map(&md2tl, w.d2tl, D, R, Rp));

  // up: h . W1 -> a1^T, sp; da1: dh2 . W2^T -> dh1, dh1^T; dh = dh1 . W1^T
  CATK_TRY(tc_launch(mh, mw1th, mw1tl, R, F, D,
                     TcUp{static_cast<const float*>(b1), w.a1t, w.sp, Rp, F,
                          d},
                     s));
  CATK_TRY(tc_launch(md2, mw2h, mw2l, R, F, D,
                     TcDa1{w.sp, w.dh1, w.dh1t, Rp, F}, s));
  CATK_TRY(tc_launch(md1, mw1h, mw1l, R, D, F, TcStore{w.dh, D}, s));

  // wgrad: dW1^T = dh1^T . h, dW2 = a1^T . dh2, K = R in w.splits slices
  const int splits = w.splits;
  const int per = hg::cdiv(hg::cdiv(R, tc::BK), splits);
  const int wtiles = 2 * hg::cdiv(F, tc::ROWS) * hg::cdiv(D, tc::BN) * splits;
  constexpr int smem = tc::smem_bytes(TC_STAGES);
  CATK_TRY(hg::prepare(tc_wgrad, smem, false));
  tc_wgrad<<<hg::grid_for(wtiles), hg::THREADS, smem, s>>>(
      md1t, mhth, mhtl, ma1t, md2th, md2tl, static_cast<float*>(dw1),
      static_cast<float*>(dw2), w.wpart, R, D, F, splits, per);
  CATK_TRY(cudaGetLastError());
  if (splits > 1) {
    tc_reduce<<<dim3(std::min(cdiv(D, 32) * cdiv(F, 32), 4 * hg::SMS), 2),
                256, 0, s>>>(w.wpart, splits, static_cast<float*>(dw1),
                        static_cast<float*>(dw2), D, F);
    CATK_TRY(cudaGetLastError());
  }

  ln_backward<<<cdiv(R, LN_WARPS), LN_WARPS * 32, 0, s>>>(
      xf, gf, w.stats, w.dh, dof, R, D, static_cast<float*>(dx), w.hx);
  CATK_TRY(cudaGetLastError());
  ColJobs cols{{{w.dh2, nullptr, static_cast<float*>(db2), D},
                {w.dh1, nullptr, static_cast<float*>(db1), F},
                {w.dh, nullptr, static_cast<float*>(dbeta), D},
                {w.hx, nullptr, static_cast<float*>(dgamma), D}}};
  return colsum(cols, 4, R, w.cpart, s);
}
