// Relative-position (Transformer-XL) attention in float32, forward and
// backward: the f32 route of the TPU's rel-pos flash attention kernels of
// cat_tpu/ops/attention_pallas.py (`_fwd_kernel_packed` and its backward,
// `pallas_call` at :736 and :783, and the variants that compute the same
// function), which the float32 token encoders of JSA-SPG
// (`EmbeddingEncoder`) reach: D = 256 with 4 heads in egs/jsa-spg, D = 16
// with 2 heads (Dh = 8) in egs/template/exp/asr-jsa. The TPU kernels take
// the operands in the input's dtype, so at f32 every product here is a full
// float32 FMA: no TF32, no bf16 rounding.
//   s[t, s'] = ((q[t] + u)·k[s'] + (q[t] + v)·p[T-1-t+s']) · scale,
//   keys s' >= len masked; out[t] = sum_s' drop(softmax(s)[t, s']) v[s'],
//   the normaliser over the undropped probabilities; lse[t] its log-sum-exp
// q, k, v, out (N, T, H, Dh), p (2T-1, H, Dh), u, v (H, Dh), lse (N, H, T),
// all f32; query rows at or past the length are zeros in out and lse.
// Dropout: the Philox mask of common_math.cuh at (stream 0, plane n·H + h,
// row t, column s'), the bf16 kernels' mask for the same seed.
//
// What bounds it on the H100: per utterance of length L and head, 6·L²·Dh
// operations forward (three L x L x Dh products) and 16·L²·Dh backward
// (the two score products recomputed, six more), at 67 TFLOP/s f32
// outside the tensor cores (jsa-spg's P2G step, N = 16, T = 256, lengths
// 256, 248, ..., 136, H = 4, Dh = 64: 0.98 GFLOP, 0.0146 ms forward;
// 0.0389 ms backward); the bytes of q,
// k, v, p and out are a few MB, below that. The design is the simple one,
// for head dimensions 8, 16, 32, 64 and 128 (a template each): blocks of
// 256 threads over 32 queries, one head and one utterance, CUDA-core FMAs
// on tiles in shared memory (rows padded by one float against bank
// conflicts). The forward walks the key tiles of 32 up to the utterance's
// length with an online softmax: a thread holds one query row's four keys
// (one Philox draw), the row's eight threads exchange maxima, sums and
// probabilities by shuffles, and the position scores of a tile pair read
// the 63 rows of p its relative positions cover. The backward is four
// stages in one C call: a query-major pass that recomputes the scores from
// lse, writes dq and, as f32 planes (N, H, T, T) in a workspace, dS and the
// dropped probabilities; a key-major pass over those planes for dK and dV;
// a pass over the rows of p for dp (utterances and queries summed in
// order); and the column sums of dq's two parts for du and dv_bias. No
// atomics: every output is one thread's sum in a fixed order, so two calls
// give the same bits.
#include "f32_tiles.cuh"

namespace {

using namespace catk;
using namespace catk::f32;

constexpr int BQ = 32, BK = 32, NT = 256;
constexpr int WIN = BQ + BK - 1;  // table rows a (query tile, key tile) reads
constexpr float NEG = -1e30f;

struct Args {
  const float *q, *k, *v, *p, *ub, *vb;
  const int* len;
  int N, T, H;
  float scale;
  Drop d;
};

// Rows row0 .. row0 + rows - 1 of head h of utterance n of x (N, T, H, DH)
// into dst (rows x DH + 1), plus add (H, DH) when given; zeros past T.
template <int DH>
__device__ void load_rows(float* dst, const float* __restrict__ x,
                          const float* __restrict__ add, int n, int row0,
                          int rows, int T, int H, int h) {
  for (int i = threadIdx.x; i < rows * DH; i += NT) {
    const int r = i / DH, c = i % DH, t = row0 + r;
    float val = 0.f;
    if (t < T) {
      val = x[(((size_t)n * T + t) * H + h) * DH + c];
      if (add != nullptr) val += add[h * DH + c];
    }
    dst[r * (DH + 1) + c] = val;
  }
}

// Table rows base .. base + WIN - 1 of head h of p (2T-1, H, DH) into dst;
// zeros outside the table.
template <int DH>
__device__ void load_window(float* dst, const float* __restrict__ p, int base,
                            int T, int H, int h) {
  for (int i = threadIdx.x; i < WIN * DH; i += NT) {
    const int j = i / DH, c = i % DH, m = base + j;
    dst[j * (DH + 1) + c] =
        m >= 0 && m < 2 * T - 1 ? p[((size_t)m * H + h) * DH + c] : 0.f;
  }
}

// The scaled scores of query row r against keys 4cg .. 4cg + 3 of the
// tile, keys at or past L (s0 the tile's first) set to NEG.
template <int DH>
__device__ void scores(const float* Qu, const float* Qv, const float* Ks,
                       const float* Pw, int r, int cg, int s0, int L,
                       float scale, float (&sc)[4]) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = 4 * cg + i;
    const float* kr = Ks + c * LD;
    const float* pr = Pw + (BQ - 1 - r + c) * LD;
    float ac = 0.f, bd = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      ac = fmaf(Qu[r * LD + d], kr[d], ac);
      bd = fmaf(Qv[r * LD + d], pr[d], bd);
    }
    sc[i] = s0 + c < L ? (ac + bd) * scale : NEG;
  }
}

// a sum or maximum over the eight threads of a query row
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Grid (cdiv(T, BQ), H, N). Thread (r = tid / 8, cg = tid % 8): query row
// t0 + r, keys 4cg .. 4cg + 3 of each key tile, output columns cg + 8j.
template <int DH>
__global__ void __launch_bounds__(NT)
    fwd_kernel(Args a, float* __restrict__ out, float* __restrict__ lse) {
  constexpr int LD = DH + 1, J = DH / 8;
  extern __shared__ float sm[];
  float* Qu = sm;
  float* Qv = Qu + BQ * LD;
  float* Ks = Qv + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Pw = Vs + BK * LD;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int T = a.T, H = a.H, L = a.len[n];
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7, lane = tid & 31;
  const int t = t0 + r;
  float acc[J] = {};
  float m_run = -__int_as_float(0x7f800000), l_run = 0.f;
  if (t0 < L) {
    load_rows<DH>(Qu, a.q, a.ub, n, t0, BQ, T, H, h);
    load_rows<DH>(Qv, a.q, a.vb, n, t0, BQ, T, H, h);
    for (int s0 = 0; s0 < L; s0 += BK) {
      __syncthreads();
      load_rows<DH>(Ks, a.k, nullptr, n, s0, BK, T, H, h);
      load_rows<DH>(Vs, a.v, nullptr, n, s0, BK, T, H, h);
      load_window<DH>(Pw, a.p, T - 1 - t0 - (BQ - 1) + s0, T, H, h);
      __syncthreads();
      float sc[4];
      scores<DH>(Qu, Qv, Ks, Pw, r, cg, s0, L, a.scale, sc);
      const float m_new =
          fmaxf(m_run, row_max(fmaxf(fmaxf(sc[0], sc[1]), fmaxf(sc[2], sc[3]))));
      const float corr = expf(m_run - m_new);
      float pe[4], rs = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pe[i] = expf(sc[i] - m_new);
        rs += pe[i];
      }
      l_run = l_run * corr + row_sum(rs);
      const unsigned bits = keep4(a.d, 0u, (uint32_t)(n * H + h), (uint32_t)t,
                                  (uint32_t)((s0 >> 2) + cg));
#pragma unroll
      for (int i = 0; i < 4; ++i) pe[i] *= keep_scale(a.d, bits, i);
#pragma unroll
      for (int j = 0; j < J; ++j) acc[j] *= corr;
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float pc =
            __shfl_sync(0xffffffffu, pe[c & 3], (lane & 24) | (c >> 2));
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] = fmaf(pc, Vs[c * LD + cg + 8 * j], acc[j]);
      }
      m_run = m_new;
    }
  }
  if (t < T) {
    const bool valid = t < L;
#pragma unroll
    for (int j = 0; j < J; ++j)
      out[(((size_t)n * T + t) * H + h) * DH + cg + 8 * j] =
          valid ? acc[j] / l_run : 0.f;
    if (cg == 0)
      lse[((size_t)n * H + h) * T + t] = valid ? m_run + logf(l_run) : 0.f;
  }
}

// Backward, query-major. Grid and threads as fwd_kernel. For each key tile
// below the length: P = exp(s - lse) (0 on query rows past the length),
// dS = P·(drop·(dO·v) - delta)·scale and P·drop, both written to the
// (N, H, T, T) planes ds and pd; dq += dS·k (du part) + dS·p (dv part).
// duv holds the two parts of dq, (N·T, H·DH) each, for du and dv_bias.
template <int DH>
__global__ void __launch_bounds__(NT)
    bwd_q_kernel(Args a, const float* __restrict__ lse,
                 const float* __restrict__ delta, const float* __restrict__ dO,
                 float* __restrict__ dq, float* __restrict__ duv,
                 float* __restrict__ ds, float* __restrict__ pd) {
  constexpr int LD = DH + 1, J = DH / 8;
  extern __shared__ float sm[];
  float* Qu = sm;
  float* Qv = Qu + BQ * LD;
  float* Do = Qv + BQ * LD;
  float* Ks = Do + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Pw = Vs + BK * LD;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int T = a.T, H = a.H, L = a.len[n];
  const int tid = threadIdx.x, r = tid >> 3, cg = tid & 7, lane = tid & 31;
  const int t = t0 + r;
  const size_t plane = ((size_t)n * H + h) * T;
  float au[J] = {}, av[J] = {};
  if (t0 < L) {
    load_rows<DH>(Qu, a.q, a.ub, n, t0, BQ, T, H, h);
    load_rows<DH>(Qv, a.q, a.vb, n, t0, BQ, T, H, h);
    load_rows<DH>(Do, dO, nullptr, n, t0, BQ, T, H, h);
    const float lse_r = t < T ? lse[plane + t] : 0.f;
    const float delta_r = t < T ? delta[plane + t] : 0.f;
    for (int s0 = 0; s0 < L; s0 += BK) {
      __syncthreads();
      load_rows<DH>(Ks, a.k, nullptr, n, s0, BK, T, H, h);
      load_rows<DH>(Vs, a.v, nullptr, n, s0, BK, T, H, h);
      load_window<DH>(Pw, a.p, T - 1 - t0 - (BQ - 1) + s0, T, H, h);
      __syncthreads();
      float sc[4], dsv[4];
      scores<DH>(Qu, Qv, Ks, Pw, r, cg, s0, L, a.scale, sc);
      const unsigned bits = keep4(a.d, 0u, (uint32_t)(n * H + h), (uint32_t)t,
                                  (uint32_t)((s0 >> 2) + cg));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = 4 * cg + i;
        float dpm = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d)
          dpm = fmaf(Do[r * LD + d], Vs[c * LD + d], dpm);
        const float P = t < L ? expf(sc[i] - lse_r) : 0.f;
        const float k = keep_scale(a.d, bits, i);
        dsv[i] = P * (dpm * k - delta_r) * a.scale;
        if (t < T && s0 + c < T) {
          ds[(plane + t) * T + s0 + c] = dsv[i];
          pd[(plane + t) * T + s0 + c] = P * k;
        }
      }
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float dc =
            __shfl_sync(0xffffffffu, dsv[c & 3], (lane & 24) | (c >> 2));
#pragma unroll
        for (int j = 0; j < J; ++j) {
          au[j] = fmaf(dc, Ks[c * LD + cg + 8 * j], au[j]);
          av[j] = fmaf(dc, Pw[(BQ - 1 - r + c) * LD + cg + 8 * j], av[j]);
        }
      }
    }
  }
  if (t < T) {
    const size_t row = ((size_t)n * T + t) * H + h;
    const size_t half = (size_t)a.N * T * H * DH;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t o = row * DH + cg + 8 * j;
      dq[o] = au[j] + av[j];
      duv[o] = au[j];
      duv[half + o] = av[j];
    }
  }
}

// Backward, key-major: dK[s] = sum_t dS[t, s]·(q[t] + u), dV[s] = sum_t
// (P·drop)[t, s]·dO[t], over the query tiles below the length in order.
// Grid (cdiv(T, BK), H, N). Thread (c = tid / 8, cg = tid % 8): key row
// s0 + c, columns cg + 8j.
template <int DH>
__global__ void __launch_bounds__(NT)
    bwd_kv_kernel(Args a, const float* __restrict__ dO,
                  const float* __restrict__ ds, const float* __restrict__ pd,
                  float* __restrict__ dk, float* __restrict__ dv) {
  constexpr int LD = DH + 1, J = DH / 8, LT = BK + 1;
  extern __shared__ float sm[];
  float* Qu = sm;
  float* Do = Qu + BQ * LD;
  float* Ds = Do + BQ * LD;
  float* Pd = Ds + BQ * LT;
  const int s0 = blockIdx.x * BK, h = blockIdx.y, n = blockIdx.z;
  const int T = a.T, H = a.H, L = a.len[n];
  const int tid = threadIdx.x, c = tid >> 3, cg = tid & 7;
  const size_t plane = ((size_t)n * H + h) * T;
  float ak[J] = {}, avv[J] = {};
  if (s0 < L) {
    for (int t0 = 0; t0 < L; t0 += BQ) {
      __syncthreads();
      load_rows<DH>(Qu, a.q, a.ub, n, t0, BQ, T, H, h);
      load_rows<DH>(Do, dO, nullptr, n, t0, BQ, T, H, h);
      for (int i = tid; i < BQ * BK; i += NT) {
        const int rr = i / BK, cc = i % BK, t = t0 + rr, s = s0 + cc;
        const bool ok = t < L && s < L;
        Ds[rr * LT + cc] = ok ? ds[(plane + t) * T + s] : 0.f;
        Pd[rr * LT + cc] = ok ? pd[(plane + t) * T + s] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < BQ; ++rr) {
        const float dsr = Ds[rr * LT + c], pdr = Pd[rr * LT + c];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          ak[j] = fmaf(dsr, Qu[rr * LD + cg + 8 * j], ak[j]);
          avv[j] = fmaf(pdr, Do[rr * LD + cg + 8 * j], avv[j]);
        }
      }
    }
  }
  const int s = s0 + c;
  if (s < T) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t o = (((size_t)n * T + s) * H + h) * DH + cg + 8 * j;
      dk[o] = ak[j];
      dv[o] = avv[j];
    }
  }
}

// Backward, table-major: dp[m] = sum over utterances n, then queries t,
// in order, of dS[n, t, s]·(q[t] + v), s = m - (T-1) + t below the
// length. Grid (cdiv(2T-1, 32), H). Thread (i = tid / 8, cg = tid % 8):
// table row m0 + i, columns cg + 8j.
template <int DH>
__global__ void __launch_bounds__(NT)
    bwd_p_kernel(Args a, const float* __restrict__ ds, float* __restrict__ dp) {
  constexpr int LD = DH + 1, J = DH / 8, LT = BQ + 1;
  extern __shared__ float sm[];
  float* Qv = sm;
  float* Bd = Qv + BQ * LD;  // (32 table rows, BQ queries)
  const int m0 = blockIdx.x * 32, h = blockIdx.y;
  const int T = a.T, H = a.H;
  const int tid = threadIdx.x, i = tid >> 3, cg = tid & 7;
  float acc[J] = {};
  for (int n = 0; n < a.N; ++n) {
    const int L = a.len[n];
    const size_t plane = ((size_t)n * H + h) * T;
    // queries whose key s = m - (T-1) + t lies in [0, L) for a row of the
    // tile: t in [T-1-(m0+31), L+T-1-m0), and t < L
    const int tlo = max(0, T - 1 - (m0 + 31)), thi = min(L, L + T - 1 - m0);
    for (int t0 = tlo / BQ * BQ; t0 < thi; t0 += BQ) {
      __syncthreads();
      load_rows<DH>(Qv, a.q, a.vb, n, t0, BQ, T, H, h);
      for (int e = tid; e < 32 * BQ; e += NT) {
        const int ii = e / BQ, rr = e % BQ, t = t0 + rr;
        const int s = m0 + ii - (T - 1) + t;
        Bd[ii * LT + rr] =
            t < L && s >= 0 && s < L ? ds[(plane + t) * T + s] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int rr = 0; rr < BQ; ++rr) {
        const float b = Bd[i * LT + rr];
#pragma unroll
        for (int j = 0; j < J; ++j)
          acc[j] = fmaf(b, Qv[rr * LD + cg + 8 * j], acc[j]);
      }
    }
  }
  const int m = m0 + i;
  if (m < 2 * T - 1) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      dp[((size_t)m * H + h) * DH + cg + 8 * j] = acc[j];
  }
}

template <int DH>
constexpr size_t fwd_smem() {
  return (size_t)(2 * BQ + 2 * BK + WIN) * (DH + 1) * 4;
}
template <int DH>
constexpr size_t bwd_q_smem() {
  return (size_t)(3 * BQ + 2 * BK + WIN) * (DH + 1) * 4;
}
template <int DH>
constexpr size_t bwd_kv_smem() {
  return (size_t)(2 * BQ * (DH + 1) + 2 * BQ * (BK + 1)) * 4;
}
template <int DH>
constexpr size_t bwd_p_smem() {
  return (size_t)(BQ * (DH + 1) + 32 * (BQ + 1)) * 4;
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

#define CATK_TRY(expr)                         \
  do {                                         \
    cudaError_t err_ = (expr);                 \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

template <int DH>
cudaError_t launch_fwd(const Args& a, float* out, float* lse, cudaStream_t s) {
  CATK_TRY(allow_smem(fwd_kernel<DH>, fwd_smem<DH>()));
  fwd_kernel<DH><<<dim3(cdiv(a.T, BQ), a.H, a.N), NT, fwd_smem<DH>(), s>>>(
      a, out, lse);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bwd(const Args& a, const float* lse, const float* delta,
                       const float* dO, float* dq, float* dk, float* dv,
                       float* dp, float* du, float* dvb, float* ws_ds,
                       float* ws_pd, float* ws_duv, float* ws_part,
                       cudaStream_t s) {
  const dim3 grid(cdiv(a.T, BQ), a.H, a.N);
  CATK_TRY(allow_smem(bwd_q_kernel<DH>, bwd_q_smem<DH>()));
  bwd_q_kernel<DH><<<grid, NT, bwd_q_smem<DH>(), s>>>(a, lse, delta, dO, dq,
                                                      ws_duv, ws_ds, ws_pd);
  CATK_TRY(cudaGetLastError());
  CATK_TRY(allow_smem(bwd_kv_kernel<DH>, bwd_kv_smem<DH>()));
  bwd_kv_kernel<DH><<<grid, NT, bwd_kv_smem<DH>(), s>>>(a, dO, ws_ds, ws_pd,
                                                       dk, dv);
  CATK_TRY(cudaGetLastError());
  CATK_TRY(allow_smem(bwd_p_kernel<DH>, bwd_p_smem<DH>()));
  bwd_p_kernel<DH><<<dim3(cdiv(2 * a.T - 1, 32), a.H), NT, bwd_p_smem<DH>(),
                     s>>>(a, ws_ds, dp);
  CATK_TRY(cudaGetLastError());
  const int rows = a.N * a.T, cols = a.H * DH;
  ColJobs jobs{{{ws_duv, nullptr, du, cols},
                {ws_duv + (size_t)rows * cols, nullptr, dvb, cols}}};
  return colsum(jobs, 2, rows, ws_part, s);
}

}  // namespace

// q, k, v, out (N, T, H, Dh), p (2T-1, H, Dh), ub, vb (H, Dh) f32;
// lengths (N,) int32 in [0, T]; lse (N, H, T) f32. Dh one of 8, 16, 32,
// 64, 128. Dropout as relpos_attention_fwd: seed words and keep threshold
// as uint32 bit patterns (thr 0: none), inv = 1 / (1 - rate).
extern "C" int relpos_attention_f32_fwd(const void* q, const void* k,
                                        const void* v, const void* p,
                                        const void* ub, const void* vb,
                                        const void* lengths, void* out,
                                        void* lse, int N, int T, int H, int Dh,
                                        int seed0, int seed1, int thr,
                                        float scale, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || T <= 0) return cudaSuccess;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(p),
               static_cast<const float*>(ub), static_cast<const float*>(vb),
               static_cast<const int*>(lengths), N, T, H, scale,
               Drop{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv}};
  float* o = static_cast<float*>(out);
  float* l = static_cast<float*>(lse);
  switch (Dh) {
    case 8: return launch_fwd<8>(a, o, l, s);
    case 16: return launch_fwd<16>(a, o, l, s);
    case 32: return launch_fwd<32>(a, o, l, s);
    case 64: return launch_fwd<64>(a, o, l, s);
    case 128: return launch_fwd<128>(a, o, l, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward of relpos_attention_f32_fwd. lse (N, H, T) from the
// forward, delta (N, H, T) = sum_d dout·out, dout (N, T, H, Dh) f32.
// Outputs, written whole: dq, dk, dv (N, T, H, Dh), dp (2T-1, H, Dh), du,
// dvb (H, Dh). Workspace (f32): ws_ds and ws_pd N·H·T·T floats each,
// ws_duv 2·N·T·H·Dh, ws_part 2·ceil(N·T / 64)·H·Dh.
extern "C" int relpos_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* p,
    const void* ub, const void* vb, const void* lengths, const void* lse,
    const void* delta, const void* dout, void* dq, void* dk, void* dv,
    void* dp, void* du, void* dvb, void* ws_ds, void* ws_pd, void* ws_duv,
    void* ws_part, int N, int T, int H, int Dh, int seed0, int seed1, int thr,
    float scale, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || T <= 0) return cudaSuccess;
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(p),
               static_cast<const float*>(ub), static_cast<const float*>(vb),
               static_cast<const int*>(lengths), N, T, H, scale,
               Drop{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv}};
  auto f = [](const void* x) { return static_cast<const float*>(x); };
  auto w = [](void* x) { return static_cast<float*>(x); };
#define CATK_BWD(DH)                                                        \
  launch_bwd<DH>(a, f(lse), f(delta), f(dout), w(dq), w(dk), w(dv), w(dp), \
                 w(du), w(dvb), w(ws_ds), w(ws_pd), w(ws_duv), w(ws_part), s)
  switch (Dh) {
    case 8: return CATK_BWD(8);
    case 16: return CATK_BWD(16);
    case 32: return CATK_BWD(32);
    case 64: return CATK_BWD(64);
    case 128: return CATK_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef CATK_BWD
}
