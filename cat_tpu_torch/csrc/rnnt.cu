// RNN-T lattice recursions over the (T, U+1) grid, one launch for all T
// frames. Row t of the alphas solves a first-order linear recurrence
// along u in the log semiring (⊕ = logaddexp, ⊗ = +):
//
//   alpha_t[u] = max(base[u] ⊕ (label_eff[t, u-1] ⊗ alpha_t[u-1]), LOG_EPS)
//   base[u]    = t == 0 ? (u == 0 ? 0 : LOG_EPS)
//                       : max(alpha_{t-1}[u] + blank_eff[t-1, u], LOG_EPS)
//
// and the betas the mirrored suffix recurrence from beta_T = beta_term:
//
//   beta_t[u] = max(b[u] ⊕ (m[u] ⊗ beta_t[u+1]), LOG_EPS),
//   b[u] = max(blank_eff[t, u] + beta_{t+1}[u], LOG_EPS),
//   m[u] = label_eff[t, u] (LOG_EPS at u = U, which has no successor).
//
// A row is an inclusive scan of (multiplier, addend) pairs with the
// combine (earlier x, later y) -> (x.m + y.m, y.a ⊕ (y.m + x.a)), every
// sum floored at LOG_EPS = -1e30 and ⊕ treating values at or below
// LOG_EPS / 2 as exact zeros (`safe_logaddexp` of `ops/semiring.py`), so
// no NaN can arise. Padding needs no care here: the tables
// (`ops/rnnt.py` `_row_tables`) give padded frames a free blank and
// labels past U_n LOG_EPS.
//
// Replaces the TPU kernels `_alpha_kernel` and `_beta_kernel` of
// `cat_tpu/ops/rnnt_pallas.py` (`pallas_call` in `forward_alphas_pallas`
// and `backward_betas_pallas`), which pad U+1 to 128 lanes, walk T as a
// sequential grid and scan each row by lane rolls. The plain versions
// are `forward_alphas_reference` and `backward_betas_reference` in
// `ops/rnnt.py`: a loop over frames with a Hillis-Steele scan along u.
//
// What bounds it on the H100: at the rnnt-v1 training batch (T' = 493,
// N = 32, U+1 <= 83, f32) it reads the two 5.2 MB tables and writes 5.2
// MB of states, 4.7 us at 3.35 TB/s, but the T' frames are dependent
// steps, so the latency of one frame's scan times T' bounds it instead.
// The design keeps a frame short: one block per utterance, its u states
// across the threads (chunks of the block's width, at most 1024, carry
// the running state from chunk to chunk, so any U+1 that fits the shared
// row works); a thread keeps its own states of the previous row in
// shared memory (no barrier for them); each row is a warp scan by
// shuffles, one combine of the warp totals through shared memory
// (double-buffered by iteration parity, so each frame costs two
// barriers), and the next frame's table values are loaded into
// registers while the current frame is scanned.
#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ float lae(float a, float b) {
  const float mx = fmaxf(a, b);
  const float mn = fminf(a, b);
  return mx <= LOG_EPS / 2 ? LOG_EPS : mx + log1pf(expf(mn - mx));
}

// (m, a) <- combine(partner (pm, pa), (m, a)): the partner is the
// earlier element of a prefix scan, the later one of a suffix scan.
__device__ __forceinline__ void absorb(float& m, float& a, float pm,
                                       float pa) {
  a = lae(a, fmaxf(m + pa, LOG_EPS));
  m = fmaxf(m + pm, LOG_EPS);
}

template <bool kSuffix>
__device__ __forceinline__ void warp_scan(float& m, float& a, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float pm = kSuffix ? __shfl_down_sync(FULL, m, d)
                             : __shfl_up_sync(FULL, m, d);
    const float pa = kSuffix ? __shfl_down_sync(FULL, a, d)
                             : __shfl_up_sync(FULL, a, d);
    if (kSuffix ? lane + d < 32 : lane >= d) absorb(m, a, pm, pa);
  }
}

// Inclusive scan of the block's (m, a) pairs in thread order (prefix) or
// reverse thread order (suffix). `wm`/`wa` hold 32 warp totals; callers
// alternate two such buffers between calls. Lanes past the row hold the
// identity (0, LOG_EPS).
template <bool kSuffix>
__device__ __forceinline__ void block_scan(float& m, float& a, float* wm,
                                           float* wa) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  warp_scan<kSuffix>(m, a, lane);
  if (nw == 1) return;
  if (lane == (kSuffix ? 0 : 31)) {
    wm[warp] = m;
    wa[warp] = a;
  }
  __syncthreads();
  if (warp == 0) {
    float sm = lane < nw ? wm[lane] : 0.f;
    float sa = lane < nw ? wa[lane] : LOG_EPS;
    warp_scan<kSuffix>(sm, sa, lane);
    if (lane < nw) {
      wm[lane] = sm;
      wa[lane] = sa;
    }
  }
  __syncthreads();
  const int src = kSuffix ? warp + 1 : warp - 1;
  if (src >= 0 && src < nw) absorb(m, a, wm[src], wa[src]);
}

// Shared memory: the previous row (U1 floats), two buffers of 32 warp
// totals (m and a) and two carry slots.
__host__ __device__ constexpr size_t smem_floats(int U1) {
  return (size_t)U1 + 4 * 32 + 2;
}

// blank, label (T, N, U1) f32; out (T, N, U1) f32 alphas.
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_alpha_kernel(const float* __restrict__ blank,
                      const float* __restrict__ label,
                      float* __restrict__ out, int T, int N, int U1) {
  extern __shared__ float sm[];
  float* row = sm;
  float* wm = sm + U1;
  float* wa = wm + 64;
  float* carry_s = wa + 64;
  const int n = blockIdx.x, B = blockDim.x;
  const int C = (U1 + B - 1) / B;
  const size_t st = (size_t)N * U1;
  const float* bl = blank + (size_t)n * U1;
  const float* lb = label + (size_t)n * U1;
  float* o = out + (size_t)n * U1;
  // frame t reads blank_eff[t - 1, u] and label_eff[t, u - 1]
  auto fetch = [&](int it, float& b, float& l) {
    const int t = it / C, u = (it % C) * B + threadIdx.x;
    b = (t > 0 && u < U1) ? bl[(size_t)(t - 1) * st + u] : 0.f;
    l = (u >= 1 && u < U1) ? lb[(size_t)t * st + u - 1] : LOG_EPS;
  };
  const int total = T * C;
  float nb, nl, carry = LOG_EPS;
  fetch(0, nb, nl);
  for (int it = 0; it < total; ++it) {
    const float b = nb, l = nl;
    if (it + 1 < total) fetch(it + 1, nb, nl);
    const int t = it / C, c = it % C, u = c * B + threadIdx.x, par = it & 1;
    const bool valid = u < U1;
    float m = 0.f, a = LOG_EPS;
    if (valid) {
      m = l;
      a = t == 0 ? (u == 0 ? 0.f : LOG_EPS) : fmaxf(row[u] + b, LOG_EPS);
    }
    block_scan<false>(m, a, wm + 32 * par, wa + 32 * par);
    if (c > 0) a = lae(a, fmaxf(m + carry, LOG_EPS));
    a = fmaxf(a, LOG_EPS);
    if (valid) {
      row[u] = a;
      o[(size_t)t * st + u] = a;
    }
    if (C > 1) {
      if (threadIdx.x == B - 1) carry_s[par] = a;
      __syncthreads();
      carry = carry_s[par];
    }
  }
}

// blank, label (T, N, U1) f32; term (N, U1) f32 (beta_T); out (T, N, U1)
// f32 betas of frames 0..T-1.
__global__ void __launch_bounds__(MAX_THREADS)
    rnnt_beta_kernel(const float* __restrict__ blank,
                     const float* __restrict__ label,
                     const float* __restrict__ term,
                     float* __restrict__ out, int T, int N, int U1) {
  extern __shared__ float sm[];
  float* row = sm;
  float* wm = sm + U1;
  float* wa = wm + 64;
  float* carry_s = wa + 64;
  const int n = blockIdx.x, B = blockDim.x;
  const int C = (U1 + B - 1) / B;
  const size_t st = (size_t)N * U1;
  const float* bl = blank + (size_t)n * U1;
  const float* lb = label + (size_t)n * U1;
  float* o = out + (size_t)n * U1;
  for (int u = threadIdx.x; u < U1; u += B) row[u] = term[(size_t)n * U1 + u];
  // frame t = T - 1 - it / C, chunks from the last; reads blank_eff[t, u]
  // and label_eff[t, u]
  auto fetch = [&](int it, float& b, float& l) {
    const int t = T - 1 - it / C, u = (C - 1 - it % C) * B + threadIdx.x;
    b = u < U1 ? bl[(size_t)t * st + u] : 0.f;
    l = u < U1 - 1 ? lb[(size_t)t * st + u] : LOG_EPS;
  };
  const int total = T * C;
  float nb, nl, carry = LOG_EPS;
  fetch(0, nb, nl);
  for (int it = 0; it < total; ++it) {
    const float b = nb, l = nl;
    if (it + 1 < total) fetch(it + 1, nb, nl);
    const int t = T - 1 - it / C, c = C - 1 - it % C;
    const int u = c * B + threadIdx.x, par = it & 1;
    const bool valid = u < U1;
    float m = 0.f, a = LOG_EPS;
    if (valid) {
      m = l;
      a = fmaxf(b + row[u], LOG_EPS);
    }
    block_scan<true>(m, a, wm + 32 * par, wa + 32 * par);
    if (c < C - 1) a = lae(a, fmaxf(m + carry, LOG_EPS));
    a = fmaxf(a, LOG_EPS);
    if (valid) {
      row[u] = a;
      o[(size_t)t * st + u] = a;
    }
    if (C > 1) {
      if (threadIdx.x == 0) carry_s[par] = a;
      __syncthreads();
      carry = carry_s[par];
    }
  }
}

// Launch shape: one block per utterance, up to 1024 threads in whole
// warps; shared memory as `smem_floats` (above 48 KB only after the
// function attribute is raised, at most 227 KB).
template <typename K>
cudaError_t prepare(K kernel, int U1, dim3& threads, size_t& smem) {
  threads = dim3(U1 >= MAX_THREADS ? MAX_THREADS : (U1 + 31) / 32 * 32);
  smem = smem_floats(U1) * sizeof(float);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

}  // namespace

extern "C" int rnnt_alpha(const void* blank, const void* label, void* out,
                          int T, int N, int U1, void* stream) {
  if (T <= 0 || N <= 0 || U1 <= 0) return cudaSuccess;
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(rnnt_alpha_kernel, U1, threads, smem);
  if (err != cudaSuccess) return err;
  rnnt_alpha_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<float*>(out), T, N, U1);
  return cudaGetLastError();
}

extern "C" int rnnt_beta(const void* blank, const void* label,
                         const void* term, void* out, int T, int N, int U1,
                         void* stream) {
  if (T <= 0 || N <= 0 || U1 <= 0) return cudaSuccess;
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(rnnt_beta_kernel, U1, threads, smem);
  if (err != cudaSuccess) return err;
  rnnt_beta_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(blank), static_cast<const float*>(label),
      static_cast<const float*>(term), static_cast<float*>(out), T, N, U1);
  return cudaGetLastError();
}
