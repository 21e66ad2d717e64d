// RNN-T lattice recursions over the (T, U+1) grid, one launch for all T
// frames:
//
//   alpha(t, u) = max(base ⊕ (label_eff[t, u-1] ⊗ alpha(t, u-1)), LOG_EPS)
//   base        = t == 0 ? (u == 0 ? 0 : LOG_EPS)
//                        : max(alpha(t-1, u) + blank_eff[t-1, u], LOG_EPS)
//
// in the log semiring (⊕ = logaddexp, ⊗ = +; no label term at u = 0),
// and the betas the mirrored recursion from beta(T, u) = beta_term[u]:
//
//   beta(t, u) = max(b ⊕ (m ⊗ beta(t, u+1)), LOG_EPS),
//   b = max(blank_eff[t, u] + beta(t+1, u), LOG_EPS),
//   m = label_eff[t, u] (LOG_EPS at u = U, which has no successor).
//
// Every sum is floored at LOG_EPS = -1e30 and ⊕ treats values at or below
// LOG_EPS / 2 as exact zeros (`lae`, the `safe_logaddexp` of
// `ops/semiring.py`), so no NaN can arise. Padding needs no care here: the
// tables (`ops/rnnt.py` `_row_tables`) give padded frames a free blank and
// labels past U_n LOG_EPS.
//
// Replaces the TPU kernels `_alpha_kernel` and `_beta_kernel` of
// `cat_tpu/ops/rnnt_pallas.py` (`pallas_call` in `forward_alphas_pallas`
// and `backward_betas_pallas`), which pad U+1 to 128 lanes, walk T as a
// sequential grid and scan each row by lane rolls. The plain versions are
// `forward_alphas_reference` and `backward_betas_reference` in
// `ops/rnnt.py`: a loop over frames with a Hillis-Steele scan along u.
//
// What bounds it on the H100: at the rnnt-v1 training batch (T' = 493,
// N = 32, U+1 <= 83, f32) it reads the two 5.2 MB tables and writes 5.2
// MB of states, 4.7 us at 3.35 TB/s. But node (t, u) needs (t-1, u) and
// (t, u-1), so the lattice is a chain of T + U dependent steps (575), and
// the latency of one step (the wavefront's: one `lae_wide`, its floors
// and one shuffle; measured by `rnnt_chain_floor` below) times that count
// bounds it instead.
//
// Two routes, chosen by `rnnt_plan` in `ops/rnnt.py` from U+1 alone; the
// C entries refuse any other plan.
// - wavefront (U+1 <= 32 * WAVE_MAX_WARPS): the nodes of one
//   anti-diagonal k = t + u are independent, so the recursion takes
//   T + U steps of one `lae_wide` each. One block per utterance of W =
//   ceil(U1 / 32) warps, thread u holding state u in a register; at step k
//   it computes node (k - u, u) if that lies on the lattice. Its own
//   register holds (t-1, u) from step k-1; (t, u-1) comes from lane u-1 by
//   one shuffle, or for lane 0 from the seam in shared memory where lane
//   31 of the warp before left it (betas: lane u+1, and lane 0 of the warp
//   after); one barrier a step when W > 1, no atomics. Each warp runs one
//   chain: a warp issues in order, and one warp holding several states a
//   lane runs their chains one after the other. The table values of step
//   k + PREFETCH are loaded into a register ring at step k, so the
//   scattered 4-byte reads (thread u+1 reads the word next to thread u's
//   one step later; the tables were just written and sit in L2) never
//   stall the chain. Its states are f64 (see `lae_wide`).
// - rowscan (longer label sequences, up to MAX_U1 of `ops/rnnt.py`): one
//   block per utterance, its u states across the threads (chunks of the
//   block's width, at most 1024, carry the running state from chunk to
//   chunk); each row t solved as an inclusive scan of (multiplier, addend)
//   pairs with the combine (earlier x, later y) -> (x.m + y.m, y.a ⊕ (y.m
//   + x.a)), in f32 and in the plain versions' order: a warp scan by
//   shuffles, one combine of the warp totals through shared memory
//   (double-buffered by iteration parity, two barriers a frame), the next
//   frame's table values loaded while the current one is scanned. T frames
//   of about 11 dependent `lae` each.
#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 1024;
// the wavefront route: at most 32 warps, one state a thread (U+1 <=
// 1024), table values loaded PREFETCH steps ahead of their use; blocks of
// up to WAVE_NARROW_WARPS warps take the instantiation bounded at that
// width, whose threads get more registers (beta's 196 against 64 at 32
// warps, where the prefetch ring spills)
constexpr int WAVE_MAX_WARPS = 32;
constexpr int WAVE_NARROW_WARPS = 8;
constexpr int PREFETCH = 16;
enum Route { ROWSCAN = 0, WAVEFRONT = 1 };

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

// The wavefront's `lae`, on f64 states: a state reaches about -4e3 at the
// rnnt-v1 batch, where one f32 rounding is 2.4e-4, and the T + U f32
// roundings of a chain leave the gradient rows about twice the gate of
// PERF.md §2 (1e-3 + 1e-3·|exact|) from the exact values
// (tests/test_torch_rnnt_wavefront.py measures it on the CPU). The
// correction log1p(e^(mn - mx)) in [0, log 2] is taken in f32 by the fast
// intrinsics `__expf` and `__logf` (about 1e-7 absolute a step, as the
// accurate expf / log1pf); the output rounds once to f32.
__device__ __forceinline__ double dmax(double a, double b) {
  return a > b ? a : b;  // no NaN reaches here: no fmax's NaN tests
}

__device__ __forceinline__ double lae_wide(double a, double b) {
  const double mx = dmax(a, b);
  const double mn = a > b ? b : a;
  return mx <= LOG_EPS / 2 ? LOG_EPS
                           : mx + (double)__logf(1.f + __expf((float)(mn - mx)));
}

// One step of the wavefront: node from its own state v plus weight b and
// its neighbour's nb plus weight l, floored.
__device__ __forceinline__ double wave_step(double v, double nb, float b,
                                            float l) {
  return dmax(lae_wide(dmax(v + b, LOG_EPS), dmax(nb + l, LOG_EPS)),
              LOG_EPS);
}

// Wavefront route: grid N, a block of W = ceil(U1 / 32) <= kMaxWarps
// warps, thread u holding state u. blank, label (T, N, U1) f32; term (N,
// U1) f32 (beta_T, betas only); out (T, N, U1) f32. Step k holds the
// nodes t + u = k (alphas) or t + u = T + U1 - 2 - k (betas).
template <bool kBeta, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps)
    rnnt_wave_kernel(const float* __restrict__ blank,
                     const float* __restrict__ label,
                     const float* __restrict__ term,
                     float* __restrict__ out, int T, int N, int U1) {
  // the state each warp's edge lane sends across the seam, by step parity
  __shared__ double seam[2][kMaxWarps];
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const int W = blockDim.x >> 5, n = blockIdx.x;
  const long long st = (long long)N * U1;
  const int K = T + U1 - 1;
  // the frame at step k is k - u (alphas) or tk - k with tk = T + U1 - 2
  // - u (betas), and each table index is an offset plus or minus k·st
  const bool on_u = u < U1;
  const long long at = (long long)n * U1 + u;
  const int tk = kBeta ? T + U1 - 2 - u : u;
  const long long ob = kBeta ? tk * st + at : at - (u + 1) * st;  // [t-1, u]
  const long long ol = kBeta ? tk * st + at : at - 1 - u * st;    // [t, u-1]
  const long long oo = kBeta ? tk * st + at : at - u * st;
  const bool has_l = kBeta ? u + 1 < U1 : u > 0;
  const long long dk = kBeta ? -st : st;
  auto frame = [&](int k) { return kBeta ? tk - k : k - tk; };
  auto live = [&](int k) { return on_u && (unsigned)frame(k) < (unsigned)T; };
  // the blank and label weights of step k: 0 and LOG_EPS off the lattice
  // and where the recursion has no such term (alphas: no blank weight at
  // t = 0)
  auto fetch = [&](int k, float& b, float& l) {
    const long long kk = k * dk;
    const bool on = live(k);
    b = on && (kBeta || frame(k) > 0) ? blank[ob + kk] : 0.f;
    l = on && has_l ? label[ol + kk] : LOG_EPS;
  };
  float rb[PREFETCH], rl[PREFETCH];
#pragma unroll
  for (int j = 0; j < PREFETCH; ++j) fetch(j, rb[j], rl[j]);
  // the state (f64) before the first step: alpha(-1, u) stands in as
  // (u == 0 ? 0 : LOG_EPS) with a blank weight of 0, so that base =
  // max(v + 0, LOG_EPS) is frame 0's; beta(T, u) = term[u]
  double v = !on_u ? LOG_EPS
             : kBeta ? term[at] : (u == 0 ? 0.0 : LOG_EPS);
  // the neighbour's state of the previous step: alphas (t, u-1) from lane
  // - 1, betas (t, u+1) from lane + 1, by one shuffle; the edge lane (0,
  // betas 31) reads it from the seam, where the facing edge lane of the
  // neighbouring warp left it; LOG_EPS past either end
  const bool edge = kBeta ? lane == 31 : lane == 0;
  const bool sends = kBeta ? lane == 0 : lane == 31;
  const int from = kBeta ? warp + 1 : warp - 1;
  const bool has_from = from >= 0 && from < W;
  if (sends) seam[1][warp] = v;
  if (W > 1) __syncthreads();
  for (int k0 = 0; k0 < K; k0 += PREFETCH) {
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int k = k0 + j;
      if (k >= K) break;
      const float b = rb[j], l = rl[j];
      fetch(k + PREFETCH, rb[j], rl[j]);
      double nb = kBeta ? __shfl_down_sync(FULL, v, 1)
                        : __shfl_up_sync(FULL, v, 1);
      if (edge) nb = has_from ? seam[(k + 1) & 1][from] : LOG_EPS;
      const double x = wave_step(v, nb, b, l);
      if (live(k)) {
        v = x;
        out[oo + k * dk] = (float)x;
      }
      // step k's edge states go to seam[k & 1], read at step k + 1; the
      // barrier orders them, and step k + 2's writes after the reads
      if (W > 1) {
        if (sends) seam[k & 1][warp] = v;
        __syncthreads();
      }
    }
  }
}

// `ops/rnnt.py` `chain_floor`: `steps` dependent steps of the wavefront
// (`wave_step`, one shuffle) with no loads, one warp a block, grid N as
// the route's at the rnnt-v1 batch; out (N, 32) f32 keeps the states live.
__global__ void __launch_bounds__(32)
    chain_floor_kernel(float* __restrict__ out, int steps, float w) {
  const int lane = threadIdx.x;
  double v = -0.25 * lane;
  for (int k = 0; k < steps; ++k)
    v = wave_step(v, __shfl_up_sync(FULL, v, 1), w, w);
  out[blockIdx.x * 32 + lane] = (float)v;
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

// The wavefront on `warps` warps a block, in the instantiation for its
// width.
template <bool kBeta>
cudaError_t launch_wave(const float* b, const float* l, const float* tm,
                        float* o, int T, int N, int U1, int warps,
                        cudaStream_t s) {
  if (warps <= WAVE_NARROW_WARPS)
    rnnt_wave_kernel<kBeta, WAVE_NARROW_WARPS><<<N, 32 * warps, 0, s>>>(
        b, l, tm, o, T, N, U1);
  else
    rnnt_wave_kernel<kBeta, WAVE_MAX_WARPS><<<N, 32 * warps, 0, s>>>(
        b, l, tm, o, T, N, U1);
  return cudaGetLastError();
}

// The plan of `ops/rnnt.py` `rnnt_plan`: wavefront on ceil(U1 / 32) warps
// up to 32 * WAVE_MAX_WARPS states, else rowscan with 0.
bool plan_ok(int U1, int route, int warps) {
  if (U1 <= 32 * WAVE_MAX_WARPS)
    return route == WAVEFRONT && warps == (U1 + 31) / 32;
  return route == ROWSCAN && warps == 0;
}

}  // namespace

// route, warps: the plan of `ops/rnnt.py` `rnnt_plan` (route 0 rowscan,
// 1 wavefront); any other plan for this U1 is refused.
extern "C" int rnnt_alpha(const void* blank, const void* label, void* out,
                          int T, int N, int U1, int route, int warps,
                          void* stream) {
  if (!plan_ok(U1, route, warps)) return cudaErrorInvalidValue;
  if (T <= 0 || N <= 0) return cudaSuccess;
  const auto* b = static_cast<const float*>(blank);
  const auto* l = static_cast<const float*>(label);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == WAVEFRONT)
    return launch_wave<false>(b, l, nullptr, o, T, N, U1, warps, s);
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(rnnt_alpha_kernel, U1, threads, smem);
  if (err != cudaSuccess) return err;
  rnnt_alpha_kernel<<<N, threads, smem, s>>>(b, l, o, T, N, U1);
  return cudaGetLastError();
}

extern "C" int rnnt_beta(const void* blank, const void* label,
                         const void* term, void* out, int T, int N, int U1,
                         int route, int warps, void* stream) {
  if (!plan_ok(U1, route, warps)) return cudaErrorInvalidValue;
  if (T <= 0 || N <= 0) return cudaSuccess;
  const auto* b = static_cast<const float*>(blank);
  const auto* l = static_cast<const float*>(label);
  const auto* tm = static_cast<const float*>(term);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == WAVEFRONT)
    return launch_wave<true>(b, l, tm, o, T, N, U1, warps, s);
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(rnnt_beta_kernel, U1, threads, smem);
  if (err != cudaSuccess) return err;
  rnnt_beta_kernel<<<N, threads, smem, s>>>(b, l, tm, o, T, N, U1);
  return cudaGetLastError();
}

// `steps` dependent steps of the wavefront with no loads on N blocks of
// one warp; out (N, 32) f32; w a weight the compiler cannot fold.
extern "C" int rnnt_chain_floor(void* out, int N, int steps, float w,
                                void* stream) {
  if (N <= 0) return cudaSuccess;
  chain_floor_kernel<<<N, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), steps, w);
  return cudaGetLastError();
}
