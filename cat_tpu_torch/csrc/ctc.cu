// CTC lattice recursions over the blank-interleaved label lattice, one
// launch for all T frames.
//
//   alpha_t[s] = max(em_t[s] + LAE3(alpha[s], alpha[s-1],
//                                   allow2[s] ? alpha[s-2] : LOG_EPS), LOG_EPS)
//   beta_t[s]  = max(LAE3(b[s], b[s+1], allow2_dst[s] ? b[s+2] : LOG_EPS),
//                    LOG_EPS),  b = max(em_{t+1} + beta_{t+1}, LOG_EPS)
//
// from alpha_{-1} = (0, LOG_EPS, ...) and beta_{T-1} = beta_last; LAE3 is
// `_lae3` of the TPU kernels (values at or below LOG_EPS / 2 are zeros,
// LOG_EPS = -1e30). Padded frames need no care here: the emission table
// (`ops/ctc.py` `_emissions`) lets blank emit 0 and labels LOG_EPS there.
//
// Replaces the TPU kernels `_alpha_kernel` and `_beta_kernel` of
// `cat_tpu/ops/ctc_pallas.py` (`pallas_call` in `forward_alphas_pallas`
// and `backward_betas_pallas`), which pad S to 128 lanes, walk T as a
// sequential grid and shift the states by lane rolls. The plain versions
// are `forward_alphas_reference` and `backward_betas_reference` in
// `ops/ctc.py`.
//
// What bounds it on the H100: at the crf-v1 training batch (T = 493, N =
// 32, S = 247, f32) it reads the 15.6 MB emission table and writes the
// 15.6 MB of states, 9.3 us at 3.35 TB/s, but the T frames are dependent
// steps, so the latency of one step (`lae3` of a state and its two
// neighbours, an added emission and its floor; measured by
// `chain_floor_kernel` below) times T bounds it instead. A state needs
// only s, s-1 and s-2 (betas s+1, s+2) of the frame before: there is
// nothing to sum across threads.
//
// Two routes, chosen by `ctc_plan` in `ops/ctc.py` from S alone; the C
// entries refuse any other plan.
// - lanes (S <= 32 * LANES_MAX_WARPS = 1024): one block per utterance of
//   W = ceil(S / 32) warps, state s in a register of thread s (lane s % 32
//   of warp s / 32). Its neighbours of the frame before come by two
//   shuffles (alphas up, betas down); the two edge lanes of a warp (alphas
//   0 and 1, betas 31 and 30) take what the shuffles cannot reach from
//   the seam in shared memory, where the two facing lanes of the
//   neighbouring warp left their values, double-buffered by frame parity:
//   one barrier a frame when W > 1, none in one warp. The betas exchange b
//   (the state plus its emission, floored), which each state forms once,
//   so a frame reads one emission a thread. The emissions of frame t +
//   PREFETCH are loaded into a register ring at frame t, one coalesced row
//   of S floats a frame, so no load stands on the chain; each step moves
//   the offsets of its load and its store by one frame, so no address
//   arithmetic and no branch stands between two of its steps either (on
//   the H100 a step with them took about 1.2 times as long), and the
//   states leave by streaming stores, which nothing reads back soon
//   (about 1.1 times as fast as plain stores there). Threads past S
//   hold LOG_EPS states and emissions, take part in every shuffle and
//   seam, and write nothing. Blocks of up to LANES_NARROW_WARPS warps take
//   the instantiation bounded at that width, whose threads may keep more
//   registers.
// - frames (longer label sequences, up to what shared memory holds): one
//   block per utterance, its states across the threads (a thread takes
//   states s, s + blockDim, ... so any S fits), the previous frame's
//   states in shared memory, double-buffered so that each frame costs one
//   barrier; every state reads its two or three neighbours from shared
//   memory.
// Both take the same expf/logf arithmetic, in f32, as the plain versions.
#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
// the lanes route: at most 32 warps, one state a thread (S <= 1024),
// emissions loaded PREFETCH frames ahead of their use; blocks of up to
// LANES_NARROW_WARPS warps take the instantiation bounded at that width
constexpr int LANES_MAX_WARPS = 32;
constexpr int LANES_NARROW_WARPS = 8;
constexpr int PREFETCH = 16;
enum Route { FRAMES = 0, LANES = 1 };

__device__ __forceinline__ float lae3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float ms = fmaxf(m, LOG_EPS);
  const float s = expf(a - ms) + expf(b - ms) + expf(c - ms);
  return m <= LOG_EPS / 2 ? LOG_EPS : ms + logf(s);
}

// em (T, N, S) f32; allow2 (N, S) bool bytes; out (T, N, S) f32. Shared:
// two f32 rows of S states and the S permission bytes.
__global__ void __launch_bounds__(1024)
    ctc_alpha_kernel(const float* __restrict__ em,
                     const unsigned char* __restrict__ allow2,
                     float* __restrict__ out, int T, int N, int S) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  unsigned char* a2 = reinterpret_cast<unsigned char*>(sm + 2 * S);
  const int n = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    prev[s] = s == 0 ? 0.f : LOG_EPS;
    a2[s] = allow2[(size_t)n * S + s];
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const size_t row = ((size_t)t * N + n) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float x1 = s >= 1 ? prev[s - 1] : LOG_EPS;
      const float x2 = (s >= 2 && a2[s]) ? prev[s - 2] : LOG_EPS;
      const float v = fmaxf(em[row + s] + lae3(prev[s], x1, x2), LOG_EPS);
      cur[s] = v;
      out[row + s] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

// em (T, N, S), allow2_dst (N, S) bool bytes, beta_last (N, S), out
// (T, N, S). Frame t reads em[t + 1].
__global__ void __launch_bounds__(1024)
    ctc_beta_kernel(const float* __restrict__ em,
                    const unsigned char* __restrict__ allow2_dst,
                    const float* __restrict__ beta_last,
                    float* __restrict__ out, int T, int N, int S) {
  extern __shared__ float sm[];
  float* prev = sm;
  float* cur = sm + S;
  unsigned char* a2 = reinterpret_cast<unsigned char*>(sm + 2 * S);
  const int n = blockIdx.x;
  const size_t last = ((size_t)(T - 1) * N + n) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float v = beta_last[(size_t)n * S + s];
    prev[s] = v;
    out[last + s] = v;
    a2[s] = allow2_dst[(size_t)n * S + s];
  }
  __syncthreads();
  for (int t = T - 2; t >= 0; --t) {
    const size_t row = ((size_t)t * N + n) * S;
    const float* e = em + row + (size_t)N * S;  // em[t + 1]
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float b0 = fmaxf(e[s] + prev[s], LOG_EPS);
      const float b1 = s + 1 < S ? fmaxf(e[s + 1] + prev[s + 1], LOG_EPS)
                                 : LOG_EPS;
      const float b2 = (s + 2 < S && a2[s])
                           ? fmaxf(e[s + 2] + prev[s + 2], LOG_EPS)
                           : LOG_EPS;
      const float v = fmaxf(lae3(b0, b1, b2), LOG_EPS);
      cur[s] = v;
      out[row + s] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

// Lanes route: grid N, a block of W = ceil(S / 32) <= kMaxWarps warps,
// thread s holding state s. em (T, N, S) f32; skip (N, S) bool bytes
// (allow2, betas allow2_dst); beta_last (N, S) f32 (betas only); out
// (T, N, S) f32. Step k makes frame k (alphas) or T - 2 - k (betas, whose
// frame T - 1 is beta_last).
template <bool kBeta, int kMaxWarps>
__global__ void __launch_bounds__(32 * kMaxWarps)
    ctc_lanes_kernel(const float* __restrict__ em,
                     const unsigned char* __restrict__ skip,
                     const float* __restrict__ beta_last,
                     float* __restrict__ out, int T, int N, int S) {
  // the values the two facing edge lanes of each warp send across the
  // seam, by frame parity: [.][w][0] from the lane next to the edge
  // (alphas lane 31, betas lane 0), [.][w][1] from the one beside it
  __shared__ float seam[2][kMaxWarps][2];
  const int s = threadIdx.x, lane = s & 31, warp = s >> 5;
  const int W = blockDim.x >> 5, n = blockIdx.x;
  const bool on = s < S;
  const size_t st = (size_t)N * S;
  const size_t at = (size_t)n * S + s;
  // r: the lane's distance from the edge its neighbours lie beyond
  // (alphas lane, betas 31 - lane); r < 2 receives across the seam, r >=
  // 30 sends
  const int r = kBeta ? 31 - lane : lane;
  const int from = kBeta ? warp + 1 : warp - 1;
  const bool has_from = from >= 0 && from < W;
  // the skip s - 2 -> s (betas s -> s + 2); never at s < 2 (s + 2 >= S)
  const bool sk = on && (kBeta ? s + 2 < S : s >= 2) && skip[at];
  // the emission of step k: alphas em[k] before `lae3`, betas em[T - 2 -
  // k] to form b after it (frame 0's is not needed), so steps k < E have
  // one. Each step moves the offsets of its load (PREFETCH steps ahead)
  // and of its store by one frame: no address arithmetic, and no branch,
  // stands between two steps of the chain.
  const int K = kBeta ? T - 1 : T, E = kBeta ? T - 2 : T;
  const long long dk = kBeta ? -(long long)st : (long long)st;
  long long o_out = (long long)(kBeta ? T - 2 : 0) * (long long)st + at;
  long long o_em = o_out;
  float ring[PREFETCH];
#pragma unroll
  for (int j = 0; j < PREFETCH; ++j, o_em += dk)
    ring[j] = on && j < E ? em[o_em] : LOG_EPS;
  // v: what a thread sends its neighbours, alpha(t - 1, s) or b(s) =
  // max(em[t + 1, s] + beta(t + 1, s), LOG_EPS)
  float v;
  if (kBeta) {
    const float last = on ? beta_last[at] : LOG_EPS;
    if (on) out[(size_t)(T - 1) * st + at] = last;
    v = fmaxf((on ? em[(size_t)(T - 1) * st + at] : LOG_EPS) + last,
              LOG_EPS);
  } else {
    v = s == 0 ? 0.f : LOG_EPS;
  }
  // the warp whose seam the edge lanes read (any valid one in one warp)
  const int fc = has_from ? from : warp;
  if (r >= 30) seam[1][warp][31 - r] = v;
  if (W > 1) __syncthreads();
  for (int k0 = 0; k0 < K; k0 += PREFETCH) {
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int k = k0 + j;
      if (k >= K) break;
      const float x = ring[j];
      ring[j] = on && k + PREFETCH < E ? em[o_em] : LOG_EPS;
      o_em += dk;
      float x1 = kBeta ? __shfl_down_sync(FULL, v, 1)
                       : __shfl_up_sync(FULL, v, 1);
      float x2 = kBeta ? __shfl_down_sync(FULL, v, 2)
                       : __shfl_up_sync(FULL, v, 2);
      // the edge lanes take the neighbouring warp's values of step k - 1;
      // every lane reads them (a broadcast), so that they are selects
      const float e0 = seam[(k + 1) & 1][fc][0];
      const float e1 = seam[(k + 1) & 1][fc][1];
      if (r == 0) x1 = has_from ? e0 : LOG_EPS;
      if (r < 2) x2 = !has_from ? LOG_EPS : r == 0 ? e1 : e0;
      if (!sk) x2 = LOG_EPS;
      float y;
      if (kBeta) {
        y = fmaxf(lae3(v, x1, x2), LOG_EPS);
        v = fmaxf(x + y, LOG_EPS);
      } else {
        y = fmaxf(x + lae3(v, x1, x2), LOG_EPS);
        v = y;
      }
      // a streaming store (evict first; see the note at the top)
      if (on) __stcs(out + o_out, y);
      o_out += dk;
      // step k's edge values go to seam[k & 1], read at step k + 1; the
      // barrier orders them, and step k + 2's writes after the reads
      if (W > 1) {
        if (r >= 30) seam[k & 1][warp][31 - r] = v;
        __syncthreads();
      }
    }
  }
}

// Frames route launch shape: one block per utterance, up to 1024 threads
// in whole warps; shared memory 9 bytes a state (above 48 KB only after the
// function attribute is raised).
template <typename K>
cudaError_t prepare(K kernel, int S, dim3& threads, size_t& smem) {
  threads = dim3(S >= 1024 ? 1024 : (S + 31) / 32 * 32);
  smem = (size_t)S * (2 * sizeof(float) + 1);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  return cudaSuccess;
}

// `ops/ctc.py` `chain_floor`: `steps` dependent steps of the recursion
// (`lae3` of a state and its two neighbours, two shuffles, an added weight
// and its floor) with no loads, one warp a block; out (N, 32) f32 keeps
// the states live.
__global__ void __launch_bounds__(32)
    chain_floor_kernel(float* __restrict__ out, int steps, float w) {
  const int lane = threadIdx.x;
  float v = -0.25f * lane;
  for (int k = 0; k < steps; ++k) {
    const float x1 = __shfl_up_sync(FULL, v, 1);
    const float x2 = __shfl_up_sync(FULL, v, 2);
    v = fmaxf(w + lae3(v, x1, x2), LOG_EPS);
  }
  out[blockIdx.x * 32 + lane] = v;
}

// The lanes route on `warps` warps a block, in the instantiation for its
// width.
template <bool kBeta>
cudaError_t launch_lanes(const float* em, const unsigned char* skip,
                         const float* last, float* out, int T, int N, int S,
                         int warps, cudaStream_t st) {
  if (warps <= LANES_NARROW_WARPS)
    ctc_lanes_kernel<kBeta, LANES_NARROW_WARPS><<<N, 32 * warps, 0, st>>>(
        em, skip, last, out, T, N, S);
  else
    ctc_lanes_kernel<kBeta, LANES_MAX_WARPS><<<N, 32 * warps, 0, st>>>(
        em, skip, last, out, T, N, S);
  return cudaGetLastError();
}

// The plan of `ops/ctc.py` `ctc_plan`: lanes on ceil(S / 32) warps up to
// 32 * LANES_MAX_WARPS states, else frames with 0.
bool plan_ok(int S, int route, int warps) {
  if (S <= 32 * LANES_MAX_WARPS)
    return route == LANES && warps == (S + 31) / 32;
  return route == FRAMES && warps == 0;
}

}  // namespace

// route, warps: the plan of `ops/ctc.py` `ctc_plan` (route 0 frames, 1
// lanes); any other plan for this S is refused.
extern "C" int ctc_alpha(const void* em, const void* allow2, void* out, int T,
                         int N, int S, int route, int warps, void* stream) {
  if (S <= 0 || !plan_ok(S, route, warps)) return cudaErrorInvalidValue;
  if (T <= 0 || N <= 0) return cudaSuccess;
  const auto* e = static_cast<const float*>(em);
  const auto* a2 = static_cast<const unsigned char*>(allow2);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (route == LANES)
    return launch_lanes<false>(e, a2, nullptr, o, T, N, S, warps, st);
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(ctc_alpha_kernel, S, threads, smem);
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<<<N, threads, smem, st>>>(e, a2, o, T, N, S);
  return cudaGetLastError();
}

extern "C" int ctc_beta(const void* em, const void* allow2_dst,
                        const void* beta_last, void* out, int T, int N, int S,
                        int route, int warps, void* stream) {
  if (S <= 0 || !plan_ok(S, route, warps)) return cudaErrorInvalidValue;
  if (T <= 0 || N <= 0) return cudaSuccess;
  const auto* e = static_cast<const float*>(em);
  const auto* a2 = static_cast<const unsigned char*>(allow2_dst);
  const auto* bl = static_cast<const float*>(beta_last);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (route == LANES)
    return launch_lanes<true>(e, a2, bl, o, T, N, S, warps, st);
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(ctc_beta_kernel, S, threads, smem);
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<<<N, threads, smem, st>>>(e, a2, bl, o, T, N, S);
  return cudaGetLastError();
}

// `steps` dependent steps of the recursion with no loads on N blocks of
// one warp; out (N, 32) f32; w a weight the compiler cannot fold.
extern "C" int ctc_chain_floor(void* out, int N, int steps, float w,
                               void* stream) {
  if (N <= 0) return cudaSuccess;
  chain_floor_kernel<<<N, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), steps, w);
  return cudaGetLastError();
}
