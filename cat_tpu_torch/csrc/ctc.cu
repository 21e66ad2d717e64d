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
// and `backward_betas_pallas`). The plain versions are
// `forward_alphas_reference` and `backward_betas_reference` in
// `ops/ctc.py`.
//
// What bounds it on the H100: at the crf-v1 training batch (T = 493, N =
// 32, S <= 247, f32) it reads the 15.6 MB emission table and writes the
// 15.6 MB of states, 9.3 us at 3.35 TB/s, but the T frames are dependent
// steps, each a read of the frame's emissions, a few exp/log and a
// barrier, so the latency of one step times T bounds it instead. The
// design: one block per utterance, its states across the threads (a
// thread takes states s, s + blockDim, ... so any S fits), the previous
// frame's states in shared memory, double-buffered so that each frame
// costs one barrier; every state reads its two or three neighbours from
// shared memory, with the same expf/logf arithmetic as the plain version.
#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e30f;

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

// Launch shape: one block per utterance, up to 1024 threads in whole
// warps; shared memory 9 bytes a state (above 48 KB only after the
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
    const float x1 = __shfl_up_sync(0xffffffffu, v, 1);
    const float x2 = __shfl_up_sync(0xffffffffu, v, 2);
    v = fmaxf(w + lae3(v, x1, x2), LOG_EPS);
  }
  out[blockIdx.x * 32 + lane] = v;
}

}  // namespace

extern "C" int ctc_alpha(const void* em, const void* allow2, void* out, int T,
                         int N, int S, void* stream) {
  if (T <= 0 || N <= 0 || S <= 0) return cudaSuccess;
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(ctc_alpha_kernel, S, threads, smem);
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(em), static_cast<const unsigned char*>(allow2),
      static_cast<float*>(out), T, N, S);
  return cudaGetLastError();
}

extern "C" int ctc_beta(const void* em, const void* allow2_dst,
                        const void* beta_last, void* out, int T, int N, int S,
                        void* stream) {
  if (T <= 0 || N <= 0 || S <= 0) return cudaSuccess;
  dim3 threads;
  size_t smem;
  cudaError_t err = prepare(ctc_beta_kernel, S, threads, smem);
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<<<N, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(em),
      static_cast<const unsigned char*>(allow2_dst),
      static_cast<const float*>(beta_last), static_cast<float*>(out), T, N, S);
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
