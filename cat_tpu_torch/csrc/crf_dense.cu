// The dense CTC-CRF denominator: its forward alpha recursion, and its
// backward (recompute, beta recursion and gradient rows), each one launch.
//
// State space {in-phone, post-blank} x (context a, b) over V classes (0 =
// blank, also BOS), alphas a_in, a_bl (V, V) per utterance, log domain.
// One frame with log-probs y (`_alpha_step` of `ops/crf_dense.py`):
//   T_src[b, u] = LSE_a(src[a, b] + W[a, b, u]) = m[b] + log sum_a
//                 exp(src[a, b] - m[b]) expW[a, b, u],  m[b] = max_a src
//   emit0[b, u] = LAE(T_bl[b, u], b != u ? T_in[b, u] : LOG_EPS)
//   a_in'[b, u] = max(LAE(a_in[b, u] + y[u], emit0[b, u] + y[u]), LOG_EPS)
//   a_bl'[b, u] = max(LAE(a_in[b, u], a_bl[b, u]) + y[0], LOG_EPS)
// for t < T_n (later frames keep the alphas); logZ = LAE over both
// tensors of alpha + F. The backward is the recursion of `_den_bwd`
// (`cat_tpu/ops/crf_dense.py:321`) with betas from F, the contraction
// E[a, b] = LSE_u(rhs[b, u] + W[a, b, u]), rhs[b, u] = y[u] + b_in[b, u],
// and each frame's gradient row the posterior of its stay, emission and
// blank transitions, exp(alpha + y + beta - logZ), summed per class.
//
// Replaces the TPU kernel `_den_fwd_kernel` of
// `cat_tpu/ops/crf_dense_pallas.py` (`pallas_call` in
// `dense_den_forward_pallas`) and, for the backward, which has no TPU
// kernel, the XLA scan `_den_bwd`. Unlike the TPU kernel it runs in the
// log domain with the per-(utterance, b) max shift of the plain version
// (`den_forward_reference`): exp-domain alphas rescaled per frame floor
// states more than ~87 nats below the maximum, and a backward that
// recomputes from such snapshots departs from the plain one.
//
// What bounds it on the H100: operations, at first count. At the crf-v1
// training batch (N = 32, T' <= 493 of 12,664 valid frames, V = 72) the
// forward's two emission contractions are 2 x 2 x 72^3 FLOP a frame, 18.9
// GFLOP, 0.28 ms at the 67 TFLOP/s f32 rate without tensor cores; its
// bytes (log-probs, 2 x 21 snapshots of (32, 72, 72), W) are 34 MB, 10 us.
// The backward recomputes the forward and adds the beta contraction, about
// twice that. Both also have T' dependent steps. The design: one block per
// utterance (32 of the 132 SMs), the (V, V) alphas (and betas) held in
// shared memory across the frames, the exp-domain products p = exp(src -
// m) built there once a frame, and expW (1.5 MB f32) read by every block
// every frame from L2, coalesced along u (along b for the beta
// contraction, which reads a transposed copy). Frames past an utterance's
// length are skipped. The backward walks the K-frame segments in reverse:
// it recomputes a segment's pre-update alphas and emission terms from its
// snapshot into a device scratch (K x 3 x V^2 f32 per utterance), then
// runs the beta step and the gradient row frame by frame. Neither the
// idle SMs nor the L2 traffic is addressed yet.
#include <cuda_runtime.h>

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr float LOWEST = -3.0e38f;  // below every state: a max's start

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m <= LOG_EPS / 2 ? LOG_EPS : m + logf(expf(a - m) + expf(b - m));
}

__device__ __forceinline__ float posterior(float score) {
  return score <= LOG_EPS / 2 ? 0.f : expf(score);
}

__device__ __forceinline__ float from_sum(float m, float s) {
  return s <= 0.f ? LOG_EPS : m + logf(fmaxf(s, 1e-37f));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max (is_max) or sum of v; blockDim.x a multiple of 32, `red`
// 33 floats of shared memory. Every thread gets the result.
__device__ float block_reduce(float v, bool is_max, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  v = is_max ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nw ? red[lane] : (is_max ? LOWEST : 0.f);
    w = is_max ? warp_max(w) : warp_sum(w);
    if (lane == 0) red[32] = w;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();
  return out;
}

// Shared memory of one block: `n2` (V, V) tensors, then three V-vectors
// and the reduction buffer.
struct Smem {
  float* t[6];
  float *m0, *m1, *y, *red;
  __device__ Smem(float* base, int V, int n2) {
    const int VV = V * V;
    for (int i = 0; i < n2; ++i) t[i] = base + i * VV;
    m0 = base + n2 * VV;
    m1 = m0 + V;
    y = m1 + V;
    red = y + V;
  }
};

size_t smem_bytes(int V, int n2) {
  return sizeof(float) * ((size_t)n2 * V * V + 3 * V + 33);
}

// One frame of the alpha recursion on the alphas in shared memory (all
// threads; ends with a barrier). With `scr`, the pre-update a_in, a_bl
// and the emission term emit0 go to scr[0 : V^2], [V^2 : 2V^2],
// [2V^2 : 3V^2].
__device__ void alpha_frame(float* a_in, float* a_bl, float* p_bl,
                            float* p_in, float* m_bl, float* m_in, float* ys,
                            const float* __restrict__ w,
                            const float* __restrict__ yrow, int V,
                            float* __restrict__ scr) {
  const int VV = V * V, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  if (tid < V) ys[tid] = yrow[tid];
  for (int col = warp; col < 2 * V; col += nw) {
    const float* src = col < V ? a_bl : a_in;
    const int b = col < V ? col : col - V;
    float m = LOWEST;
    for (int a = lane; a < V; a += 32) m = fmaxf(m, src[a * V + b]);
    m = warp_max(m);
    if (lane == 0) (col < V ? m_bl : m_in)[b] = fmaxf(m, LOG_EPS);
  }
  __syncthreads();
  for (int i = tid; i < VV; i += nt) {
    const int b = i % V;
    p_bl[i] = expf(a_bl[i] - m_bl[b]);
    p_in[i] = expf(a_in[i] - m_in[b]);
  }
  __syncthreads();
  const float y0 = ys[0];
  for (int i = tid; i < VV; i += nt) {
    const int b = i / V, u = i - b * V;
    const float* wp = w + b * V + u;  // W[a, b, u] = wp[a * V^2]
    float s_bl = 0.f, s_in = 0.f;
#pragma unroll 8
    for (int a = 0; a < V; ++a) {
      const float wv = __ldg(wp + (size_t)a * VV);
      s_bl = fmaf(p_bl[a * V + b], wv, s_bl);
      s_in = fmaf(p_in[a * V + b], wv, s_in);
    }
    const float t_bl = from_sum(m_bl[b], s_bl);
    const float t_in = b == u ? LOG_EPS : from_sum(m_in[b], s_in);
    const float e0 = lae(t_bl, t_in);
    const float ai = a_in[i], ab = a_bl[i], yu = ys[u];
    if (scr != nullptr) {
      scr[i] = ai;
      scr[VV + i] = ab;
      scr[2 * VV + i] = e0;
    }
    a_in[i] = fmaxf(lae(ai + yu, e0 + yu), LOG_EPS);
    a_bl[i] = fmaxf(lae(ai, ab) + y0, LOG_EPS);
  }
  __syncthreads();
}

__device__ void init_alphas(float* a_in, float* a_bl, int VV) {
  for (int i = threadIdx.x; i < VV; i += blockDim.x) {
    a_in[i] = LOG_EPS;
    a_bl[i] = i == 0 ? 0.f : LOG_EPS;
  }
  __syncthreads();
}

// lp (N, T, V) f32, lens (N,) int64, w = expW (V, V, V), fin = F (V, V);
// snap_in, snap_bl (S, N, V, V) with S = ceil(T / K); logz (N,).
__global__ void __launch_bounds__(1024)
    den_fwd_kernel(const float* __restrict__ lp,
                   const long long* __restrict__ lens,
                   const float* __restrict__ w, const float* __restrict__ fin,
                   float* __restrict__ snap_in, float* __restrict__ snap_bl,
                   float* __restrict__ logz, int N, int T, int V, int K) {
  extern __shared__ float smem[];
  Smem sh(smem, V, 4);
  float *a_in = sh.t[0], *a_bl = sh.t[1];
  const int VV = V * V, n = blockIdx.x;
  const int len = (int)min((long long)T, max(0LL, lens[n]));
  init_alphas(a_in, a_bl, VV);
  for (int t = 0; t < T; ++t) {
    if (t % K == 0) {
      const size_t off = ((size_t)(t / K) * N + n) * VV;
      for (int i = threadIdx.x; i < VV; i += blockDim.x) {
        snap_in[off + i] = a_in[i];
        snap_bl[off + i] = a_bl[i];
      }
    }
    if (t < len)
      alpha_frame(a_in, a_bl, sh.t[2], sh.t[3], sh.m0, sh.m1, sh.y, w,
                  lp + ((size_t)n * T + t) * V, V, nullptr);
  }
  float lse[2];
  for (int k = 0; k < 2; ++k) {
    const float* a = k == 0 ? a_in : a_bl;
    float m = LOWEST;
    for (int i = threadIdx.x; i < VV; i += blockDim.x)
      m = fmaxf(m, a[i] + fin[i]);
    m = fmaxf(block_reduce(m, true, sh.red), LOG_EPS);
    float s = 0.f;
    for (int i = threadIdx.x; i < VV; i += blockDim.x)
      s += expf(a[i] + fin[i] - m);
    lse[k] = from_sum(m, block_reduce(s, false, sh.red));
  }
  if (threadIdx.x == 0) logz[n] = lae(lse[0], lse[1]);
}

// The backward. wt = expW transposed to (u, a, b); g (N,) the incoming
// gradient; grad (N, T, V) out; scratch N x K x 3 x V^2 f32.
__global__ void __launch_bounds__(1024)
    den_bwd_kernel(const float* __restrict__ lp,
                   const long long* __restrict__ lens,
                   const float* __restrict__ w, const float* __restrict__ wt,
                   const float* __restrict__ fin,
                   const float* __restrict__ snap_in,
                   const float* __restrict__ snap_bl,
                   const float* __restrict__ logz, const float* __restrict__ g,
                   float* __restrict__ grad, float* __restrict__ scratch,
                   int N, int T, int V, int K) {
  extern __shared__ float smem[];
  Smem sh(smem, V, 6);
  float *a_in = sh.t[0], *a_bl = sh.t[1], *b_in = sh.t[2], *b_bl = sh.t[3];
  float *p0 = sh.t[4], *p1 = sh.t[5];
  const int VV = V * V, n = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int len = (int)min((long long)T, max(0LL, lens[n]));
  const float lz = logz[n] <= LOG_EPS / 2 ? 0.f : logz[n];
  const float gn = g[n];
  float* grow = grad + (size_t)n * T * V;
  float* scr = scratch + (size_t)n * K * 3 * VV;
  for (int i = len * V + tid; i < T * V; i += nt) grow[i] = 0.f;
  for (int i = tid; i < VV; i += nt) b_in[i] = b_bl[i] = fin[i];
  __syncthreads();
  const int S = (T + K - 1) / K;
  for (int seg = S - 1; seg >= 0; --seg) {
    const int t0 = seg * K;
    if (t0 >= len) continue;
    const int t1 = min(t0 + K, len);
    const size_t off = ((size_t)seg * N + n) * VV;
    for (int i = tid; i < VV; i += nt) {
      a_in[i] = snap_in[off + i];
      a_bl[i] = snap_bl[off + i];
    }
    __syncthreads();
    for (int t = t0; t < t1; ++t)
      alpha_frame(a_in, a_bl, p0, p1, sh.m0, sh.m1, sh.y, w,
                  lp + ((size_t)n * T + t) * V, V,
                  scr + (size_t)(t - t0) * 3 * VV);
    for (int t = t1 - 1; t >= t0; --t) {
      const float* pre = scr + (size_t)(t - t0) * 3 * VV;
      if (tid < V) sh.y[tid] = lp[((size_t)n * T + t) * V + tid];
      __syncthreads();
      const float* ys = sh.y;
      const float y0 = ys[0];
      // the gradient row: per element, stay + emission into (x, u) and
      // the blank transition out of (x, u)
      for (int i = tid; i < VV; i += nt) {
        const int u = i % V;
        const float ai = pre[i], ab = pre[VV + i], e0 = pre[2 * VV + i];
        const float bi = b_in[i], yu = ys[u];
        p0[i] = posterior(ai + yu + bi - lz) + posterior(e0 + yu + bi - lz);
        p1[i] = posterior(lae(ai, ab) + y0 + b_bl[i] - lz);
      }
      __syncthreads();
      for (int u = tid; u < V; u += nt) {
        float s0 = 0.f, s1 = 0.f;
        for (int x = 0; x < V; ++x) {
          s0 += p0[x * V + u];
          s1 += p1[x * V + u];
        }
        if (u > 0) grow[(size_t)t * V + u] = s0 * gn;
        sh.m0[u] = s1;
      }
      // the maxima over u of rhs[b, u] = y[u] + b_in[b, u], over all u
      // (m1) and over u != b (red, V values after the first 33)
      float* m_nr = sh.red + 33;
      for (int b = warp; b < V; b += nw) {
        float ma = LOWEST, mn = LOWEST;
        for (int u = lane; u < V; u += 32) {
          const float r = ys[u] + b_in[b * V + u];
          ma = fmaxf(ma, r);
          mn = fmaxf(mn, u == b ? LOG_EPS : r);
        }
        ma = warp_max(ma);
        mn = warp_max(mn);
        if (lane == 0) {
          sh.m1[b] = fmaxf(ma, LOG_EPS);
          m_nr[b] = fmaxf(mn, LOG_EPS);
        }
      }
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int u = 0; u < V; ++u) s += sh.m0[u];
        grow[(size_t)t * V] = s * gn;
      }
      // p0[u, b] = exp(rhs[b, u] - m1[b]); p1 the same with u = b barred
      for (int i = tid; i < VV; i += nt) {
        const int b = i / V, u = i - b * V;
        const float r = ys[u] + b_in[i];
        p0[u * V + b] = expf(r - sh.m1[b]);
        p1[u * V + b] = expf((u == b ? LOG_EPS : r) - m_nr[b]);
      }
      __syncthreads();
      // the betas before frame t, at (a, b)
      for (int i = tid; i < VV; i += nt) {
        const int a = i / V, b = i - a * V;
        const float* wp = wt + (size_t)a * V + b;  // W[a, b, u] = wp[u V^2]
        float s_all = 0.f, s_nr = 0.f;
#pragma unroll 8
        for (int u = 0; u < V; ++u) {
          const float wv = __ldg(wp + (size_t)u * VV);
          s_all = fmaf(p0[u * V + b], wv, s_all);
          s_nr = fmaf(p1[u * V + b], wv, s_nr);
        }
        const float e_all = from_sum(sh.m1[b], s_all);
        const float e_nr = from_sum(m_nr[b], s_nr);
        const float stay = ys[b] + b_in[i];
        const float blank = y0 + b_bl[i];
        b_in[i] = fmaxf(lae(lae(stay, e_nr), blank), LOG_EPS);
        b_bl[i] = fmaxf(lae(e_all, blank), LOG_EPS);
      }
      __syncthreads();
    }
  }
}

int threads_for(int V) {
  // the fewest passes over the V^2 elements, in as few warps as that needs
  const int VV = V * V;
  const int passes = (VV + 1023) / 1024;
  const int per = (VV + passes - 1) / passes;
  return (per + 31) / 32 * 32;
}

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t bytes) {
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int den_fwd(const void* lp, const void* lens, const void* w,
                       const void* fin, void* snap_in, void* snap_bl,
                       void* logz, int N, int T, int V, int K, void* stream) {
  if (N <= 0 || T <= 0) return cudaSuccess;
  if (V <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(V, 4);
  cudaError_t err = set_smem(den_fwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  den_fwd_kernel<<<N, threads_for(V), bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const long long*>(lens),
      static_cast<const float*>(w), static_cast<const float*>(fin),
      static_cast<float*>(snap_in), static_cast<float*>(snap_bl),
      static_cast<float*>(logz), N, T, V, K);
  return cudaGetLastError();
}

extern "C" int den_bwd(const void* lp, const void* lens, const void* w,
                       const void* wt, const void* fin, const void* snap_in,
                       const void* snap_bl, const void* logz, const void* g,
                       void* grad, void* scratch, int N, int T, int V, int K,
                       void* stream) {
  if (N <= 0 || T <= 0) return cudaSuccess;
  if (V <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(V, 6) + sizeof(float) * V;  // + m_nr
  cudaError_t err = set_smem(den_bwd_kernel, bytes);
  if (err != cudaSuccess) return err;
  den_bwd_kernel<<<N, threads_for(V), bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp), static_cast<const long long*>(lens),
      static_cast<const float*>(w), static_cast<const float*>(wt),
      static_cast<const float*>(fin), static_cast<const float*>(snap_in),
      static_cast<const float*>(snap_bl), static_cast<const float*>(logz),
      static_cast<const float*>(g), static_cast<float*>(grad),
      static_cast<float*>(scratch), N, T, V, K);
  return cudaGetLastError();
}
