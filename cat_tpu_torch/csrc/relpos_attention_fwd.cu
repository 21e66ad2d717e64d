// Relative-position (Transformer-XL) multi-head attention, forward (eval):
//
//   out[n,t,h] = sum_s softmax_s(((q_t + u) . k_s + (q_t + v) . p[T-1-t+s])
//                                * scale + keymask) v_s
//
// q, k, v, out (N, T, H*Dh) bf16, the projections' packed layout; p
// (2T-1, H*Dh) bf16, the projected sinusoid table; u, v biases (H*Dh) bf16;
// lengths (N,) int32: keys s >= lengths[n] are masked out. Query rows
// t >= lengths[n] are written as zeros (the caller zeroes them anyway).
//
// One block of 4 warps per (64-query tile, head, utterance); each warp owns
// 16 query rows. The block walks the key tiles of 64 up to the utterance's
// length with an online softmax in f32. For a (query tile, key tile) pair
// the relative positions T-1-t+s cover a window of 127 consecutive rows of
// p: the block loads those rows to shared memory, each warp computes
// (q + v) . p_win^T over the 80 window rows its 16 queries need, and reads
// the diagonal band bd[t, s] out of shared memory by index. No (T, T)
// score table reaches device memory, and there is no T <= 512 special case.
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NW = 4;
constexpr int WIN = BQ + BK;         // p rows loaded per tile pair (127 used)
constexpr int QPW = 80;              // window columns one warp needs
constexpr int LDS = BK + 4;          // f32 content scores
constexpr int LDQP = QPW + 4;        // f32 position scores
constexpr int LDP = BK + 8;          // bf16 probabilities
constexpr float NEG = -1e30f;

template <int DH>
struct AttnSmem {
  static constexpr int LDT = DH + 8;  // bf16 q/k/v/p tiles
  static constexpr int LDO = DH + 4;  // f32 output accumulator
  static constexpr int TILE = align128(BQ * LDT * 2);
  static constexpr int OFF_QU = 0;
  static constexpr int OFF_QV = OFF_QU + TILE;
  static constexpr int OFF_K = OFF_QV + TILE;
  static constexpr int OFF_V = OFF_K + TILE;
  static constexpr int OFF_P = OFF_V + TILE;
  static constexpr int OFF_WARP = OFF_P + align128(WIN * LDT * 2);
  static constexpr int W_S = 0;
  static constexpr int W_QP = W_S + align128(16 * LDS * 4);
  static constexpr int W_PB = W_QP + align128(16 * LDQP * 4);
  static constexpr int W_O = W_PB + align128(16 * LDP * 2);
  static constexpr int W_BYTES = W_O + align128(16 * LDO * 4);
  static constexpr int BYTES = OFF_WARP + NW * W_BYTES;
};

// Copy rows [row0, row0 + nrows) of a (rows, D) bf16 matrix, head slice
// [hoff, hoff + DH), into a shared tile; rows outside [0, limit) are zeros.
template <int DH>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows, int limit,
                                          int D, int hoff) {
  constexpr int LDT = AttnSmem<DH>::LDT;
  constexpr int C8 = DH / 8;
  for (int i = threadIdx.x; i < nrows * C8; i += NW * 32) {
    const int r = i / C8, c = (i % C8) * 8, row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row >= 0 && row < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + hoff + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

template <int DH>
__global__ void __launch_bounds__(NW * 32)
    relpos_attn_fwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ p,
                           const bf16* __restrict__ ub,
                           const bf16* __restrict__ vb,
                           const int* __restrict__ lengths,
                           bf16* __restrict__ out, int T, int H,
                           float scale) {
  using S = AttnSmem<DH>;
  constexpr int LDT = S::LDT, LDO = S::LDO;
  const int D = H * DH;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int hoff = h * DH;
  const int len = lengths[n];
  const size_t base = (size_t)n * T * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (t0 >= len) {  // every query row of the tile is padding
    constexpr int C8 = DH / 8;
    const int rows = min(BQ, T - t0);
    for (int i = threadIdx.x; i < rows * C8; i += NW * 32) {
      const int r = i / C8, c = (i % C8) * 8;
      *reinterpret_cast<uint4*>(out + base + (size_t)(t0 + r) * D + hoff +
                                c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qu = reinterpret_cast<bf16*>(smem + S::OFF_QU);
  bf16* qv = reinterpret_cast<bf16*>(smem + S::OFF_QV);
  bf16* ks = reinterpret_cast<bf16*>(smem + S::OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::OFF_V);
  bf16* pw = reinterpret_cast<bf16*>(smem + S::OFF_P);
  unsigned char* wbase = smem + S::OFF_WARP + warp * S::W_BYTES;
  float* sc = reinterpret_cast<float*>(wbase + S::W_S);
  float* qp = reinterpret_cast<float*>(wbase + S::W_QP);
  bf16* pb = reinterpret_cast<bf16*>(wbase + S::W_PB);
  float* os = reinterpret_cast<float*>(wbase + S::W_O);

  // query tile, with the two biases added in f32 and rounded to bf16
  {
    constexpr int C8 = DH / 8;
    for (int i = threadIdx.x; i < BQ * C8; i += NW * 32) {
      const int r = i / C8, c = (i % C8) * 8, t = t0 + r;
      uint4 in = make_uint4(0, 0, 0, 0), a, b;
      if (t < T)
        in = *reinterpret_cast<const uint4*>(q + base + (size_t)t * D +
                                             hoff + c);
      const bf16* hin = reinterpret_cast<const bf16*>(&in);
      bf16* ha = reinterpret_cast<bf16*>(&a);
      bf16* hb = reinterpret_cast<bf16*>(&b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float qf = __bfloat162float(hin[e]);
        ha[e] = __float2bfloat16(qf + __bfloat162float(ub[hoff + c + e]));
        hb[e] = __float2bfloat16(qf + __bfloat162float(vb[hoff + c + e]));
      }
      *reinterpret_cast<uint4*>(qu + r * LDT + c) = a;
      *reinterpret_cast<uint4*>(qv + r * LDT + c) = b;
    }
  }
  for (int i = lane; i < 16 * LDO; i += 32) os[i] = 0.f;

  // lane pair (2r, 2r+1) owns query row r of the warp: columns [half, +32)
  const int r = lane >> 1, half = (lane & 1) * 32;
  float m_run = NEG, l_run = 0.f;
  const bf16* q_u = qu + warp * 16 * LDT;
  const bf16* q_v = qv + warp * 16 * LDT;
  const int win0 = (BQ - 16) - 16 * warp;  // first window row of this warp

  for (int s0 = 0; s0 < len; s0 += BK) {
    __syncthreads();  // the previous key tile is no longer read
    load_tile<DH>(ks, k + base, s0, BK, T, D, hoff);
    load_tile<DH>(vs, v + base, s0, BK, T, D, hoff);
    // window row j holds p[T-1-t0-(BQ-1)+s0+j]
    load_tile<DH>(pw, p, T - 1 - t0 - (BQ - 1) + s0, WIN, 2 * T - 1, D, hoff);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, q_u + kk, LDT);
        wmma::load_matrix_sync(b, ks + j * 16 * LDT + kk, LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sc + j * 16, c, LDS, wmma::mem_row_major);
    }
#pragma unroll
    for (int j = 0; j < QPW / 16; ++j) {
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, q_v + kk, LDT);
        wmma::load_matrix_sync(b, pw + (win0 + j * 16) * LDT + kk, LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(qp + j * 16, c, LDQP, wmma::mem_row_major);
    }
    __syncwarp();

    // query t = t0 + 16*warp + r, key s = s0 + c: p row T-1-t+s is window
    // row (BQ-1) - 16*warp - r + c, i.e. column c - r + 15 of this warp's qp
    float sv[32];
    float tmax = NEG;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = half + i;
      float val = (sc[r * LDS + c] + qp[r * LDQP + c - r + 15]) * scale;
      val = (s0 + c < len) ? val : NEG;
      sv[i] = val;
      tmax = fmaxf(tmax, val);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);
    const float corr = __expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = __expf(sv[i] - m_new);
      psum += e;
      pb[r * LDP + half + i] = __float2bfloat16(e);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * corr + psum;
    m_run = m_new;
    for (int d = (lane & 1) * (DH / 2); d < (lane & 1) * (DH / 2) + DH / 2;
         ++d)
      os[r * LDO + d] *= corr;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < DH / 16; ++j) {
      FragC o;
      wmma::load_matrix_sync(o, os + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, pb + kk, LDP);
        wmma::load_matrix_sync(b, vs + kk * LDT + j * 16, LDT);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(os + j * 16, o, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = t0 + 16 * warp + r;
  if (t < T) {
    const float inv = (t < len) ? 1.f / l_run : 0.f;
    bf16* dst = out + base + (size_t)t * D + hoff;
    for (int d = (lane & 1) * (DH / 2); d < (lane & 1) * (DH / 2) + DH / 2;
         ++d)
      dst[d] = __float2bfloat16(os[r * LDO + d] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const void* ub, const void* vb, const void* lengths,
                   void* out, int N, int T, int H, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = AttnSmem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_attn_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H, N);
  relpos_attn_fwd_kernel<DH><<<grid, NW * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p),
      static_cast<const bf16*>(ub), static_cast<const bf16*>(vb),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), T, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Dh must be 16, 32, 64
// or 128; the Python wrapper checks it and clamps lengths to [0, T].
extern "C" int relpos_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* p,
                                    const void* ub, const void* vb,
                                    const void* lengths, void* out, int N,
                                    int T, int H, int Dh, float scale,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || T <= 0) return cudaSuccess;
  switch (Dh) {
    case 16: return launch<16>(q, k, v, p, ub, vb, lengths, out, N, T, H, scale, s);
    case 32: return launch<32>(q, k, v, p, ub, vb, lengths, out, N, T, H, scale, s);
    case 64: return launch<64>(q, k, v, p, ub, vb, lengths, out, N, T, H, scale, s);
    case 128: return launch<128>(q, k, v, p, ub, vb, lengths, out, N, T, H, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
