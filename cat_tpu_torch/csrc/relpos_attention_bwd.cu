// Relative-position (Transformer-XL) multi-head attention, backward.
// Replaces the TPU backward kernels of cat_tpu/ops/attention_pallas.py
// (`_bwd_kernel_packed`, `_bwd_kernel`, `_bwd_kernel_single`,
// `_bwd_kernel_decomp`, `_bwd_kernel_band`: one function).
//
// With qu = q + u, qv = q + v_bias, s[t,s'] = (qu_t . k_s' + qv_t .
// p[T-1-t+s']) * scale, probabilities P = exp(s - lse_t) (lse from the
// forward kernel), dropout keep mask K (the forward's, drawn again from
// Philox) and Delta_t = dO_t . O_t (computed by the wrapper):
//   dV = (P*K/(1-r))^T . dO
//   dS = P * ((dO . V^T) * K/(1-r) - Delta) * scale
//   dqu = dS . K_mat, dK = dS^T . qu,
//   dQP[t, T-1-t+s'] = dS[t, s'] (the rel-shift band read back),
//   dqv = dQP . p, dp = dQP^T . qv (summed over utterances),
//   dq = dqu + dqv, du = sum_t dqu, dv_bias = sum_t dqv.
//
// One block of 4 warps per (64-key tile, head, utterance) walks the query
// tiles up to the utterance's length; key tiles past the length only
// write zeros. dK and dV stay in registers (each warp 16 keys x Dh) for
// the whole walk. For a (query tile, key tile) pair each warp rebuilds
// its 16 x 64 scores as the forward does (content scores, and position
// scores over the 80 rows of the 127-row p window its queries need, the
// band read by index), then the block forms dS and the bf16 window
// gradient dQP (64 x 128) in shared memory. dq (f32), dp (f32, (2T-1, H,
// Dh)), du and dv_bias are sums over blocks that overlap, so they are
// added with f32 atomics into buffers the wrapper zeroed; the order of
// those sums varies from run to run. Padded query rows and keys past the
// length contribute exact zeros.
//
// What bounds it on the H100: per utterance of length L and head, about
// eight L x L x Dh products with the recomputed scores (16·L²·Dh FLOP);
// at the training batch (32 utterances of 299..493 frames, H = 8,
// Dh = 64) about 13 GFLOP, 0.013 ms at 989 TFLOP/s, against ~60 MB of
// q, k, v, p, dO and gradients, 0.018 ms at 3.35 TB/s: the atomics and
// the recompute keep this simple kernel far from either.
#include "common.cuh"

namespace {

using namespace catk;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NW = 4;
constexpr int WIN = BQ + BK;   // p window rows per tile pair (127 used)
constexpr int QPW = 80;        // window columns one warp needs
constexpr int LDS = BK + 4;    // f32 per-warp scores
constexpr int LDQP = QPW + 4;  // f32 per-warp position scores
constexpr int LDP = BK + 8;    // bf16 dropped probabilities, dS
constexpr int LDW = WIN + 8;   // bf16 window gradient dQP
constexpr float NEG = -1e30f;

template <int DH>
struct BwdSmem {
  static constexpr int LDT = DH + 8;
  static constexpr int TILE = align128(BQ * LDT * 2);
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = TILE;
  static constexpr int OFF_QU = 2 * TILE;
  static constexpr int OFF_QV = 3 * TILE;
  static constexpr int OFF_DO = 4 * TILE;
  static constexpr int OFF_P = 5 * TILE;
  static constexpr int OFF_PD = OFF_P + align128(WIN * LDT * 2);
  static constexpr int OFF_DS = OFF_PD + align128(BQ * LDP * 2);
  static constexpr int OFF_DQP = OFF_DS + align128(BQ * LDP * 2);
  static constexpr int OFF_ROW = OFF_DQP + align128(BQ * LDW * 2);
  static constexpr int OFF_WARP = OFF_ROW + align128(2 * BQ * 4);
  static constexpr int W_S = 0;
  static constexpr int W_QP = W_S + align128(16 * LDS * 4);
  static constexpr int W_SCR = W_QP + align128(16 * LDQP * 4);
  static constexpr int W_BYTES = W_SCR + 256 * 4;
  static constexpr int BYTES = OFF_WARP + NW * W_BYTES;
};

// Rows [row0, row0 + nrows) of a (rows, D) bf16 matrix, head slice
// [hoff, hoff + DH), into a shared tile; rows outside [0, limit) are zeros.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int nrows, int limit,
                                          int D, int hoff) {
  constexpr int LDT = BwdSmem<DH>::LDT;
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
    relpos_attn_bwd_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ p,
                           const bf16* __restrict__ ub,
                           const bf16* __restrict__ vb,
                           const int* __restrict__ lengths,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const bf16* __restrict__ dout,
                           float* __restrict__ dq, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, float* __restrict__ dp,
                           float* __restrict__ dub, float* __restrict__ dvb,
                           int T, int H, float scale, Drop dr) {
  using S = BwdSmem<DH>;
  constexpr int LDT = S::LDT;
  constexpr int NJ = DH / 16;
  constexpr int C8 = DH / 8;
  const int D = H * DH;
  const int s0 = blockIdx.x * BK, h = blockIdx.y, n = blockIdx.z;
  const int hoff = h * DH;
  const int len = lengths[n];
  const size_t base = (size_t)n * T * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (s0 >= len) {  // every key of the tile is padding: zero gradients
    const int rows = min(BK, T - s0);
    for (int i = threadIdx.x; i < rows * C8; i += NW * 32) {
      const size_t o = base + (size_t)(s0 + i / C8) * D + hoff + (i % C8) * 8;
      *reinterpret_cast<uint4*>(dk + o) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + o) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem + S::OFF_K);
  bf16* vs = reinterpret_cast<bf16*>(smem + S::OFF_V);
  bf16* qu = reinterpret_cast<bf16*>(smem + S::OFF_QU);
  bf16* qv = reinterpret_cast<bf16*>(smem + S::OFF_QV);
  bf16* dos = reinterpret_cast<bf16*>(smem + S::OFF_DO);
  bf16* pw = reinterpret_cast<bf16*>(smem + S::OFF_P);
  bf16* pds = reinterpret_cast<bf16*>(smem + S::OFF_PD);
  bf16* dss = reinterpret_cast<bf16*>(smem + S::OFF_DS);
  bf16* dqp = reinterpret_cast<bf16*>(smem + S::OFF_DQP);
  float* lse_s = reinterpret_cast<float*>(smem + S::OFF_ROW);
  float* dl_s = lse_s + BQ;
  unsigned char* wbase = smem + S::OFF_WARP + warp * S::W_BYTES;
  float* sc = reinterpret_cast<float*>(wbase + S::W_S);
  float* qp = reinterpret_cast<float*>(wbase + S::W_QP);
  float* scr = reinterpret_cast<float*>(wbase + S::W_SCR);

  load_rows<DH>(ks, k + base, s0, BK, T, D, hoff);
  load_rows<DH>(vs, v + base, s0, BK, T, D, hoff);

  FragC dk_acc[NJ], dv_acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  // lane pair (2r, 2r+1) owns query row r of the warp: columns [half, +32)
  const int r = lane >> 1, half = (lane & 1) * 32;
  const int win0 = (BQ - 16) - 16 * warp;  // first window row of this warp
  const uint32_t plane = (uint32_t)(n * H + h);
  const bf16* q_u = qu + warp * 16 * LDT;
  const bf16* q_v = qv + warp * 16 * LDT;

  for (int t0 = 0; t0 < len; t0 += BQ) {
    __syncthreads();  // the previous query tile is no longer read
    for (int i = threadIdx.x; i < BQ * C8; i += NW * 32) {
      const int rr = i / C8, c = (i % C8) * 8, t = t0 + rr;
      uint4 in = make_uint4(0, 0, 0, 0), g = make_uint4(0, 0, 0, 0), a, b;
      if (t < T) {
        const size_t o = base + (size_t)t * D + hoff + c;
        in = *reinterpret_cast<const uint4*>(q + o);
        g = *reinterpret_cast<const uint4*>(dout + o);
      }
      const bf16* hin = reinterpret_cast<const bf16*>(&in);
      bf16* ha = reinterpret_cast<bf16*>(&a);
      bf16* hb = reinterpret_cast<bf16*>(&b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float qf = __bfloat162float(hin[e]);
        ha[e] = __float2bfloat16(qf + __bfloat162float(ub[hoff + c + e]));
        hb[e] = __float2bfloat16(qf + __bfloat162float(vb[hoff + c + e]));
      }
      *reinterpret_cast<uint4*>(qu + rr * LDT + c) = a;
      *reinterpret_cast<uint4*>(qv + rr * LDT + c) = b;
      *reinterpret_cast<uint4*>(dos + rr * LDT + c) = g;
    }
    // window row j holds p[T-1-t0-(BQ-1)+s0+j]
    load_rows<DH>(pw, p, T - 1 - t0 - (BQ - 1) + s0, WIN, 2 * T - 1, D, hoff);
    if (threadIdx.x < BQ) {
      const int t = t0 + threadIdx.x;
      const bool ok = t < len;
      const size_t o = ((size_t)n * H + h) * T + t;
      lse_s[threadIdx.x] = ok ? lse[o] : 0.f;
      dl_s[threadIdx.x] = ok ? delta[o] : 0.f;
    }
    __syncthreads();

    // this warp's 16 x 64 content scores and 16 x 80 position scores
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

    const int t = t0 + 16 * warp + r;
    const bool row_ok = t < len;
    const float lse_r = lse_s[16 * warp + r], dl_r = dl_s[16 * warp + r];
    float pr[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = half + i;
      const float val = (sc[r * LDS + c] + qp[r * LDQP + c - r + 15]) * scale;
      pr[i] = (row_ok && s0 + c < len) ? __expf(val - lse_r) : 0.f;
    }
    __syncwarp();

    // dO . V^T for this warp's rows, into the score buffer
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      FragC c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < DH; kk += 16) {
        FragA a;
        FragBT b;
        wmma::load_matrix_sync(a, dos + warp * 16 * LDT + kk, LDT);
        wmma::load_matrix_sync(b, vs + j * 16 * LDT + kk, LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(sc + j * 16, c, LDS, wmma::mem_row_major);
    }
    __syncwarp();

#pragma unroll
    for (int i4 = 0; i4 < 32; i4 += 4) {
      const unsigned kb = keep4(dr, 0, plane, t, (s0 + half + i4) >> 2);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int i = i4 + e4;
        const float kf = keep_scale(dr, kb, e4);
        const float ds = pr[i] * (sc[r * LDS + half + i] * kf - dl_r) * scale;
        const int o = (16 * warp + r) * LDP + half + i;
        pds[o] = __float2bfloat16(pr[i] * kf);
        dss[o] = __float2bfloat16(ds);
      }
    }
    __syncthreads();

    // the window gradient: dQP[rb][m] = dS[rb][m - (BQ-1) + rb]
    for (int i = threadIdx.x; i < BQ * WIN; i += NW * 32) {
      const int rb = i / WIN, m = i % WIN, c = m - (BQ - 1) + rb;
      dqp[rb * LDW + m] =
          (c >= 0 && c < BK) ? dss[rb * LDP + c] : __float2bfloat16(0.f);
    }
    __syncthreads();

    // dq rows of this warp: dS . K and dQP . p_window, with du and dv_bias
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      FragC au, av;
      wmma::fill_fragment(au, 0.f);
      wmma::fill_fragment(av, 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, dss + warp * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(b, ks + kk * LDT + j * 16, LDT);
        wmma::mma_sync(au, a, b, au);
      }
#pragma unroll
      for (int kk = 0; kk < QPW; kk += 16) {
        FragA a;
        FragB b;
        wmma::load_matrix_sync(a, dqp + warp * 16 * LDW + win0 + kk, LDW);
        wmma::load_matrix_sync(b, pw + (win0 + kk) * LDT + j * 16, LDT);
        wmma::mma_sync(av, a, b, av);
      }
      wmma::store_matrix_sync(scr, au, 16, wmma::mem_row_major);
      __syncwarp();
      float uvals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) uvals[e] = scr[lane + 32 * e];
      if (lane < 16) {
        float s = 0.f;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) s += scr[rr * 16 + lane];
        atomicAdd(dub + hoff + j * 16 + lane, s);
      }
      __syncwarp();
      wmma::store_matrix_sync(scr, av, 16, wmma::mem_row_major);
      __syncwarp();
      if (lane < 16) {
        float s = 0.f;
#pragma unroll
        for (int rr = 0; rr < 16; ++rr) s += scr[rr * 16 + lane];
        atomicAdd(dvb + hoff + j * 16 + lane, s);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e, tq = t0 + 16 * warp + idx / 16;
        if (tq < len)
          atomicAdd(dq + base + (size_t)tq * D + hoff + j * 16 + idx % 16,
                    uvals[e] + scr[idx]);
      }
      __syncwarp();
    }

    // dV and dK of this warp's 16 keys, over the 64 queries of the tile
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {
      FragAT pa, sa;
      wmma::load_matrix_sync(pa, pds + kk * LDP + 16 * warp, LDP);
      wmma::load_matrix_sync(sa, dss + kk * LDP + 16 * warp, LDP);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragB bo, bq;
        wmma::load_matrix_sync(bo, dos + kk * LDT + j * 16, LDT);
        wmma::load_matrix_sync(bq, qu + kk * LDT + j * 16, LDT);
        wmma::mma_sync(dv_acc[j], pa, bo, dv_acc[j]);
        wmma::mma_sync(dk_acc[j], sa, bq, dk_acc[j]);
      }
    }

    // dp over this warp's 32 window rows: dQP^T . qv
    const int prow0 = T - 1 - t0 - (BQ - 1) + s0;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int m0 = 32 * warp + 16 * mi;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragC a;
        wmma::fill_fragment(a, 0.f);
#pragma unroll
        for (int kk = 0; kk < BQ; kk += 16) {
          FragAT da;
          FragB b;
          wmma::load_matrix_sync(da, dqp + kk * LDW + m0, LDW);
          wmma::load_matrix_sync(b, qv + kk * LDT + j * 16, LDT);
          wmma::mma_sync(a, da, b, a);
        }
        wmma::store_matrix_sync(scr, a, 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int prow = prow0 + m0 + e / 16;
          const float val = scr[e];
          if (val != 0.f && prow >= 0 && prow < 2 * T - 1)
            atomicAdd(dp + (size_t)prow * D + hoff + j * 16 + e % 16, val);
        }
        __syncwarp();
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      wmma::store_matrix_sync(scr, which ? dv_acc[j] : dk_acc[j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      bf16* dst = which ? dv : dk;
      for (int e = lane; e < 256; e += 32) {
        const int s = s0 + 16 * warp + e / 16;
        if (s < T)
          dst[base + (size_t)s * D + hoff + j * 16 + e % 16] =
              __float2bfloat16(scr[e]);
      }
      __syncwarp();
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const void* ub, const void* vb, const void* lengths,
                   const void* lse, const void* delta, const void* dout,
                   void* dq, void* dk, void* dv, void* dp, void* dub,
                   void* dvb, int N, int T, int H, float scale, Drop dr,
                   cudaStream_t stream) {
  constexpr int bytes = BwdSmem<DH>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      relpos_attn_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BK - 1) / BK, H, N);
  relpos_attn_bwd_kernel<DH><<<grid, NW * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p),
      static_cast<const bf16*>(ub), static_cast<const bf16*>(vb),
      static_cast<const int*>(lengths), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const bf16*>(dout),
      static_cast<float*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(dp),
      static_cast<float*>(dub), static_cast<float*>(dvb), T, H, scale, dr);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). q, k, v, dout, dk,
// dv (N, T, H*Dh) bf16; p (2T-1, H*Dh) bf16; lse, delta (N, H, T) f32;
// dq (N, T, H*Dh), dp (2T-1, H*Dh), dub, dvb (H*Dh) f32, zeroed by the
// caller (the kernel adds into them). Dh must be 16, 32, 64 or 128; the
// Python wrapper checks it and clamps lengths to [0, T]. Dropout as in
// relpos_attention_fwd (the same mask).
extern "C" int relpos_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* p,
                                    const void* ub, const void* vb,
                                    const void* lengths, const void* lse,
                                    const void* delta, const void* dout,
                                    void* dq, void* dk, void* dv, void* dp,
                                    void* dub, void* dvb, int N, int T, int H,
                                    int Dh, int seed0, int seed1, int thr,
                                    float scale, float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (N <= 0 || T <= 0) return cudaSuccess;
#define CATK_ATTN_BWD(DD)                                                     \
  launch<DD>(q, k, v, p, ub, vb, lengths, lse, delta, dout, dq, dk, dv, dp, \
             dub, dvb, N, T, H, scale, dr, s)
  switch (Dh) {
    case 16: return CATK_ATTN_BWD(16);
    case 32: return CATK_ATTN_BWD(32);
    case 64: return CATK_ATTN_BWD(64);
    case 128: return CATK_ATTN_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef CATK_ATTN_BWD
}
