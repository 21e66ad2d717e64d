// Relative-position (Transformer-XL) multi-head attention, backward.
// Replaces the TPU backward kernels of cat_tpu/ops/attention_pallas.py
// (`_bwd_kernel_packed` :624, `pallas_call` at :783, and `_bwd_kernel`,
// `_bwd_kernel_single`, `_bwd_kernel_decomp`, `_bwd_kernel_band`: one
// function).
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
// Padded query rows and keys past the length contribute exact zeros.
//
// What bounds it on the H100: per utterance of length L and head, about
// eight L x L x Dh products with the recomputed scores (16·L²·Dh FLOP);
// at the training batch (32 utterances of 299..493 frames, H = 8,
// Dh = 64) about 42 GFLOP, 0.042 ms at 989 TFLOP/s, against ~60 MB of
// q, k, v, p, dO and gradients, 0.018 ms at 3.35 TB/s. dq, dp, du and
// dv_bias are sums over keys for a fixed query; dK and dV sums over
// queries for a fixed key; the band couples both to the table p. Two
// routes, chosen by the head dimension (`bwd_route` in ops/attention.py):
//
// Dh = 64 (every recipe of the repo), three launches, no atomics, the
// same bits on every call:
// 1. `d64::relpos_attention_bwd_dq_wgmma`, the forward's flash kernel
//    (relpos_attention_fwd.cu) turned to the gradients of the query side:
//    one block of 384 threads per (128-query tile, head, utterance),
//    warp 0 loading Q and dO once and K, V and the 192-row position
//    window per key tile through a ring of two TMA stages, consumer
//    warpgroup w owning query rows 64w .. 64w + 63. Per key tile it
//    issues QP = qv·Pwinᵀ (m64n128), reads the band back through
//    per-warp f32 scratch, then S = qu·Kᵀ and dP = dO·Vᵀ (m64n64), forms
//    P from lse and dS on the fragments (the forward's Philox keep bits),
//    scatters dS into its 64 x 128 bf16 window gradient dQP in shared
//    memory (dQP[r, c - r + 63] = dS[r, c], zeros elsewhere; it lies over
//    the band scratch, which is free by then), and issues dqu += dS·K (dS
//    as the register A operand), dqv += dQP·Pwin and the dp window
//    dQPᵀ·qv (dQP read MN-major). The dp window spans 128 table rows from
//    T-64-r0+s0; the next key tile's starts 64 rows further, so after
//    each key tile the lower 64 rows are final and go to the consumer's
//    workspace slot, and the upper 64 wait in shared memory (each thread
//    its own fragment) as the next tile's lower half. dqu and dqv (64
//    registers) stay in registers across the walk; QP, then S with dP,
//    then the products (64 accumulator registers each at most) come on
//    top (ptxas: 168 registers a thread, a few hundred bytes of spills).
//    At the end it writes dq in bf16, the last 64 dp rows, and the column
//    sums of dqu and dqv (du and dv_bias partials). The coordinates are
//    `bwd_plan` of ops/attention.py,
//    checked on the CPU by a blocked emulation
//    (tests/test_torch_attn_bwd_plan.py).
// 2. `d64::relpos_attention_bwd_reduce`: dp, du and dv_bias, the slots'
//    partials summed in a fixed order (utterance, then sub-tile).
// 3. `d64::relpos_attention_bwd_dkdv_wgmma`: dK and dV, key-major. One
//    block of 384 threads per (128-key tile, head, utterance): warp 0
//    loads the block's K and V once and, per 64-query tile, Q, dO and
//    the 192-row position window through a ring of two TMA stages;
//    consumer warpgroup w owns keys 64w .. 64w + 63 and keeps dK and dV
//    (m64n64 f32, 64 registers) in registers for the whole walk over the
//    query tiles, so each block writes its own rows once. Per query tile
//    it works in the dq pass's (query-major) orientation, with its code:
//    it forms qu and qv from the stage's Q into its own buffers, issues
//    QP = qv·Pwinᵀ and reads the band back through its scratch, issues
//    S = qu·Kᵀ and dP = dO·Vᵀ, and forms P (the forward's bits), Pd =
//    P·keep/(1-r) and dS on the fragments. Only the two bf16 tiles Pd and
//    dS, [query][key] in the 128-byte swizzled layout, change
//    orientation: through shared memory, read MN-major as the A operand
//    of dV += Pdᵀ·dO and dK += dSᵀ·qu (dO and qu MN-major B operands).
//    Query t0 + r and key s0 + 64w + c read table row T-64-t0+s0 + 64w +
//    c - r + 63, column c - r + 63 of the consumer's 128-row window
//    (`bwd_kv_plan`, pinned by the same emulation).
//
// Dh = 16, 32, 128: `relpos_attention_bwd_wmma`. One block of 4 warps
// per (64-key tile, head, utterance) walks the query tiles up to the
// utterance's length; key tiles past the length only write zeros. dK and
// dV stay in registers (each warp 16 keys x Dh) for the whole walk. For a
// (query tile, key tile) pair each warp rebuilds its 16 x 64 scores as
// the forward does (content scores, and position scores over the 80 rows
// of the 127-row p window its queries need, the band read by index), then
// the block forms dS and the bf16 window gradient dQP (64 x 128) in
// shared memory and adds dq (f32), dp (f32, (2T-1, H, Dh)), du and
// dv_bias, sums over blocks that overlap, with f32 atomics into buffers
// the wrapper zeroed; the order of those sums varies from run to run.
#include "common.cuh"
#include "hopper_gemm.cuh"

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
// Shared memory of the wmma kernel.
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
  constexpr int LDT = DH + 8;
  constexpr int C8 = DH / 8;
  for (int i = threadIdx.x; i < nrows * C8; i += NW * 32) {
    const int r = i / C8, c = (i % C8) * 8, row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row >= 0 && row < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)row * D + hoff + c);
    *reinterpret_cast<uint4*>(dst + r * LDT + c) = val;
  }
}

// dK and dV from registers; dq, dp, du and dv_bias added with atomics.
template <int DH>
__global__ void __launch_bounds__(NW * 32)
    relpos_attention_bwd_wmma(const bf16* __restrict__ q,
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
cudaError_t launch_wmma(const void* q, const void* k, const void* v,
                        const void* p, const void* ub, const void* vb,
                        const void* lengths, const void* lse,
                        const void* delta, const void* dout, void* dq,
                        void* dk, void* dv, void* dp, void* dub, void* dvb,
                        int N, int T, int H, float scale, Drop dr,
                        cudaStream_t stream) {
  constexpr int bytes = BwdSmem<DH>::BYTES;
  CATK_TRY(cudaFuncSetAttribute(relpos_attention_bwd_wmma<DH>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes));
  dim3 grid((T + BK - 1) / BK, H, N);
  relpos_attention_bwd_wmma<DH><<<grid, NW * 32, bytes, stream>>>(
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

// ---- Dh = 64: the dq pass and the dK/dV pass on TMA + wgmma, and the
// reduce (see the top of the file)
namespace d64 {

constexpr int DH = 64;
constexpr int BQ = 128;        // query rows a block
constexpr int BKEY = 64;       // keys a tile
constexpr int BOX = 64 * 128;  // bytes of a 64-row box of one head slice
constexpr int STAGES = 2;
// a stage: K, V, then the p window of 3 boxes (192 rows)
constexpr int STAGE = 5 * BOX;
// f32 band scratch: a warp's 16 rows of the 80 QP columns its band reads
// (window columns 48 - 16·warp .. 127 - 16·warp); the stride (24 mod 32)
// keeps the 8-byte stores free of bank conflicts
constexpr int LDB = 88;
constexpr int OFF_QU = 0;                     // 128 rows of qu
constexpr int OFF_QV = OFF_QU + 2 * BOX;      // 128 rows of qv
constexpr int OFF_DO = OFF_QV + 2 * BOX;      // 128 rows of dO
constexpr int OFF_STAGE = OFF_DO + 2 * BOX;
// a consumer's four warps' band scratch; once the band is read, the
// consumer's window gradient dQP (64 query rows x 128 window columns,
// bf16, two 64-column boxes in the 128-byte swizzled layout) lies over
// its first 16 KB
constexpr int SCRATCH = 4 * 16 * LDB * 4;  // a multiple of 1 KB
constexpr int OFF_SCRATCH = OFF_STAGE + STAGES * STAGE;
// the lower half of each consumer's dp window, 32 f32 a thread, kept
// thread-private (element i of thread t at i·128 + t)
constexpr int OFF_CARRY = OFF_SCRATCH + 2 * SCRATCH;
constexpr int OFF_BAR = OFF_CARRY + 2 * 128 * 32 * 4;
// 1 KB to align the start; barriers: Q and dO, then full and empty per
// stage
constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);

// The dK/dV pass's shared memory, from the same 1 KB-aligned base.
namespace kv {
constexpr int OFF_K = 0;                // the block's 128 keys: two boxes
constexpr int OFF_V = OFF_K + 2 * BOX;  // and their values
// a stage: Q, dO, then the p window of 3 boxes (192 rows), STAGE bytes
constexpr int OFF_STAGE = OFF_V + 2 * BOX;
// per consumer: qu and qv (64 query rows each), then the Pd and dS tiles
// (64 query rows x 64 keys), each one box in the 128-byte swizzled layout
constexpr int OFF_QUV = OFF_STAGE + STAGES * STAGE;
constexpr int OFF_PDS = OFF_QUV + 4 * BOX;
// per consumer: its four warps' band scratch, as the dq pass's
constexpr int OFF_SCRATCH = OFF_PDS + 4 * BOX;
constexpr int OFF_BAR = OFF_SCRATCH + 2 * SCRATCH;
// barriers: K and V, then full and empty per stage
constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);
static_assert(SMEM <= 232448, "the dK/dV pass exceeds a block's 227 KB");
}  // namespace kv

// Zeros in rows [ta, tb) of the head slice of a (N·T, H·Dh) bf16 matrix
// whose utterance starts at row0.
__device__ __forceinline__ void zero_rows(bf16* x, size_t row0, int D,
                                          int hoff, int ta, int tb, int tid,
                                          int nthreads) {
  for (int i = tid; i < (tb - ta) * (DH / 8); i += nthreads) {
    const int t = ta + i / (DH / 8), c = (i % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(x + (row0 + t) * D + hoff + c) =
        make_uint4(0, 0, 0, 0);
  }
}

// Stores the bf16 pair `pair` at row r, columns c and c + 1 (c even), of
// a 64 x 64 bf16 tile in the 128-byte swizzled layout that TMA writes:
// 16-byte chunk j of row r at chunk j ^ (r % 8).
__device__ __forceinline__ void store_pair(unsigned char* tile, int r, int c,
                                           uint32_t pair) {
  *reinterpret_cast<uint32_t*>(tile + r * 128 + (((c >> 3) ^ (r & 7)) << 4) +
                               (c & 7) * 2) = pair;
}

// Issues d (64 x 64 f32 fragment) += aᵀ·b, a and b two 64 x 64 bf16 tiles
// in shared memory (64 rows of the summed index, 128-byte swizzled; a
// tile whose columns are the M index, b whose columns are the N index),
// both read MN-major, a k16 slice 16 rows (2 KB) further. The caller
// fences and commits.
__device__ __forceinline__ void mn_product(float (&d)[32], uint32_t a,
                                           uint32_t b) {
  const uint64_t da = hg::desc(a, 8192, 1024), db = hg::desc(b, 8192, 1024);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    hg::wgmma_n64<1, 1>(d, da + ((k * 2048) >> 4), db + ((k * 2048) >> 4), 1);
}

// The 64 x 64 f32 fragment `a` (rows of this consumer's warps) to rows
// row .. row + 63 of the workspace, columns hoff ..
__device__ __forceinline__ void store_rows(float* ws, size_t row, int D,
                                           int hoff, const float (&a)[32]) {
  const int t = threadIdx.x & 127;
  const int r = (t >> 5) * 16 + ((t & 31) >> 2), c = hoff + 2 * (t & 3);
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    float* dst = ws + (row + r + 8 * ih) * D + c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(a[4 * j + 2 * ih], a[4 * j + 2 * ih + 1]);
  }
}

// Workspace: slot j (query rows 64j ..) of utterance n holds SR = 64·J +
// 64 rows (J = ceil(T/64)) of H·Dh f32 from row (n·J + j)·SR: table rows
// T-64-64j .. (`bwd_slot_rows`); wdu, wdv: row n·J + j, the column sums
// of dqu and dqv over the slot's query rows.
__global__ void __launch_bounds__(hg::THREADS, 1)
    relpos_attention_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq,
                                  const __grid_constant__ CUtensorMap mk,
                                  const __grid_constant__ CUtensorMap mv,
                                  const __grid_constant__ CUtensorMap mp,
                                  const __grid_constant__ CUtensorMap mdo,
                                  const bf16* __restrict__ ub,
                                  const bf16* __restrict__ vb,
                                  const int* __restrict__ lengths,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  bf16* __restrict__ dq,
                                  float* __restrict__ ws,
                                  float* __restrict__ wdu,
                                  float* __restrict__ wdv, int T, int H,
                                  float scale, Drop dr) {
  const int D = H * DH;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int hoff = h * DH;
  const int len = lengths[n];
  const size_t row0 = (size_t)n * T, lse0 = ((size_t)n * H + h) * T;
  if (t0 >= len) {  // every query row of the tile is padding
    zero_rows(dq, row0, D, hoff, t0, min(t0 + BQ, T), threadIdx.x,
              hg::THREADS);
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t qbar = base + OFF_BAR, full = qbar + 8,
                 empty = full + 8 * STAGES;
  const int nkt = hg::cdiv(len, BKEY);
  // consumer 1 has work only where its first row is valid
  const int nact = t0 + 64 < len ? 2 : 1;
  if (threadIdx.x == 0) {
    hg::mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full + 8 * s, 1);
      hg::mbar_init(empty + 8 * s, nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const int qrow = (int)row0 + t0;
      hg::mbar_expect_tx(qbar, 4 * BOX);
      hg::tma_load(base + OFF_QU, &mq, qbar, hoff, qrow);
      hg::tma_load(base + OFF_QU + BOX, &mq, qbar, hoff, qrow + 64);
      hg::tma_load(base + OFF_DO, &mdo, qbar, hoff, qrow);
      hg::tma_load(base + OFF_DO + BOX, &mdo, qbar, hoff, qrow + 64);
      for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % STAGES, s0 = kt * BKEY;
        const uint32_t dst = base + OFF_STAGE + st * STAGE;
        const uint32_t bar = full + 8 * st;
        hg::mbar_wait(empty + 8 * st, ((kt / STAGES) & 1) ^ 1);
        hg::mbar_expect_tx(bar, STAGE);
        hg::tma_load(dst, &mk, bar, hoff, (int)row0 + s0);
        hg::tma_load(dst + BOX, &mv, bar, hoff, (int)row0 + s0);
        // p rows T-128-t0+s0 .. + 191 (negative or past 2T-2: zeros)
        const int w0 = T - BQ - t0 + s0;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          hg::tma_load(dst + (2 + b) * BOX, &mp, bar, hoff, w0 + 64 * b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3, odd = lane & 1;
  const int r0 = t0 + 64 * w;  // this consumer's first query row
  if (r0 >= len) {
    zero_rows(dq, row0, D, hoff, r0, min(r0 + 64, T), tid, 128);
    return;
  }
  unsigned char* const dqp = sm + OFF_SCRATCH + w * SCRATCH;
  float* const carry = reinterpret_cast<float*>(sm + OFF_CARRY) +
                       w * 128 * 32 + tid;

  // qu = bf16(q + u), qv = bf16(q + v) over this consumer's 64 rows, in
  // the 128-byte swizzled layout TMA wrote, as the forward forms them
  hg::mbar_wait(qbar, 0);
  {
    unsigned char* qu = sm + OFF_QU + w * BOX;
    unsigned char* qv = sm + OFF_QV + w * BOX;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + 128 * it, r = i >> 3, j = i & 7;
      const int c = hoff + 8 * (j ^ (r & 7));
      const uint4 in = *reinterpret_cast<const uint4*>(qu + i * 16);
      const uint4 bu = *reinterpret_cast<const uint4*>(ub + c);
      const uint4 bv = *reinterpret_cast<const uint4*>(vb + c);
      const bf16* hin = reinterpret_cast<const bf16*>(&in);
      const bf16* hu = reinterpret_cast<const bf16*>(&bu);
      const bf16* hv = reinterpret_cast<const bf16*>(&bv);
      uint4 a, b;
      bf16* ha = reinterpret_cast<bf16*>(&a);
      bf16* hb = reinterpret_cast<bf16*>(&b);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float qf = __bfloat162float(hin[e]);
        ha[e] = __float2bfloat16(qf + __bfloat162float(hu[e]));
        hb[e] = __float2bfloat16(qf + __bfloat162float(hv[e]));
      }
      *reinterpret_cast<uint4*>(qu + i * 16) = a;
      *reinterpret_cast<uint4*>(qv + i * 16) = b;
    }
    // the generic-proxy writes, before the warpgroup's wgmma reads them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  }
  // K-major A operands (S, QP, dP), qv as the MN-major B of the dp window
  const uint64_t dqu_a = hg::desc(base + OFF_QU + w * BOX, 16, 1024);
  const uint64_t dqv_a = hg::desc(base + OFF_QV + w * BOX, 16, 1024);
  const uint64_t ddo_a = hg::desc(base + OFF_DO + w * BOX, 16, 1024);
  const uint64_t dqv_b = hg::desc(base + OFF_QV + w * BOX, 8192, 1024);
  // dQP: K-major A of dqv (window columns 64·(k / 4) + 16·(k % 4) in box
  // k / 4), MN-major A of the dp window's lower and upper halves
  const uint32_t dqp_u = base + OFF_SCRATCH + w * SCRATCH;
  const uint64_t dqp_k = hg::desc(dqp_u, 16, 1024);
  const uint64_t dqp_lo = hg::desc(dqp_u, 8192, 1024);
  const uint64_t dqp_hi = hg::desc(dqp_u + BOX, 8192, 1024);
  float* const sw =
      reinterpret_cast<float*>(sm + OFF_SCRATCH + w * SCRATCH) +
      warp * 16 * LDB;
  // this thread's query rows: trow and trow + 8
  const int trow = r0 + 16 * warp + g;
  const uint32_t plane = (uint32_t)(n * H + h);
  bool row_ok[2];
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int t = trow + 8 * ih;
    row_ok[ih] = t < len;
    lse_r[ih] = row_ok[ih] ? lse[lse0 + t] : 0.f;
    dl_r[ih] = row_ok[ih] ? delta[lse0 + t] : 0.f;
  }
  const int J = hg::cdiv(T, 64);
  const size_t slot = (size_t)n * J + r0 / 64;
  const size_t slot_row = slot * (size_t)(64 * J + 64);

  // dqu and dqv across the walk, in registers
  float dqu[32], dqv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    dqu[i] = dqv[i] = 0.f;
    carry[i * 128] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % STAGES, s0 = kt * BKEY;
    const uint32_t stage = base + OFF_STAGE + st * STAGE;
    // consumer w's window starts at stage row 64·(1 - w)
    const uint32_t pwin = stage + (3 - w) * BOX;
    // keep bits as the forward draws them: the lane pair (2k, 2k + 1)
    // shares the Philox groups of its columns; each draws those of one of
    // its two rows and they swap. Bits 4j .. 4j + 3 of kb[ih] are columns
    // s0 + 8j + 4·(q4 / 2) ..; drawn before the stage is waited for, out
    // of the products' register peak
    uint32_t mine = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mine |= keep4(dr, 0, plane, trow + 8 * odd,
                    (s0 >> 2) + 2 * j + (q4 >> 1)) << (4 * j);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    const uint32_t kb[2] = {odd ? other : mine, odd ? mine : other};
    hg::mbar_wait(full + 8 * st, (kt / STAGES) & 1);

    // QP = qv·Pwinᵀ; each warp keeps the 80 columns its band reads
    {
      float qp[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) qp[i] = 0.f;
      const uint64_t dp_k = hg::desc(pwin, 16, 1024);
      hg::fence_acc(qp);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hg::wgmma_n128<0, 0>(qp, dqv_a + 2 * k, dp_k + 2 * k, k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(qp);
      const int jlo = 6 - 2 * warp;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j >= jlo && j < jlo + 10)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(sw + (g + 8 * i) * LDB +
                                       8 * (j - jlo) + 2 * q4) =
                make_float2(qp[4 * j + 2 * i], qp[4 * j + 2 * i + 1]);
      __syncwarp();
    }

    // S = qu·Kᵀ and dP = dO·Vᵀ, K-major operands from shared memory
    float s[32], dpv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dpv[i] = 0.f;
    {
      const uint64_t dk = hg::desc(stage, 16, 1024);
      const uint64_t dv = hg::desc(stage + BOX, 16, 1024);
      hg::fence_acc(s);
      hg::fence_acc(dpv);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hg::wgmma_n64<0, 0>(s, dqu_a + 2 * k, dk + 2 * k, k);
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hg::wgmma_n64<0, 0>(dpv, ddo_a + 2 * k, dv + 2 * k, k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(s);
      hg::fence_acc(dpv);
    }

    // P = exp(s - lse) with the band, bd[r, c] = QP[r][c - r + 63], read
    // at column c - gl + 15 of the warp's scratch; dS in bf16 pairs, the
    // A operand of dqu += dS·K
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ih = (i >> 1) & 1, j = i >> 2, gl = g + 8 * ih;
      const unsigned bits = kb[ih] >> (4 * j + 2 * odd);
      float d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q4 + e;
        const float bd = sw[gl * LDB + c - gl + 15];
        const float pr = row_ok[ih] && s0 + c < len
                             ? __expf((s[i + e] + bd) * scale - lse_r[ih])
                             : 0.f;
        d2[e] = pr * (dpv[i + e] * keep_scale(dr, bits, e) - dl_r[ih]) *
                scale;
      }
      pa[i >> 3][(i >> 1) & 3] = hg::pack_bf16(d2[0], d2[1]);
    }

    // the band scatter, once every warp of the consumer has read its band:
    // a warp zeroes its 16 rows of dQP and writes dQP[r][c - r + 63] =
    // dS[r][c] into them
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int row = 16 * warp + (lane >> 2) + 8 * (it & 1);
      *reinterpret_cast<uint4*>(dqp + (it >> 1 & 1) * BOX + row * 128 +
                                (lane & 3) * 16 + (it >> 2) * 64) =
          make_uint4(0, 0, 0, 0);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ih = (i >> 1) & 1, j = i >> 2;
      const int r = 16 * warp + g + 8 * ih;
      const int m = 8 * j + 2 * q4 + (i & 1) - r + 63;
      const uint32_t pair = pa[i >> 3][(i >> 1) & 3];
      *reinterpret_cast<unsigned short*>(
          dqp + (m >> 6) * BOX + r * 128 +
          ((((m & 63) >> 3) ^ (r & 7)) << 4) + (m & 7) * 2) =
          (unsigned short)((i & 1) ? pair >> 16 : pair & 0xFFFFu);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");

    // dqu += dS·K (K MN-major), dqv += dQP·Pwin (Pwin MN-major) and the
    // dp window's lower half dQPᵀ·qv (dQP and qv MN-major); then its upper
    // half: two groups, so that no more than 64 accumulator registers
    // besides dqu and dqv are live
    {
      float lo[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) lo[i] = 0.f;
      const uint64_t dk = hg::desc(stage, 8192, 1024);
      const uint64_t dp_m = hg::desc(pwin, 8192, 1024);
      hg::fence_acc(dqu);
      hg::fence_acc(dqv);
      hg::fence_acc(lo);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < BKEY / 16; ++k)
        hg::wgmma_n64_rs<1>(dqu, pa[k], dk + ((k * 2048) >> 4), 1);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        hg::wgmma_n64<0, 1>(dqv,
                            dqp_k + (((k >> 2) * BOX + (k & 3) * 32) >> 4),
                            dp_m + ((k * 2048) >> 4), 1);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hg::wgmma_n64<1, 1>(lo, dqp_lo + ((k * 2048) >> 4),
                            dqv_b + ((k * 2048) >> 4), k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(dqu);
      hg::fence_acc(dqv);
      hg::fence_acc(lo);
      if (tid == 0) hg::mbar_arrive(empty + 8 * st);  // the stage is free
      // table rows T-64-r0+s0 .. + 63 are final: slot rows s0 ..
#pragma unroll
      for (int i = 0; i < 32; ++i) lo[i] += carry[i * 128];
      store_rows(ws, slot_row + s0, D, hoff, lo);
    }
    {
      float up[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) up[i] = 0.f;
      hg::fence_acc(up);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < 4; ++k)
        hg::wgmma_n64<1, 1>(up, dqp_hi + ((k * 2048) >> 4),
                            dqv_b + ((k * 2048) >> 4), k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(up);
      // the next window's lower half
#pragma unroll
      for (int i = 0; i < 32; ++i) carry[i * 128] = up[i];
    }
    // every warp's products have read dQP before the next band lands on it
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  }
  // the upper half of the last window: slot rows 64·nkt ..
  {
    float last[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) last[i] = carry[i * 128];
    store_rows(ws, slot_row + 64 * nkt, D, hoff, last);
  }

#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int t = trow + 8 * ih;
    if (t >= T) continue;
    bf16* dst = dq + (row0 + t) * D + hoff + 2 * q4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * ih;
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          row_ok[ih] ? __floats2bfloat162_rn(dqu[i] + dqv[i],
                                             dqu[i + 1] + dqv[i + 1])
                     : __floats2bfloat162_rn(0.f, 0.f);
    }
  }

  // du and dv_bias partials: column sums of dqu and dqv over the 64 rows
  // (rows past the length hold zeros), over the lanes of a column and
  // then the four warps in order, through the consumer's scratch
  float* const red =
      reinterpret_cast<float*>(sm + OFF_SCRATCH + w * SCRATCH);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = dqu[4 * j + e] + dqu[4 * j + 2 + e];
      float b = dqv[4 * j + e] + dqv[4 * j + 2 + e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      if (g == 0) {
        red[warp * 128 + 8 * j + 2 * q4 + e] = a;
        red[warp * 128 + 64 + 8 * j + 2 * q4 + e] = b;
      }
    }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  {
    float sum = 0.f;
#pragma unroll
    for (int wp = 0; wp < 4; ++wp) sum += red[wp * 128 + tid];
    (tid < 64 ? wdu : wdv)[slot * D + hoff + (tid & 63)] = sum;
  }
}

// dp (2T-1, H·Dh), du and dv_bias (H·Dh): block m < 2T-1 sums table row m
// over the slots that cover it, block 2T-1 the du and dv_bias partials;
// each in the order utterance ascending, then sub-tile ascending.
__global__ void __launch_bounds__(128)
    relpos_attention_bwd_reduce(const float* __restrict__ ws,
                                const float* __restrict__ wdu,
                                const float* __restrict__ wdv,
                                const int* __restrict__ lengths,
                                float* __restrict__ dp,
                                float* __restrict__ dub,
                                float* __restrict__ dvb, int N, int T,
                                int H) {
  const int D = H * DH, J = hg::cdiv(T, 64), SR = 64 * J + 64;
  const int m = blockIdx.x;
  auto add = [](float4& a, const float4& x) {
    a.x += x.x;
    a.y += x.y;
    a.z += x.z;
    a.w += x.w;
  };
  for (int c = 4 * threadIdx.x; c < D; c += 4 * blockDim.x) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    for (int nn = 0; nn < N; ++nn) {
      const int nkt = hg::cdiv(lengths[nn], 64);
      if (m == 2 * T - 1) {
        for (int j = 0; j < nkt; ++j) {
          const size_t o = (size_t)(nn * J + j) * D + c;
          add(a, *reinterpret_cast<const float4*>(wdu + o));
          add(b, *reinterpret_cast<const float4*>(wdv + o));
        }
        continue;
      }
      // slot j covers table rows T-64-64j .. T-64-64j + 64·nkt + 63: row
      // m is its row m - T + 64 + 64j for j in [jlo, jhi)
      const int jlo = T - 64 - m > 0 ? hg::cdiv(T - 64 - m, 64) : 0;
      const int x = 64 * nkt + T - m;
      const int jhi = min(nkt, x > 0 ? hg::cdiv(x, 64) : 0);
      for (int j = jlo; j < jhi; ++j)
        add(a, *reinterpret_cast<const float4*>(
                   ws + ((size_t)(nn * J + j) * SR + m - T + 64 + 64 * j) *
                            D + c));
    }
    if (m < 2 * T - 1) {
      *reinterpret_cast<float4*>(dp + (size_t)m * D + c) = a;
    } else {
      *reinterpret_cast<float4*>(dub + c) = a;
      *reinterpret_cast<float4*>(dvb + c) = b;
    }
  }
}

// dK and dV (N, T, H·Dh) bf16: block (x, h, n) computes keys s0 = 128x ..
// s0 + 127 of head h of utterance n, every row it owns written once.
__global__ void __launch_bounds__(hg::THREADS, 1)
    relpos_attention_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap mq,
                                    const __grid_constant__ CUtensorMap mk,
                                    const __grid_constant__ CUtensorMap mv,
                                    const __grid_constant__ CUtensorMap mp,
                                    const __grid_constant__ CUtensorMap mdo,
                                    const bf16* __restrict__ ub,
                                    const bf16* __restrict__ vb,
                                    const int* __restrict__ lengths,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ delta,
                                    bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int T, int H,
                                    float scale, Drop dr) {
  const int D = H * DH;
  const int s0 = blockIdx.x * 128, h = blockIdx.y, n = blockIdx.z;
  const int hoff = h * DH;
  const int len = lengths[n];
  const size_t row0 = (size_t)n * T, lse0 = ((size_t)n * H + h) * T;
  if (s0 >= len) {  // every key of the tile is padding: zero gradients
    zero_rows(dk, row0, D, hoff, s0, min(s0 + 128, T), threadIdx.x,
              hg::THREADS);
    zero_rows(dv, row0, D, hoff, s0, min(s0 + 128, T), threadIdx.x,
              hg::THREADS);
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t kvbar = base + kv::OFF_BAR, full = kvbar + 8,
                 empty = full + 8 * STAGES;
  const int nqt = hg::cdiv(len, 64);
  // consumer 1 has work only where its first key is valid
  const int nact = s0 + 64 < len ? 2 : 1;
  if (threadIdx.x == 0) {
    hg::mbar_init(kvbar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      hg::mbar_init(full + 8 * s, 1);
      hg::mbar_init(empty + 8 * s, nact);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      const int krow = (int)row0 + s0;
      hg::mbar_expect_tx(kvbar, 4 * BOX);
      hg::tma_load(base + kv::OFF_K, &mk, kvbar, hoff, krow);
      hg::tma_load(base + kv::OFF_K + BOX, &mk, kvbar, hoff, krow + 64);
      hg::tma_load(base + kv::OFF_V, &mv, kvbar, hoff, krow);
      hg::tma_load(base + kv::OFF_V + BOX, &mv, kvbar, hoff, krow + 64);
      for (int qt = 0; qt < nqt; ++qt) {
        const int st = qt % STAGES, t0 = 64 * qt;
        const uint32_t dst = base + kv::OFF_STAGE + st * STAGE;
        const uint32_t bar = full + 8 * st;
        hg::mbar_wait(empty + 8 * st, ((qt / STAGES) & 1) ^ 1);
        hg::mbar_expect_tx(bar, STAGE);
        hg::tma_load(dst, &mq, bar, hoff, (int)row0 + t0);
        hg::tma_load(dst + BOX, &mdo, bar, hoff, (int)row0 + t0);
        // p rows T-64-t0+s0 .. + 191 (negative or past 2T-2: zeros)
        const int w0 = T - 64 - t0 + s0;
#pragma unroll
        for (int b = 0; b < 3; ++b)
          hg::tma_load(dst + (2 + b) * BOX, &mp, bar, hoff, w0 + 64 * b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int w = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q4 = lane & 3, odd = lane & 1;
  const int k0 = s0 + 64 * w;  // this consumer's first key
  if (k0 >= len) {
    zero_rows(dk, row0, D, hoff, k0, min(k0 + 64, T), tid, 128);
    zero_rows(dv, row0, D, hoff, k0, min(k0 + 64, T), tid, 128);
    return;
  }
  unsigned char* const qu = sm + kv::OFF_QUV + w * 2 * BOX;
  unsigned char* const qv = qu + BOX;
  unsigned char* const pd = sm + kv::OFF_PDS + w * 2 * BOX;
  unsigned char* const ds = pd + BOX;
  const uint32_t qu_u = base + kv::OFF_QUV + w * 2 * BOX;
  const uint32_t pd_u = base + kv::OFF_PDS + w * 2 * BOX;
  // K-major A operands (S, QP) and B operands (S, dP)
  const uint64_t dqu_a = hg::desc(qu_u, 16, 1024);
  const uint64_t dqv_a = hg::desc(qu_u + BOX, 16, 1024);
  const uint64_t dk_b = hg::desc(base + kv::OFF_K + w * BOX, 16, 1024);
  const uint64_t dv_b = hg::desc(base + kv::OFF_V + w * BOX, 16, 1024);
  float* const sw =
      reinterpret_cast<float*>(sm + kv::OFF_SCRATCH + w * SCRATCH) +
      warp * 16 * LDB;
  const uint32_t plane = (uint32_t)(n * H + h);

  // dK and dV of this consumer's 64 keys across the walk, in registers
  float dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;
  hg::mbar_wait(kvbar, 0);

  for (int qt = 0; qt < nqt; ++qt) {
    const int st = qt % STAGES, t0 = 64 * qt;
    const uint32_t stage = base + kv::OFF_STAGE + st * STAGE;
    // this thread's query rows trow and trow + 8, their lse and Delta,
    // and the keep bits as the dq pass draws them (the lane pair (2k,
    // 2k + 1) draws one row each and they swap), before the stage wait
    const int trow = t0 + 16 * warp + g;
    bool row_ok[2];
    float lse_r[2], dl_r[2];
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      const int t = trow + 8 * ih;
      row_ok[ih] = t < len;
      lse_r[ih] = row_ok[ih] ? lse[lse0 + t] : 0.f;
      dl_r[ih] = row_ok[ih] ? delta[lse0 + t] : 0.f;
    }
    uint32_t mine = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mine |= keep4(dr, 0, plane, trow + 8 * odd,
                    (k0 >> 2) + 2 * j + (q4 >> 1)) << (4 * j);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    const uint32_t kb[2] = {odd ? other : mine, odd ? mine : other};
    hg::mbar_wait(full + 8 * st, (qt / STAGES) & 1);

    // qu = bf16(q + u), qv = bf16(q + v) from the stage's 64 Q rows into
    // this consumer's own boxes, in the swizzled layout, as the forward
    // and the dq pass form them
    {
      const unsigned char* qs = sm + kv::OFF_STAGE + st * STAGE;
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const int i = tid + 128 * it, r = i >> 3, j = i & 7;
        const int c = hoff + 8 * (j ^ (r & 7));
        const uint4 in = *reinterpret_cast<const uint4*>(qs + i * 16);
        const uint4 bu = *reinterpret_cast<const uint4*>(ub + c);
        const uint4 bv = *reinterpret_cast<const uint4*>(vb + c);
        const bf16* hin = reinterpret_cast<const bf16*>(&in);
        const bf16* hu = reinterpret_cast<const bf16*>(&bu);
        const bf16* hv = reinterpret_cast<const bf16*>(&bv);
        uint4 a, b;
        bf16* ha = reinterpret_cast<bf16*>(&a);
        bf16* hb = reinterpret_cast<bf16*>(&b);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float qf = __bfloat162float(hin[e]);
          ha[e] = __float2bfloat16(qf + __bfloat162float(hu[e]));
          hb[e] = __float2bfloat16(qf + __bfloat162float(hv[e]));
        }
        *reinterpret_cast<uint4*>(qu + i * 16) = a;
        *reinterpret_cast<uint4*>(qv + i * 16) = b;
      }
      // the generic-proxy writes, before the warpgroup's wgmma reads them
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
    }

    // QP = qv·Pwinᵀ over the consumer's window (stage rows 64w ..); each
    // warp keeps the 80 columns its band reads
    {
      float qp[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) qp[i] = 0.f;
      const uint64_t dp_k = hg::desc(stage + (2 + w) * BOX, 16, 1024);
      hg::fence_acc(qp);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hg::wgmma_n128<0, 0>(qp, dqv_a + 2 * k, dp_k + 2 * k, k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(qp);
      const int jlo = 6 - 2 * warp;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (j >= jlo && j < jlo + 10)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(sw + (g + 8 * i) * LDB +
                                       8 * (j - jlo) + 2 * q4) =
                make_float2(qp[4 * j + 2 * i], qp[4 * j + 2 * i + 1]);
      __syncwarp();
    }

    // S = qu·K_wᵀ and dP = dO·V_wᵀ, K-major operands from shared memory
    float s[32], dpv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dpv[i] = 0.f;
    {
      const uint64_t ddo_a = hg::desc(stage + BOX, 16, 1024);
      hg::fence_acc(s);
      hg::fence_acc(dpv);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hg::wgmma_n64<0, 0>(s, dqu_a + 2 * k, dk_b + 2 * k, k);
#pragma unroll
      for (int k = 0; k < DH / 16; ++k)
        hg::wgmma_n64<0, 0>(dpv, ddo_a + 2 * k, dv_b + 2 * k, k);
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      hg::fence_acc(s);
      hg::fence_acc(dpv);
    }

    // P = exp(s - lse) with the band, bd[r, c] = QP[r][c - r + 63], read
    // at column c - gl + 15 of the warp's scratch; Pd and dS in bf16
    // pairs into their [query][key] tiles
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ih = (i >> 1) & 1, j = i >> 2, gl = g + 8 * ih;
      const unsigned bits = kb[ih] >> (4 * j + 2 * odd);
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q4 + e;
        const float bd = sw[gl * LDB + c - gl + 15];
        const float pr = row_ok[ih] && k0 + c < len
                             ? __expf((s[i + e] + bd) * scale - lse_r[ih])
                             : 0.f;
        const float kf = keep_scale(dr, bits, e);
        p2[e] = pr * kf;
        d2[e] = pr * (dpv[i + e] * kf - dl_r[ih]) * scale;
      }
      const int r = 16 * warp + gl, c = 8 * j + 2 * q4;
      store_pair(pd, r, c, hg::pack_bf16(p2[0], p2[1]));
      store_pair(ds, r, c, hg::pack_bf16(d2[0], d2[1]));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");

    // dV += Pdᵀ·dO and dK += dSᵀ·qu (all four MN-major)
    hg::fence_acc(dva);
    hg::fence_acc(dka);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    mn_product(dva, pd_u, stage + BOX);
    mn_product(dka, pd_u + BOX, qu_u);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    hg::fence_acc(dva);
    hg::fence_acc(dka);
    if (tid == 0) hg::mbar_arrive(empty + 8 * st);  // the stage is free
    // every warp's products have read qu, Pd and dS before the next query
    // tile writes them
    asm volatile("bar.sync %0, 128;" ::"r"(1 + w) : "memory");
  }

  // dK and dV in bf16; keys past the length are zeros
#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    const int key = k0 + 16 * warp + g + 8 * ih;
    if (key >= T) continue;
    const bool ok = key < len;
    const size_t o = (row0 + key) * D + hoff + 2 * q4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = 4 * j + 2 * ih;
      *reinterpret_cast<__nv_bfloat162*>(dk + o + 8 * j) =
          ok ? __floats2bfloat162_rn(dka[i], dka[i + 1])
             : __floats2bfloat162_rn(0.f, 0.f);
      *reinterpret_cast<__nv_bfloat162*>(dv + o + 8 * j) =
          ok ? __floats2bfloat162_rn(dva[i], dva[i + 1])
             : __floats2bfloat162_rn(0.f, 0.f);
    }
  }
}

// One tile of the dK/dV pass's products alone, for a test on the card:
// out (64 x 64 f32, row-major) = aᵀ·b for a, b (64 x 64 bf16, row-major),
// a stored by the fragments' pairs as the pass stores Pd and dS, b in
// 16-byte chunks at the places TMA writes dO, both read as the pass reads
// them (`mn_product`). One warpgroup.
__global__ void __launch_bounds__(128)
    relpos_attention_bwd_tile(const bf16* __restrict__ a,
                              const bf16* __restrict__ b,
                              float* __restrict__ out) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hg::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * q4;
    store_pair(sm, r, c, *reinterpret_cast<const uint32_t*>(a + r * 64 + c));
  }
  for (int i = tid; i < 64 * 8; i += 128) {
    const int r = i >> 3, j = i & 7;
    *reinterpret_cast<uint4*>(sm + BOX + r * 128 + ((j ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(b + r * 64 + 8 * j);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  hg::fence_acc(d);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  mn_product(d, base, base + BOX);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  hg::fence_acc(d);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    out[hg::frag_row(i) * 64 + hg::frag_col(i)] = d[i];
}

// The three launches of the Dh = 64 route, each checked.
cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const void* ub, const void* vb, const void* lengths,
                   const void* lse, const void* delta, const void* dout,
                   void* dq, void* dk, void* dv, void* dp, void* dub,
                   void* dvb, void* ws, void* wdu, void* wdv, int N, int T,
                   int H, float scale, Drop dr, cudaStream_t stream) {
  const int D = H * DH;
  CUtensorMap mq, mk, mv, mp, mdo;
  CATK_TRY(hg::tensor_map(&mq, q, N * T, D, 64));
  CATK_TRY(hg::tensor_map(&mk, k, N * T, D, 64));
  CATK_TRY(hg::tensor_map(&mv, v, N * T, D, 64));
  CATK_TRY(hg::tensor_map(&mp, p, 2 * T - 1, D, 64));
  CATK_TRY(hg::tensor_map(&mdo, dout, N * T, D, 64));
  CATK_TRY(hg::prepare(relpos_attention_bwd_dq_wgmma, SMEM, true));
  relpos_attention_bwd_dq_wgmma<<<dim3(hg::cdiv(T, BQ), H, N), hg::THREADS,
                                  SMEM, stream>>>(
      mq, mk, mv, mp, mdo, static_cast<const bf16*>(ub),
      static_cast<const bf16*>(vb), static_cast<const int*>(lengths),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<float*>(ws),
      static_cast<float*>(wdu), static_cast<float*>(wdv), T, H, scale, dr);
  CATK_TRY(cudaGetLastError());
  relpos_attention_bwd_reduce<<<2 * T, 128, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const float*>(wdu),
      static_cast<const float*>(wdv), static_cast<const int*>(lengths),
      static_cast<float*>(dp), static_cast<float*>(dub),
      static_cast<float*>(dvb), N, T, H);
  CATK_TRY(cudaGetLastError());
  CATK_TRY(hg::prepare(relpos_attention_bwd_dkdv_wgmma, kv::SMEM, true));
  relpos_attention_bwd_dkdv_wgmma<<<dim3(hg::cdiv(T, 128), H, N),
                                    hg::THREADS, kv::SMEM, stream>>>(
      mq, mk, mv, mp, mdo, static_cast<const bf16*>(ub),
      static_cast<const bf16*>(vb), static_cast<const int*>(lengths),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, scale, dr);
  return cudaGetLastError();
}

}  // namespace d64
}  // namespace

// Returns the CUDA error of the first launch that failed (0 on success).
// q, k, v, dout, dk, dv (N, T, H*Dh) bf16; p (2T-1, H*Dh) bf16; lse,
// delta (N, H, T) f32; dp (2T-1, H*Dh), dub, dvb (H*Dh) f32. Dh = 64: dq
// (N, T, H*Dh) bf16, every output written whole; ws (N*J*SR, H*Dh), wdu,
// wdv (N*J, H*Dh) f32 workspaces, J = ceil(T/64), SR = 64*J + 64 (see
// d64). Dh = 16, 32, 128: dq (N, T, H*Dh) f32, and dq, dp, dub, dvb zeroed
// by the caller (the kernel adds into them); ws, wdu, wdv unused. The
// Python wrapper checks Dh and clamps lengths to [0, T]. Dropout as in
// relpos_attention_fwd (the same mask).
extern "C" int relpos_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* p,
                                    const void* ub, const void* vb,
                                    const void* lengths, const void* lse,
                                    const void* delta, const void* dout,
                                    void* dq, void* dk, void* dv, void* dp,
                                    void* dub, void* dvb, void* ws,
                                    void* wdu, void* wdv, int N, int T,
                                    int H, int Dh, int seed0, int seed1,
                                    int thr, float scale, float inv,
                                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (N <= 0 || T <= 0) return cudaSuccess;
#define CATK_ATTN_BWD(DD)                                               \
  launch_wmma<DD>(q, k, v, p, ub, vb, lengths, lse, delta, dout, dq, dk, \
                  dv, dp, dub, dvb, N, T, H, scale, dr, s)
  switch (Dh) {
    case 16: return CATK_ATTN_BWD(16);
    case 32: return CATK_ATTN_BWD(32);
    case 64:
      return d64::launch(q, k, v, p, ub, vb, lengths, lse, delta, dout, dq,
                         dk, dv, dp, dub, dvb, ws, wdu, wdv, N, T, H, scale,
                         dr, s);
    case 128: return CATK_ATTN_BWD(128);
    default: return cudaErrorInvalidValue;
  }
#undef CATK_ATTN_BWD
}

// aᵀ·b of two 64 x 64 bf16 matrices into out (64 x 64 f32) through the
// dK/dV pass's shared-memory layouts and MN-major products: a check of
// those on the card, not a part of the backward.
extern "C" int relpos_attention_bwd_tile(const void* a, const void* b,
                                         void* out, void* stream) {
  d64::relpos_attention_bwd_tile<<<1, 128, 1024 + 2 * d64::BOX,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(out));
  return cudaGetLastError();
}
