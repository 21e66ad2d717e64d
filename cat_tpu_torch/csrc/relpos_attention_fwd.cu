// Relative-position (Transformer-XL) multi-head attention, forward:
//
//   out[n,t,h] = sum_s drop(softmax_s(((q_t + u) . k_s + (q_t + v) . p[T-1-t+s])
//                                     * scale + keymask)) v_s
//
// Replaces the TPU kernels `_fwd_kernel_packed` (cat_tpu/ops/
// attention_pallas.py:563, `pallas_call` at :736) and the forwards of the
// `_fwd_kernel`, `_single`, `_decomp` and `_band` variants, which compute
// the same function.
//
// Dropout (stream 0, plane n*H + h, row t, column s; see common_math.cuh)
// scales the unnormalised probabilities before the value product, while
// the normaliser sums them undropped, as the TPU kernel does. The kernel
// also writes the per-row log-sum-exp lse (N, H, T) f32 that the backward
// kernel (relpos_attention_bwd.cu) rebuilds the probabilities from; rows
// past the length get 0.
//
// q, k, v, out (N, T, H*Dh) bf16, the projections' packed layout; p
// (2T-1, H*Dh) bf16, the projected sinusoid table; u, v biases (H*Dh) bf16;
// lengths (N,) int32: keys s >= lengths[n] are masked out. Query rows
// t >= lengths[n] are written as zeros (the caller zeroes them anyway).
//
// What bounds it on the H100: per utterance of length L and head, three
// L x L x Dh products, 6·L²·Dh FLOP (the training batch: 15.7 GFLOP,
// 15.9 us at 989 TFLOP/s bf16), against q, k, v, p and out read or
// written once (53 MB, 15.9 us at 3.35 TB/s). The tiles below do 26 GFLOP
// there: the position product spans a 128-row window for 64 keys, and
// ragged tiles run whole. No (T, T) table reaches device memory.
// Two routes, chosen by the head dimension:
//
// Dh = 64 (every recipe of the repo): `d64::relpos_attention_fwd_wgmma`,
// a flash kernel on Hopper's TMA and wgmma. One block of 384 threads per
// (128-query tile, head, utterance); warp 0 issues TMA loads, consumer
// warpgroup w (hardware warpgroup w + 1) owns query rows 64w .. 64w + 63.
// Q arrives once; each consumer adds the biases to its rows in place (f32,
// rounded to bf16: qu, and qv beside it). Key tiles of 64 up to the
// utterance's length go through a ring of two stages under mbarriers, each
// stage the K and V head slices and the 192 rows of p that the tile pair's
// relative positions cover (three 64-row boxes from row T-128-t0+s0, zeros
// outside the table). Per key tile a consumer issues S = qu·Kᵀ (m64n64)
// and QP = qv·Pwinᵀ over its 128-row window (m64n128), both from shared
// memory; each warp writes its 16 rows of QP to f32 scratch and reads the
// band back by index, bd[r, c] = QP[r, c - r + 63]; the online softmax
// runs on the accumulator fragments (rows shared by the 4 lanes of a
// quad), the probabilities become the A operand of O += P·V (m64n64, A
// from registers, V MN-major) without touching shared memory. The window
// arithmetic is `fwd_plan` of ops/attention.py, checked on the CPU by a
// blocked emulation (tests/test_torch_attn_plan.py). No atomics: two
// calls give the same bits.
//
// Dh = 16, 32, 128: the wmma kernel below. One block of 4 warps per
// (64-query tile, head, utterance); each warp owns 16 query rows and walks
// the key tiles of 64 with an online softmax in f32; the block loads the
// 127 window rows of p a tile pair needs into shared memory, each warp
// computes (q + v) . p_win^T over the 80 window rows its 16 queries need,
// and reads the band out of shared memory by index.
#include "common.cuh"
#include "hopper_gemm.cuh"

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
                           bf16* __restrict__ out,
                           float* __restrict__ lse, int T, int H,
                           float scale, Drop dr) {
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
    for (int i = threadIdx.x; i < rows; i += NW * 32)
      lse[((size_t)n * H + h) * T + t0 + i] = 0.f;
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
  const int t_row = t0 + 16 * warp + r;     // this lane pair's query
  const uint32_t plane = (uint32_t)(n * H + h);

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
    for (int i4 = 0; i4 < 32; i4 += 4) {
      const unsigned kb = keep4(dr, 0, plane, t_row, (s0 + half + i4) >> 2);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const int i = i4 + e4;
        const float e = __expf(sv[i] - m_new);
        psum += e;
        pb[r * LDP + half + i] = __float2bfloat16(e * keep_scale(dr, kb, e4));
      }
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

  const int t = t_row;
  if (t < T) {
    const float inv = (t < len) ? 1.f / l_run : 0.f;
    if ((lane & 1) == 0)
      lse[((size_t)n * H + h) * T + t] =
          (t < len) ? m_run + logf(l_run) : 0.f;
    bf16* dst = out + base + (size_t)t * D + hoff;
    for (int d = (lane & 1) * (DH / 2); d < (lane & 1) * (DH / 2) + DH / 2;
         ++d)
      dst[d] = __float2bfloat16(os[r * LDO + d] * inv);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const void* ub, const void* vb, const void* lengths,
                   void* out, void* lse, int N, int T, int H, float scale,
                   Drop dr, cudaStream_t stream) {
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
      static_cast<const int*>(lengths), static_cast<bf16*>(out),
      static_cast<float*>(lse), T, H, scale, dr);
  return cudaGetLastError();
}

// ---- Dh = 64: TMA + wgmma flash kernel (see the top of the file)
namespace d64 {

constexpr int DH = 64;
constexpr int BQ = 128;        // query rows a block
constexpr int BKEY = 64;       // keys a tile
constexpr int BOX = 64 * 128;  // bytes of a 64-row box of one head slice
constexpr int STAGES = 2;
// a stage: K, V, then the p window of 3 boxes (192 rows)
constexpr int STAGE = 5 * BOX;
// f32 band scratch: 16 rows a consumer warp; the stride keeps a warp's
// 8-byte stores free of bank conflicts
constexpr int LDB = 136;
constexpr int OFF_QU = 0;                          // 128 rows of qu
constexpr int OFF_QV = OFF_QU + 2 * BOX;           // 128 rows of qv
constexpr int OFF_STAGE = OFF_QV + 2 * BOX;
constexpr int OFF_SCRATCH = OFF_STAGE + STAGES * STAGE;
constexpr int OFF_BAR = OFF_SCRATCH + 8 * 16 * LDB * 4;
// 1 KB to align the start; barriers: Q, then full and empty per stage
constexpr int SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);
constexpr float NEG = -1e30f;

// Zeros in out and lse for query rows [ta, tb) of the head slice.
__device__ __forceinline__ void zero_rows(bf16* out, float* lse, size_t row0,
                                          size_t lse0, int D, int hoff,
                                          int ta, int tb, int tid,
                                          int nthreads) {
  for (int i = tid; i < (tb - ta) * (DH / 8); i += nthreads) {
    const int t = ta + i / (DH / 8), c = (i % (DH / 8)) * 8;
    *reinterpret_cast<uint4*>(out + (row0 + t) * D + hoff + c) =
        make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < tb - ta; i += nthreads) lse[lse0 + ta + i] = 0.f;
}

__global__ void __launch_bounds__(hg::THREADS, 1)
    relpos_attention_fwd_wgmma(const __grid_constant__ CUtensorMap mq,
                               const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap mv,
                               const __grid_constant__ CUtensorMap mp,
                               const bf16* __restrict__ ub,
                               const bf16* __restrict__ vb,
                               const int* __restrict__ lengths,
                               bf16* __restrict__ out,
                               float* __restrict__ lse, int T, int H,
                               float scale, Drop dr) {
  const int D = H * DH;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, n = blockIdx.z;
  const int hoff = h * DH;
  const int len = lengths[n];
  const size_t row0 = (size_t)n * T, lse0 = ((size_t)n * H + h) * T;
  if (t0 >= len) {  // every query row of the tile is padding
    zero_rows(out, lse, row0, lse0, D, hoff, t0, min(t0 + BQ, T),
              threadIdx.x, hg::THREADS);
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
      hg::mbar_expect_tx(qbar, 2 * BOX);
      hg::tma_load(base + OFF_QU, &mq, qbar, hoff, qrow);
      hg::tma_load(base + OFF_QU + BOX, &mq, qbar, hoff, qrow + 64);
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
    zero_rows(out, lse, row0, lse0, D, hoff, r0, min(r0 + 64, T), tid, 128);
    return;
  }

  // qu = bf16(q + u), qv = bf16(q + v) over this consumer's 64 rows, in
  // the 128-byte swizzled layout TMA wrote: 16-byte chunk j of row r holds
  // columns 8·(j ^ (r % 8)) ..
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
  const uint64_t dqu = hg::desc(base + OFF_QU + w * BOX, 16, 1024);
  const uint64_t dqv = hg::desc(base + OFF_QV + w * BOX, 16, 1024);
  float* const sw = reinterpret_cast<float*>(sm + OFF_SCRATCH) +
                    (4 * w + warp) * 16 * LDB;
  // this thread's query rows: trow and trow + 8
  const int trow = r0 + 16 * warp + g;
  const uint32_t plane = (uint32_t)(n * H + h);

  float s[32], qp[64], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) qp[i] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < nkt; ++kt) {
    const int st = kt % STAGES, s0 = kt * BKEY;
    const uint32_t stage = base + OFF_STAGE + st * STAGE;
    hg::mbar_wait(full + 8 * st, (kt / STAGES) & 1);
    // S = qu·Kᵀ and QP = qv·Pwinᵀ, K-major operands from shared memory;
    // consumer w's window starts at stage row 64·(1 - w)
    const uint64_t dk = hg::desc(stage, 16, 1024);
    const uint64_t dp = hg::desc(stage + (3 - w) * BOX, 16, 1024);
    hg::fence_acc(s);
    hg::fence_acc(qp);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < DH / 16; ++k)
      hg::wgmma_n64<0, 0>(s, dqu + 2 * k, dk + 2 * k, k);
#pragma unroll
    for (int k = 0; k < DH / 16; ++k)
      hg::wgmma_n128<0, 0>(qp, dqv + 2 * k, dp + 2 * k, k);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    hg::fence_acc(s);
    hg::fence_acc(qp);

    // the band: warp-local row gl, key column c reads QP[16·warp + gl]
    // [c - 16·warp - gl + 63]
    __syncwarp();  // the previous tile's reads are done
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(sw + (g + 8 * i) * LDB + 8 * j + 2 * q4) =
            make_float2(qp[4 * j + 2 * i], qp[4 * j + 2 * i + 1]);
    __syncwarp();
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int ih = (i >> 1) & 1, gl = g + 8 * ih;
      const int c = (i >> 2) * 8 + 2 * q4 + (i & 1);
      const float bd = sw[gl * (LDB - 1) + c + 63 - 16 * warp];
      s[i] = s0 + c < len ? (s[i] + bd) * scale : NEG;
      mx[ih] = fmaxf(mx[ih], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      mx[ih] = fmaxf(mx[ih], __shfl_xor_sync(0xffffffffu, mx[ih], 1));
      mx[ih] = fmaxf(mx[ih], __shfl_xor_sync(0xffffffffu, mx[ih], 2));
      const float m_new = fmaxf(m_run[ih], mx[ih]);
      corr[ih] = __expf(m_run[ih] - m_new);
      m_run[ih] = m_new;
      l_run[ih] *= corr[ih];
    }
    // keep bits: the lane pair (2k, 2k + 1) shares the Philox groups of
    // its columns; each draws those of one of its two rows and they swap.
    // Bits 4j .. 4j + 3 of kb[ih] are columns s0 + 8j + 4·(q4 / 2) ..
    uint32_t mine = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mine |= keep4(dr, 0, plane, trow + 8 * odd,
                    (s0 >> 2) + 2 * j + (q4 >> 1)) << (4 * j);
    const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
    const uint32_t kb[2] = {odd ? other : mine, odd ? mine : other};
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int ih = (i >> 1) & 1, j = i >> 2;
      const float e0 = __expf(s[i] - m_run[ih]);
      const float e1 = __expf(s[i + 1] - m_run[ih]);
      l_run[ih] += e0 + e1;
      const unsigned bits = kb[ih] >> (4 * j + 2 * odd);
      pa[i >> 3][(i >> 1) & 3] = hg::pack_bf16(e0 * keep_scale(dr, bits, 0),
                                               e1 * keep_scale(dr, bits, 1));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];

    // O += P·V: V (keys x Dh, Dh contiguous) is the MN-major B operand
    const uint64_t dv = hg::desc(stage + BOX, 8192, 1024);
    hg::fence_acc(o);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int k = 0; k < BKEY / 16; ++k)
      hg::wgmma_n64_rs<1>(o, pa[k], dv + ((k * 2048) >> 4), 1);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    hg::fence_acc(o);
    if (tid == 0) hg::mbar_arrive(empty + 8 * st);  // the stage is free
  }

#pragma unroll
  for (int ih = 0; ih < 2; ++ih) {
    float l = l_run[ih];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int t = trow + 8 * ih;
    if (t >= T) continue;
    const bool valid = t < len;
    const float inv = valid ? 1.f / l : 0.f;
    if (q4 == 0) lse[lse0 + t] = valid ? m_run[ih] + logf(l) : 0.f;
    bf16* dst = out + (row0 + t) * D + hoff + 2 * q4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * ih] * inv,
                                o[4 * j + 2 * ih + 1] * inv);
  }
}

cudaError_t launch(const void* q, const void* k, const void* v, const void* p,
                   const void* ub, const void* vb, const void* lengths,
                   void* out, void* lse, int N, int T, int H, float scale,
                   Drop dr, cudaStream_t stream) {
  const int D = H * DH;
  CUtensorMap mq, mk, mv, mp;
  CATK_TRY(hg::tensor_map(&mq, q, N * T, D, 64));
  CATK_TRY(hg::tensor_map(&mk, k, N * T, D, 64));
  CATK_TRY(hg::tensor_map(&mv, v, N * T, D, 64));
  CATK_TRY(hg::tensor_map(&mp, p, 2 * T - 1, D, 64));
  CATK_TRY(hg::prepare(relpos_attention_fwd_wgmma, SMEM, true));
  relpos_attention_fwd_wgmma<<<dim3(hg::cdiv(T, BQ), H, N), hg::THREADS,
                               SMEM, stream>>>(
      mq, mk, mv, mp, static_cast<const bf16*>(ub),
      static_cast<const bf16*>(vb), static_cast<const int*>(lengths),
      static_cast<bf16*>(out), static_cast<float*>(lse), T, H, scale, dr);
  return cudaGetLastError();
}

}  // namespace d64

}  // namespace

// Returns the CUDA error of the launch (0 on success). Dh must be 16, 32, 64
// or 128; the Python wrapper checks it and clamps lengths to [0, T].
// seed0, seed1, thr: dropout seed words and keep threshold as uint32 bit
// patterns; inv = 1 / (1 - rate).
extern "C" int relpos_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* p,
                                    const void* ub, const void* vb,
                                    const void* lengths, void* out, void* lse,
                                    int N, int T, int H, int Dh, int seed0,
                                    int seed1, int thr, float scale,
                                    float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop dr{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (N <= 0 || T <= 0) return cudaSuccess;
  switch (Dh) {
    case 16: return launch<16>(q, k, v, p, ub, vb, lengths, out, lse, N, T, H, scale, dr, s);
    case 32: return launch<32>(q, k, v, p, ub, vb, lengths, out, lse, N, T, H, scale, dr, s);
    case 64: return d64::launch(q, k, v, p, ub, vb, lengths, out, lse, N, T, H, scale, dr, s);
    case 128: return launch<128>(q, k, v, p, ub, vb, lengths, out, lse, N, T, H, scale, dr, s);
    default: return cudaErrorInvalidValue;
  }
}
