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
// twice that. In practice the T' = 493 dependent frames bind: each is a
// chain of a contraction, a cluster barrier (about 1 us on the card) and
// a few block barriers, so the design spreads a frame over many SMs,
// keeps every operand of the contraction in shared memory and registers,
// and keeps barriers few. It stays on the CUDA cores in f32 (FFMA): the
// per-symbol products are (2G x V) . (V x V), 2G = 10 rows, and TF32
// would need a looser tolerance.
//
// The design: a thread-block cluster of C blocks works on a group of G
// utterances (grouped by length on the host, so a cluster loops only to
// its group's longest one). Block j owns the context symbols b in
// [j V / C, (j + 1) V / C) and holds, for its G utterances, the column
// slices a_in[:, B_j], a_bl[:, B_j] (all a, its own b) in shared memory,
// and its slice expW[:, B_j, :] (V x |B_j| x V f32, 104 KB at V = 72, C =
// 16), copied in once at the start with cp.async; where the slice does not
// fit beside the state (V = 96), the same loop reads it from L2 (template
// parameter WS). One forward frame: rows b in B_j of T_bl and T_in in
// tiles of NT = 4 outputs (b, u) for all G utterances and both sources
// (8G FMAs per 4 loads of expW and 2G broadcast loads of the exp-domain
// products), each tile's sum over a split over 4 lanes (a = h mod 4, each
// in order) and combined in a fixed order; emit0 from the sums with one
// log an element, stored into the shared memory of the block that owns u
// (distributed shared memory) in a buffer double-buffered by frame
// parity; the cluster barrier split into arrive and wait, with the a_bl
// update (which needs no emit0) in between; then the a_in update, 8
// lanes a column; each column's maximum and products for the next frame
// are made by the lanes that update it, into a second buffer. One cluster
// barrier and one block barrier a frame. Snapshots are written by column
// slice; logZ's LSE is a partial per block that rank 0 combines in rank
// order. The backward holds the betas in the same column layout: it
// recomputes a segment's alphas from its snapshot with the forward's own
// frame function (the same bits), writing the pre-update a_in, a_bl and
// emit0 to a device scratch, which it reads back one frame ahead with
// cp.async; each reverse frame computes the gradient entries of its own
// columns (column sums, in a fixed order), sends rhs[x, u] = y[u] +
// b_in[x, u] to the block that owns row x (one barrier), contracts rows b
// in B_j of rhs against the same resident slice into E[:, b] (column
// layout, so the beta update is local and runs on every thread) and sums
// the blank entry over the cluster in rank order. The beta path uses the
// hardware's approximate exp and log. No atomics: two calls give the same
// bits. Measured against the design's alternatives (tools/torch_den_ab.py,
// PERF.md): one output a thread, or 2 or 3 a thread without the split
// sum, are slower. The plan (C, G, grouping, W route, shared-memory bytes)
// comes from `den_plan` in `ops/crf_dense.py`; this file checks the bytes
// against its own layout.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr float LOG_EPS = -1e30f;
constexpr float LOWEST = -3.0e38f;  // below every state: a max's start
constexpr int MAX_G = 8;            // utterances a cluster
constexpr int MAX_C = 16;           // blocks a cluster (non-portable > 8)
constexpr int MAX_THREADS = 384;    // a block (items past it loop)
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may take
constexpr int NT = 4;               // contraction outputs a tile
constexpr int KP = NT;              // lanes a tile: the sum's index split
constexpr int TPW = 32 / KP;        // tiles a warp
constexpr int IPT = 2;              // passes over the tiles, at most
constexpr int GRP = 8;              // lanes a column in the other phases
constexpr int ROWS = (96 + GRP - 1) / GRP;  // rows a lane there, at most
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lae(float a, float b) {
  const float m = fmaxf(a, b);
  return m <= LOG_EPS / 2 ? LOG_EPS : m + logf(expf(a - m) + expf(b - m));
}

__device__ __forceinline__ float from_sum(float m, float s) {
  return s <= 0.f ? LOG_EPS : m + logf(fmaxf(s, 1e-37f));
}

// lae, from_sum and the posterior exp(score) with the hardware's
// approximate exp2 and log2 (relative error ~1e-6): for the betas and the
// gradient, which only feed gradient rows held to 1e-3. The alphas, their
// snapshots and logZ keep the accurate functions of the plain version.
__device__ __forceinline__ float lae_fast(float a, float b) {
  const float m = fmaxf(a, b);
  return m <= LOG_EPS / 2 ? LOG_EPS
                          : m + __logf(__expf(a - m) + __expf(b - m));
}

__device__ __forceinline__ float posterior_fast(float score) {
  return score <= LOG_EPS / 2 ? 0.f : __expf(score);
}

__device__ __forceinline__ float from_sum_fast(float m, float s) {
  return s <= 0.f ? LOG_EPS : m + __logf(fmaxf(s, 1e-37f));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// max / sum over the GRP lanes of an aligned group
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = GRP / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = GRP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__host__ __device__ inline int al4(int x) { return (x + 3) & ~3; }

// Shared memory of one block, in floats (mirrored by `_smem_bytes` of
// `ops/crf_dense.py`). Column tensors are (G, V, S): utterance, row x, own
// symbol s, padded to SC = al4(G V S); S = ceil(V / C) is the stride of
// the own symbols.
//   w     the expW slice, w[a AS + s V + u] = expW[a, b0 + s, u] (WS only;
//         AS = S V made odd, so a warp along a reads distinct banks)
//   p     exp-domain products, 2 parities of V S PG, PG = al4(2G): forward
//         p[(x S + s) PG + src G + g]; backward rows p[(s V + u) PG + k G +
//         g] in parity 0, and E sums [k][g][a][s] in parity 1
//   ex    the exchange, 2 parities x G V S: forward emit0 by column
//         [par][g][x][s], backward rhs by row [par][g][s][u]
//   ain, abl   the alphas' column slices
//   bin, bbl, pre (3 SC)   backward: the betas, and one frame's pre-update
//         a_in, a_bl and emit0 from the scratch
//   m     maxima (2 parities, 2 sources, G, S); y (2 parities, G, S + 1):
//         own symbols, then the blank
//   cols  blank column sums (G, S); part (2, G); pz logZ partials (G, 2, 2)
//   utt   per utterance: index, length (ints), logZ shift, incoming g
//   own   owner rank and local index of every symbol (ints)
struct Layout {
  int S, AS, PG, col, SC, UT, threads;
  int w, p, ex, ain, abl, bin, bbl, pre, m, y, cols, part, pz, utt, own, total;
};

__host__ __device__ inline Layout make_layout(int V, int C, int G, bool ws,
                                              bool bwd) {
  Layout L;
  L.S = (V + C - 1) / C;
  L.AS = (L.S * V) | 1;
  L.PG = al4(2 * G);
  L.col = V * L.S;
  L.SC = al4(G * L.col);
  L.UT = (V + NT - 1) / NT;
  int o = 0;
  L.w = o;
  o += ws ? al4(V * L.AS) : 0;
  L.p = o;
  o += 2 * L.col * L.PG;
  L.ex = o;
  o += al4(2 * G * L.col);
  L.ain = o;
  o += L.SC;
  L.abl = o;
  o += L.SC;
  L.bin = o;
  o += bwd ? L.SC : 0;
  L.bbl = o;
  o += bwd ? L.SC : 0;
  L.pre = o;
  o += bwd ? 3 * L.SC : 0;
  L.m = o;
  o += al4(4 * G * L.S);
  L.y = o;
  o += al4(2 * G * (L.S + 1));
  L.cols = o;
  o += al4(G * L.S);
  L.part = o;
  o += al4(2 * G);
  L.pz = o;
  o += al4(4 * G);
  L.utt = o;
  o += al4(4 * G);
  L.own = o;
  o += al4(2 * V);
  L.total = o;
  const int cells = L.S * V;  // a block's (row, own symbol) pairs
  L.threads = cells < 32 ? 32 : min(MAX_THREADS, (cells + 31) / 32 * 32);
  return L;
}

struct Params {
  const float* lp;         // (N, T, V) log-probs
  const long long* lens;   // (N,)
  const int* order;        // (N,) utterances by length, longest first
  const float* w;          // expW (V, V, V)
  const float* fin;        // F (V, V)
  float* snap_in;          // (S_T, N, V, V)
  float* snap_bl;
  float* logz;             // (N,)
  const float* g;          // (N,) incoming gradient (backward)
  float* grad;             // (N, T, V) (backward)
  float* scratch;          // per block K frames of 3 SC (backward)
  int N, T, V, K;
};

// One block's view: its symbols, its utterances and its shared memory.
struct Block {
  int V, S, C, j, b0, nb, Tg, AS, PG, col, SC, UT;
  float *w, *p, *ex, *ain, *abl, *bin, *bbl, *pre, *m, *y, *cols, *part, *pz;
  int *un, *ul, *own, *loc;
  float *lz, *gn;
};

template <int G>
__device__ Block setup(const Params& P, float* smem, bool ws, bool bwd) {
  cg::cluster_group cluster = cg::this_cluster();
  Block k;
  k.V = P.V;
  k.C = (int)cluster.num_blocks();
  k.j = (int)cluster.block_rank();
  const Layout L = make_layout(P.V, k.C, G, ws, bwd);
  k.S = L.S;
  k.AS = L.AS;
  k.PG = L.PG;
  k.col = L.col;
  k.SC = L.SC;
  k.UT = L.UT;
  k.b0 = k.j * P.V / k.C;
  k.nb = (k.j + 1) * P.V / k.C - k.b0;
  k.w = smem + L.w;
  k.p = smem + L.p;
  k.ex = smem + L.ex;
  k.ain = smem + L.ain;
  k.abl = smem + L.abl;
  k.bin = smem + L.bin;
  k.bbl = smem + L.bbl;
  k.pre = smem + L.pre;
  k.m = smem + L.m;
  k.y = smem + L.y;
  k.cols = smem + L.cols;
  k.part = smem + L.part;
  k.pz = smem + L.pz;
  k.un = reinterpret_cast<int*>(smem + L.utt);
  k.ul = k.un + G;
  k.lz = smem + L.utt + 2 * G;
  k.gn = k.lz + G;
  k.own = reinterpret_cast<int*>(smem + L.own);
  k.loc = k.own + P.V;
  const int tid = threadIdx.x, grp = blockIdx.x / k.C;
  if (tid < G) {
    const int idx = grp * G + tid;
    const int n = idx < P.N ? P.order[idx] : -1;
    k.un[tid] = n;
    k.ul[tid] = n < 0 ? 0
                      : (int)min((long long)P.T, max(0LL, P.lens[n]));
    if (bwd) {
      const float lz = n < 0 ? 0.f : P.logz[n];
      k.lz[tid] = lz <= LOG_EPS / 2 ? 0.f : lz;
      k.gn[tid] = n < 0 ? 0.f : P.g[n];
    }
  }
  for (int x = tid; x < P.V; x += blockDim.x) {
    const int r = ((x + 1) * k.C - 1) / P.V;
    k.own[x] = r;
    k.loc[x] = x - r * P.V / k.C;
  }
  // the expW slice, once: cp.async 4 bytes at a time (any V, any offset)
  if (ws) {
    for (int i = tid; i < P.V * k.nb * P.V; i += blockDim.x) {
      const int a = i / (k.nb * P.V), r = i - a * k.nb * P.V;
      const float* src = P.w + ((size_t)a * P.V + k.b0) * P.V + r;
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(k.w + a * k.AS + r));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(src)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  __syncthreads();
  int tg = 0;
  for (int g = 0; g < G; ++g) tg = max(tg, k.ul[g]);
  k.Tg = tg;
  return k;
}

__device__ __forceinline__ void finish_setup() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // every block of the cluster has started before any touches another's
  // shared memory
  cg::this_cluster().sync();
}

// y of frame t (none for t < 0) for the block's symbols and the blank,
// loaded by the first G (nb + 1) threads; its slot in a parity of k.y.
template <int G>
__device__ __forceinline__ float load_y(const Block& k, const Params& P,
                                        int t, int& slot) {
  slot = -1;
  const int tid = threadIdx.x;
  if (t < 0 || tid >= G * (k.nb + 1)) return 0.f;
  const int g = tid / (k.nb + 1), s = tid - g * (k.nb + 1);
  slot = g * (k.S + 1) + (s < k.nb ? s : k.S);
  const int n = k.un[g];
  return n < 0 ? 0.f
               : P.lp[((size_t)n * P.T + t) * P.V + (s < k.nb ? k.b0 + s : 0)];
}

// acc[q][.] += pp[.] * w[q] over the 2G live slots of the padded PG
template <int G>
__device__ __forceinline__ void fma_tile(float (*acc)[(2 * G + 3) / 4 * 4],
                                         const float* pp, const float* w) {
  constexpr int PG = (2 * G + 3) / 4 * 4;
  const float4* p4 = reinterpret_cast<const float4*>(pp);
#pragma unroll
  for (int i = 0; i < PG / 4; ++i) {
    const float4 v4 = p4[i];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * i + c < 2 * G)
          acc[q][4 * i + c] = fmaf(v[c], w[q], acc[q][4 * i + c]);
  }
}

// The KP lanes of a tile (part h, lane bits log2(TPW) up) hold partial
// sums of its NT = KP outputs over their share of the sum's index.
// Recursive halving: at step b the lane keeps the outputs whose bit b is
// h's, adding the partner's (lane ^ TPW << b) partial of each; afterwards
// `out` of lane h holds output h's sum, added in a fixed order.
template <int G, int N = NT>
__device__ __forceinline__ void reduce_parts(float (*acc)[(2 * G + 3) / 4 * 4],
                                             float* out, int h, int b = 0) {
  constexpr int PG = (2 * G + 3) / 4 * 4;
  if constexpr (N == 1) {
#pragma unroll
    for (int i = 0; i < 2 * G; ++i) out[i] = acc[0][i];
  } else {
    const bool hb = (h >> b) & 1;
    float half[N / 2][PG];
#pragma unroll
    for (int j = 0; j < N / 2; ++j)
#pragma unroll
      for (int i = 0; i < 2 * G; ++i)
        half[j][i] = (hb ? acc[2 * j + 1][i] : acc[2 * j][i]) +
                     __shfl_xor_sync(FULL, hb ? acc[2 * j][i]
                                              : acc[2 * j + 1][i],
                                     TPW << b);
    reduce_parts<G, N / 2>(half, out, h, b + 1);
  }
}

// A contraction tile of this lane in pass i: its index (past nb UT for
// lanes without one) and part h.
__device__ __forceinline__ int tile_of(int i, int& h) {
  const int lane = threadIdx.x & 31;
  h = lane / TPW;
  return ((threadIdx.x >> 5) + i * (blockDim.x >> 5)) * TPW +
         (lane & (TPW - 1));
}

// The own columns (g, s) of one alpha tensor, GRP lanes a column (lane
// l of a group takes rows x = l, l + GRP, ...), all columns in one round
// at V = 72, C = 16, G <= 8: `in` 0 updates a_bl (a_bl' needs no emit0),
// 1 updates a_in from emit0 received in exchange parity `xpar`; utterances
// with t past their length keep their column. Then each column's maximum
// and p = exp(a - m) for the next frame, into parity par ^ 1 of k.m, k.p
// (`prime` calls this with no utterance live, for products of parity
// par ^ 1 of the alphas as they are). With `scr`, the pre-update a_in,
// a_bl (in = 0) or emit0 (in = 1) to the scratch.
template <int G>
__device__ void update_columns(const Block& k, int t, int par, int xpar,
                               int in, float* __restrict__ scr) {
  const int tid = threadIdx.x, l8 = tid & (GRP - 1), ng = blockDim.x / GRP;
  const int V = k.V, S = k.S, nb = k.nb, col = k.col, cols = G * nb;
  const float* ys = k.y + par * G * (S + 1);
  const float* ex = k.ex + xpar * G * col;
  for (int base = 0; base < cols; base += ng) {
    const int c = base + tid / GRP;
    const bool on = c < cols;
    const int g = on ? c / nb : 0, s = on ? c - g * nb : 0;
    const bool live = on && t < k.ul[g];
    float* a = (in ? k.ain : k.abl) + g * col;
    const float yy = ys[g * (S + 1) + (in ? s : S)];
    float v[ROWS];
    float mx = LOWEST;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int x = l8 + GRP * i;
      v[i] = LOWEST;
      if (!on || x >= V) continue;
      const int e = x * S + s;
      if (in) {
        const float ai = a[e], e0 = ex[g * col + e];
        if (scr != nullptr) scr[2 * k.SC + g * col + e] = e0;
        v[i] = live ? fmaxf(lae(ai + yy, e0 + yy), LOG_EPS) : ai;
      } else {
        const float ai = k.ain[g * col + e], ab = a[e];
        if (scr != nullptr) {
          scr[g * col + e] = ai;
          scr[k.SC + g * col + e] = ab;
        }
        v[i] = live ? fmaxf(lae(ai, ab) + yy, LOG_EPS) : ab;
      }
      a[e] = v[i];
      mx = fmaxf(mx, v[i]);
    }
    mx = fmaxf(group_max(mx), LOG_EPS);
    if (!on) continue;
    float* p = k.p + (par ^ 1) * col * k.PG + in * G + g;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int x = l8 + GRP * i;
      if (x < V) p[(x * S + s) * k.PG] = expf(v[i] - mx);
    }
    if (l8 == 0) k.m[(((par ^ 1) * 2 + in) * G + g) * S + s] = mx;
  }
}

// The maxima and products of every own column for the frame of parity
// `par` (after a snapshot is loaded or the alphas initialised).
template <int G>
__device__ void prime(const Block& k, int par) {
  constexpr int NEVER = 0x7fffffff;  // no utterance is live at this frame
  update_columns<G>(k, NEVER, par ^ 1, 0, 0, nullptr);
  update_columns<G>(k, NEVER, par ^ 1, 0, 1, nullptr);
}

// emit0[b, u] from the sums s_bl, s_in of T_bl and T_in: LAE(m_bl + log
// s_bl, m_in + log s_in) = M + log(s_bl c_bl + s_in c_in), M = max(m_bl,
// m_in), c = exp(m - M); at b = u T_bl alone; where the scaled sum
// underflows, the two logs and their LAE.
__device__ __forceinline__ float emit0(float s_bl, float s_in, float m_bl,
                                       float m_in, float M, float c_bl,
                                       float c_in, bool diag) {
  if (diag) return from_sum(m_bl, s_bl);
  const float v = fmaf(s_bl, c_bl, s_in * c_in);
  if (v > 0.f) return M + logf(v);
  return lae(from_sum(m_bl, s_bl), from_sum(m_in, s_in));
}

// This lane's emit0 targets: for its tile in each pass, the exchange
// buffer of the block that owns the u of its output (q = h), at u's local
// index; null past V or past the tiles.
__device__ void emit_targets(const Block& k, float** dst) {
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    int h;
    const int tile = tile_of(i, h);
    const int u = tile - (tile / k.UT) * k.UT + h * k.UT;
    dst[i] = tile < k.nb * k.UT && u < k.V
                 ? cg::this_cluster().map_shared_rank(k.ex, k.own[u]) +
                       k.loc[u]
                 : nullptr;
  }
}

// One frame of the alpha recursion for the cluster's G utterances, on the
// block's column slices (all threads of all blocks; one cluster barrier).
// Products and maxima of frame t are in parity t & 1 of k.p and k.m, y in
// parity t & 1 of k.y; this frame makes those of frame t + 1 and loads y
// of frame `t_next` (none if negative). `xpar` is the exchange's parity.
// With `scr`, the pre-update a_in, a_bl and emit0 go to scr[0 : SC],
// [SC : 2 SC], [2 SC : 3 SC] in column layout.
template <int G, bool WS>
__device__ void alpha_frame(const Block& k, const Params& P, int t,
                            int t_next, int xpar, float* const* dst,
                            float* __restrict__ scr) {
  constexpr int PG = (2 * G + 3) / 4 * 4;
  const int tid = threadIdx.x;
  const int V = k.V, S = k.S, nb = k.nb, col = k.col, par = t & 1;
  int slot;
  const float yv = load_y<G>(k, P, t_next, slot);
  // rows b = b0 + s of T_bl, T_in. A tile is NT outputs (b, u_q), u_q =
  // tu + q UT, for all G utterances and both sources; its sums over a are
  // split over its KP lanes (a = h, h + KP, ...), and lane h emits output
  // q = h.
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    int h;
    const int tile = tile_of(i, h);
    if (__all_sync(FULL, tile >= nb * k.UT)) break;
    const int tl = min(tile, max(nb * k.UT - 1, 0));
    const int s = tl / k.UT, tu = tl - s * k.UT, b = k.b0 + s;
    float acc[NT][PG];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) acc[q][j] = 0.f;
    int uq[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) uq[q] = min(tu + q * k.UT, V - 1);
    const float* pp = k.p + par * col * PG + s * PG;
    const int pstride = S * PG;
    if (WS) {
      const float* wp = k.w + s * V;
#pragma unroll 2
      for (int a = h; a < V; a += KP) {
        float w[NT];
#pragma unroll
        for (int q = 0; q < NT; ++q) w[q] = wp[a * k.AS + uq[q]];
        fma_tile<G>(acc, pp + a * pstride, w);
      }
    } else {
      const float* wp = P.w + (size_t)b * V;
      const size_t VV = (size_t)V * V;
#pragma unroll 2
      for (int a = h; a < V; a += KP) {
        float w[NT];
#pragma unroll
        for (int q = 0; q < NT; ++q) w[q] = __ldg(wp + a * VV + uq[q]);
        fma_tile<G>(acc, pp + a * pstride, w);
      }
    }
    float sum[PG];
    reduce_parts<G>(acc, sum, h);
    if (dst[i] == nullptr) continue;
    const int u = tu + h * k.UT;
    const float* m = k.m + par * 2 * G * S + s;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_bl = m[g * S], m_in = m[(G + g) * S];
      const float M = fmaxf(m_bl, m_in);
      dst[i][((xpar * G + g) * V + b) * S] =
          emit0(sum[g], sum[G + g], m_bl, m_in, M, expf(m_bl - M),
                expf(m_in - M), b == u);
    }
  }
  cluster_arrive();
  // while the exchange completes: a_bl' (it needs no emit0), and the
  // pre-update alphas to the scratch; then a_in' from emit0 received
  update_columns<G>(k, t, par, xpar, 0, scr);
  cluster_wait();
  update_columns<G>(k, t, par, xpar, 1, scr);
  if (slot >= 0) k.y[(par ^ 1) * G * (S + 1) + slot] = yv;
  __syncthreads();
}

template <int G>
__device__ void init_alphas(const Block& k) {
  for (int e = threadIdx.x; e < G * k.col; e += blockDim.x) {
    const int r = e % k.col, x = r / k.S, s = r - x * k.S;
    k.ain[e] = LOG_EPS;
    k.abl[e] = x == 0 && k.b0 + s == 0 ? 0.f : LOG_EPS;
  }
}

// y of frame t into parity t & 1 of k.y (before a barrier)
template <int G>
__device__ void store_y(const Block& k, const Params& P, int t) {
  int slot;
  const float yv = load_y<G>(k, P, t, slot);
  if (slot >= 0) k.y[(t & 1) * G * (k.S + 1) + slot] = yv;
}

// the alphas entering frame t of every utterance, by column slice
template <int G>
__device__ void write_snapshot(const Block& k, const Params& P, int t) {
  const size_t VV = (size_t)k.V * k.V;
  for (int e = threadIdx.x; e < G * k.col; e += blockDim.x) {
    const int g = e / k.col, r = e - g * k.col, x = r / k.S;
    const int s = r - x * k.S, n = k.un[g];
    if (s >= k.nb || n < 0) continue;
    const size_t off = ((size_t)(t / P.K) * P.N + n) * VV + x * k.V + k.b0 + s;
    P.snap_in[off] = k.ain[e];
    P.snap_bl[off] = k.abl[e];
  }
}

template <int G, bool WS>
__global__ void __launch_bounds__(MAX_THREADS, 1) den_fwd_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Block k = setup<G>(P, smem, WS, false);
  init_alphas<G>(k);
  store_y<G>(k, P, 0);
  float* dst[IPT];
  emit_targets(k, dst);
  __syncthreads();
  prime<G>(k, 0);
  finish_setup();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  for (int t = 0; t < P.T; ++t) {
    if (t % P.K == 0) write_snapshot<G>(k, P, t);
    if (t < k.Tg)
      alpha_frame<G, WS>(k, P, t, t + 1 < k.Tg ? t + 1 : -1, t & 1, dst,
                         nullptr);
  }
  // logZ: each block's (max, sum of exp) of alpha + F over its columns,
  // per utterance and tensor; rank 0 combines them in rank order
  const size_t V = k.V;
  for (int c = warp; c < 2 * G; c += nw) {
    const int g = c >> 1, src = c & 1;
    const float* a = (src == 0 ? k.ain : k.abl) + g * k.col;
    float mx = LOWEST;
    for (int e = lane; e < k.col; e += 32) {
      const int x = e / k.S, s = e - x * k.S;
      if (s < k.nb) mx = fmaxf(mx, a[e] + __ldg(P.fin + x * V + k.b0 + s));
    }
    mx = fmaxf(warp_max(mx), LOG_EPS);
    float sm = 0.f;
    for (int e = lane; e < k.col; e += 32) {
      const int x = e / k.S, s = e - x * k.S;
      if (s < k.nb) sm += expf(a[e] + __ldg(P.fin + x * V + k.b0 + s) - mx);
    }
    sm = warp_sum(sm);
    if (lane == 0) {
      k.pz[c * 2] = mx;
      k.pz[c * 2 + 1] = sm;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (k.j == 0 && warp == 0) {
    float q[4 * G];
    const float* rp = lane < k.C ? cluster.map_shared_rank(k.pz, lane)
                                 : k.pz;
#pragma unroll
    for (int i = 0; i < 4 * G; ++i) q[i] = rp[i];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float lse[2];
#pragma unroll
      for (int src = 0; src < 2; ++src) {
        const float mr = lane < k.C ? q[(2 * g + src) * 2] : LOWEST;
        const float mx = fmaxf(warp_max(mr), LOG_EPS);
        float sm = 0.f;
        for (int r = 0; r < k.C; ++r) {
          const float m_r = __shfl_sync(FULL, mr, r);
          const float s_r =
              __shfl_sync(FULL, q[(2 * g + src) * 2 + 1], r);
          sm += s_r * expf(m_r - mx);
        }
        lse[src] = from_sum(mx, sm);
      }
      if (lane == 0 && k.un[g] >= 0) P.logz[k.un[g]] = lae(lse[0], lse[1]);
    }
  }
  // no block leaves while rank 0 may read its shared memory
  cluster.sync();
}

// k.pre <- one frame of the scratch (3 SC floats), 16 bytes at a time
__device__ __forceinline__ void fetch_pre(const Block& k, const float* src) {
  for (int i = threadIdx.x * 4; i < 3 * k.SC; i += blockDim.x * 4) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(k.pre + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One reverse frame of the backward: the gradient entries of the own
// columns, the betas before frame t. k.pre holds frame t's pre-update
// alphas and emit0 (column layout, as `alpha_frame` wrote them); this
// frame fetches those of frame t - 1 from `scr_prev` (none if null) and y
// of frame t_prev. `xpar` is the exchange's parity.
template <int G, bool WS>
__device__ void beta_frame(const Block& k, const Params& P, int t,
                           int t_prev, int xpar, const float* scr_prev) {
  constexpr int PG = (2 * G + 3) / 4 * 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int V = k.V, S = k.S, nb = k.nb, col = k.col, SC = k.SC;
  cg::cluster_group cluster = cg::this_cluster();
  int slot;
  const float yv = load_y<G>(k, P, t_prev, slot);
  const float* ys = k.y + (t & 1) * G * (S + 1);
  // GRP lanes per own column (g, s), u = b0 + s, over rows x: the stay
  // + emission posteriors into (x, u) (the gradient entry of u), the
  // blank posterior out of (x, u) (a column of the blank entry), and
  // rhs[x, u] = y[u] + b_in[x, u] to the block that owns row x
  const int l8 = tid & (GRP - 1), ng = nt / GRP, cols = G * nb;
  for (int base = 0; base < cols; base += ng) {
    const int c = base + tid / GRP;
    const bool on = c < cols;
    const int g = on ? c / nb : 0, s = on ? c - g * nb : 0, u = k.b0 + s;
    const float yu = ys[g * (S + 1) + s], y0 = ys[g * (S + 1) + S];
    const float lz = k.lz[g];
    float s0 = 0.f, s1 = 0.f;
    for (int x = l8; on && x < V; x += GRP) {
      const int e = g * col + x * S + s;
      const float ai = k.pre[e], ab = k.pre[SC + e], e0 = k.pre[2 * SC + e];
      const float bi = k.bin[e], bb = k.bbl[e];
      s0 += posterior_fast(ai + yu + bi - lz) +
            posterior_fast(e0 + yu + bi - lz);
      s1 += posterior_fast(lae_fast(ai, ab) + y0 + bb - lz);
      float* to = cluster.map_shared_rank(k.ex, k.own[x]);
      to[((xpar * G + g) * S + k.loc[x]) * V + u] = yu + bi;
    }
    s0 = group_sum(s0);
    s1 = group_sum(s1);
    if (on && l8 == 0) {
      if (u > 0 && t < k.ul[g])
        P.grad[((size_t)k.un[g] * P.T + t) * V + u] = s0 * k.gn[g];
      k.cols[g * S + s] = s1;
    }
  }
  __syncthreads();
  if (tid < G) {
    float sm = 0.f;
    for (int s = 0; s < nb; ++s) sm += k.cols[tid * S + s];
    k.part[xpar * G + tid] = sm;
  }
  if (scr_prev != nullptr) fetch_pre(k, scr_prev);
  cluster.sync();
  // the blank entry: rank 0 sums the blocks' parts in rank order, in its
  // last warp (which has no row below at V = 72), lane g for utterance g,
  // all blocks' parts loaded at once
  if (k.j == 0 && warp == nw - 1 && lane < G) {
    float q[MAX_C];
#pragma unroll
    for (int r = 0; r < MAX_C; ++r)
      q[r] = r < k.C ? cluster.map_shared_rank(k.part, r)[xpar * G + lane]
                     : 0.f;
    float sm = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_C; ++r) sm += q[r];
    if (t < k.ul[lane])
      P.grad[((size_t)k.un[lane] * P.T + t) * V] = sm * k.gn[lane];
  }
  // rows b = b0 + s of rhs: maxima over u (all u, and u != b) and the
  // exp-domain products (parity 0 of k.p, k.m), GRP lanes per row (g, s)
  const float* ex = k.ex + xpar * G * col;
  for (int base = 0; base < cols; base += ng) {
    const int c = base + tid / GRP;
    const bool on = c < cols;
    const int g = on ? c / nb : 0, s = on ? c - g * nb : 0, b = k.b0 + s;
    const float* r = ex + (g * S + s) * V;
    float ma = LOWEST, mn = LOWEST;
    for (int u = l8; on && u < V; u += GRP) {
      const float v = r[u];
      ma = fmaxf(ma, v);
      mn = fmaxf(mn, u == b ? LOG_EPS : v);
    }
    ma = fmaxf(group_max(ma), LOG_EPS);
    mn = fmaxf(group_max(mn), LOG_EPS);
    for (int u = l8; on && u < V; u += GRP) {
      const float v = r[u];
      float* pp = k.p + (s * V + u) * PG;
      pp[g] = __expf(v - ma);
      pp[G + g] = __expf((u == b ? LOG_EPS : v) - mn);
    }
    if (on && l8 == 0) {
      k.m[g * S + s] = ma;
      k.m[(G + g) * S + s] = mn;
    }
  }
  __syncthreads();
  // E[a, b] over u for tiles of NT outputs (a_q, b), a_q = ta + q UT, the
  // sums over u split over a tile's KP lanes (u = h, h + KP, ...): into
  // parity 1 of k.p as [k][g][a][s], lane h writing output q = h
  float* esum = k.p + col * PG;
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    int h;
    const int tile = tile_of(i, h);
    if (__all_sync(FULL, tile >= nb * k.UT)) break;
    const int tl = min(tile, max(nb * k.UT - 1, 0));
    const int s = tl / k.UT, ta = tl - s * k.UT, b = k.b0 + s;
    float acc[NT][PG];
#pragma unroll
    for (int q = 0; q < NT; ++q)
#pragma unroll
      for (int j = 0; j < 2 * G; ++j) acc[q][j] = 0.f;
    int aq[NT];
#pragma unroll
    for (int q = 0; q < NT; ++q) aq[q] = min(ta + q * k.UT, V - 1);
    const float* pp = k.p + s * V * PG;
    if (WS) {
      const float* wp = k.w + s * V;
#pragma unroll 2
      for (int u = h; u < V; u += KP) {
        float w[NT];
#pragma unroll
        for (int q = 0; q < NT; ++q) w[q] = wp[aq[q] * k.AS + u];
        fma_tile<G>(acc, pp + u * PG, w);
      }
    } else {
      const float* wp = P.w + (size_t)b * V;
      const size_t VV = (size_t)V * V;
#pragma unroll 2
      for (int u = h; u < V; u += KP) {
        float w[NT];
#pragma unroll
        for (int q = 0; q < NT; ++q) w[q] = __ldg(wp + aq[q] * VV + u);
        fma_tile<G>(acc, pp + u * PG, w);
      }
    }
    float sum[PG];
    reduce_parts<G>(acc, sum, h);
    const int a = ta + h * k.UT;
    if (tile >= nb * k.UT || a >= V) continue;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      esum[g * col + a * S + s] = sum[g];
      esum[(G + g) * col + a * S + s] = sum[G + g];
    }
  }
  __syncthreads();
  // the betas before frame t at the own columns (a, b), every thread
  for (int e = tid; e < G * col; e += nt) {
    const int g = e / col, r = e - g * col, a = r / S, s = r - a * S;
    if (s >= nb || t >= k.ul[g]) continue;
    const float e_all = from_sum_fast(k.m[g * S + s], esum[e]);
    const float e_nr = from_sum_fast(k.m[(G + g) * S + s], esum[G * col + e]);
    const float stay = ys[g * (S + 1) + s] + k.bin[e];
    const float blank = ys[g * (S + 1) + S] + k.bbl[e];
    k.bin[e] = fmaxf(lae_fast(lae_fast(stay, e_nr), blank), LOG_EPS);
    k.bbl[e] = fmaxf(lae_fast(e_all, blank), LOG_EPS);
  }
  if (slot >= 0) k.y[((t & 1) ^ 1) * G * (S + 1) + slot] = yv;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

template <int G, bool WS>
__global__ void __launch_bounds__(MAX_THREADS, 1) den_bwd_kernel(Params P) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Block k = setup<G>(P, smem, WS, true);
  const int tid = threadIdx.x, nt = blockDim.x, V = k.V, col = k.col;
  // betas after the last frame: F; gradient rows past each length: 0
  for (int e = tid; e < G * col; e += nt) {
    const int r = e % col, x = r / k.S, s = r - x * k.S;
    if (s < k.nb) k.bin[e] = k.bbl[e] = __ldg(P.fin + x * V + k.b0 + s);
  }
  for (int g = 0; g < G; ++g) {
    const int n = k.un[g];
    if (n < 0) continue;
    for (int i = tid; i < (P.T - k.ul[g]) * k.nb; i += nt) {
      const int t = k.ul[g] + i / k.nb, s = i % k.nb;
      P.grad[((size_t)n * P.T + t) * V + k.b0 + s] = 0.f;
    }
  }
  float* dst[IPT];
  emit_targets(k, dst);
  finish_setup();
  const size_t per_frame = (size_t)3 * k.SC;
  float* scr = P.scratch + (size_t)blockIdx.x * P.K * per_frame;
  const size_t VV = (size_t)V * V;
  int fc = 0;  // frames run, for the exchange's parity
  for (int seg = (P.T + P.K - 1) / P.K - 1; seg >= 0; --seg) {
    const int t0 = seg * P.K;
    if (t0 >= k.Tg) continue;
    const int t1 = min(t0 + P.K, k.Tg);
    for (int e = tid; e < G * col; e += nt) {
      const int g = e / col, r = e - g * col, x = r / k.S, s = r - x * k.S;
      const int n = k.un[g];
      if (s >= k.nb) continue;
      if (n < 0) {
        k.ain[e] = k.abl[e] = LOG_EPS;
        continue;
      }
      const size_t off = ((size_t)seg * P.N + n) * VV + x * V + k.b0 + s;
      k.ain[e] = __ldg(P.snap_in + off);
      k.abl[e] = __ldg(P.snap_bl + off);
    }
    store_y<G>(k, P, t0);
    __syncthreads();
    prime<G>(k, t0 & 1);
    __syncthreads();
    for (int t = t0; t < t1; ++t, ++fc)
      alpha_frame<G, WS>(k, P, t, t + 1 < t1 ? t + 1 : -1, fc & 1, dst,
                         scr + (t - t0) * per_frame);
    fetch_pre(k, scr + (t1 - 1 - t0) * per_frame);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int t = t1 - 1; t >= t0; --t, ++fc)
      beta_frame<G, WS>(k, P, t, t > t0 ? t - 1 : -1, fc & 1,
                        t > t0 ? scr + (t - 1 - t0) * per_frame : nullptr);
  }
  // no block leaves while rank 0 may read its shared memory
  cg::this_cluster().sync();
}

template <int G>
const void* kernel_for(bool bwd, bool ws) {
  if (bwd)
    return ws ? (const void*)den_bwd_kernel<G, true>
              : (const void*)den_bwd_kernel<G, false>;
  return ws ? (const void*)den_fwd_kernel<G, true>
            : (const void*)den_fwd_kernel<G, false>;
}

const void* kernel_for(int G, bool bwd, bool ws) {
  switch (G) {
    case 1: return kernel_for<1>(bwd, ws);
    case 2: return kernel_for<2>(bwd, ws);
    case 3: return kernel_for<3>(bwd, ws);
    case 4: return kernel_for<4>(bwd, ws);
    case 5: return kernel_for<5>(bwd, ws);
    case 6: return kernel_for<6>(bwd, ws);
    case 7: return kernel_for<7>(bwd, ws);
    case 8: return kernel_for<8>(bwd, ws);
  }
  return nullptr;
}

// The kernel of a plan, its attributes set, and its launch configuration
// (cluster dimension in `attr`); an error if the plan is not one this file
// can run, or if `smem` is not its layout's size.
cudaError_t configure(int N, int V, int C, int G, int ws, int smem, bool bwd,
                      void* stream, const void** fn, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  if (C < 1 || C > MAX_C || C > V || G < 1 || G > MAX_G)
    return cudaErrorInvalidValue;
  const Layout L = make_layout(V, C, G, ws != 0, bwd);
  if ((size_t)smem != sizeof(float) * L.total || smem > SMEM_LIMIT ||
      L.S * L.UT > IPT * (L.threads / 32) * TPW)
    return cudaErrorInvalidValue;
  *fn = kernel_for(G, bwd, ws != 0);
  cudaError_t err = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && C > 8)
    err = cudaFuncSetAttribute(
        *fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(((N + G - 1) / G) * C));
  cfg->blockDim = dim3((unsigned)L.threads);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

cudaError_t launch(const Params& p, int C, int G, int ws, int smem, bool bwd,
                   void* stream) {
  const void* fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      configure(p.N, p.V, C, G, ws, smem, bwd, stream, &fn, &cfg, &attr);
  if (err != cudaSuccess) return err;
  Params arg = p;
  void* args[] = {&arg};
  err = cudaLaunchKernelExC(&cfg, fn, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// How many clusters of the plan (C blocks, G utterances, W route `ws`)
// the card holds at once, into *out (a host int).
extern "C" int den_clusters(void* out, int V, int C, int G, int ws, int bwd,
                            void* stream) {
  const Layout L = make_layout(V, C, G, ws != 0, bwd != 0);
  const int smem = (int)sizeof(float) * L.total;
  const void* fn;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(G, V, C, G, ws, smem, bwd != 0, stream, &fn,
                              &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(static_cast<int*>(out), fn, &cfg);
}

// lp (N, T, V) f32, lens (N,) int64, order (N,) int32 (utterances longest
// first), w = expW (V, V, V), fin = F (V, V); snap_in, snap_bl (S_T, N, V,
// V) with S_T = ceil(T / K); logz (N,). C, G, ws, smem: the plan.
extern "C" int den_fwd(const void* lp, const void* lens, const void* order,
                       const void* w, const void* fin, void* snap_in,
                       void* snap_bl, void* logz, int N, int T, int V, int K,
                       int C, int G, int ws, int smem, void* stream) {
  if (N <= 0 || T <= 0) return cudaSuccess;
  if (V <= 0 || K <= 0) return cudaErrorInvalidValue;
  Params p{};
  p.lp = static_cast<const float*>(lp);
  p.lens = static_cast<const long long*>(lens);
  p.order = static_cast<const int*>(order);
  p.w = static_cast<const float*>(w);
  p.fin = static_cast<const float*>(fin);
  p.snap_in = static_cast<float*>(snap_in);
  p.snap_bl = static_cast<float*>(snap_bl);
  p.logz = static_cast<float*>(logz);
  p.N = N;
  p.T = T;
  p.V = V;
  p.K = K;
  return launch(p, C, G, ws, smem, false, stream);
}

// The backward: g (N,) the incoming gradient; grad (N, T, V) out; scratch
// ceil(N / G) C x K x 3 x al4(G V ceil(V / C)) f32.
extern "C" int den_bwd(const void* lp, const void* lens, const void* order,
                       const void* w, const void* fin, const void* snap_in,
                       const void* snap_bl, const void* logz, const void* g,
                       void* grad, void* scratch, int N, int T, int V, int K,
                       int C, int G, int ws, int smem, void* stream) {
  if (N <= 0 || T <= 0) return cudaSuccess;
  if (V <= 0 || K <= 0) return cudaErrorInvalidValue;
  Params p{};
  p.lp = static_cast<const float*>(lp);
  p.lens = static_cast<const long long*>(lens);
  p.order = static_cast<const int*>(order);
  p.w = static_cast<const float*>(w);
  p.fin = static_cast<const float*>(fin);
  p.snap_in = const_cast<float*>(static_cast<const float*>(snap_in));
  p.snap_bl = const_cast<float*>(static_cast<const float*>(snap_bl));
  p.logz = const_cast<float*>(static_cast<const float*>(logz));
  p.g = static_cast<const float*>(g);
  p.grad = static_cast<float*>(grad);
  p.scratch = static_cast<float*>(scratch);
  p.N = N;
  p.T = T;
  p.V = V;
  p.K = K;
  return launch(p, C, G, ws, smem, true, stream);
}
