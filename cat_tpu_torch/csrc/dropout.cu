// Standalone dropout: out = x * keep / (1 - rate), in one pass; and the
// keep factors alone, (R, C) f32, for the attention dropout of the
// transformer decoders.
//
// Replaces the TPU kernels `_kernel` and `_kernel3` of
// `cat_tpu/ops/dropout_pallas.py` (`pallas_call` in `_run`, under the
// custom VJP `fused_dropout`). The mask is the Philox-4x32-10 mask of
// common.cuh, keyed by (seed, stream, plane 0, row, column) over the
// (R, C) rows of the flattened tensor, so the backward, which runs this
// same kernel on the cotangent with the same seed, applies the same mask
// and nothing is stored. Each value is multiplied in f32 and rounded once
// to the storage type, as `dropout_reference` in `ops/dropout.py` does, so
// the kernel and the plain version agree bit for bit. `dropout_mask`
// writes the factor itself (1 / (1 - rate) kept, 0 dropped), bit for bit
// `dropout_scale(seed, stream, 1, R, C, rate)`, reading no input: the
// decoders' attention (`models/decoders.py` `attend`) multiplies its
// probabilities by it, one launch a mask.
//
// What bounds it on the H100: bytes. At the crf-v1 training batch (32 x
// 493 x 512 bf16) it reads 16.2 MB and writes 16.2 MB, 9.6 us at
// 3.35 TB/s; one Philox call (10 rounds of two 32-bit multiplies) serves
// four values, far below the integer rate. The design: every access is
// 16 bytes (four f32 values, one Philox group, or eight bf16 values, two
// groups); a thread holds UNROLL such chunks, strided by the grid so that
// neighbouring threads touch neighbouring addresses, and issues all their
// loads before the Philox rounds, whose draws are independent and
// interleave; the grid is a few blocks an SM and strides over the tensor.
// Rows whose width is no multiple of four, or tensors not 16-byte
// aligned, take a thread a Philox group with scalar accesses.
#include "common.cuh"

namespace {

using namespace catk;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;         // 16-byte chunks a thread holds at once
constexpr int BLOCKS_PER_SM = 4;  // blocks of the strided grid

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// Philox group q of the flattened (R, C) rows, C % 4 == 0: row q / gpr,
// group q % gpr of it (gpr = C / 4 groups a row).
__device__ __forceinline__ unsigned group_bits(const Drop& d, uint32_t stream,
                                               uint32_t q, uint32_t gpr) {
  const uint32_t row = q / gpr;
  return keep4(d, stream, 0u, row, q - row * gpr);
}

// One 16-byte chunk: x times the keep factors of its G groups (bits[g]).
__device__ __forceinline__ uint4 apply(uint4 v, const unsigned (&bits)[1],
                                       const Drop& d, float) {
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] *= keep_scale(d, bits[0], k);
  return v;
}

__device__ __forceinline__ uint4 apply(uint4 v, const unsigned (&bits)[2],
                                       const Drop& d, bf16) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[k]));
    const unsigned b = bits[k >> 1];
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        f.x * keep_scale(d, b, 2 * (k & 1)),
        f.y * keep_scale(d, b, 2 * (k & 1) + 1));
    w[k] = *reinterpret_cast<const uint32_t*>(&r);
  }
  return v;
}

// The factors of one f32 chunk (one group), for the mask.
__device__ __forceinline__ uint4 factors(unsigned bits, const Drop& d) {
  return make_uint4(__float_as_uint(keep_scale(d, bits, 0)),
                    __float_as_uint(keep_scale(d, bits, 1)),
                    __float_as_uint(keep_scale(d, bits, 2)),
                    __float_as_uint(keep_scale(d, bits, 3)));
}

// The 16-byte route: `groups` Philox groups of the flattened rows (C % 4
// == 0), G = 16 / (4 · sizeof(T)) of them a chunk; with x null, the f32
// factors themselves (T float). A bf16 tensor of an odd number of groups
// ends in a chunk of one group, moved as 8 bytes.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_vec(const uint4* __restrict__ x, uint4* __restrict__ out,
                uint32_t groups, uint32_t gpr, Drop d, uint32_t stream) {
  constexpr int G = 4 / sizeof(T);
  const uint32_t chunks = (groups + G - 1) / G;
  const uint32_t step = gridDim.x * THREADS;
  for (uint32_t base = blockIdx.x * THREADS + threadIdx.x; base < chunks;
       base += step * UNROLL) {
    uint4 v[UNROLL];
    if (x != nullptr) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t i = base + u * step;
        if (i < chunks) {
          if (G == 2 && 2 * i + 1 == groups) {  // the last, lone group
            const uint2 h = *reinterpret_cast<const uint2*>(x + i);
            v[u] = make_uint4(h.x, h.y, 0u, 0u);
          } else {
            v[u] = x[i];
          }
        }
      }
    }
    unsigned bits[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const uint32_t q = (base + u * step) * G + g;
        bits[u][g] = q < groups ? group_bits(d, stream, q, gpr) : 0u;
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const uint32_t i = base + u * step;
      if (i >= chunks) break;
      if (x == nullptr) {
        out[i] = factors(bits[u][0], d);
        continue;
      }
      const uint4 r = apply(v[u], bits[u], d, T());
      if (G == 2 && 2 * i + 1 == groups)
        *reinterpret_cast<uint2*>(out + i) = make_uint2(r.x, r.y);
      else
        out[i] = r;
    }
  }
}

// The scalar route: a thread a Philox group (row, g) of (R, C), any C;
// with x null, the f32 factors.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_groups(const T* __restrict__ x, T* __restrict__ out, int R, int C,
                   Drop d, uint32_t stream) {
  const int gpr = (C + 3) / 4;
  const long long n = (long long)R * gpr;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    const int row = (int)(i / gpr), g = (int)(i % gpr);
    const unsigned bits = keep4(d, stream, 0u, (uint32_t)row, (uint32_t)g);
    const size_t o = (size_t)row * C + 4 * g;
    for (int k = 0; k < 4 && 4 * g + k < C; ++k)
      out[o + k] = x == nullptr ? from_f32<T>(keep_scale(d, bits, k))
                                : from_f32<T>(to_f32(x[o + k]) *
                                              keep_scale(d, bits, k));
  }
}

// Blocks of a strided grid whose route would need `work` blocks to cover
// its tensor in one sweep: at most BLOCKS_PER_SM an SM (the count read once
// per device).
unsigned grid(long long work) {
  static int dev_seen = -1, sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess && dev != dev_seen) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    dev_seen = dev;
  }
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  return (unsigned)(work < cap ? (work > 0 ? work : 1) : cap);
}

template <typename T>
cudaError_t launch(const void* x, void* out, int R, int C, const Drop& d,
                   int stream_id, cudaStream_t s) {
  const long long groups = (long long)R * ((C + 3) / 4);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (C % 4 == 0 && aligned && groups < (1LL << 31)) {
    constexpr int G = 4 / sizeof(T);
    const long long chunks = (groups + G - 1) / G;
    dropout_vec<T><<<grid((chunks + THREADS * UNROLL - 1) / (THREADS * UNROLL)),
                     THREADS, 0, s>>>(
        static_cast<const uint4*>(x), static_cast<uint4*>(out),
        (uint32_t)groups, (uint32_t)(C / 4), d, (uint32_t)stream_id);
  } else {
    dropout_groups<T><<<grid((groups + THREADS - 1) / THREADS), THREADS, 0,
                         s>>>(static_cast<const T*>(x), static_cast<T*>(out),
                              R, C, d, (uint32_t)stream_id);
  }
  return cudaGetLastError();
}

}  // namespace

// x, out (R, C) contiguous, bf16 (is_f32 0) or f32 (is_f32 1); seed0,
// seed1, thr are the seed words and the keep threshold as uint32 bit
// patterns (thr 0: keep everything), inv = 1 / (1 - rate). Rows of a
// multiple of 4 values with both pointers 16-byte aligned take the
// 16-byte route, others the scalar one; both give the same bits.
extern "C" int dropout_fwd(const void* x, void* out, int R, int C, int is_f32,
                           int stream_id, int seed0, int seed1, int thr,
                           float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (R <= 0 || C <= 0) return cudaSuccess;
  return is_f32 ? launch<float>(x, out, R, C, d, stream_id, s)
                : launch<bf16>(x, out, R, C, d, stream_id, s);
}

// out (R, C) f32 contiguous: the keep factors of (seed, stream_id, plane
// 0), 1 / (1 - rate) = inv where kept and 0 where dropped; the other
// arguments as dropout_fwd's.
extern "C" int dropout_mask(void* out, int R, int C, int stream_id,
                            int seed0, int seed1, int thr, float inv,
                            void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (R <= 0 || C <= 0) return cudaSuccess;
  return launch<float>(nullptr, out, R, C, d, stream_id, s);
}
