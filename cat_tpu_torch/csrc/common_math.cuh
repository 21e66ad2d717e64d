// Helpers shared by the port's kernels that need no tensor cores: the
// bf16 type, Philox dropout bits, warp sums, LayerNorm row statistics,
// four-value bf16 loads and stores, and the sigmoid.
//
// Dropout bits: Philox-4x32-10 (Salmon et al., SC'11), counter-based, so
// a keep decision is a pure function of (seed, stream, plane, row,
// column) and forward and backward kernels draw the same mask whatever
// their tiling. Counter = (column / 4, row, plane, stream), key = the two
// seed words; word i of the output decides column 4*(column/4) + i. A
// value is kept iff its word >= thr = min(floor(rate * 2^32), 2^32 - 1)
// and kept values are scaled by 1 / (1 - rate). The plain PyTorch twin is
// `cat_tpu_torch/ops/dropout.py`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace catk {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// Dropout parameters as the wrappers pass them.
struct Drop {
  uint32_t seed0, seed1, thr;
  float inv;  // 1 / (1 - rate)
};

// Keep bits of columns 4g .. 4g+3 (bit i for column 4g + i) of `row` in
// `plane` of `stream`. thr == 0 (rate 0) keeps everything without Philox.
__device__ __forceinline__ unsigned keep4(const Drop& d, uint32_t stream,
                                          uint32_t plane, uint32_t row,
                                          uint32_t g) {
  if (d.thr == 0u) return 0xFu;
  const uint4 b = philox4x32_10(make_uint4(g, row, plane, stream), d.seed0,
                                d.seed1);
  return (b.x >= d.thr ? 1u : 0u) | (b.y >= d.thr ? 2u : 0u) |
         (b.z >= d.thr ? 4u : 0u) | (b.w >= d.thr ? 8u : 0u);
}

__device__ __forceinline__ float keep_scale(const Drop& d, unsigned bits,
                                            int i) {
  return (bits >> i) & 1u ? d.inv : 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm statistics of a row of 128·V values that a warp holds, V
// groups of 4 a lane: the mean and 1 / sqrt(variance + eps), f32, the
// variance from a second pass over the values.
template <int V>
__device__ __forceinline__ void row_stats(const float (&v)[V][4], float eps,
                                          float& mean, float& rstd) {
  constexpr int D = 128 * V;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += v[j][e];
  mean = warp_sum(s) / D;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) ss += (v[j][e] - mean) * (v[j][e] - mean);
  rstd = rsqrtf(warp_sum(ss) / D + eps);
}

// Four consecutive bf16 values, as one uint2 holds them, as f32.
__device__ __forceinline__ void unpack4(uint2 u, float (&v)[4]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

// Four consecutive bf16 values as f32, and back (8-byte aligned).
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  unpack4(*reinterpret_cast<const uint2*>(p), v);
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + __expf(-x));
}

}  // namespace catk
