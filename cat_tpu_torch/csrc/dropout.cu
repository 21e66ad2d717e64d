// Standalone dropout: out = x * keep / (1 - rate), in one pass.
//
// Replaces the TPU kernels `_kernel` and `_kernel3` of
// `cat_tpu/ops/dropout_pallas.py` (`pallas_call` in `_run`, under the
// custom VJP `fused_dropout`). The mask is the Philox-4x32-10 mask of
// common.cuh, keyed by (seed, stream, plane 0, row, column) over the
// (R, C) rows of the flattened tensor, so the backward, which runs this
// same kernel on the cotangent with the same seed, applies the same mask
// and nothing is stored. Each value is multiplied in f32 and rounded once
// to the storage type, as `dropout_reference` in `ops/dropout.py` does, so
// the kernel and the plain version agree bit for bit.
//
// What bounds it on the H100: bytes. At the crf-v1 training batch (32 x
// 493 x 512 bf16) it reads 16.2 MB and writes 16.2 MB, 9.6 us at
// 3.35 TB/s; one Philox call (10 rounds of two 32-bit multiplies) serves
// four values, far below the integer rate. The design: one thread per
// group of four columns, so one Philox call per thread and neighbouring
// threads on neighbouring addresses; the group's four values move as one
// 8-byte (bf16) or 16-byte (f32) access when the row width is a multiple
// of four, else one by one.
#include "common.cuh"

namespace {

using namespace catk;

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

// Four values of type T moved as one access.
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

template <typename T>
__global__ void __launch_bounds__(256)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, int R, int C,
                   Drop d, uint32_t stream) {
  const int G = (C + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)R * G) return;
  const int row = (int)(i / G), g = (int)(i % G);
  const unsigned bits = keep4(d, stream, 0u, (uint32_t)row, (uint32_t)g);
  const size_t base = (size_t)row * C + 4 * g;
  if (C % 4 == 0) {
    Quad<T> q = *reinterpret_cast<const Quad<T>*>(x + base);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q.v[k] = from_f32<T>(to_f32(q.v[k]) * keep_scale(d, bits, k));
    *reinterpret_cast<Quad<T>*>(out + base) = q;
  } else {
    for (int k = 0; k < 4 && 4 * g + k < C; ++k)
      out[base + k] = from_f32<T>(to_f32(x[base + k]) * keep_scale(d, bits, k));
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, int R, int C, const Drop& d,
                   int stream_id, cudaStream_t s) {
  const long long n = (long long)R * ((C + 3) / 4);
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dropout_kernel<T><<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), R, C, d,
      (uint32_t)stream_id);
  return cudaGetLastError();
}

}  // namespace

// x, out (R, C) contiguous, bf16 (is_f32 0) or f32 (is_f32 1); seed0,
// seed1, thr are the seed words and the keep threshold as uint32 bit
// patterns (thr 0: keep everything), inv = 1 / (1 - rate). With C % 4 == 0
// both pointers must be aligned to four values.
extern "C" int dropout_fwd(const void* x, void* out, int R, int C, int is_f32,
                           int stream_id, int seed0, int seed1, int thr,
                           float inv, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const Drop d{(uint32_t)seed0, (uint32_t)seed1, (uint32_t)thr, inv};
  if (R <= 0 || C <= 0) return cudaSuccess;
  return is_f32 ? launch<float>(x, out, R, C, d, stream_id, s)
                : launch<bf16>(x, out, R, C, d, stream_id, s);
}
