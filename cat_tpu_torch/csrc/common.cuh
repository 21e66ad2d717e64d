// Helpers shared by the port's wmma kernels (bf16 operands, f32 sums): the
// attention kernels for head dimensions 16, 32 and 128
// (relpos_attention_fwd.cu, relpos_attention_bwd.cu), whose products use
// the warp-level `nvcuda::wmma` bf16 16x16x16 fragments on tiles kept in
// shared memory. The Philox dropout bits, warp sums and the sigmoid are in
// common_math.cuh.
#pragma once

#include <mma.h>

#include "common_math.cuh"

namespace catk {

using namespace nvcuda;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragB;
// B given as its transpose, row-major: B[k][n] = src[n * ld + k].
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBT;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;
// A given as its transpose, row-major: A[i][k] = src[k * ld + i].
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    FragAT;

__host__ __device__ constexpr int align128(int bytes) {
  return (bytes + 127) / 128 * 128;
}

}  // namespace catk
