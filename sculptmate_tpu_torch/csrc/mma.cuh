// Shared helpers for the port's Hopper kernels: bf16 packing and the
// warp-level m16n8k16 bf16 tensor-core product (mma.sync, f32 accumulate).
//
// Fragment layout of mma.m16n8k16 (lane = threadIdx.x % 32, g = lane / 4,
// c = (lane % 4) * 2), which every kernel here relies on:
//   A (16x16, row-major): a0 = A[g][c..c+1]   a1 = A[g+8][c..c+1]
//                         a2 = A[g][c+8..c+9] a3 = A[g+8][c+8..c+9]
//   B (16x8, "col"):      b0 = B[c..c+1][g]   b1 = B[c+8..c+9][g]
//   C (16x8, f32):        c0,c1 = C[g][c..c+1]  c2,c3 = C[g+8][c..c+1]
// Two adjacent C tiles (columns 16j..16j+15) therefore ARE the A fragment
// of k-chunk j of the next product once packed to bf16 — activations never
// leave registers between products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm_port {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t *>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
    __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162 *>(&u);
    return __bfloat1622float2(v);
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace sm_port
