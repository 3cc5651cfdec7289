// K2: fused triplane density MLP over the full R^3 marching-cubes lattice.
//
// Replaces: sculptmate_tpu/ops/density_grid.py:query_density_grid, the
// z-slab lax.map program that runs the NeRF decoder's hidden layers over
// every lattice point on the TPU.
//
// Per lattice point (i, j, k) it forms h1 = silu(A[i,j] + B[k,i] + C[k,j])
// from the three factorized first-layer partial sums (small matmuls done in
// torch; A already holds the first-layer bias), runs the L hidden 64x64 SiLU
// layers, keeps output channel 0 of the 64->4 output layer, and writes
// exp(d + density_bias) as f32 in [x, y, z] order.
//
// Bound on the H100: operations. At R = 256 the lattice is 16.8 M points x
// ~66 K flops each (1.1 TFLOP) against a 67 MB f32 output.
//
// Design: all hidden weights live in shared memory for the whole block
// (L x 64 x 72 bf16, rows padded against bank conflicts: ~74 KB at L = 8, so
// dynamic shared memory). Each warp takes 16 consecutive lattice points as
// the M dimension of mma.sync m16n8k16 and keeps its activations in
// registers across every layer: a layer's f32 accumulators, plus bias and
// SiLU, pack straight into the next layer's bf16 A fragments (see mma.cuh),
// so no activation ever touches shared or device memory. The output layer
// needs only channel 0: a 64-wide dot product reduced across each quad.
// Warps stride over the lattice, so the weights are loaded once per block.

#include <math.h>

#include "mma.cuh"

namespace {

using namespace sm_port;

constexpr int HW = 64;    // hidden width (the wrapper rejects any other)
constexpr int WPAD = 72;  // smem row stride in bf16
constexpr int WARPS = 8;

__device__ __forceinline__ float silu(float x) { return x / (1.f + __expf(-x)); }

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// first-layer activations of one lattice point for this lane's 16 channels,
// in A-fragment order: element (kc, half) covers channels kc*16 + half*8 + c
__device__ __forceinline__ void first_layer(const __nv_bfloat16 *__restrict__ A,
                                            const __nv_bfloat16 *__restrict__ B,
                                            const __nv_bfloat16 *__restrict__ C,
                                            long long p, long long total, int R,
                                            int c, uint32_t out[8]) {
    if (p >= total) {
#pragma unroll
        for (int e = 0; e < 8; ++e) out[e] = 0u;
        return;
    }
    const long long RR = (long long)R * R;
    const int i = (int)(p / RR), j = (int)((p / R) % R), kk = (int)(p % R);
    const __nv_bfloat16 *ap = A + ((size_t)i * R + j) * HW;
    const __nv_bfloat16 *bp = B + ((size_t)kk * R + i) * HW;
    const __nv_bfloat16 *cp = C + ((size_t)kk * R + j) * HW;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
        const int ch = (e >> 1) * 16 + (e & 1) * 8 + c;
        const float2 a = unpack_bf16(*reinterpret_cast<const uint32_t *>(ap + ch));
        const float2 b = unpack_bf16(*reinterpret_cast<const uint32_t *>(bp + ch));
        const float2 cc = unpack_bf16(*reinterpret_cast<const uint32_t *>(cp + ch));
        out[e] = pack_bf16(silu(a.x + b.x + cc.x), silu(a.y + b.y + cc.y));
    }
}

__global__ void __launch_bounds__(WARPS * 32)
density_mlp_bf16(const __nv_bfloat16 *__restrict__ A,
                 const __nv_bfloat16 *__restrict__ B,
                 const __nv_bfloat16 *__restrict__ C,
                 const __nv_bfloat16 *__restrict__ W,  // (L, 64 out, 64 in)
                 const float *__restrict__ bias,       // (L, 64)
                 const float *__restrict__ wout,       // (65,) channel 0 + its bias
                 float density_bias, float *__restrict__ out,
                 int R, int L) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16 *Ws = reinterpret_cast<__nv_bfloat16 *>(smem);
    float *bs = reinterpret_cast<float *>(Ws + (size_t)L * HW * WPAD);
    float *wo = bs + L * HW;  // HW weights, then the bias

    for (int idx = threadIdx.x; idx < L * HW * (HW / 8); idx += blockDim.x) {
        const int row = idx / (HW / 8), ch = (idx % (HW / 8)) * 8;
        *reinterpret_cast<uint4 *>(Ws + row * WPAD + ch) =
            *reinterpret_cast<const uint4 *>(W + (size_t)row * HW + ch);
    }
    for (int idx = threadIdx.x; idx < L * HW; idx += blockDim.x) bs[idx] = bias[idx];
    for (int idx = threadIdx.x; idx <= HW; idx += blockDim.x) wo[idx] = wout[idx];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = (lane & 3) * 2;
    const long long total = (long long)R * R * R;
    const long long ntiles = (total + 15) / 16;

    for (long long tile = (long long)blockIdx.x * WARPS + warp; tile < ntiles;
         tile += (long long)gridDim.x * WARPS) {
        const long long p0 = tile * 16 + g, p1 = p0 + 8;
        uint32_t h0[8], h1[8];
        first_layer(A, B, C, p0, total, R, c, h0);
        first_layer(A, B, C, p1, total, R, c, h1);
        uint32_t a[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            a[kc][0] = h0[2 * kc];
            a[kc][1] = h1[2 * kc];
            a[kc][2] = h0[2 * kc + 1];
            a[kc][3] = h1[2 * kc + 1];
        }

        for (int l = 0; l < L; ++l) {
            const __nv_bfloat16 *Wl = Ws + (size_t)l * HW * WPAD;
            const float *bl = bs + l * HW;
            float acc[8][4];
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
                const __nv_bfloat16 *wrow = Wl + (n * 8 + g) * WPAD;
#pragma unroll
                for (int kc = 0; kc < 4; ++kc) {
                    const uint32_t b0 = *reinterpret_cast<const uint32_t *>(wrow + kc * 16 + c);
                    const uint32_t b1 = *reinterpret_cast<const uint32_t *>(wrow + kc * 16 + c + 8);
                    mma_bf16_16816(acc[n], a[kc], b0, b1);
                }
            }
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
                const int n0 = 2 * kc, n1 = 2 * kc + 1;
                const float c00 = bl[n0 * 8 + c], c01 = bl[n0 * 8 + c + 1];
                const float c10 = bl[n1 * 8 + c], c11 = bl[n1 * 8 + c + 1];
                a[kc][0] = pack_bf16(silu(acc[n0][0] + c00), silu(acc[n0][1] + c01));
                a[kc][1] = pack_bf16(silu(acc[n0][2] + c00), silu(acc[n0][3] + c01));
                a[kc][2] = pack_bf16(silu(acc[n1][0] + c10), silu(acc[n1][1] + c11));
                a[kc][3] = pack_bf16(silu(acc[n1][2] + c10), silu(acc[n1][3] + c11));
            }
        }

        // output channel 0: dot(h, wout) over this lane's 16 channels per row
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int ch = kc * 16 + half * 8 + c;
                const float2 x0 = unpack_bf16(a[kc][half * 2]);
                const float2 x1 = unpack_bf16(a[kc][half * 2 + 1]);
                d0 = fmaf(x0.x, wo[ch], fmaf(x0.y, wo[ch + 1], d0));
                d1 = fmaf(x1.x, wo[ch], fmaf(x1.y, wo[ch + 1], d1));
            }
        }
        d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
        d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
        d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
        d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
        const float bout = wo[HW];
        if ((lane & 3) == 0) {
            // the decoder's output is bf16 before the f32 density activation,
            // as in the plain version
            if (p0 < total) out[p0] = expf(bf16_round(d0 + bout) + density_bias);
            if (p1 < total) out[p1] = expf(bf16_round(d1 + bout) + density_bias);
        }
    }
}

}  // namespace

extern "C" int density_mlp_fwd(const void *A, const void *B, const void *C,
                               const void *W, const void *bias,
                               const void *wout, float density_bias,
                               void *out, int R, int L,
                               int grid, void *stream) {
    const size_t smem = (size_t)L * HW * WPAD * sizeof(__nv_bfloat16) +
                        (size_t)(L * HW + HW + 1) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        density_mlp_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    density_mlp_bf16<<<grid, WARPS * 32, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16 *>(A), static_cast<const __nv_bfloat16 *>(B),
        static_cast<const __nv_bfloat16 *>(C), static_cast<const __nv_bfloat16 *>(W),
        static_cast<const float *>(bias), static_cast<const float *>(wout), density_bias, static_cast<float *>(out), R, L);
    return (int)cudaGetLastError();
}
