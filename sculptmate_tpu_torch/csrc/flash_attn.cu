// K1: flash-attention forward, softmax(Q K^T / sqrt(D)) V with O(N) memory.
//
// Replaces: sculptmate_tpu/ops/attention.py:_flash_attention, the Pallas TPU
// flash-attention kernel (jax.experimental.pallas.ops.tpu.flash_attention)
// that every backbone attn1 (3072 x 3072) and attn2 (3072 x 1025) takes.
//
// Bound on the H100: operations. At the backbone's shapes one call does
// 4 * Nq * Nk * D * H flops on 2 * (Nq + 2 Nk) * H * D bytes of bf16 input,
// ~1000 flops per byte, far right of the ~295 flop/byte ridge.
//
// Design: one block of 4 warps per (batch x head, 64-query tile); each warp
// owns 16 query rows whose Q fragments stay in registers. The block walks
// the keys in 64-key tiles staged in shared memory (K row-major, V
// transposed so both products read 32-bit fragment pairs), runs Q K^T and
// P V on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulate), and keeps
// the online softmax (running max and sum) and the output in f32 registers.
// The scores never reach device memory. The ragged key and query tails
// (Nk = 1025, any Nq) are masked inside the kernel: no padding to 512, no
// segment ids. wgmma, TMA and a double-buffered K/V ring are later work.
//
// float32 inputs take a plain FMA kernel (one thread per query row) with the
// same tiling of keys; it exists so the card can check the kernel's masking
// and softmax in full precision, and is not on the main path.

#include <math.h>

#include "mma.cuh"

namespace {

using namespace sm_port;

constexpr int D = 64;      // head dim (the wrapper rejects any other)
constexpr int BQ = 64;     // query rows per block: 4 warps x 16
constexpr int BK = 64;     // keys per shared-memory tile
constexpr int PAD = 72;    // smem row stride in bf16: 36 words, conflict-free
                           // for the fragment pattern (4 g + lane % 4)

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16 *row_base,
                                            bool ok, int col) {
    return ok ? *reinterpret_cast<const uint32_t *>(row_base + col) : 0u;
}

__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16 *__restrict__ q,
               const __nv_bfloat16 *__restrict__ k,
               const __nv_bfloat16 *__restrict__ v,
               __nv_bfloat16 *__restrict__ o, int Nq, int Nk, int H,
               float scale_log2) {
    __shared__ __align__(16) __nv_bfloat16 Ks[BK * PAD];
    __shared__ __align__(16) __nv_bfloat16 Vt[D * PAD];  // Vt[d][key]

    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, c = (lane & 3) * 2;
    const size_t rs = (size_t)H * D;  // row stride of (B, N, H, D)
    const __nv_bfloat16 *qb = q + ((size_t)b * Nq * H + h) * D;
    const __nv_bfloat16 *kb = k + ((size_t)b * Nk * H + h) * D;
    const __nv_bfloat16 *vb = v + ((size_t)b * Nk * H + h) * D;
    __nv_bfloat16 *ob = o + ((size_t)b * Nq * H + h) * D;

    const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
    const bool ok0 = r0 < Nq, ok1 = r1 < Nq;
    uint32_t qa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        qa[kc][0] = ld_pair(qb + (size_t)r0 * rs, ok0, kc * 16 + c);
        qa[kc][1] = ld_pair(qb + (size_t)r1 * rs, ok1, kc * 16 + c);
        qa[kc][2] = ld_pair(qb + (size_t)r0 * rs, ok0, kc * 16 + c + 8);
        qa[kc][3] = ld_pair(qb + (size_t)r1 * rs, ok1, kc * 16 + c + 8);
    }

    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
        acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    for (int kt = 0; kt < Nk; kt += BK) {
        __syncthreads();  // previous tile fully consumed
        // stage K (row-major) and V (transposed): 64 keys x 8 16-byte chunks
#pragma unroll
        for (int it = 0; it < (BK * D / 8) / 128; ++it) {
            const int vi = threadIdx.x + it * 128;
            const int key = vi >> 3, d0 = (vi & 7) * 8;
            uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
            if (kt + key < Nk) {
                kv = *reinterpret_cast<const uint4 *>(kb + (size_t)(kt + key) * rs + d0);
                vv = *reinterpret_cast<const uint4 *>(vb + (size_t)(kt + key) * rs + d0);
            }
            *reinterpret_cast<uint4 *>(Ks + key * PAD + d0) = kv;
            const __nv_bfloat16 *ve = reinterpret_cast<const __nv_bfloat16 *>(&vv);
#pragma unroll
            for (int e = 0; e < 8; ++e) Vt[(d0 + e) * PAD + key] = ve[e];
        }
        __syncthreads();

        // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles)
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
            const __nv_bfloat16 *krow = Ks + (n * 8 + g) * PAD;
#pragma unroll
            for (int kc = 0; kc < 4; ++kc) {
                const uint32_t b0 = *reinterpret_cast<const uint32_t *>(krow + kc * 16 + c);
                const uint32_t b1 = *reinterpret_cast<const uint32_t *>(krow + kc * 16 + c + 8);
                mma_bf16_16816(s[n], qa[kc], b0, b1);
            }
        }

        // scale into the log2 domain, mask the ragged key tail, row maxima
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int col = kt + n * 8 + c;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool valid = col + e < Nk;
                s[n][e] = valid ? s[n][e] * scale_log2 : -INFINITY;
                s[n][2 + e] = valid ? s[n][2 + e] * scale_log2 : -INFINITY;
                mx0 = fmaxf(mx0, s[n][e]);
                mx1 = fmaxf(mx1, s[n][2 + e]);
            }
        }
        // the 4 lanes of a quad share rows g and g + 8
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        // every tile holds >= 1 valid key, so the new maxima are finite
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            s[n][0] = exp2f(s[n][0] - mn0);
            s[n][1] = exp2f(s[n][1] - mn0);
            s[n][2] = exp2f(s[n][2] - mn1);
            s[n][3] = exp2f(s[n][3] - mn1);
            ps0 += s[n][0] + s[n][1];
            ps1 += s[n][2] + s[n][3];
        }
        // per-lane partial row sums; the quad reduction happens once at the end
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            acc[n][0] *= al0;
            acc[n][1] *= al0;
            acc[n][2] *= al1;
            acc[n][3] *= al1;
        }

        // O += P V: the S tiles (2kc, 2kc+1) are the A fragment of chunk kc
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
            pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
            pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
            pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
                const __nv_bfloat16 *vrow = Vt + (n * 8 + g) * PAD + kc * 16;
                const uint32_t b0 = *reinterpret_cast<const uint32_t *>(vrow + c);
                const uint32_t b1 = *reinterpret_cast<const uint32_t *>(vrow + c + 8);
                mma_bf16_16816(acc[n], pa, b0, b1);
            }
        }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        if (ok0)
            *reinterpret_cast<uint32_t *>(ob + (size_t)r0 * rs + n * 8 + c) =
                pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
        if (ok1)
            *reinterpret_cast<uint32_t *>(ob + (size_t)r1 * rs + n * 8 + c) =
                pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
}

constexpr int FQ = 128;  // f32 kernel: query rows (threads) per block

__global__ void __launch_bounds__(FQ)
flash_fwd_f32(const float *__restrict__ q, const float *__restrict__ k,
              const float *__restrict__ v, float *__restrict__ o, int Nq,
              int Nk, int H, float scale_log2) {
    __shared__ __align__(16) float Ks[BK * D];
    __shared__ __align__(16) float Vs[BK * D];

    const int bh = blockIdx.y;
    const int b = bh / H, h = bh % H;
    const size_t rs = (size_t)H * D;
    const float *kb = k + ((size_t)b * Nk * H + h) * D;
    const float *vb = v + ((size_t)b * Nk * H + h) * D;
    const int row = blockIdx.x * FQ + threadIdx.x;
    const bool ok = row < Nq;

    float qr[D], acc[D];
    const float *qrow = q + ((size_t)b * Nq * H + h) * D + (size_t)row * rs;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        qr[d] = ok ? qrow[d] * scale_log2 : 0.f;
        acc[d] = 0.f;
    }
    float m = -INFINITY, l = 0.f;

    for (int kt = 0; kt < Nk; kt += BK) {
        __syncthreads();
        for (int vi = threadIdx.x; vi < BK * D / 4; vi += FQ) {
            const int key = vi / (D / 4), d0 = (vi % (D / 4)) * 4;
            float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
            if (kt + key < Nk) {
                kv = *reinterpret_cast<const float4 *>(kb + (size_t)(kt + key) * rs + d0);
                vv = *reinterpret_cast<const float4 *>(vb + (size_t)(kt + key) * rs + d0);
            }
            *reinterpret_cast<float4 *>(Ks + key * D + d0) = kv;
            *reinterpret_cast<float4 *>(Vs + key * D + d0) = vv;
        }
        __syncthreads();
        const int nvalid = min(BK, Nk - kt);
        for (int j = 0; j < nvalid; ++j) {
            float sc = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) sc = fmaf(qr[d], Ks[j * D + d], sc);
            if (sc > m) {  // new running max: rescale what was accumulated
                const float al = exp2f(m - sc);
                l *= al;
#pragma unroll
                for (int d = 0; d < D; ++d) acc[d] *= al;
                m = sc;
            }
            const float p = exp2f(sc - m);
            l += p;
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[j * D + d], acc[d]);
        }
    }
    if (ok) {
        float *orow = o + ((size_t)b * Nq * H + h) * D + (size_t)row * rs;
        const float inv = 1.f / l;
#pragma unroll
        for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
    }
}

}  // namespace

extern "C" int flash_attn_fwd(const void *q, const void *k, const void *v,
                              void *o, int B, int Nq, int Nk, int H,
                              int is_bf16, float scale, void *stream) {
    const float scale_log2 = scale * 1.4426950408889634f;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (is_bf16) {
        dim3 grid((Nq + BQ - 1) / BQ, B * H);
        flash_fwd_bf16<<<grid, 128, 0, st>>>(
            static_cast<const __nv_bfloat16 *>(q),
            static_cast<const __nv_bfloat16 *>(k),
            static_cast<const __nv_bfloat16 *>(v),
            static_cast<__nv_bfloat16 *>(o), Nq, Nk, H, scale_log2);
    } else {
        dim3 grid((Nq + FQ - 1) / FQ, B * H);
        flash_fwd_f32<<<grid, FQ, 0, st>>>(
            static_cast<const float *>(q), static_cast<const float *>(k),
            static_cast<const float *>(v), static_cast<float *>(o), Nq, Nk,
            H, scale_log2);
    }
    return (int)cudaGetLastError();
}
