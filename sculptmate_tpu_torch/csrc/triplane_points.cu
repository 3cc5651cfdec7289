// K4: scattered triplane sample + TripoSR's NeRF decoder at arbitrary points.
//
// Replaces: sculptmate_tpu/ops/density_grid.py:query_triplane_points (l.366),
// with ops/grid_sample.py:sample_triplane (l.138), the XLA program that
// colors every mesh vertex and samples every ray of the novel-view renderer:
// a bilinear sample of the three (40, H, W) planes at each point (zero
// padding, align_corners=False), the 120 features in bf16, then the decoder
// 120 -> 64 (SiLU) -> 8 x [64 -> 64 (SiLU)] -> 4, and from its output the
// density, exp(density + bias) and the sigmoid of the three color channels,
// f32, channels first.
//
// Bound on the H100: operations. Each point costs 81 408 tensor-core flops
// against 12 bytes in and 20 bytes out (and 2 MB of planes read once), so
// 8.39 M render samples need 0.69 ms at 989 TFLOP/s and 0.08 ms of bytes.
// The bilinear taps are scattered gathers of 160-byte rows from planes that
// fit in L2.
//
// Design (K6's scheme with one head):
// - the wrapper lays the planes out channels-last (3, H, W, 40) in f32, so
//   one tap's 40 channels are ten 16-byte loads; f32 holds bf16 codes
//   exactly, so the taps are summed from the planes' own values whatever
//   their dtype, as the plain version sums them;
// - a block of 512 threads takes 256 points at a time: the threads gather
//   the taps, sum them in f32 in the plain version's order (each product and
//   sum rounded on its own) and write the 120 bf16 features of each point to
//   a shared tile; the decoder's weights (92 KB) sit in shared memory for
//   the block's life;
// - each warp runs its 16 points through the ten layers with mma.sync
//   m16n8k16 (bf16 in, f32 sums): a layer's accumulators, biased, rounded to
//   bf16, passed through SiLU and rounded again, are the next layer's A
//   fragments, so activations never leave registers; the output layer is
//   rounded to bf16 before the f32 activations, as the plain version rounds
//   it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int C = 40;          // channels per plane
constexpr int FEAT = 3 * C;    // 120 features per point
constexpr int KIN = 128;       // features padded to the product depth
constexpr int HW = 64;         // hidden width
constexpr int LAYERS = 8;      // hidden 64 x 64 layers (TripoSR's n_hidden_layers 9)
constexpr int NOUT = 4;        // density, then three color channels
constexpr int THREADS = 512;   // 16 warps
constexpr int PTS = 256;       // points per tile, 16 per warp
constexpr int ROW = KIN + 8;   // bf16 row stride of the feature tile and W1 (conflict-free)
constexpr int HROW = HW + 8;   // bf16 row stride of a hidden and the output layer
constexpr int W1_ELEMS = HW * ROW;
constexpr int WH_ELEMS = HW * HROW;
constexpr int WO_ELEMS = 8 * HROW;
constexpr int W_ELEMS = W1_ELEMS + LAYERS * WH_ELEMS + WO_ELEMS;
constexpr int NBIAS = HW + LAYERS * HW + 8;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t *>(&v);
}

// SiLU of a bf16 pre-activation, in f32, rounded to bf16 by the caller
__device__ __forceinline__ float silu(float x) { return __fdiv_rn(x, add(1.f, __expf(-x))); }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16 *p) { return *reinterpret_cast<const uint32_t *>(p); }

// bias, bf16 rounding, SiLU and bf16 rounding of the 64 columns
// (accumulator n-tiles 0..7) as the A fragments of k-chunks 0..3
__device__ __forceinline__ void epilogue(uint32_t (&a)[4][4], const float (&acc)[8][4], const float *bias, int tq) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int j = 2 * kc + half, col = 8 * j + 2 * tq;
            const float b0 = bias[col], b1 = bias[col + 1];
            const float x0 = bf16r(add(acc[j][0], b0)), x1 = bf16r(add(acc[j][1], b1));
            const float x2 = bf16r(add(acc[j][2], b0)), x3 = bf16r(add(acc[j][3], b1));
            a[kc][2 * half] = pack2(silu(x0), silu(x1));
            a[kc][2 * half + 1] = pack2(silu(x2), silu(x3));
        }
    }
}

// first layer: 64 output columns over the 128-deep feature rows of this warp
__device__ __forceinline__ void first_layer(uint32_t (&a)[4][4], const __nv_bfloat16 *tile, const __nv_bfloat16 *w1,
                                            const float *b1, int warp, int g, int tq) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const __nv_bfloat16 *r0 = tile + (warp * 16 + g) * ROW, *r1 = r0 + 8 * ROW;
#pragma unroll
    for (int kc = 0; kc < KIN / 16; ++kc) {
        const int k = 16 * kc + 2 * tq;
        const uint32_t fa[4] = {lds32(r0 + k), lds32(r1 + k), lds32(r0 + k + 8), lds32(r1 + k + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const __nv_bfloat16 *wr = w1 + (8 * j + g) * ROW + k;
            mma16816(acc[j], fa, lds32(wr), lds32(wr + 8));
        }
    }
    epilogue(a, acc, b1, tq);
}

// one hidden 64 x 64 layer: its activations a -> a
__device__ __forceinline__ void hidden_layer(uint32_t (&a)[4][4], const __nv_bfloat16 *wl, const float *bl, int g,
                                             int tq) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        const int k = 16 * kc + 2 * tq;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const __nv_bfloat16 *wr = wl + (8 * j + g) * HROW + k;
            mma16816(acc[j], a[kc], lds32(wr), lds32(wr + 8));
        }
    }
    epilogue(a, acc, bl, tq);
}

// the taps of one (point, plane): 40 features, in f32 in the plain
// version's order (t00 + t10) + t01 + t11, each product rounded on its own
__device__ __forceinline__ void sample_plane(__nv_bfloat16 *dst, const float *__restrict__ plane, float cx, float cy,
                                             int H, int W, bool align_corners) {
    const float fx = align_corners ? mul(mul(add(cx, 1.f), 0.5f), (float)(W - 1))
                                   : mul(sub(mul(add(cx, 1.f), (float)W), 1.f), 0.5f);
    const float fy = align_corners ? mul(mul(add(cy, 1.f), 0.5f), (float)(H - 1))
                                   : mul(sub(mul(add(cy, 1.f), (float)H), 1.f), 0.5f);
    const float x0f = floorf(fx), y0f = floorf(fy);
    const float wx1 = sub(fx, x0f), wy1 = sub(fy, y0f);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float w[4] = {mul(sub(1.f, wx1), sub(1.f, wy1)), mul(wx1, sub(1.f, wy1)), mul(sub(1.f, wx1), wy1),
                        mul(wx1, wy1)};
    const int xs[4] = {x0, x0 + 1, x0, x0 + 1}, ys[4] = {y0, y0, y0 + 1, y0 + 1};
    float f[C];
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = 0.f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const bool valid = xs[t] >= 0 && xs[t] < W && ys[t] >= 0 && ys[t] < H;
        if (!valid) continue;  // the plain version adds v * 0
        const float4 *src = reinterpret_cast<const float4 *>(plane + ((size_t)ys[t] * W + xs[t]) * C);
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
            const float4 v = __ldg(src + q);
            f[4 * q] = add(f[4 * q], mul(v.x, w[t]));
            f[4 * q + 1] = add(f[4 * q + 1], mul(v.y, w[t]));
            f[4 * q + 2] = add(f[4 * q + 2], mul(v.z, w[t]));
            f[4 * q + 3] = add(f[4 * q + 3], mul(v.w, w[t]));
        }
    }
#pragma unroll
    for (int c = 0; c < C; c += 2)
        *reinterpret_cast<__nv_bfloat162 *>(dst + c) = __floats2bfloat162_rn(f[c], f[c + 1]);
}

__global__ void __launch_bounds__(THREADS, 1)
triplane_points_bf16(const float *__restrict__ planes,  // (3, H, W, 40) channels last
                     const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,
                     const uint4 *__restrict__ wts,   // W_ELEMS bf16: W1, hidden layers, Wout (padded rows)
                     const float *__restrict__ bias,  // NBIAS
                     float *__restrict__ out,         // (5, N): density, density_act, r, g, b
                     int N, int H, int W, float radius, float density_bias, int align_corners) {
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16 *tile = reinterpret_cast<__nv_bfloat16 *>(smem);  // PTS x ROW
    __nv_bfloat16 *w1 = tile + PTS * ROW;
    __nv_bfloat16 *wh = w1 + W1_ELEMS;
    __nv_bfloat16 *wo = wh + LAYERS * WH_ELEMS;
    float *bs = reinterpret_cast<float *>(wo + WO_ELEMS);

    for (int i = threadIdx.x; i < W_ELEMS / 8; i += THREADS) reinterpret_cast<uint4 *>(w1)[i] = wts[i];
    for (int i = threadIdx.x; i < NBIAS; i += THREADS) bs[i] = bias[i];
    // the padding columns 120 .. 127 of the feature rows stay zero
    for (int i = threadIdx.x; i < PTS * (KIN - FEAT); i += THREADS)
        tile[(i / (KIN - FEAT)) * ROW + FEAT + i % (KIN - FEAT)] = __float2bfloat16_rn(0.f);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, tq = lane & 3;
    const size_t plane_elems = (size_t)H * W * C;
    const int ntiles = (N + PTS - 1) / PTS;
    for (int tile_i = blockIdx.x; tile_i < ntiles; tile_i += gridDim.x) {
        const int p0 = tile_i * PTS;
        __syncthreads();  // the previous tile's rows are read (and the weights written)
        for (int item = threadIdx.x; item < 3 * PTS; item += THREADS) {
            const int p = item / 3, q = item % 3, n = p0 + p;
            __nv_bfloat16 *dst = tile + p * ROW + q * C;
            if (n >= N) {
                for (int c = 0; c < C; ++c) dst[c] = __float2bfloat16_rn(0.f);
                continue;
            }
            // planes (xy, xz, yz) at (px, py), (px, pz), (py, pz), each
            // coordinate divided by the radius as the plain version divides
            const float cx = __fdiv_rn(q == 2 ? py[n] : px[n], radius);
            const float cy = __fdiv_rn(q == 0 ? py[n] : pz[n], radius);
            sample_plane(dst, planes + q * plane_elems, cx, cy, H, W, align_corners != 0);
        }
        __syncthreads();

        uint32_t a[4][4];
        first_layer(a, tile, w1, bs, warp, g, tq);
#pragma unroll 1
        for (int l = 0; l < LAYERS; ++l) hidden_layer(a, wh + l * WH_ELEMS, bs + HW + l * HW, g, tq);
        float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
            const __nv_bfloat16 *wr = wo + g * HROW + 16 * kc + 2 * tq;
            mma16816(o, a[kc], lds32(wr), lds32(wr + 8));
        }
        const float *bout = bs + HW + LAYERS * HW;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            const int n = p0 + warp * 16 + g + 8 * rr;
            if (n >= N) continue;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int ch = 2 * tq + e;
                if (ch >= NOUT) continue;
                const float v = bf16r(add(o[2 * rr + e], bout[ch]));
                if (ch == 0) {
                    out[n] = v;
                    out[(size_t)N + n] = expf(add(v, density_bias));
                } else {
                    out[(size_t)(1 + ch) * N + n] = __fdiv_rn(1.f, add(1.f, expf(-v)));
                }
            }
        }
    }
}

}  // namespace

static size_t triplane_smem_bytes() { return (size_t)(PTS * ROW + W_ELEMS) * 2 + NBIAS * 4; }

extern "C" int triplane_points_fwd(const void *planes, const void *px, const void *py, const void *pz,
                                   const void *wts, const void *bias, void *out, int N, int H, int W, float radius,
                                   float density_bias, int align_corners, int num_sms, void *stream) {
    if (N < 0 || H < 2 || W < 2 || !(radius > 0.f)) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    const size_t smem = triplane_smem_bytes();
    static bool smem_set = false;  // once per process
    if (!smem_set) {
        cudaError_t e =
            cudaFuncSetAttribute(triplane_points_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    const int ntiles = (N + PTS - 1) / PTS;
    const int grid = std::min(ntiles, num_sms);
    triplane_points_bf16<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const float *>(planes), static_cast<const float *>(px), static_cast<const float *>(py),
        static_cast<const float *>(pz), static_cast<const uint4 *>(wts), static_cast<const float *>(bias),
        static_cast<float *>(out), N, H, W, radius, density_bias, align_corners);
    return (int)cudaGetLastError();
}
