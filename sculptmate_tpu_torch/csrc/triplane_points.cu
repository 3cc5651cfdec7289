// K4: scattered triplane sample + TripoSR's NeRF decoder at arbitrary points.
//
// Replaces: sculptmate_tpu/ops/density_grid.py:query_triplane_points (l.366),
// with ops/grid_sample.py:sample_triplane (l.138), the XLA program that
// colors every mesh vertex and samples every ray of the novel-view renderer:
// a bilinear sample of the three (40, H, W) planes at each point (zero
// padding, align_corners as given), the 120 features in bf16, then the
// decoder 120 -> 64 (SiLU) -> 8 x [64 -> 64 (SiLU)] -> 4, and from its output
// the density, exp(density + bias) and the sigmoid of the three color
// channels, f32, channels first.
//
// Floors on the H100, per point:
// - tensor cores: 81 408 flops (120 padded to 128 deep in the first layer),
//   so 8.39 M render samples need 0.69 ms at 989 TFLOP/s; the bytes (12 in,
//   20 out, the planes read once) need 0.08 ms;
// - the special-function unit: 576 SiLUs (nine 64-wide layers). The SFU
//   gives 16 results per clock per SM; at one tanh.approx.bf16x2 per two
//   SiLUs that is 288 SFU results per point, ~0.6 ms per 8.39 M points on
//   132 SMs at ~1.8 GHz, against ~2.5 ms for an exp and a divide per SiLU.
// Besides these, the gather reads 4 taps x 3 planes per point from the
// planes (2 MB in bf16, resident in L2): 960 bytes per point in bf16, and
// 960 f32 products and sums (each rounded on its own).
//
// Design:
// - a block is two producer warpgroups and two consumer warpgroups,
//   persistent (one block per SM), walking pairs of 64-point tiles. Pair n
//   is gathered by producer n % 2 into ring slot n % 4 and run by consumer
//   n % 2, so each slot has one producer and one consumer, in order (an
//   mbarrier's phases are told apart only by their parity). The producers
//   give registers to the consumers (setmaxnreg: 96 against 160);
// - the producers gather: thread t takes point t of a pair (128 points) and
//   its three planes, so every thread does the same work, loading the 4
//   taps of two 8-feature chunks at a time. Taps are summed in f32 in the
//   plain version's order ((t00 + t10) + t01) + t11, each product and sum
//   rounded on its own (a tap outside the plane is its clamped neighbour
//   times 0, as the plain version computes it), and the 120 bf16 features (8
//   zero columns pad them to 128) go into the slot in the 128-byte swizzle
//   that wgmma reads: two 64-wide K halves of 64 rows per tile. The planes
//   are channels-last, bf16 when the codes are bf16 (an 80-byte tap) and f32
//   otherwise (160 bytes), so the features are the codes' own values either
//   way;
// - a full slot is handed over by an mbarrier (the producer warpgroup's 128
//   arrivals), and handed back by another once the consumer's first layer
//   has read it: the gather of later pairs runs while earlier pairs are in
//   their products, with no block-wide barrier;
// - each consumer warpgroup runs its pair's two tiles through the layers
//   with wgmma m64n64k16, two tiles in flight as in K2: while the tensor cores
//   run one tile's layer, the warpgroup computes the other's SiLU. The first
//   layer reads the feature tile from shared memory (8 k-steps); the hidden
//   layers and the output layer (m64n8k16) take the activations from
//   registers: a layer's f32 accumulators, plus bias and SiLU, pack in place
//   into the next layer's A fragments (hopper.cuh's hidden_epilogue);
// - the decoder's weights sit in shared memory for the block's life,
//   swizzled on the host; the first and hidden layers' weights and biases
//   are halved there (exact in bf16), so each product gives h = x / 2 and
//   SiLU is h (1 + tanh h): one tanh.approx.bf16x2 and one fma.rn.bf16x2 for
//   two activations;
// - the output layer's sums are rounded to bf16 before the f32 exp and
//   sigmoid, as the plain version rounds them;
// - the layer count is a compile-time constant: the layer loop unrolls and
//   no branch wraps a wgmma (ptxas would serialize them).

#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace sm_port;

constexpr int C = 40;                     // channels per plane
constexpr int HW = 64;                    // hidden width
constexpr int LAYERS = 8;                 // hidden 64 x 64 layers (TripoSR's n_hidden_layers 9)
constexpr int NOUT = 4;                   // density, then three color channels
constexpr int TP = 64;                    // points per tile: the M rows of one wgmma
constexpr int PAIR = 2 * TP;              // points per slot: a consumer's two tiles in flight
constexpr int CONSUMERS = 2;              // consumer warpgroups per block
constexpr int PRODUCERS = 2;              // producer warpgroups per block
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
// registers per thread: the producers give theirs up to the consumers
constexpr int PRODUCER_REGS = 96;
constexpr int CONSUMER_REGS = ((65536 - 128 * PRODUCERS * PRODUCER_REGS) / (128 * CONSUMERS)) & ~7;
constexpr int NSTAGE = 4;                 // pair slots in the ring
constexpr int GATHER_CHUNKS = 2;          // 8-feature chunks of bf16 taps a producer loads at once
// Pair n is gathered by producer warpgroup n % PRODUCERS into slot n % NSTAGE
// and run by consumer warpgroup n % CONSUMERS. A slot's mbarrier phases are
// told apart only by their parity, so each slot must be filled by one
// producer and emptied by one consumer, in order:
static_assert(NSTAGE % PRODUCERS == 0 && NSTAGE % CONSUMERS == 0, "a slot needs one producer and one consumer");
constexpr int ROW_BYTES = 128;            // 64 bf16: one swizzled row
constexpr int HALF_BYTES = TP * ROW_BYTES;          // one 64-deep half of a feature tile
constexpr int TILE_BYTES = 2 * HALF_BYTES;          // 64 points x 128 features
constexpr int SLOT_BYTES = 2 * TILE_BYTES;          // a pair of tiles
constexpr int W_LAYER_BYTES = HW * ROW_BYTES;       // 64 swizzled rows
constexpr int HID_OFF = 2 * W_LAYER_BYTES;          // after the first layer's two halves
constexpr int OUT_OFF = HID_OFF + LAYERS * W_LAYER_BYTES;
constexpr int W_BYTES = OUT_OFF + 8 * ROW_BYTES;    // + the 8-row output tile
constexpr int NBIAS = HW + LAYERS * HW + 8;         // halved b1, halved hidden biases, output bias
constexpr int OUT_BIAS = (LAYERS + 1) * HW;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// 8 channels of one tap as 16-byte chunks: one of 8 bf16, or two of 4 f32;
// each(v, u, f) calls f(channel within the 8, value) for chunk u
template <typename T>
struct Taps;
template <>
struct Taps<__nv_bfloat16> {
    static constexpr int PER_8 = 1;
    template <typename F>
    __device__ __forceinline__ static void each(const uint4 &v, int, F &&f) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            f(2 * e, __uint_as_float(w[e] << 16));
            f(2 * e + 1, __uint_as_float(w[e] & 0xFFFF0000u));
        }
    }
};
template <>
struct Taps<float> {
    static constexpr int PER_8 = 2;
    template <typename F>
    __device__ __forceinline__ static void each(const uint4 &v, int u, F &&f) {
        f(4 * u, __uint_as_float(v.x));
        f(4 * u + 1, __uint_as_float(v.y));
        f(4 * u + 2, __uint_as_float(v.z));
        f(4 * u + 3, __uint_as_float(v.w));
    }
};

// the 40 features of plane q at (cx, cy) into row r of a feature tile:
// features 40q .. 40q + 39 are the 16-byte chunks 5q .. 5q + 4 of the row's
// 16, chunk g in K half g / 8 at swizzled place (g % 8) ^ (r % 8)
template <typename T>
__device__ __forceinline__ void gather_plane(unsigned char *tile, int r, int q, const T *__restrict__ plane,
                                             float cx, float cy, int H, int W, bool align_corners) {
    const float fx = align_corners ? mul(mul(add(cx, 1.f), 0.5f), (float)(W - 1))
                                   : mul(sub(mul(add(cx, 1.f), (float)W), 1.f), 0.5f);
    const float fy = align_corners ? mul(mul(add(cy, 1.f), 0.5f), (float)(H - 1))
                                   : mul(sub(mul(add(cy, 1.f), (float)H), 1.f), 0.5f);
    const float x0f = floorf(fx), y0f = floorf(fy);
    const float wx1 = sub(fx, x0f), wy1 = sub(fy, y0f);
    const int x0 = (int)x0f, y0 = (int)y0f;
    const float w[4] = {mul(sub(1.f, wx1), sub(1.f, wy1)), mul(wx1, sub(1.f, wy1)), mul(sub(1.f, wx1), wy1),
                        mul(wx1, wy1)};
    const uint4 *src[4];
    float wv[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        const int x = x0 + (t & 1), y = y0 + (t >> 1);
        const bool valid = x >= 0 && x < W && y >= 0 && y < H;
        wv[t] = valid ? w[t] : 0.f;  // the plain version adds v * (w * valid)
        const int xc = min(max(x, 0), W - 1), yc = min(max(y, 0), H - 1);
        src[t] = reinterpret_cast<const uint4 *>(plane + ((size_t)yc * W + xc) * C);
    }
    // G chunks of 8 features at a time: their 4 taps' loads are in flight
    // together, and few registers are held (f32 taps: one chunk, 8 loads)
    constexpr int G = sizeof(T) == 2 ? GATHER_CHUNKS : 1;
#pragma unroll
    for (int m0 = 0; m0 < 5; m0 += G) {
        float f[G][8];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int mm = 0; mm < G; ++mm) {
                if (m0 + mm >= 5) continue;  // resolved at compile time
#pragma unroll
                for (int u = 0; u < Taps<T>::PER_8; ++u) {
                    const uint4 v = __ldg(src[t] + Taps<T>::PER_8 * (m0 + mm) + u);
                    Taps<T>::each(v, u, [&](int ch, float x) {
                        f[mm][ch] = t == 0 ? mul(x, wv[t]) : add(f[mm][ch], mul(x, wv[t]));
                    });
                }
            }
        }
#pragma unroll
        for (int mm = 0; mm < G; ++mm) {
            if (m0 + mm >= 5) continue;
            const int gc = 5 * q + m0 + mm;
            uint4 v;
            v.x = pack_bf16(f[mm][0], f[mm][1]);
            v.y = pack_bf16(f[mm][2], f[mm][3]);
            v.z = pack_bf16(f[mm][4], f[mm][5]);
            v.w = pack_bf16(f[mm][6], f[mm][7]);
            *reinterpret_cast<uint4 *>(tile + (gc >> 3) * HALF_BYTES + r * ROW_BYTES + (((gc & 7) ^ (r & 7)) << 4)) =
                v;
        }
    }
}

// the producers: thread t of producer warpgroup pw gathers point t of the
// block's pairs n = pw, pw + PRODUCERS, ...
template <typename T>
__device__ __forceinline__ void produce(unsigned char *ring, uint32_t full, uint32_t empty,
                                        const T *__restrict__ planes, const float *__restrict__ px,
                                        const float *__restrict__ py, const float *__restrict__ pz, int N, int H,
                                        int W, float radius, bool align_corners, long long npairs, int pw,
                                        int t) {
    const size_t plane_elems = (size_t)H * W * C;
    for (long long n = pw, q = blockIdx.x + (long long)pw * gridDim.x; q < npairs;
         n += PRODUCERS, q += (long long)PRODUCERS * gridDim.x) {
        const int s = (int)(n % NSTAGE);
        if (n >= NSTAGE) mbar_wait(empty + 8 * s, (uint32_t)((n / NSTAGE - 1) & 1));
        unsigned char *tile = ring + s * SLOT_BYTES + (t / TP) * TILE_BYTES;
        const int r = t % TP;
        const long long p = q * PAIR + t;
        if (p < N) {
            // planes (xy, xz, yz) at (px, py), (px, pz), (py, pz), each
            // coordinate divided by the radius as the plain version divides
            const float x = __fdiv_rn(px[p], radius), y = __fdiv_rn(py[p], radius), z = __fdiv_rn(pz[p], radius);
            gather_plane(tile, r, 0, planes, x, y, H, W, align_corners);
            gather_plane(tile, r, 1, planes + plane_elems, x, z, H, W, align_corners);
            gather_plane(tile, r, 2, planes + 2 * plane_elems, y, z, H, W, align_corners);
        } else {  // past N: zero features, computed on and never stored
#pragma unroll
            for (int gc = 0; gc < 15; ++gc)
                *reinterpret_cast<uint4 *>(tile + (gc >> 3) * HALF_BYTES + r * ROW_BYTES +
                                           (((gc & 7) ^ (r & 7)) << 4)) = make_uint4(0, 0, 0, 0);
        }
        fence_proxy_async();  // the generic stores, made visible to wgmma
        mbar_arrive(full + 8 * s);
    }
}

// the first layer of one tile: 64 points x 128 features (two swizzled
// halves) times W1's two halves, 8 k-steps issued and committed as one group
__device__ __forceinline__ void issue_first(float (&d)[32], uint32_t tile, uint32_t w1) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
        const uint32_t h = (ks >> 2) * HALF_BYTES, kc = ks & 3;
        wgmma_ss<0>(d, desc_sw128(tile + h) + 2 * kc, desc_sw128(w1 + h) + 2 * kc, ks);
    }
    wgmma_commit();
}

// channels 0..3 sit in columns 0..3: lanes with c = 0 hold (d, r) and c = 2
// (g, b) of rows g (o[0..1]) and g + 8 (o[2..3])
__device__ __forceinline__ void store_tile(float *__restrict__ out, long long n0, const float (&o)[4],
                                           const float *bout, float density_bias, int N, int warp, int g, int c) {
    if (c >= NOUT) return;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const long long n = n0 + warp * 16 + g + 8 * rr;
        if (n >= N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int ch = c + e;
            const float v = bf16_round(add(o[2 * rr + e], bout[ch]));
            if (ch == 0) {
                out[n] = v;
                out[(size_t)N + n] = expf(add(v, density_bias));
            } else {
                out[(size_t)(1 + ch) * N + n] = __fdiv_rn(1.f, add(1.f, expf(-v)));
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
triplane_points_kernel(const T *__restrict__ planes,  // (3, H, W, 40) channels last
                     const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,
                     const uint4 *__restrict__ wts,   // W_BYTES of swizzled bf16 rows
                     const float *__restrict__ bias,  // NBIAS
                     float *__restrict__ out,         // (5, N): density, density_act, r, g, b
                     int N, int H, int W, float radius, float density_bias, int align_corners) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char *ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char *ws = ring + NSTAGE * SLOT_BYTES;  // 1024-aligned
    float *bs = reinterpret_cast<float *>(ws + W_BYTES);
    const uint32_t full = smem_u32(bs + NBIAS), empty = full + 8 * NSTAGE;

    for (int i = threadIdx.x; i < W_BYTES / 16; i += THREADS) reinterpret_cast<uint4 *>(ws)[i] = wts[i];
    for (int i = threadIdx.x; i < NBIAS; i += THREADS) bs[i] = bias[i];
    // feature columns 120..127 (chunk 15: K half 1, chunk 7) stay zero
    for (int i = threadIdx.x; i < NSTAGE * 2 * TP; i += THREADS) {
        const int r = i % TP;
        *reinterpret_cast<uint4 *>(ring + (i / TP) * TILE_BYTES + HALF_BYTES + r * ROW_BYTES +
                                   ((7 ^ (r & 7)) << 4)) = make_uint4(0, 0, 0, 0);
    }
    if (threadIdx.x == 0) {
        for (int s = 0; s < NSTAGE; ++s) {
            mbar_init(full + 8 * s, 128);   // the producers' arrivals
            mbar_init(empty + 8 * s, 128);  // the consumer warpgroup's arrivals
        }
        fence_mbar_init();
    }
    fence_proxy_async();  // the weights and zero columns are read by wgmma
    __syncthreads();

    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const long long npairs = (N + PAIR - 1) / PAIR;
    if (wg >= CONSUMERS) {
        const int pw = wg - CONSUMERS;
        setmaxnreg_dec<PRODUCER_REGS>();
        produce(ring, full, empty, planes, px, py, pz, N, H, W, radius, align_corners != 0, npairs, pw, tid);
        return;
    }
    setmaxnreg_inc<CONSUMER_REGS>();

    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = (lane & 3) * 2;
    const uint32_t sring = smem_u32(ring), sw = smem_u32(ws);
    const uint64_t dout = desc_sw128(sw + OUT_OFF);
    auto hidden_desc = [&](int l) { return desc_sw128(sw + HID_OFF + l * W_LAYER_BYTES); };
    for (long long n = wg, q = blockIdx.x + (long long)wg * gridDim.x; q < npairs;
         n += CONSUMERS, q += (long long)CONSUMERS * gridDim.x) {
        const int s = (int)(n % NSTAGE);
        mbar_wait(full + 8 * s, (uint32_t)((n / NSTAGE) & 1));
        const uint32_t t0 = sring + s * SLOT_BYTES;

        uint32_t a0[4][4], a1[4][4];
        float d0[32], d1[32], o0[4], o1[4];
#pragma unroll
        for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o0[i] = o1[i] = 0.f;
        issue_first(d0, t0, sw);
        issue_first(d1, t0 + TILE_BYTES, sw);
#pragma unroll
        for (int l = 0; l <= LAYERS; ++l) {  // unrolled: no branch around a wgmma
            const float *bl = bs + l * HW;    // b1, then each hidden layer's bias
            wgmma_wait<1>();                  // tile 0's layer is done; tile 1's still runs
            fence_regs(d0);
            hidden_epilogue(a0, d0, bl, c);
            if (l < LAYERS) issue_k64(d0, a0, hidden_desc(l));
            else issue_k64(o0, a0, dout);
            wgmma_wait<1>();
            fence_regs(d1);
            // both tiles' first layers have read the slot: hand it back
            if (l == 0) mbar_arrive(empty + 8 * s);
            hidden_epilogue(a1, d1, bl, c);
            if (l < LAYERS) issue_k64(d1, a1, hidden_desc(l));
            else issue_k64(o1, a1, dout);
        }
        wgmma_wait<1>();
        fence_regs(o0);
        store_tile(out, q * PAIR, o0, bs + OUT_BIAS, density_bias, N, warp, g, c);
        wgmma_wait<0>();
        fence_regs(o1);
        store_tile(out, q * PAIR + TP, o1, bs + OUT_BIAS, density_bias, N, warp, g, c);
    }
}

}  // namespace

// Dynamic shared memory of one block: the ring, the weights, the biases and
// 2 NSTAGE mbarriers, 1024-aligned.
static size_t triplane_smem_bytes() {
    return 1024 + (size_t)NSTAGE * SLOT_BYTES + W_BYTES + NBIAS * 4 + 16 * NSTAGE;
}

template <typename T>
static int launch(const void *planes, const void *px, const void *py, const void *pz, const void *wts,
                  const void *bias, void *out, int N, int H, int W, float radius, float density_bias,
                  int align_corners, int num_sms, cudaStream_t st) {
    const size_t smem = triplane_smem_bytes();
    static bool smem_set[MAX_DEVICES] = {};  // once per device and tap type
    if (int e = allow_smem(triplane_points_kernel<T>, (int)smem, smem_set)) return e;
    // persistent: at most one block per SM, each walking pairs of tiles
    const long long npairs = ((long long)N + PAIR - 1) / PAIR;
    const int grid = (int)std::min<long long>(npairs, num_sms);
    triplane_points_kernel<T><<<grid, THREADS, smem, st>>>(
        static_cast<const T *>(planes), static_cast<const float *>(px), static_cast<const float *>(py),
        static_cast<const float *>(pz), static_cast<const uint4 *>(wts), static_cast<const float *>(bias),
        static_cast<float *>(out), N, H, W, radius, density_bias, align_corners);
    return (int)cudaGetLastError();
}

// planes (3, H, W, 40) channels last, bf16 when planes_bf16 is set, else f32
extern "C" int triplane_points_fwd(const void *planes, int planes_bf16, const void *px, const void *py,
                                   const void *pz, const void *wts, const void *bias, void *out, int N, int H, int W,
                                   float radius, float density_bias, int align_corners, int num_sms, void *stream) {
    if (N < 0 || H < 2 || W < 2 || !(radius > 0.f)) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    return planes_bf16 ? launch<__nv_bfloat16>(planes, px, py, pz, wts, bias, out, N, H, W, radius, density_bias,
                                               align_corners, num_sms, st)
                       : launch<float>(planes, px, py, pz, wts, bias, out, N, H, W, radius, density_bias,
                                       align_corners, num_sms, st);
}
