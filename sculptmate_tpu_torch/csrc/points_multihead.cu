// K6: scattered triplane sample + SF3D's features and perturb-normal heads.
//
// Replaces: sculptmate_tpu/ops/density_grid.py:query_points_multihead
// (l.323), the XLA program that the texture bake runs at every texel of the
// atlas: a bilinear sample of the three (40, H, W) planes at each point
// (align_corners), the 120 features in bf16, then the two equal-depth heads
// of MaterialMLP packed as one 128-wide block-diagonal MLP (l.344-355):
// 120 -> 128 (SiLU) -> 2 x [128 -> 128 block-diagonal (SiLU)] -> 6, raw
// (no output activation) and f32, channels first, head 0's then head 1's.
//
// Bound on the H100: operations, barely. A 512^2 bake queries 262 144
// points at 97 792 tensor-core flops each (25.6 GFLOP, 0.026 ms at 989
// TFLOP/s) against 12 bytes in and 24 bytes out per point plus 35 MB of
// planes read once (0.013 ms at 3.35 TB/s). The bilinear taps are scattered
// gathers: 12 taps of 80 bytes per point, from planes that fit in L2. Per
// point the two heads take 384 SiLUs (three 64-wide layers each).
//
// Design (K4's, in triplane_points.cu, fitted to two heads):
// - a block is two producer warpgroups and two consumer warpgroups,
//   persistent (one block per SM), walking pairs of 64-point tiles. Pair n
//   is gathered by producer n % 2 into ring slot n % 4 and run by consumer
//   n % 2, so each slot has one producer and one consumer, in order (an
//   mbarrier's phases are told apart only by their parity). The producers
//   give registers to the consumers (setmaxnreg: 96 against 160);
// - the producers gather: thread t takes point t of a pair and its three
//   planes, loading the 4 taps of two 8-feature chunks at a time from the
//   bf16 channels-last planes (an 80-byte tap). Taps are summed in f32 in
//   the plain version's order ((t00 + t10) + t01) + t11, each product and
//   sum rounded on its own (a tap outside the plane is its clamped
//   neighbour times 0), and the 120 bf16 features (8 zero columns pad them
//   to 128) go into the slot in the 128-byte swizzle that wgmma reads;
// - a full slot is handed over by an mbarrier (the producer warpgroup's 128
//   arrivals), and handed back by another once the consumer's first layers
//   of both tiles have read it;
// - each consumer warpgroup runs a tile's two heads with wgmma m64n64k16,
//   the heads as its two products in flight: while the tensor cores run one
//   head's layer, the warpgroup computes the other's SiLU. The first layer
//   is one 64-wide product per head over K = 128 from the slot; the hidden
//   layers take each head's 64 x 64 block from registers (hopper.cuh's
//   hidden_epilogue); the output layer is an m64n8k16 product of each
//   head's 64 activations with an 8-row tile that holds its channels at
//   their place in the output (zero elsewhere), and the two tiles' sums
//   add. The block-diagonal zeros are neither stored nor multiplied. The
//   second tile's first layers are issued before the first tile's outputs
//   are stored;
// - the weights sit in shared memory for the block's life, swizzled on the
//   host; the first and hidden layers' weights and biases are halved there
//   (exact in bf16), so each product gives h = x / 2 and SiLU is
//   h (1 + tanh h): one tanh.approx.bf16x2 and one fma.rn.bf16x2 for two
//   activations;
// - the outputs are rounded to bf16 before they are returned as f32, as the
//   plain version computes them in bf16.
//
// The planes' relayout, once per scene code: (3, 40, H, W) in f32 or bf16
// -> (3, H, W, 40) bf16, one pass through shared memory (points_planes_fwd).
// Bound: bytes, the codes read once and 35.4 MB written at 384^2.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace sm_port;

constexpr int C = 40;                     // channels per plane
constexpr int HW = 64;                    // each head's hidden width
constexpr int HEADS = 2;
constexpr int LAYERS = 2;                 // hidden 64 x 64 layers per head (MaterialMLP's n_hidden_layers 3)
constexpr int MAX_OUT = 8;                // output channels in all, at most
constexpr int TP = 64;                    // points per tile: the M rows of one wgmma
constexpr int PAIR = 2 * TP;              // points per slot
constexpr int CONSUMERS = 2;              // consumer warpgroups per block
constexpr int PRODUCERS = 2;              // producer warpgroups per block
constexpr int THREADS = (CONSUMERS + PRODUCERS) * 128;
// registers per thread: the producers give theirs up to the consumers
constexpr int PRODUCER_REGS = 96;
constexpr int CONSUMER_REGS = ((65536 - 128 * PRODUCERS * PRODUCER_REGS) / (128 * CONSUMERS)) & ~7;
constexpr int NSTAGE = 4;                 // pair slots in the ring
constexpr int GATHER_CHUNKS = 2;          // 8-feature chunks a producer loads at once
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
constexpr int W1_BYTES = 2 * W_LAYER_BYTES;         // a head's first layer: two 64-deep halves
constexpr int HID_OFF = HEADS * W1_BYTES;           // head h's hidden layer l at + (h LAYERS + l) W_LAYER_BYTES
constexpr int OUT_OFF = HID_OFF + HEADS * LAYERS * W_LAYER_BYTES;  // head h's 8-row output tile at + h 1024
constexpr int W_BYTES = OUT_OFF + HEADS * 8 * ROW_BYTES;
// halved biases of layer l (0 the first, then the hidden ones) of head h at
// (l HEADS + h) HW, then the output channels' zero-padded to 8
constexpr int OUT_BIAS = (1 + LAYERS) * HEADS * HW;
constexpr int NBIAS = OUT_BIAS + MAX_OUT;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the 40 features of plane q at (cx, cy) into row r of a feature tile:
// features 40q .. 40q + 39 are the 16-byte chunks 5q .. 5q + 4 of the row's
// 16, chunk g in K half g / 8 at swizzled place (g % 8) ^ (r % 8)
__device__ __forceinline__ void gather_plane(unsigned char *tile, int r, int q,
                                             const __nv_bfloat16 *__restrict__ plane, float cx, float cy, int H,
                                             int W, bool align_corners) {
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
    // GATHER_CHUNKS chunks of 8 features at a time: their 4 taps' loads are
    // in flight together, and few registers are held
    constexpr int G = GATHER_CHUNKS;
#pragma unroll
    for (int m0 = 0; m0 < 5; m0 += G) {
        float f[G][8];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int mm = 0; mm < G; ++mm) {
                if (m0 + mm >= 5) continue;  // resolved at compile time
                const uint4 v = __ldg(src[t] + m0 + mm);
                const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const float x = __uint_as_float(e & 1 ? wd[e >> 1] & 0xFFFF0000u : wd[e >> 1] << 16);
                    f[mm][e] = t == 0 ? mul(x, wv[t]) : add(f[mm][e], mul(x, wv[t]));
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
__device__ __forceinline__ void produce(unsigned char *ring, uint32_t full, uint32_t empty,
                                        const __nv_bfloat16 *__restrict__ planes, const float *__restrict__ px,
                                        const float *__restrict__ py, const float *__restrict__ pz, int N, int H,
                                        int W, float inv_r, bool align_corners, long long npairs, int pw, int t) {
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
            // coordinate scaled by the f32 reciprocal of the radius as the
            // plain version scales it
            const float x = mul(px[p], inv_r), y = mul(py[p], inv_r), z = mul(pz[p], inv_r);
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

// the first layer of one head on one tile: 64 points x 128 features (two
// swizzled halves) times the head's two halves, 8 k-steps issued and
// committed as one group
__device__ __forceinline__ void issue_first(float (&d)[32], uint32_t tile, uint32_t w1) {
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
        const uint32_t h = (ks >> 2) * HALF_BYTES, kc = ks & 3;
        wgmma_ss<0>(d, desc_sw128(tile + h) + 2 * kc, desc_sw128(w1 + h) + 2 * kc, ks);
    }
    wgmma_commit();
}

// columns c, c + 1 of rows g (o[0..1]) and g + 8 (o[2..3]) of each head's
// output tile; the two heads' sums add (each is zero in the other's channels)
__device__ __forceinline__ void store_tile(float *__restrict__ out, long long n0, const float (&o0)[4],
                                           const float (&o1)[4], const float *bout, int N, int K, int warp, int g,
                                           int c) {
    if (c >= K) return;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const long long n = n0 + warp * 16 + g + 8 * rr;
        if (n >= N) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int ch = c + e;
            if (ch < K) out[(size_t)ch * N + n] = bf16_round(add(add(o0[2 * rr + e], o1[2 * rr + e]), bout[ch]));
        }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
points_multihead_kernel(const __nv_bfloat16 *__restrict__ planes,  // (3, H, W, 40) channels last
                        const float *__restrict__ px, const float *__restrict__ py, const float *__restrict__ pz,
                        const uint4 *__restrict__ wts,   // W_BYTES of swizzled bf16 rows
                        const float *__restrict__ bias,  // NBIAS
                        float *__restrict__ out,         // (K, N)
                        int N, int H, int W, int K, float inv_r, int align_corners) {
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
        produce(ring, full, empty, planes, px, py, pz, N, H, W, inv_r, align_corners != 0, npairs, pw, tid);
        return;
    }
    setmaxnreg_inc<CONSUMER_REGS>();

    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = (lane & 3) * 2;
    const uint32_t sring = smem_u32(ring), sw = smem_u32(ws);
    const uint64_t dout0 = desc_sw128(sw + OUT_OFF), dout1 = desc_sw128(sw + OUT_OFF + 8 * ROW_BYTES);
    auto hidden_desc = [&](int h, int l) { return desc_sw128(sw + HID_OFF + (h * LAYERS + l) * W_LAYER_BYTES); };
    for (long long n = wg, q = blockIdx.x + (long long)wg * gridDim.x; q < npairs;
         n += CONSUMERS, q += (long long)CONSUMERS * gridDim.x) {
        const int s = (int)(n % NSTAGE);
        mbar_wait(full + 8 * s, (uint32_t)((n / NSTAGE) & 1));
        const uint32_t t0 = sring + s * SLOT_BYTES;

        uint32_t a0[4][4], a1[4][4];  // head 0's and head 1's activations
        float d0[32], d1[32], o0[4], o1[4];
#pragma unroll
        for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o0[i] = o1[i] = 0.f;
        issue_first(d0, t0, sw);
        issue_first(d1, t0, sw + W1_BYTES);
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {  // unrolled, as the layers: no branch around a wgmma
#pragma unroll
            for (int l = 0; l <= LAYERS; ++l) {
                wgmma_wait<1>();  // head 0's layer is done; head 1's still runs
                fence_regs(d0);
                hidden_epilogue(a0, d0, bs + (l * HEADS) * HW, c);
                if (l < LAYERS) issue_k64(d0, a0, hidden_desc(0, l));
                else issue_k64(o0, a0, dout0);
                wgmma_wait<1>();
                fence_regs(d1);
                // both tiles' first layers have read the slot: hand it back
                if (l == 0 && tile == 1) mbar_arrive(empty + 8 * s);
                hidden_epilogue(a1, d1, bs + (l * HEADS + 1) * HW, c);
                if (l < LAYERS) issue_k64(d1, a1, hidden_desc(1, l));
                else issue_k64(o1, a1, dout1);
            }
            if (tile == 0) {
                // the second tile's first layers run while the first tile's
                // outputs are stored
                issue_first(d0, t0 + TILE_BYTES, sw);
                issue_first(d1, t0 + TILE_BYTES, sw + W1_BYTES);
                wgmma_wait<2>();
            } else {
                wgmma_wait<0>();
            }
            fence_regs(o0);
            fence_regs(o1);
            store_tile(out, q * PAIR + tile * TP, o0, o1, bs + OUT_BIAS, N, K, warp, g, c);
        }
    }
}

// ---- the planes' relayout ----------------------------------------------------

constexpr int RL_X = 64;          // points of a plane row per block
constexpr int RL_THREADS = 256;

__device__ __forceinline__ __nv_bfloat16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ __nv_bfloat16 to_bf16(__nv_bfloat16 x) { return x; }

// block (x chunk, y, plane): the 40 channels of RL_X points of row y, read
// along x (16 bytes of one channel per load where the rows allow it),
// transposed in shared memory, written as one contiguous run of the
// channels-last output
template <typename T>
__global__ void __launch_bounds__(RL_THREADS) planes_relayout(const T *__restrict__ src,
                                                              __nv_bfloat16 *__restrict__ dst, int H, int W) {
    constexpr int VEC = 16 / sizeof(T);                     // values of one 16-byte load
    __shared__ __align__(16) __nv_bfloat16 tile[RL_X * C];  // [x][c]: the output's order
    const int x0 = blockIdx.x * RL_X, y = blockIdx.y, p = blockIdx.z;
    const int nx = min(RL_X, W - x0);
    const T *s = src + ((size_t)p * C * H + y) * W + x0;  // channel c at s + c H W
    if (W % VEC == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {  // nx is a multiple of VEC too
        for (int e = threadIdx.x; e < C * (RL_X / VEC); e += RL_THREADS) {
            const int ch = e / (RL_X / VEC), xv = (e % (RL_X / VEC)) * VEC;
            if (xv >= nx) continue;
            const uint4 raw = __ldg(reinterpret_cast<const uint4 *>(s + (size_t)ch * H * W + xv));
            const T *v = reinterpret_cast<const T *>(&raw);
#pragma unroll
            for (int i = 0; i < VEC; ++i) tile[(xv + i) * C + ch] = to_bf16(v[i]);
        }
    } else {
        for (int e = threadIdx.x; e < C * RL_X; e += RL_THREADS) {
            const int ch = e / RL_X, x = e % RL_X;
            if (x < nx) tile[x * C + ch] = to_bf16(s[(size_t)ch * H * W + x]);
        }
    }
    __syncthreads();
    // nx * 80 bytes, 16-byte aligned (a point's 40 channels are 5 chunks)
    uint4 *d = reinterpret_cast<uint4 *>(dst + (((size_t)p * H + y) * W + x0) * C);
    const uint4 *t4 = reinterpret_cast<const uint4 *>(tile);
    for (int e = threadIdx.x; e < nx * C / 8; e += RL_THREADS) d[e] = t4[e];
}

}  // namespace

// Dynamic shared memory of one block: the ring, the weights, the biases and
// 2 NSTAGE mbarriers, 1024-aligned.
static size_t points_smem_bytes() { return 1024 + (size_t)NSTAGE * SLOT_BYTES + W_BYTES + NBIAS * 4 + 16 * NSTAGE; }

// planes (3, H, W, 40) bf16 channels last; wts and bias as
// ops/density_grid.py:pack_points_weights packs them; out (K, N) f32
extern "C" int points_multihead_fwd(const void *planes, const void *px, const void *py, const void *pz,
                                    const void *wts, const void *bias, void *out, int N, int H, int W, int K,
                                    float inv_r, int align_corners, int num_sms, void *stream) {
    if (K < 1 || K > MAX_OUT || N < 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
    if (N == 0) return 0;
    const size_t smem = points_smem_bytes();
    static bool smem_set[MAX_DEVICES] = {};  // once per device
    if (int e = allow_smem(points_multihead_kernel, (int)smem, smem_set)) return e;
    // persistent: at most one block per SM, each walking pairs of tiles
    const long long npairs = ((long long)N + PAIR - 1) / PAIR;
    const int grid = (int)std::min<long long>(npairs, num_sms);
    points_multihead_kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16 *>(planes), static_cast<const float *>(px), static_cast<const float *>(py),
        static_cast<const float *>(pz), static_cast<const uint4 *>(wts), static_cast<const float *>(bias),
        static_cast<float *>(out), N, H, W, K, inv_r, align_corners);
    return (int)cudaGetLastError();
}

// (P, 40, H, W) planes, bf16 when src_bf16 is set, else f32 -> (P, H, W, 40)
// bf16, each value rounded to nearest even
extern "C" int points_planes_fwd(const void *src, int src_bf16, void *dst, int P, int channels, int H, int W,
                                 void *stream) {
    if (channels != C || P < 1 || H < 1 || W < 1 || H > 65535 || P > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + RL_X - 1) / RL_X, H, P);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    __nv_bfloat16 *d = static_cast<__nv_bfloat16 *>(dst);
    if (src_bf16)
        planes_relayout<<<grid, RL_THREADS, 0, st>>>(static_cast<const __nv_bfloat16 *>(src), d, H, W);
    else
        planes_relayout<<<grid, RL_THREADS, 0, st>>>(static_cast<const float *>(src), d, H, W);
    return (int)cudaGetLastError();
}
