// K5: fused two-head triplane MLP over the full R^3 marching-tets lattice.
//
// Replaces: sculptmate_tpu/ops/density_grid.py:query_grid_multihead, the
// z-slab lax.map program that runs SF3D's density and vertex-offset heads
// (MaterialMLP, one hidden layer each) over every lattice point on the TPU.
//
// Per lattice point (i, j, k) and head h it forms
// h1 = silu(A[i,j,h] + B[k,i,h] + C[k,j,h]) from the three factorized
// first-layer partial sums (small matmuls done in torch; A already holds
// the first-layer bias; the two heads' 64 columns sit side by side, 128 in
// all), runs the head's hidden 64x64 SiLU layer and its output layer, and
// writes the raw outputs (head 0's channels, then head 1's; no output bias
// of the head, no activation) as f32 into out (K, R, R, R) in [x, y, z]
// order.
//
// Bound on the H100: operations. At R = 161 the lattice is 4.17 M points x
// ~16.9 K tensor-core flops each (70 GFLOP, 0.071 ms at 989 TFLOP/s)
// against a 67 MB f32 output (0.020 ms); the 1.07 G SiLUs run on the SFU
// and FP32 pipes, not on the tensor cores.
//
// Design: K2's (density_grid.cu), at two heads and one hidden layer. A tile
// is 64 consecutive k at fixed (i, j): the 64 M rows of wgmma m64n64k16 for
// one warpgroup. Three warpgroups per persistent block each walk their own
// tiles:
// - a tile's B[k0.., i] and C[k0.., j] rows arrive by TMA, one 64-channel
//   box per head (3-D tensor maps over the (R_k, R_i|j, 128) partials,
//   128-byte swizzle, rows past R load as zeros); once the first layer has
//   read them, the next tile's rows load while this tile's layers run;
// - both heads' hidden weights and their 8-row output tiles sit in shared
//   memory for the whole block as the B operand of every product; the
//   activations are the register A operand and never leave registers;
// - the two heads are two independent chains: while wgmma runs one head's
//   product, the warpgroup computes the other's first layer or SiLU;
// - each head's output tile holds its channels at their place in the
//   concatenated output (zeros elsewhere), so the two output products add
//   into one 8-column result exactly.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace sm_port;

constexpr int HW = 64;                                 // hidden width of a head
constexpr int HEADS = 2;                               // heads (the wrapper rejects others)
constexpr int TK = 64;                                 // lattice points (consecutive k) per tile
constexpr int WGS = 3;                                 // warpgroups per block
constexpr int MAX_OUT = 8;                             // output channels in all, at most
constexpr int ROW_BYTES = HW * 2;                      // one 64-channel bf16 row
constexpr int BOX_BYTES = TK * ROW_BYTES;              // one head's B (or C) rows of a tile
constexpr int BUF_BYTES = 2 * HEADS * BOX_BYTES;       // per warpgroup: [B h0][C h0][B h1][C h1]
constexpr int W_LAYER_BYTES = HW * ROW_BYTES;          // one hidden layer, 8 KB
constexpr int OUT_TILE_BYTES = MAX_OUT * ROW_BYTES;    // one head's output tile, 1 KB
constexpr int NBIAS = HEADS * HW + MAX_OUT;            // halved hidden biases, output biases

struct Tile {
    int i, j, k0;
    bool valid;
};

__device__ __forceinline__ Tile tile_of(long long t, long long ntiles, int R, int KB) {
    Tile tl;
    tl.valid = t < ntiles;
    if (!tl.valid) t = ntiles - 1;  // computed on, never stored
    const long long ij = t / KB;
    tl.k0 = (int)(t % KB) * TK;
    tl.i = (int)(ij / R);
    tl.j = (int)(ij % R);
    return tl;
}

// h1 of one head for this thread's rows (16w + g, +8) in A-fragment order;
// arow: the head's 64 channels of A[i, j]; rows: the head's B then C box
__device__ __forceinline__ void first_layer(uint32_t (&a)[4][4], const __nv_bfloat16 *__restrict__ arow,
                                            const unsigned char *rows, int warp, int g, int c) {
    const unsigned char *bs = rows, *cs = rows + BOX_BYTES;
    const int r0 = warp * 16 + g;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int chunk = 2 * kc + half;
            const uint32_t av = __ldg(reinterpret_cast<const unsigned int *>(arow + chunk * 8 + c));
            // 128-byte swizzle: chunk q of row r sits at q ^ (r % 8); r % 8 = g
            const int off = ((chunk ^ g) << 4) + c * 2;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                const int r = r0 + 8 * rr;
                const uint32_t bv = *reinterpret_cast<const uint32_t *>(bs + r * ROW_BYTES + off);
                const uint32_t cv = *reinterpret_cast<const uint32_t *>(cs + r * ROW_BYTES + off);
                // (A + B) + C in bf16, as the plain version sums; then x / 2
                const uint32_t s = bf16x2_add(bf16x2_add(av, bv), cv);
                __nv_bfloat162 hv = __hmul2(*reinterpret_cast<const __nv_bfloat162 *>(&s),
                                            __floats2bfloat162_rn(0.5f, 0.5f));
                a[kc][half * 2 + rr] = silu_of_half(*reinterpret_cast<uint32_t *>(&hv));
            }
        }
    }
}

// the sum of the heads' output products, 8 columns: lanes hold columns c and
// c + 1 of rows g (o[0], o[1]) and g + 8 (o[2], o[3])
__device__ __forceinline__ void store_tile(float *__restrict__ out, const Tile &tl, const float (&o0)[4],
                                           const float (&o1)[4], const float *__restrict__ bout, int K,
                                           int R, int warp, int g, int c) {
    if (!tl.valid) return;
    const size_t plane = (size_t)R * R * R;
    const size_t row = ((size_t)tl.i * R + tl.j) * R;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int k = tl.k0 + warp * 16 + g + 8 * rr;
        if (k >= R) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int ch = c + e;
            // the head's output is bf16, as in the plain version
            if (ch < K) out[ch * plane + row + k] = bf16_round(o0[2 * rr + e] + o1[2 * rr + e] + bout[ch]);
        }
    }
}

__global__ void __launch_bounds__(WGS * 128, 1)
grid_multihead_bf16(const __grid_constant__ CUtensorMap tmb, const __grid_constant__ CUtensorMap tmc,
                    const __nv_bfloat16 *__restrict__ A,  // (R, R, 128): A[i, j] + b1, both heads
                    const uint4 *__restrict__ Wp,         // (2*64 + 2*8) swizzled rows of 64 bf16
                    const float *__restrict__ bias,       // (NBIAS): halved b1 of each head, b_out
                    float *__restrict__ out, int R, int K) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char *base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char *bufs = base;                                   // WGS tile buffers
    unsigned char *ws = bufs + WGS * BUF_BYTES;                   // weights, 1024-aligned
    float *bs = reinterpret_cast<float *>(ws + HEADS * (W_LAYER_BYTES + OUT_TILE_BYTES));
    const uint32_t bars = smem_u32(bs + NBIAS);                   // WGS mbarriers
    const uint32_t sw = smem_u32(ws);

    for (int idx = threadIdx.x; idx < HEADS * (HW + MAX_OUT) * (ROW_BYTES / 16); idx += blockDim.x)
        reinterpret_cast<uint4 *>(ws)[idx] = Wp[idx];
    for (int idx = threadIdx.x; idx < NBIAS; idx += blockDim.x) bs[idx] = bias[idx];
    if (threadIdx.x == 0) {
        for (int b = 0; b < WGS; ++b) mbar_init(bars + 8 * b, 1);
        fence_mbar_init();
    }
    fence_proxy_async();  // the weights are read by wgmma (the async proxy)
    __syncthreads();

    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = (lane & 3) * 2;
    const int KB = (R + TK - 1) / TK;
    const long long ntiles = (long long)R * R * KB;
    const long long G = (long long)gridDim.x * WGS;
    const uint64_t dw0 = desc_sw128(sw), dw1 = desc_sw128(sw + W_LAYER_BYTES);
    const uint64_t dout0 = desc_sw128(sw + HEADS * W_LAYER_BYTES);
    const uint64_t dout1 = desc_sw128(sw + HEADS * W_LAYER_BYTES + OUT_TILE_BYTES);
    unsigned char *buf = bufs + wg * BUF_BYTES;
    const uint32_t bar = bars + 8 * wg;
    const CUtensorMap *mb = &tmb, *mc = &tmc;
    // one thread loads a tile's B and C rows, both heads, into the buffer
    auto issue_loads = [&](long long t) {
        const Tile tl = tile_of(t, ntiles, R, KB);
        mbar_expect_tx(bar, BUF_BYTES);
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
            const uint32_t dst = smem_u32(buf + 2 * h * BOX_BYTES);
            tma_load_3d(dst, mb, bar, h * HW, tl.i, tl.k0);
            tma_load_3d(dst + BOX_BYTES, mc, bar, h * HW, tl.j, tl.k0);
        }
    };

    long long q = blockIdx.x * WGS + wg;
    if (tid == 0 && q < ntiles) issue_loads(q);
    for (int n = 0; q < ntiles; ++n, q += G) {
        mbar_wait(bar, n & 1);
        const Tile t = tile_of(q, ntiles, R, KB);
        const __nv_bfloat16 *arow = A + ((size_t)t.i * R + t.j) * (HEADS * HW);

        uint32_t a0[4][4], a1[4][4];
        float d0[32], d1[32], o0[4], o1[4];
        first_layer(a0, arow, buf, warp, g, c);
        issue_k64(d0, a0, dw0);
        first_layer(a1, arow + HW, buf + 2 * BOX_BYTES, warp, g, c);
        issue_k64(d1, a1, dw1);
        // the buffer is read: the next tile's rows load while this tile's
        // layers run
        named_bar_sync(1 + wg, 128);
        if (tid == 0 && q + G < ntiles) issue_loads(q + G);

        wgmma_wait<1>();  // head 0's hidden product is done; head 1's still runs
        fence_regs(d0);
        hidden_epilogue(a0, d0, bs, c);
        issue_k64(o0, a0, dout0);
        wgmma_wait<1>();
        fence_regs(d1);
        hidden_epilogue(a1, d1, bs + HW, c);
        issue_k64(o1, a1, dout1);
        wgmma_wait<0>();
        fence_regs(o0);
        fence_regs(o1);
        store_tile(out, t, o0, o1, bs + HEADS * HW, K, R, warp, g, c);
    }
}

}  // namespace

// Dynamic shared memory of one block.
static size_t multihead_smem_bytes() {
    return 1024 + (size_t)WGS * BUF_BYTES + (size_t)HEADS * (W_LAYER_BYTES + OUT_TILE_BYTES) +
           (size_t)NBIAS * 4 + 8 * WGS;
}

extern "C" int grid_multihead_fwd(const void *A, const void *B, const void *C, const void *Wp,
                                  const void *bias, void *out, int R, int K, int num_sms, void *stream) {
    if (K < 1 || K > MAX_OUT) return (int)cudaErrorInvalidValue;
    // B (R_k, R_i, 128) and C (R_k, R_j, 128) as (channel, i|j, k): a box is
    // one head's 64 channels of the 64 rows k0.. at one i (or j)
    CUtensorMap tmb, tmc;
    const cuuint64_t dims[3] = {HEADS * HW, (cuuint64_t)R, (cuuint64_t)R};
    const cuuint64_t rowb = HEADS * ROW_BYTES, planeb = (cuuint64_t)R * HEADS * ROW_BYTES;
    const cuuint64_t strides[2] = {rowb, planeb};
    const cuuint32_t box[3] = {HW, 1, TK};
    int err = encode_bf16_map(&tmb, B, 3, dims, strides, box);
    if (!err) err = encode_bf16_map(&tmc, C, 3, dims, strides, box);
    if (err) return err;
    const size_t smem = multihead_smem_bytes();
    static bool smem_set = false;  // once per process
    if (!smem_set) {
        cudaError_t e = cudaFuncSetAttribute(grid_multihead_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    // persistent: at most one block per SM, each warpgroup taking tiles in turn
    const long long ntiles = (long long)R * R * ((R + TK - 1) / TK);
    const int grid = (int)std::min<long long>(num_sms, (ntiles + WGS - 1) / WGS);
    grid_multihead_bf16<<<grid, WGS * 128, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        tmb, tmc, static_cast<const __nv_bfloat16 *>(A), static_cast<const uint4 *>(Wp),
        static_cast<const float *>(bias), static_cast<float *>(out), R, K);
    return (int)cudaGetLastError();
}
