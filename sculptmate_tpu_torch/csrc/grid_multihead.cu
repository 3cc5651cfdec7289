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
// (one tanh.approx.bf16x2 per two: ~0.13 ms on 132 SMs) and the FP32 pipes,
// not on the tensor cores. Two costs come on top: the partial sums' rows
// each tile copies from L2 into shared memory (a B and a C row per point
// and head: 2.1 GB at R = 161 if every tile loaded its own), and latency.
//
// Design: K4's warp-specialized pipeline (triplane_points.cu) without its
// gather. A tile is 64 consecutive k at fixed (i, j): the 64 M rows of
// wgmma m64n64k16. A tile block is CONSUMERS rows i x 2 rows j at one k
// range; persistent blocks (one per SM) take the tile blocks u *
// gridDim.x + blockIdx.x, u = 0, 1, ...:
// - one producer warp keeps TMA loads in flight into a ring of NSTAGE
//   slots: a slot holds one tile block's B[k0.., i] rows for its rows i and
//   C[k0.., j] rows for its two rows j, both heads (one 64-channel box
//   each, 3-D tensor maps over the (R_k, R_i|j, 128) partials, 128-byte
//   swizzle, rows past R load as zeros), and by bulk copies on the same
//   mbarrier its rows A[i, j]. A box serves two or three tiles, so a tile
//   costs (CONSUMERS + 2) / (2 CONSUMERS) of the bytes that a slot per tile
//   would (on an H100, loading one box pair per tile took 0.37 ms alone at
//   R = 161, the tile blocks 0.16);
// - the consumer warpgroups (setmaxnreg: the producer's warpgroup gives
//   them its registers) each take one row i of every tile block, its two
//   tiles j0 and j0 + 1. Every consumer reads every slot, in order, and
//   hands it back (an mbarrier of all their arrivals) once its first layers
//   have read it, so the slots' phases stay in step (they are told apart
//   only by parity). Three consumers beat two (more warps to hide the
//   latency of each SiLU chain), though at their 160 registers ptxas
//   serializes some products (C7512);
// - a consumer runs its two tiles' four chains (tile, head) on a rolling
//   schedule: while the tensor cores run one chain's hidden or output
//   product, the warpgroup computes another's first layer or SiLU, with at
//   most two hidden and two output products in flight;
// - the first layer takes its B and C pairs with ldmatrix (one instruction
//   for what four 4-byte loads read), and each product starts from its
//   bias (the hidden layer's halved bias, the output bias), so the SiLU
//   epilogue only packs, tanh and fma;
// - both heads' hidden weights and their 8-row output tiles sit in shared
//   memory for the block's life as the B operand of every product; the
//   activations are the register A operand and never leave registers. Each
//   head's output tile holds its channels at their place in the
//   concatenated output (zeros elsewhere), so the second head's output
//   product adds onto the first's: one 8-column result per tile;
// - at R = 161 = 2 x 64 + 33 a third of the tiles run 31 dead rows, and
//   a tile block's rows i or j past R (R not a multiple of 3 or 2) are
//   computed on; neither is stored.
//   Skipping the first layer and SiLU of warps whose rows all lie past R
//   bought nothing: the warpgroup's products wait for its slowest warp,
//   and the branch made ptxas serialize the products.

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace sm_port;

constexpr int HW = 64;                                 // hidden width of a head
constexpr int HEADS = 2;                               // heads (the wrapper rejects others)
constexpr int TK = 64;                                 // lattice points (consecutive k) per tile
constexpr int CONSUMERS = 3;                           // consumer warpgroups: rows i of a tile block
constexpr int TJ = 2;                                  // rows j of a tile block: a consumer's two tiles
constexpr int THREADS = (CONSUMERS + 1) * 128;         // and the producer's warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = ((65536 - 128 * PRODUCER_REGS) / (128 * CONSUMERS)) & ~7;
constexpr int NSTAGE = 2;                              // tile-block slots in the ring
constexpr int MAX_OUT = 8;                             // output channels in all, at most
constexpr int ROW_BYTES = HW * 2;                      // one 64-channel bf16 row
constexpr int BOX_BYTES = TK * ROW_BYTES;              // one head's B (or C) rows of a tile
// [B i0 h0][B i0 h1][B i1 h0] ... [C j0 h0][C j0 h1][C j1 h0][C j1 h1]: 80 KB
constexpr int SLOT_BYTES = (CONSUMERS + TJ) * HEADS * BOX_BYTES;
constexpr int C_OFF = CONSUMERS * HEADS * BOX_BYTES;
constexpr int AROW_BYTES = HEADS * ROW_BYTES;          // A[i, j], both heads
constexpr int SLOT_AROWS = CONSUMERS * TJ * AROW_BYTES;
constexpr int W_LAYER_BYTES = HW * ROW_BYTES;          // one hidden layer, 8 KB
constexpr int OUT_TILE_BYTES = MAX_OUT * ROW_BYTES;    // one head's output tile, 1 KB
constexpr int W_BYTES = HEADS * (W_LAYER_BYTES + OUT_TILE_BYTES);
constexpr int NBIAS = HEADS * HW + MAX_OUT;            // halved hidden biases, output biases

struct Tile {
    int i, j, k0;
    bool valid;
};

// tile block q: rows i0 .. i0 + CONSUMERS - 1 and j0, j0 + 1 at k0
struct Block {
    int i0, j0, k0;
};

__device__ __forceinline__ Block block_of(int q, int R, int KB) {
    const int NJ = (R + TJ - 1) / TJ;
    Block b;
    b.k0 = (q % KB) * TK;
    b.j0 = (q / KB % NJ) * TJ;
    b.i0 = q / KB / NJ * CONSUMERS;
    return b;
}

// h1 of one head for this thread's rows (16w + g, +8) in A-fragment order;
// arow: the head's 64 channels of A[i, j]; brows, crows: the shared
// addresses of the head's B and C boxes. ldmatrix hands each thread its
// B and C pairs in that order: lane l gives row 16w + 8 ((l / 8) % 2) + l % 8
// of chunk 2 kc + l / 16
__device__ __forceinline__ void first_layer(uint32_t (&a)[4][4], const __nv_bfloat16 *arow, uint32_t brows,
                                            uint32_t crows, int warp, int lane, int c) {
    const int r = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
        // 128-byte swizzle: chunk q of row r sits at q ^ (r % 8)
        const uint32_t off = r * ROW_BYTES + ((((2 * kc + (lane >> 4)) ^ (lane & 7))) << 4);
        uint32_t bv[4], cv[4];
        ldsm_x4(bv, brows + off);
        ldsm_x4(cv, crows + off);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const uint32_t av = *reinterpret_cast<const uint32_t *>(arow + (2 * kc + (e >> 1)) * 8 + c);
            // (A + B) + C in bf16, as the plain version sums; then x / 2
            const uint32_t s = bf16x2_add(bf16x2_add(av, bv[e]), cv[e]);
            __nv_bfloat162 hv = __hmul2(*reinterpret_cast<const __nv_bfloat162 *>(&s),
                                        __floats2bfloat162_rn(0.5f, 0.5f));
            a[kc][e] = silu_of_half(*reinterpret_cast<uint32_t *>(&hv));
        }
    }
}

// an accumulator d of N / 2 columns set to the bias b of its columns, so
// the product adds onto it: d[4j], d[4j + 2] column 8j + c, d[4j + 1],
// d[4j + 3] column 8j + c + 1
template <int N>
__device__ __forceinline__ void bias_rows(float (&d)[N], const float *b, int c) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
        const float2 bb = *reinterpret_cast<const float2 *>(b + 8 * j + c);
        d[4 * j] = d[4 * j + 2] = bb.x;
        d[4 * j + 1] = d[4 * j + 3] = bb.y;
    }
}

// SiLU of a hidden layer's sums (the halved bias already in them), packed
// as the next product's A fragments
__device__ __forceinline__ void silu_epilogue(uint32_t (&a)[4][4], const float (&d)[32]) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int jn = 2 * kc + half;
            a[kc][half * 2] = silu_of_half(pack_bf16(d[4 * jn], d[4 * jn + 1]));
            a[kc][half * 2 + 1] = silu_of_half(pack_bf16(d[4 * jn + 2], d[4 * jn + 3]));
        }
    }
}

// the tile's 8-column result (the output bias already in it): lanes hold
// columns c and c + 1 of rows g (o[0], o[1]) and g + 8 (o[2], o[3])
__device__ __forceinline__ void store_tile(float *__restrict__ out, const Tile &tl, const float (&o)[4], int K,
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
            if (ch < K) out[ch * plane + row + k] = bf16_round(o[2 * rr + e]);
        }
    }
}

// the producer: one thread loads tile block u of this block into slot
// u % NSTAGE once every consumer has handed that slot back
__device__ __forceinline__ void produce(unsigned char *ring, unsigned char *arows, uint32_t full, uint32_t empty,
                                        const CUtensorMap *mb, const CUtensorMap *mc,
                                        const __nv_bfloat16 *__restrict__ A, int nblocks, int R, int KB) {
    for (int u = 0, q = blockIdx.x; q < nblocks; ++u, q += gridDim.x) {
        const int s = u % NSTAGE;
        if (u >= NSTAGE) mbar_wait(empty + 8 * s, (uint32_t)((u / NSTAGE - 1) & 1));
        const Block b = block_of(q, R, KB);
        const uint32_t bar = full + 8 * s, dst = smem_u32(ring + s * SLOT_BYTES);
        mbar_expect_tx(bar, SLOT_BYTES + SLOT_AROWS);
        // rows past R (R not a multiple of the block) load as zeros
#pragma unroll
        for (int h = 0; h < HEADS; ++h) {
#pragma unroll
            for (int ci = 0; ci < CONSUMERS; ++ci)
                tma_load_3d(dst + (ci * HEADS + h) * BOX_BYTES, mb, bar, h * HW, b.i0 + ci, b.k0);
#pragma unroll
            for (int x = 0; x < TJ; ++x)
                tma_load_3d(dst + C_OFF + (x * HEADS + h) * BOX_BYTES, mc, bar, h * HW, b.j0 + x, b.k0);
        }
#pragma unroll
        for (int ci = 0; ci < CONSUMERS; ++ci) {
#pragma unroll
            for (int x = 0; x < TJ; ++x) {
                // a row past R takes the last one's place: computed on, never stored
                const int i = min(b.i0 + ci, R - 1), j = min(b.j0 + x, R - 1);
                bulk_load(smem_u32(arows + s * SLOT_AROWS + (ci * TJ + x) * AROW_BYTES),
                          A + ((size_t)i * R + j) * (HEADS * HW), AROW_BYTES, bar);
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
grid_multihead_bf16(const __grid_constant__ CUtensorMap tmb, const __grid_constant__ CUtensorMap tmc,
                    const __nv_bfloat16 *__restrict__ A,  // (R, R, 128): A[i, j] + b1, both heads
                    const uint4 *__restrict__ Wp,         // (2*64 + 2*8) swizzled rows of 64 bf16
                    const float *__restrict__ bias,       // (NBIAS): halved b1 of each head, b_out
                    float *__restrict__ out, int R, int K) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char *ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char *ws = ring + NSTAGE * SLOT_BYTES;               // weights, 1024-aligned
    unsigned char *arows = ws + W_BYTES;                          // each slot's rows of A
    float *bs = reinterpret_cast<float *>(arows + NSTAGE * SLOT_AROWS);
    const uint32_t full = smem_u32(bs + NBIAS), empty = full + 8 * NSTAGE;

    for (int idx = threadIdx.x; idx < W_BYTES / 16; idx += THREADS) reinterpret_cast<uint4 *>(ws)[idx] = Wp[idx];
    for (int idx = threadIdx.x; idx < NBIAS; idx += THREADS) bs[idx] = bias[idx];
    if (threadIdx.x == 0) {
        for (int s = 0; s < NSTAGE; ++s) {
            mbar_init(full + 8 * s, 1);                 // the producer's expect_tx
            mbar_init(empty + 8 * s, 128 * CONSUMERS);  // every consumer thread's arrival
        }
        fence_mbar_init();
    }
    fence_proxy_async();  // the weights are read by wgmma (the async proxy)
    __syncthreads();

    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int KB = (R + TK - 1) / TK;
    // tile blocks: under 2^31 (the launcher checks)
    const int nblocks = (R + CONSUMERS - 1) / CONSUMERS * ((R + TJ - 1) / TJ) * KB;
    if (wg == CONSUMERS) {
        setmaxnreg_dec<PRODUCER_REGS>();
        if (tid == 0) produce(ring, arows, full, empty, &tmb, &tmc, A, nblocks, R, KB);
        return;
    }
    setmaxnreg_inc<CONSUMER_REGS>();

    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = (lane & 3) * 2;
    const uint32_t sw = smem_u32(ws);
    const uint64_t dw0 = desc_sw128(sw), dw1 = desc_sw128(sw + W_LAYER_BYTES);
    const uint64_t dout0 = desc_sw128(sw + HEADS * W_LAYER_BYTES);
    const uint64_t dout1 = desc_sw128(sw + HEADS * W_LAYER_BYTES + OUT_TILE_BYTES);
    const float *bout = bs + HEADS * HW;

    for (int u = 0, q = blockIdx.x; q < nblocks; ++u, q += gridDim.x) {
        const int s = u % NSTAGE;
        const Block b = block_of(q, R, KB);
        const int i = b.i0 + wg;
        const Tile ta = {i, b.j0, b.k0, i < R}, tb = {i, b.j0 + 1, b.k0, i < R && b.j0 + 1 < R};
        const uint32_t slot = smem_u32(ring + s * SLOT_BYTES);
        const __nv_bfloat16 *arow = reinterpret_cast<const __nv_bfloat16 *>(arows + s * SLOT_AROWS) +
                                    wg * TJ * (HEADS * HW);
        // chain (tile x, head h): first layer into f, hidden product into d ...
        // (d starts at the head's halved hidden bias)
        auto hidden = [&](uint32_t (&f)[4][4], float (&d)[32], int x, int h) {
            first_layer(f, arow + x * (HEADS * HW) + h * HW, slot + (wg * HEADS + h) * BOX_BYTES,
                        slot + C_OFF + (x * HEADS + h) * BOX_BYTES, warp, lane, c);
            bias_rows(d, bs + h * HW, c);
            issue_k64(d, f, h ? dw1 : dw0, true);
        };
        // ... then SiLU into f, the output product added onto o
        auto output = [&](float (&o)[4], uint32_t (&f)[4][4], float (&d)[32], int h) {
            fence_regs(d);
            silu_epilogue(f, d);
            issue_k64(o, f, h ? dout1 : dout0, true);
        };
        mbar_wait(full + 8 * s, (uint32_t)((u / NSTAGE) & 1));

        uint32_t fa0[4][4], fb0[4][4], fa1[4][4], fb1[4][4];
        float d0[32], d1[32], oa[4], ob[4];
        // the tiles' results start at the output bias
        bias_rows(oa, bout, c);
        bias_rows(ob, bout, c);
        // in flight after each step, oldest first
        hidden(fa0, d0, 0, 0);   // Ha0
        hidden(fb0, d1, 1, 0);   // Ha0 Hb0
        wgmma_wait<1>();
        output(oa, fa0, d0, 0);  // Hb0 Oa0
        hidden(fa1, d0, 0, 1);   // Hb0 Oa0 Ha1
        wgmma_wait<2>();
        output(ob, fb0, d1, 0);  // Oa0 Ha1 Ob0
        hidden(fb1, d1, 1, 1);   // Oa0 Ha1 Ob0 Hb1
        // this consumer's first layers have read the slot: hand it back
        mbar_arrive(empty + 8 * s);
        wgmma_wait<2>();
        output(oa, fa1, d0, 1);  // Ob0 Hb1 Oa1
        wgmma_wait<1>();
        output(ob, fb1, d1, 1);  // Oa1 Ob1
        wgmma_wait<1>();
        fence_regs(oa);
        store_tile(out, ta, oa, K, R, warp, g, c);
        wgmma_wait<0>();
        fence_regs(ob);
        store_tile(out, tb, ob, K, R, warp, g, c);
    }
}

}  // namespace

// Dynamic shared memory of one block: the ring, the weights, the slots'
// rows of A, the biases and 2 NSTAGE mbarriers, 1024-aligned.
static size_t multihead_smem_bytes() {
    return 1024 + (size_t)NSTAGE * SLOT_BYTES + W_BYTES + (size_t)NSTAGE * SLOT_AROWS + (size_t)NBIAS * 4 +
           16 * NSTAGE;
}

extern "C" int grid_multihead_fwd(const void *A, const void *B, const void *C, const void *Wp,
                                  const void *bias, void *out, int R, int K, int num_sms, void *stream) {
    const long long nblocks =
        (long long)((R + CONSUMERS - 1) / CONSUMERS) * ((R + TJ - 1) / TJ) * ((R + TK - 1) / TK);
    if (K < 1 || K > MAX_OUT || R < 1 || nblocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
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
    static bool smem_set[MAX_DEVICES] = {};  // once per device
    if (int e = allow_smem(grid_multihead_bf16, (int)smem, smem_set)) return e;
    // persistent: at most one block per SM, each taking tile blocks in turn
    const int grid = (int)std::min<long long>(num_sms, nblocks);
    grid_multihead_bf16<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        tmb, tmc, static_cast<const __nv_bfloat16 *>(A), static_cast<const uint4 *>(Wp),
        static_cast<const float *>(bias), static_cast<float *>(out), R, K);
    return (int)cudaGetLastError();
}
