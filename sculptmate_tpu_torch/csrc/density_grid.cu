// K2: fused triplane density MLP over the R^3 marching-cubes lattice, or
// over an (RX, R, R) x-slab of it (the sharded extraction's, RX = slab + 1).
//
// Replaces: sculptmate_tpu/ops/density_grid.py:query_density_grid, the
// z-slab lax.map program that runs the NeRF decoder's hidden layers over
// every lattice point on the TPU.
//
// Per lattice point (i, j, k) it forms h1 = silu(A[i,j] + B[k,i] + C[k,j])
// from the three factorized first-layer partial sums (small matmuls done in
// torch; A already holds the first-layer bias), runs the L hidden 64x64 SiLU
// layers, keeps output channel 0 of the 64->4 output layer, and writes
// exp(d + density_bias) as f32 in [x, y, z] order. A is (RX, R, 64), B
// (R, RX, 64), C (R, R, 64); RX is a loop bound and B's row stride, and a
// point's arithmetic does not depend on where it sits in the slab, so a
// lattice row gives the same bits in either of the two slabs that hold it.
//
// Bound on the H100: operations. At R = 256 the lattice is 16.8 M points x
// ~66 K tensor-core flops each (1.1 TFLOP, 1.11 ms at 989 TFLOP/s) against a
// 67 MB f32 output; but it also needs 9.7 G SiLUs, and those run on the
// SFU and FP32 pipes, not on the tensor cores.
//
// Design: a tile is 64 consecutive k at fixed (i, j): the 64 M rows of
// wgmma m64n64k16 for one warpgroup, one broadcast row of A, and one 256-byte
// output run. Three warpgroups per persistent block each walk their own
// pairs of tiles:
// - the tiles' B[k0.., i] and C[k0.., j] rows arrive by TMA (3-D tensor maps
//   over the (R_k, R_i|j, 64) partials, 128-byte swizzle, rows past R load
//   as zeros) into the warpgroup's buffer; once the first layer has read
//   them, the next pair's rows load while this pair's hidden layers run;
// - the hidden weights (pre-swizzled on the host, all L layers, 8 KB each)
//   and output channel 0 sit in shared memory for the whole block as the B
//   operand of every product; the activations are the register A operand:
//   a layer's f32 accumulators, plus bias and SiLU, pack in place into the
//   next layer's bf16 A fragments (see hopper.cuh) and never leave registers;
// - each warpgroup keeps its two tiles in flight: while wgmma runs a layer of
//   one tile, the warpgroup computes the SiLU of the other, so the tensor
//   cores and the SFU/FP32 pipes overlap instead of taking turns;
// - SiLU is silu(x) = h (1 + tanh h), h = x / 2, on bf16 pairs: one
//   tanh.approx.bf16x2 and one fma.rn.bf16x2 for two values (hopper.cuh's
//   silu_of_half). The host halves the hidden weights and biases, so each
//   product yields h directly;
// - output channel 0 is one more wgmma (m64n8k16, channel 0 in column 0).
// The layer count is a compile-time constant: the layer loop unrolls, and
// no branch around a wgmma makes ptxas serialize them.

#include <math.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace sm_port;

constexpr int HW = 64;       // hidden width (the wrapper rejects any other)
constexpr int TK = 64;       // lattice points (consecutive k) per tile
constexpr int WGS = 3;       // warpgroups per block
constexpr int L = 8;         // hidden 64x64 layers (TripoSR's decoder; the wrapper rejects others)
constexpr int ROW_BYTES = HW * 2;
constexpr int W_LAYER_BYTES = HW * ROW_BYTES;        // one hidden layer, 8 KB
constexpr int TILE_BYTES = 2 * TK * ROW_BYTES;       // a tile's B and C rows
constexpr int BUF_BYTES = 2 * TILE_BYTES;            // a pair of tiles: one buffer per warpgroup

struct Tile {
    int i, j, k0;
    bool valid;
};

// tiles (i, j, k-run) over RX x R x ceil(R / 64), i outermost
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

// h1 of one tile for this thread's rows (16w + g, +8) in A-fragment order:
// a[kc][0|1] = rows g|g+8, channels 16kc + c..; a[kc][2|3] the same at +8
__device__ __forceinline__ void first_layer(uint32_t (&a)[4][4], const __nv_bfloat16 *__restrict__ A,
                                            const Tile &tl, int R, const unsigned char *rows,
                                            int warp, int g, int c) {
    const __nv_bfloat16 *arow = A + ((size_t)tl.i * R + tl.j) * HW;
    const unsigned char *bs = rows, *cs = rows + TK * ROW_BYTES;
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

// channel 0 sits in column 0: lanes with c = 0 hold rows g (d[0]) and g + 8 (d[2])
__device__ __forceinline__ void store_tile(float *__restrict__ out, const Tile &tl, const float (&d)[4],
                                           float bout, float density_bias, int R, int warp, int g,
                                           int c) {
    if (!tl.valid || c != 0) return;
    float *orow = out + ((size_t)tl.i * R + tl.j) * R;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int k = tl.k0 + warp * 16 + g + 8 * rr;
        // the decoder's output is bf16 before the f32 density activation,
        // as in the plain version
        if (k < R) orow[k] = expf(bf16_round(d[2 * rr] + bout) + density_bias);
    }
}

__global__ void __launch_bounds__(WGS * 128, 1)
density_mlp_bf16(const __grid_constant__ CUtensorMap tmb, const __grid_constant__ CUtensorMap tmc,
                 const __nv_bfloat16 *__restrict__ A,
                 const uint4 *__restrict__ Wp,     // (L*64 + 8) swizzled rows of 64 bf16
                 const float *__restrict__ bias,   // (L*64 + 1): halved b_l, then b_out[0]
                 float density_bias, float *__restrict__ out, int R, int RX) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char *base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char *bufs = base;                                  // WGS pair buffers
    unsigned char *ws = bufs + WGS * BUF_BYTES;                  // weights, 1024-aligned
    float *bs = reinterpret_cast<float *>(ws + L * W_LAYER_BYTES + 8 * ROW_BYTES);
    const uint32_t bars = smem_u32(bs + ((L * HW + 1 + 3) & ~3));  // WGS mbarriers
    const uint32_t sw = smem_u32(ws);

    for (int idx = threadIdx.x; idx < (L * HW + 8) * (ROW_BYTES / 16); idx += blockDim.x)
        reinterpret_cast<uint4 *>(ws)[idx] = Wp[idx];
    for (int idx = threadIdx.x; idx <= L * HW; idx += blockDim.x) bs[idx] = bias[idx];
    if (threadIdx.x == 0) {
        for (int b = 0; b < WGS; ++b) mbar_init(bars + 8 * b, 1);
        fence_mbar_init();
    }
    fence_proxy_async();  // the weights are read by wgmma (the async proxy)
    __syncthreads();

    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = (lane & 3) * 2;
    const int KB = (R + TK - 1) / TK;
    const long long ntiles = (long long)RX * R * KB, npairs = (ntiles + 1) / 2;
    const long long G = (long long)gridDim.x * WGS;
    const float bout = bs[L * HW];
    auto layer_desc = [&](int l) { return desc_sw128(sw + l * W_LAYER_BYTES); };
    const uint64_t dout = desc_sw128(sw + L * W_LAYER_BYTES);
    unsigned char *buf = bufs + wg * BUF_BYTES;
    const uint32_t bar = bars + 8 * wg;
    const CUtensorMap *mb = &tmb, *mc = &tmc;
    // one thread loads a pair's B and C rows into the warpgroup's buffer
    auto issue_loads = [&](long long q) {
        mbar_expect_tx(bar, BUF_BYTES);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const Tile tl = tile_of(2 * q + e, ntiles, R, KB);
            const uint32_t dst = smem_u32(buf + e * TILE_BYTES);
            tma_load_3d(dst, mb, bar, 0, tl.i, tl.k0);
            tma_load_3d(dst + TK * ROW_BYTES, mc, bar, 0, tl.j, tl.k0);
        }
    };

    long long q = blockIdx.x * WGS + wg;
    if (tid == 0 && q < npairs) issue_loads(q);
    for (int n = 0; q < npairs; ++n, q += G) {
        mbar_wait(bar, n & 1);
        const Tile t0 = tile_of(2 * q, ntiles, R, KB), t1 = tile_of(2 * q + 1, ntiles, R, KB);

        uint32_t a0[4][4], a1[4][4];
        float d0[32], d1[32], o0[4], o1[4];
#pragma unroll
        for (int i = 0; i < 32; ++i) d0[i] = d1[i] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) o0[i] = o1[i] = 0.f;
        first_layer(a0, A, t0, R, buf, warp, g, c);
        issue_k64(d0, a0, layer_desc(0));
        first_layer(a1, A, t1, R, buf + TILE_BYTES, warp, g, c);
        issue_k64(d1, a1, layer_desc(0));
        // the buffer is read: the next pair's rows load while this pair's
        // hidden layers run
        named_bar_sync(1 + wg, 128);
        if (tid == 0 && q + G < npairs) issue_loads(q + G);
#pragma unroll
        for (int l = 0; l < L; ++l) {  // unrolled: no branch around a wgmma
            const float *bl = bs + l * HW;
            wgmma_wait<1>();  // tile 0's layer l is done; tile 1's still runs
            fence_regs(d0);
            hidden_epilogue(a0, d0, bl, c);
            if (l + 1 < L) issue_k64(d0, a0, layer_desc(l + 1));
            else issue_k64(o0, a0, dout);
            wgmma_wait<1>();
            fence_regs(d1);
            hidden_epilogue(a1, d1, bl, c);
            if (l + 1 < L) issue_k64(d1, a1, layer_desc(l + 1));
            else issue_k64(o1, a1, dout);
        }
        wgmma_wait<1>();
        fence_regs(o0);
        store_tile(out, t0, o0, bout, density_bias, R, warp, g, c);
        wgmma_wait<0>();
        fence_regs(o1);
        store_tile(out, t1, o1, bout, density_bias, R, warp, g, c);
    }
}

}  // namespace

// Dynamic shared memory of one block.
static size_t density_smem_bytes() {
    return 1024 + (size_t)WGS * BUF_BYTES + (size_t)L * W_LAYER_BYTES + 8 * ROW_BYTES +
           (size_t)((L * HW + 1 + 3) & ~3) * 4 + 8 * WGS;
}

extern "C" int density_mlp_fwd(const void *A, const void *B, const void *C, const void *Wp,
                               const void *bias, float density_bias, void *out, int R, int RX, int layers,
                               int num_sms, void *stream) {
    if (layers != L || RX < 1 || R < 1) return (int)cudaErrorInvalidValue;
    // B (R_k, RX, 64) and C (R_k, R_j, 64) as (channel, i|j, k): a box is
    // the 64 rows k0.. at one i (or j)
    CUtensorMap tmb, tmc;
    const cuuint64_t dimb[3] = {HW, (cuuint64_t)RX, (cuuint64_t)R}, dimc[3] = {HW, (cuuint64_t)R, (cuuint64_t)R};
    const cuuint64_t rowb = ROW_BYTES, planeb = (cuuint64_t)R * ROW_BYTES;
    const cuuint64_t sb[2] = {rowb, (cuuint64_t)RX * ROW_BYTES}, sc[2] = {rowb, planeb};
    const cuuint32_t box[3] = {HW, 1, TK};
    int err = encode_bf16_map(&tmb, B, 3, dimb, sb, box);
    if (!err) err = encode_bf16_map(&tmc, C, 3, dimc, sc, box);
    if (err) return err;
    const size_t smem = density_smem_bytes();
    static bool smem_set[MAX_DEVICES] = {};  // once per device
    if (int e = allow_smem(density_mlp_bf16, (int)smem, smem_set)) return e;
    // persistent: at most one block per SM, each warpgroup taking pairs of tiles
    const long long npairs = ((long long)RX * R * ((R + TK - 1) / TK) + 1) / 2;
    const int grid = (int)std::min<long long>(num_sms, (npairs + WGS - 1) / WGS);
    density_mlp_bf16<<<grid, WGS * 128, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
        tmb, tmc, static_cast<const __nv_bfloat16 *>(A), static_cast<const uint4 *>(Wp),
        static_cast<const float *>(bias), density_bias, static_cast<float *>(out), R, RX);
    return (int)cudaGetLastError();
}

