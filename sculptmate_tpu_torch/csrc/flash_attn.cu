// K1: flash-attention forward, softmax(Q K^T / sqrt(D)) V with O(N) memory.
//
// Replaces: sculptmate_tpu/ops/attention.py:_flash_attention, the Pallas TPU
// flash-attention kernel (jax.experimental.pallas.ops.tpu.flash_attention)
// that every backbone attn1 (3072 x 3072), attn2 (3072 x 1025) and ViT
// self-attention (1025 x 1025) takes.
//
// Bound on the H100: operations. At the backbone's shapes one call does
// 4 * Nq * Nk * D * H flops on 2 * (Nq + 2 Nk) * H * D bytes of bf16 input,
// ~1000 flops per byte, far right of the ~295 flop/byte ridge; so the
// tensor cores must be fed by wgmma from shared memory, and no load may
// stall them.
//
// Design (bf16): one block per (batch x head, 128-query tile) with three
// warpgroups. Warpgroup 2 is the producer: it gives up its registers
// (setmaxnreg) and one of its threads loads the Q tile once and streams
// 128-key (at D = 88, 96-key) K and V tiles by TMA into a ring of STAGES shared-memory stages,
// guarded by full/empty mbarriers. Warpgroups 0 and 1 each own 64 query
// rows: S = Q K^T is wgmma m64n128k16 with both operands in shared memory
// (K-major, the 128-byte swizzle TMA writes), the online softmax runs on
// the f32 accumulators in registers (exp2 domain), and O += P V is wgmma
// m64n64k16 with P re-packed in place from S's accumulators as the register
// A operand and V read as the MN-major B operand, so V needs no transpose.
// The tensor maps are 4-D over (D, H, N, B): a box never crosses a batch,
// rows past N load as zeros, and the last key tile masks its ragged scores
// to -inf; stores skip query rows past Nq. No padding, no segment ids.
//
// At D = 64 the exponentials cost the SFU about as long as the products
// cost the tensor cores, so the two must overlap. Within a warpgroup, tile
// j + 1's Q K^T and tile j's P V are issued together and tile j + 1's
// softmax runs while P V does (FA3's intra-warpgroup pipelining); across
// warpgroups, the two take turns to issue (ping-pong on named barriers), so
// one's softmax runs while the other's products hold the tensor cores.
// Two larger shapes were tried and ran slower: a third consumer warpgroup
// (192 query rows; 160 registers a thread) and 192-key tiles (S takes 96
// registers) both spill, and ptxas then serializes the wgmma. Exponentials
// on bf16 pairs (P is bf16 anyway) halve the SFU work but doubled the error
// and, through the moves into P's registers, serialized the wgmma too.
//
// Head dims 64 and 88 (SF3D's unused SingleStreamTransformer, 16 heads x
// 88), each its own instantiation. A 128-byte-swizzle TMA box is at most 64
// bf16 wide, so a D = 88 row is two boxes, columns 0-63 and 64-127, and the
// tensor map's extent (D) makes TMA fill columns 88-127 with zeros. Q K^T
// then runs 6 k16 steps (columns 0-95; the zeros add nothing) and P V one
// m64n96k16 whose MN-major V spans both boxes (LBO = one box); the store
// drops output columns 88-95, and the scale is 1/sqrt(D), not of the padded
// width. O takes 48 accumulators a thread there (32 at D = 64); with S's 64
// and P's 32 of a 128-key tile the consumers spilled under ptxas's 168
// registers a thread (384 threads a block), so D = 88 streams 96-key tiles
// (S 48, P 24). Q and the 3-stage K/V ring take 177 KB of shared memory at
// D = 88 (113 KB at 64).
//
// float32 inputs take a plain FMA kernel (one thread per query row) with its
// own 64-key tiles; it exists so the card can check the masking and softmax
// in full precision, and is not on the main path.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace sm_port;

constexpr int BQ = 128;     // query rows per block: 2 consumer warpgroups x 64
constexpr int STAGES = 3;   // K/V ring depth: tile j + 2 loads while j and j + 1 compute
constexpr int BOX_COLS = 64;  // bf16 columns of one 128-byte-swizzle TMA box
constexpr int ROW_BYTES = BOX_COLS * 2;  // one row of a box

// The tiles of head dim D (64 or 88; the wrapper rejects any other)
template <int D>
struct Tiles {
    // keys per ring stage (wgmma N: a multiple of 16, <= 256): at D = 88, O's
    // 48 accumulators leave no room for S's 64 and P's 32 of 128 keys
    static constexpr int BKV = D == 64 ? 128 : 96;
    static constexpr int NBOX = (D + BOX_COLS - 1) / BOX_COLS;  // boxes per row
    static constexpr int DP = (D + 15) / 16 * 16;  // columns the products run over
    static constexpr int KSTEPS = DP / 16;         // k16 steps of Q K^T
    static constexpr int NACC = DP / 2;            // O accumulators a thread
    static constexpr int Q_BOX = BQ * ROW_BYTES, KV_BOX = BKV * ROW_BYTES;  // one box of a tile
    static constexpr int Q_BYTES = NBOX * Q_BOX;
    static constexpr int TILE_BYTES = NBOX * KV_BOX;  // one K or V stage (a multiple of 1024)
    static constexpr int SMEM_BYTES = Q_BYTES + 2 * STAGES * TILE_BYTES + 8 * (2 * STAGES + 1) + 1024;
    static_assert(SMEM_BYTES <= 232448, "over the 227 KB a block may use");
};

// registers a thread after setmaxnreg: the producer hands its share to the
// consumers (2 x 128 x CONSUMER_REGS + 128 x PRODUCER_REGS = 64 512, the
// block's 168 a thread)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// One tile of BKV keys' scores -> unnormalised probabilities in place (exp2
// domain).
// Masks the key columns >= Nk of a tile that starts at kt, updates the
// running raw-score maxima m and per-lane sums l of this thread's rows
// (g and g + 8), and returns in al the factors that bring what was
// accumulated under the old maxima to the new ones.
template <int BKV>
__device__ __forceinline__ void online_softmax(float (&sc)[BKV / 2], int kt, int Nk, int c, float scale_log2,
                                               float (&m)[2], float (&l)[2], float (&al)[2]) {
    constexpr int NJ = BKV / 8;  // 8-column accumulator blocks of S
    if (kt + BKV > Nk) {  // TMA loaded the keys past Nk as zeros
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn) {
            const int col = kt + 8 * jn + c;
            const bool v0 = col < Nk, v1 = col + 1 < Nk;
            if (!v0) sc[4 * jn] = sc[4 * jn + 2] = -INFINITY;
            if (!v1) sc[4 * jn + 1] = sc[4 * jn + 3] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * jn], sc[4 * jn + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every tile holds >= 1 valid key, so the new maxima are finite
        al[r] = ex2((m[r] - mx[r]) * scale_log2);
        m[r] = mx[r];
    }
    const float ms0 = mx[0] * scale_log2, ms1 = mx[1] * scale_log2;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
        sc[4 * jn] = ex2(fmaf(sc[4 * jn], scale_log2, -ms0));
        sc[4 * jn + 1] = ex2(fmaf(sc[4 * jn + 1], scale_log2, -ms0));
        sc[4 * jn + 2] = ex2(fmaf(sc[4 * jn + 2], scale_log2, -ms1));
        sc[4 * jn + 3] = ex2(fmaf(sc[4 * jn + 3], scale_log2, -ms1));
        ps[0] += sc[4 * jn] + sc[4 * jn + 1];
        ps[1] += sc[4 * jn + 2] + sc[4 * jn + 3];
    }
    // per-lane partial row sums; the quad reduction happens once at the end
    l[0] = l[0] * al[0] + ps[0];
    l[1] = l[1] * al[1] + ps[1];
}

// P as the register A operand of P V: S's accumulator blocks (2kc, 2kc+1)
// are P's A fragment of key chunk kc
template <int BKV>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BKV / 16][4], const float (&sc)[BKV / 2]) {
    constexpr int NKC = BKV / 16;  // 16-key chunks of P V
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
        pa[kc][0] = pack_bf16(sc[8 * kc], sc[8 * kc + 1]);
        pa[kc][1] = pack_bf16(sc[8 * kc + 2], sc[8 * kc + 3]);
        pa[kc][2] = pack_bf16(sc[8 * kc + 4], sc[8 * kc + 5]);
        pa[kc][3] = pack_bf16(sc[8 * kc + 6], sc[8 * kc + 7]);
    }
}

// S = Q K^T for key tile j: 64 rows x BKV keys, DP columns in steps of 16
// (+32 bytes within a box, the next box one box on)
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Tiles<D>::BKV / 2], uint64_t dq, uint32_t stage) {
    using T = Tiles<D>;
    const uint64_t dk = desc_sw128(stage);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KSTEPS; ++kk) {
        const int step = 2 * (kk % 4), box = kk / 4;
        wgmma_ss<0>(sc, dq + box * (T::Q_BOX >> 4) + step, dk + box * (T::KV_BOX >> 4) + step, kk);
    }
    wgmma_commit();
}

// O += P V: V (keys x DP) is the MN-major B operand, its 64-wide atoms one
// box apart; key chunk kc starts 16 rows (2048 bytes) on
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[Tiles<D>::NACC], const uint32_t (&pa)[Tiles<D>::BKV / 16][4],
                                         uint32_t stage) {
    using T = Tiles<D>;
    const uint64_t dv = desc_sw128(stage + T::TILE_BYTES, T::NBOX > 1 ? T::KV_BOX : 16);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < T::BKV / 16; ++kc) wgmma_rs<1>(acc, pa[kc], dv + 128 * kc, 1);
    wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, __nv_bfloat16 *__restrict__ o,
               int Nq, int Nk, int H, float scale_log2) {
    using T = Tiles<D>;
    constexpr int Q_BYTES = T::Q_BYTES, TILE_BYTES = T::TILE_BYTES, NACC = T::NACC, BKV = T::BKV;
    extern __shared__ unsigned char smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms
    const uint32_t sq = base, skv = base + Q_BYTES;  // stage s: K, then V
    const uint32_t bars = skv + 2 * STAGES * TILE_BYTES;
    auto full = [&](int s) { return bars + 8 * s; };
    auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
    const uint32_t qbar = bars + 16 * STAGES;

    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const int q0 = blockIdx.x * BQ;
    const int ntiles = (Nk + BKV - 1) / BKV;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 8);  // one arrival per consumer warp
        }
        mbar_init(qbar, 1);
        fence_mbar_init();
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 2) {  // producer
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 256) {
            mbar_expect_tx(qbar, Q_BYTES);
#pragma unroll
            for (int x = 0; x < T::NBOX; ++x) tma_load_4d(sq + x * T::Q_BOX, &tq, qbar, x * BOX_COLS, h, q0, b);
            for (int j = 0; j < ntiles; ++j) {
                const int s = j % STAGES;
                mbar_wait(empty(s), ((j / STAGES) & 1) ^ 1);
                mbar_expect_tx(full(s), 2 * TILE_BYTES);
                const uint32_t dst = skv + s * 2 * TILE_BYTES;
#pragma unroll
                for (int x = 0; x < T::NBOX; ++x) {
                    tma_load_4d(dst + x * T::KV_BOX, &tk, full(s), x * BOX_COLS, h, j * BKV, b);
                    tma_load_4d(dst + TILE_BYTES + x * T::KV_BOX, &tv, full(s), x * BOX_COLS, h, j * BKV, b);
                }
            }
        }
    } else {  // consumers: 64 query rows each
        setmaxnreg_inc<CONSUMER_REGS>();
        const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
        const int g = lane >> 2, c = (lane & 3) * 2;
        const uint64_t dq = desc_sw128(sq + wg * 64 * ROW_BYTES);  // this warpgroup's 64 rows

        float acc[NACC], sc[BKV / 2];
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];  // raw-score maxima
        uint32_t pa[BKV / 16][4];
        auto stage = [&](int j) { return skv + (j % STAGES) * 2 * TILE_BYTES; };
        auto wait_full = [&](int j) { mbar_wait(full(j % STAGES), (j / STAGES) & 1); };
        mbar_wait(qbar, 0);

        // ping-pong: the two warpgroups take turns to issue their products,
        // so one's softmax runs while the other's products hold the tensor
        // cores. Warpgroup w waits on barrier 1 + w, which the other
        // warpgroup's last issue (or, for warpgroup 0's first, warpgroup 1's
        // start) arrived at; each issue point is one turn.
        const int my_turn = 1 + wg, their_turn = 2 - wg;
        int turns = ntiles + 1;  // issue points: Q K^T of tile 0, the loop, the last P V
        auto take_turn = [&]() { named_bar_sync(my_turn, 256); };
        auto pass_turn = [&]() {
            if (--turns > 0 || wg == 0) named_bar_arrive(their_turn, 256);  // no turn left to wait for it
        };
        if (wg == 1) named_bar_arrive(their_turn, 256);

        wait_full(0);
        take_turn();
        issue_qk<D>(sc, dq, stage(0));
        pass_turn();
        wgmma_wait<0>();
        fence_regs(sc);
        online_softmax<BKV>(sc, 0, Nk, c, scale_log2, m, l, al);
        pack_p<BKV>(pa, sc);
        // FA3-style overlap: tile j + 1's Q K^T and tile j's P V run on the
        // tensor cores while this warpgroup computes tile j + 1's softmax
        for (int j = 0; j + 1 < ntiles; ++j) {
            wait_full(j + 1);
            take_turn();
            issue_qk<D>(sc, dq, stage(j + 1));
            issue_pv<D>(acc, pa, stage(j));
            pass_turn();
            wgmma_wait<1>();  // S of tile j + 1 is done; P V of tile j may run on
            fence_regs(sc);
            online_softmax<BKV>(sc, (j + 1) * BKV, Nk, c, scale_log2, m, l, al);
            wgmma_wait<0>();
            fence_regs(acc);
            if (lane == 0) mbar_arrive(empty(j % STAGES));  // this warp is done with stage j
            // rescale what was accumulated to the new running maxima
#pragma unroll
            for (int n = 0; n < NACC / 4; ++n) {
                acc[4 * n] *= al[0]; acc[4 * n + 1] *= al[0]; acc[4 * n + 2] *= al[1]; acc[4 * n + 3] *= al[1];
            }
            pack_p<BKV>(pa, sc);
        }
        take_turn();
        issue_pv<D>(acc, pa, stage(ntiles - 1));
        pass_turn();
        wgmma_wait<0>();
        fence_regs(acc);

        float l0 = l[0], l1 = l[1];
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = 1.f / l0, inv1 = 1.f / l1;
        const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
        const size_t rs = (size_t)H * D;  // row stride of (B, N, H, D)
        __nv_bfloat16 *ob = o + ((size_t)b * Nq * H + h) * D;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {  // the padded columns D .. DP - 1 are dropped
            if (r0 < Nq)
                *reinterpret_cast<uint32_t *>(ob + (size_t)r0 * rs + n * 8 + c) =
                    pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
            if (r1 < Nq)
                *reinterpret_cast<uint32_t *>(ob + (size_t)r1 * rs + n * 8 + c) =
                    pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
        }
    }
}

constexpr int BK = 64;   // f32 kernel: keys per shared-memory tile

constexpr int FQ = 128;  // f32 kernel: query rows (threads) per block

template <int D>
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

// Encodes the maps and launches the bf16 kernel of head dim D
template <int D>
int launch_bf16(const void *q, const void *k, const void *v, void *o, int B, int Nq, int Nk, int H,
                float scale_log2, cudaStream_t st) {
    using T = Tiles<D>;
    // (D, H, N, B), innermost first; boxes of 64 columns x 128 rows of one
    // head. Columns past the extent (a box's tail at D = 88) load as zeros.
    const cuuint64_t width = D;
    CUtensorMap tq, tk, tv;
    const cuuint64_t dq[4] = {width, (cuuint64_t)H, (cuuint64_t)Nq, (cuuint64_t)B};
    const cuuint64_t dk[4] = {width, (cuuint64_t)H, (cuuint64_t)Nk, (cuuint64_t)B};
    const cuuint64_t row = (cuuint64_t)H * D * 2;
    const cuuint64_t sq[3] = {D * 2, row, row * Nq}, sk[3] = {D * 2, row, row * Nk};
    const cuuint32_t qbox[4] = {BOX_COLS, 1, BQ, 1}, box[4] = {BOX_COLS, 1, T::BKV, 1};
    int err = encode_bf16_map(&tq, q, 4, dq, sq, qbox);
    if (!err) err = encode_bf16_map(&tk, k, 4, dk, sk, box);
    if (!err) err = encode_bf16_map(&tv, v, 4, dk, sk, box);
    if (err) return err;
    static bool smem_set = false;  // once per process: it costs host time per call
    if (!smem_set) {
        cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             T::SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    dim3 grid((Nq + BQ - 1) / BQ, B * H);
    flash_fwd_bf16<D><<<grid, 384, T::SMEM_BYTES, st>>>(tq, tk, tv, static_cast<__nv_bfloat16 *>(o), Nq, Nk,
                                                         H, scale_log2);
    return 0;
}

template <int D>
void launch_f32(const void *q, const void *k, const void *v, void *o, int B, int Nq, int Nk, int H,
                float scale_log2, cudaStream_t st) {
    dim3 grid((Nq + FQ - 1) / FQ, B * H);
    flash_fwd_f32<D><<<grid, FQ, 0, st>>>(static_cast<const float *>(q), static_cast<const float *>(k),
                                          static_cast<const float *>(v), static_cast<float *>(o), Nq, Nk, H,
                                          scale_log2);
}

}  // namespace

// softmax(q k^T / sqrt(D)) v on (B, N, H, D) tensors, D = 64 or 88; returns
// a cudaError_t (cudaErrorInvalidValue for another D)
extern "C" int flash_attn_fwd(const void *q, const void *k, const void *v, void *o, int B, int Nq, int Nk,
                              int H, int D, int is_bf16, void *stream) {
    // 1/sqrt(D) rounded to f32 once, then to the exp2 domain
    const float scale = (float)(1.0 / sqrt((double)D));
    const float scale_log2 = scale * 1.4426950408889634f;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    if (D != 64 && D != 88) return (int)cudaErrorInvalidValue;
    if (is_bf16) {
        const int err = D == 64 ? launch_bf16<64>(q, k, v, o, B, Nq, Nk, H, scale_log2, st)
                                : launch_bf16<88>(q, k, v, o, B, Nq, Nk, H, scale_log2, st);
        if (err) return err;
    } else if (D == 64) {
        launch_f32<64>(q, k, v, o, B, Nq, Nk, H, scale_log2, st);
    } else {
        launch_f32<88>(q, k, v, o, B, Nq, Nk, H, scale_log2, st);
    }
    return (int)cudaGetLastError();
}
