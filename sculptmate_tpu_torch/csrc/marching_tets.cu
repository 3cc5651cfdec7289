// K7: the marching-tets wire on the card, a count, a scan and an emit.
//
// Replaces sculptmate_tpu/geometry/marching_tets.py:mt_wire_device (l.388,
// with _mt_vertex_side_wire and _mt_positions): the SF3D extraction's wire.
// The (res + 1)^3 lattice (N points per axis, x-major) is read as padded to
// Np = 8 ceil(N / 8) points per axis, the padding outside (sdf -1). Output,
// one uint8 buffer (zeroed by the caller):
//   [occupancy bits Np^3/8][px lo][px hi][py lo][py hi][pz lo][pz hi  mv each]
//   [num_verts, n_vblocks  little-endian u32]
// The Freudenthal lattice's tet edges fall into seven classes anchored at a
// lattice point (mt_tables.EDGE_DIRS: x, y, z, xy, xz, yz, xyz). Edge (c, p)
// is cut where sdf > 0 differs at p and p + d_c, both inside the real N^3
// lattice. Vertex ids are block-major: (class, 8^3 block, in-block x/y/z),
// each the exclusive prefix of the per-block counts plus the in-block rank.
// A vertex lies at t = clamp(s0 / (s0 - s1, or 1 where that is 0), 0, 1)
// (snapped to 0 or 1 within snap_eps) between its two endpoints, each moved
// by tanh(offset) / res, and is quantised to u16 over [-1/res, 1 + 1/res]
// per axis. Ids at or past the capacity mv are dropped; the counters stay
// exact, so the caller sees an overflow and retries.
//
// Bound on the H100: bytes. At R = 160 (N = 161) it reads the sdf and three
// offsets (4 x 161^3 x 4 B = 66.8 MB) and writes 0.59 MB of bits and 6 B
// per vertex: ~0.02 ms at 3.35 TB/s. The TPU program's block capacity,
// one-hot contraction and k = 32 row compaction were workarounds for fixed
// compaction buffers; here ids come from exact prefixes and only ids under
// the capacity are written.
//
// Design (K3's, in marching_cubes.cu, with seven edge classes for three
// axes), three launches:
// (1) count: one block per column of 8 x 8 (x, y) rows walking its 8^3
//     blocks along z. A block's 9^3 points (the block and the +1 halo that
//     the seven steps reach) are loaded one 8^3 block ahead into registers,
//     then kept in shared memory as one state byte each (past the real
//     lattice, inside with sdf <= 0, inside with sdf > 0), so each sdf value
//     is read from device memory once per block it borders, not once per
//     edge. Per point: its seven cut flags, and the occupancy byte of 8
//     consecutive z points from one warp ballot. Per 8^3 block: the seven
//     512-bit cut masks (each warp's ballot a 32-bit word, in in-block order
//     ox * 64 + oy * 8 + oz) and the seven per-class counts;
// (2) the multi-block scan (scan.cuh's scan_segments, decoupled look-back)
//     of the 7 NB counts in (class, block) order, whose last tile gives the
//     two wire counters (num_verts, and n_vblocks the nonzero counts);
// (3) emit, one thread per mask word: a vertex id is its block's scanned
//     base, the cut edges of the block's earlier words (a scan over the 16
//     lanes holding the block's words) and its rank within the word; the
//     sdf and the three offsets are read at each cut edge's two ends only.
// Rounding follows the plain version as PyTorch computes it on the card:
// every operation rounded on its own (no contracted multiply-adds), a
// division by a scalar as a product with its reciprocal (taken in double,
// rounded to f32), tanhf, u16 to nearest even, a NaN t kept as the clamp
// keeps it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int BS = 8;                      // block side
constexpr int CELLS = BS * BS * BS;        // threads of the count pass
constexpr int NCLS = 7;                    // edge classes
constexpr int HALO = BS + 1;               // points per axis of a block and its +1 neighbours
constexpr int HALO_PTS = HALO * HALO * HALO;
constexpr int HALO_LOADS = (HALO_PTS + CELLS - 1) / CELLS;  // halo points per thread
constexpr int MASK_WORDS = CELLS / 32;     // 32-bit words of one 8^3 block's cut mask
constexpr int EMIT_THREADS = 256;          // mask words per block of the emit pass
// bit c: class c's step along x, y and z (mt_tables.EDGE_DIRS)
constexpr unsigned STEP_X = 0b1011001u, STEP_Y = 0b1101010u, STEP_Z = 0b1110100u;
// a lattice point's state in the count pass's halo
constexpr uint8_t PAST = 0, OUTSIDE = 1, INSIDE = 2;

__device__ __forceinline__ size_t flat(int i, int j, int k, int N) { return ((size_t)i * N + j) * N + k; }

// the halo point e (x-major over 9^3) of the 8^3 block at (bi, bj, bk)
__device__ __forceinline__ void halo_point(int e, int bi, int bj, int bk, int &i, int &j, int &k) {
    i = bi + e / (HALO * HALO);
    j = bj + (e / HALO) % HALO;
    k = bk + e % HALO;
}

// one block per column of 8 x 8 (x, y) rows, walking its 8^3 blocks along
// z: each point's occupancy bit, each block's seven cut masks (masks[(c NB
// + blk) 16 + w] bit l: the class-c edge from in-block point 32 w + l is
// cut) and its per-class counts (vcnt[c NB + blk])
__global__ void __launch_bounds__(CELLS) mt_count(const float *__restrict__ sdf, uint8_t *__restrict__ occ,
                                                   unsigned *__restrict__ masks, int *__restrict__ vcnt, int N,
                                                   int Np) {
    __shared__ uint8_t state[2][HALO_PTS];          // by the parity of bz
    __shared__ int warp_cnt[2][NCLS][MASK_WORDS];   // by the parity of bz
    const int nb = Np / BS, NB = nb * nb * nb;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int ox = t >> 6, oy = (t >> 3) & 7, oz = t & 7;
    const int bi = (blockIdx.x / nb) * BS, bj = (blockIdx.x % nb) * BS;
    const int i = bi + ox, j = bj + oy;
    // the sdf at this thread's halo points of 8^3 block bz (points past the
    // lattice are not read); loaded one 8^3 block ahead
    auto load = [&](int bz, float (&v)[HALO_LOADS]) {
#pragma unroll
        for (int r = 0; r < HALO_LOADS; ++r) {
            const int e = t + r * CELLS;
            int hi, hj, hk;
            halo_point(e, bi, bj, bz * BS, hi, hj, hk);
            v[r] = e < HALO_PTS && hi < N && hj < N && hk < N ? sdf[flat(hi, hj, hk, N)] : 0.f;
        }
    };
    float next[HALO_LOADS];
    load(0, next);
    for (int bz = 0; bz < nb; ++bz) {
        uint8_t *st = state[bz & 1];
#pragma unroll
        for (int r = 0; r < HALO_LOADS; ++r) {
            const int e = t + r * CELLS;
            int hi, hj, hk;
            halo_point(e, bi, bj, bz * BS, hi, hj, hk);
            if (e < HALO_PTS) st[e] = hi < N && hj < N && hk < N ? (next[r] > 0.f ? INSIDE : OUTSIDE) : PAST;
        }
        // one barrier per 8^3 block: the states and counts of the next
        // block go to the other halves
        __syncthreads();
        if (bz > 0 && t < NCLS) {
            int n = 0;
#pragma unroll
            for (int w = 0; w < MASK_WORDS; ++w) n += warp_cnt[(bz - 1) & 1][t][w];
            vcnt[t * NB + blockIdx.x * nb + bz - 1] = n;
        }
        if (bz + 1 < nb) load(bz + 1, next);
        const int blk = blockIdx.x * nb + bz, k = bz * BS + oz;
        // a class-c edge is cut where both ends lie in the real lattice (the
        // domain mask; padding points anchor and end no edge) and their
        // occupancy differs
        const uint8_t s0 = st[(ox * HALO + oy) * HALO + oz];
        unsigned f = 0;
#pragma unroll
        for (int c = 0; c < NCLS; ++c) {
            const int dx = (STEP_X >> c) & 1, dy = (STEP_Y >> c) & 1, dz = (STEP_Z >> c) & 1;
            const uint8_t s1 = st[((ox + dx) * HALO + oy + dy) * HALO + oz + dz];
            if (s0 != PAST && s1 != PAST && s1 != s0) f |= 1u << c;
        }
        // the 8 points (i, j, k0 .. k0 + 7) are lanes 8m .. 8m + 7 of one
        // warp: their byte, bit b = point k0 + b
        const unsigned inb = __ballot_sync(FULL, s0 == INSIDE);
        if ((t & 7) == 0) occ[flat(i, j, k, Np) >> 3] = (uint8_t)((inb >> (lane & 24)) & 0xFF);
        unsigned mine = 0u;  // lane c keeps class c's word
#pragma unroll
        for (int c = 0; c < NCLS; ++c) {
            const unsigned b = __ballot_sync(FULL, (f >> c) & 1u);
            if (lane == c) mine = b;
        }
        if (lane < NCLS) {
            masks[((size_t)lane * NB + blk) * MASK_WORDS + warp] = mine;
            warp_cnt[bz & 1][lane][warp] = __popc(mine);
        }
    }
    __syncthreads();
    if (t < NCLS) {
        int n = 0;
#pragma unroll
        for (int w = 0; w < MASK_WORDS; ++w) n += warp_cnt[(nb - 1) & 1][t][w];
        vcnt[t * NB + blockIdx.x * nb + nb - 1] = n;
    }
}

// one end of an edge, deformed: i / res + tanh(offset) / res along one axis
__device__ __forceinline__ float deformed(int idx, const float *__restrict__ off, size_t p, float inv_res) {
    return __fadd_rn(__fmul_rn((float)idx, inv_res), __fmul_rn(tanhf(off[p]), inv_res));
}

struct WireScalars {
    float inv_res, lo, inv_span, eps_lo, eps_hi;  // 1/res, -1/res, 1/(1 + 2/res), eps, 1 - eps
};

// one thread per mask word (the 16 words of a (class, block) on 16
// consecutive lanes): the u16 positions of its cut edges with ids under the
// capacity; thread 0 writes the two counters the scan gave
__global__ void __launch_bounds__(EMIT_THREADS) mt_emit(const float *__restrict__ sdf, const float *__restrict__ offx,
                                                         const float *__restrict__ offy, const float *__restrict__ offz,
                                                         const unsigned *__restrict__ masks,
                                                         const int *__restrict__ vbase,
                                                         const int *__restrict__ counters, uint8_t *__restrict__ pos,
                                                         uint8_t *__restrict__ le, int N, int Np, int mv,
                                                         WireScalars w) {
    const int nb = Np / BS, NB = nb * nb * nb;
    const long long gw = (long long)blockIdx.x * EMIT_THREADS + threadIdx.x;
    const unsigned word = gw < (long long)NCLS * NB * MASK_WORDS ? masks[gw] : 0u;
    // the cut edges of the block's words up to this one
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < MASK_WORDS; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o, MASK_WORDS);
        if ((int)(threadIdx.x % MASK_WORDS) >= o) incl += y;
    }
    if (gw == 0) {
        for (int b = 0; b < 4; ++b) {
            le[b] = (uint8_t)(((unsigned)counters[0] >> (8 * b)) & 0xFF);
            le[4 + b] = (uint8_t)(((unsigned)counters[1] >> (8 * b)) & 0xFF);
        }
    }
    if (word == 0u) return;
    const int cb = (int)(gw / MASK_WORDS), wi = (int)(gw % MASK_WORDS), c = cb / NB, blk = cb % NB;
    const int bi = (blk / (nb * nb)) * BS, bj = ((blk / nb) % nb) * BS, bk = (blk % nb) * BS;
    const int dx = (STEP_X >> c) & 1, dy = (STEP_Y >> c) & 1, dz = (STEP_Z >> c) & 1;
    const float *offs[3] = {offx, offy, offz};
    int id = vbase[cb] + incl - cnt;
    for (unsigned b = word; b != 0u && id < mv; b &= b - 1u, ++id) {  // past the capacity: dropped
        const int q = wi * 32 + __ffs(b) - 1;  // in-block ox * 64 + oy * 8 + oz
        const int idx0[3] = {bi + (q >> 6), bj + ((q >> 3) & 7), bk + (q & 7)};
        const int idx1[3] = {idx0[0] + dx, idx0[1] + dy, idx0[2] + dz};
        // both ends lie in the real lattice (the count pass's domain mask)
        const size_t p0 = flat(idx0[0], idx0[1], idx0[2], N), p1 = flat(idx1[0], idx1[1], idx1[2], N);
        const float s0 = sdf[p0], d = __fsub_rn(s0, sdf[p1]);
        float t = __fdiv_rn(s0, d == 0.f ? 1.f : d);
        if (!isnan(t)) t = fminf(fmaxf(t, 0.f), 1.f);
        t = t < w.eps_lo ? 0.f : (t > w.eps_hi ? 1.f : t);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float c0 = deformed(idx0[a], offs[a], p0, w.inv_res), c1 = deformed(idx1[a], offs[a], p1, w.inv_res);
            const float v = __fadd_rn(c0, __fmul_rn(t, __fsub_rn(c1, c0)));
            const float u = rintf(__fmul_rn(__fmul_rn(__fsub_rn(v, w.lo), w.inv_span), 65535.f));
            const int qv = (int)fminf(fmaxf(u, 0.f), 65535.f);
            pos[(size_t)(2 * a) * mv + id] = (uint8_t)(qv & 0xFF);
            pos[(size_t)(2 * a + 1) * mv + id] = (uint8_t)(qv >> 8);
        }
    }
}

}  // namespace

// K7: sdf and the three raw offsets, each (N, N, N) f32 x-major -> the wire
// (zeroed by the caller: Np^3/8 + 6 mv + 8 bytes, Np = 8 ceil(N / 8)).
// Scratch, NB = (Np / 8)^3: masks 112 NB u32, vcnt and vbase 7 NB ints;
// zeroed (zeroed by the caller): the 2 counters, the scan's tile counter,
// 1 pad int, then status_tiles u64 status words. The scalars are f32 as
// the plain version rounds them: 1/res, -1/res, 1/(1 + 2/res), snap_eps
// and 1 - snap_eps, each computed in double and rounded to f32. Three
// launches: count, the scan of the 7 NB counts (which gives the counters),
// emit.
extern "C" int mt_wire_fwd(const void *sdf, const void *off_x, const void *off_y, const void *off_z, void *wire,
                           void *masks, void *vcnt, void *vbase, void *zeroed, int N, int mv, int status_tiles,
                           float inv_res, float lo, float inv_span, float eps_lo, float eps_hi, void *stream) {
    if (N < 1 || mv < 1 || (long long)N * N * N >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int Np = (N + BS - 1) / BS * BS, nb = Np / BS, NB = nb * nb * nb;
    const size_t occ_bytes = (size_t)Np * Np * Np / 8;
    const float *s = static_cast<const float *>(sdf);
    uint8_t *wb = static_cast<uint8_t *>(wire);
    unsigned *mk = static_cast<unsigned *>(masks);
    int *cnt = static_cast<int *>(vcnt), *base = static_cast<int *>(vbase), *counters = static_cast<int *>(zeroed);
    ScanSegs sg = {};
    sg.in[0] = cnt;
    sg.base[0] = base;
    sg.n[0] = NCLS * NB;
    sg.total[0] = counters;        // num_verts
    sg.nonzero[0] = counters + 1;  // n_vblocks
    sg.first_tile[1] = scan_tiles(NCLS * NB);
    sg.nsegs = 1;
    if (sg.first_tile[1] > status_tiles) return (int)cudaErrorInvalidValue;
    const long long nwords = (long long)NCLS * NB * MASK_WORDS;
    const WireScalars w{inv_res, lo, inv_span, eps_lo, eps_hi};
    mt_count<<<nb * nb, CELLS, 0, st>>>(s, wb, mk, cnt, N, Np);
    scan_segments<<<sg.first_tile[1], MS_THREADS, 0, st>>>(sg, reinterpret_cast<unsigned long long *>(counters + 4),
                                                            counters + 2);
    mt_emit<<<(int)((nwords + EMIT_THREADS - 1) / EMIT_THREADS), EMIT_THREADS, 0, st>>>(
        s, static_cast<const float *>(off_x), static_cast<const float *>(off_y), static_cast<const float *>(off_z), mk,
        base, counters, wb + occ_bytes, wb + occ_bytes + 6 * (size_t)mv, N, Np, mv, w);
    return (int)cudaGetLastError();
}
