// K7: the marching-tets wire on the card, a count, a scan and an emit.
// K11 (below K7): the packed marching-tets mesh, a classify, a scan, the
// vertices, the faces and the rows past the counts.
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

#include <algorithm>

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

// -- K11: the packed mesh --
//
// Replaces sculptmate_tpu/geometry/marching_tets.py:marching_tets (l.454,
// with _mt_vertex_side and _mt_positions): vertices numbered class-major,
// then in (x, y, z) raster order over the padded lattice, in [0, 1]
// lattice units; faces block-major (8^3 blocks of cubes in (bx, by, bz)
// order, cubes in (ox, oy, oz) order within a block), then by the cube's
// six tets and their one or two triangles; five exact counters.
//
// Bound on the H100: bytes. At R = 160 it reads the sdf and three offsets
// (66.8 MB) and writes 12 B per vertex and per face: ~0.02 ms plus ~0.004
// ms per million vertices and faces at 3.35 TB/s. The TPU program's block
// and cube capacities, row gathers and 12-slot expansion were workarounds
// for fixed compaction buffers and slow gathers; here ids come from exact
// prefixes and only rows under the capacities are written.
//
// Design, five launches, each pass shaped so that the card holds several
// waves of it and no thread waits on a neighbour's larger share:
// (1) classify, split along z: one block per segment of four 8^3 blocks of
//     a column of 8 x 8 (x, y) rows (four z-blocks are one 32-bit cut word
//     along z, so each word has one writer), 2 646 blocks at R = 160. A
//     segment loads its own halo (its blocks and the +1 points: 9 x 9 rows
//     of 33 points along z) at once, a warp per row, and keeps each row as
//     two bit rows: which points lie in the real lattice and which of
//     those are inside (sdf > 0). A class's cut word of a row is then one
//     expression of two such rows (both ends real, occupancy differing),
//     and a cube's byte (bit c: corner (c & 1, c >> 1 & 1, c >> 2 & 1)
//     inside; 0 for a cube whose far corner is past the real lattice)
//     eight bits of four rows, written in block-major order. Per 8^3
//     block: its faces (from a 256-entry count table), its active cubes
//     and which classes have a cut edge. (A state byte per point in shared
//     memory, as K7's count keeps it, took more instructions, and
//     instructions bound this pass);
// (2) one multi-block scan (scan.cuh's scan_segments) of the popcounts of
//     the cut words (vertex ids), of the block face counts (face ids), of
//     the active cubes and of the class flags; its last tiles write the
//     five counters;
// (3) vertices, balanced within each warp (K8's walk, raster.cuh): a warp
//     takes 32 consecutive cut words, scans their popcounts and walks its
//     flat list of cut edges 32 at a time; each lane finds its word from a
//     ballot over the prefix sums and the words that start in the window,
//     its edge as the n-th set bit of that word, and its id as the warp's
//     first word base plus its place in the list, so consecutive lanes
//     write consecutive ids;
// (4) faces, balanced within each 8^3 block: persistent blocks of 256
//     threads, the per-cube tables in shared memory once, walk the 8^3
//     blocks with faces, each block's face count, base and cube bytes
//     loaded one block ahead. A block scans its cubes' triangle counts
//     (two cubes a thread), and thread r takes the block's faces r, r +
//     256, ...: its cube from a binary search over the 512 prefixes, its
//     slot the difference, each corner's id its (class, x, y) row's word
//     base plus a popcount within the word (read from device memory, where
//     a block's faces share them in L1: staging the block's 7 x 9 x 9 rows
//     in shared memory took longer than the faces' own reads). The
//     per-cube tables (mt_tables' per-tet tables folded over the six tets,
//     built in geometry/marching_tets.py:cube_tables) give each triangle's
//     corners as class * 8 + anchor corner;
// (5) the rows past the counts zeroed (the counters read on the device),
//     last, so that its stores do not evict the sdf and offsets from L2
//     before the vertices gather them.
// Rounding follows the plain version as K7's does (every operation rounded
// on its own, tanhf, a NaN t kept).

namespace {

constexpr int CUBE_TRIS = 12;                          // six tets, up to two triangles each
constexpr int CUBE_TABLE = 256 + 256 * CUBE_TRIS * 3;  // counts, then triangles of edge codes
constexpr int SEG_BLOCKS = 4;                          // 8^3 blocks of a classify segment: one cut word along z
constexpr int ROW_LOADS = (HALO * HALO + MASK_WORDS - 1) / MASK_WORDS;  // halo rows per warp (16) of the classify
constexpr int K11_VERT_THREADS = 256;                  // 8 warps of 32 cut words
constexpr int FACE_THREADS = 256;                      // threads of a face block
constexpr int FACE_CUBES = CELLS / FACE_THREADS;       // consecutive cubes a thread of the face pass scans
constexpr int TAIL_THREADS = 256;

// one block per segment of SEG_BLOCKS 8^3 blocks along z of a column of 8 x
// 8 (x, y) rows: each point's cut flags as (class, x, y) row words along z
// (cutbits[((c Np + i) Np + j) nwords + w] bit b: the class-c edge from (i,
// j, 32 w + b) is cut), each cube's corner byte (cases[blk 512 + t]) and per
// 8^3 block its faces, its active cubes and its class flags (blocks: [faces
// NB][active cubes NB][class c's flag, 7 NB]). The segment's halo (its
// blocks and the +1 points: 9 x 9 rows of 33 points along z) is loaded at
// once, a warp per row, and kept as two bit rows each: which points lie in
// the real lattice and which of those are inside (sdf > 0). A cut word is
// then one expression of two rows, and a cube's byte eight bits of four.
__global__ void __launch_bounds__(CELLS) mt_classify(const float *__restrict__ sdf, const int *__restrict__ tables,
                                                      unsigned *__restrict__ cutbits, uint8_t *__restrict__ cases,
                                                      int *__restrict__ blocks, int N, int Np, int nwords) {
    __shared__ int tcount[256];
    // bit z of halo row (hx, hy): point (bi + hx, bj + hy, k0 + z), z <= 32,
    // lies in the real lattice / is inside
    __shared__ unsigned long long real[HALO * HALO], ins[HALO * HALO];
    __shared__ int warp_sums[SEG_BLOCKS][MASK_WORDS][2];  // faces, active cubes
    __shared__ unsigned cut_any[2 * NCLS];                 // bit lz: a cut edge of the warp's class in block lz
    for (int e = threadIdx.x; e < 256; e += CELLS) tcount[e] = tables[e];
    const int nb = Np / BS, NB = nb * nb * nb;
    const int col = blockIdx.x / nwords, seg = blockIdx.x % nwords;
    const int bz0 = seg * SEG_BLOCKS, nz = min(SEG_BLOCKS, nb - bz0);
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int bi = (col / nb) * BS, bj = (col % nb) * BS, k0 = bz0 * BS;
    // the halo's rows, warp w taking rows w, w + 16, ...: lane l point k0 +
    // l, lane 0 point k0 + 32 too; every load in flight before the first use
    float v[ROW_LOADS], v32[ROW_LOADS];
#pragma unroll
    for (int q = 0; q < ROW_LOADS; ++q) {
        const int row = warp + q * MASK_WORDS, hi = bi + row / HALO, hj = bj + row % HALO;
        const int p = (hi * N + hj) * N + k0;  // N^3 < 2^31
        const bool in_row = row < HALO * HALO && hi < N && hj < N;
        v[q] = in_row && k0 + lane < N ? sdf[p + lane] : 0.f;
        v32[q] = lane == 0 && in_row && k0 + 32 < N ? sdf[p + 32] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < ROW_LOADS; ++q) {
        const int row = warp + q * MASK_WORDS, hi = bi + row / HALO, hj = bj + row % HALO;
        if (row < HALO * HALO) {  // the same for the whole warp
            const bool in_row = hi < N && hj < N, re = in_row && k0 + lane < N, re32 = in_row && k0 + 32 < N;
            const unsigned r = __ballot_sync(FULL, re), in = __ballot_sync(FULL, re && v[q] > 0.f);
            if (lane == 0) {
                real[row] = r | (unsigned long long)re32 << 32;
                ins[row] = in | (unsigned long long)(re32 && v32[q] > 0.f) << 32;
            }
        }
    }
    __syncthreads();  // (also publishes the count table)
    // the cut words: thread c * 64 + 8 ax + ay takes class c's word of row
    // (bi + ax, bj + ay); an edge is cut where both ends lie in the real
    // lattice and their occupancy differs
    if (t < NCLS * BS * BS) {  // warps 0-13
        const int c = t >> 6, ax = (t >> 3) & 7, ay = t & 7;
        const int dx = (STEP_X >> c) & 1, dy = (STEP_Y >> c) & 1, dz = (STEP_Z >> c) & 1;
        const int a = ax * HALO + ay, e = (ax + dx) * HALO + ay + dy;
        const unsigned w = (unsigned)(real[a] & (real[e] >> dz) & (ins[a] ^ (ins[e] >> dz)));
        cutbits[(((size_t)c * Np + bi + ax) * Np + bj + ay) * nwords + seg] = w;
        unsigned any = 0u;
#pragma unroll
        for (int lz = 0; lz < SEG_BLOCKS; ++lz) any |= (unsigned)(((w >> (BS * lz)) & 0xFFu) != 0u) << lz;
        any = __reduce_or_sync(FULL, any);
        if (lane == 0) cut_any[warp] = any;
    }
    // the cubes: thread t the cube (ox, oy, oz) of each 8^3 block; its
    // corners (c & 1, c >> 1 & 1, c >> 2 & 1) lie on four rows, taken from
    // z = oz on (bit 8 lz: the cube's z in 8^3 block lz, bit 8 lz + 1 the
    // next point)
    const int ox = t >> 6, oy = (t >> 3) & 7, oz = t & 7;
    const unsigned rows[4] = {(unsigned)(ins[ox * HALO + oy] >> oz), (unsigned)(ins[(ox + 1) * HALO + oy] >> oz),
                              (unsigned)(ins[ox * HALO + oy + 1] >> oz),
                              (unsigned)(ins[(ox + 1) * HALO + oy + 1] >> oz)};
    const unsigned far = (unsigned)(real[(ox + 1) * HALO + oy + 1] >> (oz + 1));
#pragma unroll
    for (int lz = 0; lz < SEG_BLOCKS; ++lz) {
        if (lz >= nz) break;  // the same for the whole block
        // the cube's corner byte; a cube whose far corner is past the real
        // lattice emits nothing
        unsigned cube = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c)
            cube |= ((rows[c & 3] >> (BS * lz + (c >> 2))) & 1u) << c;
        if (((far >> (BS * lz)) & 1u) == 0u) cube = 0u;
        const int blk = col * nb + bz0 + lz;
        cases[(size_t)blk * CELLS + t] = (uint8_t)cube;
        const int ntri = tcount[cube];  // tcount[0] = 0
        const int wf = __reduce_add_sync(FULL, ntri), wa = __popc(__ballot_sync(FULL, ntri > 0));
        if (lane == 0) {
            warp_sums[lz][warp][0] = wf;
            warp_sums[lz][warp][1] = wa;
        }
    }
    __syncthreads();
    // the totals of 8^3 block bz0 + t, one thread each
    if (t < nz) {
        int faces = 0, active = 0;
#pragma unroll
        for (int w = 0; w < MASK_WORDS; ++w) {
            faces += warp_sums[t][w][0];
            active += warp_sums[t][w][1];
        }
        const int blk = col * nb + bz0 + t;
        blocks[blk] = faces;
        blocks[NB + blk] = active;
#pragma unroll
        for (int c = 0; c < NCLS; ++c) blocks[(2 + c) * NB + blk] = ((cut_any[2 * c] | cut_any[2 * c + 1]) >> t) & 1u;
    }
}

// the place of the r-th (from 0) set bit of b
__device__ __forceinline__ int nth_bit(unsigned b, int r) {
    int at = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int n = __popc(b & ((1u << s) - 1u));
        if (r >= n) {
            r -= n;
            b >>= s;
            at += s;
        }
    }
    return at;
}

// one warp per 32 consecutive cut words (the words of a row consecutive,
// rows in (class, x, y) order), walking their cut edges 32 at a time: the
// positions of those with ids under the capacity
__global__ void __launch_bounds__(K11_VERT_THREADS) mt_verts(const float *__restrict__ sdf,
                                                             const float *__restrict__ offx,
                                                             const float *__restrict__ offy,
                                                             const float *__restrict__ offz,
                                                             const unsigned *__restrict__ cutbits,
                                                             const int *__restrict__ word_base, float *__restrict__ pos,
                                                             int N, int Np, int nwords, int mv, float inv_res) {
    const int lane = threadIdx.x & 31;
    const int nall = NCLS * Np * Np * nwords;
    const int w0 = blockIdx.x * K11_VERT_THREADS + (threadIdx.x & ~31);  // the warp's first word
    if (w0 >= nall) return;  // the whole warp
    const unsigned b = w0 + lane < nall ? cutbits[w0 + lane] : 0u;
    // the warp's edges have consecutive ids from its first word's base
    // (loaded with the words, whether or not the warp has an edge)
    const int base0 = lane == 0 ? word_base[w0] : 0;
    const int cnt = __popc(b);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    const int excl = incl - cnt, total = __shfl_sync(FULL, incl, 31);
    if (total == 0) return;  // the whole warp: no cut edge
    const int base = __shfl_sync(FULL, base0, 0);
    const unsigned nonzero = __ballot_sync(FULL, cnt > 0);
    const float *offs[3] = {offx, offy, offz};
    for (int v0 = 0; v0 < total && base + v0 < mv; v0 += 32) {
        // edge v = v0 + lane lies in the word j with excl_j <= v < incl_j:
        // the word open at v0 (the words wholly before it, counted), or the
        // k-th word that starts in (v0, v], k the words starting up to v
        const int open = __popc(__ballot_sync(FULL, incl <= v0));
        const bool starts = cnt > 0 && excl > v0 && excl < v0 + 32;
        const unsigned at = __reduce_or_sync(FULL, starts ? 1u << (excl - v0) : 0u);
        const int k = __popc(at & ((2u << lane) - 1u));
        const int jw = k == 0 ? open : nth_bit(nonzero & (0xFFFFFFFEu << open), k - 1);
        const int ej = __shfl_sync(FULL, excl, jw);
        const unsigned bj = __shfl_sync(FULL, b, jw);
        const int v = v0 + lane, id = base + v;
        if (v >= total || id >= mv) continue;  // past the capacity: dropped
        const int q = nth_bit(bj, v - ej);  // the lane's rank in its word
        const int wi = w0 + jw, row3 = wi / nwords, w = wi % nwords;
        const int c = row3 / (Np * Np), row = row3 % (Np * Np), i = row / Np, j = row % Np, kz = 32 * w + q;
        const int dx = (STEP_X >> c) & 1, dy = (STEP_Y >> c) & 1, dz = (STEP_Z >> c) & 1;
        const int idx0[3] = {i, j, kz}, idx1[3] = {i + dx, j + dy, kz + dz};
        // both ends lie in the real lattice (the classify pass's domain mask)
        const size_t p0 = flat(i, j, kz, N), p1 = flat(idx1[0], idx1[1], idx1[2], N);
        const float s0 = sdf[p0], d = __fsub_rn(s0, sdf[p1]);
        float t = __fdiv_rn(s0, d == 0.f ? 1.f : d);
        if (!isnan(t)) t = fminf(fmaxf(t, 0.f), 1.f);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float c0 = deformed(idx0[a], offs[a], p0, inv_res), c1 = deformed(idx1[a], offs[a], p1, inv_res);
            pos[(size_t)a * mv + id] = __fadd_rn(c0, __fmul_rn(t, __fsub_rn(c1, c0)));
        }
    }
}

// persistent blocks walking the 8^3 blocks, the tables loaded once: the
// faces of each block's cubes with ids under the capacity, thread r taking
// the block's faces r, r + FACE_THREADS, ...
__global__ void __launch_bounds__(FACE_THREADS) mt_faces(const uint8_t *__restrict__ cases,
                                                         const int *__restrict__ tables,
                                                         const unsigned *__restrict__ cutbits,
                                                         const int *__restrict__ word_base,
                                                         const int *__restrict__ fcount, const int *__restrict__ fbase,
                                                         int *__restrict__ corners, int Np, int nwords, int mf) {
    __shared__ uint8_t tcount[256];
    __shared__ uint8_t tri[256 * CUBE_TRIS * 3];  // edge codes class * 8 + corner (< 56)
    __shared__ int first[CELLS];                   // each cube's first face in the block
    __shared__ uint8_t scase[CELLS];
    // (the table's -1 past a cube's count kept as code 0: a face that a
    // wrong search sends past its cube's count still reads in bounds)
    for (int e = threadIdx.x; e < CUBE_TABLE; e += FACE_THREADS) {
        const int v = tables[e];
        if (e < 256) tcount[e] = (uint8_t)v;
        else tri[e - 256] = (uint8_t)max(v, 0);
    }
    __syncthreads();
    const int nb = Np / BS, NB = nb * nb * nb, t = threadIdx.x;
    // each 8^3 block's face count, face base and this thread's FACE_CUBES
    // consecutive cube bytes, loaded one block ahead
    int nf = 0, fb = 0;
    unsigned cs = 0u;
    auto load_cases = [&](int b) {
        cs = 0u;
#pragma unroll
        for (int h = 0; h < FACE_CUBES; ++h) cs |= (unsigned)cases[(size_t)b * CELLS + FACE_CUBES * t + h] << (8 * h);
    };
    if ((int)blockIdx.x < NB) {
        nf = fcount[blockIdx.x];
        fb = fbase[blockIdx.x];
        load_cases(blockIdx.x);
    }
    for (int blk = blockIdx.x; blk < NB; blk += gridDim.x) {
        const int nf_here = nf, fb_here = fb, next = blk + gridDim.x;
        const unsigned cs_here = cs;
        if (next < NB) {
            nf = fcount[next];
            fb = fbase[next];
            load_cases(next);
        }
        if (nf_here == 0 || fb_here >= mf) continue;  // the same for the whole block
        const int bi = (blk / (nb * nb)) * BS, bj = ((blk / nb) % nb) * BS, bk = (blk % nb) * BS;
        // the cubes' first faces: a scan of the threads' triangle counts,
        // then each thread's cubes in order
        int n = 0;
#pragma unroll
        for (int h = 0; h < FACE_CUBES; ++h) n += tcount[(cs_here >> (8 * h)) & 0xFFu];
        int total;
        int f0 = block_exclusive_scan(n, &total);
#pragma unroll
        for (int h = 0; h < FACE_CUBES; ++h) {
            const unsigned cu = (cs_here >> (8 * h)) & 0xFFu;
            first[FACE_CUBES * t + h] = f0;
            scase[FACE_CUBES * t + h] = (uint8_t)cu;
            f0 += tcount[cu];
        }
        __syncthreads();
        for (int r = t; r < total && fb_here + r < mf; r += FACE_THREADS) {
            // the cube u with first_u <= r < first_u + its count: the last
            // cube whose first face is at most r (a cube without faces shares
            // its first with the next one)
            int u = 0;
#pragma unroll
            for (int s = CELLS / 2; s > 0; s >>= 1)
                if (first[u + s] <= r) u += s;
            const int slot = r - first[u], cu = scase[u];
            const int ox = u >> 6, oy = (u >> 3) & 7, oz = u & 7;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const int code = tri[(cu * CUBE_TRIS + slot) * 3 + c], cls = code >> 3, a = code & 7;
                const int i = bi + ox + (a & 1), j = bj + oy + ((a >> 1) & 1), k = bk + oz + (a >> 2);
                const int g = ((cls * Np + i) * Np + j) * nwords + (k >> 5);  // the corner's cut word
                corners[(size_t)c * mf + fb_here + r] = word_base[g] + __popc(cutbits[g] & ((1u << (k & 31)) - 1u));
            }
        }
        __syncthreads();  // the next block rewrites first and scase
    }
}

// the rows past the counts zeroed: blockIdx.y 0-2 the positions' rows from
// min(num_verts, mv), 3-5 the corners' rows from min(num_faces, mf); a row
// at the 16-byte boundaries in 16-byte stores
__global__ void __launch_bounds__(TAIL_THREADS) mt_tails(const int *__restrict__ counts, float *__restrict__ pos,
                                                         int *__restrict__ corners, int mv, int mf) {
    const int row = blockIdx.y, cap = row < 3 ? mv : mf;
    unsigned *p = row < 3 ? reinterpret_cast<unsigned *>(pos) + (size_t)row * mv
                          : reinterpret_cast<unsigned *>(corners) + (size_t)(row - 3) * mf;
    const int lo = min(counts[row < 3 ? 0 : 1], cap);
    const int head = min(cap, lo + (int)(((16 - (reinterpret_cast<uintptr_t>(p + lo) & 15)) & 15) >> 2));
    const int nvec = (cap - head) >> 2, tail = head + 4 * nvec;
    const int t0 = blockIdx.x * TAIL_THREADS + threadIdx.x, stride = gridDim.x * TAIL_THREADS;
    if (t0 < head - lo) p[lo + t0] = 0u;
    uint4 *q = reinterpret_cast<uint4 *>(p + head);
    for (int e = t0; e < nvec; e += stride) q[e] = make_uint4(0u, 0u, 0u, 0u);
    if (t0 < cap - tail) p[tail + t0] = 0u;
}

}  // namespace

// K11: sdf and the three raw offsets, each (N, N, N) f32 x-major, and the
// per-cube tables (int32 [count 256][triangles 256 x 12 x 3]) -> (3, mv) f32
// positions and (3, mf) int32 face corners, every row past the counts 0.
// zeroed (zeroed by the caller): the 5 int32 counters (num_verts,
// num_faces, active vertex blocks, face blocks, active cubes), the scan's
// tile counter, 2 pad ints, then status_tiles u64 status words. Scratch,
// Np = 8 ceil(N / 8), NB = (Np / 8)^3: cutbits and word_base 7 Np^2
// ceil(Np / 32) ints each, cases Np^3 bytes, blocks 9 NB ints, fbase NB
// ints. inv_res is f32(1 / res). Five launches: classify, one scan of every
// count array (which writes the counters), the vertices, the faces, the
// rows past the counts.
extern "C" int marching_tets_fwd(const void *sdf, const void *off_x, const void *off_y, const void *off_z,
                                 const void *tables, void *pos, void *corners, void *zeroed, void *cutbits,
                                 void *word_base, void *cases, void *blocks, void *fbase, int N, int mv, int mf,
                                 int status_tiles, int num_sms, float inv_res, void *stream) {
    if (N < 2 || mv < 1 || mf < 1) return (int)cudaErrorInvalidValue;
    const int Np = (N + BS - 1) / BS * BS, nb = Np / BS, NB = nb * nb * nb, nwords = (Np + 31) / 32;
    if ((long long)Np * Np * Np >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const float *s = static_cast<const float *>(sdf);
    const int *tab = static_cast<const int *>(tables);
    unsigned *bits = static_cast<unsigned *>(cutbits);
    int *wb = static_cast<int *>(word_base), *bl = static_cast<int *>(blocks), *fb = static_cast<int *>(fbase);
    int *counts = static_cast<int *>(zeroed);
    const int nwords_all = NCLS * Np * Np * nwords;

    ScanSegs sg = {};
    auto seg = [&](int k, const int *in, int *base, int n, int popc, int *total, int *nonzero) {
        sg.in[k] = in;
        sg.base[k] = base;
        sg.n[k] = n;
        sg.popc[k] = popc;
        sg.total[k] = total;
        sg.nonzero[k] = nonzero;
        sg.first_tile[k + 1] = sg.first_tile[k] + scan_tiles(n);
    };
    // counts = [num_verts, num_faces, active vertex blocks, face blocks, active cubes]
    seg(0, reinterpret_cast<const int *>(bits), wb, nwords_all, 1, counts, nullptr);  // vertex ids
    seg(1, bl, fb, NB, 0, counts + 1, counts + 3);                                    // face ids, face blocks
    seg(2, bl + NB, nullptr, NB, 0, counts + 4, nullptr);                             // active cubes
    seg(3, bl + 2 * NB, nullptr, NCLS * NB, 0, counts + 2, nullptr);                  // vertex blocks
    sg.nsegs = 4;
    const int tiles = sg.first_tile[4];
    if (tiles > status_tiles) return (int)cudaErrorInvalidValue;

    int fgrid = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fgrid, mt_faces, FACE_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    fgrid = std::max(1, std::min(NB, fgrid * num_sms));
    const dim3 tgrid(std::max(1, std::min((std::max(mv, mf) + 4 * TAIL_THREADS - 1) / (4 * TAIL_THREADS),
                                          2 * num_sms)), 6);

    mt_classify<<<nb * nb * nwords, CELLS, 0, st>>>(s, tab, bits, static_cast<uint8_t *>(cases), bl, N, Np, nwords);
    scan_segments<<<tiles, MS_THREADS, 0, st>>>(sg, reinterpret_cast<unsigned long long *>(counts + 8), counts + 5);
    mt_verts<<<(nwords_all + K11_VERT_THREADS - 1) / K11_VERT_THREADS, K11_VERT_THREADS, 0, st>>>(
        s, static_cast<const float *>(off_x), static_cast<const float *>(off_y), static_cast<const float *>(off_z),
        bits, wb, static_cast<float *>(pos), N, Np, nwords, mv, inv_res);
    mt_faces<<<fgrid, FACE_THREADS, 0, st>>>(static_cast<const uint8_t *>(cases), tab, bits, wb, bl, fb,
                                             static_cast<int *>(corners), Np, nwords, mf);
    // last: its stores would evict the sdf and offsets the vertices gather
    mt_tails<<<tgrid, TAIL_THREADS, 0, st>>>(counts, static_cast<float *>(pos), static_cast<int *>(corners), mv, mf);
    return (int)cudaGetLastError();
}
