// K3 and K10: marching cubes on the card, each a count, a scan and an emit.
//
// K3 replaces sculptmate_tpu/geometry/marching_cubes.py:mc_wire_device
// (l.454, with _vertex_side_wire, scatter_compact_rows and
// _compacted_positions): the wire of the Lean path. Occupancy bits, the cut
// lattice edges numbered block-major (axis, 8^3 block, in-block ox/oy/oz:
// each id the exclusive prefix of the per-block cut counts plus the
// in-block rank), a u16 t per vertex, two little-endian u32 counters, and
// optionally the f32 lattice positions of the vertices for the color query.
//
// K10 replaces sculptmate_tpu/geometry/marching_cubes.py:marching_cubes
// (l.538, with _vertex_side, _compact_blocks and _cut_masks): the packed
// mesh. Vertices numbered axis-major, then in flat x-major (i, j, k) order;
// faces emitted block-major (blocks (bx, by, bz), cells (ox, oy, oz), then
// the table's triangles); four exact counters.
//
// Bound on the H100: bytes. At 256^3 K3 reads the 67 MB level and writes
// 2.1 MB of bits and 14 B per vertex (0.022 ms at 3.35 TB/s); K10 reads the
// level and writes 12 B per vertex and per face (~0.027 ms at ~0.6 M
// vertices). The TPU program's block capacities, one-hot contraction and
// overflow tails were workarounds for fixed compaction buffers; here the
// ids come from exact prefixes and only the rows under the capacity are
// written.
//
// Design:
// - K3: count (one block of 512 threads per 8^3 block: a point's three cut
//   flags, the occupancy byte of 8 consecutive z points from one warp
//   ballot, per-axis block counts from __syncthreads_count), an exclusive
//   scan of the 3 NB counts in one block (which also writes the counters),
//   then emit (the same flags again, in-block ranks from ballots);
// - K10, four launches: (1) classify, one block per column of 8 x 8 rows
//   walking its 8^3 blocks along z: every cell's case byte, each (axis, x, y) row's cut flags as
//   32-bit words (one warp ballot per 8 z points), and per 8^3 block its
//   faces, active cells and axes with a cut edge; (2) one multi-block scan
//   (scan.cuh's scan_segments, decoupled look-back) of the popcounts of the
//   cut words (vertex ids), of the block face counts (face ids), of the
//   active cells and of the axis flags, whose last tiles write the four
//   counters; (3) one thread per cut word emits its positions; (4) persistent
//   blocks, each with the tables in shared memory once, walk the 8^3
//   blocks with faces and emit them from the case bytes, each corner's id
//   its cut word's base plus a popcount within the word.
// Rounding follows the plain versions: every operation rounded on its own,
// t's u16 to nearest even.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "scan.cuh"

namespace {

constexpr int BS = 8;                     // block side
constexpr int CELLS = BS * BS * BS;       // threads of a per-block kernel
constexpr int VERT_THREADS = 256;         // cut words per block of K10's vertex pass

// bit a set when the edge from lattice point p = (i, j, k) to its +a
// neighbour is cut (the two sides of level > 0 differ)
__device__ __forceinline__ unsigned cut_flags(const float *__restrict__ lv, size_t p, int i, int j, int k, int RX,
                                              int RY, int RZ) {
    const bool in = lv[p] > 0.f;
    unsigned f = 0;
    if (i + 1 < RX && (lv[p + (size_t)RY * RZ] > 0.f) != in) f |= 1u;
    if (j + 1 < RY && (lv[p + RZ] > 0.f) != in) f |= 2u;
    if (k + 1 < RZ && (lv[p + 1] > 0.f) != in) f |= 4u;
    return f;
}

// clamp(l0 / (l0 - l1, or 1 where that is 0), 0, 1) of the edge p -> p + step
__device__ __forceinline__ float edge_t(const float *__restrict__ lv, size_t p, size_t step) {
    const float l0 = lv[p], d = __fsub_rn(l0, lv[p + step]);
    return fminf(fmaxf(__fdiv_rn(l0, d == 0.f ? 1.f : d), 0.f), 1.f);
}

__device__ __forceinline__ size_t axis_step(int a, int RY, int RZ) {
    return a == 0 ? (size_t)RY * RZ : (a == 1 ? (size_t)RZ : 1);
}

// -- K3: the wire --

struct BlockPoint {
    int blk, i, j, k;
    size_t p;
};

// the lattice point of this thread: block blockIdx.x in (bx, by, bz) order,
// thread t = ox * 64 + oy * 8 + oz within it
__device__ __forceinline__ BlockPoint block_point(int RY, int RZ) {
    const int nby = RY / BS, nbz = RZ / BS, blk = blockIdx.x, t = threadIdx.x;
    BlockPoint q;
    q.blk = blk;
    q.i = (blk / (nby * nbz)) * BS + (t >> 6);
    q.j = ((blk / nbz) % nby) * BS + ((t >> 3) & 7);
    q.k = (blk % nbz) * BS + (t & 7);
    q.p = ((size_t)q.i * RY + q.j) * RZ + q.k;
    return q;
}

__global__ void __launch_bounds__(CELLS) wire_count(const float *__restrict__ lv, uint8_t *__restrict__ occ,
                                                     int *__restrict__ vcnt, int RX, int RY, int RZ) {
    const BlockPoint q = block_point(RY, RZ);
    const int NB = gridDim.x, lane = threadIdx.x & 31;
    const unsigned f = cut_flags(lv, q.p, q.i, q.j, q.k, RX, RY, RZ);
    // the 8 points (i, j, k0 .. k0 + 7) are lanes 8m .. 8m + 7 of one warp:
    // their byte, bit b = point k0 + b
    const unsigned in = __ballot_sync(FULL, lv[q.p] > 0.f);
    if ((threadIdx.x & 7) == 0) occ[q.p >> 3] = (uint8_t)((in >> (lane & 24)) & 0xFF);
    const int cx = __syncthreads_count(f & 1u), cy = __syncthreads_count(f & 2u), cz = __syncthreads_count(f & 4u);
    if (threadIdx.x == 0) {
        vcnt[q.blk] = cx;
        vcnt[NB + q.blk] = cy;
        vcnt[2 * NB + q.blk] = cz;
    }
}

__global__ void __launch_bounds__(CELLS) wire_emit(const float *__restrict__ lv, const int *__restrict__ vbase,
                                                    uint8_t *__restrict__ t_lo, uint8_t *__restrict__ t_hi,
                                                    float *__restrict__ pos, int RX, int RY, int RZ, int mv) {
    __shared__ int warp_cnt[3][CELLS / 32];
    const BlockPoint q = block_point(RY, RZ);
    const int NB = gridDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned f = cut_flags(lv, q.p, q.i, q.j, q.k, RX, RY, RZ);
    int rank[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const unsigned b = __ballot_sync(FULL, (f >> a) & 1u);
        rank[a] = __popc(b & lanemask_lt());
        if (lane == 0) warp_cnt[a][warp] = __popc(b);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        if (!((f >> a) & 1u)) continue;
        int id = vbase[a * NB + q.blk] + rank[a];
        for (int w = 0; w < warp; ++w) id += warp_cnt[a][w];
        if (id >= mv) continue;  // past the capacity: dropped, the counters stay exact
        const float t = edge_t(lv, q.p, axis_step(a, RY, RZ));
        const int u = __float2int_rn(__fmul_rn(t, 65535.f));
        t_lo[id] = (uint8_t)(u & 0xFF);
        t_hi[id] = (uint8_t)(u >> 8);
        if (pos != nullptr) {
            pos[id] = __fadd_rn((float)q.i, a == 0 ? t : 0.f);
            pos[(size_t)mv + id] = __fadd_rn((float)q.j, a == 1 ? t : 0.f);
            pos[2 * (size_t)mv + id] = __fadd_rn((float)q.k, a == 2 ? t : 0.f);
        }
    }
}

// -- K10: the packed mesh --

// one block per column of 8 x 8 (x, y) rows, walking its 8^3 blocks along
// z: each cell's case byte (0 on the +boundary, where cells emit nothing),
// in block-major order; each (axis, x, y) row's cut flags along z as 32-bit
// words (word w = z 32w .. 32w + 31, written once its four 8^3 blocks are
// seen, the last word's high bits zero); per 8^3 block its faces, its
// active cells and which axes have a cut edge starting in it (blocks:
// [faces NB][active cells NB][axis flags 3 NB])
__global__ void __launch_bounds__(CELLS) mc_classify(const float *__restrict__ lv, const int *__restrict__ tri_count,
                                                      unsigned *__restrict__ cutbits, uint8_t *__restrict__ cases,
                                                      int *__restrict__ blocks, int RX, int RY, int RZ, int nwords) {
    __shared__ int tcount[256];
    __shared__ int warp_sums[2][CELLS / 32][3];  // faces, active cells, axis flags; by the parity of bz
    for (int e = threadIdx.x; e < 256; e += CELLS) tcount[e] = tri_count[e];
    __syncthreads();
    const int nby = RY / BS, nbz = RZ / BS, NB = (RX / BS) * nby * nbz;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int i = (blockIdx.x / nby) * BS + (t >> 6), j = (blockIdx.x % nby) * BS + ((t >> 3) & 7);
    const size_t sx = (size_t)RY * RZ, sy = RZ;
    const bool xi = i + 1 < RX, yj = j + 1 < RY;
    const size_t nrows = (size_t)RX * RY;
    unsigned word[3] = {0u, 0u, 0u};  // this lane's row's word so far (lanes with oz = 0 store it)
    // the level at the 8 corners of this thread's cell in 8^3 block bz,
    // corner c at +x (c & 1), +y (c & 2), +z (c & 4); a corner past the
    // lattice reads as 0 (outside). Loaded one 8^3 block ahead.
    auto corners = [&](int bz, float (&v)[8]) {
        const int k = bz * BS + (t & 7);
        const size_t p = ((size_t)i * RY + j) * RZ + k;
        const bool zk = k + 1 < RZ, cell = xi && yj && zk;
        v[0] = lv[p];
        v[1] = xi ? lv[p + sx] : 0.f;
        v[2] = yj ? lv[p + sy] : 0.f;
        v[3] = cell ? lv[p + sx + sy] : 0.f;
        v[4] = zk ? lv[p + 1] : 0.f;
        v[5] = cell ? lv[p + sx + 1] : 0.f;
        v[6] = cell ? lv[p + sy + 1] : 0.f;
        v[7] = cell ? lv[p + sx + sy + 1] : 0.f;
    };
    float next[8];
    corners(0, next);
    for (int bz = 0; bz < nbz; ++bz) {
        const int k = bz * BS + (t & 7), blk = blockIdx.x * nbz + bz;
        const bool zk = k + 1 < RZ, cell = xi && yj && zk;
        unsigned in = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c) in |= (unsigned)(next[c] > 0.f) << c;
        if (bz + 1 < nbz) corners(bz + 1, next);
        const unsigned in0 = in & 1u;
        const unsigned f = (xi && ((in >> 1) & 1u) != in0 ? 1u : 0u) | (yj && ((in >> 2) & 1u) != in0 ? 2u : 0u) |
                           (zk && ((in >> 4) & 1u) != in0 ? 4u : 0u);
        const int cs = cell ? (int)in : 0;
        cases[(size_t)blk * CELLS + t] = (uint8_t)cs;
        const int ntri = tcount[cs];  // tri_count[0] = 0
        // the 8 points (i, j, k0 .. k0 + 7) are lanes 8m .. 8m + 7 of one warp
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const unsigned b = __ballot_sync(FULL, (f >> a) & 1u);
            word[a] |= ((b >> (lane & 24)) & 0xFFu) << (8 * (bz & 3));
        }
        if ((bz & 3) == 3 || bz == nbz - 1) {
            if ((lane & 7) == 0)
#pragma unroll
                for (int a = 0; a < 3; ++a) cutbits[((size_t)a * nrows + (size_t)i * RY + j) * nwords + bz / 4] = word[a];
            word[0] = word[1] = word[2] = 0u;
        }
        const int wf = __reduce_add_sync(FULL, ntri), wa = __popc(__ballot_sync(FULL, ntri > 0));
        const unsigned wo = __reduce_or_sync(FULL, f);
        if (lane == 0) {
            warp_sums[bz & 1][warp][0] = wf;
            warp_sums[bz & 1][warp][1] = wa;
            warp_sums[bz & 1][warp][2] = (int)wo;
        }
        // one barrier per 8^3 block: the next block writes the other half
        __syncthreads();
        if (t == 0) {
            int faces = 0, active = 0, axes = 0;
            for (int w = 0; w < CELLS / 32; ++w) {
                faces += warp_sums[bz & 1][w][0];
                active += warp_sums[bz & 1][w][1];
                axes |= warp_sums[bz & 1][w][2];
            }
            blocks[blk] = faces;
            blocks[NB + blk] = active;
            blocks[2 * NB + blk] = axes & 1;
            blocks[3 * NB + blk] = (axes >> 1) & 1;
            blocks[4 * NB + blk] = (axes >> 2) & 1;
        }
    }
}

// one thread per cut word (the words of a row consecutive, rows in (axis,
// x, y) order): the positions of its cut edges with ids under the capacity,
// the first its word's scanned base
__global__ void __launch_bounds__(VERT_THREADS) mc_verts(const float *__restrict__ lv,
                                                         const unsigned *__restrict__ cutbits,
                                                         const int *__restrict__ word_base, float *__restrict__ pos,
                                                         int RX, int RY, int RZ, int nwords, int mv) {
    const int nrows = RX * RY;
    const long long wi = (long long)blockIdx.x * VERT_THREADS + threadIdx.x;
    if (wi >= 3ll * nrows * nwords) return;
    unsigned b = cutbits[wi];
    int id = word_base[wi];
    if (b == 0u || id >= mv) return;
    const int row3 = (int)(wi / nwords), w = (int)(wi % nwords);
    const int a = row3 / nrows, row = row3 % nrows, i = row / RY, j = row % RY;
    const size_t step = axis_step(a, RY, RZ), p0 = ((size_t)i * RY + j) * RZ;
    for (; b != 0u && id < mv; b &= b - 1u, ++id) {
        const int k = 32 * w + __ffs(b) - 1;
        const float t = edge_t(lv, p0 + k, step);
        pos[id] = __fadd_rn((float)i, a == 0 ? t : 0.f);
        pos[(size_t)mv + id] = __fadd_rn((float)j, a == 1 ? t : 0.f);
        pos[2 * (size_t)mv + id] = __fadd_rn((float)k, a == 2 ? t : 0.f);
    }
}

// the vertex id of the cut edge (a, i, j, k): its word's base plus the cut
// edges before it in the word
__device__ __forceinline__ int vertex_id(const unsigned *__restrict__ cutbits, const int *__restrict__ word_base,
                                         int a, int i, int j, int k, int RX, int RY, int nwords) {
    const size_t w3 = (((size_t)a * RX + i) * RY + j) * nwords + (k >> 5);
    int id = word_base[w3];
    return id + __popc(cutbits[w3] & ((1u << (k & 31)) - 1u));
}

// persistent blocks walking the 8^3 blocks, the tables loaded once: the
// faces of each block's cells with ids under the capacity, from the case
// bytes and the scanned face bases
__global__ void __launch_bounds__(CELLS) mc_faces(const uint8_t *__restrict__ cases, const int *__restrict__ tables,
                                                   const unsigned *__restrict__ cutbits,
                                                   const int *__restrict__ word_base, const int *__restrict__ fcount,
                                                   const int *__restrict__ fbase, int *__restrict__ corners, int RX,
                                                   int RY, int RZ, int nwords, int mf, int maxtri) {
    extern __shared__ int tab[];  // tri_count (256), tri_table (256 * maxtri * 3), edge axis (12), edge offset (36)
    const int ntab = 256 + 256 * maxtri * 3 + 12 + 36;
    for (int e = threadIdx.x; e < ntab; e += CELLS) tab[e] = tables[e];
    __syncthreads();
    const int *tri = tab + 256, *eaxis = tri + 256 * maxtri * 3, *eoff = eaxis + 12;
    const int nby = RY / BS, nbz = RZ / BS, NB = (RX / BS) * nby * nbz, t = threadIdx.x;
    for (int blk = blockIdx.x; blk < NB; blk += gridDim.x) {
        const int fb = fbase[blk];
        if (fcount[blk] == 0 || fb >= mf) continue;  // the same for the whole block
        const int i = (blk / (nby * nbz)) * BS + (t >> 6), j = ((blk / nbz) % nby) * BS + ((t >> 3) & 7),
                  k = (blk % nbz) * BS + (t & 7);
        const int cs = cases[(size_t)blk * CELLS + t], ntri = tab[cs];
        int total;
        const int f0 = fb + block_exclusive_scan(ntri, &total);
        for (int s = 0; s < ntri && f0 + s < mf; ++s) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const int le = tri[(cs * maxtri + s) * 3 + c];
                corners[(size_t)c * mf + f0 + s] = vertex_id(cutbits, word_base, eaxis[le], i + eoff[3 * le],
                                                             j + eoff[3 * le + 1], k + eoff[3 * le + 2], RX, RY,
                                                             nwords);
            }
        }
    }
}

bool bad_shape(int RX, int RY, int RZ) {
    return RX < BS || RY < BS || RZ < BS || RX % BS || RY % BS || RZ % BS ||
           (long long)RX * RY * RZ >= (1ll << 31);
}

}  // namespace

// K3: level (RX, RY, RZ) f32 -> the wire (zeroed by the caller: n3/8 + 2 mv
// + 8 bytes) and, when pos is not null, the (3, mv) f32 lattice positions
// (zeroed by the caller). vcnt and vbase: 3 NB ints of scratch.
extern "C" int mc_wire_fwd(const void *level, void *wire, void *pos, void *vcnt, void *vbase, int RX, int RY, int RZ,
                           int mv, void *stream) {
    if (bad_shape(RX, RY, RZ) || mv < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int NB = (RX / BS) * (RY / BS) * (RZ / BS);
    const size_t n3 = (size_t)RX * RY * RZ;
    const float *lv = static_cast<const float *>(level);
    uint8_t *w = static_cast<uint8_t *>(wire);
    int *cnt = static_cast<int *>(vcnt), *base = static_cast<int *>(vbase);
    wire_count<<<NB, CELLS, 0, st>>>(lv, w, cnt, RX, RY, RZ);
    scan_counts<<<1, SCAN_THREADS, 0, st>>>(cnt, 3 * NB, base, nullptr, w + n3 / 8 + 2 * (size_t)mv);
    wire_emit<<<NB, CELLS, 0, st>>>(lv, base, w + n3 / 8, w + n3 / 8 + mv, static_cast<float *>(pos), RX, RY, RZ,
                                    mv);
    return (int)cudaGetLastError();
}

// K10: level (RX, RY, RZ) f32 -> (3, mv) f32 positions and (3, mf) int32
// face corners (both zeroed by the caller). zeroed (zeroed by the caller):
// the 4 int32 counters, the scan's tile counter, 3 pad ints, then
// status_tiles u64 status words. Scratch: cutbits and word_base 3 RX RY
// ceil(RZ / 32) ints each, cases RX RY RZ bytes, blocks 5 NB ints, fbase
// NB ints. Four launches: classify, one scan of every count array (which
// writes the counters), the vertices, the faces.
extern "C" int marching_cubes_fwd(const void *level, const void *tables, void *pos, void *corners, void *zeroed,
                                  void *cutbits, void *word_base, void *cases, void *blocks, void *fbase, int RX,
                                  int RY, int RZ, int mv, int mf, int maxtri, int status_tiles, int num_sms,
                                  void *stream) {
    if (bad_shape(RX, RY, RZ) || mv < 1 || mf < 1 || maxtri < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int NB = (RX / BS) * (RY / BS) * (RZ / BS), nrows = RX * RY, nwords = (RZ + 31) / 32;
    const float *lv = static_cast<const float *>(level);
    const int *tab = static_cast<const int *>(tables);
    unsigned *bits = static_cast<unsigned *>(cutbits);
    int *wb = static_cast<int *>(word_base), *bl = static_cast<int *>(blocks), *fb = static_cast<int *>(fbase);
    int *counts = static_cast<int *>(zeroed);

    ScanSegs sg = {};
    auto seg = [&](int s, const int *in, int *base, int n, int popc, int *total, int *nonzero) {
        sg.in[s] = in;
        sg.base[s] = base;
        sg.n[s] = n;
        sg.popc[s] = popc;
        sg.total[s] = total;
        sg.nonzero[s] = nonzero;
        sg.first_tile[s + 1] = sg.first_tile[s] + scan_tiles(n);
    };
    // counts = [num_verts, num_faces, max(active vertex blocks, face blocks), active cells]
    seg(0, reinterpret_cast<const int *>(bits), wb, 3 * nrows * nwords, 1, counts, nullptr);  // vertex ids
    seg(1, bl, fb, NB, 0, counts + 1, counts + 2);                                            // face ids
    seg(2, bl + NB, nullptr, NB, 0, counts + 3, nullptr);                                     // active cells
    seg(3, bl + 2 * NB, nullptr, 3 * NB, 0, counts + 2, nullptr);                             // vertex blocks
    sg.nsegs = 4;
    const int tiles = sg.first_tile[4];
    if (tiles > status_tiles) return (int)cudaErrorInvalidValue;

    int fgrid = 0;
    const size_t smem = (size_t)(256 + 256 * maxtri * 3 + 12 + 36) * sizeof(int);
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fgrid, mc_faces, CELLS, smem);
    if (e != cudaSuccess) return (int)e;
    fgrid = std::max(1, std::min(NB, fgrid * num_sms));

    mc_classify<<<(RX / BS) * (RY / BS), CELLS, 0, st>>>(lv, tab, bits, static_cast<uint8_t *>(cases), bl, RX, RY,
                                                         RZ, nwords);
    scan_segments<<<tiles, MS_THREADS, 0, st>>>(sg, reinterpret_cast<unsigned long long *>(counts + 8),
                                                 counts + 4);
    mc_verts<<<(3 * nrows * nwords + VERT_THREADS - 1) / VERT_THREADS, VERT_THREADS, 0, st>>>(
        lv, bits, wb, static_cast<float *>(pos), RX, RY, RZ, nwords, mv);
    mc_faces<<<fgrid, CELLS, smem, st>>>(static_cast<const uint8_t *>(cases), tab, bits, wb, bl, fb,
                                         static_cast<int *>(corners), RX, RY, RZ, nwords, mf, maxtri);
    return (int)cudaGetLastError();
}
