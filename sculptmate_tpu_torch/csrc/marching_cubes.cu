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
// vertices; 8 B more per vertex with the edges). The TPU program's block
// capacities, one-hot contraction and overflow tails were workarounds for
// fixed compaction buffers; here the
// ids come from exact prefixes and only the rows under the capacity are
// written.
//
// Design:
// - K3, three launches: (1) count, one block per column of 8 x 8 (x, y)
//   rows walking its 8^3 blocks along z, the next block's level loaded
//   ahead (K10's classify pattern): a point's three cut flags, the
//   occupancy byte of 8 consecutive z points from one warp ballot, the
//   block's three 512-bit cut masks (each warp's ballot a 32-bit word, in
//   in-block order ox * 64 + oy * 8 + oz) and its per-axis counts; (2) the
//   multi-block scan (scan.cuh's scan_segments, decoupled look-back) of
//   the 3 NB counts, which also gives the two wire counters; (3) emit, one
//   thread per mask word: its ids are the block's scanned base, the cut
//   edges of the block's earlier words (a scan over the 16 lanes holding
//   the block's words) and a rank within the word, and it reads the level
//   at its cut edges only;
// - K10, four launches: (1) classify, one block per column of 8 x 8 rows
//   walking its 8^3 blocks along z: every cell's case byte, each (axis, x, y) row's cut flags as
//   32-bit words (one warp ballot per 8 z points), and per 8^3 block its
//   faces, active cells and axes with a cut edge; (2) one multi-block scan
//   (scan.cuh's scan_segments, decoupled look-back) of the popcounts of the
//   cut words (vertex ids), of the block face counts (face ids), of the
//   active cells and of the axis flags, whose last tiles write the four
//   counters; (3) one thread per cut word emits its positions (and, when
//   the caller asks, each vertex's cut edge a n3 + lin, the identity the
//   sharded extraction welds its seams by); (4) persistent
//   blocks, each with the tables in shared memory once, walk the 8^3
//   blocks with faces and emit them from the case bytes, each corner's id
//   its cut word's base plus a popcount within the word.
// Rounding follows the plain versions: every operation rounded on its own,
// t's u16 to nearest even.
//
// The x limit (``xlimit``, RX - 1 for a whole lattice): an x-slab of the
// sharded extraction holds its neighbour's first row as a halo, plus
// padding rows. Cells and x-cut edges at x >= xlimit emit nothing; y and z
// cut edges are never x-masked (a cell's +x face uses them). It is one
// compare in each count pass: K3's and K10's later passes read only what
// those passes wrote.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "scan.cuh"

namespace {

constexpr int BS = 8;                     // block side
constexpr int CELLS = BS * BS * BS;       // threads of a per-block kernel
constexpr int VERT_THREADS = 256;         // cut words per block of K10's vertex pass

// clamp(l0 / (l0 - l1, or 1 where that is 0), 0, 1) of the edge p -> p + step
__device__ __forceinline__ float edge_t(const float *__restrict__ lv, size_t p, size_t step) {
    const float l0 = lv[p], d = __fsub_rn(l0, lv[p + step]);
    return fminf(fmaxf(__fdiv_rn(l0, d == 0.f ? 1.f : d), 0.f), 1.f);
}

__device__ __forceinline__ size_t axis_step(int a, int RY, int RZ) {
    return a == 0 ? (size_t)RY * RZ : (a == 1 ? (size_t)RZ : 1);
}

// -- K3: the wire --

constexpr int MASK_WORDS = CELLS / 32;   // 32-bit words of one 8^3 block's cut mask
constexpr int EMIT_THREADS = 256;        // mask words per block of the emit pass

// one block per column of 8 x 8 (x, y) rows, walking its 8^3 blocks along
// z: each point's occupancy bit, each block's three cut masks (masks[(a NB +
// blk) 16 + w] bit l: the edge from in-block point 32 w + l to its +a
// neighbour is cut) and its per-axis counts (vcnt[a NB + blk])
__global__ void __launch_bounds__(CELLS) wire_count(const float *__restrict__ lv, uint8_t *__restrict__ occ,
                                                     unsigned *__restrict__ masks, int *__restrict__ vcnt, int RX,
                                                     int RY, int RZ, int xlimit) {
    __shared__ int warp_cnt[2][3][MASK_WORDS];  // by the parity of bz
    const int nby = RY / BS, nbz = RZ / BS, NB = (RX / BS) * nby * nbz;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int i = (blockIdx.x / nby) * BS + (t >> 6), j = (blockIdx.x % nby) * BS + ((t >> 3) & 7);
    const size_t sx = (size_t)RY * RZ, sy = RZ;
    const bool xi = i + 1 < RX, yj = j + 1 < RY;
    const bool xcut = xi && i < xlimit;  // x-cut edges from this row count
    // the level at this thread's point of 8^3 block bz and at its +x, +y
    // and +z neighbours (0 past the lattice, where no edge is cut); loaded
    // one 8^3 block ahead
    auto load = [&](int bz, float (&v)[4]) {
        const int k = bz * BS + (t & 7);
        const size_t p = ((size_t)i * RY + j) * RZ + k;
        v[0] = lv[p];
        v[1] = xi ? lv[p + sx] : 0.f;
        v[2] = yj ? lv[p + sy] : 0.f;
        v[3] = k + 1 < RZ ? lv[p + 1] : 0.f;
    };
    float next[4];
    load(0, next);
    for (int bz = 0; bz < nbz; ++bz) {
        const int k = bz * BS + (t & 7), blk = blockIdx.x * nbz + bz;
        const size_t p = ((size_t)i * RY + j) * RZ + k;
        const bool in = next[0] > 0.f;
        const bool fx = xcut && (next[1] > 0.f) != in, fy = yj && (next[2] > 0.f) != in,
                   fz = k + 1 < RZ && (next[3] > 0.f) != in;
        if (bz + 1 < nbz) load(bz + 1, next);
        // the 8 points (i, j, k0 .. k0 + 7) are lanes 8m .. 8m + 7 of one
        // warp: their byte, bit b = point k0 + b
        const unsigned inb = __ballot_sync(FULL, in);
        if ((t & 7) == 0) occ[p >> 3] = (uint8_t)((inb >> (lane & 24)) & 0xFF);
        const unsigned bx = __ballot_sync(FULL, fx), by = __ballot_sync(FULL, fy), bzm = __ballot_sync(FULL, fz);
        if (lane < 3)
            masks[((size_t)lane * NB + blk) * MASK_WORDS + warp] = lane == 0 ? bx : (lane == 1 ? by : bzm);
        if (lane == 0) {
            warp_cnt[bz & 1][0][warp] = __popc(bx);
            warp_cnt[bz & 1][1][warp] = __popc(by);
            warp_cnt[bz & 1][2][warp] = __popc(bzm);
        }
        // one barrier per 8^3 block: the next block writes the other half
        __syncthreads();
        if (t < 3) {
            int n = 0;
#pragma unroll
            for (int w = 0; w < MASK_WORDS; ++w) n += warp_cnt[bz & 1][t][w];
            vcnt[t * NB + blk] = n;
        }
    }
}

// one thread per mask word (the 16 words of an (axis, block) on 16
// consecutive lanes): the t, and the positions, of its cut edges with ids
// under the capacity; thread 0 writes the two counters the scan gave
__global__ void __launch_bounds__(EMIT_THREADS) wire_emit(const float *__restrict__ lv,
                                                           const unsigned *__restrict__ masks,
                                                           const int *__restrict__ vbase,
                                                           const int *__restrict__ counters, uint8_t *__restrict__ t_lo,
                                                           uint8_t *__restrict__ t_hi, uint8_t *__restrict__ le,
                                                           float *__restrict__ pos, int RX, int RY, int RZ, int mv) {
    const int nby = RY / BS, nbz = RZ / BS, NB = (RX / BS) * nby * nbz;
    const long long gw = (long long)blockIdx.x * EMIT_THREADS + threadIdx.x;
    const unsigned word = gw < 3ll * NB * MASK_WORDS ? masks[gw] : 0u;
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
    const int ab = (int)(gw / MASK_WORDS), wi = (int)(gw % MASK_WORDS), a = ab / NB, blk = ab % NB;
    const int bi = (blk / (nby * nbz)) * BS, bj = ((blk / nbz) % nby) * BS, bk = (blk % nbz) * BS;
    const size_t step = axis_step(a, RY, RZ);
    int id = vbase[ab] + incl - cnt;
    for (unsigned b = word; b != 0u && id < mv; b &= b - 1u, ++id) {  // past the capacity: dropped
        const int q = wi * 32 + __ffs(b) - 1;  // in-block ox * 64 + oy * 8 + oz
        const int i = bi + (q >> 6), j = bj + ((q >> 3) & 7), k = bk + (q & 7);
        const float t = edge_t(lv, ((size_t)i * RY + j) * RZ + k, step);
        const int u = __float2int_rn(__fmul_rn(t, 65535.f));
        t_lo[id] = (uint8_t)(u & 0xFF);
        t_hi[id] = (uint8_t)(u >> 8);
        if (pos != nullptr) {
            pos[id] = __fadd_rn((float)i, a == 0 ? t : 0.f);
            pos[(size_t)mv + id] = __fadd_rn((float)j, a == 1 ? t : 0.f);
            pos[2 * (size_t)mv + id] = __fadd_rn((float)k, a == 2 ? t : 0.f);
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
                                                      int *__restrict__ blocks, int RX, int RY, int RZ, int nwords,
                                                      int xlimit) {
    __shared__ int tcount[256];
    __shared__ int warp_sums[2][CELLS / 32][3];  // faces, active cells, axis flags; by the parity of bz
    for (int e = threadIdx.x; e < 256; e += CELLS) tcount[e] = tri_count[e];
    __syncthreads();
    const int nby = RY / BS, nbz = RZ / BS, NB = (RX / BS) * nby * nbz;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int i = (blockIdx.x / nby) * BS + (t >> 6), j = (blockIdx.x % nby) * BS + ((t >> 3) & 7);
    const size_t sx = (size_t)RY * RZ, sy = RZ;
    const bool xi = i + 1 < RX, yj = j + 1 < RY;
    const bool xc = xi && i < xlimit;  // this row's cells and x-cut edges count
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
        const bool zk = k + 1 < RZ, cell = xc && yj && zk;
        unsigned in = 0u;
#pragma unroll
        for (int c = 0; c < 8; ++c) in |= (unsigned)(next[c] > 0.f) << c;
        if (bz + 1 < nbz) corners(bz + 1, next);
        const unsigned in0 = in & 1u;
        const unsigned f = (xc && ((in >> 1) & 1u) != in0 ? 1u : 0u) | (yj && ((in >> 2) & 1u) != in0 ? 2u : 0u) |
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
// the first its word's scanned base, and, when edges is not null, each
// one's edge a n3 + (i RY + j) RZ + k
__global__ void __launch_bounds__(VERT_THREADS) mc_verts(const float *__restrict__ lv,
                                                         const unsigned *__restrict__ cutbits,
                                                         const int *__restrict__ word_base, float *__restrict__ pos,
                                                         long long *__restrict__ edges, int RX, int RY, int RZ,
                                                         int nwords, int mv) {
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
        if (edges != nullptr) edges[id] = (long long)a * RX * RY * RZ + (long long)(p0 + k);
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

// K3: level (RX, RY, RZ) f32, x limit xlimit (<= RX - 1) -> the wire (zeroed by the caller: n3/8 + 2 mv
// + 8 bytes) and, when pos is not null, the (3, mv) f32 lattice positions
// (zeroed by the caller). Scratch: masks 48 NB u32, vcnt and vbase 3 NB
// ints; zeroed (zeroed by the caller): the 2 counters, the scan's tile
// counter, 1 pad int, then status_tiles u64 status words. Three launches:
// count, the scan of the 3 NB counts (which gives the counters), emit.
extern "C" int mc_wire_fwd(const void *level, void *wire, void *pos, void *masks, void *vcnt, void *vbase,
                           void *zeroed, int RX, int RY, int RZ, int xlimit, int mv, int status_tiles,
                           void *stream) {
    if (bad_shape(RX, RY, RZ) || mv < 1 || xlimit < 0 || xlimit > RX - 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int NB = (RX / BS) * (RY / BS) * (RZ / BS);
    const size_t n3 = (size_t)RX * RY * RZ;
    const float *lv = static_cast<const float *>(level);
    uint8_t *w = static_cast<uint8_t *>(wire);
    unsigned *mk = static_cast<unsigned *>(masks);
    int *cnt = static_cast<int *>(vcnt), *base = static_cast<int *>(vbase), *counters = static_cast<int *>(zeroed);
    ScanSegs sg = {};
    sg.in[0] = cnt;
    sg.base[0] = base;
    sg.n[0] = 3 * NB;
    sg.total[0] = counters;        // num_verts
    sg.nonzero[0] = counters + 1;  // n_vblocks
    sg.first_tile[1] = scan_tiles(3 * NB);
    sg.nsegs = 1;
    if (sg.first_tile[1] > status_tiles) return (int)cudaErrorInvalidValue;
    const long long nwords = 3ll * NB * MASK_WORDS;
    wire_count<<<(RX / BS) * (RY / BS), CELLS, 0, st>>>(lv, w, mk, cnt, RX, RY, RZ, xlimit);
    scan_segments<<<sg.first_tile[1], MS_THREADS, 0, st>>>(sg, reinterpret_cast<unsigned long long *>(counters + 4),
                                                            counters + 2);
    wire_emit<<<(int)((nwords + EMIT_THREADS - 1) / EMIT_THREADS), EMIT_THREADS, 0, st>>>(
        lv, mk, base, counters, w + n3 / 8, w + n3 / 8 + mv, w + n3 / 8 + 2 * (size_t)mv, static_cast<float *>(pos),
        RX, RY, RZ, mv);
    return (int)cudaGetLastError();
}

// K10: level (RX, RY, RZ) f32, x limit xlimit (<= RX - 1) -> (3, mv) f32 positions and (3, mf) int32
// face corners (both zeroed by the caller), and, when edges is not null, the
// (mv,) int64 cut edge of each vertex (zeroed by the caller). zeroed
// (zeroed by the caller): the 4 int32 counters, the scan's tile counter, 3 pad ints, then
// status_tiles u64 status words. Scratch: cutbits and word_base 3 RX RY
// ceil(RZ / 32) ints each, cases RX RY RZ bytes, blocks 5 NB ints, fbase
// NB ints. Four launches: classify, one scan of every count array (which
// writes the counters), the vertices, the faces.
extern "C" int marching_cubes_fwd(const void *level, const void *tables, void *pos, void *edges, void *corners,
                                  void *zeroed, void *cutbits, void *word_base, void *cases, void *blocks,
                                  void *fbase, int RX, int RY, int RZ, int xlimit, int mv, int mf, int maxtri,
                                  int status_tiles, int num_sms, void *stream) {
    if (bad_shape(RX, RY, RZ) || mv < 1 || mf < 1 || maxtri < 1 || xlimit < 0 || xlimit > RX - 1)
        return (int)cudaErrorInvalidValue;
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
                                                         RZ, nwords, xlimit);
    scan_segments<<<tiles, MS_THREADS, 0, st>>>(sg, reinterpret_cast<unsigned long long *>(counts + 8),
                                                 counts + 4);
    mc_verts<<<(3 * nrows * nwords + VERT_THREADS - 1) / VERT_THREADS, VERT_THREADS, 0, st>>>(
        lv, bits, wb, static_cast<float *>(pos), static_cast<long long *>(edges), RX, RY, RZ, nwords, mv);
    mc_faces<<<fgrid, CELLS, smem, st>>>(static_cast<const uint8_t *>(cases), tab, bits, wb, bl, fb,
                                         static_cast<int *>(corners), RX, RY, RZ, nwords, mf, maxtri);
    return (int)cudaGetLastError();
}
