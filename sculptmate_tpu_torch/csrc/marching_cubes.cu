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
// - K10: per (x, y) row, the cut flags of each axis as 32-bit words (one
//   warp ballot per word) and their counts; per 8^3 block the cells' cases
//   and triangle counts, the active cells and the axes with cut edges;
//   exclusive scans of the row counts (vertex ids) and of the block face
//   counts (face ids); then one warp per row emits the positions and one
//   block per 8^3 block emits the faces, each corner's id the row base plus
//   the popcount of the row's cut words before it.
// Rounding follows the plain versions: every operation rounded on its own,
// t's u16 to nearest even.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int BS = 8;                     // block side
constexpr int CELLS = BS * BS * BS;       // threads of a per-block kernel
constexpr int ROW_WARPS = 8;              // rows per block of the per-row kernels

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

// per (x, y) row: each axis's cut flags along z as 32-bit words, and their
// counts (row a * RX * RY + x * RY + y)
__global__ void __launch_bounds__(ROW_WARPS * 32) mc_rows(const float *__restrict__ lv, unsigned *__restrict__ cutbits,
                                                          int *__restrict__ row_cnt, int RX, int RY, int RZ,
                                                          int nwords) {
    const int lane = threadIdx.x & 31, row = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), nrows = RX * RY;
    if (row >= nrows) return;  // whole warps
    const int i = row / RY, j = row % RY;
    int cnt[3] = {0, 0, 0};
    for (int w = 0; w < nwords; ++w) {
        const int k = 32 * w + lane;
        const unsigned f = k < RZ ? cut_flags(lv, ((size_t)i * RY + j) * RZ + k, i, j, k, RX, RY, RZ) : 0u;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const unsigned b = __ballot_sync(FULL, (f >> a) & 1u);
            if (lane == 0) cutbits[((size_t)a * nrows + row) * nwords + w] = b;
            cnt[a] += __popc(b);
        }
    }
    if (lane == 0)
        for (int a = 0; a < 3; ++a) row_cnt[a * nrows + row] = cnt[a];
}

// per 8^3 block: faces and active cells of its cells, and which axes have a
// cut edge starting in it (blocks: [faces NB][active cells NB][axis flags 3 NB])
__global__ void __launch_bounds__(CELLS) mc_cells(const float *__restrict__ lv, const int *__restrict__ tables,
                                                   int *__restrict__ blocks, int RX, int RY, int RZ) {
    const BlockPoint q = block_point(RY, RZ);
    const int NB = gridDim.x;
    const unsigned f = cut_flags(lv, q.p, q.i, q.j, q.k, RX, RY, RZ);
    int ntri = 0;
    if (q.i + 1 < RX && q.j + 1 < RY && q.k + 1 < RZ) {  // cells on the +boundary emit nothing
        int cs = 0;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const size_t pc = q.p + ((c & 1) ? (size_t)RY * RZ : 0) + (((c >> 1) & 1) ? RZ : 0) + ((c >> 2) & 1);
            cs |= (lv[pc] > 0.f) << c;
        }
        ntri = tables[cs];
    }
    int faces;
    block_exclusive_scan(ntri, &faces);
    const int active = __syncthreads_count(ntri > 0);
    const int fx = __syncthreads_or(f & 1u), fy = __syncthreads_or(f & 2u), fz = __syncthreads_or(f & 4u);
    if (threadIdx.x == 0) {
        blocks[q.blk] = faces;
        blocks[NB + q.blk] = active;
        blocks[2 * NB + q.blk] = fx != 0;
        blocks[3 * NB + q.blk] = fy != 0;
        blocks[4 * NB + q.blk] = fz != 0;
    }
}

// one warp per (axis, x, y) row: the positions of its cut edges with ids
// under the capacity
__global__ void __launch_bounds__(ROW_WARPS * 32) mc_verts(const float *__restrict__ lv,
                                                           const unsigned *__restrict__ cutbits,
                                                           const int *__restrict__ row_base, float *__restrict__ pos,
                                                           int RX, int RY, int RZ, int nwords, int mv) {
    const int lane = threadIdx.x & 31, row3 = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5), nrows = RX * RY;
    if (row3 >= 3 * nrows) return;  // whole warps
    const int a = row3 / nrows, row = row3 % nrows, i = row / RY, j = row % RY;
    const size_t step = axis_step(a, RY, RZ);
    int base = row_base[row3];
    for (int w = 0; w < nwords && base < mv; ++w) {
        const unsigned b = cutbits[(size_t)row3 * nwords + w];
        const int k = 32 * w + lane, id = base + __popc(b & lanemask_lt());
        if (((b >> lane) & 1u) && id < mv) {
            const float t = edge_t(lv, ((size_t)i * RY + j) * RZ + k, step);
            pos[id] = __fadd_rn((float)i, a == 0 ? t : 0.f);
            pos[(size_t)mv + id] = __fadd_rn((float)j, a == 1 ? t : 0.f);
            pos[2 * (size_t)mv + id] = __fadd_rn((float)k, a == 2 ? t : 0.f);
        }
        base += __popc(b);
    }
}

// the vertex id of the cut edge (a, i, j, k): its row's base plus the cut
// edges before it in the row
__device__ __forceinline__ int vertex_id(const unsigned *__restrict__ cutbits, const int *__restrict__ row_base,
                                         int a, int i, int j, int k, int RX, int RY, int nwords) {
    const size_t row3 = ((size_t)a * RX + i) * RY + j;
    const unsigned *words = cutbits + row3 * nwords;
    int id = row_base[row3];
    for (int w = 0; w < (k >> 5); ++w) id += __popc(words[w]);
    return id + __popc(words[k >> 5] & ((1u << (k & 31)) - 1u));
}

// one block per 8^3 block: the faces of its cells with ids under the capacity
__global__ void __launch_bounds__(CELLS) mc_faces(const float *__restrict__ lv, const int *__restrict__ tables,
                                                   const unsigned *__restrict__ cutbits,
                                                   const int *__restrict__ row_base, const int *__restrict__ fbase,
                                                   int *__restrict__ corners, int RX, int RY, int RZ, int nwords,
                                                   int mf, int maxtri) {
    extern __shared__ int tab[];  // tri_count (256), tri_table (256 * maxtri * 3), edge axis (12), edge offset (36)
    const int ntab = 256 + 256 * maxtri * 3 + 12 + 36;
    for (int e = threadIdx.x; e < ntab; e += CELLS) tab[e] = tables[e];
    __syncthreads();
    const int *tri = tab + 256, *eaxis = tri + 256 * maxtri * 3, *eoff = eaxis + 12;

    const BlockPoint q = block_point(RY, RZ);
    int cs = 0, ntri = 0;
    if (q.i + 1 < RX && q.j + 1 < RY && q.k + 1 < RZ) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const size_t pc = q.p + ((c & 1) ? (size_t)RY * RZ : 0) + (((c >> 1) & 1) ? RZ : 0) + ((c >> 2) & 1);
            cs |= (lv[pc] > 0.f) << c;
        }
        ntri = tab[cs];
    }
    int total;
    const int f0 = fbase[q.blk] + block_exclusive_scan(ntri, &total);
    for (int s = 0; s < ntri && f0 + s < mf; ++s) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const int le = tri[(cs * maxtri + s) * 3 + c];
            corners[(size_t)c * mf + f0 + s] = vertex_id(cutbits, row_base, eaxis[le], q.i + eoff[3 * le],
                                                         q.j + eoff[3 * le + 1], q.k + eoff[3 * le + 2], RX, RY,
                                                         nwords);
        }
    }
}

// counts = [num_verts, num_faces, max(active vertex blocks, face blocks),
// active cells] from the scans' sums
__global__ void mc_counters(const int *__restrict__ sums, int *__restrict__ counts) {
    counts[0] = sums[0];
    counts[1] = sums[2];
    counts[2] = max(sums[6], sums[3]);
    counts[3] = sums[4];
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
// face corners (both zeroed by the caller) and 4 int32 counters. Scratch:
// cutbits 3 RX RY ceil(RZ / 32) words, row_base 3 RX RY ints, blocks 5 NB
// ints, sums 8 ints.
extern "C" int marching_cubes_fwd(const void *level, const void *tables, void *pos, void *corners, void *counts,
                                  void *cutbits, void *row_base, void *blocks, void *sums, int RX, int RY, int RZ,
                                  int mv, int mf, int maxtri, void *stream) {
    if (bad_shape(RX, RY, RZ) || mv < 1 || mf < 1 || maxtri < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int NB = (RX / BS) * (RY / BS) * (RZ / BS), nrows = RX * RY, nwords = (RZ + 31) / 32;
    const float *lv = static_cast<const float *>(level);
    const int *tab = static_cast<const int *>(tables);
    unsigned *bits = static_cast<unsigned *>(cutbits);
    int *rb = static_cast<int *>(row_base), *bl = static_cast<int *>(blocks), *sm = static_cast<int *>(sums);
    mc_rows<<<(nrows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(lv, bits, rb, RX, RY, RZ, nwords);
    mc_cells<<<NB, CELLS, 0, st>>>(lv, tab, bl, RX, RY, RZ);
    scan_counts<<<1, SCAN_THREADS, 0, st>>>(rb, 3 * nrows, rb, sm, nullptr);          // vertex ids
    scan_counts<<<1, SCAN_THREADS, 0, st>>>(bl, NB, bl, sm + 2, nullptr);             // face ids
    scan_counts<<<1, SCAN_THREADS, 0, st>>>(bl + NB, NB, nullptr, sm + 4, nullptr);   // active cells
    scan_counts<<<1, SCAN_THREADS, 0, st>>>(bl + 2 * NB, 3 * NB, nullptr, sm + 6, nullptr);  // vertex blocks
    mc_counters<<<1, 1, 0, st>>>(sm, static_cast<int *>(counts));
    mc_verts<<<(3 * nrows + ROW_WARPS - 1) / ROW_WARPS, ROW_WARPS * 32, 0, st>>>(lv, bits, rb,
                                                                                static_cast<float *>(pos), RX, RY,
                                                                                RZ, nwords, mv);
    const size_t smem = (size_t)(256 + 256 * maxtri * 3 + 12 + 36) * sizeof(int);
    mc_faces<<<NB, CELLS, smem, st>>>(lv, tab, bits, rb, bl, static_cast<int *>(corners), RX, RY, RZ, nwords, mf,
                                      maxtri);
    return (int)cudaGetLastError();
}
