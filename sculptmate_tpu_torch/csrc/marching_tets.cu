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
// compaction buffers; here ids come from exact prefixes (K3's scheme with
// seven classes for three axes) and only ids under the capacity are written.
//
// Design: count (one block of 512 threads per 8^3 block: a point's seven cut
// flags, the occupancy byte of 8 consecutive z points from one warp ballot,
// per-class block counts from __syncthreads_count), the exclusive scan of
// the 7 NB counts in one block (which also writes the counters), then emit
// (the flags again, in-block ranks from ballots). No edge mask is stored.
// Rounding follows the plain version as PyTorch computes it on the card:
// every operation rounded on its own (no contracted multiply-adds), a
// division by a scalar as a product with its reciprocal (taken in double,
// rounded to f32), tanhf, u16 to nearest even, a NaN t kept as the clamp
// keeps it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr int BS = 8;                // block side
constexpr int CELLS = BS * BS * BS;  // threads of a per-block kernel
constexpr int NCLS = 7;              // edge classes
// bit c: class c's step along x, y and z (mt_tables.EDGE_DIRS)
constexpr unsigned STEP_X = 0b1011001u, STEP_Y = 0b1101010u, STEP_Z = 0b1110100u;

struct BlockPoint {
    int blk, i, j, k;
};

// this thread's padded lattice point: block blockIdx.x in (bx, by, bz)
// order, thread t = ox * 64 + oy * 8 + oz within it
__device__ __forceinline__ BlockPoint block_point(int nb) {
    const int blk = blockIdx.x, t = threadIdx.x;
    BlockPoint q;
    q.blk = blk;
    q.i = (blk / (nb * nb)) * BS + (t >> 6);
    q.j = ((blk / nb) % nb) * BS + ((t >> 3) & 7);
    q.k = (blk % nb) * BS + (t & 7);
    return q;
}

__device__ __forceinline__ size_t flat(int i, int j, int k, int N) { return ((size_t)i * N + j) * N + k; }

// sdf > 0 at (i, j, k); the padding (any coordinate >= N) is outside
__device__ __forceinline__ bool occupied(const float *__restrict__ sdf, int i, int j, int k, int N) {
    return i < N && j < N && k < N && sdf[flat(i, j, k, N)] > 0.f;
}

// bit c set when class c's edge from (i, j, k) is cut: both ends inside the
// real N^3 lattice (the domain mask) and their occupancy differs
__device__ __forceinline__ unsigned cut_flags(const float *__restrict__ sdf, int i, int j, int k, int N) {
    const bool in = occupied(sdf, i, j, k, N);
    unsigned f = 0;
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
        const int dx = (STEP_X >> c) & 1, dy = (STEP_Y >> c) & 1, dz = (STEP_Z >> c) & 1;
        if (i + dx < N && j + dy < N && k + dz < N && occupied(sdf, i + dx, j + dy, k + dz, N) != in) f |= 1u << c;
    }
    return f;
}

__global__ void __launch_bounds__(CELLS) mt_count(const float *__restrict__ sdf, uint8_t *__restrict__ occ,
                                                   int *__restrict__ vcnt, int N, int Np) {
    const BlockPoint q = block_point(Np / BS);
    const int NB = gridDim.x, lane = threadIdx.x & 31;
    const unsigned f = cut_flags(sdf, q.i, q.j, q.k, N);
    // the 8 points (i, j, k0 .. k0 + 7) are lanes 8m .. 8m + 7 of one warp:
    // their byte, bit b = point k0 + b
    const unsigned in = __ballot_sync(FULL, occupied(sdf, q.i, q.j, q.k, N));
    if ((threadIdx.x & 7) == 0) occ[flat(q.i, q.j, q.k, Np) >> 3] = (uint8_t)((in >> (lane & 24)) & 0xFF);
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
        const int n = __syncthreads_count((f >> c) & 1u);
        if (threadIdx.x == 0) vcnt[c * NB + q.blk] = n;
    }
}

// one end of an edge, deformed: i / res + tanh(offset) / res along one axis
__device__ __forceinline__ float deformed(int idx, const float *__restrict__ off, size_t p, float inv_res) {
    return __fadd_rn(__fmul_rn((float)idx, inv_res), __fmul_rn(tanhf(off[p]), inv_res));
}

struct WireScalars {
    float inv_res, lo, inv_span, eps_lo, eps_hi;  // 1/res, -1/res, 1/(1 + 2/res), eps, 1 - eps
};

__global__ void __launch_bounds__(CELLS) mt_emit(const float *__restrict__ sdf, const float *__restrict__ ox,
                                                  const float *__restrict__ oy, const float *__restrict__ oz,
                                                  const int *__restrict__ vbase, uint8_t *__restrict__ pos, int N,
                                                  int Np, int mv, WireScalars w) {
    __shared__ int warp_cnt[NCLS][CELLS / 32];
    const BlockPoint q = block_point(Np / BS);
    const int NB = gridDim.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned f = cut_flags(sdf, q.i, q.j, q.k, N);
    int rank[NCLS];
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
        const unsigned b = __ballot_sync(FULL, (f >> c) & 1u);
        rank[c] = __popc(b & lanemask_lt());
        if (lane == 0) warp_cnt[c][warp] = __popc(b);
    }
    __syncthreads();
    if (f == 0) return;
    const size_t p0 = flat(q.i, q.j, q.k, N);  // a cut edge's anchor lies in the real lattice
    const float s0 = sdf[p0];
    const float *offs[3] = {ox, oy, oz};
    const int idx0[3] = {q.i, q.j, q.k};
#pragma unroll
    for (int c = 0; c < NCLS; ++c) {
        if (!((f >> c) & 1u)) continue;
        int id = vbase[c * NB + q.blk] + rank[c];
        for (int v = 0; v < warp; ++v) id += warp_cnt[c][v];
        if (id >= mv) continue;  // past the capacity: dropped, the counters stay exact
        const int idx1[3] = {q.i + (int)((STEP_X >> c) & 1), q.j + (int)((STEP_Y >> c) & 1),
                             q.k + (int)((STEP_Z >> c) & 1)};
        const size_t p1 = flat(idx1[0], idx1[1], idx1[2], N);
        const float d = __fsub_rn(s0, sdf[p1]);
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
// vcnt and vbase: 7 (Np/8)^3 ints of scratch. The scalars are f32 as the
// plain version rounds them: 1/res, -1/res, 1/(1 + 2/res), snap_eps and
// 1 - snap_eps, each computed in double and rounded to f32.
extern "C" int mt_wire_fwd(const void *sdf, const void *off_x, const void *off_y, const void *off_z, void *wire,
                           void *vcnt, void *vbase, int N, int mv, float inv_res, float lo, float inv_span,
                           float eps_lo, float eps_hi, void *stream) {
    if (N < 1 || mv < 1 || (long long)N * N * N >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const int Np = (N + BS - 1) / BS * BS, nb = Np / BS, NB = nb * nb * nb;
    const size_t occ_bytes = (size_t)Np * Np * Np / 8;
    const float *s = static_cast<const float *>(sdf);
    uint8_t *wb = static_cast<uint8_t *>(wire);
    int *cnt = static_cast<int *>(vcnt), *base = static_cast<int *>(vbase);
    mt_count<<<NB, CELLS, 0, st>>>(s, wb, cnt, N, Np);
    scan_counts<<<1, SCAN_THREADS, 0, st>>>(cnt, NCLS * NB, base, nullptr, wb + occ_bytes + 6 * (size_t)mv);
    const WireScalars w{inv_res, lo, inv_span, eps_lo, eps_hi};
    mt_emit<<<NB, CELLS, 0, st>>>(s, static_cast<const float *>(off_x), static_cast<const float *>(off_y),
                                  static_cast<const float *>(off_z), base, wb + occ_bytes, N, Np, mv, w);
    return (int)cudaGetLastError();
}
