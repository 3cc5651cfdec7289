// Exclusive scans shared by the marching kernels (K3, K10 in
// marching_cubes.cu, K7 in marching_tets.cu) and the unwrap (K9 in
// uv_unwrap.cu): the in-block prefix of one int per thread, which K10's
// face pass takes; and the multi-block scan of one or several count arrays
// in one launch (scan_segments: decoupled look-back over tiles of 2048
// counts), which K3, K7, K9 and K10 launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// exclusive prefix of v over the block's threads in order; *total gets the
// block's sum. Every thread of the block must call it.
__device__ int block_exclusive_scan(int v, int *total) {
    __shared__ int warp_part[32];
    __shared__ int block_total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_part[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const int w = lane < nwarps ? warp_part[lane] : 0;
        int s = w;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(FULL, s, o);
            if (lane >= o) s += y;
        }
        warp_part[lane] = s - w;
        if (lane == 31) block_total = s;
    }
    __syncthreads();
    const int excl = warp_part[warp] + x - v;
    *total = block_total;
    __syncthreads();  // the shared parts may be reused by the next call
    return excl;
}

// ---- the multi-block scan ----------------------------------------------------
//
// Up to MS_SEGS count arrays ("segments") in one launch, each cut into
// tiles of MS_TILE counts, one block per tile. A block takes the next tile
// id from a counter (so a tile only ever waits for tiles that have
// started), loads its counts coalesced (a warp reads 32 consecutive ints),
// scans them in shared memory, and finds the sum of the tiles before it by
// decoupled look-back: it publishes its aggregate, walks back over its
// predecessors' status words, adding aggregates until it meets an
// inclusive prefix, and publishes its own. A status word packs the flag
// (bits 62-63: 0 none yet, 1 aggregate, 2 inclusive prefix), the count of
// nonzero entries (bits 31-61) and the sum (bits 0-30). The last tile of a
// segment writes its total and nonzero count with atomicMax into ints the
// caller zeroed, so two segments can share one counter as their maximum.
// The status words and the tile counter are zeroed by the caller on the
// stream before every launch.

constexpr int MS_THREADS = 256;
constexpr int MS_ITEMS = 8;
constexpr int MS_TILE = MS_THREADS * MS_ITEMS;  // counts per tile
constexpr int MS_SEGS = 4;

struct ScanSegs {
    const int *in[MS_SEGS];  // counts; or 32-bit words whose popcounts are the counts (popc)
    int *base[MS_SEGS];      // exclusive prefixes of the counts, or null
    int *total[MS_SEGS];     // atomicMax of the segment's sum, or null
    int *nonzero[MS_SEGS];   // atomicMax of its count of nonzero entries, or null
    int n[MS_SEGS];
    int popc[MS_SEGS];
    int first_tile[MS_SEGS + 1];  // the segments' tiles, one after another
    int nsegs;
};

// the tiles of a segment of n counts
__host__ __device__ __forceinline__ int scan_tiles(int n) { return (n + MS_TILE - 1) / MS_TILE; }

constexpr unsigned long long MS_FLAG_AGG = 1ull << 62, MS_FLAG_PREFIX = 2ull << 62, MS_VALUE = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long ms_pack(int sum, int nonzero) {
    return ((unsigned long long)nonzero << 31) | (unsigned)sum;
}
__device__ __forceinline__ int ms_sum(unsigned long long v) { return (int)(v & 0x7FFFFFFFull); }
__device__ __forceinline__ int ms_nonzero(unsigned long long v) { return (int)((v >> 31) & 0x7FFFFFFFull); }

__device__ __forceinline__ void ms_publish(unsigned long long *p, unsigned long long v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ms_read(const unsigned long long *p) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
    return v;
}

// exclusive prefix of a packed (sum, nonzero) pair over the block's threads
__device__ unsigned long long block_exclusive_scan64(unsigned long long v, unsigned long long *total) {
    __shared__ unsigned long long warp_part[32];
    __shared__ unsigned long long block_total;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
    unsigned long long x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_part[warp] = x;
    __syncthreads();
    if (warp == 0) {
        const unsigned long long w = lane < nwarps ? warp_part[lane] : 0;
        unsigned long long s = w;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned long long y = __shfl_up_sync(FULL, s, o);
            if (lane >= o) s += y;
        }
        warp_part[lane] = s - w;
        if (lane == 31) block_total = s;
    }
    __syncthreads();
    const unsigned long long excl = warp_part[warp] + x - v;
    *total = block_total;
    __syncthreads();
    return excl;
}

// shared-memory slot of count e of a tile: one pad word per 32, so that a
// thread's MS_ITEMS consecutive counts are read without bank conflicts
__device__ __forceinline__ int ms_slot(int e) { return e + (e >> 5); }

__global__ void __launch_bounds__(MS_THREADS) scan_segments(const __grid_constant__ ScanSegs sg,
                                                            unsigned long long *status, int *next_tile) {
    __shared__ int vals[MS_TILE + MS_TILE / 32];
    __shared__ int tile_id;
    __shared__ unsigned long long tile_prefix;
    if (threadIdx.x == 0) tile_id = atomicAdd(next_tile, 1);
    __syncthreads();
    const int gt = tile_id;
    int s = 0;
    while (s + 1 < sg.nsegs && gt >= sg.first_tile[s + 1]) ++s;
    const int first = sg.first_tile[s], tile = gt - first, n = sg.n[s], lo = tile * MS_TILE;
    const int *in = sg.in[s];
    const bool popc = sg.popc[s] != 0;
#pragma unroll
    for (int it = 0; it < MS_ITEMS; ++it) {
        const int e = it * MS_THREADS + threadIdx.x, g = lo + e;
        int v = g < n ? in[g] : 0;
        if (popc) v = __popc(v);
        vals[ms_slot(e)] = v;
    }
    __syncthreads();
    int local[MS_ITEMS], sum = 0, nz = 0;
#pragma unroll
    for (int e = 0; e < MS_ITEMS; ++e) {
        local[e] = vals[ms_slot(threadIdx.x * MS_ITEMS + e)];
        sum += local[e];
        nz += local[e] != 0;
    }
    unsigned long long agg;
    const unsigned long long excl = block_exclusive_scan64(ms_pack(sum, nz), &agg);
    if (threadIdx.x == 0) {
        unsigned long long prefix = 0;
        if (tile == 0) {
            ms_publish(status + gt, MS_FLAG_PREFIX | agg);
        } else {
            ms_publish(status + gt, MS_FLAG_AGG | agg);
            const long long t0 = clock64();
            for (int pred = gt - 1;;) {
                const unsigned long long st = ms_read(status + pred);
                if ((st >> 62) == 0) {  // not published yet; a lost tile traps after ~10 s
                    if (clock64() - t0 > (1ll << 34)) __trap();
                    continue;
                }
                prefix += st & MS_VALUE;
                if ((st >> 62) == 2) break;
                --pred;
            }
            ms_publish(status + gt, MS_FLAG_PREFIX | (prefix + agg));
        }
        tile_prefix = prefix;
        if (tile == sg.first_tile[s + 1] - first - 1) {
            if (sg.total[s] != nullptr) atomicMax(sg.total[s], ms_sum(prefix + agg));
            if (sg.nonzero[s] != nullptr) atomicMax(sg.nonzero[s], ms_nonzero(prefix + agg));
        }
    }
    __syncthreads();
    int *base = sg.base[s];
    if (base == nullptr) return;
    int run = ms_sum(tile_prefix) + ms_sum(excl);
#pragma unroll
    for (int e = 0; e < MS_ITEMS; ++e) {
        vals[ms_slot(threadIdx.x * MS_ITEMS + e)] = run;
        run += local[e];
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < MS_ITEMS; ++it) {
        const int e = it * MS_THREADS + threadIdx.x, g = lo + e;
        if (g < n) base[g] = vals[ms_slot(e)];
    }
}

}  // namespace
