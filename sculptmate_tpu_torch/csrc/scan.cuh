// Block-wide exclusive scans shared by the marching kernels (K3, K10 in
// marching_cubes.cu, K7 in marching_tets.cu): the in-block prefix of one
// int per thread, and a single-block scan of a count array that also
// writes its sums (as ints, or as little-endian u32 wire counters).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

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

// One block: base[i] = cnt[0] + ... + cnt[i - 1] (in place when base ==
// cnt; skipped when base is null); sums[0] the total and sums[1] the
// nonzero entries (when sums is not null); the same two as little-endian
// u32 bytes at le (when le is not null).
__global__ void __launch_bounds__(SCAN_THREADS) scan_counts(const int *cnt, int n, int *base, int *sums,
                                                            uint8_t *le) {
    const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
    int s = 0, nz = 0;
    for (int i = lo; i < hi; ++i) {
        const int c = cnt[i];
        s += c;
        nz += c != 0;
    }
    int total, nonzero;
    int run = block_exclusive_scan(s, &total);
    block_exclusive_scan(nz, &nonzero);
    if (base != nullptr) {
        for (int i = lo; i < hi; ++i) {
            const int c = cnt[i];
            base[i] = run;
            run += c;
        }
    }
    if (threadIdx.x == 0) {
        if (sums != nullptr) {
            sums[0] = total;
            sums[1] = nonzero;
        }
        if (le != nullptr) {
            for (int b = 0; b < 4; ++b) {
                le[b] = (uint8_t)(((unsigned)total >> (8 * b)) & 0xFF);
                le[4 + b] = (uint8_t)(((unsigned)nonzero >> (8 * b)) & 0xFF);
            }
        }
    }
}

}  // namespace
