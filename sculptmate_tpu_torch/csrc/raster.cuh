// K8's rasterizer, shared by its two forms: the bake form
// (raster_winner.cu: six corner rows and a key row per face) and the unwrap
// form (uv_unwrap.cu: the corners and key formed from K9's state, launched
// inside K9's chain). The form is the Loader, a template parameter:
// `ld(f, c, key)` gives face f's six corner UVs c = [u0, v0, u1, v1, u2, v2]
// and its key.
//
// For every texel (x, y) the kernel leaves in `winner` the lowest key among
// the faces whose barycentric test, with slack `margin`, covers the texel
// centre (x, y) / (res - 1); the caller fills `winner` with WINNER_SINK
// (INT_MAX) first.
//
// Design: one launch, balanced within each warp. A warp loads 32
// consecutive faces (one a lane), forms each face's terms and texel bbox,
// and takes an inclusive scan of their candidate counts (w x h; 0 for a
// face that covers nothing). It then walks the warp's flat list of
// (face, texel) candidates 32 at a time: each lane finds the face its
// candidate belongs to from a ballot over the prefix sums and a __popc
// rank, reads that face's terms from shared memory, tests the texel and
// does atomicMin of the key. A face of any size goes through the same
// loop, so a warp waits for its candidates' total, not for its largest
// face. min is commutative: the result does not depend on the order of
// the atomics.
//
// Arithmetic: the JAX program's products, sums and quotients in its order,
// each rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn: no contracted
// multiply-add moves an edge texel), and the texel centre as x * (1 /
// (res - 1)), as XLA computes the JAX program's division by that constant.
// The winner is bit-equal to the plain version's.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RW_THREADS = 256;  // 8 warps of 32 faces
constexpr unsigned RW_FULL = 0xffffffffu;
// candidates a warp walks are counted in an int: res^2 x 32 must fit
constexpr int RW_MAX_RES = 8191;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Face {
    float u0, v0, e1u, e1v, e2u, e2v, d00, d01, d11, den;
    int xlo, ylo, w, first, key;  // first: the face's first candidate in its warp's list
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// float -> int32 as the bbox needs it: clamped to [-1, res] first, so an
// out-of-range corner cannot overflow the conversion
__device__ __forceinline__ int to_index(float t, int res) { return (int)fminf(fmaxf(t, -1.f), (float)res); }

// a face's terms and texel bbox (the JAX program's, widened by the margin's
// slack); returns its candidate count, 0 where it covers nothing
__device__ __forceinline__ int make_face(const float (&c)[6], int key, int res, float mslack, bool widen, Face &fc) {
    const float u0 = c[0], v0 = c[1], u1 = c[2], v1 = c[3], u2 = c[4], v2 = c[5];
    const float s = (float)(res - 1);
    fc.u0 = u0;
    fc.v0 = v0;
    fc.e1u = sub(u1, u0);
    fc.e1v = sub(v1, v0);
    fc.e2u = sub(u2, u0);
    fc.e2v = sub(v2, v0);
    fc.d00 = add(mul(fc.e1u, fc.e1u), mul(fc.e1v, fc.e1v));
    fc.d01 = add(mul(fc.e1u, fc.e2u), mul(fc.e1v, fc.e2v));
    fc.d11 = add(mul(fc.e2u, fc.e2u), mul(fc.e2v, fc.e2v));
    fc.den = sub(mul(fc.d00, fc.d11), mul(fc.d01, fc.d01));
    fc.key = key;
    const float umin = mul(fminf(fminf(u0, u1), u2), s), umax = mul(fmaxf(fmaxf(u0, u1), u2), s);
    const float vmin = mul(fminf(fminf(v0, v1), v2), s), vmax = mul(fmaxf(fmaxf(v0, v1), v2), s);
    // the margin's slack, in texels: margin * (res - 1) * (|e1| + |e2|)
    const float slack = widen ? mul(mslack, add(__fsqrt_rn(fc.d00), __fsqrt_rn(fc.d11))) : 0.f;
    const int xlo = clampi(to_index(ceilf(sub(sub(umin, slack), 1e-3f)), res), 0, res - 1);
    const int xhi = clampi(to_index(floorf(add(add(umax, slack), 1e-3f)), res), -1, res - 1);
    const int ylo = clampi(to_index(ceilf(sub(sub(vmin, slack), 1e-3f)), res), 0, res - 1);
    const int yhi = clampi(to_index(floorf(add(add(vmax, slack), 1e-3f)), res), -1, res - 1);
    const bool finite = isfinite(u0) && isfinite(v0) && isfinite(u1) && isfinite(v1) && isfinite(u2) && isfinite(v2);
    fc.xlo = xlo;
    fc.ylo = ylo;
    fc.w = xhi - xlo + 1;
    const int h = yhi - ylo + 1;
    const bool covers = finite && fc.w > 0 && h > 0 && fabsf(fc.den) >= 1e-12f;
    return covers ? fc.w * h : 0;
}

// the barycentric test of texel (x, y), centre (x, y) * rcp
__device__ __forceinline__ bool inside(const Face &fc, int x, int y, float rcp, float mg) {
    const float gx = mul((float)x, rcp), gy = mul((float)y, rcp);
    const float pu = sub(gx, fc.u0), pv = sub(gy, fc.v0);
    const float d20 = add(mul(pu, fc.e1u), mul(pv, fc.e1v));
    const float d21 = add(mul(pu, fc.e2u), mul(pv, fc.e2v));
    const float bv = __fdiv_rn(sub(mul(fc.d11, d20), mul(fc.d01, d21)), fc.den);
    const float bw = __fdiv_rn(sub(mul(fc.d00, d21), mul(fc.d01, d20)), fc.den);
    const float bu = sub(sub(1.f, bv), bw);
    return bu >= -mg && bv >= -mg && bw >= -mg;
}

__device__ __forceinline__ void deposit(int *__restrict__ winner, int texel, int key) { atomicMin(winner + texel, key); }

template <class Loader>
__global__ void __launch_bounds__(RW_THREADS)
raster_warp(const Loader ld, int F, int res, float rcp, float mg, float mslack, bool widen, int *__restrict__ winner) {
    __shared__ Face faces[RW_THREADS];
    __shared__ int start_lane[RW_THREADS / 32][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int f = blockIdx.x * RW_THREADS + threadIdx.x;
    Face fc;
    int n = 0;
    if (f < F) {
        float c[6];
        int key;
        ld(f, c, key);
        n = make_face(c, key, res, mslack, widen, fc);
    }
    // inclusive scan of the candidate counts over the warp
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(RW_FULL, incl, o);
        if (lane >= o) incl += y;
    }
    const int excl = incl - n, total = __shfl_sync(RW_FULL, incl, 31);
    fc.first = excl;
    if (n > 0) faces[threadIdx.x] = fc;
    const Face *wf = faces + warp * 32;
    int *starts_of = start_lane[warp];
    for (int c0 = 0; c0 < total; c0 += 32) {
        // candidate c = c0 + lane belongs to the lane j with first_j <= c <
        // first_j + n_j: the face open at c0 (the faces wholly before it,
        // counted), or the last face that starts in (c0, c]
        const int o0 = __popc(__ballot_sync(RW_FULL, incl <= c0));
        const bool starts = n > 0 && excl > c0 && excl < c0 + 32;
        const unsigned starting = __ballot_sync(RW_FULL, starts);
        if (starts) starts_of[__popc(starting & ((1u << lane) - 1u))] = lane;
        const unsigned at = __reduce_or_sync(RW_FULL, starts ? 1u << (excl - c0) : 0u);
        __syncwarp();
        const int c = c0 + lane;
        if (c < total) {
            const int k = __popc(at & ((2u << lane) - 1u));  // faces starting in (c0, c]
            const Face &g = wf[k == 0 ? o0 : starts_of[k - 1]];
            const int local = c - g.first, dy = local / g.w;
            const int x = g.xlo + (local - dy * g.w), y = g.ylo + dy;
            // (a texel off the raster is never written, whatever the search gave)
            if ((unsigned)x < (unsigned)res && (unsigned)y < (unsigned)res && inside(g, x, y, rcp, mg))
                deposit(winner, y * res + x, g.key);
        }
        __syncwarp();  // the next window rewrites starts_of
    }
}

}  // namespace
