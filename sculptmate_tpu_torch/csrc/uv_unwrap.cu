// K9: cube-projection UV unwrap, as passes over the faces.
//
// Replaces: sculptmate_tpu/geometry/uv_unwrap_device.py:_unwrap_core (l.114)
// with _depth_round (l.56) and _sortable (l.45), the XLA program that
// unwraps every SF3D asset on an accelerator: geometric face normal -> cube
// slice, per-corner-slot normalisation, per-slice tangent means -> rotation
// angles, per-slice lo/hi normalisation, two depth-visibility rounds through
// the bake rasterizer (K8 here), atlas placement.
//
// Bound on the H100: bytes. ~0.6 M faces read their 3 corner positions and
// write 24 bytes of UVs, with ~100 bytes of per-face state passed between
// the passes: ~60 MB, ~0.02 ms at 3.35 TB/s; the two 1024^2 visibility
// rasters are K8's.
//
// Design: one thread per face in every pass; what a pass needs from all
// faces is reduced into a small array of slots (`stats`) that the next pass
// reads. Reductions never depend on the order of atomics:
// - min/max (vertex bbox, the per-corner-slot max, the slices' lo/hi and
//   depth ranges, the overlap slices' bounds) are atomicMin/atomicMax on
//   sortable ints, pre-reduced per block in shared memory;
// - the slices' tangent sums are per-block partial sums in a fixed order
//   (warp shuffles, then warps in order), summed over blocks by the wrapper
//   in a fixed order.
// The wrapper's glue between the passes (six angles from the sums, the
// prefix over the pool flags) stays on the device: nothing waits for the
// host. A slice's lo/hi are gathered by the face's slice index, so an empty
// slice (+-inf) never reaches a face.
//
// Arithmetic: the plain version's products, sums and quotients in its
// order, each rounded on its own; divisions of the JAX program by a
// constant are products with its f32 reciprocal, as XLA computes them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RASTER_RES = 1024;
constexpr int SINK = 0x7FFFFFFF;
constexpr int INF_S = 0x7F800000;                 // sortable(+inf)
constexpr int NINF_S = -0x7F800000 - 1;           // sortable(-inf)
constexpr float THIRD = 0.3333333432674408f;      // f32(1 / 3)
constexpr float SPAN = 0.8999999761581421f;       // f32(1 - 2 * 0.05)
constexpr float INSET = 0.05f;
constexpr float MARGIN_TOL = 0.02f;               // depth tolerance, share of the slice's range
// stats slots
constexpr int S_BMIN = 0, S_BMAX = 3, S_MDD = 6, S_LO = 9, S_HI = 15, S_DEPTH = 21, S_ULO = 45, S_VLO = 51,
              S_UHI = 57, S_VHI = 63;

// per cube face: projection axis, sign, u axis, u sign, v axis, v sign
__constant__ int RULES[6][6] = {
    {0, 1, 1, 1, 2, -1}, {0, -1, 1, 1, 2, -1}, {1, 1, 0, 1, 2, -1},
    {1, -1, 0, 1, 2, -1}, {2, 1, 0, 1, 1, 1}, {2, -1, 0, 1, 1, -1},
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }
__device__ __forceinline__ int sortable(float f) {
    const int i = __float_as_int(f);
    return i < 0 ? i ^ 0x7FFFFFFF : i;
}
__device__ __forceinline__ float unsortable(int s) { return __int_as_float(s < 0 ? s ^ 0x7FFFFFFF : s); }
__device__ __forceinline__ float len3(float x, float y, float z) {
    return __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
}

// block-level min/max into shared slots, then one global atomic per slot
struct SlotMinMax {
    int *lo, *hi;
    int n;
    __device__ void init() {
        for (int i = threadIdx.x; i < n; i += blockDim.x) lo[i] = INF_S, hi[i] = NINF_S;
        __syncthreads();
    }
    __device__ void put(int slot, float vlo, float vhi) {
        atomicMin(lo + slot, sortable(vlo));
        atomicMax(hi + slot, sortable(vhi));
    }
    __device__ void flush(int *glo, int *ghi) {
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            if (lo[i] != INF_S) atomicMin(glo + i, lo[i]);
            if (hi[i] != NINF_S) atomicMax(ghi + i, hi[i]);
        }
    }
};

struct Geo {
    float tri[3][3];  // [corner][axis] normalised corner positions
    float n[3];       // unit geometric normal
    float half[3], bmin[3];
    int index;        // cube slice
};

__device__ Geo geometry(const float *__restrict__ pos, int Nv, const int *__restrict__ faces, int F, int f,
                        const int *__restrict__ stats) {
    Geo g;
    float rng[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        g.bmin[d] = unsortable(stats[S_BMIN + d]);
        rng[d] = fmaxf(sub(unsortable(stats[S_BMAX + d]), g.bmin[d]), 1e-12f);
        g.half[d] = mul(rng[d], 0.5f);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const int v = faces[c * F + f];
#pragma unroll
        for (int d = 0; d < 3; ++d) g.tri[c][d] = sub(dv(mul(2.f, sub(pos[d * Nv + v], g.bmin[d])), rng[d]), 1.f);
    }
    float e1[3], e2[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        e1[d] = mul(sub(g.tri[1][d], g.tri[0][d]), g.half[d]);
        e2[d] = mul(sub(g.tri[2][d], g.tri[0][d]), g.half[d]);
    }
    float n0 = sub(mul(e1[1], e2[2]), mul(e1[2], e2[1]));
    float n1 = sub(mul(e1[2], e2[0]), mul(e1[0], e2[2]));
    float n2 = sub(mul(e1[0], e2[1]), mul(e1[1], e2[0]));
    const float nl = fmaxf(len3(n0, n1, n2), 1e-12f);
    g.n[0] = dv(n0, nl);
    g.n[1] = dv(n1, nl);
    g.n[2] = dv(n2, nl);
    // argmax over (+x, -x, +y, -y, +z, -z), the first of equal scores
    const float s[6] = {g.n[0], -g.n[0], g.n[1], -g.n[1], g.n[2], -g.n[2]};
    int best = 0;
#pragma unroll
    for (int k = 1; k < 6; ++k)
        if (s[k] > s[best]) best = k;
    g.index = best;
    return g;
}

// a[i] by selects, so the corner arrays stay in registers
__device__ __forceinline__ float pick3(const float (&a)[3], int i) { return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]); }

// the warp into the slice's cell of the 4x4 raster grid
__device__ __forceinline__ float cell(float c, float gcell) {
    return mul(add(add(mul(clamp01(c), SPAN), INSET), gcell), 0.25f);
}

__global__ void __launch_bounds__(THREADS) uw_bbox_k(const float *__restrict__ pos, int Nv, int *__restrict__ stats) {
    __shared__ int lo[3], hi[3];
    SlotMinMax mm{lo, hi, 3};
    mm.init();
    const int v = blockIdx.x * blockDim.x + threadIdx.x;
    if (v < Nv)
        for (int d = 0; d < 3; ++d) mm.put(d, pos[d * Nv + v], pos[d * Nv + v]);
    mm.flush(stats + S_BMIN, stats + S_BMAX);
}

__global__ void __launch_bounds__(THREADS)
uw_faces_index_k(const float *__restrict__ pos, int Nv, const int *__restrict__ faces, int F,
                 int *__restrict__ stats, int *__restrict__ index, float *__restrict__ depth) {
    __shared__ int mdd[3];
    if (threadIdx.x < 3) mdd[threadIdx.x] = 0;
    __syncthreads();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f < F) {
        const Geo g = geometry(pos, Nv, faces, F, f, stats);
        const int ax = RULES[g.index][0];
        index[f] = g.index;
        depth[f] = mul(mul((float)RULES[g.index][1], add(add(pick3(g.tri[0], ax), pick3(g.tri[1], ax)), pick3(g.tri[2], ax))), THIRD);
        // the reference's quirk: each corner slot normalised by its max over all faces
        for (int c = 0; c < 3; ++c) atomicMax(mdd + c, __float_as_int(fabsf(pick3(g.tri[c], ax))));
    }
    __syncthreads();
    if (threadIdx.x < 3) atomicMax(stats + S_MDD + threadIdx.x, mdd[threadIdx.x]);
}

__global__ void __launch_bounds__(THREADS)
uw_faces_project_k(const float *__restrict__ pos, int Nv, const int *__restrict__ faces, int F,
                   const int *__restrict__ stats, const int *__restrict__ index, float *__restrict__ uv,
                   float *__restrict__ partial) {
    __shared__ float warp_sums[THREADS / 32][6][7];
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    float vals[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int slice = -1;
    if (f < F) {
        const Geo g = geometry(pos, Nv, faces, F, f, stats);
        slice = index[f];
        const int *r = RULES[slice];
        const float us = (float)r[3], vs = (float)r[5];
        float uc[3], vc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float mdd = __int_as_float(stats[S_MDD + c]);
            uc[c] = clamp01(mul(add(dv(mul(us, pick3(g.tri[c], r[2])), mdd), 1.f), 0.5f));
            vc[c] = clamp01(mul(add(dv(mul(vs, pick3(g.tri[c], r[4])), mdd), 1.f), 0.5f));
            uv[c * F + f] = uc[c];
            uv[(3 + c) * F + f] = vc[c];
        }
        // the face's tangent from its UV gradient, Gram-Schmidt against n
        const float du1 = sub(uc[1], uc[0]), dv1 = sub(vc[1], vc[0]);
        const float du2 = sub(uc[2], uc[0]), dv2 = sub(vc[2], vc[0]);
        const float den = fmaxf(sub(mul(du1, dv2), mul(dv1, du2)), 1e-6f);
        float t[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
            t[d] = dv(sub(mul(sub(g.tri[1][d], g.tri[0][d]), dv2), mul(sub(g.tri[2][d], g.tri[0][d]), dv1)), den);
        float tl = fmaxf(len3(t[0], t[1], t[2]), 1e-12f);
#pragma unroll
        for (int d = 0; d < 3; ++d) t[d] = dv(t[d], tl);
        const float nd = add(add(mul(t[0], g.n[0]), mul(t[1], g.n[1])), mul(t[2], g.n[2]));
#pragma unroll
        for (int d = 0; d < 3; ++d) t[d] = sub(t[d], mul(nd, g.n[d]));
        tl = fmaxf(len3(t[0], t[1], t[2]), 1e-12f);
        // the expected tangent cross(n, cross(pos_rot, n)), pos_rot = (-y, x, 0), per corner
        float em[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float praw[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) praw[d] = add(mul(add(g.tri[c][d], 1.f), g.half[d]), g.bmin[d]);
            const float prx = -praw[1], pry = praw[0];
            const float cx = mul(pry, g.n[2]), cy = mul(-prx, g.n[2]);
            const float cz = sub(mul(prx, g.n[1]), mul(pry, g.n[0]));
            const float ex = sub(mul(g.n[1], cz), mul(g.n[2], cy));
            const float ey = sub(mul(g.n[2], cx), mul(g.n[0], cz));
            const float ez = sub(mul(g.n[0], cy), mul(g.n[1], cx));
            const float el = fmaxf(len3(ex, ey, ez), 1e-12f);
            const float e[3] = {dv(ex, el), dv(ey, el), dv(ez, el)};
#pragma unroll
            for (int d = 0; d < 3; ++d) em[d] = c == 0 ? e[d] : add(em[d], e[d]);
        }
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            vals[d] = dv(t[d], tl);
            vals[3 + d] = mul(em[d], THIRD);
        }
        vals[6] = 1.f;
    }
    // per-slice partial sums of this block, in a fixed order
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int s = 0; s < 6; ++s)
        for (int k = 0; k < 7; ++k) {
            float x = slice == s ? vals[k] : 0.f;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) x = add(x, __shfl_down_sync(0xFFFFFFFFu, x, o));
            if (lane == 0) warp_sums[warp][s][k] = x;
        }
    __syncthreads();
    if (threadIdx.x < 42) {
        const int s = threadIdx.x / 7, k = threadIdx.x % 7;
        float x = warp_sums[0][s][k];
        for (int w = 1; w < THREADS / 32; ++w) x = add(x, warp_sums[w][s][k]);
        partial[blockIdx.x * 42 + threadIdx.x] = x;
    }
}

// rotate each slice by its angle; the slices' lo/hi over both components
__global__ void __launch_bounds__(THREADS)
uw_faces_rotate_k(float *__restrict__ uv, int F, const int *__restrict__ index, const float *__restrict__ angles,
                  int *__restrict__ stats) {
    __shared__ int lo[6], hi[6];
    SlotMinMax mm{lo, hi, 6};
    mm.init();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f < F) {
        const int s = index[f];
        const float ca = angles[s], sa = angles[6 + s];
        float mn = INFINITY, mx = -INFINITY;
        for (int c = 0; c < 3; ++c) {
            const float cu = sub(mul(uv[c * F + f], 2.f), 1.f), cv = sub(mul(uv[(3 + c) * F + f], 2.f), 1.f);
            const float ru = sub(mul(ca, cu), mul(sa, cv)), rv = add(mul(sa, cu), mul(ca, cv));
            uv[c * F + f] = ru;
            uv[(3 + c) * F + f] = rv;
            mn = fminf(mn, fminf(ru, rv));
            mx = fmaxf(mx, fmaxf(ru, rv));
        }
        mm.put(s, mn, mx);
    }
    mm.flush(stats + S_LO, stats + S_HI);
}

// K8's inputs for one visibility round (round 0 first normalises the slices
// by their lo/hi, gathered by slice index), and the participants' depth
// range per slice
__global__ void __launch_bounds__(THREADS)
uw_round_prepare_k(float *__restrict__ uv, int F, const int *__restrict__ index, const float *__restrict__ depth,
                   const uint8_t *__restrict__ vis, int round, float *__restrict__ corners, int *__restrict__ key,
                   int *__restrict__ stats) {
    __shared__ int lo[6], hi[6];
    SlotMinMax mm{lo, hi, 6};
    mm.init();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f < F) {
        const int s = index[f];
        if (round == 0) {
            const float l = unsortable(stats[S_LO + s]), h = unsortable(stats[S_HI + s]);
            const float scale = fmaxf(sub(h, l), 1e-12f);
            for (int k = 0; k < 6; ++k) uv[k * F + f] = dv(sub(uv[k * F + f], l), scale);
        }
        const bool part = round == 0 || !vis[f];
        const float gx = (float)(s % 4), gy = (float)(s / 4);
        for (int c = 0; c < 3; ++c) {
            corners[(2 * c) * F + f] = part ? cell(uv[c * F + f], gx) : 0.f;
            corners[(2 * c + 1) * F + f] = part ? cell(uv[(3 + c) * F + f], gy) : 0.f;
        }
        key[f] = part ? ~sortable(depth[f]) : SINK - 1;
        if (part) mm.put(s, depth[f], depth[f]);
    }
    mm.flush(stats + S_DEPTH + 12 * round, stats + S_DEPTH + 12 * round + 6);
}

// a face is visible unless the winner at its centroid texel lies in front
// of it by more than the slice's depth tolerance
__global__ void __launch_bounds__(THREADS)
uw_round_visible_k(const float *__restrict__ uv, int F, const int *__restrict__ index,
                   const float *__restrict__ depth, const int *__restrict__ winner, const int *__restrict__ stats,
                   int round, uint8_t *__restrict__ vis) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const int s = index[f];
    const float dmin = unsortable(stats[S_DEPTH + 12 * round + s]);
    const float dmax = unsortable(stats[S_DEPTH + 12 * round + 6 + s]);
    const float eps = mul(MARGIN_TOL, fmaxf(sub(dmax, dmin), 1e-6f));
    const float gx = (float)(s % 4), gy = (float)(s / 4);
    const float cu = cell(mul(add(add(uv[f], uv[F + f]), uv[2 * F + f]), THIRD), gx);
    const float cv = cell(mul(add(add(uv[3 * F + f], uv[4 * F + f]), uv[5 * F + f]), THIRD), gy);
    const float smax = (float)(RASTER_RES - 1);
    const int cx = min(max((int)rintf(mul(cu, smax)), 0), RASTER_RES - 1);
    const int cy = min(max((int)rintf(mul(cv, smax)), 0), RASTER_RES - 1);
    const int wkey = winner[cy * RASTER_RES + cx];
    const bool covered = wkey < SINK - 1;
    vis[round * F + f] = !covered || unsortable(~wkey) <= add(depth[f], eps);
}

// atlas index = slice + 6 x visibility class; the overlap slices' bounds
__global__ void __launch_bounds__(THREADS)
uw_atlas_k(const float *__restrict__ uv, int F, const int *__restrict__ index, const uint8_t *__restrict__ vis,
           int *__restrict__ atlas, int *__restrict__ stats) {
    __shared__ int ulo[6], uhi[6], vlo[6], vhi[6];
    SlotMinMax mu{ulo, uhi, 6}, mv{vlo, vhi, 6};
    mu.init();
    mv.init();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f < F) {
        const int s = index[f];
        const int a = vis[f] ? s : (vis[F + f] ? s + 6 : s + 12);
        atlas[f] = a;
        if (a >= 6 && a < 12) {
            const float *u = uv + f, *v = uv + 3 * F + f;
            mu.put(a - 6, fminf(fminf(u[0], u[F]), u[2 * F]), fmaxf(fmaxf(u[0], u[F]), u[2 * F]));
            mv.put(a - 6, fminf(fminf(v[0], v[F]), v[2 * F]), fmaxf(fmaxf(v[0], v[F]), v[2 * F]));
        }
    }
    mu.flush(stats + S_ULO, stats + S_UHI);
    mv.flush(stats + S_VLO, stats + S_VHI);
}

__device__ __forceinline__ float place(float c, float lo, float hi, float cval, float nf, float w, float cell_off,
                                       float pad, float one_m_pad, float half_pad) {
    float r = dv(sub(c, lo), fmaxf(sub(hi, lo), cval));
    r = clamp01(add(mul(r, sub(1.f, mul(mul(pad, nf), 0.5f))), mul(mul(pad, nf), 0.25f)));
    r = add(mul(r, w), cell_off);
    return clamp01(add(mul(r, one_m_pad), half_pad));
}

// placement -> out (F, 6) [u0, v0, u1, v1, u2, v2]
__global__ void __launch_bounds__(THREADS)
uw_place_k(const float *__restrict__ uv, int F, const int *__restrict__ atlas, const int *__restrict__ ids,
           const int *__restrict__ n_rem, const int *__restrict__ stats, float pad, float one_m_2pad,
           float one_m_pad, float half_pad, float *__restrict__ out) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const int a = atlas[f], block = a / 6, s = a % 6;
    const bool pool = a >= 12;
    float uc[3], vc[3];
    for (int c = 0; c < 3; ++c) uc[c] = uv[c * F + f], vc[c] = uv[(3 + c) * F + f];
    if (a >= 6 && !pool) {  // overlap slices: rescaled to fill their cell, at most 2x
        const int o = a - 6;
        const float ul = unsortable(stats[S_ULO + o]), uh = unsortable(stats[S_UHI + o]);
        const float vl = unsortable(stats[S_VLO + o]), vh = unsortable(stats[S_VHI + o]);
        for (int c = 0; c < 3; ++c) {
            uc[c] = dv(sub(uc[c], ul), fmaxf(sub(uh, ul), 0.5f));
            vc[c] = dv(sub(vc[c], vl), fmaxf(sub(vh, vl), 0.5f));
        }
    }
    for (int c = 0; c < 3; ++c) {
        uc[c] = clamp01(add(mul(uc[c], one_m_2pad), pad));
        vc[c] = clamp01(add(mul(vc[c], one_m_2pad), pad));
    }
    if (pool) {  // individual squares, the reference's pool layout
        const int n = *n_rem;
        const float mult = __fsqrt_rn(mul(fmaxf((float)n, 1.f), 6.f));
        const int nw = max((int)ceilf(mul(0.5f, mult)), 1);
        const int nh = max((n + nw - 1) / nw, 1);
        const float nwf = (float)nw, nhf = (float)nh;
        const float width = dv(1.f, nwf), height = dv(1.f, nhf);
        const float cval = mul(fminf(width, height), 1.5f);
        const float id = (float)(ids[f] - 1);
        const float col = mul(fmodf(id, nwf), width), row = mul(floorf(dv(id, nwf)), height);
        const float ulo = fminf(fminf(uc[0], uc[1]), uc[2]), uhi = fmaxf(fmaxf(uc[0], uc[1]), uc[2]);
        const float vlo = fminf(fminf(vc[0], vc[1]), vc[2]), vhi = fmaxf(fmaxf(vc[0], vc[1]), vc[2]);
        for (int c = 0; c < 3; ++c) {
            uc[c] = place(uc[c], ulo, uhi, cval, nwf, width, col, pad, one_m_pad, half_pad);
            vc[c] = place(vc[c], vlo, vhi, cval, nhf, height, row, pad, one_m_pad, half_pad);
        }
    }
    const float xs[6] = {0.f, 1.f, 2.f, 0.f, 1.f, 2.f}, ys[6] = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
    const float xv = pool ? 0.f : xs[s], yv = pool ? 0.f : ys[s];
    const float off = THIRD, dupl = 0.1666666716337204f, off2 = 0.6666666865348816f;
    const float offset_x = block == 0 ? mul(off, xv) : add(mul(dupl, xv), mul((float)min(block - 1, 1), 0.5f));
    const float offset_y = block == 0 ? mul(off, yv) : add(mul(dupl, yv), off2);
    const float div_x = pool ? 2.f : (a >= 6 ? 6.f : 3.f), div_y = pool ? 3.f : (a >= 6 ? 6.f : 3.f);
    for (int c = 0; c < 3; ++c) {
        out[(size_t)f * 6 + 2 * c] = add(dv(uc[c], div_x), offset_x);
        out[(size_t)f * 6 + 2 * c + 1] = add(dv(vc[c], div_y), offset_y);
    }
}

inline int blocks(int n) { return n > 0 ? (n + THREADS - 1) / THREADS : 0; }
inline cudaStream_t st(void *s) { return reinterpret_cast<cudaStream_t>(s); }

}  // namespace

// Each entry launches one pass on `stream` and returns a cudaError_t (0 on
// success). Layouts: pos (3, Nv) f32; faces (3, F) i32; uv (6, F) f32 rows
// [u0, u1, u2, v0, v1, v2]; stats as the wrapper initialises them.

extern "C" int uw_bbox(const void *pos, int Nv, void *stats, void *stream) {
    if (Nv > 0)
        uw_bbox_k<<<blocks(Nv), THREADS, 0, st(stream)>>>(static_cast<const float *>(pos), Nv, static_cast<int *>(stats));
    return (int)cudaGetLastError();
}

extern "C" int uw_faces_index(const void *pos, int Nv, const void *faces, int F, void *stats, void *index,
                              void *depth, void *stream) {
    if (F > 0)
        uw_faces_index_k<<<blocks(F), THREADS, 0, st(stream)>>>(
            static_cast<const float *>(pos), Nv, static_cast<const int *>(faces), F, static_cast<int *>(stats),
            static_cast<int *>(index), static_cast<float *>(depth));
    return (int)cudaGetLastError();
}

extern "C" int uw_faces_project(const void *pos, int Nv, const void *faces, int F, const void *stats,
                                const void *index, void *uv, void *partial, void *stream) {
    if (F > 0)
        uw_faces_project_k<<<blocks(F), THREADS, 0, st(stream)>>>(
            static_cast<const float *>(pos), Nv, static_cast<const int *>(faces), F,
            static_cast<const int *>(stats), static_cast<const int *>(index), static_cast<float *>(uv),
            static_cast<float *>(partial));
    return (int)cudaGetLastError();
}

extern "C" int uw_faces_rotate(void *uv, int F, const void *index, const void *angles, void *stats, void *stream) {
    if (F > 0)
        uw_faces_rotate_k<<<blocks(F), THREADS, 0, st(stream)>>>(static_cast<float *>(uv), F,
                                                                 static_cast<const int *>(index),
                                                                 static_cast<const float *>(angles),
                                                                 static_cast<int *>(stats));
    return (int)cudaGetLastError();
}

extern "C" int uw_round_prepare(void *uv, int F, const void *index, const void *depth, const void *vis, int round,
                                void *corners, void *key, void *stats, void *stream) {
    if (F > 0)
        uw_round_prepare_k<<<blocks(F), THREADS, 0, st(stream)>>>(
            static_cast<float *>(uv), F, static_cast<const int *>(index), static_cast<const float *>(depth),
            static_cast<const uint8_t *>(vis), round, static_cast<float *>(corners), static_cast<int *>(key),
            static_cast<int *>(stats));
    return (int)cudaGetLastError();
}

extern "C" int uw_round_visible(const void *uv, int F, const void *index, const void *depth, const void *winner,
                                const void *stats, int round, void *vis, void *stream) {
    if (F > 0)
        uw_round_visible_k<<<blocks(F), THREADS, 0, st(stream)>>>(
            static_cast<const float *>(uv), F, static_cast<const int *>(index), static_cast<const float *>(depth),
            static_cast<const int *>(winner), static_cast<const int *>(stats), round, static_cast<uint8_t *>(vis));
    return (int)cudaGetLastError();
}

extern "C" int uw_atlas(const void *uv, int F, const void *index, const void *vis, void *atlas, void *stats,
                        void *stream) {
    if (F > 0)
        uw_atlas_k<<<blocks(F), THREADS, 0, st(stream)>>>(static_cast<const float *>(uv), F,
                                                          static_cast<const int *>(index),
                                                          static_cast<const uint8_t *>(vis),
                                                          static_cast<int *>(atlas), static_cast<int *>(stats));
    return (int)cudaGetLastError();
}

extern "C" int uw_place(const void *uv, int F, const void *atlas, const void *ids, const void *n_rem,
                        const void *stats, float pad, float one_m_2pad, float one_m_pad, float half_pad, void *out,
                        void *stream) {
    if (F > 0)
        uw_place_k<<<blocks(F), THREADS, 0, st(stream)>>>(
            static_cast<const float *>(uv), F, static_cast<const int *>(atlas), static_cast<const int *>(ids),
            static_cast<const int *>(n_rem), static_cast<const int *>(stats), pad, one_m_2pad, one_m_pad, half_pad,
            static_cast<float *>(out));
    return (int)cudaGetLastError();
}
