// K9: cube-projection UV unwrap, as a short chain of fused face passes.
//
// Replaces: sculptmate_tpu/geometry/uv_unwrap_device.py:_unwrap_core (l.114)
// with _depth_round (l.56) and _sortable (l.45), the XLA program that
// unwraps every SF3D asset on an accelerator: geometric face normal -> cube
// slice, per-corner-slot normalisation, per-slice tangent means -> rotation
// angles, per-slice lo/hi normalisation, two depth-visibility rounds through
// the bake rasterizer (K8's unwrap form here), atlas placement.
//
// Bound on the H100: bytes. ~0.6 M faces read their 3 corner positions and
// write 24 bytes of UVs, with ~100 bytes of per-face state passed between
// the passes: ~60 MB, ~0.02 ms at 3.35 TB/s; the two 1024^2 visibility
// rasters are K8's.
//
// Design: one call (uw_unwrap) launches the whole chain on the stream, with
// one grid-wide dependency between each pair of passes and no PyTorch op
// between them:
//   0. a copy of STATS_INIT (the slots' identities, zeroed counters) into
//      the call's stats: every slot a pass reduces into holds its identity
//      before the first pass starts;
//   1. init_bbox: both 1024^2 winners filled with WINNER_SINK, the scan's
//      status words and the epilogue's group tickets zeroed, the vertex
//      bbox;
//   2. faces_index: each face's slice and depth, the per-corner-slot max
//      (the reference's quirk) and round 0's per-slice depth range (all
//      faces take part);
//   3. faces_project: the projected UVs and, per slice, the sums of the
//      faces' tangents and expected tangents in a fixed order; the last
//      block to finish turns the sums into the six angles (cos, sin);
//   4. faces_rotate: the rotation and each slice's lo/hi;
//   5. K8's unwrap form, round 0 (raster.cuh with the Round loader);
//   6. visible, round 0: each face at its centroid texel, and round 1's
//      per-slice depth range over the faces it hides;
//   7. K8's unwrap form, round 1, over the faces round 0 hid;
//   8. atlas: round 1's visibility, the atlas index, the overlap slices'
//      bounds and the pool flags (one bit a face);
//   9. the pool prefix: scan.cuh's scan_segments over the flag words;
//  10. place.
// The per-face UVs are written twice (project, rotate). Every later pass
// normalises a face's rotated UVs by its slice's lo/hi on load, with the
// same operations the rows were normalised with, so the values are the
// same bits; an empty slice's +-inf is never gathered.
//
// Reductions never depend on the order of atomics: min/max (vertex bbox,
// the per-corner-slot max, the slices' lo/hi and depth ranges, the overlap
// slices' bounds) are atomicMin/atomicMax on sortable ints, reduced per warp
// first; the slices' tangent sums are per-block partial sums in a fixed
// order, then per group of EPI_GROUP blocks and over the groups, each by
// the last block to finish its level (a __threadfence and a ticket), rows
// in order.
//
// Arithmetic: the plain version's products, sums and quotients in its
// order, each rounded on its own; divisions of the JAX program by a
// constant are products with its f32 reciprocal, as XLA computes them.

#include <stdint.h>

#include "raster.cuh"
#include "scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RASTER_RES = 1024;
constexpr int RASTER_TEXELS = RASTER_RES * RASTER_RES;
constexpr int SINK = 0x7FFFFFFF;
constexpr int INF_S = 0x7F800000;                 // sortable(+inf)
constexpr int NINF_S = -0x7F800000 - 1;           // sortable(-inf)
constexpr float THIRD = 0.3333333432674408f;      // f32(1 / 3)
constexpr float SPAN = 0.8999999761581421f;       // f32(1 - 2 * 0.05)
constexpr float INSET = 0.05f;
constexpr double MARGIN = 0.05;                   // the visibility rasters' barycentric slack
constexpr float MARGIN_TOL = 0.02f;               // depth tolerance, share of the slice's range
constexpr int NSUM = 42;                          // per slice: tangent xyz, expected tangent xyz, count
constexpr int EPI_GROUP = 64;                     // block rows summed by each group's last block
constexpr int INIT_BLOCKS = 512;                  // init_bbox's grid (grid-stride: few bbox atomics)
// stats slots: bbox, the per-corner-slot max, the rotated lo/hi, the depth
// range of each round, the overlap slices' u/v bounds, then the counters
constexpr int S_BMIN = 0, S_BMAX = 3, S_MDD = 6, S_LO = 9, S_HI = 15, S_DEPTH = 21, S_ULO = 45, S_VLO = 51,
              S_UHI = 57, S_VHI = 63, S_TICKET = 69, S_NREM = 70, S_TILE = 71, STATS = 72;

__constant__ int RULES[6][6] = {
    {0, 1, 1, 1, 2, -1}, {0, -1, 1, 1, 2, -1}, {1, 1, 0, 1, 2, -1},
    {1, -1, 0, 1, 2, -1}, {2, 1, 0, 1, 1, 1}, {2, -1, 0, 1, 1, -1},
};  // per cube face: projection axis, sign, u axis, u sign, v axis, v sign

#define SIX(x) x, x, x, x, x, x
__constant__ int STATS_INIT[STATS] = {
    INF_S, INF_S, INF_S, NINF_S, NINF_S, NINF_S,      // bbox
    0, 0, 0,                                          // per-corner-slot max (of |x|)
    SIX(INF_S), SIX(NINF_S),                          // rotated lo, hi
    SIX(INF_S), SIX(NINF_S), SIX(INF_S), SIX(NINF_S), // depth min, max of round 0, round 1
    SIX(INF_S), SIX(INF_S), SIX(NINF_S), SIX(NINF_S), // overlap ulo, vlo, uhi, vhi
    0, 0, 0,                                          // epilogue ticket, pool count, scan tile counter
};
#undef SIX

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
__device__ __forceinline__ unsigned lanes_below() { return (1u << (threadIdx.x & 31)) - 1u; }

// this warp's min of lo and max of hi for each slot in [0, n) that one of
// its lanes names (slot -1: none) into the block's shared slots; every lane
// of the warp calls it
__device__ __forceinline__ void warp_minmax(int *slo, int *shi, int n, int slot, int lo, int hi) {
    for (int s = 0; s < n; ++s) {
        const bool mine = slot == s;
        if (!__any_sync(RW_FULL, mine)) continue;
        const int l = __reduce_min_sync(RW_FULL, mine ? lo : INF_S);
        const int h = __reduce_max_sync(RW_FULL, mine ? hi : NINF_S);
        if ((threadIdx.x & 31) == 0) {
            atomicMin(slo + s, l);
            atomicMax(shi + s, h);
        }
    }
}

// n min/max slot pairs in shared memory, flushed once per block
template <int N>
struct BlockMinMax {
    int lo[N], hi[N];
    __device__ void init() {
        for (int i = threadIdx.x; i < N; i += blockDim.x) lo[i] = INF_S, hi[i] = NINF_S;
        __syncthreads();
    }
    __device__ void put(int slot, float vlo, float vhi) { warp_minmax(lo, hi, N, slot, sortable(vlo), sortable(vhi)); }
    __device__ void flush(int *glo, int *ghi) {
        __syncthreads();
        for (int i = threadIdx.x; i < N; i += blockDim.x) {
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

struct Mesh {
    const float *px, *py, *pz;
    const int *fa, *fb, *fc;
    int F;
};

__device__ Geo geometry(const Mesh &m, int f, const int *__restrict__ stats) {
    Geo g;
    float rng[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        g.bmin[d] = unsortable(stats[S_BMIN + d]);
        rng[d] = fmaxf(sub(unsortable(stats[S_BMAX + d]), g.bmin[d]), 1e-12f);
        g.half[d] = mul(rng[d], 0.5f);
    }
    // read-only gathers (the struct's pointers carry no __restrict__)
    const int vid[3] = {__ldg(m.fa + f), __ldg(m.fb + f), __ldg(m.fc + f)};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const float p[3] = {__ldg(m.px + vid[c]), __ldg(m.py + vid[c]), __ldg(m.pz + vid[c])};
#pragma unroll
        for (int d = 0; d < 3; ++d) g.tri[c][d] = sub(dv(mul(2.f, sub(p[d], g.bmin[d])), rng[d]), 1.f);
    }
    float e1[3], e2[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        e1[d] = mul(sub(g.tri[1][d], g.tri[0][d]), g.half[d]);
        e2[d] = mul(sub(g.tri[2][d], g.tri[0][d]), g.half[d]);
    }
    const float n0 = sub(mul(e1[1], e2[2]), mul(e1[2], e2[1]));
    const float n1 = sub(mul(e1[2], e2[0]), mul(e1[0], e2[2]));
    const float n2 = sub(mul(e1[0], e2[1]), mul(e1[1], e2[0]));
    const float nl = fmaxf(len3(n0, n1, n2), 1e-12f);
    g.n[0] = dv(n0, nl);
    g.n[1] = dv(n1, nl);
    g.n[2] = dv(n2, nl);
    // argmax over (+x, -x, +y, -y, +z, -z), the first of equal scores
    const float s[6] = {g.n[0], -g.n[0], g.n[1], -g.n[1], g.n[2], -g.n[2]};
    int best = 0;
    float top = s[0];
#pragma unroll
    for (int k = 1; k < 6; ++k)
        if (s[k] > top) top = s[k], best = k;
    g.index = best;
    return g;
}

// a[i] by selects, so the corner arrays stay in registers
__device__ __forceinline__ float pick3(const float (&a)[3], int i) { return i == 0 ? a[0] : (i == 1 ? a[1] : a[2]); }

// the warp into the slice's cell of the 4x4 raster grid
__device__ __forceinline__ float cell(float c, float gcell) {
    return mul(add(add(mul(clamp01(c), SPAN), INSET), gcell), 0.25f);
}

// face f's rotated UVs normalised by its slice's lo/hi: uc[3], vc[3]
__device__ __forceinline__ void normalised(const float *__restrict__ uv, int F, int f, int s,
                                           const int *__restrict__ stats, float (&uc)[3], float (&vc)[3]) {
    const float l = unsortable(stats[S_LO + s]), h = unsortable(stats[S_HI + s]);
    const float scale = fmaxf(sub(h, l), 1e-12f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        uc[c] = dv(sub(uv[c * F + f], l), scale);
        vc[c] = dv(sub(uv[(3 + c) * F + f], l), scale);
    }
}

__device__ __forceinline__ bool bit(const unsigned *__restrict__ words, int f) { return (words[f >> 5] >> (f & 31)) & 1u; }

// K8's unwrap form: a face's corners and key for one visibility round,
// from K9's state. Round 0's participants are all the faces, round 1's the
// faces round 0 hid; a non-participant gets zero corners (a degenerate face
// that covers nothing) and the key SINK - 1.
struct Round {
    const float *uv;
    const int *index, *stats;
    const float *depth;
    const unsigned *vis0;  // round 0's visibility bits, read in round 1
    int F, round;
    __device__ __forceinline__ void operator()(int f, float (&c)[6], int &key) const {
        if (round == 1 && bit(vis0, f)) {  // not in this round: nothing more to read
#pragma unroll
            for (int k = 0; k < 6; ++k) c[k] = 0.f;
            key = SINK - 1;
            return;
        }
        const int s = index[f];
        float uc[3], vc[3];
        normalised(uv, F, f, s, stats, uc, vc);
        const float gx = (float)(s % 4), gy = (float)(s / 4);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            c[2 * k] = cell(uc[k], gx);
            c[2 * k + 1] = cell(vc[k], gy);
        }
        key = ~sortable(depth[f]);
    }
};

// a face is hidden where the winner at its centroid texel lies in front of
// it by more than the slice's depth tolerance
__device__ __forceinline__ bool visible_at(const float (&uc)[3], const float (&vc)[3], int s, float depth,
                                           const int *__restrict__ winner, const int *__restrict__ range) {
    const float dmin = unsortable(range[s]), dmax = unsortable(range[6 + s]);
    const float eps = mul(MARGIN_TOL, fmaxf(sub(dmax, dmin), 1e-6f));
    const float gx = (float)(s % 4), gy = (float)(s / 4);
    const float cu = cell(mul(add(add(uc[0], uc[1]), uc[2]), THIRD), gx);
    const float cv = cell(mul(add(add(vc[0], vc[1]), vc[2]), THIRD), gy);
    const float smax = (float)(RASTER_RES - 1);
    const int cx = min(max((int)rintf(mul(cu, smax)), 0), RASTER_RES - 1);
    const int cy = min(max((int)rintf(mul(cv, smax)), 0), RASTER_RES - 1);
    const int wkey = winner[cy * RASTER_RES + cx];
    return wkey >= SINK - 1 || unsortable(~wkey) <= add(depth, eps);
}

__global__ void __launch_bounds__(THREADS)
uw_init_bbox_k(Mesh m, int Nv, int *__restrict__ stats, int4 *__restrict__ winners, int *__restrict__ zeroed,
               int nzeroed) {
    __shared__ BlockMinMax<3> mm;
    mm.init();
    const int stride = gridDim.x * blockDim.x, t = blockIdx.x * blockDim.x + threadIdx.x;
    const int4 sink = make_int4(SINK, SINK, SINK, SINK);
    for (int i = t; i < 2 * RASTER_TEXELS / 4; i += stride) winners[i] = sink;
    for (int i = t; i < nzeroed; i += stride) zeroed[i] = 0;
    float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int v = t; v < Nv; v += stride) {
        const float p[3] = {m.px[v], m.py[v], m.pz[v]};
#pragma unroll
        for (int d = 0; d < 3; ++d) lo[d] = fminf(lo[d], p[d]), hi[d] = fmaxf(hi[d], p[d]);
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) mm.put(d, lo[d], hi[d]);
    mm.flush(stats + S_BMIN, stats + S_BMAX);
}

__global__ void __launch_bounds__(THREADS)
uw_faces_index_k(Mesh m, int *__restrict__ stats, int *__restrict__ index, float *__restrict__ depth) {
    __shared__ BlockMinMax<6> range;
    __shared__ int mdd[3];
    range.init();
    if (threadIdx.x < 3) mdd[threadIdx.x] = 0;
    __syncthreads();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    int slice = -1;
    float dep = 0.f, a[3] = {0.f, 0.f, 0.f};
    if (f < m.F) {
        const Geo g = geometry(m, f, stats);
        const int ax = RULES[g.index][0];
        slice = g.index;
        dep = mul(mul((float)RULES[slice][1], add(add(pick3(g.tri[0], ax), pick3(g.tri[1], ax)), pick3(g.tri[2], ax))),
                  THIRD);
        index[f] = slice;
        depth[f] = dep;
#pragma unroll
        for (int c = 0; c < 3; ++c) a[c] = fabsf(pick3(g.tri[c], ax));
    }
    // the reference's quirk: each corner slot normalised by its max over all faces
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        const int x = __reduce_max_sync(RW_FULL, __float_as_int(a[c]));
        if ((threadIdx.x & 31) == 0) atomicMax(mdd + c, x);
    }
    range.put(slice, dep, dep);  // round 0: every face takes part
    range.flush(stats + S_DEPTH, stats + S_DEPTH + 6);
    if (threadIdx.x < 3) atomicMax(stats + S_MDD + threadIdx.x, mdd[threadIdx.x]);
}

// rows of NSUM floats, [from, to) in order, into `out` (block-wide; the
// first NSUM threads write)
__device__ void sum_rows(const float *__restrict__ rows, int from, int to, float *__restrict__ out) {
    __shared__ float part[THREADS / NSUM][NSUM];
    constexpr int CHAINS = THREADS / NSUM;  // 6 chains of rows a value, each in order
    const int j = threadIdx.x % NSUM, chain = threadIdx.x / NSUM;
    if (chain < CHAINS) {
        float x = 0.f;
        for (int r = from + chain; r < to; r += CHAINS) x = add(x, __ldcg(rows + (size_t)r * NSUM + j));
        part[chain][j] = x;
    }
    __syncthreads();
    if (threadIdx.x < NSUM) {
        float x = part[0][j];
        for (int c = 1; c < CHAINS; ++c) x = add(x, part[c][j]);
        out[j] = x;
    }
    __syncthreads();
}

// each slice's angle between its mean tangent and mean expected tangent
__device__ void angles_from(const float (&sums)[NSUM], float *__restrict__ angles) {
    if (threadIdx.x >= 6) return;
    const float *r = sums + threadIdx.x * 7;
    const float cnt = fmaxf(r[6], 1e-12f);
    const float am[3] = {dv(r[0], cnt), dv(r[1], cnt), dv(r[2], cnt)};
    const float em[3] = {dv(r[3], cnt), dv(r[4], cnt), dv(r[5], cnt)};
    const float dot = add(add(mul(am[0], em[0]), mul(am[1], em[1])), mul(am[2], em[2]));
    const float cross2 = sub(mul(am[0], em[1]), mul(am[1], em[0]));
    const float ang = atan2f(cross2, dot);
    angles[threadIdx.x] = cosf(ang);
    angles[6 + threadIdx.x] = sinf(ang);
}

__global__ void __launch_bounds__(THREADS)
uw_faces_project_k(Mesh m, int *__restrict__ stats, const int *__restrict__ index, float *__restrict__ uv,
                   float *__restrict__ rows, float *__restrict__ group_rows, int *__restrict__ group_ticket,
                   float *__restrict__ angles) {
    __shared__ float warp_sums[THREADS / 32][NSUM];
    __shared__ float sums[NSUM];
    __shared__ bool last;
    const int F = m.F, f = blockIdx.x * blockDim.x + threadIdx.x;
    float vals[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int slice = -1;
    if (f < F) {
        const Geo g = geometry(m, f, stats);
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
    // this block's per-slice sums in a fixed order: a shuffle tree for each
    // slice some lane of the warp has, then the warps in order
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int s = 0; s < 6; ++s) {
        const bool has = __any_sync(RW_FULL, slice == s);
#pragma unroll
        for (int k = 0; k < 7; ++k) {
            float x = slice == s ? vals[k] : 0.f;
            if (has) {
#pragma unroll
                for (int o = 16; o > 0; o >>= 1) x = add(x, __shfl_down_sync(RW_FULL, x, o));
            }
            if (lane == 0) warp_sums[warp][s * 7 + k] = x;
        }
    }
    __syncthreads();
    const int nblk = gridDim.x, group = blockIdx.x / EPI_GROUP, ngroups = (nblk + EPI_GROUP - 1) / EPI_GROUP;
    if (threadIdx.x < NSUM) {
        float x = warp_sums[0][threadIdx.x];
        for (int w = 1; w < THREADS / 32; ++w) x = add(x, warp_sums[w][threadIdx.x]);
        rows[(size_t)blockIdx.x * NSUM + threadIdx.x] = x;
        __threadfence();
    }
    // the last block of the group sums the group's rows in order; the last
    // group's summing block sums the groups' rows in order
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(group_ticket + group, 1) == min(EPI_GROUP, nblk - group * EPI_GROUP) - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum_rows(rows, group * EPI_GROUP, min(nblk, (group + 1) * EPI_GROUP), sums);
    if (threadIdx.x < NSUM) {
        group_rows[group * NSUM + threadIdx.x] = sums[threadIdx.x];
        __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(stats + S_TICKET, 1) == ngroups - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum_rows(group_rows, 0, ngroups, sums);
    angles_from(sums, angles);
}

// rotate each slice by its angle; the slices' lo/hi over both components
__global__ void __launch_bounds__(THREADS)
uw_faces_rotate_k(float *__restrict__ uv, int F, const int *__restrict__ index, const float *__restrict__ angles,
                  int *__restrict__ stats) {
    __shared__ BlockMinMax<6> mm;
    mm.init();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    int s = -1;
    float mn = INFINITY, mx = -INFINITY;
    if (f < F) {
        s = index[f];
        const float ca = angles[s], sa = angles[6 + s];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float cu = sub(mul(uv[c * F + f], 2.f), 1.f), cv = sub(mul(uv[(3 + c) * F + f], 2.f), 1.f);
            const float ru = sub(mul(ca, cu), mul(sa, cv)), rv = add(mul(sa, cu), mul(ca, cv));
            uv[c * F + f] = ru;
            uv[(3 + c) * F + f] = rv;
            mn = fminf(mn, fminf(ru, rv));
            mx = fmaxf(mx, fmaxf(ru, rv));
        }
    }
    mm.put(s, mn, mx);
    mm.flush(stats + S_LO, stats + S_HI);
}

// round 0's visibility (one bit a face), and round 1's per-slice depth
// range over the faces it hides (round 1's participants)
__global__ void __launch_bounds__(THREADS)
uw_visible_k(const float *__restrict__ uv, int F, const int *__restrict__ index, const float *__restrict__ depth,
             const int *__restrict__ winner, int *__restrict__ stats, unsigned *__restrict__ vis0) {
    __shared__ BlockMinMax<6> range;
    range.init();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    bool vis = true;
    int hidden_slice = -1;
    float dep = 0.f;
    if (f < F) {
        const int s = index[f];
        float uc[3], vc[3];
        normalised(uv, F, f, s, stats, uc, vc);
        dep = depth[f];
        vis = visible_at(uc, vc, s, dep, winner, stats + S_DEPTH);
        if (!vis) hidden_slice = s;
    }
    const unsigned word = __ballot_sync(RW_FULL, vis);
    if ((threadIdx.x & 31) == 0 && f < F) vis0[f >> 5] = word;
    range.put(hidden_slice, dep, dep);
    range.flush(stats + S_DEPTH + 12, stats + S_DEPTH + 18);
}

// round 1's visibility; atlas index = slice + 6 x visibility class; the
// overlap slices' bounds; the pool flags (one bit a face)
__global__ void __launch_bounds__(THREADS)
uw_atlas_k(const float *__restrict__ uv, int F, const int *__restrict__ index, const float *__restrict__ depth,
           const int *__restrict__ winner, const unsigned *__restrict__ vis0, int *__restrict__ atlas,
           int *__restrict__ stats, unsigned *__restrict__ pool) {
    __shared__ BlockMinMax<6> mu, mv;
    mu.init();
    mv.init();
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    int a = -1;
    float ulo = 0.f, uhi = 0.f, vlo = 0.f, vhi = 0.f;
    if (f < F) {
        const int s = index[f];
        float uc[3], vc[3];
        normalised(uv, F, f, s, stats, uc, vc);
        a = s;
        if (!bit(vis0, f)) a = visible_at(uc, vc, s, depth[f], winner, stats + S_DEPTH + 12) ? s + 6 : s + 12;
        atlas[f] = a;
        ulo = fminf(fminf(uc[0], uc[1]), uc[2]), uhi = fmaxf(fmaxf(uc[0], uc[1]), uc[2]);
        vlo = fminf(fminf(vc[0], vc[1]), vc[2]), vhi = fmaxf(fmaxf(vc[0], vc[1]), vc[2]);
    }
    const int over = a >= 6 && a < 12 ? a - 6 : -1;
    mu.put(over, ulo, uhi);
    mv.put(over, vlo, vhi);
    const unsigned word = __ballot_sync(RW_FULL, a >= 12);
    if ((threadIdx.x & 31) == 0 && f < F) pool[f >> 5] = word;
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

struct Pad {
    float pad, one_m_2pad, one_m_pad, half_pad;
};

// face f's placed UVs into dst[6]
__device__ __forceinline__ void place_face(const float *__restrict__ uv, int F, int f, const int *__restrict__ index,
                                           const int *__restrict__ atlas, const unsigned *__restrict__ pool,
                                           const int *__restrict__ pool_base, const int *__restrict__ stats,
                                           const Pad &p, float *dst) {
    const int a = atlas[f], block = a / 6, s = a % 6;
    const bool in_pool = a >= 12;
    float uc[3], vc[3];
    normalised(uv, F, f, index[f], stats, uc, vc);
    if (a >= 6 && !in_pool) {  // overlap slices: rescaled to fill their cell, at most 2x
        const int o = a - 6;
        const float ul = unsortable(stats[S_ULO + o]), uh = unsortable(stats[S_UHI + o]);
        const float vl = unsortable(stats[S_VLO + o]), vh = unsortable(stats[S_VHI + o]);
        for (int c = 0; c < 3; ++c) {
            uc[c] = dv(sub(uc[c], ul), fmaxf(sub(uh, ul), 0.5f));
            vc[c] = dv(sub(vc[c], vl), fmaxf(sub(vh, vl), 0.5f));
        }
    }
    for (int c = 0; c < 3; ++c) {
        uc[c] = clamp01(add(mul(uc[c], p.one_m_2pad), p.pad));
        vc[c] = clamp01(add(mul(vc[c], p.one_m_2pad), p.pad));
    }
    if (in_pool) {  // individual squares, the reference's pool layout
        const int n = stats[S_NREM];
        const float mult = __fsqrt_rn(mul(fmaxf((float)n, 1.f), 6.f));
        const int nw = max((int)ceilf(mul(0.5f, mult)), 1);
        const int nh = max((n + nw - 1) / nw, 1);
        const float nwf = (float)nw, nhf = (float)nh;
        const float width = dv(1.f, nwf), height = dv(1.f, nhf);
        const float cval = mul(fminf(width, height), 1.5f);
        const int rank = pool_base[f >> 5] + __popc(pool[f >> 5] & lanes_below());
        const float id = (float)rank;
        const float col = mul(fmodf(id, nwf), width), row = mul(floorf(dv(id, nwf)), height);
        const float ulo = fminf(fminf(uc[0], uc[1]), uc[2]), uhi = fmaxf(fmaxf(uc[0], uc[1]), uc[2]);
        const float vlo = fminf(fminf(vc[0], vc[1]), vc[2]), vhi = fmaxf(fmaxf(vc[0], vc[1]), vc[2]);
        for (int c = 0; c < 3; ++c) {
            uc[c] = place(uc[c], ulo, uhi, cval, nwf, width, col, p.pad, p.one_m_pad, p.half_pad);
            vc[c] = place(vc[c], vlo, vhi, cval, nhf, height, row, p.pad, p.one_m_pad, p.half_pad);
        }
    }
    const float xs[6] = {0.f, 1.f, 2.f, 0.f, 1.f, 2.f}, ys[6] = {0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
    const float xv = in_pool ? 0.f : xs[s], yv = in_pool ? 0.f : ys[s];
    const float off = THIRD, dupl = 0.1666666716337204f, off2 = 0.6666666865348816f;
    const float offset_x = block == 0 ? mul(off, xv) : add(mul(dupl, xv), mul((float)min(block - 1, 1), 0.5f));
    const float offset_y = block == 0 ? mul(off, yv) : add(mul(dupl, yv), off2);
    const float div_x = in_pool ? 2.f : (a >= 6 ? 6.f : 3.f), div_y = in_pool ? 3.f : (a >= 6 ? 6.f : 3.f);
    for (int c = 0; c < 3; ++c) {
        dst[2 * c] = add(dv(uc[c], div_x), offset_x);
        dst[2 * c + 1] = add(dv(vc[c], div_y), offset_y);
    }
}

// placement -> out (F, 6) [u0, v0, u1, v1, u2, v2], staged in shared
// memory so the block's rows go out coalesced; a pool face's square is its
// rank among the pool faces, in face order: its word's scanned base plus
// the pool faces before it in the word
__global__ void __launch_bounds__(THREADS)
uw_place_k(const float *__restrict__ uv, int F, const int *__restrict__ index, const int *__restrict__ atlas,
           const unsigned *__restrict__ pool, const int *__restrict__ pool_base, const int *__restrict__ stats,
           Pad p, float *__restrict__ out) {
    __shared__ float placed[THREADS * 6];
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f < F) place_face(uv, F, f, index, atlas, pool, pool_base, stats, p, placed + threadIdx.x * 6);
    __syncthreads();
    const int first = blockIdx.x * blockDim.x, n = 6 * min(F - first, THREADS);
    for (int i = threadIdx.x; i < n; i += THREADS) out[(size_t)first * 6 + i] = placed[i];
}

// one face's round inputs as K8's unwrap form forms them, written out (the
// checks hold them to the plain version's)
__global__ void __launch_bounds__(THREADS)
uw_round_inputs_k(const Round ld, float *__restrict__ corners, int *__restrict__ key) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= ld.F) return;
    float c[6];
    ld(f, c, key[f]);
    for (int k = 0; k < 6; ++k) corners[(size_t)k * ld.F + f] = c[k];
}

inline int blocks(long long n) { return n > 0 ? (int)((n + THREADS - 1) / THREADS) : 0; }
inline int words(int F) { return (F + 31) / 32; }
inline size_t up4(size_t n) { return (n + 3) / 4 * 4; }  // 16-byte aligned offsets

// the call's scratch, in int32 words: both winners, stats, the scan's
// status words (u64), the epilogue's group tickets, then per face the
// slice, depth, rotated UVs, round 0's visibility bits, the pool bits and
// their scanned bases, and the projection's block and group rows
struct Layout {
    size_t winners, stats, status, tickets, index, depth, uv, vis0, pool, base, rows, group_rows, total;
    int tiles, nblk, ngroups;
    explicit Layout(int F) {
        tiles = scan_tiles(words(F));
        nblk = blocks(F);
        ngroups = (nblk + EPI_GROUP - 1) / EPI_GROUP;
        size_t next = 0;
        auto take = [&next](size_t n) { const size_t o = next; next += up4(n); return o; };
        winners = take(2 * (size_t)RASTER_TEXELS);
        stats = take(STATS);
        status = take(2 * (size_t)tiles);
        tickets = take(ngroups);
        index = take(F);
        depth = take(F);
        uv = take(6 * (size_t)F);
        vis0 = take(words(F));
        pool = take(words(F));
        base = take(words(F));
        rows = take((size_t)nblk * NSUM);
        group_rows = take((size_t)ngroups * NSUM);
        total = next;
    }
};

inline cudaStream_t st(void *s) { return reinterpret_cast<cudaStream_t>(s); }

template <class T>
T *at(void *ws, size_t words) {
    return reinterpret_cast<T *>(static_cast<int *>(ws) + words);
}

Round round_of(void *ws, const Layout &L, int F, int round) {
    return Round{at<float>(ws, L.uv), at<int>(ws, L.index), at<int>(ws, L.stats), at<float>(ws, L.depth),
                 at<unsigned>(ws, L.vis0), F, round};
}

int raster_round(const Round &ld, int *winner, cudaStream_t s) {
    raster_warp<<<(ld.F + RW_THREADS - 1) / RW_THREADS, RW_THREADS, 0, s>>>(
        ld, ld.F, RASTER_RES, 1.f / (float)(RASTER_RES - 1), (float)MARGIN, (float)(MARGIN * (RASTER_RES - 1)),
        true, winner);
    return (int)cudaGetLastError();
}

}  // namespace

// Scratch of a call on F faces, in int32 words (uw_unwrap's `ws`).
extern "C" long long uw_workspace_words(int F) { return F > 0 ? (long long)Layout(F).total : 0; }

// K9 on a mesh of Nv vertices (rotated positions px, py, pz, (Nv,) f32
// each) and F > 0 faces (corner ids fa, fb, fc, (F,) int32 each) ->
// out (F, 6) f32 [u0, v0, u1, v1, u2, v2], atlas (F,) int32, angles
// (2, 6) f32 [cos, sin]. `ws` holds uw_workspace_words(F) int32 words,
// 16-byte aligned; nothing in it needs initialising. Launches the whole
// chain on `stream`; returns a cudaError_t (0 on success).
extern "C" int uw_unwrap(const void *px, const void *py, const void *pz, int Nv, const void *fa, const void *fb,
                         const void *fc, int F, float pad, float one_m_2pad, float one_m_pad, float half_pad,
                         void *ws, void *out, void *atlas, void *angles, void *stream) {
    if (F <= 0 || Nv <= 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = st(stream);
    const Layout L(F);
    const Mesh m{static_cast<const float *>(px), static_cast<const float *>(py), static_cast<const float *>(pz),
                 static_cast<const int *>(fa), static_cast<const int *>(fb), static_cast<const int *>(fc), F};
    int *stats = at<int>(ws, L.stats), *index = at<int>(ws, L.index);
    int *win0 = at<int>(ws, L.winners), *win1 = win0 + RASTER_TEXELS;
    float *uv = at<float>(ws, L.uv), *depth = at<float>(ws, L.depth);
    unsigned *vis0 = at<unsigned>(ws, L.vis0), *pool = at<unsigned>(ws, L.pool);
    int *base = at<int>(ws, L.base);
    float *fangles = static_cast<float *>(angles);
    cudaError_t e = cudaMemcpyFromSymbolAsync(stats, STATS_INIT, sizeof(STATS_INIT), 0, cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    // the status words and the group tickets lie next to each other: one range to zero
    const int nzeroed = (int)(L.index - L.status);
    uw_init_bbox_k<<<INIT_BLOCKS, THREADS, 0, s>>>(
        m, Nv, stats, at<int4>(ws, L.winners), at<int>(ws, L.status), nzeroed);
    uw_faces_index_k<<<blocks(F), THREADS, 0, s>>>(m, stats, index, depth);
    uw_faces_project_k<<<L.nblk, THREADS, 0, s>>>(m, stats, index, uv, at<float>(ws, L.rows),
                                                  at<float>(ws, L.group_rows), at<int>(ws, L.tickets), fangles);
    uw_faces_rotate_k<<<blocks(F), THREADS, 0, s>>>(uv, F, index, fangles, stats);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (int r = raster_round(round_of(ws, L, F, 0), win0, s)) return r;
    uw_visible_k<<<blocks(F), THREADS, 0, s>>>(uv, F, index, depth, win0, stats, vis0);
    if (int r = raster_round(round_of(ws, L, F, 1), win1, s)) return r;
    uw_atlas_k<<<blocks(F), THREADS, 0, s>>>(uv, F, index, depth, win1, vis0, static_cast<int *>(atlas), stats,
                                             pool);
    ScanSegs sg = {};
    sg.in[0] = reinterpret_cast<const int *>(pool);
    sg.base[0] = base;
    sg.total[0] = stats + S_NREM;
    sg.n[0] = words(F);
    sg.popc[0] = 1;
    sg.first_tile[1] = L.tiles;
    sg.nsegs = 1;
    scan_segments<<<L.tiles, MS_THREADS, 0, s>>>(sg, at<unsigned long long>(ws, L.status), stats + S_TILE);
    uw_place_k<<<blocks(F), THREADS, 0, s>>>(uv, F, index, static_cast<const int *>(atlas), pool, base, stats,
                                             Pad{pad, one_m_2pad, one_m_pad, half_pad}, static_cast<float *>(out));
    return (int)cudaGetLastError();
}

// K8's unwrap form alone, for one round, on state the caller gives: the
// rotated UVs (6, F) f32 rows [u0, u1, u2, v0, v1, v2], the slice (F,)
// int32, the depth (F,) f32, STATS int32 slots of which the slices' lo/hi
// (sortable) are read, and in round 1 round 0's visibility bits. Writes
// the corners (6, F) f32 rows [u0, v0, u1, v1, u2, v2] and keys (F,) that
// its loader forms, and rasterizes them into `winner` (1024^2, filled with
// WINNER_SINK by the caller).
extern "C" int uw_round(const void *uv, const void *index, const void *depth, const void *stats, const void *vis0,
                        int F, int round, void *corners, void *key, void *winner, void *stream) {
    if (F <= 0 || round < 0 || round > 1) return (int)cudaErrorInvalidValue;
    const Round ld{static_cast<const float *>(uv), static_cast<const int *>(index), static_cast<const int *>(stats),
                   static_cast<const float *>(depth), static_cast<const unsigned *>(vis0), F, round};
    uw_round_inputs_k<<<blocks(F), THREADS, 0, st(stream)>>>(ld, static_cast<float *>(corners),
                                                              static_cast<int *>(key));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return raster_round(ld, static_cast<int *>(winner), st(stream));
}
