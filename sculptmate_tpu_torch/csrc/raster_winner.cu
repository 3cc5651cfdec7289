// K8: per-texel scatter-min rasterizer of per-face keys.
//
// Replaces: sculptmate_tpu/geometry/texture_bake.py:binned_winner (l.234)
// with _face_tile_pairs (l.156), the two-tier (face, tile) pair program the
// JAX package runs for the bake (face-id keys, margin 0, 512^2) and for the
// device unwrap's two visibility rounds (keys ~sortable(depth), margin
// 0.05, 1024^2).
//
// For every texel (x, y) it writes the lowest key among the faces whose
// barycentric test, with slack `margin`, covers the texel centre
// (x, y) / (res - 1); WINNER_SINK (INT_MAX, set by the wrapper) where none
// does.
//
// Bound on the H100: bytes. A face is 28 bytes in (six f32 corner UVs and
// its key) and the winner buffer 4 bytes a texel out: ~17 MB of faces at
// 0.6 M faces and 4 MB at 1024^2, ~6 us at 3.35 TB/s. An atlas face covers
// a texel or two, so the barycentric tests are few; the atomics land in L2.
//
// Design: no binning. One thread per face computes its texel bbox (the JAX
// program's, widened by the margin's slack), tests each texel of a bbox of
// at most SMALL_TEXELS and does atomicMin of its key into the winner
// buffer; a face with a larger bbox is appended to a list instead, and a
// second launch gives each listed face a block that strides over its bbox.
// min is commutative, so the result is independent of the order of the
// atomics, and no face is ever unroutable: the JAX package's pair
// capacities, overflow counters and retries have no counterpart.
//
// Arithmetic: the JAX program's products, sums and quotients in its order,
// each rounded on its own (__fmul_rn / __fadd_rn / __fdiv_rn: no contracted
// multiply-add moves an edge texel), and the texel centre as x * (1 /
// (res - 1)), as XLA computes the JAX program's division by that constant.
// The winner is bit-equal to the plain version's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int SMALL_TEXELS = 64;  // bbox texels a face's own thread walks
constexpr int FACE_THREADS = 256;
constexpr int BIG_THREADS = 256;

struct Face {
    float u0, v0, e1u, e1v, e2u, e2v, d00, d01, d11, den;
    int xlo, ylo, w, h, key;
    bool covers;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// float -> int32 as the bbox needs it: clamped to [-1, res] first, so an
// out-of-range corner cannot overflow the conversion
__device__ __forceinline__ int to_index(float t, int res) {
    return (int)fminf(fmaxf(t, -1.f), (float)res);
}

__device__ Face load_face(const float *__restrict__ u0p, const float *__restrict__ v0p,
                          const float *__restrict__ u1p, const float *__restrict__ v1p,
                          const float *__restrict__ u2p, const float *__restrict__ v2p,
                          const int *__restrict__ keys, int f, int res, float mslack, bool widen) {
    Face fc;
    const float u0 = u0p[f], v0 = v0p[f], u1 = u1p[f], v1 = v1p[f], u2 = u2p[f], v2 = v2p[f];
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
    fc.key = keys[f];
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
    const int w = xhi - xlo + 1;
    const int h = yhi - ylo + 1;
    fc.w = w;
    fc.h = h;
    fc.covers = finite && w > 0 && h > 0 && fabsf(fc.den) >= 1e-12f;
    return fc;
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

__device__ __forceinline__ void deposit(int *__restrict__ winner, int texel, int key) {
    atomicMin(winner + texel, key);
}

__global__ void __launch_bounds__(FACE_THREADS)
raster_faces(const float *__restrict__ u0, const float *__restrict__ v0, const float *__restrict__ u1,
             const float *__restrict__ v1, const float *__restrict__ u2, const float *__restrict__ v2,
             const int *__restrict__ keys, int F, int res, float rcp, float mg, float mslack, bool widen,
             int *__restrict__ winner, int *__restrict__ big_list, int *__restrict__ big_count) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;
    const Face fc = load_face(u0, v0, u1, v1, u2, v2, keys, f, res, mslack, widen);
    if (!fc.covers) return;
    if (fc.w * fc.h > SMALL_TEXELS) {
        big_list[atomicAdd(big_count, 1)] = f;
        return;
    }
    for (int dy = 0; dy < fc.h; ++dy)
        for (int dx = 0; dx < fc.w; ++dx) {
            const int x = fc.xlo + dx, y = fc.ylo + dy;
            if (inside(fc, x, y, rcp, mg)) deposit(winner, y * res + x, fc.key);
        }
}

// one block per listed face at a time, its threads striding over the bbox
__global__ void __launch_bounds__(BIG_THREADS)
raster_big_faces(const float *__restrict__ u0, const float *__restrict__ v0, const float *__restrict__ u1,
                 const float *__restrict__ v1, const float *__restrict__ u2, const float *__restrict__ v2,
                 const int *__restrict__ keys, int res, float rcp, float mg, float mslack, bool widen,
                 int *__restrict__ winner, const int *__restrict__ big_list, const int *__restrict__ big_count) {
    const int n_big = *big_count;
    for (int i = blockIdx.x; i < n_big; i += gridDim.x) {
        const Face fc = load_face(u0, v0, u1, v1, u2, v2, keys, big_list[i], res, mslack, widen);
        const int n = fc.w * fc.h;
        for (int t = threadIdx.x; t < n; t += blockDim.x) {
            const int x = fc.xlo + t % fc.w, y = fc.ylo + t / fc.w;
            if (inside(fc, x, y, rcp, mg)) deposit(winner, y * res + x, fc.key);
        }
    }
}

}  // namespace

// winner (res * res) must hold WINNER_SINK; scratch holds F + 1 ints (the
// big-face list, then its count). Returns a cudaError_t (0 on success).
extern "C" int raster_winner_fwd(const void *u0, const void *v0, const void *u1, const void *v1, const void *u2,
                                 const void *v2, const void *keys, int F, int res, float rcp, float margin,
                                 float mslack, void *winner, void *scratch, int num_sms, void *stream) {
    if (F < 0 || res < 2) return (int)cudaErrorInvalidValue;
    if (F == 0) return 0;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    int *list = static_cast<int *>(scratch), *count = list + F;
    cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    const bool widen = margin > 0.f;
    raster_faces<<<(F + FACE_THREADS - 1) / FACE_THREADS, FACE_THREADS, 0, st>>>(
        static_cast<const float *>(u0), static_cast<const float *>(v0), static_cast<const float *>(u1),
        static_cast<const float *>(v1), static_cast<const float *>(u2), static_cast<const float *>(v2),
        static_cast<const int *>(keys), F, res, rcp, margin, mslack, widen, static_cast<int *>(winner), list, count);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // the list's length is on the device: a fixed grid reads it there
    const int grid = std::max(1, std::min(4 * num_sms, F));
    raster_big_faces<<<grid, BIG_THREADS, 0, st>>>(
        static_cast<const float *>(u0), static_cast<const float *>(v0), static_cast<const float *>(u1),
        static_cast<const float *>(v1), static_cast<const float *>(u2), static_cast<const float *>(v2),
        static_cast<const int *>(keys), res, rcp, margin, mslack, widen, static_cast<int *>(winner), list, count);
    return (int)cudaGetLastError();
}
