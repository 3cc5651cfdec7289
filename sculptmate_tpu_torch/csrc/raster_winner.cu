// K8: per-texel scatter-min rasterizer of per-face keys, bake form.
//
// Replaces: sculptmate_tpu/geometry/texture_bake.py:binned_winner (l.234)
// with _face_tile_pairs (l.156), the two-tier (face, tile) pair program the
// JAX package runs for the bake (face-id keys, margin 0, 512^2) and for the
// device unwrap's two visibility rounds (keys ~sortable(depth), margin
// 0.05, 1024^2). The unwrap's rounds run K8's unwrap form, launched inside
// K9's chain (uv_unwrap.cu); this file is the form that takes corner rows.
//
// Bound on the H100: bytes. A face is 28 bytes in (six f32 corner UVs and
// its key) and the winner buffer 4 bytes a texel out: ~17 MB of faces at
// 0.6 M faces and 4 MB at 1024^2, ~6 us at 3.35 TB/s. An atlas face covers
// a texel or two, so the barycentric tests are few; the atomics land in L2.
//
// Design: raster.cuh's warp-balanced kernel, one launch, with a loader that
// reads the six corner rows and the key row. No binning: the JAX package's
// pair capacities, overflow counters and retries have no counterpart.

#include "raster.cuh"

namespace {

struct CornerRows {
    const float *u0, *v0, *u1, *v1, *u2, *v2;
    const int *keys;
    __device__ __forceinline__ void operator()(int f, float (&c)[6], int &key) const {
        c[0] = u0[f];
        c[1] = v0[f];
        c[2] = u1[f];
        c[3] = v1[f];
        c[4] = u2[f];
        c[5] = v2[f];
        key = keys[f];
    }
};

}  // namespace

// winner (res * res) must hold WINNER_SINK. Returns a cudaError_t (0 on
// success).
extern "C" int raster_winner_fwd(const void *u0, const void *v0, const void *u1, const void *v1, const void *u2,
                                 const void *v2, const void *keys, int F, int res, float rcp, float margin,
                                 float mslack, void *winner, void *stream) {
    if (F < 0 || res < 2 || res > RW_MAX_RES) return (int)cudaErrorInvalidValue;
    if (F == 0) return 0;
    const CornerRows ld{static_cast<const float *>(u0), static_cast<const float *>(v0),
                        static_cast<const float *>(u1), static_cast<const float *>(v1),
                        static_cast<const float *>(u2), static_cast<const float *>(v2),
                        static_cast<const int *>(keys)};
    raster_warp<<<(F + RW_THREADS - 1) / RW_THREADS, RW_THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        ld, F, res, rcp, margin, mslack, margin > 0.f, static_cast<int *>(winner));
    return (int)cudaGetLastError();
}
