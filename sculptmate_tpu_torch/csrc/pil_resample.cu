// K12: PIL-exact separable Lanczos resample of uint8 images, and the add-on's
// condition image built inside it.
//
// Replaces no TPU kernel: the JAX package leaves this work to PIL on the host.
// It stands in for the add-on frontend's host PIL and numpy work
// (frontend/preprocess.py:preprocess_image with frontend/matting.py:remove and
// SessionBase.predict_mask): the photo's Lanczos to the matting network's
// input, the mask's Lanczos back to the photo's size, the cutout, the crop and
// pads, the composite on gray and the Lanczos to 1024^2, ~230 ms of one host
// core a request while the card sat idle. Every step gives PIL's bytes:
// Pillow's ImagingResample for 8 bits a channel (Resample.c: int32 taps with
// 22 fractional bits, the horizontal pass, a clip to 8 bits, the vertical
// pass), Paste.c's mask blend for the cutout, and numpy's float32 composite.
//
// Bound on the H100: bytes. A Lean request reads the 1024^2 photo (3 MB) for
// the downsize, writes the mask (1 MB), reads the photo and the mask again for
// the condition image, and writes and reads each pass's intermediate: ~20 MB,
// ~6 us at 3.35 TB/s. A tap is an integer multiply-add a channel.
//
// Design:
// - two launches a resize, as Pillow runs it: the horizontal pass over every
//   source row into an 8-bit intermediate, then the vertical pass. A thread
//   makes one output texel, all its channels; neighbouring threads make
//   neighbouring texels of one row, so the vertical pass's reads coalesce and
//   the horizontal pass's overlapping windows hit L1;
// - the taps (bounds and int32 coefficients per output index) are built on
//   the host in float64 by Pillow's formulas and kept on the card per
//   (in, out) pair (ops/pil_resample.py); a pass whose size does not change
//   runs on the identity taps, which give the input's bytes, as Pillow's
//   skipped pass does;
// - the mask's resize reads the network's float mask as PIL's L image of it
//   (255 m, truncated) and folds its bbox (the texels above 0) into each
//   block's reduction and four atomicMax: no extra pass and no sync;
// - the condition image's horizontal pass reads a virtual padded square:
//   outside the crop a texel is the composite gray 127 with no read; inside,
//   Pillow's cutout blend and then numpy's float32 composite on gray, each
//   step rounded on its own (__fdiv_rn, __fmul_rn, __fadd_rn), so that no
//   multiply-add contracts into an FMA, and truncated to 8 bits. A texel is
//   composited once per tap that reads it (up to 9): a few hundred million
//   float operations, under the launch's own time;
// - the Pro button's padded RGBA square is one gather of the cutout.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int PRECISION_BITS = 22;  // 32 - 8 - 2, Pillow's for 8 bits a channel
constexpr int THREADS = 256;

enum Source { SRC_U8 = 0, SRC_MASK = 1, SRC_CONDITION = 2 };
enum Form { OUT_RGB_U8 = 0, OUT_RGB_F32 = 1, OUT_L_BBOX = 2 };

// The condition image's virtual padded square: square rows [oy, oy + hc) and
// columns [ox, ox + wc) hold the photo's texels from (y1, x1) on.
struct Crop {
    const unsigned char *mask;  // the photo's L mask, (photo_h, photo_w)
    int oy, ox, hc, wc, y1, x1, photo_h, photo_w;
};

__device__ __forceinline__ unsigned char clip8(int in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (unsigned char)(in >> PRECISION_BITS);
}

// Paste.c's DIV255: a / 255 rounded, for a in [0, 255 * 255].
__device__ __forceinline__ unsigned div255(unsigned a) {
    const unsigned t = a + 128;
    return (t + (t >> 8)) >> 8;
}

// A photo texel c under mask m, cut out (Image.composite onto an empty RGBA
// canvas: c m / 255 rounded, alpha 255 m / 255 = m) and composited on gray as
// preprocess_image's numpy does: f = x / 255; rgb = f_c f_a + (1 - f_a) 0.5;
// uint8(rgb * 255), truncated.
__device__ __forceinline__ unsigned char composite_gray(unsigned c, unsigned m) {
    const float fc = __fdiv_rn((float)div255(c * m), 255.f);
    const float fa = __fdiv_rn((float)div255(255u * m), 255.f);
    const float v = __fadd_rn(__fmul_rn(fc, fa), __fmul_rn(__fsub_rn(1.f, fa), 0.5f));
    return (unsigned char)__float2int_rz(__fmul_rn(v, 255.f));
}

template <int C, int SRC>
__device__ __forceinline__ void load_texel(const void *src, const Crop &crop, int in_w, int y, int x,
                                           unsigned (&v)[C]) {
    if constexpr (SRC == SRC_U8) {
        const unsigned char *p = static_cast<const unsigned char *>(src) + ((size_t)y * in_w + x) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = p[c];
    } else if constexpr (SRC == SRC_MASK) {
        const float m = static_cast<const float *>(src)[(size_t)y * in_w + x];
        v[0] = (unsigned)__float2int_rz(__fmul_rn(m, 255.f));
    } else {
        const int ry = y - crop.oy, rx = x - crop.ox;
        if (ry >= 0 && ry < crop.hc && rx >= 0 && rx < crop.wc) {
            const size_t t = (size_t)(crop.y1 + ry) * crop.photo_w + crop.x1 + rx;
            const unsigned m = crop.mask[t];
            const unsigned char *p = static_cast<const unsigned char *>(src) + t * 3;
#pragma unroll
            for (int c = 0; c < C; ++c) v[c] = composite_gray(p[c], m);
        } else {
#pragma unroll
            for (int c = 0; c < C; ++c) v[c] = 127;  // composite_gray(0, 0)
        }
    }
}

// Horizontal pass: tmp (in_h, out_w, C) from the source's (in_h, in_w) texels.
template <int C, int SRC>
__global__ void __launch_bounds__(THREADS) resample_h(const void *__restrict__ src, Crop crop, int in_w,
                                                      const int *__restrict__ bounds, const int *__restrict__ kk,
                                                      int ksize, int out_w, unsigned char *__restrict__ tmp) {
    const int xx = blockIdx.x * THREADS + threadIdx.x;
    const int y = blockIdx.y;
    if (xx >= out_w) return;
    const int xmin = __ldg(bounds + 2 * xx), xmax = __ldg(bounds + 2 * xx + 1);
    const int *k = kk + (size_t)xx * ksize;
    int ss[C];
#pragma unroll
    for (int c = 0; c < C; ++c) ss[c] = 1 << (PRECISION_BITS - 1);
    for (int x = 0; x < xmax; ++x) {
        unsigned v[C];
        load_texel<C, SRC>(src, crop, in_w, y, x + xmin, v);
        const int w = __ldg(k + x);
#pragma unroll
        for (int c = 0; c < C; ++c) ss[c] += (int)v[c] * w;
    }
    unsigned char *o = tmp + ((size_t)y * out_w + xx) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = clip8(ss[c]);
}

// Vertical pass: out (out_h, w, C) from tmp (in_h, w, C); as float32 x / 255
// when F32 (the matting network's input). With BBOX (C = 1), the texels above
// 0 go into bbox as max(out_h - y), max(y + 1), max(w - x), max(x + 1).
template <int C, bool F32, bool BBOX>
__global__ void __launch_bounds__(THREADS) resample_v(const unsigned char *__restrict__ tmp, int w,
                                                      const int *__restrict__ bounds, const int *__restrict__ kk,
                                                      int ksize, int out_h, void *__restrict__ out,
                                                      int *__restrict__ bbox) {
    const int xx = blockIdx.x * THREADS + threadIdx.x;
    const int yy = blockIdx.y;
    bool fg = false;
    if (xx < w) {
        const int ymin = __ldg(bounds + 2 * yy), ymax = __ldg(bounds + 2 * yy + 1);
        const int *k = kk + (size_t)yy * ksize;
        int ss[C];
#pragma unroll
        for (int c = 0; c < C; ++c) ss[c] = 1 << (PRECISION_BITS - 1);
        for (int y = 0; y < ymax; ++y) {
            const unsigned char *p = tmp + ((size_t)(y + ymin) * w + xx) * C;
            const int wt = __ldg(k + y);
#pragma unroll
            for (int c = 0; c < C; ++c) ss[c] += (int)p[c] * wt;
        }
        const size_t o = ((size_t)yy * w + xx) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const unsigned char v = clip8(ss[c]);
            if constexpr (F32) {
                static_cast<float *>(out)[o + c] = __fdiv_rn((float)v, 255.f);
            } else {
                static_cast<unsigned char *>(out)[o + c] = v;
            }
            fg |= v > 0;
        }
    }
    if constexpr (BBOX) {
        __shared__ int lo[THREADS / 32], hi[THREADS / 32];
        if (!__syncthreads_or(fg)) return;  // the whole block agrees
        int xlo = __reduce_min_sync(0xffffffffu, fg ? xx : INT_MAX);
        int xhi = __reduce_max_sync(0xffffffffu, fg ? xx : -1);
        const int warp = threadIdx.x / 32;
        if (threadIdx.x % 32 == 0) {
            lo[warp] = xlo;
            hi[warp] = xhi;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int i = 1; i < THREADS / 32; ++i) {
                xlo = min(xlo, lo[i]);
                xhi = max(xhi, hi[i]);
            }
            atomicMax(bbox + 0, out_h - yy);
            atomicMax(bbox + 1, yy + 1);
            atomicMax(bbox + 2, w - xlo);
            atomicMax(bbox + 3, xhi + 1);
        }
    }
}

// The Pro button's padded RGBA square (side s): the cutout inside the crop,
// zeros outside.
__global__ void __launch_bounds__(THREADS) cutout_rgba(const unsigned char *__restrict__ photo, Crop crop, int s,
                                                       uchar4 *__restrict__ out) {
    const int x = blockIdx.x * THREADS + threadIdx.x;
    const int y = blockIdx.y;
    if (x >= s) return;
    const int ry = y - crop.oy, rx = x - crop.ox;
    uchar4 v = make_uchar4(0, 0, 0, 0);
    if (ry >= 0 && ry < crop.hc && rx >= 0 && rx < crop.wc) {
        const size_t t = (size_t)(crop.y1 + ry) * crop.photo_w + crop.x1 + rx;
        const unsigned m = crop.mask[t];
        const unsigned char *p = photo + t * 3;
        v = make_uchar4(div255(p[0] * m), div255(p[1] * m), div255(p[2] * m), div255(255u * m));
    }
    out[(size_t)y * s + x] = v;
}

dim3 grid_of(int w, int h) { return dim3((w + THREADS - 1) / THREADS, h); }

bool valid_crop(const Crop &c, int in_h, int in_w) {
    return c.mask && c.hc >= 0 && c.wc >= 0 && c.oy >= 0 && c.ox >= 0 && c.oy + c.hc <= in_h &&
           c.ox + c.wc <= in_w && c.y1 >= 0 && c.x1 >= 0 && c.y1 + c.hc <= c.photo_h && c.x1 + c.wc <= c.photo_w;
}

}  // namespace

// Horizontal pass into tmp (in_h, out_w, C). source 0: the (in_h, in_w, 3)
// uint8 photo `src`; 1: an (in_h, in_w) float32 mask `src` in [0, 1], C 1;
// 2: the condition image's virtual square of side in_h = in_w over the
// (photo_h, photo_w, 3) photo `src` and its L `mask`. `taps`: out_w (first,
// count) pairs, then out_w rows of ksize int32 coefficients. Returns a
// cudaError_t (0 on success).
extern "C" int pil_resample_h(int source, const void *src, const void *mask, int oy, int ox, int hc, int wc, int y1,
                              int x1, int photo_h, int photo_w, int in_h, int in_w, const void *taps, int ksize,
                              int out_w, void *tmp, void *stream) {
    if (in_h < 1 || in_w < 1 || out_w < 1 || ksize < 1 || !src || !taps || !tmp) return (int)cudaErrorInvalidValue;
    const Crop crop{static_cast<const unsigned char *>(mask), oy, ox, hc, wc, y1, x1, photo_h, photo_w};
    const int *bounds = static_cast<const int *>(taps);
    const int *kk = bounds + 2 * out_w;
    unsigned char *t = static_cast<unsigned char *>(tmp);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const dim3 grid = grid_of(out_w, in_h);
    if (source == SRC_U8) {
        resample_h<3, SRC_U8><<<grid, THREADS, 0, st>>>(src, crop, in_w, bounds, kk, ksize, out_w, t);
    } else if (source == SRC_MASK) {
        resample_h<1, SRC_MASK><<<grid, THREADS, 0, st>>>(src, crop, in_w, bounds, kk, ksize, out_w, t);
    } else if (source == SRC_CONDITION && in_h == in_w && valid_crop(crop, in_h, in_w)) {
        resample_h<3, SRC_CONDITION><<<grid, THREADS, 0, st>>>(src, crop, in_w, bounds, kk, ksize, out_w, t);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Vertical pass from tmp (in_h, w, C) into out (out_h, w, C). form 0: RGB
// uint8; 1: RGB float32 x / 255; 2: L uint8, its texels above 0 folded into
// `bbox` (4 int32, zeroed first). Returns a cudaError_t (0 on success).
extern "C" int pil_resample_v(int form, const void *tmp, int w, const void *taps, int ksize, int out_h, void *out,
                              void *bbox, void *stream) {
    if (w < 1 || out_h < 1 || ksize < 1 || !tmp || !taps || !out) return (int)cudaErrorInvalidValue;
    const int *bounds = static_cast<const int *>(taps);
    const int *kk = bounds + 2 * out_h;
    const unsigned char *t = static_cast<const unsigned char *>(tmp);
    int *b = static_cast<int *>(bbox);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const dim3 grid = grid_of(w, out_h);
    if (form == OUT_RGB_U8) {
        resample_v<3, false, false><<<grid, THREADS, 0, st>>>(t, w, bounds, kk, ksize, out_h, out, b);
    } else if (form == OUT_RGB_F32) {
        resample_v<3, true, false><<<grid, THREADS, 0, st>>>(t, w, bounds, kk, ksize, out_h, out, b);
    } else if (form == OUT_L_BBOX && b) {
        const cudaError_t err = cudaMemsetAsync(b, 0, 4 * sizeof(int), st);
        if (err != cudaSuccess) return (int)err;
        resample_v<1, false, true><<<grid, THREADS, 0, st>>>(t, w, bounds, kk, ksize, out_h, out, b);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// The padded RGBA square (s, s, 4) of the (photo_h, photo_w, 3) photo's cutout.
// Returns a cudaError_t (0 on success).
extern "C" int pil_cutout_rgba(const void *photo, const void *mask, int oy, int ox, int hc, int wc, int y1, int x1,
                               int photo_h, int photo_w, int s, void *out, void *stream) {
    const Crop crop{static_cast<const unsigned char *>(mask), oy, ox, hc, wc, y1, x1, photo_h, photo_w};
    if (s < 1 || !photo || !out || !valid_crop(crop, s, s)) return (int)cudaErrorInvalidValue;
    cutout_rgba<<<grid_of(s, s), THREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char *>(photo), crop, s, static_cast<uchar4 *>(out));
    return (int)cudaGetLastError();
}
