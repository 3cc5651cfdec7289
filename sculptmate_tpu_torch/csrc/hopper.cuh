// Shared helpers for the port's Hopper kernels (sm_90a): bf16 packing,
// mbarriers, TMA tensor loads, wgmma descriptors and the wgmma products the
// kernels issue, and the host-side encoding of TMA tensor maps.
//
// Layouts every kernel here relies on (lane = threadIdx.x % 32, w = warp in
// its warpgroup, g = lane / 4, c = (lane % 4) * 2):
//   wgmma m64nN f32 accumulator d[4j .. 4j+3], j = 0 .. N/8-1:
//     d[4j], d[4j+1] = D[16w + g][8j + c .. +1]
//     d[4j+2], d[4j+3] = D[16w + g + 8][8j + c .. +1]
//   wgmma m64k16 register A fragment (bf16 pairs) a[0..3]:
//     a0 = A[16w + g][c .. +1]       a1 = A[16w + g + 8][c .. +1]
//     a2 = A[16w + g][c + 8 .. +9]   a3 = A[16w + g + 8][c + 8 .. +9]
// so the accumulator blocks j = 2kc, 2kc+1 of one product, packed to bf16,
// ARE the A fragment of k-chunk kc of the next product: activations and
// probabilities never leave registers between products.
//
// Shared-memory tiles are rows of 64 bf16 (128 bytes) in the 128-byte
// swizzle that TMA writes (CU_TENSOR_MAP_SWIZZLE_128B): 16-byte chunk q of
// row r sits at chunk q ^ (r % 8), in atoms of 8 rows = 1024 bytes, each
// tile 1024-byte aligned. The wgmma descriptors below read that layout
// (layout type 1 = 128-byte swizzle, stride between 8-row groups 1024 B).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm_port {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t *>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// returns once the phase of parity `parity` has completed; a wait that
// never completes (a lost arrival) traps after ~2^34 cycles (~10 s) instead
// of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    const long long t0 = clock64();
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (!done && clock64() - t0 > (1ll << 34)) __trap();
    } while (!done);
}
// generic-proxy writes to shared memory, made visible to wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// per-thread register budget of the calling warpgroup from here on (a
// multiple of 8): dec hands registers back to the SM, inc waits for them
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barriers over `n` threads (ids 1..15; 0 is __syncthreads): sync
// waits until n threads have arrived, arrive counts this warp and goes on
__device__ __forceinline__ void named_bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// four 8x8 b16 matrices from shared memory in the mma fragment layout: lane
// l gives the address of row l % 8 of matrix l / 8 (16 contiguous bytes);
// r[i] gets row lane / 4, columns 2 (lane % 4) .. +1 of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// ---- TMA -------------------------------------------------------------------
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                            int c0, int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap *map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
          "r"(c3)
        : "memory");
}

// a contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory to shared memory, completing on the mbarrier's tx count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void *src, uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
        : "memory");
}

// ---- wgmma -----------------------------------------------------------------
// Descriptor of a 128-byte-swizzled tile at shared address `addr`: K-major
// (rows are M or N, 64 bf16 of K each; advance K by 16 with +32 bytes) or
// MN-major (rows are K, 64 bf16 of N each; advance K by 16 with +2048 bytes).
// Either way 8-row groups lie 1024 bytes apart (SBO); LBO is unused within
// one 64-wide swizzle atom along K or N. An MN-major operand wider than 64
// (K1's V at head dim 88) spans several atoms along N: `lbo` is then the
// byte distance between them.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo = 16) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins accumulators that an in-flight wgmma writes, so the compiler
// neither moves nor reuses them across the asynchronous region
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma m64nNk16, N picked by the size of the accumulator array (N / 2
// floats). TB = 0: B is K-major; TB = 1: B is MN-major (transposed). A in
// shared memory (_ss) is K-major; A in registers (_rs) is the fragment above.

template <int TB>  // m64n128k16
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>  // m64n96k16
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, %51;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>  // m64n64k16
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>  // m64n64k16
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>  // m64n96k16
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>  // m64n8k16
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// ---- bf16 pairs and the 64-wide MLP layers of K2, K4 and K5 -----------------
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
    uint32_t r;
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
    return r;
}

// silu(x) for a bf16 pair given h = x / 2: h (1 + tanh h)
__device__ __forceinline__ uint32_t silu_of_half(uint32_t h) {
    uint32_t t, r;
    asm("tanh.approx.bf16x2 %0, %1;\n" : "=r"(t) : "r"(h));
    asm("fma.rn.bf16x2 %0, %1, %2, %1;\n" : "=r"(r) : "r"(h), "r"(t));
    return r;
}

__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// bias + SiLU on one 64-wide layer's accumulators (pre-halved weights and
// bias: d + b = x / 2), packed as the next product's A fragments
__device__ __forceinline__ void hidden_epilogue(uint32_t (&a)[4][4], const float (&d)[32],
                                                const float *__restrict__ bl, int c) {
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int jn = 2 * kc + half;
            const float2 bb = *reinterpret_cast<const float2 *>(bl + 8 * jn + c);
            a[kc][half * 2] = silu_of_half(pack_bf16(d[4 * jn] + bb.x, d[4 * jn + 1] + bb.y));
            a[kc][half * 2 + 1] = silu_of_half(pack_bf16(d[4 * jn + 2] + bb.x, d[4 * jn + 3] + bb.y));
        }
    }
}

// d = a . W for a 64-deep product: a the register A fragments of 64 rows x
// 64 channels, W a swizzled K-major tile of N rows (N = 64 for a hidden
// layer, 8 for an output tile) at descriptor dw; issued and committed as
// one group; with `accumulate` the product adds to d as it stands
template <int NACC>
__device__ __forceinline__ void issue_k64(float (&d)[NACC], const uint32_t (&a)[4][4], uint64_t dw,
                                          bool accumulate = false) {
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<0>(d, a[kc], dw + 2 * kc, accumulate || kc > 0);
    wgmma_commit();
}

}  // namespace sm_port

// ---- host: TMA tensor maps ---------------------------------------------------
// cuTensorMapEncodeTiled lives in libcuda; it is looked up once through
// the runtime, so the kernels link against nothing but cudart.
typedef CUresult (*EncodeTiledFn)(CUtensorMap *, CUtensorMapDataType, cuuint32_t, void *,
                                  const cuuint64_t *, const cuuint64_t *, const cuuint32_t *,
                                  const cuuint32_t *, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map of `rank` dims (innermost first; dim 0 is the 64-wide
// contiguous row) with byte strides of dims 1.. in `strides`, boxes of
// `box`, 128-byte swizzle; elements outside the tensor load as zeros.
// Returns a cudaError_t-compatible code (0 on success).
static inline int encode_bf16_map(CUtensorMap *map, const void *base, int rank,
                                  const cuuint64_t *dims, const cuuint64_t *strides,
                                  const cuuint32_t *box) {
    static EncodeTiledFn encode = nullptr;
    if (!encode) {
        void *fn = nullptr;
        cudaDriverEntryPointQueryResult q;
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
        if (err != cudaSuccess) return (int)err;
        if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorSymbolNotFound;
        encode = reinterpret_cast<EncodeTiledFn>(fn);
    }
    const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
    CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void *>(base),
                        dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
