// bilinear: resample channels-last float32 images at image coordinates,
// forward and backward.
//
// Replaces (JAX): perf_tpu/core/resample.py bilinear_sample (and pano_sample,
// its wrap_x form), vmapped over a leading batch of images where the
// distillation samples its 60 views at once (perf_tpu/priors/pano_joint.py).
//
// Layout: img [B, H, W, C] float32, coords [B, M, 2] float32 (row fraction,
// column fraction), out [B, M, C]. Per sample: py = row * H - 0.5,
// px = col * W - 0.5; the four taps (floor, floor + 1) clamp to the image
// in y, and in x clamp (border, zeros) or wrap (wrap_x); the weights are
// JAX's: ((v00 * (1 - wy)) * (1 - wx) + (v01 * (1 - wy)) * wx)
// + (v10 * wy) * (1 - wx) + (v11 * wy) * wx, rounded as JAX rounds (no
// contraction). zeros multiplies the whole sample by 0 when its centre lies
// outside [0, H-1] x [0, W-1].
//
// What bounds the forward on the H100: not HBM. At the visibility core's
// shape (C = 1, 8.4 M samples over a 33.5 MB padded pano stack) each sample
// is 8 bytes of coordinates in, 4 bytes out and 4 scattered 4-byte taps.
// Where the coordinates are random, the taps touch about two distinct
// 32-byte sectors a sample, nearly all missing L1; this kernel and
// grid_sample then take the same time, which points at the L2's sector
// rate (a hypothesis: no counter was read). Where they are the path's
// (neighbouring samples read neighbouring pixels), the taps mostly hit L1
// and the instructions and the lines each SM's L1 must hold bound it. So
// the design keeps both low:
//   - the image comes from the grid (blockIdx.y): no division per sample;
//   - offsets inside an image are 32-bit (the wrapper refuses an image of
//     2^31 elements or more), bases are 64-bit once per block;
//   - the channel count and the padding mode are template parameters for
//     the counts the main path passes (1: distance maps and depth biases,
//     2: the anchor reference, 3: panos and normals, 7: the distillation's
//     view stack); one generic instantiation of the same kernel takes any
//     other count at run time;
//   - one sample a thread in blocks of 1024, its coordinates one float2
//     read evict-first and its outputs written evict-first (both pass
//     once), its 4 C tap loads all issued before any is used; a tap's
//     channels are one float2 load when C = 2 (the wrapper copies an
//     image that is not 8-byte aligned).
// Of the variants perf_tpu_torch/tools/bilinear_variants.py times (1, 2,
// 4 or 8 samples a thread, pairs of neighbours as one float4, a one-wave
// grid-stride loop, cache hints, blocks of 128 to 1024), this one is the
// fastest at random coordinates, where it mostly beats grid_sample by
// ~0.5% (the others tie or lose to it). Blocks of 128 are ~12% faster at
// the path's coordinates but lose to grid_sample at random ones by ~0.3%.
//
// Backward: each tap's weight times the sample's cotangent is added with a
// float32 atomicAdd into the zeroed image gradient, which is what JAX's
// transpose of the gather does (a scatter-add); the sum order changes from
// run to run. It shares the forward's tap code (image from the grid, 32-bit
// offsets), one sample per thread. No coordinate gradient: no caller
// differentiates the coords.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // backward
constexpr int FWD_THREADS = 1024;
constexpr int MAX_BATCH = 65535;   // gridDim.y

enum Mode { BORDER = 0, WRAP_X = 1, ZEROS = 2 };

struct Taps {
    int i00, i01, i10, i11;        // pixel offsets (y * W + x) in the image
    float wy, wx, ay, ax;          // fractions and their complements
    bool keep;                     // false when zeros-padding drops it
};

template <int MODE>
__device__ __forceinline__ Taps taps_of(float row, float col, int h, int w) {
    const float py = __fsub_rn(__fmul_rn(row, (float)h), 0.5f);
    const float px = __fsub_rn(__fmul_rn(col, (float)w), 0.5f);
    const float y0f = floorf(py), x0f = floorf(px);
    Taps t;
    t.wy = __fsub_rn(py, y0f);
    t.wx = __fsub_rn(px, x0f);
    t.ay = __fsub_rn(1.0f, t.wy);
    t.ax = __fsub_rn(1.0f, t.wx);
    const int y0 = (int)y0f, x0 = (int)x0f;
    const int y0c = min(max(y0, 0), h - 1), y1c = min(max(y0 + 1, 0), h - 1);
    int x0c, x1c;
    if (MODE == WRAP_X) {
        x0c = ((x0 % w) + w) % w;
        x1c = (((x0 + 1) % w) + w) % w;
    } else {
        x0c = min(max(x0, 0), w - 1);
        x1c = min(max(x0 + 1, 0), w - 1);
    }
    t.i00 = y0c * w + x0c;
    t.i01 = y0c * w + x1c;
    t.i10 = y1c * w + x0c;
    t.i11 = y1c * w + x1c;
    t.keep = MODE != ZEROS || (py >= 0.0f && py <= (float)(h - 1)
                               && px >= 0.0f && px <= (float)(w - 1));
    return t;
}

// One channel of a sample from its four tap values, in JAX's order.
__device__ __forceinline__ float blend(const Taps& t, float v00, float v01,
                                       float v10, float v11) {
    float acc = __fmul_rn(__fmul_rn(v00, t.ay), t.ax);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, t.ay), t.wx));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, t.wy), t.ax));
    return __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, t.wy), t.wx));
}

// C > 0: a fixed channel count (C == 2 with float2 taps); C == 0: `c` at run
// time. Grid: (ceil(m / FWD_THREADS), B).
template <int C, int MODE>
__global__ void __launch_bounds__(FWD_THREADS)
bilinear_fwd_kernel(const float* __restrict__ img, int h, int w, int c_rt,
                    const float2* __restrict__ coords, int m,
                    float* __restrict__ out) {
    const int i = blockIdx.x * FWD_THREADS + threadIdx.x;
    if (i >= m) return;
    const int c = C > 0 ? C : c_rt;
    const size_t b = blockIdx.y;
    const float* image = img + b * (size_t)h * w * c;
    const float2 rc = __ldcs(coords + b * (size_t)m + i);
    const Taps t = taps_of<MODE>(rc.x, rc.y, h, w);
    float* o = out + (b * (size_t)m + i) * c;
    if constexpr (C == 0) {                    // the generic channel loop
        for (int ch = 0; ch < c; ++ch) {
            const float v = blend(t, __ldg(image + t.i00 * c + ch),
                                  __ldg(image + t.i01 * c + ch),
                                  __ldg(image + t.i10 * c + ch),
                                  __ldg(image + t.i11 * c + ch));
            __stcs(o + ch, t.keep ? v : __fmul_rn(v, 0.0f));
        }
    } else {
        const int off[4] = {t.i00 * C, t.i01 * C, t.i10 * C, t.i11 * C};
        float v[4][C];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if constexpr (C == 2) {
                const float2 p = __ldg(reinterpret_cast<const float2*>(
                    image + off[q]));
                v[q][0] = p.x;
                v[q][1] = p.y;
            } else {
#pragma unroll
                for (int ch = 0; ch < C; ++ch)
                    v[q][ch] = __ldg(image + off[q] + ch);
            }
        }
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
            const float s = blend(t, v[0][ch], v[1][ch], v[2][ch], v[3][ch]);
            // JAX multiplies by the inside mask: 0 * v, NaN stays NaN
            __stcs(o + ch, t.keep ? s : __fmul_rn(s, 0.0f));
        }
    }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
bilinear_bwd_kernel(const float* __restrict__ grad, int h, int w, int c,
                    const float2* __restrict__ coords, int m,
                    float* __restrict__ grad_img) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const size_t b = blockIdx.y;
    const float2 rc = __ldg(coords + b * (size_t)m + i);
    const Taps t = taps_of<MODE>(rc.x, rc.y, h, w);
    if (!t.keep) return;                      // adds only zeros
    float* base = grad_img + b * (size_t)h * w * c;
    const float* g = grad + (b * (size_t)m + i) * c;
    for (int ch = 0; ch < c; ++ch) {
        const float gc = g[ch];
        if (gc == 0.0f) continue;
        atomicAdd(base + t.i00 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.ay));
        atomicAdd(base + t.i01 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.ay));
        atomicAdd(base + t.i10 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.wy));
        atomicAdd(base + t.i11 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.wy));
    }
}

bool fits(int b, int h, int w, int c, long long m) {
    return b <= MAX_BATCH && (long long)h * w * c < (1LL << 31)
           && m * (c > 2 ? c : 2) < (1LL << 31);
}

template <int C, int MODE>
void launch_fwd(const float* img, int b, int h, int w, int c,
                const float2* coords, int m, float* out, cudaStream_t s) {
    const dim3 grid((unsigned)((m + FWD_THREADS - 1) / FWD_THREADS),
                    (unsigned)b);
    bilinear_fwd_kernel<C, MODE><<<grid, FWD_THREADS, 0, s>>>(
        img, h, w, c, coords, m, out);
}

template <int MODE>
void dispatch_fwd(const float* img, int b, int h, int w, int c,
                  const float2* coords, int m, float* out, cudaStream_t s) {
    switch (c) {
    case 1: launch_fwd<1, MODE>(img, b, h, w, c, coords, m, out, s); return;
    case 2: launch_fwd<2, MODE>(img, b, h, w, c, coords, m, out, s); return;
    case 3: launch_fwd<3, MODE>(img, b, h, w, c, coords, m, out, s); return;
    case 7: launch_fwd<7, MODE>(img, b, h, w, c, coords, m, out, s); return;
    default: launch_fwd<0, MODE>(img, b, h, w, c, coords, m, out, s);
    }
}

}  // namespace

extern "C" int bilinear_fwd_launch(const void* img, int b, int h, int w, int c,
                                   const void* coords, long long m, int mode,
                                   void* out, void* stream) {
    if (h < 1 || w < 1 || c < 1 || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    if (b <= 0 || m <= 0) return (int)cudaSuccess;
    if (!fits(b, h, w, c, m) || ((uintptr_t)coords & 7)
        || ((uintptr_t)img & 7))
        return (int)cudaErrorInvalidValue;
    const float* im = (const float*)img;
    const float2* co = (const float2*)coords;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == BORDER) dispatch_fwd<BORDER>(im, b, h, w, c, co, (int)m, o, s);
    else if (mode == WRAP_X) dispatch_fwd<WRAP_X>(im, b, h, w, c, co, (int)m, o, s);
    else dispatch_fwd<ZEROS>(im, b, h, w, c, co, (int)m, o, s);
    return (int)cudaGetLastError();
}

extern "C" int bilinear_bwd_launch(const void* grad, int b, int h, int w, int c,
                                   const void* coords, long long m, int mode,
                                   void* grad_img, void* stream) {
    if (h < 1 || w < 1 || c < 1 || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    if (b <= 0 || m <= 0) return (int)cudaSuccess;
    if (!fits(b, h, w, c, m) || ((uintptr_t)coords & 7))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((m + THREADS - 1) / THREADS), (unsigned)b);
    const float* g = (const float*)grad;
    const float2* co = (const float2*)coords;
    float* gi = (float*)grad_img;
    cudaStream_t s = (cudaStream_t)stream;
    if (mode == BORDER)
        bilinear_bwd_kernel<BORDER><<<grid, THREADS, 0, s>>>(g, h, w, c, co, (int)m, gi);
    else if (mode == WRAP_X)
        bilinear_bwd_kernel<WRAP_X><<<grid, THREADS, 0, s>>>(g, h, w, c, co, (int)m, gi);
    else
        bilinear_bwd_kernel<ZEROS><<<grid, THREADS, 0, s>>>(g, h, w, c, co, (int)m, gi);
    return (int)cudaGetLastError();
}
