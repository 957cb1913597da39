// bilinear: resample channels-last float32 images at image coordinates,
// forward and backward, one thread per output sample.
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
// Backward: each tap's weight times the sample's cotangent is added with a
// float32 atomicAdd into the zeroed image gradient, which is what JAX's
// transpose of the gather does (a scatter-add); the sum order changes from
// run to run. No coordinate gradient: no caller differentiates the coords.
//
// What bounds it on the H100: memory. Per sample 8 bytes of coords in,
// 4 taps x C floats gathered (neighbouring samples hit neighbouring pixels,
// so most taps come from L1/L2) and C floats out; the backward's atomics
// land on few pixels per sample. A first version: no shared-memory tiling.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Taps {
    long long i00, i01, i10, i11;  // pixel offsets (y * W + x) of the taps
    float wy, wx, ay, ax;          // fractions and their complements
    float keep;                    // 0 when zeros-padding drops the sample
};

__device__ __forceinline__ Taps taps_of(float row, float col, int h, int w,
                                        int mode) {
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
    if (mode == 1) {
        x0c = ((x0 % w) + w) % w;
        x1c = (((x0 + 1) % w) + w) % w;
    } else {
        x0c = min(max(x0, 0), w - 1);
        x1c = min(max(x0 + 1, 0), w - 1);
    }
    t.i00 = (long long)y0c * w + x0c;
    t.i01 = (long long)y0c * w + x1c;
    t.i10 = (long long)y1c * w + x0c;
    t.i11 = (long long)y1c * w + x1c;
    t.keep = 1.0f;
    if (mode == 2 && !(py >= 0.0f && py <= (float)(h - 1) && px >= 0.0f &&
                       px <= (float)(w - 1)))
        t.keep = 0.0f;
    return t;
}

__global__ void __launch_bounds__(THREADS)
bilinear_fwd_kernel(const float* __restrict__ img, int b, int h, int w, int c,
                    const float* __restrict__ coords, long long m,
                    int mode, float* __restrict__ out) {
    const long long total = (long long)b * m;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        const Taps t = taps_of(coords[2 * i], coords[2 * i + 1], h, w, mode);
        const float* base = img + (i / m) * (long long)h * w * c;
        float* o = out + i * c;
        for (int ch = 0; ch < c; ++ch) {
            const float v00 = __ldg(base + t.i00 * c + ch);
            const float v01 = __ldg(base + t.i01 * c + ch);
            const float v10 = __ldg(base + t.i10 * c + ch);
            const float v11 = __ldg(base + t.i11 * c + ch);
            float acc = __fmul_rn(__fmul_rn(v00, t.ay), t.ax);
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, t.ay), t.wx));
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, t.wy), t.ax));
            acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, t.wy), t.wx));
            o[ch] = __fmul_rn(acc, t.keep);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
bilinear_bwd_kernel(const float* __restrict__ grad, int b, int h, int w, int c,
                    const float* __restrict__ coords, long long m, int mode,
                    float* __restrict__ grad_img) {
    const long long total = (long long)b * m;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        const Taps t = taps_of(coords[2 * i], coords[2 * i + 1], h, w, mode);
        if (t.keep == 0.0f) continue;             // adds only zeros
        float* base = grad_img + (i / m) * (long long)h * w * c;
        const float* g = grad + i * c;
        for (int ch = 0; ch < c; ++ch) {
            const float gc = g[ch];
            if (gc == 0.0f) continue;
            atomicAdd(base + t.i00 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.ay));
            atomicAdd(base + t.i01 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.ay));
            atomicAdd(base + t.i10 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.wy));
            atomicAdd(base + t.i11 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.wy));
        }
    }
}

unsigned grid_for(long long total) {
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > 132 * 32) blocks = 132 * 32;
    return (unsigned)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" int bilinear_fwd_launch(const void* img, int b, int h, int w, int c,
                                   const void* coords, long long m, int mode,
                                   void* out, void* stream) {
    if (h < 1 || w < 1 || c < 1 || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    if (b <= 0 || m <= 0) return (int)cudaSuccess;
    bilinear_fwd_kernel<<<grid_for((long long)b * m), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float*)img, b, h, w, c, (const float*)coords, m, mode,
        (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int bilinear_bwd_launch(const void* grad, int b, int h, int w, int c,
                                   const void* coords, long long m, int mode,
                                   void* grad_img, void* stream) {
    if (h < 1 || w < 1 || c < 1 || mode < 0 || mode > 2)
        return (int)cudaErrorInvalidValue;
    if (b <= 0 || m <= 0) return (int)cudaSuccess;
    bilinear_bwd_kernel<<<grid_for((long long)b * m), THREADS, 0,
                          (cudaStream_t)stream>>>(
        (const float*)grad, b, h, w, c, (const float*)coords, m, mode,
        (float*)grad_img);
    return (int)cudaGetLastError();
}
