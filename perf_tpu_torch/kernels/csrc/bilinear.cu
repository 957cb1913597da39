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
// Backward: JAX's transpose of the gather, a scatter-add of each tap's
// weight times the sample's cotangent into the image gradient. Float
// atomics would add a pixel's products in an order that changes from run
// to run: on an H100 the image gradient of the border-padded card test
// (many samples clamped onto one border pixel) moved by up to 1.48e-6 of
// its largest value between launches (tools/bilinear_spread.py, 200
// launches), past the card test's 1e-6 bar against autograd. So each of
// the two routes sums in an order that does not change, and repeats
// bitwise:
//
// sorted (few samples an image, as the distillation's 256 of a 384 x 384
// view): one block an image zeroes the image's gradient, then takes its
// samples 256 at a time in order; per chunk and channel it sorts the 1024
// products by pixel (CUB's block radix sort, stable: a pixel's products
// stay in (sample, tap) order), sums each pixel's run in float64 and adds
// it to the pixel. The block owns its image, so nothing else writes there:
// no atomics. Its parallelism is the image count, so it suits only a few
// chunks an image: at [60, 384, 384, 1] it takes 0.0217 ms with 256
// samples a view and 0.0399 with 1024, the fixed-point route 0.0335 and
// 0.0760 (float atomics 0.0166 and 0.0196; H100 80GB HBM3, 700 W,
// tools/bilinear_bwd_variants.py).
//
// fixed point (any count): every pass runs over the samples, one a thread
// (the forward's tap code), and touches only the pixels their taps reach:
//   1. clear: each tap's int64 accumulator and float slot set to 0 (many
//      samples may clear one pixel), and the largest finite |cotangent| G
//      folded into one word (atomicMax on the float's bits: order-free);
//   2. add: each product p as the int64 llrint(p * 2^k) with one integer
//      atomic, where 2^k puts m * G (a bound on any pixel's sum: a sample's
//      four weights sum to 1) in [2^60, 2^61); a pixel's k products are
//      then off the exact sum by at most k * m * G * 2^-61, far under
//      float32's rounding; a non-finite product goes to the float slot
//      with a float atomic instead (inf and NaN add up to the same
//      non-finite value in any order);
//   3. round: each tap's pixel gets its float slot plus its int64 sum
//      scaled back and rounded once to float32 (every sample that reaches
//      a pixel writes it the same value); the launch zeroes the image
//      gradient first.
// Where the samples outnumber the pixels, passes over the whole image beat
// the scattered clear and round: at [4, 256, 512, 1] with 131,072 samples
// an image these passes take 0.161 ms, whole-image ones 0.053 (H100,
// tools/bilinear_bwd_variants.py); no caller has that shape yet. No
// coordinate gradient: no caller differentiates the coords.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // backward
constexpr int FWD_THREADS = 1024;
constexpr int MAX_BATCH = 65535;   // gridDim.y

enum Mode { BORDER = 0, WRAP_X = 1, ZEROS = 2 };
enum Route { FIXED_POINT = 0, SORTED = 1 };     // the backward's

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

// 2^k with m * G * 2^k in [2^60, 2^61): any pixel's fixed-point sum stays
// below 2^61 in magnitude.
__device__ __forceinline__ double fixed_scale(const unsigned* gmax, int m) {
    const double bound = (double)__uint_as_float(*gmax) * (double)m;
    return bound > 0.0 ? ldexp(1.0, 60 - ilogb(bound)) : 1.0;
}

// The pixel offsets (y * W + x) * c + ch of a sample's four taps.
__device__ __forceinline__ void tap_slots(const Taps& t, int c, int ch,
                                          int (&q)[4]) {
    q[0] = t.i00 * c + ch;
    q[1] = t.i01 * c + ch;
    q[2] = t.i10 * c + ch;
    q[3] = t.i11 * c + ch;
}

// Pass 1 (grid: ceil(m / THREADS) x B; *gmax starts at 0): non-negative
// floats order as their bits do.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
bwd_clear_kernel(const float* __restrict__ grad, int h, int w, int c,
                 const float2* __restrict__ coords, int m,
                 unsigned* __restrict__ gmax,
                 unsigned long long* __restrict__ acc,
                 float* __restrict__ special) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    const size_t b = blockIdx.y;
    float v = 0.0f;
    if (i < m) {
        const float2 rc = __ldg(coords + b * (size_t)m + i);
        const Taps t = taps_of<MODE>(rc.x, rc.y, h, w);
        if (t.keep) {                         // a dropped sample adds nothing
            const size_t base = b * (size_t)h * w * c;
            const float* g = grad + (b * (size_t)m + i) * c;
            for (int ch = 0; ch < c; ++ch) {
                const float a = fabsf(__ldg(g + ch));
                if (a <= FLT_MAX) v = fmaxf(v, a);   // not inf, not NaN
                int q[4];
                tap_slots(t, c, ch, q);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    acc[base + q[k]] = 0ull;
                    special[base + q[k]] = 0.0f;
                }
            }
        }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
    if ((threadIdx.x & 31) == 0 && v > 0.0f)
        atomicMax(gmax, __float_as_uint(v));
}

__device__ __forceinline__ void add_product(unsigned long long* acc,
                                            float* special, int i, float p,
                                            double scale) {
    if (fabsf(p) <= FLT_MAX)
        atomicAdd(acc + i, (unsigned long long)__double2ll_rn((double)p * scale));
    else
        atomicAdd(special + i, p);
}

// Pass 2, the same grid.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
bilinear_bwd_kernel(const float* __restrict__ grad, int h, int w, int c,
                    const float2* __restrict__ coords, int m,
                    const unsigned* __restrict__ gmax,
                    unsigned long long* __restrict__ acc,
                    float* __restrict__ special) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const size_t b = blockIdx.y;
    const float2 rc = __ldg(coords + b * (size_t)m + i);
    const Taps t = taps_of<MODE>(rc.x, rc.y, h, w);
    if (!t.keep) return;                      // adds only zeros
    const double scale = fixed_scale(gmax, m);
    const size_t base = b * (size_t)h * w * c;
    unsigned long long* a = acc + base;
    float* sp = special + base;
    const float* g = grad + (b * (size_t)m + i) * c;
    for (int ch = 0; ch < c; ++ch) {
        const float gc = g[ch];
        if (gc == 0.0f) continue;
        add_product(a, sp, t.i00 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.ay), scale);
        add_product(a, sp, t.i01 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.ay), scale);
        add_product(a, sp, t.i10 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.wy), scale);
        add_product(a, sp, t.i11 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.wy), scale);
    }
}

// Pass 3, the same grid: grad_img at each tap = its float slot plus its
// fixed-point sum scaled back and rounded to float32.
template <int MODE>
__global__ void __launch_bounds__(THREADS)
bwd_round_kernel(int h, int w, int c, const float2* __restrict__ coords,
                 int m, const unsigned* __restrict__ gmax,
                 const long long* __restrict__ acc,
                 const float* __restrict__ special,
                 float* __restrict__ grad_img) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const size_t b = blockIdx.y;
    const float2 rc = __ldg(coords + b * (size_t)m + i);
    const Taps t = taps_of<MODE>(rc.x, rc.y, h, w);
    if (!t.keep) return;
    const double inv = 1.0 / fixed_scale(gmax, m);
    const size_t base = b * (size_t)h * w * c;
    for (int ch = 0; ch < c; ++ch) {
        int q[4];
        tap_slots(t, c, ch, q);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            grad_img[base + q[k]] = __fadd_rn(
                special[base + q[k]],
                __double2float_rn(__ll2double_rn(acc[base + q[k]]) * inv));
    }
}

// The sorted route (grid: B blocks). key_bits: the bits of h * w * c, the
// key of a product that adds nothing.
constexpr int SORT_ITEMS = 4 * THREADS;      // a chunk's taps of a channel

template <int MODE>
__global__ void __launch_bounds__(THREADS)
bwd_sorted_kernel(const float* __restrict__ grad, int h, int w, int c,
                  const float2* __restrict__ coords, int m, int key_bits,
                  float* __restrict__ grad_img) {
    using Sort = cub::BlockRadixSort<unsigned, THREADS, 4, float>;
    __shared__ union {
        typename Sort::TempStorage sort;
        struct { unsigned key[SORT_ITEMS]; float val[SORT_ITEMS]; } run;
    } sm;
    const size_t b = blockIdx.x;
    const unsigned n = (unsigned)h * w * c;
    float* gi = grad_img + b * (size_t)n;
    if ((n & 3) == 0) {                        // gi then 16-byte aligned
        float4* g4 = reinterpret_cast<float4*>(gi);
        for (unsigned i = threadIdx.x; i < n / 4; i += THREADS)
            g4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
        for (unsigned i = threadIdx.x; i < n; i += THREADS) gi[i] = 0.0f;
    }
    __syncthreads();
    for (int start = 0; start < m; start += THREADS) {
        const int i = start + threadIdx.x;
        Taps t = {};
        if (i < m) {
            const float2 rc = __ldg(coords + b * (size_t)m + i);
            t = taps_of<MODE>(rc.x, rc.y, h, w);
        }
        for (int ch = 0; ch < c; ++ch) {
            const float gc = i < m && t.keep
                ? __ldg(grad + (b * (size_t)m + i) * c + ch) : 0.0f;
            const bool on = gc != 0.0f;        // a zero adds nothing
            int q[4];
            tap_slots(t, c, ch, q);
            unsigned key[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) key[k] = on ? (unsigned)q[k] : n;
            float val[4] = {__fmul_rn(__fmul_rn(gc, t.ax), t.ay),
                            __fmul_rn(__fmul_rn(gc, t.wx), t.ay),
                            __fmul_rn(__fmul_rn(gc, t.ax), t.wy),
                            __fmul_rn(__fmul_rn(gc, t.wx), t.wy)};
            Sort(sm.sort).Sort(key, val, 0, key_bits);   // blocked order
            __syncthreads();
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                sm.run.key[4 * threadIdx.x + k] = key[k];
                sm.run.val[4 * threadIdx.x + k] = val[k];
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < 4; ++k) {         // a run's first item sums it
                const int j = 4 * threadIdx.x + k;
                const unsigned px = sm.run.key[j];
                if (px == n || (j > 0 && sm.run.key[j - 1] == px)) continue;
                double sum = 0.0;
                for (int l = j; l < SORT_ITEMS && sm.run.key[l] == px; ++l)
                    sum += (double)sm.run.val[l];
                gi[px] = __fadd_rn(gi[px], __double2float_rn(sum));
            }
            __syncthreads();
        }
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

template <int MODE>
void launch_bwd(const void* grad, int b, int h, int w, int c,
                const void* coords, int m, int route, void* acc,
                void* special, void* gmax, void* grad_img, cudaStream_t s) {
    const float* g = (const float*)grad;
    const float2* co = (const float2*)coords;
    if (route == SORTED) {
        int bits = 1;
        while ((1LL << bits) <= (long long)h * w * c) ++bits;
        bwd_sorted_kernel<MODE><<<b, THREADS, 0, s>>>(
            g, h, w, c, co, m, bits, (float*)grad_img);
        return;
    }
    const dim3 grid((unsigned)((m + THREADS - 1) / THREADS), (unsigned)b);
    unsigned* gm = (unsigned*)gmax;
    float* sp = (float*)special;
    bwd_clear_kernel<MODE><<<grid, THREADS, 0, s>>>(
        g, h, w, c, co, m, gm, (unsigned long long*)acc, sp);
    bilinear_bwd_kernel<MODE><<<grid, THREADS, 0, s>>>(
        g, h, w, c, co, m, gm, (unsigned long long*)acc, sp);
    bwd_round_kernel<MODE><<<grid, THREADS, 0, s>>>(
        h, w, c, co, m, gm, (const long long*)acc, sp, (float*)grad_img);
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

// route: FIXED_POINT or SORTED; for FIXED_POINT acc: B * H * W * C int64
// scratch, special: B * H * W * C float32 scratch (neither needs a fill),
// gmax: one uint32 scratch (SORTED reads none of them). grad_img need not
// be zeroed.
extern "C" int bilinear_bwd_launch(const void* grad, int b, int h, int w, int c,
                                   const void* coords, long long m, int mode,
                                   int route, void* acc, void* special,
                                   void* gmax, void* grad_img, void* stream) {
    if (h < 1 || w < 1 || c < 1 || mode < 0 || mode > 2 || route < 0
        || route > 1)
        return (int)cudaErrorInvalidValue;
    if (b <= 0) return (int)cudaSuccess;
    if (!fits(b, h, w, c, m) || ((uintptr_t)coords & 7)
        || ((uintptr_t)grad_img & 15)
        || (route == FIXED_POINT && ((uintptr_t)acc & 7)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (route == FIXED_POINT) {
        cudaError_t err = cudaMemsetAsync(
            grad_img, 0, (size_t)b * h * w * c * sizeof(float), s);
        if (err == cudaSuccess) err = cudaMemsetAsync(gmax, 0, 4, s);
        if (err != cudaSuccess) return (int)err;
        if (m <= 0) return (int)cudaSuccess;
    }
    if (mode == BORDER) launch_bwd<BORDER>(grad, b, h, w, c, coords, (int)m, route, acc, special, gmax, grad_img, s);
    else if (mode == WRAP_X) launch_bwd<WRAP_X>(grad, b, h, w, c, coords, (int)m, route, acc, special, gmax, grad_img, s);
    else launch_bwd<ZEROS>(grad, b, h, w, c, coords, (int)m, route, acc, special, gmax, grad_img, s);
    return (int)cudaGetLastError();
}
