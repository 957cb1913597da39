// ngp_mlp: the NGP MLP (K2) on the training path, forward and backward,
// with its output activation and AABB select fused in.
//
// Replaces (JAX): perf_tpu/fields/mlp.py ngp_mlp_apply_channels (bf16
// 32 -> 64 -> 1 density head, 32 -> 64 -> 64 -> 3 colour head) and
// ngp_mlp_apply (float32 10 -> 64 -> 1 proposal fields), with
// perf_tpu/fields/ngp.py trunc_exp and the where-select / selector product
// of query_density_ray, query_rgb_ray, query_*_coords and
// query_density_field (ngp.py:64-91, :148-200, :252-261), and their
// autodiff. The plain PyTorch versions are perf_tpu_torch/fields/mlp.py
// ngp_head_plain and ngp_head_bwd_plain.
//
// What bounds it on the H100: per point 2.1k (density), 6.3k (colour) or
// 0.7k (proposal) multiply-adds forward and about three times as many
// backward, against 128 (or 40) bytes of input: the operations, not memory,
// set the time. The bf16 heads' products are bf16 x bf16 with float32 sums,
// which the tensor cores could take at 989 TFLOP/s; this design runs them as
// scalar float32 FMA (67 TFLOP/s), the simple version first.
//
// Design. Forward: one thread per point, as field_eval.cu: the weights in
// shared memory (rounded to bf16 on load where the forward rounds them),
// the 64 hidden units in registers, the epilogue fused; it writes the
// activated channels [C, M] and, for the backward, the raw outputs [C, M].
// Backward: a block takes tiles of 128 points, one thread per point; each
// thread recomputes its point's hidden layers (nothing of them is saved),
// applies the epilogue's derivative (trunc_exp's at the input clamped to
// 15, zero outside the select), forms the cotangents of every hidden
// layer and dx, and stages the tile's layer inputs and pre-activation
// cotangents in shared memory; then the block's threads sum the tile's
// weight-gradient contributions, each thread owning fixed entries: it
// sums the tile's points in order and adds the sum to its entries of the
// block's row of partial sums, which persists in device memory over the
// block's tiles (a thread reads and writes only its own entries). A second
// kernel sums the blocks' rows in block order
// and rounds the bf16 layers' sums once, at the end. No atomics: the
// result repeats bitwise. Rounding to bf16 happens where both packages'
// autodiff rounds: the input and each hidden output forward, each
// cotangent that reaches a bf16 value backward (dx, the hidden layers'
// cotangents, dW0, dW1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HID = 64;
constexpr int THREADS = 128;     // forward: a point a thread; backward: the tile
constexpr int HS = HID + 4;      // a staged row of 64: 16-byte rows, float4
                                 // stores of 8 lanes on distinct banks
constexpr int FWD_MAX_BLOCKS = 132 * 16;

enum { EPI_TRUNC_EXP = 0, EPI_SIGMOID = 1, EPI_TRUNC_EXP_M1 = 2 };

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float rnd(float v) {
    return BF16 ? bf16_round(v) : v;
}

template <int EPI>
__device__ __forceinline__ float epilogue(float raw, bool sel) {
    if (EPI == EPI_SIGMOID)
        return __fmul_rn(1.0f / (1.0f + expf(-raw)), sel ? 1.0f : 0.0f);
    const float z = EPI == EPI_TRUNC_EXP_M1 ? __fsub_rn(raw, 1.0f) : raw;
    return sel ? expf(fminf(z, 80.0f)) : 0.0f;
}

// d raw from the activated channel's cotangent g
template <int EPI>
__device__ __forceinline__ float epilogue_grad(float raw, float g, bool sel) {
    if (EPI == EPI_SIGMOID) {
        const float y = 1.0f / (1.0f + expf(-raw));
        return __fmul_rn(__fmul_rn(g, sel ? 1.0f : 0.0f),
                         __fmul_rn(y, __fsub_rn(1.0f, y)));
    }
    const float z = EPI == EPI_TRUNC_EXP_M1 ? __fsub_rn(raw, 1.0f) : raw;
    return __fmul_rn(sel ? g : 0.0f, expf(fminf(z, 15.0f)));
}

// The layer shapes of one head.
template <int MAX_IN_, int NH_, int C_, bool BF16_, int EPI_>
struct Head {
    static constexpr int MAX_IN = MAX_IN_;     // din <= MAX_IN, a multiple of 8
    static constexpr int NH = NH_;             // hidden layers: 1 or 2
    static constexpr int C = C_;               // output channels
    static constexpr bool BF16 = BF16_;
    static constexpr int EPI = EPI_;
    static constexpr int AS = MAX_IN + 4;      // a staged input row
    static constexpr int NW1 = NH == 2 ? HID * HID : 0;
    static constexpr int NWL = (HID * C + 3) / 4 * 4;
    static constexpr int W_FLOATS = MAX_IN * HID + NW1 + NWL;
    // backward shared memory: the weights, then the tile's input rows, the
    // first hidden layer's outputs and cotangents, (NH == 2) the second's,
    // and the raw cotangents (4 a point)
    static constexpr int BWD_FLOATS = W_FLOATS + THREADS * (AS + 4)
                                      + THREADS * HS * (NH == 2 ? 4 : 2);
};

using GeoHead = Head<32, 1, 1, true, EPI_TRUNC_EXP>;
using AppHead = Head<32, 2, 3, true, EPI_SIGMOID>;
using PropHead = Head<16, 1, 1, false, EPI_TRUNC_EXP_M1>;

// The weights into shared memory: W0 [din, 64] (rows past din zero), W1
// [64, 64], WL [64, C]; the bf16 heads' hidden layers rounded to bf16.
template <class H>
__device__ __forceinline__ void load_weights(const float* __restrict__ w0,
                                             const float* __restrict__ w1,
                                             const float* __restrict__ wl,
                                             int din, float* s) {
    for (int e = threadIdx.x; e < H::MAX_IN * HID; e += blockDim.x)
        s[e] = e < din * HID ? rnd<H::BF16>(w0[e]) : 0.0f;
    for (int e = threadIdx.x; e < H::NW1; e += blockDim.x)
        s[H::MAX_IN * HID + e] = rnd<H::BF16>(w1[e]);
    for (int e = threadIdx.x; e < HID * H::C; e += blockDim.x)
        s[H::MAX_IN * HID + H::NW1 + e] = wl[e];
}

// A point's input row, rounded where the forward rounds; zeros past din.
template <class H>
__device__ __forceinline__ void load_input(const float* __restrict__ row,
                                           int din, float* xin) {
#pragma unroll
    for (int k = 0; k < H::MAX_IN; ++k)
        xin[k] = k < din ? rnd<H::BF16>(__ldg(row + k)) : 0.0f;
}

// out[j] = sum_k in[k] * W[k, j] over k < n (W row-major [., 64] in shared
// memory, read as float4 broadcasts).
template <int K>
__device__ __forceinline__ void layer(const float* in, const float* W, int n,
                                      float* out) {
#pragma unroll
    for (int j = 0; j < HID; ++j) out[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (k < n) {
            const float a = in[k];
            const float4* w = reinterpret_cast<const float4*>(W + k * HID);
#pragma unroll
            for (int q = 0; q < HID / 4; ++q) {
                const float4 v = w[q];
                out[4 * q] = fmaf(a, v.x, out[4 * q]);
                out[4 * q + 1] = fmaf(a, v.y, out[4 * q + 1]);
                out[4 * q + 2] = fmaf(a, v.z, out[4 * q + 2]);
                out[4 * q + 3] = fmaf(a, v.w, out[4 * q + 3]);
            }
        }
    }
}

// sum_j a[j] * W[k, j] for one row k of W (float4 broadcasts).
__device__ __forceinline__ float row_dot(const float* a, const float* Wk) {
    const float4* w = reinterpret_cast<const float4*>(Wk);
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < HID / 4; ++q) {
        const float4 v = w[q];
        acc = fmaf(a[4 * q], v.x, acc);
        acc = fmaf(a[4 * q + 1], v.y, acc);
        acc = fmaf(a[4 * q + 2], v.z, acc);
        acc = fmaf(a[4 * q + 3], v.w, acc);
    }
    return acc;
}

// ReLU and rounding in place; returns the bit mask of pre-activations > 0.
template <bool BF16>
__device__ __forceinline__ unsigned long long activate(float* h) {
    unsigned long long mask = 0ull;
#pragma unroll
    for (int j = 0; j < HID; ++j) {
        if (h[j] > 0.0f) mask |= 1ull << j;
        h[j] = rnd<BF16>(fmaxf(h[j], 0.0f));
    }
    return mask;
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float* v) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <class H>
__global__ void __launch_bounds__(THREADS)
mlp_fwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ sel,
               long long m, int din, const float* __restrict__ w0,
               const float* __restrict__ w1, const float* __restrict__ wl,
               float* __restrict__ out, float* __restrict__ raw) {
    __shared__ __align__(16) float sw[H::W_FLOATS];
    load_weights<H>(w0, w1, wl, din, sw);
    __syncthreads();
    const float* s0 = sw;
    const float* s1 = s0 + H::MAX_IN * HID;
    const float* sl = s1 + H::NW1;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += (long long)gridDim.x * blockDim.x) {
        float xin[H::MAX_IN];
        load_input<H>(x + i * din, din, xin);
        float h[HID];
        layer<H::MAX_IN>(xin, s0, din, h);
        activate<H::BF16>(h);
        if constexpr (H::NH == 2) {
            float a[HID];
            layer<HID>(h, s1, HID, a);
            activate<H::BF16>(a);
#pragma unroll
            for (int j = 0; j < HID; ++j) h[j] = a[j];
        }
        const bool s = sel[i] != 0;
#pragma unroll
        for (int c = 0; c < H::C; ++c) {
            float o = 0.0f;
#pragma unroll
            for (int j = 0; j < HID; ++j) o = fmaf(h[j], sl[j * H::C + c], o);
            out[c * m + i] = epilogue<H::EPI>(o, s);
            if (raw) raw[c * m + i] = o;
        }
    }
}

// sums[q * 64] += the tile's sum over its points p of a[p, q] * d[p], for
// q < n (the first n of K entries; rows of a at stride AS, of d at stride
// HS), point by point in order. Adding each tile's sum, not each point's,
// keeps the float32 sum over the block's points two-level.
template <int K, int AS>
__device__ __forceinline__ void accumulate(const float* a, const float* d,
                                           float* sums, int n) {
    float g[K];
#pragma unroll
    for (int q = 0; q < K; ++q) g[q] = 0.0f;
    for (int p = 0; p < THREADS; ++p) {
        const float dj = d[p * HS];
        const float4* ar = reinterpret_cast<const float4*>(a + p * AS);
#pragma unroll
        for (int q = 0; q < K / 4; ++q) {
            const float4 v = ar[q];
            g[4 * q] = fmaf(v.x, dj, g[4 * q]);
            g[4 * q + 1] = fmaf(v.y, dj, g[4 * q + 1]);
            g[4 * q + 2] = fmaf(v.z, dj, g[4 * q + 2]);
            g[4 * q + 3] = fmaf(v.w, dj, g[4 * q + 3]);
        }
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
        if (q < n) sums[q * HID] += g[q];
}

template <class H>
__global__ void __launch_bounds__(THREADS)
mlp_bwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ sel,
               const float* __restrict__ raw, const float* __restrict__ g,
               long long m, int din, const float* __restrict__ w0,
               const float* __restrict__ w1, const float* __restrict__ wl,
               float* __restrict__ dx, float* __restrict__ part, int n_w) {
    extern __shared__ __align__(16) float smem[];
    constexpr int K0 = H::MAX_IN / 2;     // the dW0 rows a thread owns
    constexpr int K1 = HID / 2;           // the dW1 rows a thread owns
    float* s0 = smem;
    float* s1 = s0 + H::MAX_IN * HID;
    float* sl = s1 + H::NW1;
    float* a0 = s0 + H::W_FLOATS;         // [THREADS, AS] inputs
    float* a1 = a0 + THREADS * H::AS;     // [THREADS, HS] first hidden outputs
    float* d1 = a1 + THREADS * HS;        // their pre-activations' cotangents
    float* a2 = d1 + THREADS * HS;        // (NH == 2) second hidden outputs
    float* d2 = a2 + (H::NH == 2 ? THREADS * HS : 0);
    float* dr = d2 + (H::NH == 2 ? THREADS * HS : 0);   // [THREADS, 4]
    load_weights<H>(w0, w1, wl, din, s0);
    __syncthreads();

    const int t = threadIdx.x;
    // the weight-gradient entries the thread owns: column j of W0's rows
    // kg * K0 + q and of W1's rows kg * K1 + q, and (kg == 0) row j of WL.
    // Their sums over the block's tiles live in the block's row of the
    // partials (read and written by their owner only), so they hold no
    // registers while the thread's own pass runs.
    const int j = t % HID, kg = t / HID;
    float* pb = part + (long long)blockIdx.x * n_w;  // [W0, W1, WL] sums
    float* p0 = pb + (kg * K0) * HID + j;
    float* p1 = pb + din * HID + (kg * K1) * HID + j;
    float* pl = pb + din * HID + H::NW1 + j * H::C;
#pragma unroll
    for (int q = 0; q < K0; ++q)
        if (kg * K0 + q < din) p0[q * HID] = 0.0f;
    if constexpr (H::NH == 2) {
#pragma unroll
        for (int q = 0; q < K1; ++q) p1[q * HID] = 0.0f;
    }
    if (kg == 0) {
#pragma unroll
        for (int c = 0; c < H::C; ++c) pl[c] = 0.0f;
    }

    const long long n_tiles = (m + THREADS - 1) / THREADS;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        // the point's own pass: recompute, cotangents, dx, staged rows
        const long long i = tile * THREADS + t;
        const bool live = i < m;
        float xin[H::MAX_IN];
        if (live) {
            load_input<H>(x + i * din, din, xin);
        } else {
#pragma unroll
            for (int k = 0; k < H::MAX_IN; ++k) xin[k] = 0.0f;
        }
        store_row<H::MAX_IN>(a0 + t * H::AS, xin);
        float h[HID];
        layer<H::MAX_IN>(xin, s0, din, h);
        const unsigned long long m1 = activate<H::BF16>(h);
        store_row<HID>(a1 + t * HS, h);
        float drc[H::C];
        const bool s = live && sel[i] != 0;
#pragma unroll
        for (int c = 0; c < H::C; ++c) {
            drc[c] = live ? epilogue_grad<H::EPI>(raw[c * m + i], g[c * m + i], s)
                          : 0.0f;
            dr[t * 4 + c] = drc[c];
        }
        float dl[HID];    // the last hidden layer's pre-activation cotangents
        {
            float a[HID];
            unsigned long long ml = m1;
            if constexpr (H::NH == 2) {
                layer<HID>(h, s1, HID, a);
                ml = activate<H::BF16>(a);
                store_row<HID>(a2 + t * HS, a);
            }
            // the channels' cotangents summed in channel order, unfused
#pragma unroll
            for (int jj = 0; jj < HID; ++jj) {
                float acc = __fmul_rn(drc[0], sl[jj * H::C]);
#pragma unroll
                for (int c = 1; c < H::C; ++c)
                    acc = __fadd_rn(acc, __fmul_rn(drc[c], sl[jj * H::C + c]));
                dl[jj] = (ml >> jj) & 1ull ? rnd<H::BF16>(acc) : 0.0f;
            }
        }
        if constexpr (H::NH == 2) {
            store_row<HID>(d2 + t * HS, dl);
#pragma unroll
            for (int k = 0; k < HID; ++k)
                h[k] = (m1 >> k) & 1ull ? rnd<H::BF16>(row_dot(dl, s1 + k * HID))
                                        : 0.0f;
        } else {
#pragma unroll
            for (int k = 0; k < HID; ++k) h[k] = dl[k];
        }
        store_row<HID>(d1 + t * HS, h);       // h: the first layer's cotangents
        if (dx != nullptr && live) {
#pragma unroll
            for (int k = 0; k < H::MAX_IN; ++k)
                if (k < din) dx[i * din + k] = rnd<H::BF16>(row_dot(h, s0 + k * HID));
        }
        __syncthreads();

        // the tile's weight-gradient contributions, point by point in order
        accumulate<K0, H::AS>(a0 + kg * K0, d1 + j, p0, din - kg * K0);
        if constexpr (H::NH == 2)
            accumulate<K1, HS>(a1 + kg * K1, d2 + j, p1, K1);
        if (kg == 0) {
            const float* al = H::NH == 2 ? a2 : a1;
            float gl[H::C];
#pragma unroll
            for (int c = 0; c < H::C; ++c) gl[c] = 0.0f;
            for (int p = 0; p < THREADS; ++p) {
                const float hj = al[p * HS + j];
#pragma unroll
                for (int c = 0; c < H::C; ++c) gl[c] = fmaf(hj, dr[p * 4 + c], gl[c]);
            }
#pragma unroll
            for (int c = 0; c < H::C; ++c) pl[c] += gl[c];
        }
        __syncthreads();
    }
}

// grad[e] = the blocks' partials summed in block order; the first n_round
// entries (the bf16 layers) rounded to bf16.
__global__ void mlp_grad_reduce_kernel(const float* __restrict__ part,
                                       int n_blocks, int n_w, int n_round,
                                       float* __restrict__ grad) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_w) return;
    float s = 0.0f;
    for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * n_w + e];
    grad[e] = e < n_round ? bf16_round(s) : s;
}

template <class H>
int fwd_launch(const void* x, const void* sel, long long m, int din,
               const void* w0, const void* w1, const void* wl, void* out,
               void* raw, cudaStream_t stream) {
    if (din < 1 || din > H::MAX_IN) return (int)cudaErrorInvalidValue;
    if (m <= 0) return (int)cudaSuccess;
    long long blocks = (m + THREADS - 1) / THREADS;
    if (blocks > FWD_MAX_BLOCKS) blocks = FWD_MAX_BLOCKS;
    mlp_fwd_kernel<H><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const float*)x, (const uint8_t*)sel, m, din, (const float*)w0,
        (const float*)w1, (const float*)wl, (float*)out, (float*)raw);
    return (int)cudaGetLastError();
}

template <class H>
int bwd_launch(const void* x, const void* sel, const void* raw, const void* g,
               long long m, int din, const void* w0, const void* w1,
               const void* wl, void* dx, void* part, int n_blocks, void* grad,
               cudaStream_t stream) {
    if (din < 1 || din > H::MAX_IN || n_blocks < 1) return (int)cudaErrorInvalidValue;
    const int n_w = din * HID + H::NW1 + HID * H::C;
    const size_t smem = sizeof(float) * H::BWD_FLOATS;
    cudaError_t err = cudaFuncSetAttribute(
        mlp_bwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bwd_kernel<H><<<n_blocks, THREADS, smem, stream>>>(
        (const float*)x, (const uint8_t*)sel, (const float*)raw, (const float*)g,
        m, din, (const float*)w0, (const float*)w1, (const float*)wl,
        (float*)dx, (float*)part, n_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    mlp_grad_reduce_kernel<<<(n_w + 255) / 256, 256, 0, stream>>>(
        (const float*)part, n_blocks, n_w, H::BF16 ? din * HID + H::NW1 : 0,
        (float*)grad);
    return (int)cudaGetLastError();
}

}  // namespace

// head: 0 density (bf16, 1 hidden layer, 1 channel, trunc_exp), 1 colour
// (bf16, 2 hidden layers, 3 channels, sigmoid), 2 proposal density
// (float32, 1 hidden layer, 1 channel, trunc_exp(raw - 1)). x [m, din]
// float32, sel [m] bool, W0 [din, 64], W1 [64, 64] (colour only), WL [64,
// C] float32; out and raw [C, m] float32 (raw may be null).
extern "C" int ngp_mlp_fwd_launch(int head, const void* x, const void* sel,
                                  long long m, int din, const void* w0,
                                  const void* w1, const void* wl, void* out,
                                  void* raw, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (head) {
        case 0: return fwd_launch<GeoHead>(x, sel, m, din, w0, w1, wl, out, raw, s);
        case 1: return fwd_launch<AppHead>(x, sel, m, din, w0, w1, wl, out, raw, s);
        case 2: return fwd_launch<PropHead>(x, sel, m, din, w0, w1, wl, out, raw, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// raw and g [C, m] float32; dx [m, din] float32 (may be null); part
// [n_blocks, n_w] float32 scratch; grad [n_w] float32: dW0, dW1, dWL
// flattened row-major in that order. Launches the backward on n_blocks
// blocks, then the reduction.
extern "C" int ngp_mlp_bwd_launch(int head, const void* x, const void* sel,
                                  const void* raw, const void* g, long long m,
                                  int din, const void* w0, const void* w1,
                                  const void* wl, void* dx, void* part,
                                  int n_blocks, void* grad, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (head) {
        case 0: return bwd_launch<GeoHead>(x, sel, raw, g, m, din, w0, w1, wl, dx,
                                           part, n_blocks, grad, s);
        case 1: return bwd_launch<AppHead>(x, sel, raw, g, m, din, w0, w1, wl, dx,
                                           part, n_blocks, grad, s);
        case 2: return bwd_launch<PropHead>(x, sel, raw, g, m, din, w0, w1, wl, dx,
                                            part, n_blocks, grad, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
