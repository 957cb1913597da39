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
// What bounds it on the H100. Per point the density head reads 128 bytes
// of input and does 2.1k multiply-adds forward (the colour head 6.3k), about
// three times as many backward, where it also writes 128 bytes of dx. Their
// hidden products are bf16 x bf16 with float32 sums, which is what the
// tensor cores compute: there (989 TFLOP/s) they take a tenth of the time
// the bytes take, so the bytes bound the bf16 heads. The proposal head is
// float32 throughout in both packages (TF32 would break its 1e-5 bars), so
// its products stay scalar FMA (67 TFLOP/s), where the operations bound it.
//
// The bf16 heads (mlp_fwd_kernel, mlp_bwd_kernel): mma.sync m16n8k16 with
// ldmatrix (mma_bf16.cuh), not wgmma. These products need a tenth of the
// byte time even at mma.sync's rate, and its per-warp fragments let a warp
// own 16 points end to end with no warpgroup barriers: a layer's float32 C
// fragments get the ReLU and the bf16 rounding in registers, and two
// adjacent n8 tiles are the next product's k16 A fragment as they stand.
// The input is read as float4 (16 B a lane): lane (gq, tq) takes columns
// 16 s + 4 tq .. + 3 of its rows for k-step s, which are A's columns (2 tq,
// 2 tq + 1, 2 tq + 8, 2 tq + 9) under a permutation of each 16 columns;
// W0 sits in shared memory with its rows in the same order (phys_k), so
// the product is the same, and dx comes out in it as float4 stores. The
// weights are rounded to bf16 once a block into shared memory, rows padded
// to 144 B (80 B for the inputs) so the 8 rows of an ldmatrix fall on
// distinct banks. The last layer (64 -> C, float32 weights) and the
// epilogue stay float32 and scalar on the C fragments, with a quad shuffle
// for the row sums.
//
// Forward: each warp takes 16 points at a time over a grid of as many
// blocks as fit on the card, and loads its next 16 points' input while it
// computes. Backward: a block takes tiles of 64 points, 16 a warp, and
// holds the next tile's inputs in registers while it works on this one.
// Per tile each warp recomputes its points' hidden layers (nothing new is
// saved), forms the epilogue's derivative (trunc_exp's at the input clamped
// to 15, zero outside the select), the last hidden layer's cotangent as the
// float32 outer product with WL (channel order, unfused, as the plain
// version), masks and rounds it, then (colour head) d1 = bf16(mask * d2
// W1^T) and dx = bf16(d1 W0^T), both on the tensor cores. It stages the
// tile's bf16 inputs, hidden outputs and cotangents in shared memory; then
// dW0 = X^T D1 and dW1 = A1^T D2 run on the tensor cores with the tile's
// points as the sum's depth (ldmatrix.trans), each warp owning two n8
// columns of every m-tile. The hidden layers, d1 and dx are issued a k16
// step at a time into a zeroed fragment and added to their float32 sums
// with a rounded add (mma_add_16816): the tensor cores' internal sums,
// which align the products to the largest and truncate, never carry more
// than 16 products, and what lies beyond is a float32 sum in another order
// than the plain version's (this holds the colour head's backward 10%
// longer than chaining the k-steps, H100). A tile's weight-gradient
// products are chained over its 4 k-steps (64 points) and then added to
// the block's float32 sums with a rounded add: summing each k16 step apart
// as well held that backward another 24% longer (more live fragments, more
// spills). The last layer's gradient stays float32 and scalar (a thread a
// row of WL and half the tile's points). Each block writes its sums to its
// row of the partials; mlp_grad_reduce_kernel then sums the rows in block
// order, 8 consecutive runs of rows in parallel and the runs in order, and
// rounds dW0 and dW1 to bf16 once. The grid is every block the card holds
// at once (the wrapper asks ngp_mlp_occupancy; Cfg::BWD_BLOCKS holds the
// colour head's registers to 3 blocks a SM). No atomics, and a grid that
// depends on M and the card only: the result repeats bitwise.
//
// The proposal head (mlp_f32_fwd_kernel, mlp_f32_bwd_kernel): one thread a
// point, the weights and (backward) a tile of 128 points' rows in float32
// shared memory, the tile's weight-gradient sums a thread an entry.
//
// Rounding to bf16 happens where both packages' autodiff rounds: the input,
// W0, W1 and each hidden output forward, each cotangent that reaches a bf16
// value backward (the hidden layers', dx), dW0 and dW1 once after their
// float32 sums.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int HID = 64;

enum { EPI_TRUNC_EXP = 0, EPI_SIGMOID = 1, EPI_TRUNC_EXP_M1 = 2 };
enum { HEAD_GEO = 0, HEAD_APP = 1, HEAD_PROP = 2 };

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
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

// ---------------------------------------------------------------------------
// The bf16 heads on the tensor cores

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 16 * WARPS;   // the backward's tile of points
constexpr int KP = 32;             // the input width, padded with zeros
constexpr int XS = KP + 8;         // a staged input row (bf16, 80 B)
constexpr int HS = HID + 8;        // a staged 64-wide row (bf16, 144 B)

template <int HEAD> struct Cfg;
// BWD_BLOCKS: the backward's blocks a SM its registers are held to
// (__launch_bounds__); the grid is as many as fit on the card at once
template <> struct Cfg<HEAD_GEO> {
    static constexpr int NH = 1, C = 1, EPI = EPI_TRUNC_EXP, BWD_BLOCKS = 4;
};
template <> struct Cfg<HEAD_APP> {
    static constexpr int NH = 2, C = 3, EPI = EPI_SIGMOID, BWD_BLOCKS = 3;
};

// the weights in shared memory: W0 [KP, HS] with row 16 s + r holding input
// column phys_k(16 s + r), W1 [64, HS], WL transposed [C, 64]
template <int HEAD>
struct __align__(16) TcWeights {
    __nv_bfloat16 w0[KP * HS];
    __nv_bfloat16 w1[(Cfg<HEAD>::NH == 2 ? HID : 1) * HS];
    float wl[Cfg<HEAD>::C * HID];
};

// the backward's staged tile, point-major: the inputs (columns in input
// order), the first hidden layer's outputs and its pre-activations'
// cotangents, the second's (colour head), the raw outputs' cotangents
template <int HEAD>
struct __align__(16) TcTile {
    static constexpr int R2 = Cfg<HEAD>::NH == 2 ? TILE : 1;
    __nv_bfloat16 x[TILE * XS];
    __nv_bfloat16 a1[TILE * HS];
    __nv_bfloat16 d1[TILE * HS];
    __nv_bfloat16 a2[R2 * HS];
    __nv_bfloat16 d2[R2 * HS];
    float dr[TILE * 4];
};

// The input column that row 16 s + r of k-step s carries: A fragment slot r
// = 2 tq + e holds column 4 tq + e, slot 8 + 2 tq + e column 4 tq + 2 + e.
__device__ __forceinline__ int phys_k(int row) {
    const int r = row & 15;
    return (row & ~15) + 4 * ((r & 7) >> 1) + 2 * (r >> 3) + (r & 1);
}

template <int HEAD>
__device__ __forceinline__ void load_tc_weights(const float* __restrict__ w0,
                                                const float* __restrict__ w1,
                                                const float* __restrict__ wl,
                                                int din, TcWeights<HEAD>& s) {
    using H = Cfg<HEAD>;
    for (int e = threadIdx.x; e < KP * HID; e += blockDim.x) {
        const int row = e / HID, j = e % HID, k = phys_k(row);
        s.w0[row * HS + j] = __float2bfloat16_rn(k < din ? w0[k * HID + j] : 0.0f);
    }
    if constexpr (H::NH == 2) {
        for (int e = threadIdx.x; e < HID * HID; e += blockDim.x)
            s.w1[(e / HID) * HS + e % HID] = __float2bfloat16_rn(w1[e]);
    }
    for (int e = threadIdx.x; e < HID * H::C; e += blockDim.x)
        s.wl[(e % H::C) * HID + e / H::C] = wl[e];
}

// A warp's 16 input rows from row i0: v[h][s][e] = x[i0 + gq + 8 h][16 s +
// 4 tq + e], zero past m and din; vec: din == KP and 16-byte rows.
struct XRows {
    float v[2][2][4];
};

__device__ __forceinline__ void load_x(XRows& r, const float* __restrict__ x,
                                       long long m, int din, bool vec,
                                       long long i0, int gq, int tq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const long long i = i0 + gq + 8 * h;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int k = 16 * s + 4 * tq;
            if (vec) {
                const float4 v = i < m ? __ldg(reinterpret_cast<const float4*>(
                                             x + i * KP + k))
                                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                r.v[h][s][0] = v.x;
                r.v[h][s][1] = v.y;
                r.v[h][s][2] = v.z;
                r.v[h][s][3] = v.w;
            } else {
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    r.v[h][s][e] = i < m && k + e < din ? __ldg(x + i * din + k + e)
                                                        : 0.0f;
            }
        }
    }
}

// the rows as A fragments of the two k-steps, rounded to bf16
__device__ __forceinline__ void x_frags(const XRows& r, uint32_t (&a)[2][4]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        a[s][0] = pack_bf16(r.v[0][s][0], r.v[0][s][1]);
        a[s][1] = pack_bf16(r.v[1][s][0], r.v[1][s][1]);
        a[s][2] = pack_bf16(r.v[0][s][2], r.v[0][s][3]);
        a[s][3] = pack_bf16(r.v[1][s][2], r.v[1][s][3]);
    }
}

// c = A W for the 64 outputs (8 n-tiles): A of KS k-steps, W's staged rows
// the k index (transposed loads)
template <int KS>
__device__ __forceinline__ void layer_tc(const uint32_t (&a)[KS][4],
                                         const __nv_bfloat16* w,
                                         float (&c)[8][4], int lane) {
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
            uint32_t b[4];
            ldsm_x4_trans(b, w + (16 * s + 8 * (mi & 1) + r) * HS
                                 + 8 * (2 * np + (mi >> 1)));
            if (s == 0) {   // c is zero: the first k-step's sum is its own
                mma_bf16_16816(c[2 * np], a[s], b[0], b[1]);
                mma_bf16_16816(c[2 * np + 1], a[s], b[2], b[3]);
            } else {
                mma_add_16816(c[2 * np], a[s], b[0], b[1]);
                mma_add_16816(c[2 * np + 1], a[s], b[2], b[3]);
            }
        }
    }
}

// c = A W^T for NT n-tiles: A of 4 k-steps (64 columns), W's staged rows
// the n index, its columns the k index
template <int NT>
__device__ __forceinline__ void layer_tc_t(const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* w,
                                           float (&c)[NT][4], int lane) {
    const int mi = lane >> 3, r = lane & 7;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
            uint32_t b[4];
            ldsm_x4(b, w + (8 * (2 * np + (mi >> 1)) + r) * HS + 16 * kk
                           + 8 * (mi & 1));
            if (kk == 0) {
                mma_bf16_16816(c[2 * np], a[kk], b[0], b[1]);
                mma_bf16_16816(c[2 * np + 1], a[kk], b[2], b[3]);
            } else {
                mma_add_16816(c[2 * np], a[kk], b[0], b[1]);
                mma_add_16816(c[2 * np + 1], a[kk], b[2], b[3]);
            }
        }
    }
}

// bf16(relu(c)) as the next product's A fragments (n-tiles 2 kk, 2 kk + 1
// make k-step kk); returns the mask of c > 0, bit 4 nt + e
__device__ __forceinline__ uint32_t relu_frags(const float (&c)[8][4],
                                               uint32_t (&a)[4][4]) {
    uint32_t mask = 0u;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (c[nt][e] > 0.0f) mask |= 1u << (4 * nt + e);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int nt = 2 * kk + (q >> 1), e = 2 * (q & 1);
            a[kk][q] = pack_bf16(fmaxf(c[nt][e], 0.0f), fmaxf(c[nt][e + 1], 0.0f));
        }
    return mask;
}

// bf16(d) where the mask is set, else 0, as A fragments
__device__ __forceinline__ void masked_frags(const float (&d)[8][4],
                                             uint32_t mask,
                                             uint32_t (&a)[4][4]) {
    float v[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            v[nt][e] = (mask >> (4 * nt + e)) & 1u ? d[nt][e] : 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        a[kk][0] = pack_bf16(v[2 * kk][0], v[2 * kk][1]);
        a[kk][1] = pack_bf16(v[2 * kk][2], v[2 * kk][3]);
        a[kk][2] = pack_bf16(v[2 * kk + 1][0], v[2 * kk + 1][1]);
        a[kk][3] = pack_bf16(v[2 * kk + 1][2], v[2 * kk + 1][3]);
    }
}

// A fragments of 64 columns into a warp's 16 rows of a staged [., HS] tile
__device__ __forceinline__ void stage_frags(__nv_bfloat16* t,
                                            const uint32_t (&a)[4][4], int gq,
                                            int tq) {
    uint32_t* r0 = reinterpret_cast<uint32_t*>(t + gq * HS + 2 * tq);
    uint32_t* r1 = reinterpret_cast<uint32_t*>(t + (gq + 8) * HS + 2 * tq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        r0[8 * kk] = a[kk][0];
        r1[8 * kk] = a[kk][1];
        r0[8 * kk + 4] = a[kk][2];
        r1[8 * kk + 4] = a[kk][3];
    }
}

template <int HEAD>
__global__ void __launch_bounds__(THREADS, 4)
mlp_fwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ sel,
               long long m, int din, const float* __restrict__ w0,
               const float* __restrict__ w1, const float* __restrict__ wl,
               float* __restrict__ out, float* __restrict__ raw) {
    using H = Cfg<HEAD>;
    constexpr int C = H::C;
    __shared__ TcWeights<HEAD> sw;
    load_tc_weights<HEAD>(w0, w1, wl, din, sw);
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gq = lane >> 2, tq = lane & 3;
    const bool vec = din == KP && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const long long n_groups = (m + 15) / 16;
    const long long step = (long long)gridDim.x * WARPS;
    long long grp = (long long)blockIdx.x * WARPS + warp;
    XRows xr;
    if (grp < n_groups) load_x(xr, x, m, din, vec, grp * 16, gq, tq);
    for (; grp < n_groups; grp += step) {
        uint32_t ax[2][4];
        x_frags(xr, ax);
        if (grp + step < n_groups)
            load_x(xr, x, m, din, vec, (grp + step) * 16, gq, tq);
        float c[8][4];
        layer_tc<2>(ax, sw.w0, c, lane);
        if constexpr (H::NH == 2) {
            uint32_t ah[4][4];
            relu_frags(c, ah);
            layer_tc<4>(ah, sw.w1, c, lane);
        }
        // the last layer in float32 over the bf16 hidden outputs; row
        // gq + 8 h's sum over the quad's 64 units by two shuffles
        float o[2][C];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < C; ++cc) o[h][cc] = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float hv = bf16_round(fmaxf(c[nt][e], 0.0f));
                const int j = 8 * nt + 2 * tq + (e & 1);
#pragma unroll
                for (int cc = 0; cc < C; ++cc)
                    o[e >> 1][cc] = fmaf(hv, sw.wl[cc * HID + j], o[e >> 1][cc]);
            }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int cc = 0; cc < C; ++cc) {
                o[h][cc] += __shfl_xor_sync(0xffffffffu, o[h][cc], 1);
                o[h][cc] += __shfl_xor_sync(0xffffffffu, o[h][cc], 2);
            }
        if (tq < 2) {
            const long long i = grp * 16 + gq + 8 * tq;
            if (i < m) {
                const bool s = sel[i] != 0;
#pragma unroll
                for (int cc = 0; cc < C; ++cc) {
                    const float v = tq ? o[1][cc] : o[0][cc];
                    out[cc * m + i] = epilogue<H::EPI>(v, s);
                    if (raw) raw[cc * m + i] = v;
                }
            }
        }
    }
}

// raw, g and sel of a warp's rows gq and gq + 8 (h = 0, 1)
template <int C>
struct EpiRows {
    float raw[2][C], g[2][C];
    bool sel[2];
};

template <int C>
__device__ __forceinline__ void load_epi(EpiRows<C>& r, const float* __restrict__ raw,
                                         const float* __restrict__ g,
                                         const uint8_t* __restrict__ sel,
                                         long long m, long long i0, int gq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const long long i = i0 + gq + 8 * h;
        const bool live = i < m;
        r.sel[h] = live && sel[i] != 0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            r.raw[h][c] = live ? __ldg(raw + c * m + i) : 0.0f;
            r.g[h][c] = live ? __ldg(g + c * m + i) : 0.0f;
        }
    }
}

template <int HEAD>
__global__ void __launch_bounds__(THREADS, Cfg<HEAD>::BWD_BLOCKS)
mlp_bwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ sel,
               const float* __restrict__ raw, const float* __restrict__ g,
               long long m, int din, const float* __restrict__ w0,
               const float* __restrict__ w1, const float* __restrict__ wl,
               float* __restrict__ dx, float* __restrict__ part, int n_w) {
    using H = Cfg<HEAD>;
    constexpr int C = H::C, NH = H::NH, M1 = NH == 2 ? 4 : 1;
    extern __shared__ __align__(16) unsigned char smem[];
    auto& sw = *reinterpret_cast<TcWeights<HEAD>*>(smem);
    auto& st = *reinterpret_cast<TcTile<HEAD>*>(smem + sizeof(TcWeights<HEAD>));
    load_tc_weights<HEAD>(w0, w1, wl, din, sw);

    const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
    const int gq = lane >> 2, tq = lane & 3, mi = lane >> 3, lr = lane & 7;
    const bool vec = din == KP && ((reinterpret_cast<uintptr_t>(x)
                                    | reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
    // The weight gradients' sums over the block's tiles. The warp owns
    // n-tiles 2 warp and 2 warp + 1 (hidden units 16 warp ..+15) of dW0's
    // two m-tiles (the input columns) and of dW1's four; thread t owns row
    // t % 64 of WL over half t / 64 of each tile's points.
    float s0[2][2][4], s1[M1][2][4], sl[C];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) s0[a][b][e] = 0.0f;
#pragma unroll
    for (int a = 0; a < M1; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int e = 0; e < 4; ++e) s1[a][b][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) sl[c] = 0.0f;

    const long long n_tiles = (m + TILE - 1) / TILE;
    const long long step = (long long)gridDim.x * TILE;
    XRows xr;
    EpiRows<C> er;
    if (blockIdx.x < n_tiles) {
        const long long i0 = (long long)blockIdx.x * TILE + 16 * warp;
        load_x(xr, x, m, din, vec, i0, gq, tq);
        load_epi<C>(er, raw, g, sel, m, i0, gq);
    }
    __syncthreads();
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        // the warp's 16 points: recompute, cotangents, dx, staged rows
        const long long i0 = tile * TILE + 16 * warp;
        const int row = 16 * warp;
        uint32_t ax[2][4];
        x_frags(xr, ax);
        float dr[2][C];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < C; ++c)
                dr[h][c] = i0 + gq + 8 * h < m
                    ? epilogue_grad<H::EPI>(er.raw[h][c], er.g[h][c], er.sel[h])
                    : 0.0f;
        if (tile + gridDim.x < n_tiles) {     // the next tile, in flight
            load_x(xr, x, m, din, vec, i0 + step, gq, tq);
            load_epi<C>(er, raw, g, sel, m, i0 + step, gq);
        }
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            *reinterpret_cast<uint2*>(st.x + (row + gq) * XS + 16 * s + 4 * tq) =
                make_uint2(ax[s][0], ax[s][2]);
            *reinterpret_cast<uint2*>(st.x + (row + gq + 8) * XS + 16 * s + 4 * tq) =
                make_uint2(ax[s][1], ax[s][3]);
        }
        if (tq < 2) {
#pragma unroll
            for (int c = 0; c < C; ++c) st.dr[(row + gq + 8 * tq) * 4 + c] = dr[tq][c];
        }
        float c[8][4];
        layer_tc<2>(ax, sw.w0, c, lane);
        uint32_t ah[4][4];
        const uint32_t mask0 = relu_frags(c, ah);
        stage_frags(st.a1 + row * HS, ah, gq, tq);
        uint32_t mask_last = mask0;
        if constexpr (NH == 2) {
            layer_tc<4>(ah, sw.w1, c, lane);
            uint32_t a2[4][4];
            mask_last = relu_frags(c, a2);
            stage_frags(st.a2 + row * HS, a2, gq, tq);
        }
        // the last hidden layer's cotangent: the channels' float32 products
        // with WL summed in channel order, unfused
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = 8 * nt + 2 * tq + (e & 1), h = e >> 1;
                float acc = __fmul_rn(dr[h][0], sw.wl[j]);
#pragma unroll
                for (int cc = 1; cc < C; ++cc)
                    acc = __fadd_rn(acc, __fmul_rn(dr[h][cc], sw.wl[cc * HID + j]));
                c[nt][e] = acc;
            }
        uint32_t ad[4][4];
        masked_frags(c, mask_last, ad);
        if constexpr (NH == 2) {
            stage_frags(st.d2 + row * HS, ad, gq, tq);
            layer_tc_t<8>(ad, sw.w1, c, lane);
            masked_frags(c, mask0, ad);
        }
        stage_frags(st.d1 + row * HS, ad, gq, tq);
        if (dx != nullptr) {
            float cx[4][4];      // logical columns 16 s + .., n-tiles 2 s, 2 s + 1
            layer_tc_t<4>(ad, sw.w0, cx, lane);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const long long i = i0 + gq + 8 * h;
                if (i >= m) continue;
#pragma unroll
                for (int s = 0; s < 2; ++s) {
                    const int k = 16 * s + 4 * tq;
                    const float v[4] = {bf16_round(cx[2 * s][2 * h]),
                                        bf16_round(cx[2 * s][2 * h + 1]),
                                        bf16_round(cx[2 * s + 1][2 * h]),
                                        bf16_round(cx[2 * s + 1][2 * h + 1])};
                    if (vec) {
                        *reinterpret_cast<float4*>(dx + i * KP + k) =
                            make_float4(v[0], v[1], v[2], v[3]);
                    } else {
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            if (k + e < din) dx[i * din + k + e] = v[e];
                    }
                }
            }
        }
        __syncthreads();

        // the tile's weight gradients: its 64 points are the products'
        // depth, chained over 4 k-steps, then added to the block's sums
        {
            float p0[2][2][4], p1[M1][2][4];
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int e = 0; e < 4; ++e) p0[a][b][e] = 0.0f;
#pragma unroll
            for (int a = 0; a < M1; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int e = 0; e < 4; ++e) p1[a][b][e] = 0.0f;
#pragma unroll
            for (int q = 0; q < TILE / 16; ++q) {
                const int prow = 16 * q + 8 * (mi & 1) + lr;   // B: k rows
                const int arow = 16 * q + 8 * (mi >> 1) + lr;  // A^T: k rows
                const int bcol = 8 * (2 * warp + (mi >> 1));
                uint32_t b[4], a[4];
                ldsm_x4_trans(b, st.d1 + prow * HS + bcol);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    ldsm_x4_trans(a, st.x + arow * XS + 16 * mt + 8 * (mi & 1));
                    mma_bf16_16816(p0[mt][0], a, b[0], b[1]);
                    mma_bf16_16816(p0[mt][1], a, b[2], b[3]);
                }
                if constexpr (NH == 2) {
                    ldsm_x4_trans(b, st.d2 + prow * HS + bcol);
#pragma unroll
                    for (int mt = 0; mt < M1; ++mt) {
                        ldsm_x4_trans(a, st.a1 + arow * HS + 16 * mt + 8 * (mi & 1));
                        mma_bf16_16816(p1[mt][0], a, b[0], b[1]);
                        mma_bf16_16816(p1[mt][1], a, b[2], b[3]);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int b = 0; b < 2; ++b)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s0[a][b][e] += p0[a][b][e];
            if constexpr (NH == 2) {
#pragma unroll
                for (int a = 0; a < M1; ++a)
#pragma unroll
                    for (int b = 0; b < 2; ++b)
#pragma unroll
                        for (int e = 0; e < 4; ++e) s1[a][b][e] += p1[a][b][e];
            }
        }
        // the last layer's gradient, float32 and scalar, point by point
        {
            const __nv_bfloat16* al = NH == 2 ? st.a2 : st.a1;
            const int j = t % HID, p0 = (t / HID) * (TILE / 2);
            float pl[C];
#pragma unroll
            for (int cc = 0; cc < C; ++cc) pl[cc] = 0.0f;
#pragma unroll 8
            for (int p = p0; p < p0 + TILE / 2; ++p) {
                const float a = __bfloat162float(al[p * HS + j]);
#pragma unroll
                for (int cc = 0; cc < C; ++cc) pl[cc] = fmaf(a, st.dr[p * 4 + cc], pl[cc]);
            }
#pragma unroll
            for (int cc = 0; cc < C; ++cc) sl[cc] += pl[cc];
        }
        __syncthreads();
    }

    // the block's row of the partials: [dW0 (din rows), dW1, WL]
    float* pb = part + (long long)blockIdx.x * n_w;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int k = 16 * mt + gq + 8 * h;
                const int n = 8 * (2 * warp + nn) + 2 * tq;
                if (k < din)
                    *reinterpret_cast<float2*>(pb + k * HID + n) =
                        make_float2(s0[mt][nn][2 * h], s0[mt][nn][2 * h + 1]);
            }
    if constexpr (NH == 2) {
        float* p1 = pb + din * HID;
#pragma unroll
        for (int mt = 0; mt < M1; ++mt)
#pragma unroll
            for (int nn = 0; nn < 2; ++nn)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int k = 16 * mt + gq + 8 * h;
                    const int n = 8 * (2 * warp + nn) + 2 * tq;
                    *reinterpret_cast<float2*>(p1 + k * HID + n) =
                        make_float2(s1[mt][nn][2 * h], s1[mt][nn][2 * h + 1]);
                }
    }
    // WL's row t % 64: the first half's sum plus the second's
    if (t >= HID) {
#pragma unroll
        for (int cc = 0; cc < C; ++cc) st.dr[(t - HID) * 4 + cc] = sl[cc];
    }
    __syncthreads();
    if (t < HID) {
        float* pl = pb + din * HID + (NH == 2 ? HID * HID : 0) + t * C;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) pl[cc] = sl[cc] + st.dr[t * 4 + cc];
    }
}

// ---------------------------------------------------------------------------
// The float32 proposal head: scalar FMA, one thread a point

constexpr int P_IN = 16;                // the widest input
constexpr int P_AS = P_IN + 4;          // a staged input row
constexpr int P_HS = HID + 4;           // a staged hidden row: 16-byte rows
constexpr int P_TILE = 128;             // the backward's tile, a point a thread
constexpr int P_W = P_IN * HID + HID;   // W0 (rows past din zero), WL [64, 1]
constexpr int P_BWD_FLOATS = P_W + P_TILE * (P_AS + 4) + P_TILE * P_HS * 2;
constexpr int P_FWD_MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ void p_load_weights(const float* __restrict__ w0,
                                               const float* __restrict__ wl,
                                               int din, float* s) {
    for (int e = threadIdx.x; e < P_IN * HID; e += blockDim.x)
        s[e] = e < din * HID ? w0[e] : 0.0f;
    for (int e = threadIdx.x; e < HID; e += blockDim.x) s[P_IN * HID + e] = wl[e];
}

__device__ __forceinline__ void p_load_input(const float* __restrict__ row,
                                             int din, float* xin) {
#pragma unroll
    for (int k = 0; k < P_IN; ++k) xin[k] = k < din ? __ldg(row + k) : 0.0f;
}

// out[j] = sum_k in[k] * W[k, j] over k < n (W row-major [., 64] in shared
// memory, read as float4 broadcasts)
__device__ __forceinline__ void p_layer(const float* in, const float* W, int n,
                                        float* out) {
#pragma unroll
    for (int j = 0; j < HID; ++j) out[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < P_IN; ++k) {
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

// sum_j a[j] * W[k, j] for one row k of W (float4 broadcasts)
__device__ __forceinline__ float p_row_dot(const float* a, const float* Wk) {
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

// ReLU in place; returns the bit mask of pre-activations > 0
__device__ __forceinline__ unsigned long long p_relu(float* h) {
    unsigned long long mask = 0ull;
#pragma unroll
    for (int j = 0; j < HID; ++j) {
        if (h[j] > 0.0f) mask |= 1ull << j;
        h[j] = fmaxf(h[j], 0.0f);
    }
    return mask;
}

template <int N>
__device__ __forceinline__ void p_store_row(float* dst, const float* v) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
        reinterpret_cast<float4*>(dst)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__global__ void __launch_bounds__(P_TILE)
mlp_f32_fwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ sel,
                   long long m, int din, const float* __restrict__ w0,
                   const float* __restrict__ wl, float* __restrict__ out,
                   float* __restrict__ raw) {
    __shared__ __align__(16) float sw[P_W];
    p_load_weights(w0, wl, din, sw);
    __syncthreads();
    const float* sl = sw + P_IN * HID;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
         i += (long long)gridDim.x * blockDim.x) {
        float xin[P_IN];
        p_load_input(x + i * din, din, xin);
        float h[HID];
        p_layer(xin, sw, din, h);
        p_relu(h);
        float o = 0.0f;
#pragma unroll
        for (int j = 0; j < HID; ++j) o = fmaf(h[j], sl[j], o);
        out[i] = epilogue<EPI_TRUNC_EXP_M1>(o, sel[i] != 0);
        if (raw) raw[i] = o;
    }
}

// sums[q * 64] += the tile's sum over its points p of a[p, q] * d[p], for
// q < n (the first n of K entries; rows of a at stride AS, of d at stride
// P_HS), point by point in order. Adding each tile's sum, not each point's,
// keeps the float32 sum over the block's points two-level.
template <int K, int AS>
__device__ __forceinline__ void p_accumulate(const float* a, const float* d,
                                             float* sums, int n) {
    float g[K];
#pragma unroll
    for (int q = 0; q < K; ++q) g[q] = 0.0f;
    for (int p = 0; p < P_TILE; ++p) {
        const float dj = d[p * P_HS];
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

// A block takes tiles of 128 points, a thread a point: it recomputes its
// point's hidden layer, forms the cotangents and dx and stages the tile's
// rows; then each thread sums the tile's contributions to its weight-gradient
// entries (column j of W0's rows kg * 8 ..+7, row j of WL for kg == 0) and
// adds them to the block's row of the partials, which only it touches.
__global__ void __launch_bounds__(P_TILE)
mlp_f32_bwd_kernel(const float* __restrict__ x, const uint8_t* __restrict__ sel,
                   const float* __restrict__ raw, const float* __restrict__ g,
                   long long m, int din, const float* __restrict__ w0,
                   const float* __restrict__ wl, float* __restrict__ dx,
                   float* __restrict__ part, int n_w) {
    extern __shared__ __align__(16) float psm[];
    constexpr int K0 = P_IN / 2;         // the dW0 rows a thread owns
    float* s0 = psm;
    float* sl = s0 + P_IN * HID;
    float* a0 = psm + P_W;               // [P_TILE, P_AS] inputs
    float* a1 = a0 + P_TILE * P_AS;      // [P_TILE, P_HS] hidden outputs
    float* d1 = a1 + P_TILE * P_HS;      // their pre-activations' cotangents
    float* dr = d1 + P_TILE * P_HS;      // [P_TILE, 4] raw cotangents
    p_load_weights(w0, wl, din, s0);
    __syncthreads();

    const int t = threadIdx.x;
    const int j = t % HID, kg = t / HID;
    float* pb = part + (long long)blockIdx.x * n_w;   // [W0, WL] sums
    float* p0 = pb + (kg * K0) * HID + j;
    float* pl = pb + din * HID + j;
#pragma unroll
    for (int q = 0; q < K0; ++q)
        if (kg * K0 + q < din) p0[q * HID] = 0.0f;
    if (kg == 0) *pl = 0.0f;

    const long long n_tiles = (m + P_TILE - 1) / P_TILE;
    for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const long long i = tile * P_TILE + t;
        const bool live = i < m;
        float xin[P_IN];
        if (live) {
            p_load_input(x + i * din, din, xin);
        } else {
#pragma unroll
            for (int k = 0; k < P_IN; ++k) xin[k] = 0.0f;
        }
        p_store_row<P_IN>(a0 + t * P_AS, xin);
        float h[HID];
        p_layer(xin, s0, din, h);
        const unsigned long long m1 = p_relu(h);
        p_store_row<HID>(a1 + t * P_HS, h);
        const float drc = live ? epilogue_grad<EPI_TRUNC_EXP_M1>(
                                     raw[i], g[i], sel[i] != 0)
                               : 0.0f;
        dr[t * 4] = drc;
#pragma unroll
        for (int k = 0; k < HID; ++k)
            h[k] = (m1 >> k) & 1ull ? __fmul_rn(drc, sl[k]) : 0.0f;
        p_store_row<HID>(d1 + t * P_HS, h);   // the hidden layer's cotangents
        if (dx != nullptr && live) {
#pragma unroll
            for (int k = 0; k < P_IN; ++k)
                if (k < din) dx[i * din + k] = p_row_dot(h, s0 + k * HID);
        }
        __syncthreads();

        p_accumulate<K0, P_AS>(a0 + kg * K0, d1 + j, p0, din - kg * K0);
        if (kg == 0) {
            float gl = 0.0f;
            for (int p = 0; p < P_TILE; ++p) gl = fmaf(a1[p * P_HS + j], dr[p * 4], gl);
            *pl += gl;
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------

// grad[e] = the blocks' partial rows summed in block order: warp w sums its
// run of consecutive rows in order, then the 8 runs are added in order; the
// first n_round entries (the bf16 layers) rounded to bf16. A block takes 32
// entries.
constexpr int RED_RUNS = 8;

__global__ void __launch_bounds__(32 * RED_RUNS)
mlp_grad_reduce_kernel(const float* __restrict__ part, int n_blocks, int n_w,
                       int n_round, float* __restrict__ grad) {
    __shared__ float runs[RED_RUNS][32];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int e = blockIdx.x * 32 + lane;
    const int per = (n_blocks + RED_RUNS - 1) / RED_RUNS;
    const int b1 = min(n_blocks, (w + 1) * per);
    float s = 0.0f;
    if (e < n_w) {
#pragma unroll 8
        for (int b = w * per; b < b1; ++b) s += part[(long long)b * n_w + e];
    }
    runs[w][lane] = s;
    __syncthreads();
    if (w == 0 && e < n_w) {
        float total = runs[0][lane];
#pragma unroll
        for (int r = 1; r < RED_RUNS; ++r) total += runs[r][lane];
        grad[e] = e < n_round ? bf16_round(total) : total;
    }
}

template <int HEAD>
size_t tc_bwd_smem() {
    return sizeof(TcWeights<HEAD>) + sizeof(TcTile<HEAD>);
}

// the forward's grid: every block the card holds at once (cached a device)
template <int HEAD>
int tc_fwd_blocks() {
    static int cached[32] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 32) return 132;
    if (cached[dev] == 0) {
        int sms = 0, per = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, mlp_fwd_kernel<HEAD>,
                                                      THREADS, 0);
        cached[dev] = (sms > 0 ? sms : 132) * (per > 0 ? per : 1);
    }
    return cached[dev];
}

template <int HEAD>
int tc_fwd_launch(const void* x, const void* sel, long long m, int din,
                  const void* w0, const void* w1, const void* wl, void* out,
                  void* raw, cudaStream_t stream) {
    if (din < 1 || din > KP) return (int)cudaErrorInvalidValue;
    if (m <= 0) return (int)cudaSuccess;
    const long long needed = ((m + 15) / 16 + WARPS - 1) / WARPS;
    const long long most = tc_fwd_blocks<HEAD>();
    const long long blocks = needed < most ? needed : most;
    mlp_fwd_kernel<HEAD><<<(unsigned)blocks, THREADS, 0, stream>>>(
        (const float*)x, (const uint8_t*)sel, m, din, (const float*)w0,
        (const float*)w1, (const float*)wl, (float*)out, (float*)raw);
    return (int)cudaGetLastError();
}

int f32_fwd_launch(const void* x, const void* sel, long long m, int din,
                   const void* w0, const void* wl, void* out, void* raw,
                   cudaStream_t stream) {
    if (din < 1 || din > P_IN) return (int)cudaErrorInvalidValue;
    if (m <= 0) return (int)cudaSuccess;
    long long blocks = (m + P_TILE - 1) / P_TILE;
    if (blocks > P_FWD_MAX_BLOCKS) blocks = P_FWD_MAX_BLOCKS;
    mlp_f32_fwd_kernel<<<(unsigned)blocks, P_TILE, 0, stream>>>(
        (const float*)x, (const uint8_t*)sel, m, din, (const float*)w0,
        (const float*)wl, (float*)out, (float*)raw);
    return (int)cudaGetLastError();
}

int reduce_launch(const void* part, int n_blocks, int n_w, int n_round,
                  void* grad, cudaStream_t stream) {
    mlp_grad_reduce_kernel<<<(n_w + 31) / 32, 32 * RED_RUNS, 0, stream>>>(
        (const float*)part, n_blocks, n_w, n_round, (float*)grad);
    return (int)cudaGetLastError();
}

template <int HEAD>
int tc_bwd_launch(const void* x, const void* sel, const void* raw, const void* g,
                  long long m, int din, const void* w0, const void* w1,
                  const void* wl, void* dx, void* part, int n_blocks, void* grad,
                  cudaStream_t stream) {
    using H = Cfg<HEAD>;
    if (din < 1 || din > KP || n_blocks < 1) return (int)cudaErrorInvalidValue;
    const int n_w1 = H::NH == 2 ? HID * HID : 0;
    const int n_w = din * HID + n_w1 + HID * H::C;
    const size_t smem = tc_bwd_smem<HEAD>();
    cudaError_t err = cudaFuncSetAttribute(
        mlp_bwd_kernel<HEAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bwd_kernel<HEAD><<<n_blocks, THREADS, smem, stream>>>(
        (const float*)x, (const uint8_t*)sel, (const float*)raw, (const float*)g,
        m, din, (const float*)w0, (const float*)w1, (const float*)wl,
        (float*)dx, (float*)part, n_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return reduce_launch(part, n_blocks, n_w, din * HID + n_w1, grad, stream);
}

int f32_bwd_launch(const void* x, const void* sel, const void* raw, const void* g,
                   long long m, int din, const void* w0, const void* wl, void* dx,
                   void* part, int n_blocks, void* grad, cudaStream_t stream) {
    if (din < 1 || din > P_IN || n_blocks < 1) return (int)cudaErrorInvalidValue;
    const int n_w = din * HID + HID;
    const size_t smem = sizeof(float) * P_BWD_FLOATS;
    cudaError_t err = cudaFuncSetAttribute(
        mlp_f32_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_f32_bwd_kernel<<<n_blocks, P_TILE, smem, stream>>>(
        (const float*)x, (const uint8_t*)sel, (const float*)raw, (const float*)g,
        m, din, (const float*)w0, (const float*)wl, (float*)dx, (float*)part, n_w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return reduce_launch(part, n_blocks, n_w, 0, grad, stream);
}

// blocks a SM, dynamic shared memory a block
template <class K>
int occupancy(K kernel, int threads, size_t smem, int* out) {
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    out[1] = (int)smem;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                              smem);
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
        case HEAD_GEO:
            return tc_fwd_launch<HEAD_GEO>(x, sel, m, din, w0, w1, wl, out, raw, s);
        case HEAD_APP:
            return tc_fwd_launch<HEAD_APP>(x, sel, m, din, w0, w1, wl, out, raw, s);
        case HEAD_PROP:
            return f32_fwd_launch(x, sel, m, din, w0, wl, out, raw, s);
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
        case HEAD_GEO:
            return tc_bwd_launch<HEAD_GEO>(x, sel, raw, g, m, din, w0, w1, wl, dx,
                                           part, n_blocks, grad, s);
        case HEAD_APP:
            return tc_bwd_launch<HEAD_APP>(x, sel, raw, g, m, din, w0, w1, wl, dx,
                                           part, n_blocks, grad, s);
        case HEAD_PROP:
            return f32_bwd_launch(x, sel, raw, g, m, din, w0, wl, dx, part,
                                  n_blocks, grad, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The backward's second kernel alone: grad [n_w] = part [n_blocks, n_w]
// summed in block order, the first n_round entries rounded to bf16 (for
// timing it apart from the tiles; the backward launches it itself).
extern "C" int ngp_mlp_reduce_launch(const void* part, int n_blocks, int n_w,
                                     int n_round, void* grad, void* stream) {
    if (n_blocks < 1 || n_w < 1 || n_round < 0 || n_round > n_w)
        return (int)cudaErrorInvalidValue;
    return reduce_launch(part, n_blocks, n_w, n_round, grad, (cudaStream_t)stream);
}

// The head's forward (backward = 0) or backward kernel on the current
// device: out[0] blocks a SM, out[1] its dynamic shared memory a block.
extern "C" int ngp_mlp_occupancy(int head, int backward, int* out) {
    switch (head * 2 + (backward != 0)) {
        case 2 * HEAD_GEO: return occupancy(mlp_fwd_kernel<HEAD_GEO>, THREADS, 0, out);
        case 2 * HEAD_GEO + 1:
            return occupancy(mlp_bwd_kernel<HEAD_GEO>, THREADS,
                             tc_bwd_smem<HEAD_GEO>(), out);
        case 2 * HEAD_APP: return occupancy(mlp_fwd_kernel<HEAD_APP>, THREADS, 0, out);
        case 2 * HEAD_APP + 1:
            return occupancy(mlp_bwd_kernel<HEAD_APP>, THREADS,
                             tc_bwd_smem<HEAD_APP>(), out);
        case 2 * HEAD_PROP: return occupancy(mlp_f32_fwd_kernel, P_TILE, 0, out);
        case 2 * HEAD_PROP + 1:
            return occupancy(mlp_f32_bwd_kernel, P_TILE, sizeof(float) * P_BWD_FLOATS,
                             out);
        default: return (int)cudaErrorInvalidValue;
    }
}
