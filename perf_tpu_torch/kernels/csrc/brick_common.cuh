// brick_common.cuh: the brick-grid lookup shared by field_eval.cu (serving),
// brick_encode.cu (training: the forward through BrickLevels, and the
// backward), brick_encode_grad.cu (the sphere field's encode with
// derivatives) and occ_prune.cu, and the
// geometry head (encode + bf16 MLP + trunc_exp) shared by field_eval.cu and
// occ_prune.cu.
//
// Mirrors perf_tpu/kernels/brickgrid.py (brick_index and the factored
// trilinear weights of corner_interp_lowp) and its plain PyTorch version in
// perf_tpu_torch/kernels/brickgrid.py. A point at level resolution res lies
// in brick b = c0 / 3 at local cell loc = c0 % 3 of each axis; the brick's
// 128-lane bf16 row holds its 4^3 corners x 2 features. The row is dense
// ((bx * nb + by) * nb + bz) or the uint32 prime hash masked to the table.
// Every float operation is rounded as JAX rounds it (no contraction), in
// JAX's order: w = (wx * wy) * wz over corners ox, oy, oz.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

struct BrickCorner {
    uint32_t row;    // the brick's row in the level's table
    int loc[3];      // the point's cell inside the brick, per axis (0..2)
    float fr[3];     // the point's fraction inside that cell, per axis
};

// The row of brick (bx, by, bz) in a level's table of `rows` rows.
__device__ __forceinline__ uint32_t brick_row(int bx, int by, int bz, int nb,
                                              int hashed, int rows) {
    if (hashed) {
        uint32_t h = ((uint32_t)bx * 1u) ^ ((uint32_t)by * 2654435761u)
                     ^ ((uint32_t)bz * 805459861u);
        return h & (uint32_t)(rows - 1);
    }
    return (uint32_t)((bx * nb + by) * nb + bz);
}

__device__ __forceinline__ BrickCorner brick_locate(float nx, float ny, float nz,
                                                    int res, int nb, int hashed,
                                                    int rows) {
    BrickCorner c;
    float p[3] = {nx, ny, nz};
    int b[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float pos = __fmul_rn(fminf(fmaxf(p[a], 0.0f), 1.0f), (float)res);
        float c0f = fminf(fmaxf(floorf(pos), 0.0f), (float)(res - 1));
        c.fr[a] = __fsub_rn(pos, c0f);
        int c0 = (int)c0f;
        b[a] = c0 / 3;
        c.loc[a] = c0 - b[a] * 3;
    }
    c.row = brick_row(b[0], b[1], b[2], nb, hashed, rows);
    return c;
}

// Calls f(corner, w) for the 8 interpolation corners of c: corner is the
// corner's index in the brick row (0..63, two bf16 features each), w its
// trilinear weight.
template <class F>
__device__ __forceinline__ void brick_for_corners(const BrickCorner& c, F&& f) {
#pragma unroll
    for (int ox = 0; ox < 2; ++ox) {
        float wx = ox ? c.fr[0] : __fsub_rn(1.0f, c.fr[0]);
#pragma unroll
        for (int oy = 0; oy < 2; ++oy) {
            float wy = oy ? c.fr[1] : __fsub_rn(1.0f, c.fr[1]);
            float wxy = __fmul_rn(wx, wy);
#pragma unroll
            for (int oz = 0; oz < 2; ++oz) {
                float wz = oz ? c.fr[2] : __fsub_rn(1.0f, c.fr[2]);
                f(((c.loc[0] + ox) * 4 + (c.loc[1] + oy)) * 4 + (c.loc[2] + oz),
                  __fmul_rn(wxy, wz));
            }
        }
    }
}

// The two f32 features of c interpolated from its bf16 row.
__device__ __forceinline__ float2 brick_interp(const BrickCorner& c,
                                               const __nv_bfloat16* __restrict__ row) {
    const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(row);
    float a0 = 0.0f, a1 = 0.0f;
    brick_for_corners(c, [&](int corner, float w) {
        float2 v = __bfloat1622float2(__ldg(r2 + corner));
        a0 = __fadd_rn(a0, __fmul_rn(v.x, w));
        a1 = __fadd_rn(a1, __fmul_rn(v.y, w));
    });
    return make_float2(a0, a1);
}

// The two features of level l at (x, y, z) from the bf16 [L, rows, 128]
// table: the forward tile encode's encoder (ray_points.cuh). brick_interp's
// corners, weights and sums in its order, read four corners at a time: a
// point's z pair (lz + oz, oz = 0, 1; lz <= 2) lies in the 16-byte group
// of corners ((lx + ox) * 4 + ly + oy) * 4 + 0..3, so each (ox, oy) is one
// 16-byte read (the same sector) instead of two 4-byte ones. `interp` reads
// row c.row at c's cell and fractions (the run-dedup encode of
// brick_encode.cu hands it another row than the point's own).
struct BrickLevels {
    const __nv_bfloat16* __restrict__ table;
    int rows;

    template <class Level>
    __device__ __forceinline__ float2 operator()(int l, const Level& L, float x,
                                                 float y, float z) const {
        return interp(l, brick_locate(x, y, z, L.res, L.lookup, L.hashed, rows));
    }

    __device__ __forceinline__ float2 interp(int l, const BrickCorner& c) const {
        const uint4* groups = reinterpret_cast<const uint4*>(
            table + ((size_t)l * rows + c.row) * 128);
        const int lz = c.loc[2];
        float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
        for (int ox = 0; ox < 2; ++ox) {
            const float wx = ox ? c.fr[0] : __fsub_rn(1.0f, c.fr[0]);
#pragma unroll
            for (int oy = 0; oy < 2; ++oy) {
                const float wy = oy ? c.fr[1] : __fsub_rn(1.0f, c.fr[1]);
                const float wxy = __fmul_rn(wx, wy);
                const uint4 g = __ldg(groups + (c.loc[0] + ox) * 4 + c.loc[1] + oy);
                const uint32_t pair[2] = {lz == 0 ? g.x : (lz == 1 ? g.y : g.z),
                                          lz == 0 ? g.y : (lz == 1 ? g.z : g.w)};
#pragma unroll
                for (int oz = 0; oz < 2; ++oz) {
                    const float wz = oz ? c.fr[2] : __fsub_rn(1.0f, c.fr[2]);
                    const float w = __fmul_rn(wxy, wz);
                    // a corner's two bf16 features, the first in the low half
                    const float v0 = __uint_as_float(pair[oz] << 16);
                    const float v1 = __uint_as_float(pair[oz] & 0xffff0000u);
                    a0 = __fadd_rn(a0, __fmul_rn(v0, w));
                    a1 = __fadd_rn(a1, __fmul_rn(v1, w));
                }
            }
        }
        return make_float2(a0, a1);
    }
};

// ---------------------------------------------------------------------------
// The NGP geometry head of perf_tpu/fields/ngp.py (query_density_coords):
// brick encode of all levels, features rounded to bf16, a bias-free
// in -> 64 ReLU layer with bf16-valued weights and each output rounded to
// bf16, a float32 64 -> 1 layer, trunc_exp (input clamped at 80) and 0
// outside the open unit cube. The level table holds (res, nb, hashed) per
// level; weights are float32 values (W0 already rounded to bf16).

constexpr int NGP_MAX_LEVELS = 16;
constexpr int NGP_MAX_IN = 2 * NGP_MAX_LEVELS;
constexpr int NGP_HID = 64;

__device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// The brick encode of one head: two features per level, rounded to bf16.
__device__ __forceinline__ void encode_head(
        const __nv_bfloat16* __restrict__ table, int rows, const int* lv,
        int n_levels, float nx, float ny, float nz, float* feat) {
#pragma unroll
    for (int l = 0; l < NGP_MAX_LEVELS; ++l) {
        if (l < n_levels) {
            const BrickCorner c = brick_locate(nx, ny, nz, lv[3 * l],
                                               lv[3 * l + 1], lv[3 * l + 2], rows);
            const float2 f = brick_interp(
                c, table + ((size_t)l * rows + c.row) * 128);
            feat[2 * l] = bf16_round(f.x);
            feat[2 * l + 1] = bf16_round(f.y);
        } else {
            feat[2 * l] = 0.0f;
            feat[2 * l + 1] = 0.0f;
        }
    }
}

// h[j] = bf16(relu(sum_k feat[k] * W[k, j])) for the first layer.
__device__ __forceinline__ void first_layer(const float* feat, const float* W,
                                            int in_dim, float* h) {
#pragma unroll
    for (int j = 0; j < NGP_HID; ++j) h[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < NGP_MAX_IN; ++k) {
        if (k < in_dim) {
            float fk = feat[k];
            const float* wk = W + k * NGP_HID;
#pragma unroll
            for (int j = 0; j < NGP_HID; ++j) h[j] = fmaf(fk, wk[j], h[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < NGP_HID; ++j) h[j] = bf16_round(fmaxf(h[j], 0.0f));
}

// Density at normalised coords (nx, ny, nz): W0 [in, 64] and W1 [64].
__device__ __forceinline__ float geo_density(
        const __nv_bfloat16* __restrict__ table, int rows, const int* lv,
        int n_levels, const float* W0, const float* W1,
        float nx, float ny, float nz) {
    float feat[NGP_MAX_IN];
    float h[NGP_HID];
    encode_head(table, rows, lv, n_levels, nx, ny, nz, feat);
    first_layer(feat, W0, 2 * n_levels, h);
    float raw = 0.0f;
#pragma unroll
    for (int j = 0; j < NGP_HID; ++j) raw = fmaf(h[j], W1[j], raw);
    const bool sel = nx > 0.0f && nx < 1.0f && ny > 0.0f && ny < 1.0f &&
                     nz > 0.0f && nz < 1.0f;
    return sel ? expf(fminf(raw, 80.0f)) : 0.0f;
}
