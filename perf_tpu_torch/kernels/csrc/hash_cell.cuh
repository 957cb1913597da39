// hash_cell.cuh: where a point falls in one level of the multiresolution
// hash grid, shared by hash_encode.cu (features) and hash_encode_grad.cu
// (features with their derivatives with respect to the position), so the
// two locate corners, weigh them and order them alike, as JAX's
// perf_tpu/kernels/hashgrid.py _axis_terms / corner_index /
// encode_level_coords do.
//
// Per axis at level resolution res: pos = clamp(x, 0, 1) * res, lower
// corner c0 = clamp(floor(pos), 0, res - 1), f = pos - c0, the upper
// corner's weight w = f (linear) or (f * f) * (3 - 2 f) (smoothstep, as
// JAX writes it). With GRAD also dw = d w / d x in JAX's forward-mode
// arithmetic: d f = dclip * res, dclip = 1 inside (0, 1), 0.5 at 0 and at
// 1 (JAX's maximum / minimum split a tie), 0 outside (floor and the
// clipped lower corner have none); smoothstep
// dw = (df * f + f * df) * (3 - 2 f) + (f * f) * -(2 df).
// The 8 corners in JAX's order (ox, oy, oz) = (0,0,0), (0,0,1), ...,
// (1,1,1); a corner's row is dense, (cx * (res+1) + cy) * (res+1) + cz,
// where the level's (res+1)^3 corners fit the T rows, else the uint32
// prime hash (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) masked to
// T - 1. Its weight is (A * B) * C with A = w or 1 - w per axis, and with
// GRAD its derivatives (dA * B) * C, (A * dB) * C, (A * B) * dC, dA = dw
// or -dw. Every float operation is rounded on its own (no contraction).
// HashLevels is the forward tile encode's encoder (ray_points.cuh): a
// level's two features at a point, from the table interleaved [L, T, 2].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct HashCell {
    int c[3];        // the lower corner per axis
    float w[3];      // the weight of the upper corner per axis
    float dw[3];     // d w / d x per axis (GRAD only)
};

template <bool SMOOTH, bool GRAD>
__device__ __forceinline__ HashCell hash_cell(const float* p, int res) {
    HashCell h;
    const float fres = (float)res;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float v = p[a];
        const float pos = __fmul_rn(fminf(fmaxf(v, 0.0f), 1.0f), fres);
        const float c0f = fminf(fmaxf(floorf(pos), 0.0f), (float)(res - 1));
        const float f = __fsub_rn(pos, c0f);
        const float ff = __fmul_rn(f, f);
        const float g = __fsub_rn(3.0f, __fmul_rn(2.0f, f));
        h.w[a] = SMOOTH ? __fmul_rn(ff, g) : f;
        if (GRAD) {
            const float dclip = (v > 0.0f && v < 1.0f) ? 1.0f
                              : ((v == 0.0f || v == 1.0f) ? 0.5f : 0.0f);
            const float df = __fmul_rn(dclip, fres);
            h.dw[a] = SMOOTH
                ? __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(df, f), __fmul_rn(f, df)), g),
                            __fmul_rn(ff, -__fmul_rn(2.0f, df)))
                : df;
        }
        h.c[a] = (int)c0f;
    }
    return h;
}

__device__ __forceinline__ uint32_t hash_corner_row(int cx, int cy, int cz,
                                                    int r1, int hashed,
                                                    uint32_t mask) {
    if (hashed)
        return ((uint32_t)cx * 1u ^ (uint32_t)cy * 2654435761u
                ^ (uint32_t)cz * 805459861u) & mask;
    return (uint32_t)((cx * r1 + cy) * r1 + cz);
}

// Calls f(row, weight) for the 8 corners of h in JAX's order, or with GRAD
// f(row, weight, d weight / dx, / dy, / dz). r1 is res + 1 (the dense
// stride); hashed and mask select the level's row function.
template <bool GRAD, class F>
__device__ __forceinline__ void for_hash_corners(const HashCell& h, int r1,
                                                 int hashed, uint32_t mask,
                                                 F&& f) {
#pragma unroll
    for (int ox = 0; ox < 2; ++ox) {
        const float a = ox ? h.w[0] : __fsub_rn(1.0f, h.w[0]);
#pragma unroll
        for (int oy = 0; oy < 2; ++oy) {
            const float b = oy ? h.w[1] : __fsub_rn(1.0f, h.w[1]);
            const float ab = __fmul_rn(a, b);
#pragma unroll
            for (int oz = 0; oz < 2; ++oz) {
                const float c = oz ? h.w[2] : __fsub_rn(1.0f, h.w[2]);
                const uint32_t row = hash_corner_row(
                    h.c[0] + ox, h.c[1] + oy, h.c[2] + oz, r1, hashed, mask);
                if constexpr (GRAD) {
                    const float da = ox ? h.dw[0] : -h.dw[0];
                    const float db = oy ? h.dw[1] : -h.dw[1];
                    const float dc = oz ? h.dw[2] : -h.dw[2];
                    f(row, __fmul_rn(ab, c), __fmul_rn(__fmul_rn(da, b), c),
                      __fmul_rn(__fmul_rn(a, db), c), __fmul_rn(ab, dc));
                } else {
                    f(row, __fmul_rn(ab, c));
                }
            }
        }
    }
}

// The two features of level l at (x, y, z) from the float32 table
// interleaved as [L, T, 2] (the wrapper's per-call copy of JAX's [L, 2, T]
// layout): one 8-byte read a corner; each feature sums table[l][row][f] *
// weight corner after corner in JAX's order.
template <bool SMOOTH>
struct HashLevels {
    const float2* __restrict__ table;
    int table_size;
    uint32_t mask;

    template <class Level>
    __device__ __forceinline__ float2 operator()(int l, const Level& L, float x,
                                                 float y, float z) const {
        const float p[3] = {x, y, z};
        const HashCell h = hash_cell<SMOOTH, false>(p, L.res);
        const float2* t = table + (size_t)l * table_size;
        float a0 = 0.0f, a1 = 0.0f;
        for_hash_corners<false>(h, L.lookup, L.hashed, mask,
                                [&](uint32_t r, float w) {
            const float2 v = __ldg(t + r);
            a0 = __fadd_rn(a0, __fmul_rn(v.x, w));
            a1 = __fadd_rn(a1, __fmul_rn(v.y, w));
        });
        return make_float2(a0, a1);
    }
};
