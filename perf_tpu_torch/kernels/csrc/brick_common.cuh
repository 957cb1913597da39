// brick_common.cuh: the brick-grid lookup shared by field_eval.cu (serving)
// and brick_encode.cu (training, forward and backward).
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
    if (hashed) {
        uint32_t h = ((uint32_t)b[0] * 1u) ^ ((uint32_t)b[1] * 2654435761u)
                     ^ ((uint32_t)b[2] * 805459861u);
        c.row = h & (uint32_t)(rows - 1);
    } else {
        c.row = (uint32_t)((b[0] * nb + b[1]) * nb + b[2]);
    }
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
