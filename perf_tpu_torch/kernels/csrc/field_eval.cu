// field_eval: the NGP brick field, encode + both MLPs fused, one thread per point.
//
// Replaces (JAX): perf_tpu/kernels/brickgrid.py corner_interp_lowp forward
// (via brick_encode / encode_brick_level) and perf_tpu/fields/mlp.py
// ngp_mlp_apply_channels with perf_tpu/fields/ngp.py trunc_exp,
// query_density_coords and query_rgb_coords. The serving path calls it from
// the snapshot bake: every occupied corner of the bake grid is one point.
//
// What bounds it on the H100: per point, 2 heads x 16 levels of 8 scattered
// 4-byte loads (two bf16 features of one corner) from 16 MB tables that stay
// in the 50 MB L2, plus ~2.1k (geo) + ~6.3k (app) multiply-adds of MLP in
// float32 on the CUDA cores. At 57M bake corners that is ~0.5 TFLOP of
// scalar FMA: the MLPs, not memory, set the time.
//
// Simple design (the geometry head, the encode and the first layer live in
// brick_common.cuh, shared with occ_prune.cu): one thread owns one point end to end, so the 32 features
// and the 64 hidden units never leave registers. The MLP weights sit in
// shared memory as float32 values already rounded to bf16 (read as warp
// broadcasts). Rounding to bf16 happens exactly where JAX rounds: table
// values (the host passes a bf16 table), the 32 encoded features at the MLP
// input, each ReLU output; the last layer is float32 with float32 weights.
// The tensor cores are unused: a later PR can tile points x neurons onto
// wgmma.
//
// Weight buffer (float32, in this order): geo W0 [in, 64], geo W1 [64],
// app W0 [in, 64], app W1 [64, 64], app W2 [64, 3]; in = 2 * n_levels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "brick_common.cuh"

namespace {

constexpr int MAX_LEVELS = NGP_MAX_LEVELS;
constexpr int MAX_IN = NGP_MAX_IN;
constexpr int HID = NGP_HID;
constexpr int THREADS = 128;
constexpr int MAX_W = MAX_IN * HID + HID + MAX_IN * HID + HID * HID + HID * 3;

__global__ void __launch_bounds__(THREADS)
field_eval_kernel(const float* __restrict__ xyz, long long n,
                  const __nv_bfloat16* __restrict__ geo_table,
                  const __nv_bfloat16* __restrict__ app_table,
                  const float* __restrict__ weights,
                  const int* __restrict__ levels, int n_levels, int rows,
                  float aabb_min, float span, float* __restrict__ out) {
    __shared__ float sw[MAX_W];
    __shared__ int slv[3 * MAX_LEVELS];
    const int in_dim = 2 * n_levels;
    const int n_w = in_dim * HID + HID + in_dim * HID + HID * HID + HID * 3;
    for (int i = threadIdx.x; i < n_w; i += blockDim.x) sw[i] = weights[i];
    for (int i = threadIdx.x; i < 3 * n_levels; i += blockDim.x) slv[i] = levels[i];
    __syncthreads();
    const float* gW0 = sw;
    const float* gW1 = gW0 + in_dim * HID;
    const float* aW0 = gW1 + HID;
    const float* aW1 = aW0 + in_dim * HID;
    const float* aW2 = aW1 + HID * HID;

    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        float nx = (xyz[3 * i] - aabb_min) / span;
        float ny = (xyz[3 * i + 1] - aabb_min) / span;
        float nz = (xyz[3 * i + 2] - aabb_min) / span;
        bool sel = nx > 0.0f && nx < 1.0f && ny > 0.0f && ny < 1.0f &&
                   nz > 0.0f && nz < 1.0f;
        float feat[MAX_IN];
        float h[HID];

        // geo head: in -> 64 -> 1, trunc_exp, where-select
        const float sigma = geo_density(geo_table, rows, slv, n_levels, gW0,
                                        gW1, nx, ny, nz);

        // app head: in -> 64 -> 64 -> 3, sigmoid, times the selector
        encode_head(app_table, rows, slv, n_levels, nx, ny, nz, feat);
        first_layer(feat, aW0, in_dim, h);
        float o0 = 0.0f, o1 = 0.0f, o2 = 0.0f;
        for (int j = 0; j < HID; ++j) {
            float acc = 0.0f;
#pragma unroll
            for (int k = 0; k < HID; ++k) acc = fmaf(h[k], aW1[k * HID + j], acc);
            acc = bf16_round(fmaxf(acc, 0.0f));
            o0 = fmaf(acc, aW2[3 * j], o0);
            o1 = fmaf(acc, aW2[3 * j + 1], o1);
            o2 = fmaf(acc, aW2[3 * j + 2], o2);
        }
        float s = sel ? 1.0f : 0.0f;
        out[4 * i] = sigma;
        out[4 * i + 1] = s / (1.0f + expf(-o0));
        out[4 * i + 2] = s / (1.0f + expf(-o1));
        out[4 * i + 3] = s / (1.0f + expf(-o2));
    }
}

}  // namespace

extern "C" int field_eval_launch(const void* xyz, long long n,
                                 const void* geo_table, const void* app_table,
                                 const void* weights, const void* levels,
                                 int n_levels, int rows, float aabb_min,
                                 float span, void* out, void* stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    if (n <= 0) return (int)cudaSuccess;
    long long blocks = (n + THREADS - 1) / THREADS;
    if (blocks > 132 * 16) blocks = 132 * 16;
    field_eval_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)xyz, n, (const __nv_bfloat16*)geo_table,
        (const __nv_bfloat16*)app_table, (const float*)weights,
        (const int*)levels, n_levels, rows, aabb_min, span, (float*)out);
    return (int)cudaGetLastError();
}
