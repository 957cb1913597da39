// occ_prune: drop the pool-shell voxels that the previous episode's fitted
// field marks empty, one thread per voxel.
//
// Replaces (JAX): perf_tpu/train/scene.py NeRFScene._field_prune_occ
// (prune_chunk): the density of the geometry head at each voxel centre and at
// n_jitter jittered points inside the voxel, the max, and
// keep = (sigma * 5e-3 > tau) | (prev == 0); the new grid is occ where kept,
// else 0.
//
// Points: voxel v = (i, j, k) of the res^3 grid (flat index v = (i*res + j)*res
// + k) has centre ((float(i) + 0.5) / res - 0.5) * 2 per axis; jittered point
// j adds (u - 0.5) * (2 / res) with u = jitter[j, v mod chunk, axis]. JAX
// draws one jitter table per prune and reuses it for every chunk of `chunk`
// voxels, which the modulo reproduces. Every float operation is rounded as
// JAX rounds it; the density is brick_common.cuh's geo_density, the same code
// as field_eval.cu's geometry head.
//
// Voxels with occ == 0 or prev == 0 do not evaluate the field: the select
// returns occ (or 0) for them whatever the density is. Only the shell that
// both episodes share costs work.
//
// What bounds it on the H100: at occ_res 256, 16.8 M voxels of 2 bytes read
// and 1 written (50 MB, ~15 us of HBM time), plus, per shell voxel, 3 field
// evaluations of 16 levels x 8 corner loads and a 32 x 64 MLP in float32 FMA
// (~2.3k multiply-adds): the shell's MLPs, not memory, set the time. A first
// version: one thread per voxel, the MLP off the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "brick_common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_JITTER = 4;

__global__ void __launch_bounds__(THREADS)
occ_prune_kernel(const uint8_t* __restrict__ occ, const uint8_t* __restrict__ prev,
                 long long n_vox, int res, const float* __restrict__ jitter,
                 int n_jitter, long long chunk, float jit_scale,
                 const __nv_bfloat16* __restrict__ table, int rows,
                 const float* __restrict__ weights, const int* __restrict__ levels,
                 int n_levels, float aabb_min, float span, float tau,
                 uint8_t* __restrict__ out) {
    __shared__ float sw[NGP_MAX_IN * NGP_HID + NGP_HID];
    __shared__ int slv[3 * NGP_MAX_LEVELS];
    const int in_dim = 2 * n_levels;
    for (int i = threadIdx.x; i < in_dim * NGP_HID + NGP_HID; i += blockDim.x)
        sw[i] = weights[i];
    for (int i = threadIdx.x; i < 3 * n_levels; i += blockDim.x) slv[i] = levels[i];
    __syncthreads();
    const float* W0 = sw;
    const float* W1 = sw + in_dim * NGP_HID;
    const float fres = (float)res;

    for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n_vox;
         v += (long long)gridDim.x * blockDim.x) {
        const uint8_t o = occ[v];
        if (o == 0 || prev[v] == 0) {
            out[v] = o;
            continue;
        }
        const long long idx[3] = {v / ((long long)res * res), (v / res) % res,
                                  v % res};
        float base[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
            base[a] = __fmul_rn(
                __fsub_rn(__fdiv_rn(__fadd_rn((float)idx[a], 0.5f), fres), 0.5f),
                2.0f);
        const long long jv = v % chunk;
        float dens = 0.0f;
        for (int j = -1; j < n_jitter; ++j) {
            float p[3];
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                p[a] = base[a];
                if (j >= 0) {
                    const float u = jitter[((long long)j * chunk + jv) * 3 + a];
                    p[a] = __fadd_rn(base[a], __fmul_rn(__fsub_rn(u, 0.5f), jit_scale));
                }
                p[a] = __fdiv_rn(__fsub_rn(p[a], aabb_min), span);
            }
            const float d = geo_density(table, rows, slv, n_levels, W0, W1,
                                        p[0], p[1], p[2]);
            dens = (j < 0) ? d : fmaxf(dens, d);
        }
        out[v] = (__fmul_rn(dens, 5e-3f) > tau) ? o : (uint8_t)0;
    }
}

}  // namespace

extern "C" int occ_prune_launch(const void* occ, const void* prev, long long n_vox,
                                int res, const void* jitter, int n_jitter,
                                long long chunk, float jit_scale,
                                const void* table, int rows, const void* weights,
                                const void* levels, int n_levels, float aabb_min,
                                float span, float tau, void* out, void* stream) {
    if (n_levels < 1 || n_levels > NGP_MAX_LEVELS || n_jitter < 0 ||
        n_jitter > MAX_JITTER || chunk <= 0)
        return (int)cudaErrorInvalidValue;
    if (n_vox <= 0) return (int)cudaSuccess;
    long long blocks = (n_vox + THREADS - 1) / THREADS;
    if (blocks > 132 * 64) blocks = 132 * 64;
    occ_prune_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)occ, (const uint8_t*)prev, n_vox, res,
        (const float*)jitter, n_jitter, chunk, jit_scale,
        (const __nv_bfloat16*)table, rows, (const float*)weights,
        (const int*)levels, n_levels, aabb_min, span, tau, (uint8_t*)out);
    return (int)cudaGetLastError();
}
