// shade_composite: the training composite of shade_rays with the per-ray
// distortion loss, forward and backward, one thread per ray.
//
// Replaces (JAX): perf_tpu/render/renderer.py shade_rays, the compositing
// lines (384-390: tau, exclusive-cumsum transmittance, weights, opacity,
// distance), and perf_tpu/kernels/distortion.py distortion_per_ray
// (prefix-sum form of the Mip-NeRF 360 loss), with their gradients, which
// JAX takes by autodiff.
//
// Inputs per ray: sigma [S] (already where-masked to 0 at invalid samples),
// t_mid [S], valid [S] (0 / 1) and delta = step * stride.
// Forward: tau_i = sigma_i * delta; T_i = exp(-(C_i - tau_i)) with C the
// inclusive running sum (JAX's cumsum(tau) - tau); w_i = T_i (1 - exp(-tau_i));
// opacity = sum w, distance = sum w t; with u = w * valid, W and M the
// exclusive running sums of u and u * t:
// dist_loss = 2 sum u (t W - M) + 1/3 sum delta u^2. The weights (the colour
// composite uses them detached) and T are written for the backward.
// Backward, from the cotangents of opacity, distance and dist_loss:
// dL/du_k = 2 (t_k W_k - M_k) + 2 (A_k - t_k B_k) + 2/3 delta u_k, with A, B
// the suffix sums of u t and u over i > k; gw_k = g_op + g_dist t_k
// + g_dl valid_k dL/du_k; dL/dtau_k = gw_k T_k exp(-tau_k) - sum_{i>k} gw_i w_i;
// dsigma_k = delta dL/dtau_k. Pass 1 walks forward and stores W_k, M_k in
// scratch; pass 2 walks back with the suffix sums in registers.
//
// What bounds it on the H100: memory. The forward reads 12 bytes and writes
// 8 per sample; the backward reads 20 and writes 4, plus 8 of scratch both
// ways. One thread walks one ray in order, so the scans need no exchange
// between threads; neighbouring threads read neighbouring rows (a stride of
// S floats), which L1 absorbs as each thread walks its row. A warp per ray
// with shuffle scans is later work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
shade_fwd_kernel(const float* __restrict__ sigma, const float* __restrict__ t_mid,
                 const float* __restrict__ valid, long long n, int S, float delta,
                 float* __restrict__ weights, float* __restrict__ trans,
                 float* __restrict__ opacity, float* __restrict__ distance,
                 float* __restrict__ dist_loss) {
    long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const long long base = r * S;
    float C = 0.0f, W = 0.0f, M = 0.0f, op = 0.0f, dist = 0.0f;
    float bi = 0.0f, uni = 0.0f;
    for (int i = 0; i < S; ++i) {
        const float tau = sigma[base + i] * delta;
        const float t = t_mid[base + i];
        C = C + tau;
        const float T = expf(-(C - tau));
        const float w = T * (1.0f - expf(-tau));
        weights[base + i] = w;
        trans[base + i] = T;
        op = op + w;
        dist = dist + w * t;
        const float u = w * valid[base + i];
        const float um = u * t;
        W = W + u;
        M = M + um;
        bi = bi + u * (t * (W - u) - (M - um));
        uni = uni + delta * u * u;
    }
    opacity[r] = op;
    distance[r] = dist;
    dist_loss[r] = 2.0f * bi + (1.0f / 3.0f) * uni;
}

__global__ void __launch_bounds__(THREADS)
shade_bwd_kernel(const float* __restrict__ sigma, const float* __restrict__ t_mid,
                 const float* __restrict__ valid, const float* __restrict__ weights,
                 const float* __restrict__ trans, long long n, int S, float delta,
                 const float* __restrict__ g_op, const float* __restrict__ g_dist,
                 const float* __restrict__ g_dl, float2* __restrict__ scratch,
                 float* __restrict__ g_sigma) {
    long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    const long long base = r * S;
    float W = 0.0f, M = 0.0f;
    for (int i = 0; i < S; ++i) {
        scratch[base + i] = make_float2(W, M);
        const float u = weights[base + i] * valid[base + i];
        W = W + u;
        M = M + u * t_mid[base + i];
    }
    const float go = g_op[r], gd = g_dist[r], gl = g_dl[r];
    float A = 0.0f, B = 0.0f, G = 0.0f;
    for (int i = S - 1; i >= 0; --i) {
        const float t = t_mid[base + i], v = valid[base + i];
        const float w = weights[base + i];
        const float u = w * v;
        const float2 wm = scratch[base + i];
        const float ddl = 2.0f * (t * wm.x - wm.y) + 2.0f * (A - t * B)
                          + (2.0f / 3.0f) * delta * u;
        const float gw = go + gd * t + gl * v * ddl;
        const float tau = sigma[base + i] * delta;
        const float dtau = gw * trans[base + i] * expf(-tau) - G;
        g_sigma[base + i] = dtau * delta;
        G = G + gw * w;
        A = A + u * t;
        B = B + u;
    }
}

unsigned blocks_for(long long n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

extern "C" int shade_composite_fwd_launch(
        const void* sigma, const void* t_mid, const void* valid, long long n,
        int S, float delta, void* weights, void* trans, void* opacity,
        void* distance, void* dist_loss, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    shade_fwd_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)sigma, (const float*)t_mid, (const float*)valid, n, S,
        delta, (float*)weights, (float*)trans, (float*)opacity,
        (float*)distance, (float*)dist_loss);
    return (int)cudaGetLastError();
}

extern "C" int shade_composite_bwd_launch(
        const void* sigma, const void* t_mid, const void* valid,
        const void* weights, const void* trans, long long n, int S, float delta,
        const void* g_op, const void* g_dist, const void* g_dl, void* scratch,
        void* g_sigma, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    shade_bwd_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)sigma, (const float*)t_mid, (const float*)valid,
        (const float*)weights, (const float*)trans, n, S, delta,
        (const float*)g_op, (const float*)g_dist, (const float*)g_dl,
        (float2*)scratch, (float*)g_sigma);
    return (int)cudaGetLastError();
}
