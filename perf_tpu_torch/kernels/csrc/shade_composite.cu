// shade_composite: the training composite of shade_rays with the per-ray
// distortion loss, forward and backward; a group of lanes per ray.
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
// inclusive running sums of u and u * t:
// dist_loss = 2 sum u (t (W - u) - (M - u t)) + 1/3 sum delta u^2 (JAX's
// cumsum - x again). Writes the weights (the colour composite uses them
// detached) and the three per-ray values, nothing for the backward.
// Backward, from the cotangents of opacity, distance and dist_loss:
// recomputes tau, C, T, w, W and M as the forward does; with A, B the sums
// of u t and u over the samples after k (suffix sums),
// dL/du_k = 2 (t_k (W_k - u_k) - (M_k - u_k t_k)) + 2 (A_k - t_k B_k)
// + 2/3 delta u_k; gw_k = g_op + g_dist t_k + g_dl valid_k dL/du_k;
// dL/dtau_k = gw_k T_k exp(-tau_k) - G_k with G_k the sum of gw_i w_i over
// i > k; dsigma_k = delta dL/dtau_k. Writes dsigma only.
//
// Design. A ray is a group of G lanes (8, 16 or 32: a segment of a warp),
// and each lane owns a run of R <= 8 consecutive samples of the row
// (render/renderer.py composite_lanes picks G and R from S); a row longer
// than G R samples runs in chunks of G R, left to right, with the running
// sums carried. A lane loads its run (16-byte loads where R and S are
// multiples of 4 and the rows aligned, scalar loads otherwise), scans it
// in registers, and the lanes' run totals are scanned across the group by
// shuffles (Hillis-Steele, __shfl_up_sync): a sample's prefix is
// (carry + the sum of the lanes below) + its run's running sum. The suffix
// sums A, B, G of the backward come from the mirror scan (__shfl_down_sync
// over the lanes above, the run summed from its end), never from total -
// prefix, which cancels. Per-ray sums: each lane sums its runs, then a
// butterfly (__shfl_xor_sync) over the group. No atomics, no scratch: the
// result repeats bitwise. A backward over several chunks first walks them
// left to right and keeps each chunk's three carries (C, W, M) in shared
// memory, then walks them right to left with the suffix carries.
//
// What bounds it on the H100: memory. The forward reads 12 bytes a sample
// and writes 4 (the weights), plus 12 a ray; the backward reads 12 a sample
// and 12 a ray and writes 4 a sample. The arithmetic (two expf a sample, the
// scans' log2(G) shuffle steps) is small beside it; the groups keep many
// rays in flight, so the 1,024-ray high bucket spreads over the card too.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int RMAX = 8;
constexpr unsigned FULL = 0xffffffffu;

// -- scans over the lanes of a group (G a power of two, <= 32) ---------------

// the sum over the lanes below this one (0 at lane 0), and the group's total
// in tot: Hillis-Steele, at d = 1, 2, 4, ... each lane adds the value d
// lanes below it
__device__ __forceinline__ float lanes_below(float x, int lane, int G,
                                             float& tot) {
    for (int d = 1; d < G; d <<= 1) {
        const float y = __shfl_up_sync(FULL, x, d, G);
        if (lane >= d) x = y + x;
    }
    const float below = __shfl_up_sync(FULL, x, 1, G);
    tot = __shfl_sync(FULL, x, G - 1, G);
    return lane == 0 ? 0.0f : below;
}

// the sum over the lanes above this one (0 at the last lane), and the
// group's total: the mirror scan, each lane adding the value d lanes above
__device__ __forceinline__ float lanes_above(float x, int lane, int G,
                                             float& tot) {
    for (int d = 1; d < G; d <<= 1) {
        const float y = __shfl_down_sync(FULL, x, d, G);
        if (lane + d < G) x = x + y;
    }
    const float above = __shfl_down_sync(FULL, x, 1, G);
    tot = __shfl_sync(FULL, x, 0, G);
    return lane == G - 1 ? 0.0f : above;
}

// the group's sum on every lane: a butterfly at d = G/2, ..., 1
__device__ __forceinline__ float group_sum(float x, int G) {
    for (int d = G >> 1; d > 0; d >>= 1)
        x = x + __shfl_xor_sync(FULL, x, d, G);
    return x;
}

// -- a lane's run: m <= R valid samples at p, zeros past them ---------------

template <bool VEC>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int m,
                                         float (&x)[RMAX]) {
    if (VEC) {
#pragma unroll
        for (int q = 0; q < RMAX / 4; ++q) {
            float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (4 * q < m) a = __ldg(reinterpret_cast<const float4*>(p) + q);
            x[4 * q] = a.x;
            x[4 * q + 1] = a.y;
            x[4 * q + 2] = a.z;
            x[4 * q + 3] = a.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < RMAX; ++j) x[j] = j < m ? __ldg(p + j) : 0.0f;
    }
}

template <bool VEC>
__device__ __forceinline__ void store_run(float* __restrict__ p, int m,
                                          const float (&x)[RMAX]) {
    if (VEC) {
#pragma unroll
        for (int q = 0; q < RMAX / 4; ++q)
            if (4 * q < m)
                reinterpret_cast<float4*>(p)[q] = make_float4(
                    x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
    } else {
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
            if (j < m) p[j] = x[j];
    }
}

// The forward of one chunk for one lane (its run of m samples at row
// offset `at`): t, v loaded; Te = T exp(-tau), w, u = w v and
// wx = t (W - u) - (M - u t). The carries cC, cW, cM (the running sums of
// tau, u, u t at the chunk's start) advance by the chunk's totals. A sample
// past m has tau = t = v = 0, so w = u = 0 and the runs' sums gain +0.
template <bool VEC>
__device__ __forceinline__ void chunk_forward(
        const float* __restrict__ sigma, const float* __restrict__ t_mid,
        const float* __restrict__ valid, long long at, int m, int lane, int G,
        float delta, float& cC, float& cW, float& cM, float (&t)[RMAX],
        float (&v)[RMAX], float (&Te)[RMAX], float (&w)[RMAX],
        float (&u)[RMAX], float (&wx)[RMAX]) {
    float tau[RMAX], run[RMAX];
    load_run<VEC>(sigma + at, m, tau);
    load_run<VEC>(t_mid + at, m, t);
    load_run<VEC>(valid + at, m, v);
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
        tau[j] = tau[j] * delta;
        acc = acc + tau[j];
        run[j] = acc;
    }
    float tot;
    const float base = cC + lanes_below(acc, lane, G, tot);
    cC = cC + tot;
    float run_u[RMAX], run_m[RMAX], au = 0.0f, am = 0.0f;
#pragma unroll
    for (int j = 0; j < RMAX; ++j) {
        const float T = expf(-((base + run[j]) - tau[j]));
        const float e = expf(-tau[j]);
        Te[j] = T * e;
        w[j] = T * (1.0f - e);
        u[j] = w[j] * v[j];
        au = au + u[j];
        run_u[j] = au;
        am = am + __fmul_rn(u[j], t[j]);
        run_m[j] = am;
    }
    const float bw = cW + lanes_below(au, lane, G, tot);
    cW = cW + tot;
    const float bm = cM + lanes_below(am, lane, G, tot);
    cM = cM + tot;
#pragma unroll
    for (int j = 0; j < RMAX; ++j)
        wx[j] = t[j] * ((bw + run_u[j]) - u[j])
                - ((bm + run_m[j]) - __fmul_rn(u[j], t[j]));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
shade_fwd_kernel(const float* __restrict__ sigma,
                 const float* __restrict__ t_mid,
                 const float* __restrict__ valid, long long n, int S, int G,
                 int R, float delta, float* __restrict__ weights,
                 float* __restrict__ opacity, float* __restrict__ distance,
                 float* __restrict__ dist_loss) {
    const int lane = threadIdx.x & (G - 1);
    const long long r = (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
    const bool live = r < n;
    const long long row = live ? r * S : 0;
    float cC = 0.0f, cW = 0.0f, cM = 0.0f;
    float op = 0.0f, dist = 0.0f, bi = 0.0f, uni = 0.0f;
    for (int c0 = 0; c0 < S; c0 += G * R) {
        const int p = c0 + lane * R;
        const int m = live ? max(0, min(R, S - p)) : 0;
        float t[RMAX], v[RMAX], Te[RMAX], w[RMAX], u[RMAX], wx[RMAX];
        chunk_forward<VEC>(sigma, t_mid, valid, row + p, m, lane, G, delta,
                           cC, cW, cM, t, v, Te, w, u, wx);
#pragma unroll
        for (int j = 0; j < RMAX; ++j) {
            op = op + w[j];
            dist = dist + w[j] * t[j];
            bi = bi + u[j] * wx[j];
            uni = uni + delta * u[j] * u[j];
        }
        store_run<VEC>(weights + row + p, m, w);
    }
    op = group_sum(op, G);
    dist = group_sum(dist, G);
    bi = group_sum(bi, G);
    uni = group_sum(uni, G);
    if (live && lane == 0) {
        opacity[r] = op;
        distance[r] = dist;
        dist_loss[r] = 2.0f * bi + (1.0f / 3.0f) * uni;
    }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
shade_bwd_kernel(const float* __restrict__ sigma,
                 const float* __restrict__ t_mid,
                 const float* __restrict__ valid, long long n, int S, int G,
                 int R, float delta, const float* __restrict__ g_op,
                 const float* __restrict__ g_dist,
                 const float* __restrict__ g_dl,
                 float* __restrict__ g_sigma) {
    extern __shared__ float chunk_carry[];   // [groups][chunks][3], chunks > 1
    const int lane = threadIdx.x & (G - 1);
    const long long r = (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
    const bool live = r < n;
    const long long row = live ? r * S : 0;
    const int chunk = G * R;
    const int chunks = (S + chunk - 1) / chunk;
    float* carry = chunk_carry + (threadIdx.x / G) * chunks * 3;
    const float go = live ? g_op[r] : 0.0f;
    const float gd = live ? g_dist[r] : 0.0f;
    const float gl = live ? g_dl[r] : 0.0f;
    float t[RMAX], v[RMAX], Te[RMAX], w[RMAX], u[RMAX], wx[RMAX];
    if (chunks > 1) {
        float cC = 0.0f, cW = 0.0f, cM = 0.0f;
        for (int k = 0; k < chunks; ++k) {
            if (lane == 0) {
                carry[3 * k] = cC;
                carry[3 * k + 1] = cW;
                carry[3 * k + 2] = cM;
            }
            const int p = k * chunk + lane * R;
            const int m = live ? max(0, min(R, S - p)) : 0;
            chunk_forward<VEC>(sigma, t_mid, valid, row + p, m, lane, G, delta,
                               cC, cW, cM, t, v, Te, w, u, wx);
        }
        __syncwarp();
    }
    float cA = 0.0f, cB = 0.0f, cG = 0.0f;
    for (int k = chunks - 1; k >= 0; --k) {
        float cC = 0.0f, cW = 0.0f, cM = 0.0f;
        if (chunks > 1) {
            cC = carry[3 * k];
            cW = carry[3 * k + 1];
            cM = carry[3 * k + 2];
        }
        const int p = k * chunk + lane * R;
        const int m = live ? max(0, min(R, S - p)) : 0;
        chunk_forward<VEC>(sigma, t_mid, valid, row + p, m, lane, G, delta,
                           cC, cW, cM, t, v, Te, w, u, wx);
        // A, B: the sums of u t and u over the samples after each, the run
        // summed from its end
        float sa[RMAX], sb[RMAX], aa = 0.0f, ab = 0.0f;
#pragma unroll
        for (int j = RMAX - 1; j >= 0; --j) {
            sa[j] = aa;
            sb[j] = ab;
            aa = aa + __fmul_rn(u[j], t[j]);
            ab = ab + u[j];
        }
        float tot;
        const float ba = cA + lanes_above(aa, lane, G, tot);
        cA = cA + tot;
        const float bb = cB + lanes_above(ab, lane, G, tot);
        cB = cB + tot;
        float gw[RMAX], sg[RMAX], ag = 0.0f;
#pragma unroll
        for (int j = 0; j < RMAX; ++j) {
            const float ddl = 2.0f * wx[j]
                              + 2.0f * ((ba + sa[j]) - t[j] * (bb + sb[j]))
                              + (2.0f / 3.0f) * delta * u[j];
            gw[j] = go + gd * t[j] + gl * v[j] * ddl;
        }
#pragma unroll
        for (int j = RMAX - 1; j >= 0; --j) {
            sg[j] = ag;
            ag = ag + __fmul_rn(gw[j], w[j]);
        }
        const float bg = cG + lanes_above(ag, lane, G, tot);
        cG = cG + tot;
        float ds[RMAX];
#pragma unroll
        for (int j = 0; j < RMAX; ++j)
            ds[j] = (gw[j] * Te[j] - (bg + sg[j])) * delta;
        store_run<VEC>(g_sigma + row + p, m, ds);
    }
}

// the launch's shape; cudaErrorInvalidValue for a plan the kernels do not
// take
int plan(long long n, int S, int G, int R, int vec, const void* const* ptrs,
         int n_ptrs, unsigned* blocks) {
    if (G != 8 && G != 16 && G != 32) return (int)cudaErrorInvalidValue;
    if (R < 1 || R > RMAX || S < 1) return (int)cudaErrorInvalidValue;
    if (vec) {
        if (R % 4 || S % 4) return (int)cudaErrorInvalidValue;
        for (int i = 0; i < n_ptrs; ++i)
            if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16)
                return (int)cudaErrorInvalidValue;
    }
    *blocks = (unsigned)((n + THREADS / G - 1) / (THREADS / G));
    return (int)cudaSuccess;
}

// the backward's shared memory: each group's carries of every chunk (none
// for a row of one chunk)
long long bwd_smem(int S, int G, int R) {
    const int chunks = (S + G * R - 1) / (G * R);
    return chunks > 1 ? (long long)(THREADS / G) * chunks * 3 * sizeof(float)
                      : 0;
}

}  // namespace

extern "C" int shade_composite_fwd_launch(
        const void* sigma, const void* t_mid, const void* valid, long long n,
        int S, int G, int R, int vec, float delta, void* weights,
        void* opacity, void* distance, void* dist_loss, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const void* ptrs[] = {sigma, t_mid, valid, weights};
    unsigned blocks;
    int err = plan(n, S, G, R, vec, ptrs, 4, &blocks);
    if (err) return err;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec)
        shade_fwd_kernel<true><<<blocks, THREADS, 0, st>>>(
            (const float*)sigma, (const float*)t_mid, (const float*)valid, n,
            S, G, R, delta, (float*)weights, (float*)opacity,
            (float*)distance, (float*)dist_loss);
    else
        shade_fwd_kernel<false><<<blocks, THREADS, 0, st>>>(
            (const float*)sigma, (const float*)t_mid, (const float*)valid, n,
            S, G, R, delta, (float*)weights, (float*)opacity,
            (float*)distance, (float*)dist_loss);
    return (int)cudaGetLastError();
}

extern "C" int shade_composite_bwd_launch(
        const void* sigma, const void* t_mid, const void* valid, long long n,
        int S, int G, int R, int vec, float delta, const void* g_op,
        const void* g_dist, const void* g_dl, void* g_sigma, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    const void* ptrs[] = {sigma, t_mid, valid, g_sigma};
    unsigned blocks;
    int err = plan(n, S, G, R, vec, ptrs, 4, &blocks);
    if (err) return err;
    const long long smem = bwd_smem(S, G, R);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (vec)
        shade_bwd_kernel<true><<<blocks, THREADS, (size_t)smem, st>>>(
            (const float*)sigma, (const float*)t_mid, (const float*)valid, n,
            S, G, R, delta, (const float*)g_op, (const float*)g_dist,
            (const float*)g_dl, (float*)g_sigma);
    else
        shade_bwd_kernel<false><<<blocks, THREADS, (size_t)smem, st>>>(
            (const float*)sigma, (const float*)t_mid, (const float*)valid, n,
            S, G, R, delta, (const float*)g_op, (const float*)g_dist,
            (const float*)g_dl, (float*)g_sigma);
    return (int)cudaGetLastError();
}
