// prop: the proposal estimator's per-ray functions (nerfacc's
// PropNetEstimator counterpart), one warp per ray.
//
// Replaces (JAX): perf_tpu/render/prop.py _sample_from_weights (42-63),
// _weights_from_density (66-71) with the last-sample override of 102, and
// prop_loss (142-162, one proposal level per launch), with the gradients
// that JAX takes by autodiff (the resampled edges have none: 107 stops it).
//
// Entry points:
//   prop_resample:    edges [N, M+1], weights [N, M], u [N, n+1]
//                     -> new edges [N, n+1] (and, if asked, the searched
//                     indices [N, n+1] int32);
//   prop_weights:     sigma [N, M], edges [N, M+1] -> w [N, M];
//   prop_weights_bwd: + dw [N, M] -> dsigma [N, M];
//   prop_loss:        proposal edges [N, M+1], proposal w [N, M], final
//                     edges [N, n+1], final w [N, n] -> per-ray sum of
//                     clip(w - bound, 0)^2 / (w + 1e-7) [N];
//   prop_loss_bwd:    + d per-ray sum [N] -> d proposal w [N, M].
//
// JAX's arithmetic, kept on purpose (the file is compiled with -fmad=false
// and writes its sums with rounding intrinsics):
// - Prefix sums run in XLA's CPU order (its reduce-window rewrite of
//   cumsum): blocks of 16 scanned in sequence, the block totals scanned in
//   sequence, each block offset by the sum of the blocks before it
//   (xla_scan below; M <= 256, so one level of blocks). The plain version
//   (render/prop.py, xla_cumsum) is the same order.
// - The exclusive transmittance prefix is the inclusive prefix minus tau in
//   float32, not a true exclusive scan: with the last proposal sigma set to
//   1e10, tau there is ~1.5e8, whose float32 ulp is 16, so the prefix before
//   the last bin comes out as a multiple of 16, as in JAX.
// - Searches are jnp.searchsorted's (side left, method scan): a fixed
//   ceil(log2(len + 1)) halvings of [0, len) with "q <= a[mid]" going left,
//   so nearly sorted edges are searched alike.
// - The resampling keeps max(cdf_hi - cdf_lo, 1e-10) and the clips.
//
// What bounds it on the H100: at the production shapes (8192 rays, 128 and
// 64 proposal bins, 64 final samples) each launch moves 2-10 MB, 1-3 us at
// 3.35 TB/s, so a launch costs more than its bytes. A warp owns a ray: its
// rows are staged in shared memory with coalesced loads, the up to 16
// blocks of the prefix sum are scanned by one lane each, and the searches
// and per-bin arithmetic spread over the lanes. Sums whose order is free
// (the loss, the suffix sums of the backwards) still run in a fixed order,
// so a launch is repeatable bitwise.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_BINS = 256;           // M and n; one level of 16-blocks
constexpr int ROW = MAX_BINS + 4;       // M + 1 entries, padded

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// In-place inclusive prefix sum of s[0, m) in XLA's CPU order; every lane of
// the warp calls it.
__device__ void xla_scan(float* s, int m, int lane) {
    const int nb = (m + 15) / 16;
    __syncwarp();
    if (lane < nb) {
        float acc = 0.0f;
        const int end = min(m, lane * 16 + 16);
        for (int j = lane * 16; j < end; ++j) {
            acc = add(acc, s[j]);
            s[j] = acc;
        }
    }
    __syncwarp();
    float pre = 0.0f;
    if (lane < nb)
        for (int b = 0; b < lane; ++b) pre = add(pre, s[b * 16 + 15]);
    __syncwarp();
    if (lane < nb) {
        const int end = min(m, lane * 16 + 16);
        for (int j = lane * 16; j < end; ++j) s[j] = add(pre, s[j]);
    }
    __syncwarp();
}

// jnp.searchsorted(a[0, len), q, side="left", method="scan").
__device__ int search_left(const float* a, int len, float q) {
    int levels = 0;
    while ((1 << levels) < len + 1) ++levels;
    int lo = 0, hi = len;
    for (int i = 0; i < levels; ++i) {
        const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
        if (q <= a[mid]) hi = mid; else lo = mid;
    }
    return hi;
}

// tau of bin j and the transmittance prefix C - tau: tau into tau[], the
// inclusive prefix into pre[] (XLA's order), as _weights_from_density.
__device__ void load_tau(const float* sigma, const float* edges, int m,
                         int override_last, int lane, float* tau, float* pre) {
    for (int j = lane; j < m; j += 32) {
        const float s = (override_last && j == m - 1) ? 1e10f : sigma[j];
        const float t = mul(s, sub(edges[j + 1], edges[j]));
        tau[j] = t;
        pre[j] = t;
    }
    xla_scan(pre, m, lane);
}

__global__ void __launch_bounds__(THREADS)
weights_kernel(const float* __restrict__ sigma, const float* __restrict__ edges,
               int n_rays, int m, int override_last, float* __restrict__ w) {
    __shared__ float sh_tau[WARPS][ROW], sh_pre[WARPS][ROW];
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long r = (long long)blockIdx.x * WARPS + wid;
    if (r >= n_rays) return;
    float* tau = sh_tau[wid];
    float* pre = sh_pre[wid];
    load_tau(sigma + r * m, edges + r * (m + 1), m, override_last, lane, tau,
             pre);
    for (int j = lane; j < m; j += 32) {
        const float trans = expf(-sub(pre[j], tau[j]));
        const float alpha = sub(1.0f, expf(-tau[j]));
        w[r * m + j] = mul(trans, alpha);
    }
}

// dtau_k = (g_k T_k) e^-tau_k + (R_k - dX_k) with dX = -((g alpha) T) and
// R the suffix sums of dX (XLA's order on the reversed row), as JAX's
// autodiff writes it; dsigma = dtau * dt, 0 for an overridden last sigma.
__global__ void __launch_bounds__(THREADS)
weights_bwd_kernel(const float* __restrict__ sigma,
                   const float* __restrict__ edges, const float* __restrict__ g,
                   int n_rays, int m, int override_last,
                   float* __restrict__ dsigma) {
    __shared__ float sh_tau[WARPS][ROW], sh_pre[WARPS][ROW], sh_rev[WARPS][ROW];
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long r = (long long)blockIdx.x * WARPS + wid;
    if (r >= n_rays) return;
    float* tau = sh_tau[wid];
    float* pre = sh_pre[wid];
    float* rev = sh_rev[wid];
    const float* e = edges + r * (m + 1);
    load_tau(sigma + r * m, e, m, override_last, lane, tau, pre);
    for (int j = lane; j < m; j += 32) {
        const float trans = expf(-sub(pre[j], tau[j]));
        const float alpha = sub(1.0f, expf(-tau[j]));
        const float dx = -mul(mul(g[r * m + j], alpha), trans);
        rev[m - 1 - j] = dx;
        pre[j] = trans;            // pre now holds T
        tau[j] = dx;               // keep dX beside it; tau is recomputed
    }
    xla_scan(rev, m, lane);
    for (int j = lane; j < m; j += 32) {
        const float t = mul(override_last && j == m - 1 ? 1e10f : sigma[r * m + j],
                            sub(e[j + 1], e[j]));
        const float da = mul(mul(g[r * m + j], pre[j]), expf(-t));
        const float dtau = add(da, sub(rev[m - 1 - j], tau[j]));
        dsigma[r * m + j] = (override_last && j == m - 1)
                                ? 0.0f : mul(dtau, sub(e[j + 1], e[j]));
    }
}

__global__ void __launch_bounds__(THREADS)
resample_kernel(const float* __restrict__ edges, const float* __restrict__ weights,
                const float* __restrict__ u, int n_rays, int m, int n_out,
                float* __restrict__ out, int* __restrict__ idx_out) {
    __shared__ float sh_cdf[WARPS][ROW], sh_t[WARPS][ROW];
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long r = (long long)blockIdx.x * WARPS + wid;
    if (r >= n_rays) return;
    float* cdf = sh_cdf[wid];
    float* t = sh_t[wid];
    for (int j = lane; j < m; j += 32) cdf[j + 1] = add(weights[r * m + j], 1e-5f);
    for (int j = lane; j <= m; j += 32) t[j] = edges[r * (m + 1) + j];
    if (lane == 0) cdf[0] = 0.0f;
    xla_scan(cdf + 1, m, lane);
    const float total = cdf[m];
    __syncwarp();
    for (int j = lane; j <= m; j += 32) cdf[j] = div(cdf[j], total);
    __syncwarp();
    for (int k = lane; k < n_out; k += 32) {
        const float q = u[r * n_out + k];
        const int i = min(max(search_left(cdf, m + 1, q), 1), m);
        const float c_lo = cdf[i - 1], c_hi = cdf[i];
        const float frac = fminf(fmaxf(
            div(sub(q, c_lo), fmaxf(sub(c_hi, c_lo), 1e-10f)), 0.0f), 1.0f);
        out[r * n_out + k] = add(t[i - 1], mul(frac, sub(t[i], t[i - 1])));
        if (idx_out) idx_out[r * n_out + k] = i;
    }
}

// The proposal CDF (0, then XLA's prefix of wp) and edges of a ray, staged.
__device__ void load_proposal(const float* te, const float* wp, int m, int lane,
                              float* cdf, float* edges) {
    for (int j = lane; j < m; j += 32) cdf[j + 1] = wp[j];
    for (int j = lane; j <= m; j += 32) edges[j] = te[j];
    if (lane == 0) cdf[0] = 0.0f;
    xla_scan(cdf + 1, m, lane);
}

// Final interval k's (lo, hi) CDF rows and w - bound.
__device__ float interval_excess(const float* cdf, const float* edges, int m,
                                 const float* tf, float wf, int k, int* lo,
                                 int* hi) {
    *lo = min(max(search_left(edges, m + 1, tf[k]) - 1, 0), m);
    *hi = min(max(search_left(edges, m + 1, tf[k + 1]), 0), m);
    return sub(wf, sub(cdf[*hi], cdf[*lo]));
}

__global__ void __launch_bounds__(THREADS)
loss_kernel(const float* __restrict__ te, const float* __restrict__ wp,
            const float* __restrict__ tf, const float* __restrict__ wf,
            int n_rays, int m, int n, float* __restrict__ out) {
    __shared__ float sh_cdf[WARPS][ROW], sh_e[WARPS][ROW], sh_term[WARPS][ROW];
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long r = (long long)blockIdx.x * WARPS + wid;
    if (r >= n_rays) return;
    float* cdf = sh_cdf[wid];
    float* e = sh_e[wid];
    float* term = sh_term[wid];
    load_proposal(te + r * (m + 1), wp + r * m, m, lane, cdf, e);
    for (int k = lane; k < n; k += 32) {
        int lo, hi;
        const float w = wf[r * n + k];
        const float x = fmaxf(interval_excess(cdf, e, m, tf + r * (n + 1), w,
                                              k, &lo, &hi), 0.0f);
        term[k] = div(mul(x, x), add(w, 1e-7f));
    }
    __syncwarp();
    if (lane == 0) {
        float acc = 0.0f;
        for (int k = 0; k < n; ++k) acc = add(acc, term[k]);
        out[r] = acc;
    }
}

// d term_k / d bound_k = -(g / (w + 1e-7)) 2 x where w - bound > 0 (JAX's
// max passes 0.5 at a tie, where x = 0); bound = cdf[hi] - cdf[lo]; the CDF
// cotangent is accumulated in k order by one lane, then d wp_i = the sum of
// d cdf[j] over j > i (XLA's order on the reversed row).
__global__ void __launch_bounds__(THREADS)
loss_bwd_kernel(const float* __restrict__ te, const float* __restrict__ wp,
                const float* __restrict__ tf, const float* __restrict__ wf,
                const float* __restrict__ g, int n_rays, int m, int n,
                float* __restrict__ dwp) {
    __shared__ float sh_cdf[WARPS][ROW], sh_e[WARPS][ROW], sh_db[WARPS][ROW];
    __shared__ short sh_lo[WARPS][ROW], sh_hi[WARPS][ROW];
    const int wid = threadIdx.x / 32, lane = threadIdx.x % 32;
    const long long r = (long long)blockIdx.x * WARPS + wid;
    if (r >= n_rays) return;
    float* cdf = sh_cdf[wid];
    float* e = sh_e[wid];
    float* db = sh_db[wid];
    load_proposal(te + r * (m + 1), wp + r * m, m, lane, cdf, e);
    const float gr = g[r];
    for (int k = lane; k < n; k += 32) {
        int lo, hi;
        const float w = wf[r * n + k];
        const float d = interval_excess(cdf, e, m, tf + r * (n + 1), w, k, &lo,
                                        &hi);
        const float x = fmaxf(d, 0.0f);
        const float gx = mul(div(gr, add(w, 1e-7f)), mul(2.0f, x));
        db[k] = d > 0.0f ? -gx : (d == 0.0f ? -mul(0.5f, gx) : 0.0f);
        sh_lo[wid][k] = (short)lo;
        sh_hi[wid][k] = (short)hi;
    }
    __syncwarp();
    float* dcdf = cdf;                  // the CDF is no longer needed
    for (int j = lane; j <= m; j += 32) dcdf[j] = 0.0f;
    __syncwarp();
    if (lane == 0)
        for (int k = 0; k < n; ++k) {
            dcdf[sh_hi[wid][k]] = add(dcdf[sh_hi[wid][k]], db[k]);
            dcdf[sh_lo[wid][k]] = sub(dcdf[sh_lo[wid][k]], db[k]);
        }
    __syncwarp();
    // reversed d cdf[1..m] into e, scanned: e[m - 1 - i] = sum_{j > i} dcdf[j]
    for (int i = lane; i < m; i += 32) e[m - 1 - i] = dcdf[i + 1];
    xla_scan(e, m, lane);
    for (int i = lane; i < m; i += 32) dwp[r * m + i] = e[m - 1 - i];
}

unsigned blocks_for(int n_rays) { return (unsigned)((n_rays + WARPS - 1) / WARPS); }

bool shapes_ok(int n_rays, int m) { return n_rays > 0 && m > 0 && m <= MAX_BINS; }

}  // namespace

extern "C" int prop_resample_launch(const void* edges, const void* weights,
                                    const void* u, int n_rays, int m, int n_out,
                                    void* out, void* idx_out, void* stream) {
    if (!shapes_ok(n_rays, m) || n_out > MAX_BINS + 1) return (int)cudaErrorInvalidValue;
    resample_kernel<<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)edges, (const float*)weights, (const float*)u, n_rays, m,
        n_out, (float*)out, (int*)idx_out);
    return (int)cudaGetLastError();
}

extern "C" int prop_weights_launch(const void* sigma, const void* edges,
                                   int n_rays, int m, int override_last,
                                   void* w, void* stream) {
    if (!shapes_ok(n_rays, m)) return (int)cudaErrorInvalidValue;
    weights_kernel<<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)sigma, (const float*)edges, n_rays, m, override_last,
        (float*)w);
    return (int)cudaGetLastError();
}

extern "C" int prop_weights_bwd_launch(const void* sigma, const void* edges,
                                       const void* g, int n_rays, int m,
                                       int override_last, void* dsigma,
                                       void* stream) {
    if (!shapes_ok(n_rays, m)) return (int)cudaErrorInvalidValue;
    weights_bwd_kernel<<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)sigma, (const float*)edges, (const float*)g, n_rays, m,
        override_last, (float*)dsigma);
    return (int)cudaGetLastError();
}

extern "C" int prop_loss_launch(const void* te, const void* wp, const void* tf,
                                const void* wf, int n_rays, int m, int n,
                                void* out, void* stream) {
    if (!shapes_ok(n_rays, m) || n <= 0 || n > MAX_BINS) return (int)cudaErrorInvalidValue;
    loss_kernel<<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)te, (const float*)wp, (const float*)tf, (const float*)wf,
        n_rays, m, n, (float*)out);
    return (int)cudaGetLastError();
}

extern "C" int prop_loss_bwd_launch(const void* te, const void* wp, const void* tf,
                                    const void* wf, const void* g, int n_rays,
                                    int m, int n, void* dwp, void* stream) {
    if (!shapes_ok(n_rays, m) || n <= 0 || n > MAX_BINS) return (int)cudaErrorInvalidValue;
    loss_bwd_kernel<<<blocks_for(n_rays), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)te, (const float*)wp, (const float*)tf, (const float*)wf,
        (const float*)g, n_rays, m, n, (float*)dwp);
    return (int)cudaGetLastError();
}
