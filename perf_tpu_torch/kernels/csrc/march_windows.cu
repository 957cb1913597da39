// march_windows: the hierarchical occupancy march, one thread per ray, in
// its eval form (no jitter) and its stratified training form (a per-ray
// jitter), plus count_windows, the per-ray occupied-window count over the
// full flat ladder that sizes the training sample budget.
//
// Replaces (JAX): perf_tpu/render/renderer.py march_windows with
// _select_segments, _fine_windows_from_segments and _probe_points, as called
// by frame_march_plan, by snapshot._snapshot_chunk_planned (fine stage only,
// segments from the plan) and, stratified, by render_rays_bucketed; and
// count_occupied_windows (renderer.py:163-183).
//
// Coarse stage (when no segments are given): walk the n_seg segment centres
// in t order against the pooled, dilated coarse grid and keep the first
// max_seg occupied ones. Fine stage: probe the fine grid at the centre of
// each of the sw windows of every kept segment, in t order, and keep the
// first max_win occupied windows. Keeping the first K hits of an ascending
// walk is what the JAX path's two top_k calls over the monotone keys
// (n - index) select. The slots left over are filled as top_k fills them:
// with the zero-key candidates in ascending candidate order (lax.top_k puts
// the lower index first among equal keys), flagged invalid. Their values
// matter on the training path: a strided encode level lerps the last valid
// samples towards the ray's last sample, which may sit in such a slot.
//
// What bounds it on the H100: one byte gather per probe from a 16 MB (256^3)
// grid that stays in L2; ~63 coarse + <= 40 fine probes per ray, latency
// bound. The ray stops walking as soon as its budgets are full. count_windows
// probes the whole ladder twice (750 probes per ray at the flagship ladder);
// it runs on 16,384 probe rays once per episode.
//
// Integer parity: the probe voxel is trunc((clip(o + d*t) * 0.5 + 0.5) * res)
// and t is evaluated in the same operation order as renderer.py:179, 201,
// 223-224. Every float operation uses a rounding intrinsic (no FMA
// contraction), and the file is also compiled with -fmad=false, so voxels
// match the float32 reference exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

struct Ray {
    float o[3], d[3];
};

__device__ __forceinline__ int probe(const uint8_t* __restrict__ grid, int res,
                                     const Ray& r, float t) {
    int v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        float w = __fadd_rn(r.o[a], __fmul_rn(r.d[a], t));
        w = fminf(fmaxf(w, -0.999f), 0.999f);
        v[a] = (int)__fmul_rn(__fadd_rn(__fmul_rn(w, 0.5f), 0.5f), (float)res);
    }
    return grid[((long long)v[0] * res + v[1]) * res + v[2]] != 0;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays_o,
                                        const float* __restrict__ rays_d,
                                        long long i) {
    Ray r;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        r.o[a] = rays_o[3 * i + a];
        r.d[a] = rays_d[3 * i + a];
    }
    return r;
}

__global__ void __launch_bounds__(THREADS)
march_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
             const float* __restrict__ jitter,
             long long n, const uint8_t* __restrict__ occ, int res,
             const uint8_t* __restrict__ coarse, int cres,
             const int* __restrict__ sidx_in,
             const uint8_t* __restrict__ svalid_in, int s_in,
             int* __restrict__ sidx_out, uint8_t* __restrict__ svalid_out,
             int max_seg, int* __restrict__ widx, float* __restrict__ wvalid,
             int max_win, int* __restrict__ counts, float near, float far,
             float step, int c, int sw, int n_seg, int n_windows) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = load_ray(rays_o, rays_d, i);
    // the eval form has no jitter; adding 0.0f leaves every t unchanged
    const float jit = jitter != nullptr ? jitter[i] : 0.0f;
    const float fc = (float)c, fsw = (float)sw;
    const float half_sw = 0.5f * fsw, half_c = 0.5f * fc;
    int* wi = widx + i * max_win;
    float* wv = wvalid + i * max_win;
    int nw = 0;

    // fine stage over one kept segment; returns false once the budget is full
    auto fine = [&](int s) {
        for (int j = 0; j < sw && nw < max_win; ++j) {
            int w = s * sw + j;
            float t = __fadd_rn(near, __fmul_rn(__fadd_rn(
                __fadd_rn(__fmul_rn((float)w, fc), half_c), jit), step));
            if (w < n_windows && t < far && probe(occ, res, r, t)) {
                wi[nw] = w;
                wv[nw] = 1.0f;
                ++nw;
            }
        }
        return nw < max_win;
    };

    const int* si;
    const uint8_t* sv;
    int n_slots;
    if (sidx_in != nullptr) {
        si = sidx_in + i * s_in;
        sv = svalid_in + i * s_in;
        n_slots = s_in;
        for (int k = 0; k < s_in; ++k) {
            if (sv[k] && !fine(si[k])) break;
        }
    } else {
        int* so = sidx_out + i * max_seg;
        uint8_t* svo = svalid_out + i * max_seg;
        int ns = 0;
        for (int s = 0; s < n_seg && ns < max_seg; ++s) {
            float t = __fadd_rn(near, __fmul_rn(__fadd_rn(__fmul_rn(
                __fadd_rn(__fmul_rn((float)s, fsw), half_sw), fc), jit), step));
            if (t < far && probe(coarse, cres, r, t)) {
                so[ns] = s;
                svo[ns] = 1;
                ++ns;
            }
        }
        // leftover segment slots: the unselected segments, ascending
        for (int s = 0, k = 0, q = ns; s < n_seg && q < max_seg; ++s) {
            if (k < ns && so[k] == s) {
                ++k;
                continue;
            }
            so[q] = s;
            svo[q] = 0;
            ++q;
        }
        for (int k = 0; k < ns; ++k) {
            if (!fine(so[k])) break;
        }
        si = so;
        sv = svo;
        n_slots = max_seg;
    }
    counts[i] = nw;
    // leftover window slots: the unselected candidates, in candidate order
    for (int q = 0, k = 0, m = nw; q < n_slots && m < max_win; ++q) {
        for (int j = 0; j < sw && m < max_win; ++j) {
            int w = si[q] * sw + j;
            if (sv[q] && k < nw && wi[k] == w) {
                ++k;
                continue;
            }
            wi[m] = w;
            wv[m] = 0.0f;
            ++m;
        }
    }
}

__global__ void __launch_bounds__(THREADS)
count_kernel(const float* __restrict__ rays_o, const float* __restrict__ rays_d,
             long long n, const uint8_t* __restrict__ occ, int res,
             int* __restrict__ counts, float near, float far, float step, int c,
             int n_windows) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Ray r = load_ray(rays_o, rays_d, i);
    const float fc = (float)c, half_c = 0.5f * fc;
    const float offs[2] = {0.0f, 0.999f};
    int best = 0;
    for (int e = 0; e < 2; ++e) {
        int cnt = 0;
        for (int w = 0; w < n_windows; ++w) {
            float t = __fadd_rn(near, __fmul_rn(__fadd_rn(
                __fadd_rn(__fmul_rn((float)w, fc), half_c), offs[e]), step));
            if (t < far && probe(occ, res, r, t)) ++cnt;
        }
        best = max(best, cnt);
    }
    counts[i] = best;
}

}  // namespace

extern "C" int march_windows_launch(
        const void* rays_o, const void* rays_d, const void* jitter, long long n,
        const void* occ, int res, const void* coarse, int cres,
        const void* sidx_in, const void* svalid_in, int s_in, void* sidx_out,
        void* svalid_out, int max_seg, void* widx, void* wvalid, int max_win,
        void* counts, float near, float far, float step, int c, int sw,
        int n_seg, int n_windows, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    long long blocks = (n + THREADS - 1) / THREADS;
    march_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, (const float*)jitter, n,
        (const uint8_t*)occ, res, (const uint8_t*)coarse, cres,
        (const int*)sidx_in, (const uint8_t*)svalid_in, s_in, (int*)sidx_out,
        (uint8_t*)svalid_out, max_seg, (int*)widx, (float*)wvalid, max_win,
        (int*)counts, near, far, step, c, sw, n_seg, n_windows);
    return (int)cudaGetLastError();
}

extern "C" int count_windows_launch(
        const void* rays_o, const void* rays_d, long long n, const void* occ,
        int res, void* counts, float near, float far, float step, int c,
        int n_windows, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    long long blocks = (n + THREADS - 1) / THREADS;
    count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, n, (const uint8_t*)occ, res,
        (int*)counts, near, far, step, c, n_windows);
    return (int)cudaGetLastError();
}
