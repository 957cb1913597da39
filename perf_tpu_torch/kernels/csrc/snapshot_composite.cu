// snapshot_composite: expand the marched windows into samples, read the
// baked snapshot table and composite, one thread per ray.
//
// Replaces (JAX): perf_tpu/render/snapshot.py _composite_snapshot together
// with perf_tpu/render/renderer.py _windows_to_samples, as run by
// _snapshot_chunk_planned / _snapshot_chunk: the standard instance, and the
// run-dedup instance (K12, dedup_k > 0: snapshot_composite_dedup_launch).
//
// Per sample: t_mid = near + ((widx * c) + (s + 0.5) * stride) * step and
// valid = wvalid * (t_mid < far); the point's brick row in the dense
// [nb^3, 256] bf16 table (4^3 corners x (sigma, r, g, b), lane =
// ((cx*4 + cy)*4 + cz)*4 + f); trilinear interpolation of the 8 corners,
// each one aligned 8-byte load of its four features; sigma = max(sigma, 0)
// * valid * aabb-select; tau = sigma * step * stride; the transmittance is
// the exclusive running sum of tau along the ray. Then opacity, distance and
// the clipped colour are accumulated and the eval backgrounds added
// (distance + bg_distance * (1 - opacity), colour + 0.5 * (1 - opacity)).
//
// What bounds it on the H100: the table (1.1 GB at res 384) does not fit in
// L2, so each sample costs up to 8 scattered 8-byte reads inside one 512-byte
// row, i.e. a few 32-byte sectors from HBM: random-access, latency bound.
// Simple design: one thread walks its ray in t order, so the scan needs no
// cross-thread exchange and neighbouring rays (neighbouring pixels) read
// neighbouring rows. The JAX path materialises a [rays, samples, 256] row
// tensor; nothing of that size exists here.
//
// The dedup instance (JAX: one row gathered per brick run, K candidates,
// expanded back with a one-hot product, which is the bf16 row itself): the
// thread numbers the row changes along all S slots of its ray, the padding
// windows' and the samples past far included (their rows count runs, as
// JAX's rows of every slot do), and a sample whose run id (clipped at K - 1)
// reached K - 1 reads the row of run K - 1's first sample at its own cell
// and fractions; the others read their own row. The scan is sequential in
// the thread, as the composite is; where K covers every run of a ray, every
// value equals the standard instance's bitwise.
//
// Compiled with -fmad=false and written with rounding intrinsics for the
// sample positions, so the brick rows match the float32 reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

template <bool DEDUP>
__global__ void __launch_bounds__(THREADS)
composite_kernel(const float* __restrict__ rays_o,
                 const float* __restrict__ rays_d, long long n,
                 const int* __restrict__ widx, const float* __restrict__ wvalid,
                 int n_win, const __nv_bfloat16* __restrict__ table, int res,
                 int nb, float near, float far, float step, int c, int stride,
                 int spw, float tau_scale, float aabb_min, float span,
                 float bg_distance, int k_runs, float* __restrict__ rgb,
                 float* __restrict__ distance, float* __restrict__ opacity) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float o[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        o[a] = rays_o[3 * i + a];
        d[a] = rays_d[3 * i + a];
    }
    const float fres = (float)res, fc = (float)c, fst = (float)stride;
    float excl = 0.0f, op = 0.0f, dist = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
    int run = -1, prev = -1, star = 0;   // the dedup scan: run id, last row, R*
    for (int k = 0; k < n_win; ++k) {
        float wv = wvalid[i * n_win + k];
        if (!DEDUP && wv == 0.0f) continue;   // padding slot: weight 0, tau 0
        float base = __fmul_rn((float)widx[i * n_win + k], fc);
        for (int s = 0; s < spw; ++s) {
            float fine = __fmul_rn(__fadd_rn((float)s, 0.5f), fst);
            float t = __fadd_rn(near, __fmul_rn(__fadd_rn(base, fine), step));
            float valid = t < far ? wv : 0.0f;
            float p[3], fr[3];
            int b[3], loc[3];
            bool sel = true;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                p[a] = __fdiv_rn(__fsub_rn(__fadd_rn(o[a], __fmul_rn(d[a], t)),
                                           aabb_min), span);
                sel = sel && p[a] > 0.0f && p[a] < 1.0f;
                float pos = __fmul_rn(fminf(fmaxf(p[a], 0.0f), 1.0f), fres);
                float c0f = fminf(fmaxf(floorf(pos), 0.0f), fres - 1.0f);
                fr[a] = __fsub_rn(pos, c0f);
                int c0 = (int)c0f;
                b[a] = c0 / 3;
                loc[a] = c0 - 3 * b[a];
            }
            int brick = (b[0] * nb + b[1]) * nb + b[2];
            if (DEDUP) {
                if (brick != prev) {
                    if (++run == k_runs - 1) star = brick;
                    prev = brick;
                }
                if (run >= k_runs - 1) brick = star;
                if (wv == 0.0f) continue;   // padding slot: counted, weight 0
            }
            const uint2* row = reinterpret_cast<const uint2*>(
                table + (size_t)brick * 256);
            float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int ox = 0; ox < 2; ++ox) {
                float wx = ox ? fr[0] : __fsub_rn(1.0f, fr[0]);
#pragma unroll
                for (int oy = 0; oy < 2; ++oy) {
                    float wxy = __fmul_rn(wx, oy ? fr[1] : __fsub_rn(1.0f, fr[1]));
#pragma unroll
                    for (int oz = 0; oz < 2; ++oz) {
                        float w = __fmul_rn(wxy, oz ? fr[2] : __fsub_rn(1.0f, fr[2]));
                        int corner = ((loc[0] + ox) * 4 + (loc[1] + oy)) * 4 + loc[2] + oz;
                        uint2 raw = __ldg(row + corner);
                        float2 sr = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
                        float2 gb = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
                        v[0] = __fadd_rn(v[0], __fmul_rn(sr.x, w));
                        v[1] = __fadd_rn(v[1], __fmul_rn(sr.y, w));
                        v[2] = __fadd_rn(v[2], __fmul_rn(gb.x, w));
                        v[3] = __fadd_rn(v[3], __fmul_rn(gb.y, w));
                    }
                }
            }
            float sig = fmaxf(v[0], 0.0f) * valid * (sel ? 1.0f : 0.0f);
            float tau = sig * tau_scale;
            float weight = expf(-excl) * (1.0f - expf(-tau));
            excl += tau;
            op += weight;
            dist += weight * t;
            cr += weight * fminf(fmaxf(v[1], 0.0f), 1.0f);
            cg += weight * fminf(fmaxf(v[2], 0.0f), 1.0f);
            cb += weight * fminf(fmaxf(v[3], 0.0f), 1.0f);
        }
    }
    float rest = 1.0f - op;
    opacity[i] = op;
    distance[i] = dist + bg_distance * rest;
    rgb[3 * i] = cr + 0.5f * rest;
    rgb[3 * i + 1] = cg + 0.5f * rest;
    rgb[3 * i + 2] = cb + 0.5f * rest;
}

}  // namespace

namespace {

int composite_launch(bool dedup, const void* rays_o, const void* rays_d,
                     long long n, const void* widx, const void* wvalid,
                     int n_win, const void* table, int res, int nb, float near,
                     float far, float step, int c, int stride, int spw,
                     float tau_scale, float aabb_min, float span,
                     float bg_distance, int k_runs, void* rgb, void* distance,
                     void* opacity, void* stream) {
    if (n <= 0) return (int)cudaSuccess;
    long long blocks = (n + THREADS - 1) / THREADS;
    auto kernel = dedup ? composite_kernel<true> : composite_kernel<false>;
    kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rays_o, (const float*)rays_d, n, (const int*)widx,
        (const float*)wvalid, n_win, (const __nv_bfloat16*)table, res, nb, near,
        far, step, c, stride, spw, tau_scale, aabb_min, span, bg_distance,
        k_runs, (float*)rgb, (float*)distance, (float*)opacity);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int snapshot_composite_launch(
        const void* rays_o, const void* rays_d, long long n, const void* widx,
        const void* wvalid, int n_win, const void* table, int res, int nb,
        float near, float far, float step, int c, int stride, int spw,
        float tau_scale, float aabb_min, float span, float bg_distance,
        void* rgb, void* distance, void* opacity, void* stream) {
    return composite_launch(false, rays_o, rays_d, n, widx, wvalid, n_win,
                            table, res, nb, near, far, step, c, stride, spw,
                            tau_scale, aabb_min, span, bg_distance, 0, rgb,
                            distance, opacity, stream);
}

// k_runs: the run candidates K of the chunk (1 <= K; the wrapper passes
// K < S only).
extern "C" int snapshot_composite_dedup_launch(
        const void* rays_o, const void* rays_d, long long n, const void* widx,
        const void* wvalid, int n_win, const void* table, int res, int nb,
        float near, float far, float step, int c, int stride, int spw,
        float tau_scale, float aabb_min, float span, float bg_distance,
        int k_runs, void* rgb, void* distance, void* opacity, void* stream) {
    if (k_runs < 1) return (int)cudaErrorInvalidValue;
    return composite_launch(true, rays_o, rays_d, n, widx, wvalid, n_win,
                            table, res, nb, near, far, step, c, stride, spw,
                            tau_scale, aabb_min, span, bg_distance, k_runs, rgb,
                            distance, opacity, stream);
}
