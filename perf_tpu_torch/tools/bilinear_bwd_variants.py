"""Design probe of the resampler's backward (K9, ``bilinear_sample_bwd``) on
one CUDA GPU.

Times the kernel's two routes and two earlier designs of the image
gradient, each beside autograd's gradient of the plain version and
``grid_sampler_2d_backward``, at the distillation's two calls
(``priors/pano_joint.py``: the local depth-bias map [60, 384, 384, 1] and
normal-bias map [60, 384, 384, 3], 256 random samples a view, border
padding), at 1024 samples a view (the sorted route's largest count), and
at a dense shape ([4, 256, 512, 1], 131,072 random samples an image):

- ``sorted`` and ``fixed_point``: the kernel in ``kernels/csrc/bilinear.cu``
  through ``bilinear_sample_grad_cuda`` with its route forced (one block
  an image sorting its products by pixel; fixed-point sums whose passes
  touch only the pixels the taps reach); ``kernel`` is the route the
  wrapper picks;
- ``fixed_dense``: the same fixed-point sums with the accumulator filled
  and rounded over the whole image (two passes over 8 bytes a pixel and
  channel, and a read of the zeroed float image);
- ``float_atomics``: one float atomic a product (the design before fixed
  point: its sums change order from launch to launch).

The earlier designs share the kernel's tap code (``#include`` of the
source). Each design is checked against autograd (largest absolute
difference over the largest absolute value, the card test's reading) and
against a second launch (bitwise or not). Times are CUDA events over 20
launches, queued behind a spin kernel, seven rounds in turn (three at the
dense shape); the median is printed with the card's name and power limit.
It runs on CUDA only and exits non-zero without a GPU.

    python -m perf_tpu_torch.tools.bilinear_bwd_variants
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from .bilinear_variants import timed

VARIANTS = ("fixed_dense", "float_atomics")

SOURCE = r"""
#include "bilinear.cu"

namespace {

__global__ void __launch_bounds__(THREADS)
dense_max_kernel(const float* __restrict__ grad, long long n,
                 unsigned* __restrict__ gmax) {
    float v = 0.0f;
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS) {
        const float a = fabsf(__ldg(grad + i));
        if (a <= FLT_MAX) v = fmaxf(v, a);
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
    if ((threadIdx.x & 31) == 0) atomicMax(gmax, __float_as_uint(v));
}

__global__ void __launch_bounds__(THREADS)
dense_round_kernel(const long long* __restrict__ acc, long long n,
                   const unsigned* __restrict__ gmax, int m,
                   float* __restrict__ grad_img) {
    const double inv = 1.0 / fixed_scale(gmax, m);
    for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
         i += (long long)gridDim.x * THREADS)
        grad_img[i] = __fadd_rn(grad_img[i],
                                __double2float_rn(__ll2double_rn(acc[i]) * inv));
}

unsigned one_wave(long long n) {
    const long long blocks = (n + THREADS - 1) / THREADS;
    return (unsigned)(blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

__global__ void __launch_bounds__(THREADS)
atomic_bwd_kernel(const float* __restrict__ grad, int h, int w, int c,
                  const float2* __restrict__ coords, int m,
                  float* __restrict__ grad_img) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= m) return;
    const size_t b = blockIdx.y;
    const float2 rc = __ldg(coords + b * (size_t)m + i);
    const Taps t = taps_of<BORDER>(rc.x, rc.y, h, w);
    float* base = grad_img + b * (size_t)h * w * c;
    const float* g = grad + (b * (size_t)m + i) * c;
    for (int ch = 0; ch < c; ++ch) {
        const float gc = g[ch];
        if (gc == 0.0f) continue;
        atomicAdd(base + t.i00 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.ay));
        atomicAdd(base + t.i01 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.ay));
        atomicAdd(base + t.i10 * c + ch, __fmul_rn(__fmul_rn(gc, t.ax), t.wy));
        atomicAdd(base + t.i11 * c + ch, __fmul_rn(__fmul_rn(gc, t.wx), t.wy));
    }
}

}  // namespace

// v 0: fixed_dense, 1: float_atomics (border only);
// grad_img zeroed by the caller; acc: pixels int64 scratch, gmax: uint32.
extern "C" int variant_bwd_launch(int v, const void* grad, int b, int h,
                                  int w, int c, const void* coords, int m,
                                  void* acc, void* gmax, void* grad_img,
                                  void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const float* g = (const float*)grad;
    const float2* co = (const float2*)coords;
    float* gi = (float*)grad_img;
    const dim3 grid((unsigned)((m + THREADS - 1) / THREADS), (unsigned)b);
    const long long pixels = (long long)b * h * w * c;
    if (v == 0) {
        cudaMemsetAsync(acc, 0, (size_t)pixels * 8, s);
        cudaMemsetAsync(gmax, 0, 4, s);
        const long long n = (long long)b * m * c;
        dense_max_kernel<<<one_wave(n), THREADS, 0, s>>>(g, n, (unsigned*)gmax);
        bilinear_bwd_kernel<BORDER><<<grid, THREADS, 0, s>>>(
            g, h, w, c, co, m, (const unsigned*)gmax,
            (unsigned long long*)acc, gi);
        dense_round_kernel<<<one_wave(pixels), THREADS, 0, s>>>(
            (const long long*)acc, pixels, (const unsigned*)gmax, m, gi);
    } else if (v == 1) {
        atomic_bwd_kernel<<<grid, THREADS, 0, s>>>(g, h, w, c, co, m, gi);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    """Compile the variants for sm_90a into ``build/kernels`` and load them."""
    from ..kernels import cuda
    head = (cuda.CSRC / "bilinear.cu").read_bytes()
    digest = hashlib.sha256(SOURCE.encode() + head).hexdigest()[:12]
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda.BUILD_DIR / f"bilinear_bwd_variants.{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(SOURCE)
        subprocess.run([cuda._nvcc(), *cuda.ARCH_FLAGS, *cuda.BASE_FLAGS,
                        "-I", str(cuda.CSRC), "-o", str(so), str(cu)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.variant_bwd_launch.argtypes = [
        cuda.I32, cuda.P, cuda.I32, cuda.I32, cuda.I32, cuda.I32, cuda.P,
        cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P]
    lib.variant_bwd_launch.restype = cuda.I32
    return lib


def shape_row(lib, shape, m: int, gen, rounds: int) -> dict:
    """Every design at image gradient ``shape`` [B, H, W, C] from m random
    samples an image: its error against autograd, whether it repeats
    bitwise, and its median ms over ``rounds``."""
    from ..core.resample import (BWD_ROUTES, SORTED_MAX_SAMPLES,
                                 bilinear_sample_grad_cuda,
                                 bilinear_sample_plain)
    dev = torch.device("cuda")
    b, h, w, c = shape
    co = torch.rand((b, m, 2), generator=gen, device=dev)
    cot = torch.randn((b, m, c), generator=gen, device=dev)
    leaf = torch.zeros(shape, device=dev, requires_grad=True)
    (ref,) = torch.autograd.grad(bilinear_sample_plain(leaf, co, "border"),
                                 leaf, cot)
    acc = torch.empty(shape, dtype=torch.int64, device=dev)
    gmax = torch.empty(1, dtype=torch.int32, device=dev)

    def variant(v):
        def call():
            out = torch.zeros(shape, device=dev)
            err = lib.variant_bwd_launch(
                v, cot.data_ptr(), b, h, w, c, co.data_ptr(), m,
                acc.data_ptr(), gmax.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"variant {VARIANTS[v]}: cudaError {err}")
            return out
        return call

    grid = (co.flip(-1) * 2.0 - 1.0)[:, :, None, :]
    gcot = cot.permute(0, 2, 1)[..., None]
    zeros = torch.zeros(shape, device=dev).permute(0, 3, 1, 2)
    calls = {"kernel": lambda: bilinear_sample_grad_cuda(shape, co, "border",
                                                         cot),
             **{route: (lambda route=route: bilinear_sample_grad_cuda(
                 shape, co, "border", cot, route)) for route in BWD_ROUTES},
             **{name: variant(v) for v, name in enumerate(VARIANTS)},
             "autograd": lambda: torch.autograd.grad(
                 bilinear_sample_plain(leaf, co, "border"), leaf, cot)[0],
             "library": lambda: torch.ops.aten.grid_sampler_2d_backward(
                 gcot, zeros, grid, 0, 1, False, [True, False])[0]}
    top = ref.abs().max()
    row = {"shape": list(shape), "samples_per_image": m,
           "kernel_route": ("sorted" if m <= SORTED_MAX_SAMPLES
                            else "fixed_point"),
           "vs_autograd": {}, "repeats_bitwise": {}}
    for name, fn in calls.items():
        a, again = fn(), fn()
        if name == "library":
            a, again = (t.permute(0, 2, 3, 1) for t in (a, again))
        torch.cuda.synchronize()
        row["vs_autograd"][name] = ((a - ref).abs().max() / top).item()
        row["repeats_bitwise"][name] = torch.equal(a, again)
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            times[name].append(timed(fn))
    row["ms"] = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("bilinear_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    lib = build()
    rows = [shape_row(lib, (60, 384, 384, 1), 256, gen, 7),
            shape_row(lib, (60, 384, 384, 3), 256, gen, 7),
            shape_row(lib, (60, 384, 384, 1), 1024, gen, 7),
            shape_row(lib, (4, 256, 512, 1), 131072, gen, 3)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    for row in rows:
        print(json.dumps({"card": smi[0], **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
