"""Design probe of the ``bilinear`` forward (K9) on one CUDA GPU.

Times variants of the one-channel, border-padded forward against the
kernel in ``kernels/csrc/bilinear.cu`` (through ``bilinear_sample_cuda``)
and ``F.grid_sample``, on a [4, 1024, 2048, 1] float32 stack (the
visibility core's padded pano stack) at two coordinate sets of 2,097,152
samples an image:

- ``random``: uniform in [0, 1]^2 (the kernels line's row);
- ``pano``: pano 3's pixels, placed on the walls of a box room, seen from
  each of the four panos (``train/sup_pool.py`` ``_pano_proj_depths``), so
  neighbouring samples read neighbouring pixels as on the path.

Each variant shares the kernel's tap and blend code (``#include`` of the
source) and differs in how it feeds it: samples a thread takes (``s``:
a block's width apart, ``p``: pairs of neighbours read as one float4 and
written as one float2, ``g``: one sample at a time in a grid-stride loop
over one wave of blocks), the cache hint on the coordinate loads and the
output stores (``h0`` none, ``h1`` evict-first ``__ldcs`` / ``__stcs``)
and threads a block (``t128`` to ``t1024``; 256 otherwise). The kernel
itself takes one sample a thread with ``h1`` in blocks of 1024; ``s4_h0``
is its design before that. Every variant's output is checked bitwise
against the kernel's. Times are CUDA events over 20 launches, queued
behind a spin kernel, seven rounds in turn; the median is printed. It
runs on CUDA only and exits non-zero without a GPU or on a mismatch.

    python -m perf_tpu_torch.tools.bilinear_variants
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import math
import subprocess
import sys

import torch

# name -> (samples a thread, feed: 0 apart, 1 pairs, 2 grid-stride, hint,
# threads a block)
VARIANTS = {
    "s4_h0": (4, 0, 0, 256), "s8_h1": (8, 0, 1, 256),
    "s2_h1": (2, 0, 1, 256), "s2_h1_t128": (2, 0, 1, 128),
    "s1_h1": (1, 0, 1, 256), "s1_h0_t128": (1, 0, 0, 128),
    "p2_h1_t128": (2, 1, 1, 128), "p4_h1": (4, 1, 1, 256),
    "s1_h1_t512": (1, 0, 1, 512), "s1_h1_t128": (1, 0, 1, 128),
    "s2_h1_t512": (2, 0, 1, 512), "s1_h0_t512": (1, 0, 0, 512),
    "g_h1_t128": (1, 2, 1, 128), "g_h1_t256": (1, 2, 1, 256),
    "g_h1_t512": (1, 2, 1, 512), "g_h1_t1024": (1, 2, 1, 1024),
}

SOURCE = r"""
#include "bilinear.cu"

namespace {

template <int HINT>
__device__ __forceinline__ float2 ld2(const float2* p) {
    return HINT ? __ldcs(p) : __ldg(p);
}

template <int HINT>
__device__ __forceinline__ float4 ld4(const float4* p) {
    return HINT ? __ldcs(p) : __ldg(p);
}

template <int HINT>
__device__ __forceinline__ void st1(float* p, float v) {
    if constexpr (HINT) __stcs(p, v); else *p = v;
}

template <int HINT>
__device__ __forceinline__ void st2(float2* p, float2 v) {
    if constexpr (HINT) __stcs(p, v); else *p = v;
}

// C = 1, border. PAIR = 0: SPT samples a block's width apart; PAIR = 1:
// SPT / 2 pairs of neighbours a block's width apart (m even).
template <int SPT, int PAIR, int HINT, int THR>
__global__ void __launch_bounds__(THR)
variant_fwd(const float* __restrict__ img, int h, int w,
            const float2* __restrict__ coords, int m,
            float* __restrict__ out) {
    const size_t b = blockIdx.y;
    const float* image = img + b * (size_t)h * w;
    coords += b * (size_t)m;
    out += b * (size_t)m;
    Taps t[SPT];
    float v[SPT][4];
    if constexpr (PAIR == 2) {             // one wave, grid-stride
        for (int i = blockIdx.x * THR + threadIdx.x; i < m;
             i += gridDim.x * THR) {
            const float2 rc = ld2<HINT>(coords + i);
            const Taps q = taps_of<BORDER>(rc.x, rc.y, h, w);
            st1<HINT>(out + i, blend(q, __ldg(image + q.i00),
                                     __ldg(image + q.i01),
                                     __ldg(image + q.i10),
                                     __ldg(image + q.i11)));
        }
    } else if constexpr (PAIR == 0) {
        const int first = blockIdx.x * (THR * SPT) + threadIdx.x;
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int i = first + k * THR;
            const float2 rc = i < m ? ld2<HINT>(coords + i)
                                    : make_float2(0.0f, 0.0f);
            t[k] = taps_of<BORDER>(rc.x, rc.y, h, w);
        }
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            v[k][0] = __ldg(image + t[k].i00);
            v[k][1] = __ldg(image + t[k].i01);
            v[k][2] = __ldg(image + t[k].i10);
            v[k][3] = __ldg(image + t[k].i11);
        }
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            const int i = first + k * THR;
            if (i >= m) break;
            st1<HINT>(out + i, blend(t[k], v[k][0], v[k][1], v[k][2],
                                     v[k][3]));
        }
    } else {
        constexpr int NP = SPT / 2;
        const int first = blockIdx.x * (THR * NP) + threadIdx.x;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int i = 2 * (first + k * THR);
            const float4 rc = i < m
                ? ld4<HINT>(reinterpret_cast<const float4*>(coords + i))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            t[2 * k] = taps_of<BORDER>(rc.x, rc.y, h, w);
            t[2 * k + 1] = taps_of<BORDER>(rc.z, rc.w, h, w);
        }
#pragma unroll
        for (int k = 0; k < SPT; ++k) {
            v[k][0] = __ldg(image + t[k].i00);
            v[k][1] = __ldg(image + t[k].i01);
            v[k][2] = __ldg(image + t[k].i10);
            v[k][3] = __ldg(image + t[k].i11);
        }
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int i = 2 * (first + k * THR);
            if (i >= m) break;
            st2<HINT>(reinterpret_cast<float2*>(out + i), make_float2(
                blend(t[2 * k], v[2 * k][0], v[2 * k][1], v[2 * k][2],
                      v[2 * k][3]),
                blend(t[2 * k + 1], v[2 * k + 1][0], v[2 * k + 1][1],
                      v[2 * k + 1][2], v[2 * k + 1][3])));
        }
    }
}

template <int SPT, int PAIR, int HINT, int THR>
void launch_variant(const float* img, int b, int h, int w,
                    const float2* coords, int m, float* out, cudaStream_t s) {
    const int per_block = THR * SPT;
    int blocks = (m + per_block - 1) / per_block;
    if (PAIR == 2) {                       // as many blocks as fit at once
        int sms = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
        blocks = min(blocks, max(1, sms * (2048 / THR) / b));
    }
    const dim3 grid((unsigned)blocks, (unsigned)b);
    variant_fwd<SPT, PAIR, HINT, THR><<<grid, THR, 0, s>>>(img, h, w, coords,
                                                           m, out);
}

}  // namespace

extern "C" int variant_launch(int v, const void* img, int b, int h, int w,
                              const void* coords, long long m, void* out,
                              void* stream) {
    const float* im = (const float*)img;
    const float2* co = (const float2*)coords;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (v) {
%CASES%
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
"""


def build() -> ctypes.CDLL:
    """Compile the variants for sm_90a into ``build/kernels`` and load them."""
    from ..kernels import cuda
    cases = "\n".join(
        f"    case {i}: launch_variant<{s}, {p}, {hint}, {thr}>(im, b, h, w, "
        f"co, (int)m, o, s); break;"
        for i, (s, p, hint, thr) in enumerate(VARIANTS.values()))
    src = SOURCE.replace("%CASES%", cases)
    head = (cuda.CSRC / "bilinear.cu").read_bytes()
    digest = hashlib.sha256(src.encode() + head).hexdigest()[:12]
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda.BUILD_DIR / f"bilinear_variants.{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(src)
        subprocess.run([cuda._nvcc(), *cuda.ARCH_FLAGS, *cuda.BASE_FLAGS,
                        "-I", str(cuda.CSRC), "-o", str(so), str(cu)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.variant_launch.argtypes = [cuda.I32, cuda.P, cuda.I32, cuda.I32,
                                   cuda.I32, cuda.P, cuda.I64, cuda.P,
                                   cuda.P]
    lib.variant_launch.restype = cuda.I32
    return lib


def pano_coords(h: int, w: int, device) -> torch.Tensor:
    """[4, h * w, 2]: pano 3's pixels on the walls of a 6 x 3 x 8 box room,
    projected into each of four panos inside it."""
    from ..core import direction_to_img_coord, gen_pano_rays
    centres = torch.tensor([[0.0, 0.0, 0.0], [0.8, 0.1, 0.3],
                            [-0.6, 0.2, -0.5], [0.3, -0.1, 0.7]],
                           device=device)
    poses = torch.eye(4, device=device).repeat(4, 1, 1)
    for p, yaw in enumerate((0.0, 0.7, -1.2, 2.5)):
        c, s = math.cos(yaw), math.sin(yaw)
        poses[p, :3, :3] = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0],
                                         [-s, 0.0, c]], device=device)
        poses[p, :3, 3] = centres[p]
    rays = gen_pano_rays(poses[3], h, w)
    half = torch.tensor([3.0, 1.5, 4.0], device=device)
    d = torch.where(rays.d.abs() < 1e-9, torch.full_like(rays.d, 1e-9),
                    rays.d)
    t = ((torch.sign(d) * half - rays.o) / d).amin(-1, keepdim=True)
    pts = rays.o + rays.d * t
    rel = pts[None] - poses[:, None, None, :3, 3]
    local = torch.einsum("pji,phwj->phwi", poses[:, :3, :3], rel)
    local = local / torch.linalg.norm(local, dim=-1, keepdim=True)
    return direction_to_img_coord(local).reshape(4, -1, 2).contiguous()


def timed(fn, iters: int = 20) -> float:
    """Device ms per call over ``iters`` calls after a warm-up, queued
    behind a ~10 ms spin kernel."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch.nn.functional as F
    from ..core.resample import bilinear_sample_cuda
    if not torch.cuda.is_available():
        print("bilinear_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    b, h, w = 4, 1024, 2048
    gen = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((b, h, w, 1), generator=gen, device=dev)
    sets = {"random": torch.rand((b, h * w, 2), generator=gen, device=dev),
            "pano": pano_coords(h, w, dev)}
    lib = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    for tag, co in sets.items():
        m = co.shape[1]
        ref = bilinear_sample_cuda(img, co, "border")
        grid = (co.flip(-1) * 2.0 - 1.0)[:, :, None, :]
        calls = {"kernel": lambda: bilinear_sample_cuda(img, co, "border"),
                 "grid_sample": lambda: F.grid_sample(
                     img.permute(0, 3, 1, 2), grid, mode="bilinear",
                     padding_mode="border", align_corners=False)}
        for i, name in enumerate(VARIANTS):
            out = torch.empty_like(ref)

            def call(i=i, out=out):
                err = lib.variant_launch(i, img.data_ptr(), b, h, w,
                                         co.data_ptr(), m, out.data_ptr(),
                                         stream())
                if err:
                    raise RuntimeError(f"variant {name}: cudaError {err}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"bilinear_variants: {name} ({tag}) differs",
                      file=sys.stderr)
                return 1
            calls[name] = call
        times = {name: [] for name in calls}
        for _ in range(7):
            for name, fn in calls.items():
                times[name].append(timed(fn))
        result[tag] = {name: sorted(t)[3] for name, t in times.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0], "shape": [b, h, w, 1],
                      "samples_per_image": h * w, "ms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
