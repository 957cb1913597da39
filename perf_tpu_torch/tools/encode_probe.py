"""Design probe of the encodes' forward kernels (K10, K1) on one CUDA GPU.

Both forwards are ``csrc/ray_points.cuh``'s tile encode: a block takes a
tile of rays, encodes every level's coarse points of the tile into shared
memory and writes the tile's lerped, level-concatenated rows. Two design
questions are timed here, each variant's output checked bitwise against
the kernel's (through its wrapper):

- ``layout`` (K10): the parameter is JAX's feature-major [L, 2, T], whose
  corner's two features lie T floats apart (two 4-byte reads from two
  32-byte sectors). The kernel reads an interleaved [L, T, 2] copy the
  wrapper makes per call (one 8-byte read a corner; timed with the copy);
  the variant reads [L, 2, T] as it is. The copy is also timed alone.
- ``tile``: the rays a tile takes and the threads a block, swept around
  the kernel's choice (``tile_shape``): tiles of about 32 to 320 samples
  in blocks of 128 or 256 threads (``launch_ray_tile`` with them given).
  A tile's shared memory (its coarse features and coordinates) comes out
  of the SM's L1 cache.

Shapes of the training steps and the point form's callers, on rays from
(0.5, 0.3, -0.2) in a cube room of half-extent 0.8 with samples 1e-3
apart ending 0.02 past the wall (the march's near-surface windows):

- ``hash_geo``: the hash field's geometry phase, 8192 x 128 at the strides
  of a 5e-4 march step, the default 16-level 2^18 grid;
- ``brick_scene``: the brick field's geometry phase, 8192 x 80, the same
  strides, the default 16-level 2^12-row grid;
- ``brick_prop_final``: the prop path's final field, 8192 x 64, stride 1;
- ``smooth_points``: the refiner's ``fd`` field, 7 x 32,768 directions on
  the sphere field's smoothstep grid (16 levels, 2^19, fine_res 4096);
- ``prop_points``: a proposal field's point form, 8192 x 128 points over
  [0.01, 2.0] on the 5-level 2^17 grid of max_res 256.

With ``--backward`` it probes the hash encode's backward instead (K10,
linear and smoothstep: ``hash_ray_bwd_kernel``, which takes the features'
cotangent [N, S, 2L] and forms the coarse points' cotangents itself), at
``hash_geo``, ``hash_geo_sparse`` (the same with each ray's cotangent 0
past a random first 0-32 samples: the hash steps' mostly-zero pattern),
``prop_points`` and ``smooth_points``, on bf16-valued cotangents from a
seed. Each variant is held against the plain backward
(``hash_encode_ray_bwd_plain``) by relative norm, printed with the kernel
against itself (two runs):

- ``parent``: the design before, ``lerp_levels_transpose`` in PyTorch, a
  zeroed [L, 2, T] gradient and one thread per coarse point adding 16
  float atomics (its source is kept here); ``parent_kernel`` without the
  transpose, ``glue`` the transpose alone;
- ``kernel``: the wrapper (``hash_encode_ray_bwd_cuda``);
- ``pairs`` / ``no_pairs``: the kernel's other instance, with (linear) or
  without (smoothstep) a dense level's oz = 0, 1 corners, which are
  neighbouring rows, added by one float4 atomic when they start one;
- ``no_shared``: the kernel without the levels ``shared_levels`` picks
  summed in a block's shared memory, where it picks any; else ``shared0``:
  the kernel with level 0 (where dense) summed there.

The designs tried before these (two float atomics a corner into [L, 2, T],
no sum of a cell's run of lanes, passes of fewer levels, other tile sizes)
were slower and left the kernel; PERF.md keeps their readings.

Times are CUDA events over 20 calls queued behind a spin kernel, seven
rounds in turn; the median is printed. It runs on CUDA only and exits
non-zero without a GPU or on a mismatch.

    python -m perf_tpu_torch.tools.encode_probe [--backward]
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from .bilinear_variants import timed

# appended to a copy of each kernel source: the kernels at a given tile
# and block (tile_launch; in the hash source kind 0 is the linear kernel,
# 1 smoothstep, 2 the [L, 2, T] variant)
HASH_SOURCE = r"""
#include "hash_encode.cu"

namespace {

// HashLevels<false> reading the [L, 2, T] table as it is: two 4-byte
// reads a corner, T floats apart.
struct HashLevelsFeatureMajor {
    const float* __restrict__ table;
    int table_size;
    uint32_t mask;

    template <class Level>
    __device__ __forceinline__ float2 operator()(int l, const Level& L, float x,
                                                 float y, float z) const {
        const float p[3] = {x, y, z};
        const HashCell h = hash_cell<false, false>(p, L.res);
        const float* t0 = table + (size_t)l * 2 * table_size;
        const float* t1 = t0 + table_size;
        float a0 = 0.0f, a1 = 0.0f;
        for_hash_corners<false>(h, L.lookup, L.hashed, mask,
                                [&](uint32_t r, float w) {
            a0 = __fadd_rn(a0, __fmul_rn(__ldg(t0 + r), w));
            a1 = __fadd_rn(a1, __fmul_rn(__ldg(t1 + r), w));
        });
        return make_float2(a0, a1);
    }
};

__global__ void __launch_bounds__(TILE_THREADS)
feature_major_fwd_kernel(TileArgs a, HashLevelsFeatureMajor enc) {
    ray_encode_tile(a, enc);
}

}  // namespace

extern "C" int tile_launch(
        int kind, const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, const void* table, int size,
        const void* levels, int n_levels, void* out, int tile, int threads,
        void* stream) {
    const uint32_t mask = (uint32_t)size - 1u;
    if (kind == 2)
        return launch_ray_tile(feature_major_fwd_kernel,
                               HashLevelsFeatureMajor{(const float*)table, size,
                                                      mask},
                               nx, ny, nz, n_rays, n_samples, per_ray, levels,
                               n_levels, out, stream, tile, threads);
    if (kind == 1)
        return launch_ray_tile(hash_ray_fwd_kernel<true>,
                               HashLevels<true>{(const float2*)table, size, mask},
                               nx, ny, nz, n_rays, n_samples, per_ray, levels,
                               n_levels, out, stream, tile, threads);
    return launch_ray_tile(hash_ray_fwd_kernel<false>,
                           HashLevels<false>{(const float2*)table, size, mask},
                           nx, ny, nz, n_rays, n_samples, per_ray, levels,
                           n_levels, out, stream, tile, threads);
}

// the rays a tile and the threads a block the kernels' launcher picks
extern "C" int kernel_tile_shape(int n_samples, int per_ray, int n_levels,
                                 int* threads) {
    int smem;
    return tile_shape(n_samples, per_ray, n_levels, &smem, threads);
}
"""

BRICK_SOURCE = r"""
#include "brick_encode.cu"

extern "C" int tile_launch(
        int kind, const void* nx, const void* ny, const void* nz, int n_rays,
        int n_samples, int per_ray, const void* table, int size,
        const void* levels, int n_levels, void* out, int tile, int threads,
        void* stream) {
    return launch_ray_tile(brick_ray_fwd_kernel,
                           BrickLevels{(const __nv_bfloat16*)table, size},
                           nx, ny, nz, n_rays, n_samples, per_ray, levels,
                           n_levels, out, stream, tile, threads);
}
"""

BWD_SOURCE = r"""
#include "hash_encode.cu"

namespace {

// The level of global point g and the sample it reads: returns the level,
// sets ray and sample.
__device__ __forceinline__ int plan_point(long long g, const int* lv, int n_levels,
                                          int n_samples, long long& ray, int& s) {
    int l = 0;
    while (l + 1 < n_levels && g >= (long long)lv[(l + 1) * PLAN_COLS + 5]) ++l;
    const int k = lv[l * PLAN_COLS + 3], npts = lv[l * PLAN_COLS + 4];
    long long local = g - (long long)lv[l * PLAN_COLS + 5];
    ray = local / npts;
    int p = (int)(local - ray * npts);
    s = (k == 1) ? p : (p == npts - 1 ? n_samples - 1 : p * k);
    return l;
}

// the backward before the fused design: one thread per coarse point of the
// plan, its cotangents [P, 2] formed in PyTorch, 16 float atomics into the
// zeroed [L, 2, T] gradient
template <bool SMOOTH>
__global__ void __launch_bounds__(256)
parent_bwd_kernel(const float* __restrict__ nx, const float* __restrict__ ny,
                  const float* __restrict__ nz, int n_samples, int table_size,
                  const int* __restrict__ levels, int n_levels, long long total,
                  const float2* __restrict__ grad_out,
                  float* __restrict__ grad_table) {
    __shared__ int lv[PLAN_MAX_LEVELS * PLAN_COLS];
    load_plan(lv, levels, n_levels);
    const uint32_t mask = (uint32_t)table_size - 1u;
    for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         g < total; g += (long long)gridDim.x * blockDim.x) {
        const float2 go = grad_out[g];
        if (go.x == 0.0f && go.y == 0.0f) continue;
        long long ray;
        int s;
        const int l = plan_point(g, lv, n_levels, n_samples, ray, s);
        const long long si = ray * n_samples + s;
        const int* row = lv + l * PLAN_COLS;
        const float p[3] = {nx[si], ny[si], nz[si]};
        const HashCell h = hash_cell<SMOOTH, false>(p, row[0]);
        float* d0 = grad_table + (size_t)l * 2 * table_size;
        float* d1 = d0 + table_size;
        for_hash_corners<false>(h, row[1], row[2], mask,
                                [&](uint32_t r, float w) {
            const float c0 = __fmul_rn(go.x, w), c1 = __fmul_rn(go.y, w);
            if (c0 != 0.0f) atomicAdd(d0 + r, c0);
            if (c1 != 0.0f) atomicAdd(d1 + r, c1);
        });
    }
}

}  // namespace

extern "C" int parent_launch(
        int smooth, const void* nx, const void* ny, const void* nz,
        int n_samples, int table_size, const void* levels, int n_levels,
        long long total, const void* grad_out, void* grad_table,
        void* stream) {
    auto k = smooth ? parent_bwd_kernel<true> : parent_bwd_kernel<false>;
    k<<<plan_grid(total, 256), 256, 0, (cudaStream_t)stream>>>(
        (const float*)nx, (const float*)ny, (const float*)nz, n_samples,
        table_size, (const int*)levels, n_levels, total,
        (const float2*)grad_out, (float*)grad_table);
    return (int)cudaGetLastError();
}

extern "C" int variant_launch(
        int smooth, int pairs, const void* nx, const void* ny,
        const void* nz, int n_rays, int n_samples, int per_ray,
        int table_size, const void* levels, int n_levels, const void* grad,
        int shared_levels, int slab, void* scratch, void* out, void* stream) {
#define V(S, P) bwd_run<S, P>(nx, ny, nz, n_rays, n_samples, per_ray, \
    table_size, levels, n_levels, grad, (unsigned)shared_levels, slab, \
    scratch, out, stream)
    return smooth ? (pairs ? V(true, true) : V(true, false))
                  : (pairs ? V(false, true) : V(false, false));
#undef V
}
"""


def _build(name: str, source: str) -> ctypes.CDLL:
    from ..kernels import cuda
    heads = b"".join(p.read_bytes() for p in sorted(cuda.CSRC.glob("*.cu*")))
    digest = hashlib.sha256(source.encode() + heads).hexdigest()[:12]
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda.BUILD_DIR / f"encode_probe_{name}.{digest}.cu"
    so = cu.with_suffix(".so")
    if not so.exists():
        cu.write_text(source)
        subprocess.run([cuda._nvcc(), *cuda.ARCH_FLAGS, *cuda.BASE_FLAGS,
                        "-I", str(cuda.CSRC), "-o", str(so), str(cu)],
                       check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    if name == "bwd":
        P, I = cuda.P, cuda.I32
        lib.parent_launch.argtypes = [I, P, P, P, I, I, P, I, cuda.I64, P, P,
                                      P]
        lib.variant_launch.argtypes = [I, I, P, P, P, I, I, I, I, P, I, P, I,
                                       I, P, P, P]
        lib.parent_launch.restype = lib.variant_launch.restype = I
        return lib
    lib.tile_launch.argtypes = [cuda.I32, cuda.P, cuda.P, cuda.P, cuda.I32,
                                cuda.I32, cuda.I32, cuda.P, cuda.I32, cuda.P,
                                cuda.I32, cuda.P, cuda.I32, cuda.I32, cuda.P]
    lib.tile_launch.restype = cuda.I32
    if name == "hash":
        lib.kernel_tile_shape.argtypes = [cuda.I32, cuda.I32, cuda.I32,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.kernel_tile_shape.restype = cuda.I32
    return lib


def room_rays(n: int, device, seed: int = 0):
    """(o [3], unit directions [n, 3], wall hit t [n, 1]) from the smoke's
    off-centre camera in a cube room of half-extent 0.8."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=-1, keepdim=True)
    o = torch.tensor([0.5, 0.3, -0.2], device=device)
    t_hit = ((torch.sign(d) * 0.8 - o) / d).amin(-1, keepdim=True)
    return o, d, t_hit


def inputs(device) -> dict:
    """name -> (grid, strides, nx, ny, nz) of the probe's shapes."""
    from ..fields.ngp import NGPDensityFieldConfig
    from ..kernels import BrickGridConfig, HashGridConfig
    from ..kernels.hashgrid import level_strides
    n = 8192
    o, d, t_hit = room_rays(n, device)

    def near_wall(s):
        steps = torch.arange(s, 0, -1, device=device, dtype=torch.float32)
        return t_hit + 0.02 - 1e-3 * steps

    def ray_coords(t):
        p = (o + d[:, None, :] * t[..., None] + 1.0) / 2.0
        return [p[..., a].contiguous() for a in range(3)]

    out = {}
    for name, grid, s, stride1 in (
            ("hash_geo", HashGridConfig(), 128, False),
            ("brick_scene", BrickGridConfig(), 80, False),
            ("brick_prop_final", BrickGridConfig(), 64, True)):
        strides = ((1,) * grid.n_levels if stride1
                   else level_strides(grid, 5e-4, s))
        out[name] = (grid, strides, *ray_coords(near_wall(s)))
    t = torch.linspace(0.01, 2.0, 128, device=device).expand(n, 128)
    grid = NGPDensityFieldConfig(max_res=256).grid
    out["prop_points"] = (grid, (1,) * grid.n_levels,
                          *[a.reshape(-1, 1) for a in ray_coords(t)])
    gen = torch.Generator(device=device).manual_seed(3)
    u = torch.randn((32768, 3), generator=gen, device=device)
    u = u / u.norm(dim=-1, keepdim=True)
    e = torch.eye(3, device=device) / 4096
    x = torch.cat([u] + [u + sg * e[a] for a in range(3)
                         for sg in (1.0, -1.0)]) * 0.49 + 0.49
    grid = HashGridConfig.sphere_field(fine_res=4096)
    out["smooth_points"] = (grid, (1,) * grid.n_levels,
                            *[x[:, a:a + 1].contiguous() for a in range(3)])
    return out


def main() -> int:
    from ..kernels.brickgrid import brick_encode_ray_cuda
    from ..kernels.hashgrid import hash_encode_ray_cuda, ray_kernel_plan
    if not torch.cuda.is_available():
        print("encode_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {"hash": _build("hash", HASH_SOURCE),
            "brick": _build("brick", BRICK_SOURCE)}
    gen = torch.Generator(device=dev).manual_seed(1)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    for name, (grid, strides, nx, ny, nz) in inputs(dev).items():
        brick = grid.fused_field
        smooth = grid.interpolation == "smoothstep"
        table = (torch.rand(grid.table_shape, generator=gen, device=dev)
                 - 0.5) * 2e-2
        levels, per_ray = ray_kernel_plan(grid, strides, nx)
        n, s = nx.shape
        wrapper = brick_encode_ray_cuda if brick else hash_encode_ray_cuda
        ref = wrapper(table, nx, ny, nz, grid, strides)
        if brick:
            size, kind, lib = grid.n_bricks, 0, libs["brick"]
            arg_table = table.to(torch.bfloat16)
        else:
            size, kind, lib = grid.table_size, int(smooth), libs["hash"]
            arg_table = table.transpose(1, 2).contiguous()
        chunks = grid.n_levels if grid.n_levels % 2 else grid.n_levels // 2
        threads = ctypes.c_int()
        tile = libs["hash"].kernel_tile_shape(s, per_ray, grid.n_levels,
                                     ctypes.byref(threads))
        kernel_tile = (tile, threads.value)
        calls = {"kernel": lambda: wrapper(table, nx, ny, nz, grid, strides)}
        checks = {}

        def launcher(tile, threads, kind=kind, arg_table=arg_table, lib=lib):
            def call(out):
                check_rc(lib.tile_launch(
                    kind, nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), n, s,
                    per_ray, arg_table.data_ptr(), size, levels.data_ptr(),
                    grid.n_levels, out.data_ptr(), tile, threads, stream()),
                    name)
            return call

        if not brick and not smooth:
            out = torch.empty_like(ref)
            fm = launcher(*kernel_tile, kind=2, arg_table=table)
            calls["layout_feature_major"] = lambda fm=fm, out=out: fm(out)
            checks["layout_feature_major"] = (fm, out)
            calls["layout_copy_alone"] = \
                lambda: table.transpose(1, 2).contiguous()
        for target in (32, 64, 128, 256, 320):
            tile = max(1, target // s)
            for threads in (128, 256):
                threads = threads // chunks * chunks
                out = torch.empty_like(ref)
                fn = launcher(tile, threads)
                key = f"tile{tile}_t{threads}"
                if key in calls:
                    continue
                calls[key] = lambda fn=fn, out=out: fn(out)
                checks[key] = (fn, out)
        for key, (fn, out) in checks.items():
            fn(out)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"encode_probe: {key} differs ({name})",
                      file=sys.stderr)
                return 1
        times = {k: [] for k in calls}
        for _ in range(7):
            for k, fn in calls.items():
                times[k].append(timed(fn))
        result[name] = {"shape": [n, s], "strides": list(strides),
                        "points": per_ray * n,
                        "kernel_tile": list(kernel_tile),
                        "ms": {k: sorted(v)[3] for k, v in times.items()}}
        print(json.dumps({name: result[name]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0], "encodes": result}), flush=True)
    return 0


def backward_inputs(device) -> dict:
    """name -> (grid, strides, nx, ny, nz, cotangent [N, S, 2L]) of the
    backward's shapes: bf16-valued cotangents from a seed."""
    shapes = inputs(device)
    gen = torch.Generator(device=device).manual_seed(2)
    out = {}
    for name, key in (("hash_geo", "hash_geo"),
                      ("hash_geo_sparse", "hash_geo"),
                      ("prop_points", "prop_points"),
                      ("smooth_points", "smooth_points")):
        grid, strides, nx, ny, nz = shapes[key]
        n, s = nx.shape
        g = torch.randn((n, s, grid.out_dim), generator=gen, device=device)
        g = g.to(torch.bfloat16).float()
        if name.endswith("sparse"):
            keep = torch.randint(0, 33, (n, 1), generator=gen, device=device)
            g = g * (torch.arange(s, device=device) < keep)[..., None]
        out[name] = (grid, strides, nx, ny, nz, g.contiguous())
    return out


def backward_main() -> int:
    from ..kernels.hashgrid import (hash_encode_ray_bwd_cuda,
                                    hash_encode_ray_bwd_plain,
                                    lerp_levels_transpose, level_plan,
                                    ray_kernel_plan, shared_levels)
    if not torch.cuda.is_available():
        print("encode_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = _build("bwd", BWD_SOURCE)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    for name, (grid, strides, nx, ny, nz, g) in backward_inputs(dev).items():
        smooth = int(grid.interpolation == "smoothstep")
        n, s = nx.shape
        plan, total = level_plan(grid, strides, n, s)
        levels, per_ray = ray_kernel_plan(grid, strides, nx)
        shape = grid.table_shape
        ref = hash_encode_ray_bwd_plain(shape, nx, ny, nz, grid, strides, g)
        coarse = lerp_levels_transpose(g, plan, n, s, total)

        def parent(coarse=None):
            c = (lerp_levels_transpose(g, plan, n, s, total) if coarse is None
                 else coarse)
            out = torch.zeros(shape, device=dev)
            check_rc(lib.parent_launch(
                smooth, nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), s,
                grid.table_size, levels.data_ptr(), grid.n_levels, total,
                c.data_ptr(), out.data_ptr(), stream()), name)
            return out

        kernel_shared = shared_levels(plan, n)

        def variant(pairs, shared):
            slab = sum(grid.level_lookup(lvl)[1] ** 3 * 2 for lvl in shared)
            acc = torch.empty((grid.n_levels, grid.table_size, 2), device=dev)
            out = torch.empty(shape, device=dev)

            def call():
                check_rc(lib.variant_launch(
                    smooth, pairs, nx.data_ptr(), ny.data_ptr(),
                    nz.data_ptr(), n, s, per_ray, grid.table_size,
                    levels.data_ptr(), grid.n_levels, g.data_ptr(),
                    sum(1 << v for v in shared), slab, acc.data_ptr(),
                    out.data_ptr(), stream()), name)
                return out
            return call

        calls = {
            "parent": parent,
            "parent_kernel": lambda: parent(coarse),
            "glue": lambda: lerp_levels_transpose(g, plan, n, s, total),
            "kernel": lambda: hash_encode_ray_bwd_cuda(shape, nx, ny, nz,
                                                       grid, strides, g),
            # the kernel with its other PAIRS instance
            "pairs" if not smooth else "no_pairs":
                variant(1 - smooth, kernel_shared)}
        if kernel_shared:
            calls["no_shared"] = variant(smooth, ())
        elif not grid.level_hashed(0):
            calls["shared0"] = variant(smooth, (0,))
        rel = {}
        for key, fn in calls.items():
            if key == "glue":
                continue
            got = fn()
            torch.cuda.synchronize()
            rel[key] = ((got - ref).norm() / ref.norm()).item()
        again = hash_encode_ray_bwd_cuda(shape, nx, ny, nz, grid, strides, g)
        first = hash_encode_ray_bwd_cuda(shape, nx, ny, nz, grid, strides, g)
        rel["kernel_vs_kernel"] = ((again - first).norm()
                                   / first.norm()).item()
        bad = {k: v for k, v in rel.items() if not v <= 1e-5}
        if bad:
            print(f"encode_probe: {name}: {bad}", file=sys.stderr)
            return 1
        times = {k: [] for k in calls}
        for _ in range(7):
            for k, fn in calls.items():
                times[k].append(timed(fn))
        result[name] = {"shape": [n, s], "strides": list(strides),
                        "points": total,
                        "kernel_shared": list(kernel_shared),
                        "rel_norm": rel,
                        "ms": {k: sorted(v)[3] for k, v in times.items()},
                        "ms_spread": {k: [min(v), max(v)]
                                      for k, v in times.items()}}
        print(json.dumps({name: result[name]}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(json.dumps({"card": smi[0], "backward": result}), flush=True)
    return 0


def check_rc(rc: int, name: str):
    if rc:
        raise RuntimeError(f"encode_probe ({name}): cudaError {rc}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true",
                    help="probe the hash encode's backward")
    sys.exit(backward_main() if ap.parse_args().backward else main())
