"""The port's CUDA kernel wrappers.

Everywhere: a wrapper refuses tensors its kernel does not take before it
builds anything, and the plain path (CPU tensors) counts no launch.

On a CUDA GPU only (marker ``cuda``; skipped elsewhere): each kernel against
its plain version on the same inputs, at small and odd sizes, with a tiny
field that hashes some levels. This file imports no JAX, so it also runs on
a machine without it, without the JAX suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.fields import NGPFieldConfig, field_eval, field_eval_plain
from perf_tpu_torch.fields.ngp import field_eval_cuda
from perf_tpu_torch.kernels import BrickGridConfig, cuda
from perf_tpu_torch.render import (RenderConfig, SnapshotConfig,
                                   coarse_occ_grid, snapshot_render_cfg)
from perf_tpu_torch.render.renderer import (march_windows,
                                            march_windows_cuda,
                                            march_windows_plain)
from perf_tpu_torch.render.snapshot import (
    bake_corners, bake_scatter_pack, bake_scatter_pack_plain, bake_snapshot,
    composite_snapshot, composite_snapshot_cuda, composite_snapshot_plain)
from perf_tpu_torch.kernels.brickgrid import (
    BrickEncode, axis_split, brick_encode_ray, brick_encode_ray_cuda,
    brick_encode_ray_dedup_cuda, brick_encode_ray_plain, brick_index,
    brick_points_dedup_grad_cuda, brick_points_grad_cuda,
    brick_points_grad_plain, dedup_caps)
from perf_tpu_torch.kernels.hashgrid import (coarse_coords, level_plan,
                                             lerp_levels,
                                             lerp_levels_transpose)
from perf_tpu_torch.render.occgrid import (occ_grid_from_points,
                                           occ_grid_from_points_cuda,
                                           occ_grid_from_points_plain)
from perf_tpu_torch.render.renderer import (
    composite_lanes, count_occupied_windows, count_occupied_windows_cuda,
    count_occupied_windows_plain, shade_composite, shade_composite_cuda,
    shade_composite_grad_cuda, shade_composite_plain)
from perf_tpu_torch.core import bilinear_sample
from perf_tpu_torch.core.resample import (SORTED_MAX_SAMPLES,
                                          bilinear_sample_cuda,
                                          bilinear_sample_grad_cuda,
                                          bilinear_sample_plain)
from perf_tpu_torch.kernels.brickgrid import (
    brick_encode_grad_cuda, brick_encode_grad_grad_cuda,
    brick_encode_grad_grad_plain, brick_encode_grad_plain,
    brick_encode_stacked_grad)
from perf_tpu_torch.train.scene import (field_prune_occ,
                                        field_prune_occ_cuda,
                                        field_prune_occ_plain)
from perf_tpu_torch.kernels.gather import (onehot_gather, onehot_gather_cuda,
                                           take_gather, take_gather_cuda)
from perf_tpu_torch.render import prop as prop_k
from perf_tpu_torch.kernels.hashgrid import (
    HashGridConfig, HashEncode, hash_encode, hash_encode_grad,
    hash_encode_grad_cuda, hash_encode_grad_grad_cuda,
    hash_encode_grad_grad_plain, hash_encode_grad_plain, hash_encode_ray,
    hash_encode_ray_bwd_cuda, hash_encode_ray_bwd_plain, hash_encode_ray_cuda,
    hash_encode_ray_plain, level_strides, shared_levels)
from perf_tpu_torch.utils import (cube_room_occ_grid, random_field_params,
                                  render_cube_room_pano)
from perf_tpu_torch.data import Dataset
from perf_tpu_torch.fields import SphereFieldConfig
from perf_tpu_torch.fields.mlp import (APP_HEAD, GEO_HEAD, PROP_HEAD, NGPHead,
                                       bf16_grad_sums_f64, bf16_grads_within,
                                       bf16_head_reach, ngp_head_bwd_plain,
                                       ngp_head_plain)
from perf_tpu_torch.kernels.ngp_mlp import (ngp_head, ngp_mlp_bwd_cuda,
                                            ngp_mlp_fwd_cuda)
from perf_tpu_torch.priors import (FakeCubeRoomDepthPredictor,
                                   FakeCubeRoomNormalPredictor,
                                   PanoFusionConfig, PanoFusionInvPredictor,
                                   PanoFusionNormalPredictor, PanoGeoRefiner,
                                   RefinerConfig)

# 4 levels (res 8, 16, 32, 64), levels 2 and 3 hashed into 256 rows
TINY = NGPFieldConfig(grid=BrickGridConfig(n_levels=4, log2_bricks=8,
                                           base_res=8, per_level_scale=2.0))
# a 5-level smoothstep sphere grid (16 .. 256), every level hashed into 64
# rows
SPHERE = BrickGridConfig.sphere_field(fine_res=256, n_levels=5,
                                      log2_bricks=6)
# 6 hash levels (res 4 .. 41), levels 0 and 1 dense, 2-5 hashed into 1024
# rows
HASH = HashGridConfig(n_levels=6, log2_table_size=10, base_res=4,
                      per_level_scale=1.6)
# the sphere field's smoothstep hash grid at 4 levels (res 16 .. 64): level
# 0 dense (17^3 corners), 1-3 hashed into 8192 rows
HASH_SPHERE = HashGridConfig.sphere_field(fine_res=64, n_levels=4,
                                          log2_table_size=13)
RENDER = RenderConfig(step=4e-3, occ_res=64, march_coarse=12)
SNAP = SnapshotConfig(res=48, sample_stride=12, bake_chunk=4096)


# -- hard inputs of the brick encode's backward and of the resampler (the
# card tests below and tests/test_torch_encode_collisions.py) ---------------

BWD_CASES = ("one_brick", "voxel_runs", "boundaries", "zero_cotangents",
             "hash_alias", "stride1")


def aliased_bricks(grid: BrickGridConfig, level: int) -> tuple:
    """Two bricks of a hashed level whose rows coincide."""
    nb = grid.level_bricks(level)
    assert grid.level_hashed(level)
    b = torch.arange(nb ** 3)
    bx, by, bz = b // (nb * nb), (b // nb) % nb, b % nb
    rows = brick_index(bx, by, bz, nb, grid.n_bricks).numpy()
    _, first, counts = np.unique(rows, return_index=True, return_counts=True)
    i = int(first[np.argmax(counts > 1)])
    j = int(np.nonzero(rows == rows[i])[0][1])
    return tuple((int(bx[k]), int(by[k]), int(bz[k])) for k in (i, j))


def brick_bwd_case(name: str):
    """One hard input of the brick encode's backward on the TINY grid, from
    a seed: (x, y, z [N, S] float32 in about [0, 1], strides, point
    cotangents [points, 2] float32, sample cotangents [N, S, L * 2]
    float32). Samples are monotone along each ray."""
    grid = TINY.grid
    rng = np.random.default_rng(40 + BWD_CASES.index(name))
    fine = grid.level_res(grid.n_levels - 1)

    def rays_in(lo, hi, s):
        """One ray per row of lo / hi [N, 3]: s sorted samples per axis."""
        u = np.sort(rng.uniform(size=(lo.shape[0], s, 3)), axis=1)
        return lo[:, None] + (hi - lo)[:, None] * u

    # the cases share two plan shapes (one compile of each for JAX)
    if name in ("one_brick", "boundaries", "zero_cotangents"):
        n, s, strides = 16, 24, (2, 1, 1, 1)
    else:
        n, s, strides = 13, 31, (1, 1, 1, 1)
    if name == "one_brick":        # every ray inside one brick of the finest
        lo = np.full((n, 3), [15, 21, 27]) / fine + 1e-3
        pts = rays_in(lo, lo + 3.0 / fine - 2e-3, s)
    elif name == "voxel_runs":     # each ray inside one voxel of the finest
        lo = (rng.integers(0, fine, (n, 3)) + 0.1) / fine
        pts = rays_in(lo, lo + 0.8 / fine, s)
    elif name == "hash_alias":     # rays alternate between two aliased bricks
        a, b = aliased_bricks(grid, grid.n_levels - 1)
        lo = np.array([a if i % 2 == 0 else b for i in range(n)]) * 3.0 / fine
        pts = rays_in(lo + 1e-3, lo + 3.0 / fine - 1e-3, s)
    elif name == "stride1":        # scattered rays
        pts = np.sort(rng.uniform(-0.05, 1.05, (n, s, 3)), axis=1)
    else:                          # rays of samples 4e-3 apart
        o = rng.uniform(0.1, 0.9, (n, 1, 3))
        d = rng.standard_normal((n, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        pts = o + d * (4e-3 * np.arange(s))[None, :, None]
    x, y, z = (np.ascontiguousarray(pts[..., a], np.float32) for a in range(3))
    total = sum(s if k == 1 else s // k + 1 for k in strides) * n
    g = rng.standard_normal((total, 2)).astype(np.float32)
    gs = rng.standard_normal((n, s, 2 * grid.n_levels)).astype(np.float32)
    if name == "zero_cotangents":  # 40% of the points add nothing, 10% one
        r = rng.uniform(size=total)
        g[r < 0.4] = 0.0
        one = np.nonzero((r >= 0.4) & (r < 0.5))[0]
        g[one, rng.integers(0, 2, one.shape[0])] = 0.0
        gs[rng.uniform(size=(n, s)) < 0.4] = 0.0
    return x, y, z, strides, g, gs


def bilinear_case(c: int, padding: str, seed: int):
    """img [3, 37, 61, c] and coords [3, 4173, 2] reaching past the image on
    every side (4173 samples: no multiple of a block's), float32, from a
    seed; cotangents [3, 4173, c]."""
    rng = np.random.default_rng(seed + 7 * c + len(padding))
    img = rng.standard_normal((3, 37, 61, c)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, (3, 4173, 2)).astype(np.float32)
    cot = rng.standard_normal((3, 4173, c)).astype(np.float32)
    return img, coords, cot


# -- inputs of the NGP MLP kernels (the card tests below and
# tests/test_torch_mlp.py) ------------------------------------------------------

MLP_HEADS = (GEO_HEAD, APP_HEAD, PROP_HEAD)


def mlp_case(head: NGPHead, seed: int, m: int = 301, din: int | None = None):
    """(ws, x [m, din], sel [m], g [C, m]) as numpy float32 / bool: He-init
    weights, inputs N(0, 0.5), sel 80% true, cotangents N(0, 1); din 32 (10
    for the proposal head) unless given. With m >=
    8: row 0 is zero (every ReLU at 0) and the three rows with the largest
    first-channel raw output are scaled (the heads are bias-free ReLU
    networks, so raw scales with the input) to reach about 20 and 100
    inside the select and 100 outside it (the clamps at 15 and 80), the
    row with the smallest to about -30."""
    rng = np.random.default_rng(seed)
    din = din or (10 if head is PROP_HEAD else 32)
    dims = [din] + [64] * head.hidden + [head.channels]
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    x = rng.normal(0.0, 0.5, (m, din)).astype(np.float32)
    sel = rng.uniform(size=m) < 0.8
    g = rng.standard_normal((head.channels, m)).astype(np.float32)
    if m < 8:
        return ws, x, sel, g
    x[0] = 0.0
    raw = ngp_head_plain([torch.from_numpy(w) for w in ws],
                         torch.from_numpy(x), torch.ones(m, dtype=torch.bool),
                         head)[1][0].numpy()
    if (raw > 0.0).sum() < 3:     # a head whose first channel seldom rises
        ws[-1][:, 0] *= -1.0
        raw = -raw
    up = np.argsort(raw)[-3:]
    down = np.argsort(raw)[:1] if raw.min() < 0.0 else []
    for row, target in zip((*up, *down), (20.0, 100.0, 100.0, -30.0)):
        x[row] *= target / raw[row]
    sel[up[:2]] = True
    sel[up[2]] = False
    return ws, x, sel, g


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |v| (8 significant bits); 0 at 0."""
    a = np.abs(np.asarray(v, np.float64))
    safe = np.where(a > 0, a, 1.0)
    return np.where(a > 0, 2.0 ** (np.floor(np.log2(safe)) - 7), 0.0)


def bf16_ulps_apart(got, ref) -> np.ndarray:
    """|got - ref| in bf16 ulps of the larger magnitude (inf where one is 0
    and the other is not)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    ulp = bf16_ulp(np.maximum(np.abs(got), np.abs(ref)))
    d = np.abs(got - ref)
    return np.where(ulp > 0, d / np.where(ulp > 0, ulp, 1.0),
                    np.where(d > 0, np.inf, 0.0))


def is_bf16_valued(t) -> bool:
    t = torch.as_tensor(t)
    return torch.equal(t, t.to(torch.bfloat16).float())


FWD_CASES = ("tail", "point", "s48", "s80", "faces", "misaligned", "one")


def fwd_case(name: str, n_levels: int, device):
    """One hard input of the forward encodes, from a seed: (x, y, z [N, S]
    float32, strides). N is no multiple of a tile's rays (``one``: a single
    ray of 8 samples); strides run from 16 to 1 in one plan (all 1 in the
    point form, S = 1); ``faces`` puts samples exactly at 0 and 1 and
    beyond both faces; ``misaligned`` hands the kernel coordinates 4 bytes
    past a 16-byte boundary."""
    rng = np.random.default_rng(60 + FWD_CASES.index(name))
    n, s = {"point": (2049, 1), "s48": (129, 48), "s80": (37, 80),
            "one": (1, 8)}.get(name, (257, 32))
    strides = tuple(min(k, s) for k in (16, 1, 4, 2, 8, 1, 2, 16)[:n_levels])
    pts = np.sort(rng.uniform(-0.05, 1.05, (n, s, 3)), axis=1)
    if name == "faces":
        flat = pts.reshape(-1, 3)
        edge = np.array([0.0, 1.0, -0.25, 1.25, 0.5])
        flat[::7] = edge[rng.integers(0, 5, flat[::7].shape)]
    out = []
    for a in range(3):
        v = torch.from_numpy(np.ascontiguousarray(pts[..., a], np.float32))
        if name == "misaligned":
            buf = torch.empty(n * s + 5, device=device)
            view = buf[1:1 + n * s].view(n, s)
            view.copy_(v)
            assert view.data_ptr() % 16 == 4
            out.append(view)
        else:
            out.append(v.to(device))
    return (*out, strides)


def check_forward_and_grad(fn, plain, grad_kernel, grad_plain, name: str,
                           table, coords, grid, strides, tol: float,
                           seed: int, fused: bool = False):
    """The Function ``fn`` on the card against the plain composition
    ``plain`` (within ``tol``; 0.0: bitwise), one launch of the forward
    kernel ``name``; the table gradient through it against the plain
    backward ``grad_plain`` and against a second call of a backward kernel
    ``grad_kernel``: on the coarse cotangents that autograd of the plain
    lerp and concatenation gives (the brick's [P, 2] route, within 1e-6),
    or, ``fused``, on the features' cotangent (the hash backward, within
    HASH_BWD_TOL)."""
    x, y, z = coords
    n, s = x.shape
    t = table.clone().requires_grad_(True)
    before = cuda.counts()[name]
    got = fn(t, x, y, z, grid, strides)
    assert cuda.counts()[name] == before + 1
    ref = plain(table, x, y, z, grid, strides)
    if tol == 0.0:
        assert torch.equal(got, ref)
    else:
        assert (got - ref).abs().max().item() <= tol
    gen = torch.Generator(device=x.device).manual_seed(seed)
    g = torch.randn(got.shape, generator=gen, device=x.device)
    got.backward(g)
    plan, total = level_plan(grid, strides, n, s)
    leaf = torch.zeros((total, 2), device=x.device, requires_grad=True)
    (coarse,) = torch.autograd.grad(lerp_levels(leaf, plan, n, s), leaf, g)
    assert torch.equal(lerp_levels_transpose(g, plan, n, s, total), coarse)
    cs = [a.contiguous() for a in coords]
    cot, bwd_tol = (g, HASH_BWD_TOL) if fused else (coarse, 1e-6)
    # the same contributions; float atomics add them in an order that
    # changes from run to run
    for gt_ref in (grad_plain(table.shape, *cs, grid, strides, cot),
                   grad_kernel(table.shape, *cs, grid, strides, cot)):
        assert ((t.grad - gt_ref).norm() / gt_ref.norm()).item() <= bwd_tol


def _rays(n: int, seed: int, device):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def test_cuda_wrappers_refuse_cpu_tensors_before_building():
    params = params_from_jax(random_field_params(0, TINY))
    cfg = snapshot_render_cfg(RENDER, SNAP)
    occ = torch.zeros((64 ** 3,), dtype=torch.uint8)
    o, d = _rays(8, 0, "cpu")
    widx = torch.zeros((8, 2), dtype=torch.int32)
    table = torch.zeros((SNAP.n_bricks ** 3, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        field_eval_cuda(params, o, TINY)
    with pytest.raises(ValueError, match="CUDA"):
        march_windows_cuda(occ, o, d, cfg, coarse=coarse_occ_grid(occ, 64))
    with pytest.raises(ValueError, match="CUDA"):
        composite_snapshot_cuda(table, o, d, widx, widx.float(), TINY, cfg,
                                SNAP.res)
    with pytest.raises(ValueError, match="field_eval kernel takes"):
        field_eval_cuda(params, o, dataclasses.replace(TINY, n_neurons=32))
    x = torch.rand(4, 8)
    strides = (1,) * TINY.grid.n_levels
    with pytest.raises(ValueError, match="CUDA"):
        brick_encode_ray_cuda(params["geo"]["table"], x, x, x, TINY.grid,
                              strides)
    with pytest.raises(ValueError, match="CUDA"):
        brick_points_grad_cuda(params["geo"]["table"].shape, x, x, x,
                               TINY.grid, strides, torch.zeros(32 * 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        brick_encode_ray_dedup_cuda(params["geo"]["table"], x, x, x,
                                    TINY.grid, strides, (2, 2, 0, 3))
    with pytest.raises(ValueError, match="CUDA"):
        brick_points_dedup_grad_cuda(params["geo"]["table"].shape, x, x, x,
                                     TINY.grid, strides,
                                     torch.zeros(32 * 4, 2), (2, 2, 0, 3))
    with pytest.raises(ValueError, match="one cap >= 0 a level"):
        brick_encode_ray_dedup_cuda(params["geo"]["table"], x, x, x,
                                    TINY.grid, strides, (2, 2))
    with pytest.raises(ValueError, match="CUDA"):
        composite_snapshot_cuda(table, o, d, widx, widx.float(), TINY, cfg,
                                SNAP.res, dedup_k=1)
    # the dedup encode gives no position gradient
    with pytest.raises(ValueError, match="detach the coordinates"):
        brick_encode_ray(params["geo"]["table"], x.clone().requires_grad_(),
                         x, x, TINY.grid, strides, (2, 2, 0, 3))
    with pytest.raises(ValueError, match="CUDA"):
        count_occupied_windows_cuda(occ, o, d, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        shade_composite_cuda(x, x, x, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        shade_composite_grad_cuda(x, x, x, 0.01, x[:, :1], x[:, :1], x[:, 0])
    with pytest.raises(ValueError, match="CUDA"):
        occ_grid_from_points_cuda(o, 64)
    img = torch.zeros((2, 5, 7, 3))
    with pytest.raises(ValueError, match="CUDA"):
        bilinear_sample_cuda(img, torch.zeros((2, 4, 2)), "border")
    with pytest.raises(ValueError, match="CUDA"):
        bilinear_sample_grad_cuda(img.shape, torch.zeros((2, 4, 2)),
                                  "border", torch.zeros((2, 4, 3)))
    sp_table = torch.zeros((5, 64, 128))
    with pytest.raises(ValueError, match="CUDA"):
        brick_encode_grad_cuda(sp_table, o, SPHERE)
    with pytest.raises(ValueError, match="CUDA"):
        brick_encode_grad_grad_cuda(sp_table.shape, o, SPHERE,
                                    torch.zeros(8, 10), torch.zeros(8, 3, 10))
    linear = dataclasses.replace(SPHERE, interpolation="linear")
    with pytest.raises(ValueError, match="only smoothstep"):
        brick_encode_grad_cuda(sp_table, o, linear)
    with pytest.raises(ValueError, match="only smoothstep"):
        brick_encode_grad_plain(sp_table, o, linear)
    with pytest.raises(ValueError, match="CUDA"):
        field_prune_occ_cuda(params["geo"], TINY, occ, occ, 64,
                             torch.zeros((2, 8, 3)))
    h_table = torch.zeros(HASH.table_shape)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_ray_cuda(h_table, x, x, x, HASH, (1,) * 6)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_ray_bwd_cuda(h_table.shape, x, x, x, HASH, (1,) * 6,
                                 torch.zeros((4, 8, 12)))
    smooth = dataclasses.replace(HASH, interpolation="smoothstep")
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_ray_cuda(h_table, x, x, x, smooth, (1,) * 6)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_ray_bwd_cuda(h_table.shape, x, x, x, smooth, (1,) * 6,
                                 torch.zeros((4, 8, 12)))
    cubic = dataclasses.replace(HASH, interpolation="cubic")
    with pytest.raises(ValueError, match="only"):
        hash_encode_ray_cuda(h_table, x, x, x, cubic, (1,) * 6)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_grad_cuda(h_table, o, smooth)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode_grad_grad_cuda(h_table.shape, o, smooth,
                                   torch.zeros(8, 12), torch.zeros(8, 3, 12))
    with pytest.raises(ValueError, match="only"):
        hash_encode_grad_cuda(h_table, o, cubic)
    # the position-gradient kernels are built for smoothstep only
    with pytest.raises(ValueError, match="smoothstep"):
        hash_encode_grad_cuda(h_table, o, HASH)
    with pytest.raises(ValueError, match="smoothstep"):
        hash_encode_grad_grad_cuda(h_table.shape, o, HASH,
                                   torch.zeros(8, 12), torch.zeros(8, 3, 12))
    g_table = torch.zeros((4096, 128), dtype=torch.bfloat16)
    g_rows = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        take_gather_cuda(g_table, g_rows, 512)
    with pytest.raises(ValueError, match="CUDA"):
        onehot_gather_cuda(g_table, g_rows, 512)


def test_ngp_mlp_wrappers_refuse_cpu_tensors_and_other_heads():
    for head in MLP_HEADS:
        ws, x, sel, g = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else [torch.from_numpy(w) for w in a]
                         for a in mlp_case(head, 0, 9))
        with pytest.raises(ValueError, match="CUDA tensor"):
            ngp_mlp_fwd_cuda(ws, x, sel, head, save_raw=True)
        with pytest.raises(ValueError, match="CUDA tensor"):
            ngp_mlp_bwd_cuda(ws, x, sel, g, g, head)
    deep = NGPHead("geo", 2, 1, True, "trunc_exp")
    with pytest.raises(ValueError, match="no instance"):
        ngp_mlp_fwd_cuda(ws, x, sel, deep, save_raw=False)
    assert cuda.counts()["ngp_mlp"] == cuda.counts()["ngp_mlp_bwd"] == 0


# an nvcc -Xptxas -v log and a cuobjdump -sass listing of the kind the
# card's toolkit prints, for the parsers in tools/mlp_probe.py
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114mlp_bwd_kernelILi1EEEvPKfPKhS3_S3_xiS3_S3_S3_PfS6_i' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114mlp_bwd_kernelILi1EEEvPKfPKhS3_S3_xiS3_S3_S3_PfS6_i
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 222 registers, used 1 barriers, 0 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114mlp_fwd_kernelILi0EEEvPKfPKhxiS3_S3_S3_PfS6_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114mlp_fwd_kernelILi0EEEvPKfPKhxiS3_S3_S3_PfS6_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 82 registers, used 1 barriers, 5008 bytes smem, 440 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118mlp_f32_fwd_kernelEPKfPKhxiS2_S2_PfS5_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118mlp_f32_fwd_kernelEPKfPKhxiS2_S2_PfS5_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 111 registers, 4352 bytes smem, 424 bytes cmem[0]
"""
SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_114mlp_fwd_kernelILi0EEEvPKfPKhxiS3_S3_S3_PfS6_
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0350*/                   HMMA.16816.F32.BF16 R24, R4, R20, RZ ; /* 0x000000140418723c */
        /*0360*/              @!P0 HMMA.16816.F32.BF16 R28, R4, R22, R28 ;
        /*0370*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_118mlp_f32_fwd_kernelEPKfPKhxiS2_S2_PfS5_
        /*0010*/                   FFMA R1, R2, R3, R4 ;
        /*0020*/                   STS.128 [R2], R4 ;  // HMMA in a comment
"""


def test_build_log_and_sass_parsers():
    from perf_tpu_torch.tools.mlp_probe import ptxas_usage, sass_counts
    usage = ptxas_usage(PTXAS_LOG)
    assert len(usage) == 3
    bwd = usage["_ZN12_GLOBAL__N_114mlp_bwd_kernelILi1EEEvPKfPKhS3_S3_xiS3_S3_"
                "S3_PfS6_i"]
    assert bwd == {"stack_bytes": 24, "spill_stores": 0, "spill_loads": 0,
                   "registers": 222, "smem_bytes": 0}
    f32 = usage["_ZN12_GLOBAL__N_118mlp_f32_fwd_kernelEPKfPKhxiS2_S2_PfS5_"]
    assert (f32["registers"], f32["smem_bytes"], f32["spill_stores"]) == (
        111, 4352, 4)
    counts = sass_counts(SASS, "HMMA")
    assert counts == {
        "_ZN12_GLOBAL__N_114mlp_fwd_kernelILi0EEEvPKfPKhxiS3_S3_S3_PfS6_": 2,
        "_ZN12_GLOBAL__N_118mlp_f32_fwd_kernelEPKfPKhxiS2_S2_PfS5_": 0}
    assert sass_counts(SASS, "FFMA") == dict.fromkeys(counts, 1)


@pytest.mark.parametrize("backward", [False, True])
def test_ngp_mlp_kernel_symbols_name_one_instance_each(backward):
    """Each head's forward or backward kernel is told apart by a part of
    its mangled name that no other instance's holds."""
    from perf_tpu_torch.kernels.ngp_mlp import KERNEL_HEADS
    from perf_tpu_torch.tools.mlp_probe import kernel_symbol
    names = {"_ZN12_GLOBAL__N_114mlp_fwd_kernelILi0EEEvPKf",
             "_ZN12_GLOBAL__N_114mlp_fwd_kernelILi1EEEvPKf",
             "_ZN12_GLOBAL__N_118mlp_f32_fwd_kernelEPKf",
             "_ZN12_GLOBAL__N_114mlp_bwd_kernelILi0EEEvPKf",
             "_ZN12_GLOBAL__N_114mlp_bwd_kernelILi1EEEvPKf",
             "_ZN12_GLOBAL__N_118mlp_f32_bwd_kernelEPKf",
             "_ZN12_GLOBAL__N_122mlp_grad_reduce_kernelEPKf"}
    picked = set()
    for head in KERNEL_HEADS:
        found = [n for n in names if kernel_symbol(head, backward) in n]
        assert len(found) == 1
        picked.add(found[0])
    assert len(picked) == len(KERNEL_HEADS)


def test_non_wild_entry_points_never_fall_back_to_the_cpu(monkeypatch):
    """Without a visible GPU, a default-constructed refiner or fusion
    predictor raises rather than quietly running the plain versions on the
    CPU; asked for the CPU, it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: PanoGeoRefiner(**kw),
                 lambda **kw: PanoFusionInvPredictor(
                     FakeCubeRoomDepthPredictor(), **kw),
                 lambda **kw: PanoFusionNormalPredictor(
                     FakeCubeRoomNormalPredictor(), **kw)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            make()
        assert make(device="cpu").device.type == "cpu"


def test_bilinear_kernels_refuse_sizes_past_int32():
    from perf_tpu_torch.core.resample import _check_sizes
    _check_sizes(65535, 1024, 2048, 7, 2 ** 28 - 1)
    with pytest.raises(ValueError, match="an image in int32"):
        _check_sizes(1, 2 ** 16, 2 ** 15, 1, 16)
    with pytest.raises(ValueError, match="samples in int32"):
        _check_sizes(1, 8, 8, 3, 2 ** 31 // 3 + 1)
    with pytest.raises(ValueError, match="at most 65535 images"):
        _check_sizes(65536, 8, 8, 1, 16)


def test_shared_levels_are_the_dense_levels_within_the_budget():
    """The hash backward's host planner: dense levels only (the plan's
    hashed column, ``level_hashed``), each with SHARED_MIN_POINTS of the
    plan's points a row, their rows x 2 float32 within the budget; every
    dense level with points and bytes to spare."""
    from perf_tpu_torch.fields.ngp import NGPDensityFieldConfig
    from perf_tpu_torch.kernels.hashgrid import SHARED_MIN_POINTS
    ngp, sphere = HashGridConfig(), HashGridConfig.sphere_field(fine_res=4096)
    prop = NGPDensityFieldConfig(max_res=256).grid
    many = 1 << 26
    for grid in (ngp, NGPDensityFieldConfig().grid, prop, sphere, HASH,
                 HASH5, HASH_SPHERE):
        dense = tuple(lvl for lvl in range(grid.n_levels)
                      if not grid.level_hashed(lvl))
        for n, s, strides in ((many, 1, (1,) * grid.n_levels),
                              (8192, 128, level_strides(grid, 5e-4, 128)),
                              (2049, 1, (1,) * grid.n_levels)):
            plan, _ = level_plan(grid, strides, n, s)
            if n == many:
                assert shared_levels(plan, n, 1 << 40) == dense
            for budget in (0, 39303, 39304, 48 * 1024, 160 * 1024, 232448):
                got = shared_levels(plan, n, budget)
                rows = [plan[lvl][1] ** 3 for lvl in got]
                assert set(got) <= set(dense)
                assert sum(rows) * 8 <= budget
                assert all(n * plan[lvl][4] >= SHARED_MIN_POINTS * r
                           for lvl, r in zip(got, rows))
    # the NGP grid: level 0's 17^3 rows take 39,304 bytes, level 1's 24^3
    # 110,592
    plan = level_plan(ngp, (1,) * 16, many, 1)[0]
    assert shared_levels(plan, many, 39303) == ()
    assert shared_levels(plan, many, 48 * 1024) == (0,)
    assert shared_levels(plan, many, 160 * 1024) == (0, 1)
    # the smoke's shapes with the default budget: the hash geometry plan's
    # level 0 has 15 points a row (9 a ray at stride 16), the proposal
    # field's point form 213, the refiner's 47
    geo = level_plan(ngp, level_strides(ngp, 5e-4, 128), 8192, 128)[0]
    assert shared_levels(geo, 8192) == ()
    assert shared_levels(level_plan(prop, (1,) * 5, 1 << 20, 1)[0],
                         1 << 20) == (0,)
    assert shared_levels(level_plan(sphere, (1,) * 16, 229376, 1)[0],
                         229376) == (0,)


def test_plain_path_counts_no_launch():
    cuda.reset_counts()
    params = params_from_jax(random_field_params(0, TINY))
    occ = cube_room_occ_grid(64, 32, 64)
    table = bake_snapshot(params, TINY, occ, 64, SNAP)
    cfg = snapshot_render_cfg(RENDER, SNAP)
    o, d = _rays(64, 1, "cpu")
    widx, wvalid = march_windows(occ, o, d, cfg,
                                 coarse=coarse_occ_grid(occ, 64))[:2]
    composite_snapshot(table, o, d, widx, wvalid, TINY, cfg, SNAP.res)
    x = torch.rand(8, 16)
    t = params["geo"]["table"].clone().requires_grad_(True)
    BrickEncode.apply(t, x, x, x, TINY.grid, (2, 1, 1, 1)).sum().backward()
    # the K12 plain routes: the dedup encode with its backward, and the
    # snapshot composite with run candidates
    xs = torch.sort(x, dim=1).values
    brick_encode_ray(t, xs, xs, xs, TINY.grid, (2, 1, 1, 1),
                     (3, 2, 0, 4)).sum().backward()
    composite_snapshot(table, o, d, widx, wvalid, TINY, cfg, SNAP.res,
                       dedup_k=1)
    count_occupied_windows(occ, o, d, cfg)
    shade_composite(x.requires_grad_(True), x, torch.ones_like(x), 0.01)[1] \
        .sum().backward()
    occ_grid_from_points(o, 64)
    img = torch.rand((2, 5, 7, 3), requires_grad=True)
    bilinear_sample(img, torch.rand((2, 4, 2)), "wrap_x").sum().backward()
    t = torch.zeros((5, 64, 128), requires_grad=True)
    f, df = brick_encode_stacked_grad(t, torch.rand((6, 3)), SPHERE)
    (f.sum() + df.sum()).backward()
    field_prune_occ(params["geo"], TINY, occ, occ, 64, torch.rand((2, 64, 3)))
    t = torch.zeros(HASH.table_shape, requires_grad=True)
    HashEncode.apply(t, x, x, x, HASH, (2, 2, 1, 1, 1, 1)).sum().backward()
    hash_encode(t, torch.rand((5, 3)), HASH).sum().backward()
    t = torch.zeros(HASH_SPHERE.table_shape, requires_grad=True)
    hash_encode(t, torch.rand((5, 3)), HASH_SPHERE).sum().backward()
    f, df = hash_encode_grad(t, torch.rand((6, 3)), HASH_SPHERE)
    (f.sum() + df.sum()).backward()
    g_table = torch.zeros((4096, 128), dtype=torch.bfloat16)
    take_gather(g_table, torch.zeros(256, dtype=torch.int32), 128)
    onehot_gather(g_table, torch.zeros(256, dtype=torch.int32), 128)
    e = torch.sort(torch.rand((4, 9)), dim=1)[0]
    sig = torch.rand((4, 8), requires_grad=True)
    w = prop_k.weights_from_density(sig, e, override_last=True)
    new = prop_k.sample_from_weights(e, w, prop_k.linspace_u(4, 4))
    prop_k.prop_loss(new, prop_k.weights_from_density(sig[:, :4], new),
                     [{"edges": e, "weights": w}]).backward()
    for head in MLP_HEADS:
        ws, xm, selm, _ = mlp_case(head, 0, 9)
        ws = [torch.from_numpy(a).requires_grad_(True) for a in ws]
        ngp_head(ws, torch.from_numpy(xm).requires_grad_(True),
                 torch.from_numpy(selm), head).sum().backward()
    assert set(cuda.counts()) == {
        "field_eval", "bake_scatter_pack", "march_windows",
        "march_windows_stratified", "snapshot_composite", "brick_encode",
        "brick_encode_bwd",
        "count_windows", "shade_composite", "shade_composite_bwd",
        "occ_grid", "bilinear_sample", "bilinear_sample_bwd",
        "brick_encode_grad", "brick_encode_grad_bwd", "occ_prune",
        "hash_encode", "hash_encode_bwd", "take_gather", "onehot_gather",
        "hash_encode_smooth", "hash_encode_smooth_bwd", "hash_encode_grad",
        "hash_encode_grad_bwd", "prop_resample", "prop_weights",
        "prop_weights_bwd", "prop_loss", "prop_loss_bwd", "ngp_mlp",
        "ngp_mlp_bwd", "brick_encode_dedup", "brick_encode_dedup_bwd",
        "snapshot_composite_dedup"}
    assert all(v == 0 for v in cuda.counts().values())


def test_importing_the_anchor_slice_never_imports_jax():
    code = ("import sys, perf_tpu_torch.app.runner, perf_tpu_torch.priors, "
            "perf_tpu_torch.inpaint, perf_tpu_torch.pose, "
            "perf_tpu_torch.native, perf_tpu_torch.fields.sphere_field, "
            "perf_tpu_torch.core.resample, perf_tpu_torch.kernels.hashgrid, "
            "perf_tpu_torch.kernels.gather, "
            "perf_tpu_torch.tools.bench_pallas_encode, "
            "perf_tpu_torch.tools.bilinear_variants, "
            "perf_tpu_torch.tools.bilinear_spread, "
            "perf_tpu_torch.tools.bilinear_bwd_variants, "
            "perf_tpu_torch.tools.encode_probe, "
            "perf_tpu_torch.tools.mlp_probe, perf_tpu_torch.kernels.ngp_mlp, "
            "perf_tpu_torch.tools.composite_probe, "
            "perf_tpu_torch.priors.pano_refiner, "
            "perf_tpu_torch.priors.pano_fusion, perf_tpu_torch.data.dataset; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'perf_tpu.', 'flax', 'optax')) "
            "or m == 'perf_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__))))


# -- on the card -----------------------------------------------------------------

@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = params_from_jax(random_field_params(0, TINY), dev)
    occ = cube_room_occ_grid(64, 32, 64, device=dev)
    return dev, params, occ


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1037])
def test_field_eval_kernel_matches_plain(gpu, n):
    dev, params, _ = gpu
    rng = np.random.default_rng(n)
    xyz = torch.from_numpy(rng.uniform(-1.1, 1.1, (n, 3)).astype(
        np.float32)).to(dev)
    before = cuda.counts()["field_eval"]
    got = field_eval(params, xyz, TINY)
    assert cuda.counts()["field_eval"] == before + 1
    ref = field_eval_plain(params, xyz, TINY)
    err, scale = (got - ref).abs(), ref.abs()
    # same bf16 rounding points, float32 sums in another order: ~1e-6
    # relative, up to a few percent where a hidden unit sits on a bf16 tie
    assert (err > 1e-4 * scale + 1e-6).float().mean().item() <= 5e-3
    assert bool((err <= 0.05 * scale + 1e-6).all())
    assert bool((got[:, 0] == 0).eq(ref[:, 0] == 0).all())   # AABB select


@pytest.mark.cuda
def test_bake_scatter_pack_kernel_equals_plain(gpu):
    dev, params, occ = gpu
    idx = bake_corners(occ, 64, SNAP.res)
    vals = torch.randn((idx.shape[0], 4), generator=torch.Generator()
                       .manual_seed(2)).to(dev)
    shape = (SNAP.n_bricks ** 3, 256)
    got = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
    ref = torch.zeros_like(got)
    bake_scatter_pack(got, idx, vals, SNAP.res)
    bake_scatter_pack_plain(ref, idx, vals, SNAP.res)
    assert torch.equal(got, ref)            # the same bf16 values, bitwise


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [None, 4])
def test_march_and_composite_kernels_match_plain(gpu, budget):
    dev, params, occ = gpu
    cfg = snapshot_render_cfg(RENDER, SNAP)
    if budget:
        cfg = dataclasses.replace(cfg, max_samples=budget)
    o, d = _rays(3001, 3, dev)
    coarse = coarse_occ_grid(occ, 64)
    got = march_windows(occ, o, d, cfg, coarse=coarse)
    ref = march_windows_plain(occ, o, d, cfg, coarse=coarse)
    seg = (ref[3].contiguous(), ref[4].contiguous())
    planned = march_windows(occ, o, d, cfg, segments=seg)
    for a in (got, planned):
        # integers: exactly equal where valid; padding carries weight 0
        valid = ref[1] > 0
        assert torch.equal(a[1] > 0, valid) and torch.equal(a[2], ref[2])
        assert torch.equal(torch.where(valid, a[0], -1),
                           torch.where(valid, ref[0], -1))
    assert torch.equal(torch.where(ref[4], got[3], -1),
                       torch.where(ref[4], ref[3], -1))
    assert int(ref[2].max()) > 0

    table = bake_snapshot(params, TINY, occ, 64, SNAP)
    args = (table, o, d, got[0], got[1], TINY, cfg, SNAP.res)
    out, want = composite_snapshot(*args), composite_snapshot_plain(*args)
    # same rows and samples; float32 sums and the scan in another order
    for k, tol in (("rgb", 2e-5), ("opacity", 2e-5), ("distance", 1e-4)):
        assert (out[k] - want[k]).abs().max().item() <= tol, k


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_CASES)
def test_brick_encode_kernels_match_plain(gpu, case):
    """The forward writes the lerped, level-concatenated features: the same
    8 bf16 corners a coarse point, summed in another order (float32
    rounding), and the same lerp; the gradient through ``BrickEncode``
    equals the [P, 2] route's."""
    dev, params, _ = gpu
    *coords, strides = fwd_case(case, TINY.grid.n_levels, dev)
    check_forward_and_grad(
        brick_encode_ray, brick_encode_ray_plain, brick_points_grad_cuda,
        brick_points_grad_plain, "brick_encode", params["geo"]["table"],
        coords, TINY.grid, strides, 1e-6, FWD_CASES.index(case))


@pytest.mark.cuda
@pytest.mark.parametrize("budget", [16, 32])
def test_stratified_march_and_count_kernels_equal_plain(gpu, budget):
    dev, _, occ = gpu
    cfg = RenderConfig(step=4e-3, occ_res=64, march_coarse=8,
                       max_samples=budget, sample_stride=2)
    o, d = _rays(3001, 4, dev)
    jitter = torch.rand((3001, 1), generator=torch.Generator().manual_seed(
        budget)).to(dev)
    coarse = coarse_occ_grid(occ, 64)
    before = cuda.counts()
    got = march_windows(occ, o, d, cfg, coarse, jitter=jitter)
    after = cuda.counts()
    # the stratified form is counted apart from the eval form
    assert after["march_windows_stratified"] == (
        before["march_windows_stratified"] + 1)
    assert after["march_windows"] == before["march_windows"]
    ref = march_windows_plain(occ, o, d, cfg, coarse, jitter=jitter)
    # integers, every slot (invalid ones too: top_k's tie order)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert int(ref[2].max()) > 0
    assert torch.equal(count_occupied_windows(occ, o, d, cfg),
                       count_occupied_windows_plain(occ, o, d, cfg))


def shade_case(n: int, s: int, seed: int) -> tuple:
    """sigma, t_mid, valid [n, s] float32 and three cotangents: a run of
    valid samples at a random place, densities from clear to opaque; rows
    0-1 entirely invalid, rows 2-3 saturated from their first sample on
    (tau up to 1e3, where T underflows to 0)."""
    rng = np.random.default_rng(seed)
    start, length = rng.integers(0, s, n), rng.integers(1, s + 1, n)
    idx = np.arange(s)[None, :]
    valid = ((idx >= start[:, None]) & (idx < (start + length)[:, None])
             & (rng.uniform(size=(n, s)) < 0.9)).astype(np.float32)
    valid[:2] = 0.0
    valid[2:4, 0] = 1.0
    tau = rng.exponential(1.0, (n, s)) * 10.0 ** rng.uniform(-3, 0.5, (n, 1))
    tau[2:4] = rng.uniform(100.0, 1e3, (2, s))
    sig = (tau / 1e-3 * valid).astype(np.float32)
    t_mid = np.sort(rng.uniform(0.05, 1.5, (n, s)), 1).astype(np.float32)
    cots = [rng.normal(size=sh).astype(np.float32)
            for sh in ((n, 1), (n, 1), (n,))]
    return sig, t_mid, valid, cots


@pytest.mark.cuda
@pytest.mark.parametrize("s", (1, 17, 80, 256))
def test_shade_composite_kernels_match_plain(gpu, s):
    """A group of lanes a ray; 1037 rays fill no block evenly (4, 8 or 16
    rays a block)."""
    dev = gpu[0]
    n = 1037
    sig, t_mid, valid, cots = shade_case(n, s, 7 + s)
    cots = [torch.from_numpy(c).to(dev) for c in cots]
    outs, grads = [], []
    for fn in (shade_composite, shade_composite_plain):
        st = torch.from_numpy(sig).to(dev).requires_grad_(True)
        w, op, dist, dl = fn(st, torch.from_numpy(t_mid).to(dev),
                             torch.from_numpy(valid).to(dev), 1e-3)
        ((op * cots[0]).sum() + (dist * cots[1]).sum()
         + (dl * cots[2]).sum()).backward()
        outs.append((w.detach(), op.detach(), dist.detach(), dl.detach()))
        grads.append(st.grad)
    # float32 lane runs and shuffle scans vs PyTorch's cumsum / sum order
    for a, b in zip(*outs):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5 * max(1.0, b.abs().max())
    assert torch.isfinite(grads[0]).all()
    err = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert err.item() <= 1e-5
    # no atomics: a second launch repeats dsigma bitwise
    args = [torch.from_numpy(a).to(dev) for a in (sig, t_mid, valid)]
    again = shade_composite_grad_cuda(*args, 1e-3, *cots)
    assert torch.equal(again, grads[0])


@pytest.mark.cuda
@pytest.mark.parametrize("s", (600, 1001))
def test_shade_composite_kernels_in_chunks(gpu, s):
    """Rows longer than a group's G R (the plan's 32 lanes of 8 samples: 3
    and 4 chunks), so the carries go from chunk to chunk and the
    backward's through shared memory; 16-byte loads at 600 samples, scalar
    loads at 1001."""
    dev = gpu[0]
    assert composite_lanes(s) == (32, 8)
    *arrays, cots = shade_case(45, s, 11)
    sig, t_mid, valid, *cots = (torch.from_numpy(a).to(dev)
                                for a in arrays + cots)
    got = shade_composite_cuda(sig, t_mid, valid, 1e-3)
    st = sig.clone().requires_grad_(True)
    want = shade_composite_plain(st, t_mid, valid, 1e-3)
    for a, b in zip(got, want):
        assert (a - b.detach()).abs().max().item() <= 1e-5 * max(
            1.0, b.abs().max())
    lin = sum((o * c).sum() for o, c in zip(want[1:], cots))
    (ref,) = torch.autograd.grad(lin, st)
    ds = shade_composite_grad_cuda(sig, t_mid, valid, 1e-3, *cots)
    assert ((ds - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_occ_grid_kernel_is_bitwise_plain(gpu):
    dev = gpu[0]
    rng = np.random.default_rng(8)
    pts = torch.from_numpy(rng.uniform(-1.05, 1.05, (20011, 3)).astype(
        np.float32)).to(dev)
    for dil in (0, 1):
        got = occ_grid_from_points(pts, 64, dil)
        assert torch.equal(got, occ_grid_from_points_plain(pts, 64, dil))
        assert int(got.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["border", "wrap_x", "zeros"])
@pytest.mark.parametrize("c", [1, 2, 3, 7, 5, "2 misaligned"])
def test_bilinear_kernels_match_plain(gpu, c, padding):
    """The forward bitwise and the backward within 1e-6 at every channel
    count the main path passes (1, 2, 3, 7), one the generic instantiation
    takes (5), and C = 2 on an image and coords that are not 8-byte
    aligned; B > 1, a sample count no block divides, coords past the
    image. The backward's fixed-point route at every sample, its sorted
    route at the first SORTED_MAX_SAMPLES samples of each image (the most
    it takes)."""
    dev = gpu[0]
    nc = 2 if c == "2 misaligned" else c
    img_np, coords_np, cot_np = bilinear_case(nc, padding, 11)
    img = torch.from_numpy(img_np).to(dev)
    coords = torch.from_numpy(coords_np).to(dev)
    if c == "2 misaligned":
        def shifted(t):
            store = torch.empty(t.numel() + 1, device=dev)
            out = store[1:].view(t.shape)
            out.copy_(t)
            assert out.data_ptr() % 8 == 4
            return out
        img, coords = shifted(img), shifted(coords)
    before = cuda.counts()["bilinear_sample"]
    got = bilinear_sample_cuda(img, coords, padding)
    assert cuda.counts()["bilinear_sample"] == before + 1
    ref = bilinear_sample_plain(img, coords, padding)
    # the same taps, products and sums in JAX's order: bitwise
    assert torch.equal(got, ref)
    cot = torch.from_numpy(cot_np).to(dev)
    for route, m in (("fixed_point", coords.shape[1]),
                     ("sorted", SORTED_MAX_SAMPLES)):
        co_r, cot_r = coords[:, :m], cot[:, :m].contiguous()
        if m < coords.shape[1]:
            co_r = co_r.contiguous()
        gi = bilinear_sample_grad_cuda(tuple(img.shape), co_r, padding,
                                       cot_r, route)
        leaf = img.clone().requires_grad_(True)
        (gi_ref,) = torch.autograd.grad(bilinear_sample_plain(
            leaf, co_r, padding), leaf, cot_r)
        # the same products: the kernel sums them in fixed point and rounds
        # once, or sorts them by pixel and sums each pixel's in float64 a
        # chunk of 256 samples, autograd with float atomics in an order
        # that changes (on an H100 its own spread read up to 3.05e-7 over
        # 200 launches, perf_tpu_torch/tools/bilinear_spread.py)
        assert ((gi - gi_ref).abs().max()
                / gi_ref.abs().max()).item() <= 1e-6, route
        # neither route's sums depend on the order of its threads
        assert torch.equal(bilinear_sample_grad_cuda(
            tuple(img.shape), co_r, padding, cot_r, route), gi), route


@pytest.mark.cuda
@pytest.mark.parametrize("padding", ["border", "wrap_x"])
def test_bilinear_sample_entry_point_launches_both_kernels(gpu, padding):
    """``bilinear_sample`` on card tensors (a batch, coords [B, ..., 2], an
    image that is not 8-byte aligned) launches the forward and, under
    autograd, the backward kernel once each, with the kernels' results."""
    dev = gpu[0]
    img_np, coords_np, cot_np = bilinear_case(2, padding, 12)
    store = torch.empty(img_np.size + 1, device=dev)
    img = store[1:].view(img_np.shape)
    img.copy_(torch.from_numpy(img_np))
    assert img.data_ptr() % 8 == 4
    img.requires_grad_(True)
    coords = torch.from_numpy(coords_np).to(dev)
    cot = torch.from_numpy(cot_np).to(dev)
    b, m = coords.shape[:2]
    before = cuda.counts()
    out = bilinear_sample(img, coords.view(b, 1, m, 2), padding)
    (out * cot.view(out.shape)).sum().backward()
    after = cuda.counts()
    assert after["bilinear_sample"] == before["bilinear_sample"] + 1
    assert after["bilinear_sample_bwd"] == before["bilinear_sample_bwd"] + 1
    assert torch.equal(out.view(b, m, -1),
                       bilinear_sample_plain(img.detach(), coords, padding))
    gi_ref = bilinear_sample_grad_cuda(tuple(img.shape), coords, padding,
                                       cot)
    assert ((img.grad - gi_ref).abs().max() / gi_ref.abs().max()).item() \
        <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CASES)
def test_brick_encode_bwd_kernel_matches_plain_on_hard_plans(gpu, case):
    """Long runs of one key (points of many rays in one brick, a ray's
    samples in one voxel), ray and level boundaries inside a warp, zero
    cotangents among non-zero ones, two bricks the hash puts in one row,
    an all-stride-1 plan, totals no multiple of 32."""
    dev = gpu[0]
    x, y, z, strides, g, _ = brick_bwd_case(case)
    x, y, z, g = (torch.from_numpy(a).to(dev) for a in (x, y, z, g))
    shape = TINY.grid.table_shape
    before = cuda.counts()["brick_encode_bwd"]
    gt = brick_points_grad_cuda(shape, x, y, z, TINY.grid, strides, g)
    assert cuda.counts()["brick_encode_bwd"] == before + 1
    ref = brick_points_grad_plain(shape, x, y, z, TINY.grid, strides, g)
    assert ref.norm().item() > 0
    # the same bf16-rounded contributions, summed in float32 in another
    # order (per group of equal corners, then by float atomics)
    assert ((gt - ref).norm() / ref.norm()).item() <= 1e-6


# -- the run-dedup encode and composite (K12) -----------------------------------

DEDUP_CASES = ("one_run", "over_cap", "hashed", "misaligned_tail")


def ray_runs(x, y, z, grid, strides) -> list:
    """Per level, the most brick runs (changes of the encode's row, hashed
    where the level hashes, + 1) of any ray's coarse points."""
    out = []
    for lvl, k in enumerate(strides):
        res, nb = grid.level_res(lvl), grid.level_bricks(lvl)
        b = [axis_split(coarse_coords(a, k), res)[0] for a in (x, y, z)]
        rows = brick_index(*b, nb, grid.n_bricks)
        out.append(int(((rows[:, 1:] != rows[:, :-1]).sum(1) + 1).max()))
    return out


def dedup_case(name: str, device):
    """One hard input of the dedup encode on the TINY grid (levels 2 and 3
    hashed): (x, y, z [N, S], strides, caps). ``one_run``: every ray's
    points in one brick of every level; ``over_cap``: rays across the cube
    with more runs than every cap (cap 1 on one level: every point reads
    the first point's row); ``hashed``: caps on the hashed levels only, 80
    samples a ray (warp walks of 32 + 32 + 16 points); ``misaligned_tail``:
    257 rays (no multiple of a tile), coordinates 4 bytes past a 16-byte
    boundary."""
    if name == "one_run":
        rng = np.random.default_rng(90)
        n, s = 37, 48
        lo = np.array([0.503, 0.497, 0.51])
        pts = lo + np.sort(rng.uniform(0.0, 4e-3, (n, s, 3)), axis=1)
        x, y, z = (torch.from_numpy(np.ascontiguousarray(
            pts[..., a], np.float32)).to(device) for a in range(3))
        return x, y, z, (1, 2, 1, 4), (2, 2, 3, 2)
    base = {"over_cap": "tail", "hashed": "s80",
            "misaligned_tail": "misaligned"}[name]
    x, y, z, strides = fwd_case(base, TINY.grid.n_levels, device)
    caps = {"over_cap": (2, 3, 5, 1), "hashed": (0, 0, 7, 9),
            "misaligned_tail": (2, 20, 4, 6)}[name]
    return x, y, z, strides, caps


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEDUP_CASES)
def test_brick_encode_dedup_kernels_match_plain(gpu, case):
    """The dedup forward against its plain version within K1's forward's
    1e-6 (the same rows and corners, float32 sums in another order), one
    launch; the dedup backward against a second launch within 1e-6
    relative norm (each run summed in its points' order, rounded twice;
    float atomics across rays) and against its plain version within 1e-5
    (``index_add_`` on the card sums a run in any order: at most 0.1% of
    the entries may move by a second rounding on a tie, each by at most
    one bf16 ulp of its |g| sum); the gradient through ``BrickEncode`` is
    the dedup backward's."""
    dev, params, _ = gpu
    x, y, z, strides, caps = dedup_case(case, dev)
    grid = TINY.grid
    n, s = x.shape
    assert dedup_caps(strides, s, caps) == caps
    runs = ray_runs(*(a.cpu() for a in (x, y, z)), grid, strides)
    if case == "one_run":
        assert runs == [1] * grid.n_levels
    if case == "over_cap":
        assert all(r > c for r, c in zip(runs, caps))
    table = params["geo"]["table"]
    t = table.clone().requires_grad_(True)
    before = cuda.counts()
    got = brick_encode_ray(t, x, y, z, grid, strides, caps)
    after = cuda.counts()
    assert after["brick_encode_dedup"] == before["brick_encode_dedup"] + 1
    assert after["brick_encode"] == before["brick_encode"]
    ref = brick_encode_ray_plain(table, x, y, z, grid, strides, caps)
    err = (got - ref).abs().max().item()
    print(f"{case}: forward max abs err {err:.3g}")
    assert err <= 1e-6
    gen = torch.Generator(device=dev).manual_seed(DEDUP_CASES.index(case))
    g = torch.randn(got.shape, generator=gen, device=dev)
    got.backward(g)
    assert cuda.counts()["brick_encode_dedup_bwd"] == \
        before["brick_encode_dedup_bwd"] + 1
    plan, total = level_plan(grid, strides, n, s)
    cot = lerp_levels_transpose(g, plan, n, s, total)
    cs = [a.contiguous() for a in (x, y, z)]
    want = brick_points_grad_plain(table.shape, *cs, grid, strides, cot, caps)
    again = brick_points_dedup_grad_cuda(table.shape, *cs, grid, strides,
                                         cot, caps)
    g_abs = brick_points_grad_plain(table.shape, *cs, grid, strides,
                                    cot.abs(), caps).double()
    assert want.norm().item() > 0
    for name, gt, bar in (("plain", want, 1e-5), ("rerun", again, 1e-6)):
        rel = ((t.grad - gt).norm() / gt.norm()).item()
        diff = (t.grad - gt).abs().double()
        ulp = torch.exp2(torch.floor(torch.log2(g_abs.clamp_min(1e-38))) - 7)
        moved = (diff > 1e-6 * g_abs).double().mean().item()
        print(f"{case}: backward vs {name}: relative norm {rel:.3g}, "
              f"{moved:.3g} of the entries moved")
        assert rel <= bar and moved <= 1e-3
        assert bool((diff <= ulp + 1e-6 * g_abs).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("over_cap", "hashed", "misaligned_tail"))
def test_brick_encode_dedup_with_covering_caps_equals_k1_bitwise(gpu, case):
    """Caps that cover every run of every ray (and stay below the point
    counts): the dedup forward reads every point's own row, so it equals
    the standard forward bitwise."""
    dev, params, _ = gpu
    x, y, z, strides, _ = dedup_case(case, dev)
    s = x.shape[1]
    runs = ray_runs(*(a.cpu() for a in (x, y, z)), TINY.grid, strides)
    caps = dedup_caps(strides, s, tuple(runs))
    assert caps is not None
    table = params["geo"]["table"]
    assert torch.equal(
        brick_encode_ray_dedup_cuda(table, x, y, z, TINY.grid, strides, caps),
        brick_encode_ray_cuda(table, x, y, z, TINY.grid, strides))


@pytest.mark.cuda
@pytest.mark.parametrize("k_runs", [1, 3, 8, "cover"])
def test_snapshot_composite_dedup_kernel_matches_plain(gpu, k_runs):
    """The dedup composite against its plain version at the standard
    composite's tolerances, one launch of the dedup instance; K that covers
    every run of every ray (padding slots included) gives the standard
    kernel's values bitwise."""
    from perf_tpu_torch.render.renderer import windows_to_samples
    from perf_tpu_torch.render.snapshot import snapshot_rows
    dev, params, occ = gpu
    cfg = snapshot_render_cfg(RENDER, SNAP)
    o, d = _rays(3001, 5, dev)
    widx, wvalid = march_windows(occ, o, d, cfg,
                                 coarse=coarse_occ_grid(occ, 64))[:2]
    table = bake_snapshot(params, TINY, occ, 64, SNAP)
    t_mid, _ = windows_to_samples(widx, wvalid, cfg)
    rows = snapshot_rows(o, d, t_mid, TINY, SNAP.res)
    runs = int(((rows[:, 1:] != rows[:, :-1]).sum(1) + 1).max())
    k = runs if k_runs == "cover" else k_runs
    assert k < t_mid.shape[1]
    args = (table, o, d, widx, wvalid, TINY, cfg, SNAP.res)
    before = cuda.counts()["snapshot_composite_dedup"]
    out = composite_snapshot(*args, dedup_k=k)
    assert cuda.counts()["snapshot_composite_dedup"] == before + 1
    want = composite_snapshot_plain(*args, dedup_k=k)
    for key, tol in (("rgb", 2e-5), ("opacity", 2e-5), ("distance", 1e-4)):
        assert (out[key] - want[key]).abs().max().item() <= tol, key
    std = composite_snapshot(*args)
    if k_runs == "cover":
        assert all(torch.equal(out[key], std[key]) for key in out)
    elif k_runs == 1:
        assert not torch.equal(out["opacity"], std["opacity"])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2049])
def test_brick_encode_grad_kernels_match_plain(gpu, n):
    dev = gpu[0]
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.normal(0, 0.1, (5, 64, 128)).astype(
        np.float32)).to(dev)
    d = rng.normal(size=(n, 3))
    x = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)
                          * 0.49 + 0.49).astype(np.float32)).to(dev)
    before = cuda.counts()["brick_encode_grad"]
    f, df = brick_encode_grad_cuda(table, x, SPHERE)
    assert cuda.counts()["brick_encode_grad"] == before + 1
    f_ref, df_ref = brick_encode_grad_plain(table, x, SPHERE)
    # the same 8 bf16 corners and weights; float32 sums in another order
    assert (f - f_ref).abs().max().item() <= 1e-6
    assert ((df - df_ref).abs().max() / df_ref.abs().max()).item() <= 1e-6
    gf = torch.from_numpy(rng.normal(size=tuple(f.shape)).astype(
        np.float32)).to(dev)
    gd = torch.from_numpy(rng.normal(size=tuple(df.shape)).astype(
        np.float32)).to(dev)
    gt = brick_encode_grad_grad_cuda(table.shape, x, SPHERE, gf, gd)
    gt_ref = brick_encode_grad_grad_plain(table.shape, x, SPHERE, gf, gd)
    # the same bf16-rounded combined rows (a row whose float32 sum lands
    # on a bf16 tie may round the other way); float atomics reorder sums
    assert ((gt - gt_ref).norm() / gt_ref.norm()).item() <= 1e-5


@pytest.mark.cuda
def test_occ_prune_kernel_matches_plain(gpu):
    dev, _, occ = gpu
    params = params_from_jax(random_field_params(0, TINY, density_gain=0.9),
                             dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    prev = occ * (torch.rand(occ.shape, generator=gen, device=dev) > 0.1)
    jitter = torch.rand((2, 5000, 3), generator=gen, device=dev)
    before = cuda.counts()["occ_prune"]
    got = field_prune_occ(params["geo"], TINY, occ, prev.to(torch.uint8), 64,
                          jitter)
    assert cuda.counts()["occ_prune"] == before + 1
    ref = field_prune_occ_plain(params["geo"], TINY, occ,
                                prev.to(torch.uint8), 64, jitter)
    # the same densities but for bf16 ties in the MLP's hidden units: only
    # a voxel at the threshold may flip
    assert int((got != ref).sum()) <= 2
    shell = (occ != 0) & (prev != 0)
    assert 0 < int((ref[shell] == 0).sum()) < int(shell.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("block", [512, 1024])
def test_row_gather_kernels_equal_plain_bitwise(gpu, block):
    dev = gpu[0]
    rng = np.random.default_rng(block)
    table = torch.from_numpy(rng.standard_normal((4096, 128)).astype(
        np.float32)).to(torch.bfloat16).to(dev)
    rows = torch.from_numpy(rng.integers(0, 4096, 3 * block).astype(
        np.int32)).to(dev)
    ref = table[rows.long()].view(torch.int16)
    for name, fn in (("take_gather", take_gather),
                     ("onehot_gather", onehot_gather)):
        before = cuda.counts()[name]
        got = fn(table, rows, block)
        assert cuda.counts()[name] == before + 1
        # one non-zero product per output on the tensor cores: bitwise
        assert torch.equal(got.view(torch.int16), ref), name


# a 5-level hash grid (res 4 .. 26; levels 0 and 1 dense, 2-4 hashed into
# 1024 rows): an odd level count, whose rows the forward writes as float2s
HASH5 = dataclasses.replace(HASH, n_levels=5)

# the hash backward (the features' cotangent in) against its plain version
# (lerp_levels_transpose, then the scatter): relative norm of the table
# gradient. The same float32 contributions, summed in another order: the
# kernel starts each lane's lerp-transpose sum at another sample, sums a
# cell's run of lanes before its atomics, and float atomics add in an
# order that changes from run to run.
HASH_BWD_TOL = 1e-6

# hard inputs of the hash backward at the fields' own grids (hash_bwd_case)
HASH_BWD_CASES = ("production", "mostly_zero", "contention",
                  "misaligned_cotangent", "smooth_points")
# their tolerances, from six runs on an H100 (the readings this test
# prints): at most 1.03e-7 against the plain version and 2.9e-8 against a
# second launch, but 1.11e-6 and 4.8e-7 in the contention case, whose
# level-0 and level-1 rows take the ~10^4 contributions of all 1037 rays
# each, summed in another order on every run
HASH_BWD_CASE_TOL = {**dict.fromkeys(HASH_BWD_CASES, HASH_BWD_TOL),
                     "contention": 4e-6}


def hash_bwd_case(name: str, device):
    """(grid, [x, y, z] float32 [N, S], strides, cotangent [N, S, 2L]) from
    a seed. ``production``: the NGP field's full grid (16 levels, 2^18
    rows), 1037 rays x 128 samples 2.5e-4 apart (the 5e-4 march step in
    [0, 1] coordinates) at that step's strides; ``mostly_zero``: the same
    with each ray's cotangent 0 past its first 0-16 samples and four rays
    in five all 0 (the hash steps' padded budget); ``contention``: every
    ray inside one level-0 cell (rays from [0.50, 0.51]^3, 0.032 long);
    ``misaligned_cotangent``: the production input with the cotangent 4
    bytes past a 16-byte boundary; ``smooth_points``: the sphere field's
    smoothstep grid at fine_res 4096 (2^19 rows) in the point form, 4099
    points on and beyond the box's faces."""
    rng = np.random.default_rng(90 + HASH_BWD_CASES.index(name))
    if name == "smooth_points":
        grid = HashGridConfig.sphere_field(fine_res=4096)
        x = _sphere_points(4099, 5)
        coords = [torch.from_numpy(np.ascontiguousarray(x[:, a:a + 1]))
                  .to(device) for a in range(3)]
        n, s, strides = 4099, 1, (1,) * grid.n_levels
    else:
        grid = HashGridConfig()
        n, s = 1037, 128
        strides = level_strides(grid, 5e-4, s)
        lo, hi = (0.5, 0.51) if name == "contention" else (0.1, 0.6)
        o = rng.uniform(lo, hi, (n, 1, 3))
        d = rng.standard_normal((n, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = (0.0 if name == "contention" else rng.uniform(0.0, 0.3, (n, 1, 1))
             ) + 2.5e-4 * np.arange(s)[None, :, None]
        pts = o + d * t
        coords = [torch.from_numpy(np.ascontiguousarray(pts[..., a],
                                                        np.float32))
                  .to(device) for a in range(3)]
    cot = rng.standard_normal((n, s, grid.out_dim)).astype(np.float32)
    if name == "mostly_zero":
        keep = rng.integers(0, 17, (n, 1, 1))
        keep[rng.uniform(size=n) < 0.8] = 0
        cot *= np.arange(s)[None, :, None] < keep
    g = torch.from_numpy(cot).to(device)
    if name == "misaligned_cotangent":
        buf = torch.empty(g.numel() + 5, device=device)
        view = buf[1:1 + g.numel()].view(g.shape)
        view.copy_(g)
        assert view.data_ptr() % 16 == 4
        g = view
    return grid, coords, strides, g


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [HASH, HASH5], ids=["6_levels", "5_levels"])
@pytest.mark.parametrize("case", FWD_CASES)
def test_hash_encode_kernels_match_plain(gpu, case, grid):
    """The forward writes the lerped, level-concatenated features: the same
    corners, weights, sums and lerp in the same order (no contraction), so
    bitwise; the gradient through ``HashEncode`` (the fused backward on the
    features' cotangent) agrees with the plain backward and with a second
    launch."""
    dev = gpu[0]
    rng = np.random.default_rng(FWD_CASES.index(case))
    *coords, strides = fwd_case(case, grid.n_levels, dev)
    table = torch.from_numpy(rng.uniform(-0.1, 0.1, grid.table_shape).astype(
        np.float32)).to(dev)
    check_forward_and_grad(
        hash_encode_ray, hash_encode_ray_plain, hash_encode_ray_bwd_cuda,
        hash_encode_ray_bwd_plain, "hash_encode", table, coords, grid,
        strides, 0.0, FWD_CASES.index(case), fused=True)


def _sphere_points(n: int, seed: int) -> np.ndarray:
    """n points in [0, 1]^3, the first few on and beyond the box's faces."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    edge = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0, 1], [-0.1, 1.2, 0.3]],
                    np.float32)
    x[:min(n, 4)] = edge[:min(n, 4)]
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("case", FWD_CASES + ("sphere_points",))
def test_hash_encode_smooth_kernels_match_plain(gpu, case):
    """The smoothstep forward (the sphere field's grid) on the hard plans
    and on the sphere field's point form (directions on and beyond the
    box's faces through ``hash_encode``): bitwise its plain version, one
    ``hash_encode_smooth`` launch and no linear one; the gradient through
    ``HashEncode`` (the fused backward) agrees with the plain backward and
    with a second launch."""
    dev = gpu[0]
    grid = HASH_SPHERE
    rng = np.random.default_rng(7 + len(case))
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, grid.table_shape).astype(
        np.float32)).to(dev)
    if case == "sphere_points":
        x = torch.from_numpy(_sphere_points(2049, 3)).to(dev)
        before = cuda.counts()
        got = hash_encode(table, x, grid)
        after = cuda.counts()
        assert after["hash_encode_smooth"] == before["hash_encode_smooth"] + 1
        assert after["hash_encode"] == before["hash_encode"]
        coords = [x[:, a:a + 1].contiguous() for a in range(3)]
        ref = hash_encode_ray_plain(table, *coords, grid, (1,) * 4)
        assert torch.equal(got, ref.reshape(got.shape))
        strides = (1,) * grid.n_levels
    else:
        *coords, strides = fwd_case(case, grid.n_levels, dev)
    before = cuda.counts()
    check_forward_and_grad(
        hash_encode_ray, hash_encode_ray_plain, hash_encode_ray_bwd_cuda,
        hash_encode_ray_bwd_plain, "hash_encode_smooth", table, coords, grid,
        strides, 0.0, len(case), fused=True)
    after = cuda.counts()
    assert after["hash_encode"] == before["hash_encode"]
    assert after["hash_encode_smooth_bwd"] == \
        before["hash_encode_smooth_bwd"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", HASH_BWD_CASES)
def test_hash_encode_bwd_kernel_matches_plain_at_field_sizes(gpu, case):
    """The fused backward at the fields' own grids (hash_bwd_case): within
    HASH_BWD_TOL of its plain version and of a second launch, one launch
    of its entry point each (linear, or smoothstep for the sphere
    field's)."""
    dev = gpu[0]
    grid, coords, strides, g = hash_bwd_case(case, dev)
    name = ("hash_encode_smooth_bwd" if grid.interpolation == "smoothstep"
            else "hash_encode_bwd")
    shape = grid.table_shape
    before = cuda.counts()
    got = hash_encode_ray_bwd_cuda(shape, *coords, grid, strides, g)
    again = hash_encode_ray_bwd_cuda(shape, *coords, grid, strides, g)
    after = cuda.counts()
    assert after[name] == before[name] + 2
    assert sum(after.values()) == sum(before.values()) + 2
    ref = hash_encode_ray_bwd_plain(shape, *coords, grid, strides, g)
    assert ref.abs().max().item() > 0.0
    rel = [((got - other).norm() / other.norm()).item()
           for other in (ref, again)]
    # the readings behind HASH_BWD_CASE_TOL (shown by pytest -s)
    print(f"{case}: kernel vs plain {rel[0]:.3e}, vs a second launch "
          f"{rel[1]:.3e}")
    assert max(rel) <= HASH_BWD_CASE_TOL[case]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 2049])
def test_hash_encode_grad_kernels_match_plain(gpu, n):
    dev = gpu[0]
    grid = HASH_SPHERE
    rng = np.random.default_rng(n + 1)
    x = torch.from_numpy(_sphere_points(n, n + 1)).to(dev)
    table = torch.from_numpy(rng.uniform(-0.5, 0.5, grid.table_shape).astype(
        np.float32)).to(dev)
    before = cuda.counts()
    f, df = hash_encode_grad_cuda(table, x, grid)
    assert cuda.counts()["hash_encode_grad"] == before["hash_encode_grad"] + 1
    f_ref, df_ref = hash_encode_grad_plain(table, x, grid)
    # the same corners, weights, derivative weights and sums in the same
    # order (no contraction)
    assert (f - f_ref).abs().max().item() <= 1e-6
    assert ((df - df_ref).abs().max() / df_ref.abs().max()).item() <= 1e-6
    gf = torch.from_numpy(rng.normal(size=tuple(f.shape)).astype(
        np.float32)).to(dev)
    gd = torch.from_numpy(rng.normal(size=tuple(df.shape)).astype(
        np.float32)).to(dev)
    gt = hash_encode_grad_grad_cuda(table.shape, x, grid, gf, gd)
    assert cuda.counts()["hash_encode_grad_bwd"] == \
        before["hash_encode_grad_bwd"] + 1
    gt_ref = hash_encode_grad_grad_plain(table.shape, x, grid, gf, gd)
    # the same float32 contributions, added by float atomics
    assert ((gt - gt_ref).norm() / gt_ref.norm()).item() <= 1e-6
    # through the autograd function: both cotangents reach the table
    leaf = table.clone().requires_grad_(True)
    ff, dd = hash_encode_grad(leaf, x, grid)
    (g_auto,) = torch.autograd.grad((ff, dd), leaf, (gf, gd))
    assert ((g_auto - gt_ref).norm() / gt_ref.norm()).item() <= 1e-6


@pytest.mark.cuda
def test_non_wild_entry_points_default_to_the_card(gpu):
    """The non-Wild geometry API's entry points run on the card unless the
    caller asks for the CPU: a default-constructed refiner and fusion
    predictor, and the dataset's masks, live on the GPU."""
    dev = gpu[0]
    refiner = PanoGeoRefiner(RefinerConfig(
        n_iters=2, batch_size=64, scan_chunk=1, field=SphereFieldConfig(
            n_levels=2, log2_table_size=12, fine_res=32, weight_norm=True,
            output="raw", encoding="hash", grad_mode="ad")))
    inv = PanoFusionInvPredictor(FakeCubeRoomDepthPredictor(),
                                 PanoFusionConfig(gen_res=8, iters=2,
                                                  scan_chunk=1))
    nrm = PanoFusionNormalPredictor(FakeCubeRoomNormalPredictor(),
                                    PanoFusionConfig(gen_res=8, iters=2,
                                                     scan_chunk=1))
    assert {refiner.device.type, inv.device.type, nrm.device.type} == {"cuda"}
    ds = Dataset()
    pano = render_cube_room_pano(torch.eye(4), 8, 16)
    ds.image, ds.height, ds.width = pano["rgb"], 8, 16
    dist = ds.get_ref_distance(inv)
    normal = ds.get_ref_normal(nrm)
    r_dist, r_normal = ds.refine_geometry(dist, normal, refiner)
    assert all(t.device.type == "cuda"
               for t in (dist, normal, r_dist, r_normal))


@pytest.mark.cuda
def test_hash_field_serving_and_prune_launch_the_hash_kernel(gpu):
    dev, _, occ = gpu
    fc = NGPFieldConfig(grid=HASH)
    params = params_from_jax(random_field_params(0, fc, density_gain=0.9),
                             dev)
    rng = np.random.default_rng(5)
    xyz = torch.from_numpy(rng.uniform(-1.1, 1.1, (2049, 3)).astype(
        np.float32)).to(dev)
    before = cuda.counts()
    got = field_eval(params, xyz, fc)
    after = cuda.counts()
    assert after["hash_encode"] == before["hash_encode"] + 2     # two heads
    assert after["field_eval"] == before["field_eval"]
    ref = field_eval_plain(params, xyz, fc)
    err, scale = (got - ref).abs(), ref.abs()
    # the same encode up to float32 rounding; where a feature or hidden unit
    # sits on a bf16 tie the two may round apart (a few percent)
    assert (err > 1e-4 * scale + 1e-6).float().mean().item() <= 5e-3
    assert bool((err <= 0.05 * scale + 1e-6).all())
    gen = torch.Generator(device=dev).manual_seed(3)
    prev = (occ * (torch.rand(occ.shape, generator=gen, device=dev) > 0.1)
            ).to(torch.uint8)
    jitter = torch.rand((2, 5000, 3), generator=gen, device=dev)
    before = cuda.counts()
    pruned = field_prune_occ(params["geo"], fc, occ, prev, 64, jitter)
    after = cuda.counts()
    assert after["hash_encode"] == before["hash_encode"] + 3
    assert after["occ_prune"] == before["occ_prune"]
    want = field_prune_occ_plain(params["geo"], fc, occ, prev, 64, jitter)
    assert int((pruned != want).sum()) <= 2


# -- the proposal estimator (K11, csrc/prop.cu) ----------------------------

def _prop_rows(n: int, m: int, seed: int):
    """Sorted edges [n, m+1] over [0.01, 2], densities [n, m] with a few
    peaks, peaked weights [n, m]."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.01, 2.0, (n, m + 1)), 1).astype(np.float32)
    sigma = (rng.random((n, m)) ** 4 * rng.uniform(0, 60, (n, 1))).astype(
        np.float32)
    w = (rng.random((n, m)) ** 6 * rng.uniform(0, 1, (n, 1))).astype(
        np.float32)
    return edges, sigma, w


def test_prop_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The five K11 wrappers refuse CPU tensors and shapes their kernels
    do not take, before building anything; the routes on CPU tensors (the
    plain versions) count no launch."""
    e, s, w = (torch.from_numpy(a) for a in _prop_rows(4, 8, 0))
    u = prop_k.linspace_u(4, 5)
    with pytest.raises(ValueError, match="CUDA"):
        prop_k.sample_from_weights_cuda(e, w, u.contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        prop_k.weights_from_density_cuda(s, e)
    with pytest.raises(ValueError, match="CUDA"):
        prop_k.weights_from_density_bwd_cuda(s, e, w)
    with pytest.raises(ValueError, match="CUDA"):
        prop_k.prop_loss_cuda(e, w, e, w)
    with pytest.raises(ValueError, match="CUDA"):
        prop_k.prop_loss_bwd_cuda(e, w, e, w, torch.ones(4))
    big = torch.zeros((2, prop_k.MAX_BINS + 1))
    with pytest.raises(ValueError, match="bins"):
        prop_k.weights_from_density_cuda(
            big, torch.zeros((2, prop_k.MAX_BINS + 2)))
    names = ("prop_resample", "prop_weights", "prop_weights_bwd", "prop_loss",
             "prop_loss_bwd")
    before = {k: cuda.counts()[k] for k in names}
    s.requires_grad_(True)
    wt = prop_k.weights_from_density(s, e, override_last=True)
    new = prop_k.sample_from_weights(e, wt, u)
    final_w = prop_k.weights_from_density(s[:, :5].detach(), new)
    loss = prop_k.prop_loss(new, final_w, [{"edges": e, "weights": wt}])
    loss.backward()
    assert s.grad is not None and (s.grad[:, -1] == 0).all()
    assert {k: cuda.counts()[k] for k in names} == before


def _prop_gpu(seed: int, n: int, m: int, dev):
    e, s, w = (torch.from_numpy(a).to(dev) for a in _prop_rows(n, m, seed))
    return e, s, w


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", [(1, 8, 5), (1037, 128, 64), (33, 64, 64),
                                   (5, 256, 257)])
def test_prop_resample_kernel_matches_plain(gpu, n, m, k):
    """Stratified and linspace u: the searched indices equal, the edges
    equal (the same CDF in XLA's order, the same divisions, no
    contraction)."""
    dev = gpu[0]
    e, _, w = _prop_gpu(n + m, n, m, dev)
    g = torch.Generator(device=dev).manual_seed(n)
    for u in (prop_k.stratified_u(torch.rand((n, 1), generator=g, device=dev),
                             k - 1).contiguous(),
              prop_k.linspace_u(n, k - 1, dev).contiguous()):
        before = cuda.counts()["prop_resample"]
        got, idx = prop_k.sample_from_weights_cuda(e, w, u, return_idx=True)
        assert cuda.counts()["prop_resample"] == before + 1
        ref, ref_idx = prop_k.sample_from_weights_plain(e, w, u)
        assert torch.equal(idx.long(), ref_idx)
        assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("override", [True, False])
@pytest.mark.parametrize("n,m", [(1, 2), (1037, 128), (64, 256)])
def test_prop_weights_kernels_match_plain(gpu, n, m, override):
    """w within 1e-6 relative + 2e-7 absolute (expf against torch's exp);
    the overridden last bin's rounded prefix equal; d sigma within 1e-5
    relative norm, 0 for an overridden last sigma."""
    dev = gpu[0]
    e, s, _ = _prop_gpu(m, n, m, dev)
    before = cuda.counts()["prop_weights"]
    got = prop_k.weights_from_density_cuda(s, e, override)
    assert cuda.counts()["prop_weights"] == before + 1
    ref = prop_k.weights_from_density_plain(s, e, override)
    assert bool(((got - ref).abs() <= 1e-6 * ref.abs() + 2e-7).all())
    g = torch.randn((n, m), generator=torch.Generator(device=dev).manual_seed(
        m), device=dev)
    before = cuda.counts()["prop_weights_bwd"]
    ds = prop_k.weights_from_density_bwd_cuda(s, e, g, override)
    assert cuda.counts()["prop_weights_bwd"] == before + 1
    ds_ref = prop_k.weights_from_density_bwd_plain(s, e, g, override)
    assert (ds - ds_ref).norm().item() <= 1e-5 * ds_ref.norm().item()
    if override:
        assert bool((ds[:, -1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k", [(1, 8, 4), (1037, 128, 64), (77, 64, 64)])
def test_prop_loss_kernels_match_plain(gpu, n, m, k):
    """Per-ray sums within 1e-5 relative (the plain sum runs in the same
    order), d proposal weights within 1e-5 relative norm."""
    dev = gpu[0]
    te, _, wp = _prop_gpu(m, n, m, dev)
    tf, _, wf = _prop_gpu(m + 1, n, k, dev)
    wf = (wf * 2.0).contiguous()
    before = cuda.counts()["prop_loss"]
    got = prop_k.prop_loss_cuda(te, wp, tf, wf)
    assert cuda.counts()["prop_loss"] == before + 1
    ref = prop_k.prop_loss_plain(te, wp, tf, wf)
    assert bool(((got - ref).abs() <= 1e-5 * ref.abs() + 1e-12).all())
    assert ref.sum().item() > 0
    g = torch.rand((n,), generator=torch.Generator(device=dev).manual_seed(n),
                   device=dev)
    before = cuda.counts()["prop_loss_bwd"]
    dw = prop_k.prop_loss_bwd_cuda(te, wp, tf, wf, g)
    assert cuda.counts()["prop_loss_bwd"] == before + 1
    dw_ref = prop_k.prop_loss_bwd_plain(te, wp, tf, wf, g)
    assert ((dw - dw_ref).norm() / dw_ref.norm()).item() <= 1e-5


# -- the NGP MLP (K2, csrc/ngp_mlp.cu) --------------------------------------------

# m: no multiple of the backward's tile (64 points in the bf16 heads, 128
# in the proposal head); a single point; every point outside the select;
# enough tiles that each block of the backward's grid takes two or three;
# one 16-row fragment less one and plus one; a 64-point tile plus one; many
# tiles over the grid with a remainder; an input narrower than the widest
# (the bf16 heads' W0 padded to 32 rows, x read without 16-byte rows)
MLP_SIZES = {"tail": 301, "one": 1, "sel_false": 257, "tiles": 87_077,
             "frag_less": 15, "frag_more": 17, "tile_more": 65,
             "grid_rest": 131_077, "narrow": 301}


def _mlp_on(dev, head: NGPHead, case: str):
    din = (24 if head.bf16 else 7) if case == "narrow" else None
    ws, x, sel, g = mlp_case(head, 70 + list(MLP_SIZES).index(case),
                             MLP_SIZES[case], din)
    if case == "sel_false":
        sel[:] = False
    return ([torch.from_numpy(w).to(dev) for w in ws],
            torch.from_numpy(x).to(dev), torch.from_numpy(sel).to(dev),
            torch.from_numpy(g).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MLP_SIZES))
@pytest.mark.parametrize("head", MLP_HEADS, ids=lambda h: h.name)
def test_ngp_mlp_kernels_match_plain(gpu, head, case):
    """Forward (under no_grad and through the Function) and backward
    against the plain versions on the card: the forward's float32 sums run
    in another order than cuBLAS's, so a hidden unit on a bf16 tie may round
    apart (at most 0.1% of outputs off by > 1e-4 relative); the backward on
    the kernel's own raw outputs, for the bf16 heads by ``fields/mlp.py``
    ``bf16_grads_within``: dx, dW0, dW1 bf16-valued; dx within one bf16
    ulp, or within the span that the moves of the sums' order upstream can
    carry to it (``bf16_head_reach``: a hidden output or cotangent rounded
    the other way on a tie, a ReLU decided the other way within its
    reach of zero), and five of its nonzero rows zeroed fail that; an
    entry of dW0 or dW1 past one ulp no farther from the float64 sum of
    the plain version's terms (``bf16_grad_sums_f64``) than the plain
    version is, plus one ulp and its terms' reach; the last layer within
    1e-5 relative norm plus its terms' reach; and on the points no tie
    reaches (the cotangent zero elsewhere) the same with no reach: one
    ulp, the float64 sums, 1e-5. The proposal head's float32 gradients all
    within 1e-5; a second backward bitwise the first."""
    ws, x, sel, g = _mlp_on(gpu[0], head, case)
    before = cuda.counts()
    with torch.no_grad():
        out_ng = ngp_head(ws, x, sel, head)
    mid = cuda.counts()
    assert mid["ngp_mlp"] == before["ngp_mlp"] + 1
    assert mid["ngp_mlp_bwd"] == before["ngp_mlp_bwd"]
    lx = x.clone().requires_grad_(True)
    lws = [w.clone().requires_grad_(True) for w in ws]
    out = ngp_head(lws, lx, sel, head)
    assert torch.equal(out, out_ng)
    ref, _ = ngp_head_plain(ws, x, sel, head)
    rel = (out - ref).abs() / ref.abs().clamp_min(1e-30)
    assert torch.isfinite(out).all()
    assert (rel > 1e-4).float().mean().item() <= 1e-3
    if case == "sel_false":
        assert (out == 0).all()

    grads = list(torch.autograd.grad(out, [lx, *lws], g))
    after = cuda.counts()
    assert after["ngp_mlp_bwd"] == mid["ngp_mlp_bwd"] + 1
    again = torch.autograd.grad(ngp_head(lws, lx, sel, head), [lx, *lws], g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _, raw = ngp_mlp_fwd_cuda(ws, x, sel, head, save_raw=True)
    rdx, rws = ngp_head_bwd_plain(ws, x, sel, raw, g, head)
    want = [rdx, *rws]
    if not head.bf16:
        for a, b in zip(grads, want):
            nb = b.norm()
            assert (a - b).norm() <= 1e-5 * nb if nb > 0 else (a == 0).all()
        return
    reach = bf16_head_reach(ws, x, sel, raw, g, head)
    sums = bf16_grad_sums_f64(ws, x, sel, raw, g, head)
    full = bf16_grads_within(grads, want, sums, reach)
    assert all(full["ok"].values()), full
    rows = torch.nonzero(rdx.abs().sum(dim=1) > 0).flatten()[-5:]
    if rows.numel():
        bad = [t.clone() for t in grads]
        bad[0][rows] = 0.0
        assert not bf16_grads_within(bad, want, sums, reach)["ok"]["dx"]
    g2 = g * reach["tie_free"]
    dx2, dws2 = ngp_mlp_bwd_cuda(ws, x, sel, raw, g2, head)
    rdx2, rws2 = ngp_head_bwd_plain(ws, x, sel, raw, g2, head)
    reach2 = bf16_head_reach(ws, x, sel, raw, g2, head)
    assert all(bool((t == 0).all()) for t in reach2["terms"])
    sums2 = bf16_grad_sums_f64(ws, x, sel, raw, g2, head)
    free = bf16_grads_within([dx2, *dws2], [rdx2, *rws2], sums2, reach2)
    assert all(free["ok"].values()), free

