"""Brick-packed multiresolution grid: config, indexing and the plain encode.

Counterpart of ``perf_tpu/kernels/brickgrid.py:41-265``. A level's corners
are packed into overlapping 4x4x4-corner bricks on a stride-3 grid; one
row of a level's table holds a whole brick, feature-interleaved
(lane = ((cx*4 + cy)*4 + cz)*F + f). Any voxel's 8 interpolation corners lie
in one row. Rows are dense when a level's bricks fit the table, else a
uint32 prime hash of the brick coordinates.

This module holds the plain PyTorch version of the encode (the table is
read as bf16, as ``corner_interp_lowp`` reads it; only each point's 8
interpolation corners are read). On the serving path the encode runs
fused with the MLPs inside the ``field_eval`` CUDA kernel
(``fields/ngp.py``). The training path encodes ray-structured samples with
per-level strides through ``brick_encode_ray``: the ``brick_encode``
kernels (``csrc/brick_encode.cu``) forward and backward for CUDA tensors,
the plain versions here for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import cuda

PRIMES = (1, 2654435761, 805459861)
BRICK = 3          # voxels per brick edge
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class BrickGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_bricks: int = 12
    base_res: int = 16
    per_level_scale: float = 1.4472692012786865

    @property
    def n_bricks(self) -> int:
        return 1 << self.log2_bricks

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def level_res(self, level: int) -> int:
        # float64, exactly as the JAX package computes it
        return int(np.floor(self.base_res * self.per_level_scale ** level))

    def level_bricks(self, level: int) -> int:
        return self.level_res(level) // BRICK + 1

    def level_hashed(self, level: int) -> bool:
        return self.level_bricks(level) ** 3 > self.n_bricks


def brick_index(bx, by, bz, nb: int, table_rows: int) -> torch.Tensor:
    """Row of brick (bx, by, bz): dense when nb^3 fits the table, else the
    uint32 prime hash masked to ``table_rows - 1``. The hash runs in int64
    with each product wrapped to 32 bits, which is uint32 arithmetic."""
    if nb ** 3 <= table_rows:
        return bx * (nb * nb) + by * nb + bz
    bx, by, bz = bx.long(), by.long(), bz.long()
    h = (((bx * PRIMES[0]) & _U32) ^ ((by * PRIMES[1]) & _U32)
         ^ ((bz * PRIMES[2]) & _U32))
    return h & (table_rows - 1)


def axis_split(x: torch.Tensor, res: int):
    """-> (brick coord, local corner in [0, 2], linear interpolation
    fraction)."""
    pos = torch.clamp(x, 0.0, 1.0) * res
    c0f = torch.clamp(torch.floor(pos), 0, res - 1)
    frac = pos - c0f
    c0 = c0f.to(torch.int64)
    b = torch.div(c0, BRICK, rounding_mode="floor")
    return b, c0 - b * BRICK, frac


_CORNER_OFFSETS = tuple(ox * 16 + oy * 4 + oz
                        for ox in (0, 1) for oy in (0, 1) for oz in (0, 1))


def _corners(x, y, z, res: int, nb: int, rows: int):
    """The 8 interpolation corners of each point, in the kernel's (ox, oy,
    oz) order: (flat index into the level's [rows * 64] corner table, [...,
    8] int64; weight (wx * wy) * wz, [..., 8] float32)."""
    (bx, lx, fx), (by, ly, fy), (bz, lz, fz) = (
        axis_split(a, res) for a in (x, y, z))
    first = brick_index(bx, by, bz, nb, rows) * 64 + (lx * 4 + ly) * 4 + lz
    idx = first[..., None] + torch.tensor(_CORNER_OFFSETS, device=x.device)
    wx, wy, wz = (torch.stack([1.0 - f, f], dim=-1) for f in (fx, fy, fz))
    w = (wx[..., :, None, None] * wy[..., None, :, None]) * wz[..., None, None, :]
    return idx, w.reshape(w.shape[:-3] + (8,))


def encode_level(table: torch.Tensor, lvl: int, x, y, z,
                 cfg: BrickGridConfig) -> torch.Tensor:
    """One level at coords [...] in [0, 1] -> [..., F] float32 (the
    forward of ``corner_interp_lowp``): the 8 interpolation corners of each
    point's bf16 row, weighted and summed. JAX sums all 64 * F lanes of the
    row, 56 * F of them weighted 0."""
    corners = table[lvl].to(torch.bfloat16).reshape(-1, cfg.n_features)
    idx, w = _corners(x, y, z, cfg.level_res(lvl), cfg.level_bricks(lvl),
                      table.shape[1])
    return (corners[idx].float() * w[..., None]).sum(dim=-2)


def brick_encode(table: torch.Tensor, x: torch.Tensor,
                 cfg: BrickGridConfig) -> torch.Tensor:
    """Flat encode: x [..., 3] in [0, 1] -> [..., L*F] float32."""
    return torch.cat([encode_level(table, lvl, x[..., 0], x[..., 1],
                                   x[..., 2], cfg)
                      for lvl in range(cfg.n_levels)], dim=-1)


# -- the training encode: ray-structured, per-level strides, with gradient ---

def level_plan(cfg: BrickGridConfig, strides: tuple, n_rays: int,
               n_samples: int) -> tuple:
    """Rows (res, bricks per axis, hashed, stride, points per ray, first
    point) per level, and the total number of points. A level of stride k
    > 1 reads samples 0, k, ..., S-k and S-1 of each ray; stride 1 reads
    every sample."""
    plan, first = [], 0
    for lvl, k in enumerate(strides):
        if n_samples % k:
            raise ValueError(f"stride {k} does not divide {n_samples} samples")
        npts = n_samples if k == 1 else n_samples // k + 1
        plan.append((cfg.level_res(lvl), cfg.level_bricks(lvl),
                     int(cfg.level_hashed(lvl)), k, npts, first))
        first += n_rays * npts
    return plan, first


def coarse_coords(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, S] -> the samples a stride-k level reads, [N, S/k + 1]."""
    return x if k == 1 else torch.cat([x[:, ::k], x[:, -1:]], dim=1)


def brick_points_plain(table: torch.Tensor, nx, ny, nz,
                       cfg: BrickGridConfig, strides: tuple) -> torch.Tensor:
    """Features [points, F] of every level's points, level after level."""
    return torch.cat([
        encode_level(table, lvl, *(coarse_coords(a, k) for a in (nx, ny, nz)),
                     cfg).reshape(-1, cfg.n_features)
        for lvl, k in enumerate(strides)])


def brick_points_grad_plain(table_shape, nx, ny, nz, cfg: BrickGridConfig,
                            strides: tuple, grad: torch.Tensor):
    """Table gradient [L, R, 64*F] float32 from the points' cotangents
    [points, F] (``_ci_bwd``): each corner's w * g rounded to bf16, then
    scatter-added in float32."""
    n, s = nx.shape
    nf = cfg.n_features
    plan, _ = level_plan(cfg, strides, n, s)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=grad.device)
    for lvl, (res, nb, _, k, npts, first) in enumerate(plan):
        xs, ys, zs = (coarse_coords(a, k) for a in (nx, ny, nz))
        g = grad[first:first + n * npts].reshape(n, npts, 1, nf)
        idx, w = _corners(xs, ys, zs, res, nb, table_shape[1])
        contrib = (w[..., None] * g).to(torch.bfloat16).float()
        gt[lvl].view(-1, nf).index_add_(0, idx.reshape(-1),
                                        contrib.reshape(-1, nf))
    return gt


@functools.lru_cache(maxsize=64)
def _level_table(plan: tuple, device: torch.device) -> torch.Tensor:
    """The plan as an int32 device tensor, made once per plan: a fresh
    host-to-device copy would make every launch wait for the queue."""
    return torch.tensor(plan, dtype=torch.int32, device=device)


def _kernel_plan(cfg: BrickGridConfig, strides, nx, table_shape):
    n, s = nx.shape
    plan, total = level_plan(cfg, strides, n, s)
    if total >= 2 ** 31:
        raise ValueError(f"{total} points: the kernel indexes points in int32")
    if tuple(table_shape) != (cfg.n_levels, cfg.n_bricks, 128):
        raise ValueError("brick_encode kernel takes a [L, rows, 128] table "
                         f"(2 features), got {tuple(table_shape)}")
    return _level_table(tuple(plan), nx.device), total


def brick_points_cuda(table: torch.Tensor, nx, ny, nz, cfg: BrickGridConfig,
                      strides: tuple) -> torch.Tensor:
    levels, total = _kernel_plan(cfg, strides, nx, table.shape)
    dev = nx.device
    for name, a in (("nx", nx), ("ny", ny), ("nz", nz)):
        cuda.check(a, name, torch.float32, tuple(nx.shape), dev)
    tbf = table.to(torch.bfloat16).contiguous()
    cuda.check(tbf, "table", torch.bfloat16,
               (cfg.n_levels, cfg.n_bricks, 128), dev)
    out = torch.empty((total, 2), dtype=torch.float32, device=dev)
    _ENCODE.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), nx.shape[1],
                   tbf.data_ptr(), cfg.n_bricks, levels.data_ptr(),
                   cfg.n_levels, total, out.data_ptr())
    return out


def brick_points_grad_cuda(table_shape, nx, ny, nz, cfg: BrickGridConfig,
                           strides: tuple, grad: torch.Tensor):
    dev = nx.device
    levels, total = _kernel_plan(cfg, strides, nx, table_shape)
    for name, a in (("nx", nx), ("ny", ny), ("nz", nz)):
        cuda.check(a, name, torch.float32, tuple(nx.shape), dev)
    grad = grad.contiguous()
    cuda.check(grad, "grad", torch.float32, (total, 2), dev)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=dev)
    _ENCODE_BWD.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
                       nx.shape[1], cfg.n_bricks, levels.data_ptr(),
                       cfg.n_levels, total, grad.data_ptr(), gt.data_ptr())
    return gt


def _register():
    args = [cuda.P, cuda.P, cuda.P, cuda.I32]
    fwd = cuda.register(cuda.CudaKernel(
        "brick_encode", "brick_encode.cu", "brick_encode_fwd_launch",
        args + [cuda.P, cuda.I32, cuda.P, cuda.I32, cuda.I64, cuda.P]))
    bwd = cuda.register(cuda.CudaKernel(
        "brick_encode_bwd", "brick_encode.cu", "brick_encode_bwd_launch",
        args + [cuda.I32, cuda.P, cuda.I32, cuda.I64, cuda.P, cuda.P]))
    return fwd, bwd


_ENCODE, _ENCODE_BWD = _register()


class BrickEncode(torch.autograd.Function):
    """Coarse-point features of all levels, [points, F], with the table
    gradient (``corner_interp_lowp`` and its VJP); the coordinates get no
    gradient. CUDA tensors launch the kernels, CPU tensors take the plain
    versions."""

    @staticmethod
    def forward(ctx, table, nx, ny, nz, cfg, strides):
        ctx.save_for_backward(nx, ny, nz)
        ctx.cfg, ctx.strides, ctx.table_shape = cfg, strides, table.shape
        if nx.is_cuda:
            return brick_points_cuda(table, nx, ny, nz, cfg, strides)
        if nx.device.type != "cpu":
            raise ValueError(f"brick_encode: unsupported device {nx.device}")
        return brick_points_plain(table, nx, ny, nz, cfg, strides)

    @staticmethod
    def backward(ctx, grad):
        nx, ny, nz = ctx.saved_tensors
        fn = brick_points_grad_cuda if grad.is_cuda else brick_points_grad_plain
        gt = fn(ctx.table_shape, nx, ny, nz, ctx.cfg, ctx.strides, grad)
        return gt, None, None, None, None, None


def brick_encode_ray(table: torch.Tensor, nx, ny, nz, cfg: BrickGridConfig,
                     strides: tuple) -> torch.Tensor:
    """Ray-structured encode: normalised coords [N, S] -> [N, S, L*F]. Level
    l is evaluated at its strided points and lerped back to all S samples
    (``brick_encode_ray``)."""
    from .hashgrid import lerp_upsample
    nx, ny, nz = (a.contiguous() for a in (nx, ny, nz))
    n, s = nx.shape
    flat = BrickEncode.apply(table, nx, ny, nz, cfg, tuple(strides))
    plan, _ = level_plan(cfg, strides, n, s)
    outs = []
    for _, _, _, k, npts, first in plan:
        c = flat[first:first + n * npts].reshape(n, npts, cfg.n_features)
        outs.append(lerp_upsample(c, k, s))
    return torch.cat(outs, dim=-1)
