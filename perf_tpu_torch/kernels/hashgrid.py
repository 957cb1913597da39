"""The multiresolution hash grid (Instant-NGP, tcnn's HashGrid) and the
per-level ray subsampling shared by the grid encoders.

Counterpart of ``perf_tpu/kernels/hashgrid.py``: ``HashGridConfig``,
``init_hash_table``, the corner index (dense where a level's
``(res + 1)^3`` corners fit the table, else the uint32 prime hash masked to
it), the linear-interpolation encode in its point form
(``hash_encode_coords`` / ``hash_encode``) and ray form with per-level
strides (``hash_encode_ray``), ``level_strides`` and ``_lerp_upsample``.
Tables are ``[L, F, T]`` float32 (feature-major), the JAX layout, so a
checkpoint of either package loads in the other.

Both forms run through ``HashEncode``: the encode of every level's points
(the level plan of ``level_plan``: a level of stride k reads samples 0, k,
..., S-k and S-1 of each ray; the point form is rays of one sample) with
the table gradient. CUDA tensors launch the ``hash_encode`` kernels
(``csrc/hash_encode.cu``), forward and backward; CPU tensors take the plain
versions here, which keep JAX's order of corner offsets, weight products
and sums. The lerp back to all S samples runs around the kernel in
PyTorch. Only linear interpolation is ported (the NGP field's): the
smoothstep encode with its position gradient (the sphere field's hash
encoding) is refused.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import numpy as np
import torch

from . import cuda

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# the 8 cube-corner offsets (ox, oy, oz), in JAX's order
OFFSETS = tuple((i >> 2 & 1, i >> 1 & 1, i & 1) for i in range(8))


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 18
    base_res: int = 16
    per_level_scale: float = 1.4472692012786865
    interpolation: str = "linear"  # only linear is ported
    # serving and the prune run the hash encode kernel, then the plain heads
    fused_field: ClassVar[bool] = False

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    @property
    def table_shape(self) -> tuple:
        return (self.n_levels, self.n_features, self.table_size)

    def level_res(self, level: int) -> int:
        # float64 as the JAX package: the finest default level is
        # floor(16 * 1.4472692...^15) = 4095, which a float32 product misses
        return int(np.floor(self.base_res * self.per_level_scale ** level))

    def level_hashed(self, level: int) -> bool:
        return (self.level_res(level) + 1) ** 3 > self.table_size

    def level_lookup(self, level: int) -> tuple:
        """(res, corners per axis, hashed): the level's columns of the
        kernel's level plan."""
        res = self.level_res(level)
        return res, res + 1, int(self.level_hashed(level))

    def init_table(self, generator: torch.Generator, device=None):
        return init_hash_table(generator, self, device)

    def encode_coords(self, table, x, y, z) -> torch.Tensor:
        return hash_encode_coords(table, x, y, z, self)

    def encode_coords_plain(self, table, x, y, z) -> torch.Tensor:
        return hash_encode_coords_plain(table, x, y, z, self)

    def encode_ray(self, table, nx, ny, nz, strides: tuple) -> torch.Tensor:
        return hash_encode_ray(table, nx, ny, nz, self, strides)


def init_hash_table(generator: torch.Generator, cfg: HashGridConfig,
                    device=None) -> torch.Tensor:
    """[L, F, T] float32, Uniform(-1e-4, 1e-4) (tcnn's init)."""
    table = torch.rand(cfg.table_shape, generator=generator) * 2e-4 - 1e-4
    return table.to(device)


def corner_index(cx, cy, cz, res: int, table_size: int) -> torch.Tensor:
    """Integer corner coordinates -> table row: dense when the level's
    corners fit the table, else the uint32 prime hash masked to it. Torch
    has no wrapping uint32 multiply, so each product runs in int64 and is
    masked to 32 bits before the XOR, which is uint32 arithmetic."""
    if (res + 1) ** 3 <= table_size:
        r1 = res + 1
        return cx * (r1 * r1) + cy * r1 + cz
    cx, cy, cz = cx.long(), cy.long(), cz.long()
    h = (((cx * PRIMES[0]) & _U32) ^ ((cy * PRIMES[1]) & _U32)
         ^ ((cz * PRIMES[2]) & _U32))
    return h & (table_size - 1)


def _check_linear(cfg: HashGridConfig):
    if cfg.interpolation != "linear":
        raise ValueError("the hash encode takes only linear interpolation "
                         f"(the NGP field's), got {cfg.interpolation!r}")


def _axis_terms(x: torch.Tensor, res: int):
    """Per axis: (lower corner, int64; linear weight of the upper one)."""
    pos = torch.clamp(x, 0.0, 1.0) * res
    c0f = torch.clamp(torch.floor(pos), 0, res - 1)
    return c0f.to(torch.int64), pos - c0f


def _level_corners(x, y, z, res: int, table_size: int):
    """The 8 corners of each point in JAX's order: [(row, weight)], the
    weight ((wx * wy) * wz) with 1 - w for a lower corner."""
    (cx, wx), (cy, wy), (cz, wz) = (_axis_terms(a, res) for a in (x, y, z))
    out = []
    for ox, oy, oz in OFFSETS:
        idx = corner_index(cx + ox, cy + oy, cz + oz, res, table_size)
        weight = ((wx if ox else 1.0 - wx) * (wy if oy else 1.0 - wy)
                  * (wz if oz else 1.0 - wz))
        out.append((idx, weight))
    return out


def encode_level_coords(table_lvl: torch.Tensor, res: int, x, y, z,
                        cfg: HashGridConfig) -> list:
    """One level at coords in [0, 1] (three same-shape tensors); table_lvl
    [F, T] -> F tensors shaped like x (``encode_level_coords``)."""
    _check_linear(cfg)
    accs = [None] * cfg.n_features
    for idx, weight in _level_corners(x, y, z, res, cfg.table_size):
        for f in range(cfg.n_features):
            term = table_lvl[f][idx] * weight
            accs[f] = term if accs[f] is None else accs[f] + term
    return accs


def hash_encode_coords_plain(table: torch.Tensor, x, y, z,
                             cfg: HashGridConfig) -> torch.Tensor:
    """The plain point form: [...] coords -> [..., L*F], level-major."""
    return torch.stack([f for lvl in range(cfg.n_levels)
                        for f in encode_level_coords(
                            table[lvl], cfg.level_res(lvl), x, y, z, cfg)],
                       dim=-1)


# -- per-level ray subsampling (shared with the brick grid) ---------------------

def level_strides(cfg, step: float, n_samples: int) -> tuple:
    """Per-level power-of-two strides along the ray: level l is sampled
    every ~half of its voxel (2 / res_l) and lerped back to the full
    ladder, capped at 16 and at half the sample count, and halved until it
    divides ``n_samples``."""
    strides = []
    for lvl in range(cfg.n_levels):
        voxel = 2.0 / cfg.level_res(lvl)
        k = max(1, int(voxel / (2.0 * step)))
        k = 1 << (k.bit_length() - 1)
        cap = max(1, n_samples // 2)
        cap = 1 << (cap.bit_length() - 1)
        k = min(k, 16, cap)
        while n_samples % k:
            k //= 2
        strides.append(k)
    return tuple(strides)


def lerp_upsample(coarse: torch.Tensor, stride: int, n: int) -> torch.Tensor:
    """[N, P+1, ...] values at every ``stride``-th sample plus the last ->
    [N, n, ...] by linear interpolation (``_lerp_upsample``)."""
    if stride == 1:
        return coarse[:, :n]
    p = n // stride
    left = coarse[:, :p].unsqueeze(2)
    right = coarse[:, 1:p + 1].unsqueeze(2)
    w = torch.arange(stride, dtype=coarse.dtype, device=coarse.device) / stride
    w = w.reshape((1, 1, stride) + (1,) * (coarse.dim() - 2))
    full = left * (1.0 - w) + right * w
    return full.reshape((coarse.shape[0], p * stride) + coarse.shape[2:])


def level_plan(cfg, strides: tuple, n_rays: int, n_samples: int) -> tuple:
    """Rows (res, lookup size, hashed, stride, points per ray, first point)
    per level, and the total number of points. The lookup size is the
    level's bricks per axis (brick grid) or corners per axis (hash grid). A
    level of stride k > 1 reads samples 0, k, ..., S-k and S-1 of each ray;
    stride 1 reads every sample."""
    plan, first = [], 0
    for lvl, k in enumerate(strides):
        if n_samples % k:
            raise ValueError(f"stride {k} does not divide {n_samples} samples")
        npts = n_samples if k == 1 else n_samples // k + 1
        plan.append((*cfg.level_lookup(lvl), k, npts, first))
        first += n_rays * npts
    return plan, first


def coarse_coords(x: torch.Tensor, k: int) -> torch.Tensor:
    """[N, S] -> the samples a stride-k level reads, [N, S/k + 1]."""
    return x if k == 1 else torch.cat([x[:, ::k], x[:, -1:]], dim=1)


@functools.lru_cache(maxsize=64)
def plan_tensor(plan: tuple, device: torch.device) -> torch.Tensor:
    """A level plan as an int32 device tensor, made once per plan: a fresh
    host-to-device copy would make every launch wait for the queue."""
    return torch.tensor(plan, dtype=torch.int32, device=device)


def kernel_plan(cfg, strides: tuple, nx: torch.Tensor) -> tuple:
    """(the level plan on nx's device, total points) of a ray-form launch."""
    n, s = nx.shape
    plan, total = level_plan(cfg, strides, n, s)
    if total >= 2 ** 31:
        raise ValueError(f"{total} points: the kernel indexes points in int32")
    return plan_tensor(tuple(plan), nx.device), total


# -- the encode of a level plan's points, plain and kernel ----------------------

def hash_points_plain(table: torch.Tensor, nx, ny, nz, cfg: HashGridConfig,
                      strides: tuple) -> torch.Tensor:
    """Features [points, F] of every level's points, level after level."""
    return torch.cat([
        torch.stack(encode_level_coords(
            table[lvl], cfg.level_res(lvl),
            *(coarse_coords(a, k) for a in (nx, ny, nz)), cfg),
            dim=-1).reshape(-1, cfg.n_features)
        for lvl, k in enumerate(strides)])


def hash_points_grad_plain(table_shape, nx, ny, nz, cfg: HashGridConfig,
                           strides: tuple, grad: torch.Tensor):
    """Table gradient [L, F, T] float32 from the points' cotangents [points,
    F]: each corner's weight * cotangent scatter-added in float32 (JAX's
    transpose of the gather; no bf16 rounding)."""
    _check_linear(cfg)
    n, s = nx.shape
    nf = cfg.n_features
    plan, _ = level_plan(cfg, strides, n, s)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=grad.device)
    for lvl, (res, _, _, k, npts, first) in enumerate(plan):
        g = grad[first:first + n * npts].reshape(n, npts, nf)
        xs, ys, zs = (coarse_coords(a, k) for a in (nx, ny, nz))
        for idx, weight in _level_corners(xs, ys, zs, res, cfg.table_size):
            for f in range(nf):
                gt[lvl, f].index_add_(0, idx.reshape(-1),
                                      (g[..., f] * weight).reshape(-1))
    return gt


def _check_kernel_args(cfg: HashGridConfig, table_shape, coords):
    _check_linear(cfg)
    if tuple(table_shape) != (cfg.n_levels, 2, cfg.table_size):
        raise ValueError("hash_encode kernel takes a [L, 2, T] table (2 "
                         f"features), got {tuple(table_shape)}")
    dev = coords[0].device
    for name, a in zip(("nx", "ny", "nz"), coords):
        cuda.check(a, name, torch.float32, tuple(coords[0].shape), dev)


def hash_points_cuda(table: torch.Tensor, nx, ny, nz, cfg: HashGridConfig,
                     strides: tuple) -> torch.Tensor:
    _check_kernel_args(cfg, table.shape, (nx, ny, nz))
    levels, total = kernel_plan(cfg, strides, nx)
    dev = nx.device
    table = table.contiguous()
    cuda.check(table, "table", torch.float32, None, dev)
    out = torch.empty((total, 2), dtype=torch.float32, device=dev)
    _ENCODE.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), nx.shape[1],
                   table.data_ptr(), cfg.table_size, levels.data_ptr(),
                   cfg.n_levels, total, out.data_ptr())
    return out


def hash_points_grad_cuda(table_shape, nx, ny, nz, cfg: HashGridConfig,
                          strides: tuple, grad: torch.Tensor):
    _check_kernel_args(cfg, table_shape, (nx, ny, nz))
    levels, total = kernel_plan(cfg, strides, nx)
    dev = nx.device
    grad = grad.contiguous()
    if grad.data_ptr() % 8:          # the kernel reads float2
        grad = grad.clone()
    cuda.check(grad, "grad", torch.float32, (total, 2), dev)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=dev)
    _ENCODE_BWD.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
                       nx.shape[1], cfg.table_size, levels.data_ptr(),
                       cfg.n_levels, total, grad.data_ptr(), gt.data_ptr())
    return gt


_ARGS = [cuda.P, cuda.P, cuda.P, cuda.I32]
_ENCODE = cuda.register(cuda.CudaKernel(
    "hash_encode", "hash_encode.cu", "hash_encode_fwd_launch",
    _ARGS + [cuda.P, cuda.I32, cuda.P, cuda.I32, cuda.I64, cuda.P]))
_ENCODE_BWD = cuda.register(cuda.CudaKernel(
    "hash_encode_bwd", "hash_encode.cu", "hash_encode_bwd_launch",
    _ARGS + [cuda.I32, cuda.P, cuda.I32, cuda.I64, cuda.P, cuda.P]))


class HashEncode(torch.autograd.Function):
    """Features [points, F] of a level plan's points with the table
    gradient; the coordinates get none (the NeRF path never needs the
    position gradient). CUDA tensors launch the kernels, CPU tensors take
    the plain versions."""

    @staticmethod
    def forward(ctx, table, nx, ny, nz, cfg, strides):
        _check_linear(cfg)
        ctx.save_for_backward(nx, ny, nz)
        ctx.cfg, ctx.strides, ctx.table_shape = cfg, strides, table.shape
        if nx.is_cuda:
            return hash_points_cuda(table, nx, ny, nz, cfg, strides)
        if nx.device.type != "cpu":
            raise ValueError(f"hash_encode: unsupported device {nx.device}")
        return hash_points_plain(table, nx, ny, nz, cfg, strides)

    @staticmethod
    def backward(ctx, grad):
        nx, ny, nz = ctx.saved_tensors
        fn = hash_points_grad_cuda if grad.is_cuda else hash_points_grad_plain
        gt = fn(ctx.table_shape, nx, ny, nz, ctx.cfg, ctx.strides, grad)
        return gt, None, None, None, None, None


def _encode_points(table, nx, ny, nz, cfg, strides) -> torch.Tensor:
    if torch.is_grad_enabled() and any(a.requires_grad for a in (nx, ny, nz)):
        raise ValueError("the hash encode gives the table gradient only; "
                         "detach the coordinates")
    nx, ny, nz = (a.contiguous() for a in (nx, ny, nz))
    return HashEncode.apply(table, nx, ny, nz, cfg, tuple(strides))


def hash_encode_ray(table: torch.Tensor, nx, ny, nz, cfg: HashGridConfig,
                    strides: tuple) -> torch.Tensor:
    """Ray-structured encode: normalised coords [N, S] -> [N, S, L*F]. Level
    l is evaluated at its strided points and lerped back to all S samples
    (``hash_encode_ray``)."""
    n, s = nx.shape
    flat = _encode_points(table, nx, ny, nz, cfg, strides)
    plan, _ = level_plan(cfg, strides, n, s)
    return torch.cat([
        lerp_upsample(flat[first:first + n * npts].reshape(
            n, npts, cfg.n_features), k, s)
        for _, _, _, k, npts, first in plan], dim=-1)


def hash_encode_coords(table: torch.Tensor, x, y, z,
                       cfg: HashGridConfig) -> torch.Tensor:
    """The point form: coords [...] in [0, 1] -> [..., L*F], level-major
    (level 0 f0, level 0 f1, level 1 f0, ...): one sample per ray, every
    stride 1."""
    shape = x.shape
    flat = _encode_points(table, *(a.reshape(-1, 1) for a in (x, y, z)),
                          cfg, (1,) * cfg.n_levels)
    feats = flat.reshape(cfg.n_levels, -1, cfg.n_features).permute(1, 0, 2)
    return feats.reshape(*shape, cfg.out_dim)


def hash_encode(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """Positions x [..., 3] in [0, 1]^3 -> features [..., L*F]."""
    return hash_encode_coords(table, x[..., 0], x[..., 1], x[..., 2], cfg)
