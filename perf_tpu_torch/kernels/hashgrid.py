"""The multiresolution hash grid (Instant-NGP, tcnn's HashGrid) and the
per-level ray subsampling shared by the grid encoders.

Counterpart of ``perf_tpu/kernels/hashgrid.py``: ``HashGridConfig``,
``init_hash_table``, the corner index (dense where a level's
``(res + 1)^3`` corners fit the table, else the uint32 prime hash masked to
it), the linear-interpolation encode in its point form
(``hash_encode_coords`` / ``hash_encode``) and ray form with per-level
strides (``hash_encode_ray``), ``level_strides`` and ``_lerp_upsample``.
Tables are ``[L, F, T]`` float32 (feature-major), the JAX layout, so a
checkpoint of either package loads in the other. Interpolation is linear
(the NGP field's) or smoothstep, w = f * f * (3 - 2 f) (the sphere field's,
``HashGridConfig.sphere_field``).

Both forms run through ``HashEncode``: the finished features [N, S, L*F]
of ray-structured coordinates [N, S] (the level plan of ``level_plan``: a
level of stride k is encoded at samples 0, k, ..., S-k and S-1 of each ray
and lerped back to all S; the point form is rays of one sample) with the
table gradient. CUDA tensors launch the ``hash_encode`` kernels
(``csrc/hash_encode.cu``; the smoothstep variant counts as
``hash_encode_smooth``): the forward writes the lerped, level-concatenated
features itself, the backward takes their cotangent [N, S, L*F] as
autograd hands it in and forms the coarse points' cotangents itself (the
lerp's and the concatenation's transpose), with the levels of
``shared_levels`` summed in a block's shared memory first. CPU tensors
take the plain versions here, which keep JAX's order of corner offsets,
weight products and sums: ``hash_encode_ray_bwd_plain`` is
``lerp_levels_transpose`` (the ops autograd runs on the lerp and the
concatenation) followed by ``hash_points_grad_plain``.
``HashEncode`` gives no position gradient.

The sphere field's ``ad`` gradients take ``hash_encode_grad``: the point
form's features and their derivatives with respect to the position, dfeats
[N, 3, L*F], as JAX's autodiff of ``hash_encode`` gives them (the clip's
derivative is 1 inside, 0.5 at 0 and at 1, 0 outside; floor and the
clipped lower corner contribute nothing), with the table gradient of both
(``HashEncodeGrad``; the ``hash_encode_grad`` kernels of
``csrc/hash_encode_grad.cu`` on the card, smoothstep only). Both kernel
sources locate a point's cell, weights and rows through one header,
``csrc/hash_cell.cuh``, as the plain versions here share ``_axis_terms``
and ``_level_corners``.
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
    interpolation: str = "linear"  # or "smoothstep"
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

    @classmethod
    def sphere_field(cls, fine_res: int = 2048, n_levels: int = 16,
                     log2_table_size: int = 19, base_res: int = 16):
        """The sphere distance field's grid: the growth solved from
        ``fine_res`` in float64 (as the JAX package), smoothstep
        interpolation."""
        scale = float(np.exp(np.log(fine_res / base_res) / (n_levels - 1)))
        return cls(n_levels=n_levels, n_features=2,
                   log2_table_size=log2_table_size, base_res=base_res,
                   per_level_scale=scale, interpolation="smoothstep")

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

    def encode_ray(self, table, nx, ny, nz, strides: tuple,
                   run_caps: tuple | None = None) -> torch.Tensor:
        """``run_caps`` is ignored: the run dedup is a brick-grid encode (JAX
        routes only brick grids to it)."""
        return hash_encode_ray(table, nx, ny, nz, self, strides)


def init_hash_table(generator: torch.Generator, cfg: HashGridConfig,
                    device=None) -> torch.Tensor:
    """[L, F, T] float32, Uniform(-1e-4, 1e-4) (tcnn's init)."""
    table = torch.rand(cfg.table_shape, generator=generator) * 2e-4 - 1e-4
    return table.to(device)


def _axis_term(c, axis: int, res: int, table_size: int) -> torch.Tensor:
    """One axis's share of a corner's row: c * (res + 1)^(2 - axis) where
    the level's corners fit the table, else c * prime masked to 32 bits.
    Torch has no wrapping uint32 multiply, so the product runs in int64 and
    is masked, which is uint32 arithmetic."""
    if (res + 1) ** 3 <= table_size:
        return c * (res + 1) ** (2 - axis)
    return (c.long() * PRIMES[axis]) & _U32


def _row(tx, ty, tz, res: int, table_size: int) -> torch.Tensor:
    """The row of the axis terms: their sum (dense) or their XOR masked to
    the table (the prime hash)."""
    if (res + 1) ** 3 <= table_size:
        return tx + ty + tz
    return (tx ^ ty ^ tz) & (table_size - 1)


def corner_index(cx, cy, cz, res: int, table_size: int) -> torch.Tensor:
    """Integer corner coordinates -> table row: dense when the level's
    corners fit the table, else the uint32 prime hash masked to it."""
    return _row(*(_axis_term(c, a, res, table_size)
                  for a, c in enumerate((cx, cy, cz))), res, table_size)


INTERPOLATIONS = ("linear", "smoothstep")


def _smooth(cfg: HashGridConfig) -> bool:
    if cfg.interpolation not in INTERPOLATIONS:
        raise ValueError(f"hash grid interpolation {cfg.interpolation!r}: "
                         f"only {INTERPOLATIONS} are ported")
    return cfg.interpolation == "smoothstep"


def _axis_terms(x: torch.Tensor, res: int, smooth: bool, grad: bool = False):
    """Per axis: (lower corner, int64; weight of the upper one), the
    smoothstep weight as JAX writes it, (f * f) * (3 - 2 f). ``grad`` adds
    d weight / d x with JAX's forward-mode arithmetic: the clip's
    derivative 1 inside, 0.5 at 0 and at 1 (``maximum`` / ``minimum`` split
    a tie), 0 outside; d f = that times res (floor and the clipped lower
    corner have none); smoothstep d w = (df * f + f * df) * (3 - 2 f) +
    (f * f) * -(2 df)."""
    pos = torch.clamp(x, 0.0, 1.0) * res
    c0f = torch.clamp(torch.floor(pos), 0, res - 1)
    frac = pos - c0f
    w = frac * frac * (3.0 - 2.0 * frac) if smooth else frac
    if not grad:
        return c0f.to(torch.int64), w
    dclip = torch.where((x > 0.0) & (x < 1.0), 1.0,
                        torch.where((x == 0.0) | (x == 1.0), 0.5, 0.0))
    dfrac = dclip * res
    dw = ((dfrac * frac + frac * dfrac) * (3.0 - 2.0 * frac)
          + (frac * frac) * -(2.0 * dfrac)) if smooth else dfrac
    return c0f.to(torch.int64), w, dw


def _level_corners(x, y, z, res: int, table_size: int, smooth: bool,
                   grad: bool = False):
    """The 8 corners of each point in JAX's order: [(row, weight)], the
    weight (A * B) * C with A = wx for an upper corner and 1 - wx for a
    lower one. ``grad`` adds its derivatives ((dA * B) * C, (A * dB) * C,
    (A * B) * dC), dA = -dwx for a lower corner: [(row, weight, (d weight
    / dx, / dy, / dz))]. Each axis's row terms (``corner_index``'s), 1 - w
    and -dw are formed once for its lower and upper corner."""
    terms = [_axis_terms(a, res, smooth, grad) for a in (x, y, z)]
    rows = [tuple(_axis_term(t[0] + o, ax, res, table_size) for o in (0, 1))
            for ax, t in enumerate(terms)]
    ws = [(1.0 - t[1], t[1]) for t in terms]
    dws = [(-t[2], t[2]) for t in terms] if grad else None
    out = []
    # OFFSETS order: x slowest, z fastest; the x-y products are shared by
    # the two z corners
    for ox in (0, 1):
        for oy in (0, 1):
            a, b = ws[0][ox], ws[1][oy]
            ab = a * b
            if grad:
                dab = (dws[0][ox] * b, a * dws[1][oy])
            for oz in (0, 1):
                c = ws[2][oz]
                idx = _row(rows[0][ox], rows[1][oy], rows[2][oz], res,
                           table_size)
                if not grad:
                    out.append((idx, ab * c))
                    continue
                out.append((idx, ab * c, (dab[0] * c, dab[1] * c,
                                          ab * dws[2][oz])))
    return out


def encode_level_coords(table_lvl: torch.Tensor, res: int, x, y, z,
                        cfg: HashGridConfig) -> list:
    """One level at coords in [0, 1] (three same-shape tensors); table_lvl
    [F, T] -> F tensors shaped like x (``encode_level_coords``)."""
    smooth = _smooth(cfg)
    accs = [None] * cfg.n_features
    for idx, weight in _level_corners(x, y, z, res, cfg.table_size, smooth):
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


@functools.lru_cache(maxsize=64)
def _lerp_weights(stride: int, dtype, device) -> tuple:
    """(w, 1 - w) of ``_lerp_upsample`` at ``stride``: w = arange(k) / k as
    [1, 1, k, 1], made once per stride, type and device."""
    w = torch.arange(stride, dtype=dtype, device=device) / stride
    w = w.reshape(1, 1, stride, 1)
    return w, 1.0 - w


def lerp_upsample(coarse: torch.Tensor, stride: int, n: int) -> torch.Tensor:
    """[N, P+1, F] values at every ``stride``-th sample plus the last ->
    [N, n, F] by linear interpolation (``_lerp_upsample``)."""
    if stride == 1:
        return coarse[:, :n]
    p = n // stride
    left = coarse[:, :p].unsqueeze(2)
    right = coarse[:, 1:p + 1].unsqueeze(2)
    w, one_minus_w = _lerp_weights(stride, coarse.dtype, coarse.device)
    full = left * one_minus_w + right * w
    return full.reshape((coarse.shape[0], p * stride) + coarse.shape[2:])


def lerp_levels(flat: torch.Tensor, plan, n: int, s: int) -> torch.Tensor:
    """Coarse points' features [points, F] of a level plan -> the samples'
    [N, S, L*F]: each level lerped back to the S samples, the levels
    concatenated (what the forward kernels write)."""
    nf = flat.shape[1]
    return torch.cat([
        lerp_upsample(flat[first:first + n * npts].reshape(n, npts, nf), k, s)
        for _, _, _, k, npts, first in plan], dim=-1)


def lerp_levels_transpose(grad: torch.Tensor, plan, n: int, s: int,
                          total: int) -> torch.Tensor:
    """The transpose of ``lerp_levels``: the samples' cotangent [N, S,
    L*F] -> the coarse points' [points, F], with the float32 operations
    autograd runs on the lerp (each product, the sum over a stride's
    samples, the two neighbours' shares added) and the concatenation, so
    the values equal autograd's. A run of stride-1 levels is one copy."""
    nf = grad.shape[-1] // len(plan)
    out = grad.new_empty((total, nf))
    lvl = 0
    while lvl < len(plan):
        k, npts, first = plan[lvl][3:]
        if k == 1:
            end = lvl
            while end < len(plan) and plan[end][3] == 1:
                end += 1
            out[first:first + (end - lvl) * n * s].view(
                end - lvl, n, s, nf).copy_(
                grad[..., lvl * nf:end * nf].reshape(n, s, end - lvl, nf)
                .permute(2, 0, 1, 3))
            lvl = end
            continue
        p = s // k
        w, one_minus_w = _lerp_weights(k, grad.dtype, grad.device)
        g = grad[..., lvl * nf:(lvl + 1) * nf].reshape(n, p, k, nf)
        left = (g * one_minus_w).sum(2, keepdim=True).squeeze(2)
        right = (g * w).sum(2, keepdim=True).squeeze(2)
        dst = out[first:first + n * npts].view(n, npts, nf)
        dst[:, :p].copy_(left)
        dst[:, p:].zero_()
        dst[:, 1:].add_(right)
        lvl += 1
    return out


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


def ray_kernel_plan(cfg, strides: tuple, nx: torch.Tensor) -> tuple:
    """(the level plan on nx's device, coarse points a ray) of a forward
    tile launch, whose lerp takes power-of-two strides (``level_strides``
    gives only those)."""
    if any(k & (k - 1) for k in strides):
        raise ValueError(f"strides {tuple(strides)}: the forward kernels "
                         "lerp power-of-two strides only")
    levels, total = kernel_plan(cfg, strides, nx)
    return levels, total // max(nx.shape[0], 1)


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
    smooth = _smooth(cfg)
    n, s = nx.shape
    nf = cfg.n_features
    plan, _ = level_plan(cfg, strides, n, s)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=grad.device)
    for lvl, (res, _, _, k, npts, first) in enumerate(plan):
        g = grad[first:first + n * npts].reshape(n, npts, nf)
        xs, ys, zs = (coarse_coords(a, k) for a in (nx, ny, nz))
        for idx, weight in _level_corners(xs, ys, zs, res, cfg.table_size,
                                          smooth):
            for f in range(nf):
                gt[lvl, f].index_add_(0, idx.reshape(-1),
                                      (g[..., f] * weight).reshape(-1))
    return gt


def _check_kernel_args(cfg: HashGridConfig, table_shape, coords):
    _smooth(cfg)
    if tuple(table_shape) != (cfg.n_levels, 2, cfg.table_size):
        raise ValueError("hash_encode kernel takes a [L, 2, T] table (2 "
                         f"features), got {tuple(table_shape)}")
    dev = coords[0].device
    for name, a in zip(("nx", "ny", "nz"), coords):
        cuda.check(a, name, torch.float32, tuple(coords[0].shape), dev)


def hash_encode_ray_plain(table: torch.Tensor, nx, ny, nz,
                          cfg: HashGridConfig, strides: tuple) -> torch.Tensor:
    """The plain ray form: coords [N, S] -> [N, S, L*F], every level's
    coarse points encoded, lerped back to the S samples and concatenated
    (JAX's ``hash_encode_ray``; the point form is S = 1)."""
    n, s = nx.shape
    plan, _ = level_plan(cfg, strides, n, s)
    return lerp_levels(hash_points_plain(table, nx, ny, nz, cfg, strides),
                       plan, n, s)


def hash_encode_ray_cuda(table: torch.Tensor, nx, ny, nz,
                         cfg: HashGridConfig, strides: tuple) -> torch.Tensor:
    _check_kernel_args(cfg, table.shape, (nx, ny, nz))
    levels, per_ray = ray_kernel_plan(cfg, strides, nx)
    dev = nx.device
    n, s = nx.shape
    # the kernel reads a corner's two features as one float2: an [L, T, 2]
    # copy of the [L, 2, T] parameter, made per call
    inter = table.transpose(1, 2).contiguous()
    cuda.check(inter, "table", torch.float32, None, dev)
    out = torch.empty((n, s, cfg.out_dim), dtype=torch.float32, device=dev)
    _ENCODE[_smooth(cfg)].launch(
        nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), n, s, per_ray,
        inter.data_ptr(), cfg.table_size, levels.data_ptr(), cfg.n_levels,
        out.data_ptr())
    return out


def hash_encode_ray_bwd_plain(table_shape, nx, ny, nz, cfg: HashGridConfig,
                              strides: tuple, grad: torch.Tensor):
    """Table gradient [L, F, T] float32 from the features' cotangent [N, S,
    L*F]: the coarse points' cotangents (``lerp_levels_transpose``), then
    their scatter (``hash_points_grad_plain``)."""
    n, s = nx.shape
    plan, total = level_plan(cfg, strides, n, s)
    return hash_points_grad_plain(
        table_shape, nx, ny, nz, cfg, strides,
        lerp_levels_transpose(grad, plan, n, s, total))


# the backward's shared-memory levels (tools/encode_probe.py --backward,
# PERF.md): the bytes a block gives them, and the points a row a level
# needs to take a block's copy (on an H100 level 0's copy took 4-10% off
# the point forms, 46-213 points a row, and added 2% to the hash geometry
# plan's 15)
SHARED_LEVEL_BYTES = 48 * 1024
SHARED_MIN_POINTS = 32


def shared_levels(plan, n_rays: int,
                  budget: int = SHARED_LEVEL_BYTES) -> tuple:
    """The levels of a level plan (``level_plan``'s rows) whose gradient
    the backward kernel sums in a block's shared memory before it adds them
    to the table's: dense levels (the plan's hashed column, which is
    ``level_hashed``) with at least SHARED_MIN_POINTS of the plan's points
    a row, coarsest first, while their rows x 2 float32 fit in ``budget``
    bytes together."""
    picked, used = [], 0
    for lvl, (_, look, hashed, _, npts, _) in enumerate(plan):
        rows = look ** 3
        if hashed or n_rays * npts < SHARED_MIN_POINTS * rows:
            continue
        if used + rows * 8 > budget:
            break
        picked.append(lvl)
        used += rows * 8
    return tuple(picked)


@functools.lru_cache(maxsize=64)
def _shared_slab(cfg: HashGridConfig, strides: tuple, n_rays: int,
                 n_samples: int) -> tuple:
    """(bit mask of ``shared_levels``, their rows x 2 float32) of a backward
    launch, made once per plan."""
    shared = shared_levels(level_plan(cfg, strides, n_rays, n_samples)[0],
                           n_rays)
    return (sum(1 << lvl for lvl in shared),
            sum(cfg.level_lookup(lvl)[1] ** 3 * 2 for lvl in shared))


def hash_encode_ray_bwd_cuda(table_shape, nx, ny, nz, cfg: HashGridConfig,
                             strides: tuple, grad: torch.Tensor):
    _check_kernel_args(cfg, table_shape, (nx, ny, nz))
    levels, per_ray = ray_kernel_plan(cfg, strides, nx)
    dev = nx.device
    n, s = nx.shape
    grad = grad.contiguous()         # autograd's cotangent is: no copy
    cuda.check(grad, "grad", torch.float32, (n, s, cfg.out_dim), dev)
    mask, slab = _shared_slab(cfg, tuple(strides), n, s)
    gt = torch.empty(table_shape, dtype=torch.float32, device=dev)
    # the kernel's float2 accumulator [L, T, 2], zeroed by the launch
    acc = torch.empty((cfg.n_levels, cfg.table_size, 2), dtype=torch.float32,
                      device=dev)
    _ENCODE_BWD[_smooth(cfg)].launch(
        nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), n, s, per_ray,
        cfg.table_size, levels.data_ptr(), cfg.n_levels, grad.data_ptr(),
        mask, slab, acc.data_ptr(), gt.data_ptr())
    return gt


_ARGS = [cuda.P, cuda.P, cuda.P, cuda.I32]
# indexed by smoothstep: the linear entry points, then the smoothstep ones
_ENCODE = tuple(cuda.register(cuda.CudaKernel(
    f"hash_encode{tag}", "hash_encode.cu", f"hash_encode{tag}_fwd_launch",
    _ARGS + [cuda.I32, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.I32, cuda.P]))
    for tag in ("", "_smooth"))
_ENCODE_BWD = tuple(cuda.register(cuda.CudaKernel(
    f"hash_encode{tag}_bwd", "hash_encode.cu", f"hash_encode{tag}_bwd_launch",
    _ARGS + [cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.I32, cuda.P,
             cuda.I32, cuda.I32, cuda.P, cuda.P]))
    for tag in ("", "_smooth"))


class HashEncode(torch.autograd.Function):
    """Features [N, S, L*F] of ray-structured coordinates [N, S] with the
    table gradient; the coordinates get none (the NeRF path never needs
    the position gradient). CUDA tensors launch the kernels, CPU tensors
    take the plain versions; the backward kernel takes the features'
    cotangent as it comes."""

    @staticmethod
    def forward(ctx, table, nx, ny, nz, cfg, strides):
        _smooth(cfg)
        ctx.save_for_backward(nx, ny, nz)
        ctx.cfg, ctx.strides, ctx.table_shape = cfg, strides, table.shape
        if nx.is_cuda:
            return hash_encode_ray_cuda(table, nx, ny, nz, cfg, strides)
        if nx.device.type != "cpu":
            raise ValueError(f"hash_encode: unsupported device {nx.device}")
        return hash_encode_ray_plain(table, nx, ny, nz, cfg, strides)

    @staticmethod
    def backward(ctx, grad):
        nx, ny, nz = ctx.saved_tensors
        fn = (hash_encode_ray_bwd_cuda if grad.is_cuda
              else hash_encode_ray_bwd_plain)
        gt = fn(ctx.table_shape, nx, ny, nz, ctx.cfg, ctx.strides, grad)
        return gt, None, None, None, None, None


def hash_encode_ray(table: torch.Tensor, nx, ny, nz, cfg: HashGridConfig,
                    strides: tuple) -> torch.Tensor:
    """Ray-structured encode: normalised coords [N, S] -> [N, S, L*F]. Level
    l is evaluated at its strided points and lerped back to all S samples
    (``hash_encode_ray``)."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in (nx, ny, nz)):
        raise ValueError("the hash encode gives the table gradient only; "
                         "detach the coordinates (hash_encode_grad gives "
                         "the position gradient)")
    nx, ny, nz = (a.contiguous() for a in (nx, ny, nz))
    return HashEncode.apply(table, nx, ny, nz, cfg, tuple(strides))


def hash_encode_coords(table: torch.Tensor, x, y, z,
                       cfg: HashGridConfig) -> torch.Tensor:
    """The point form: coords [...] in [0, 1] -> [..., L*F], level-major
    (level 0 f0, level 0 f1, level 1 f0, ...): one sample per ray, every
    stride 1."""
    shape = x.shape
    feats = hash_encode_ray(table, *(a.reshape(-1, 1) for a in (x, y, z)),
                            cfg, (1,) * cfg.n_levels)
    return feats.reshape(*shape, cfg.out_dim)


def hash_encode(table: torch.Tensor, x: torch.Tensor,
                cfg: HashGridConfig) -> torch.Tensor:
    """Positions x [..., 3] in [0, 1]^3 -> features [..., L*F]."""
    return hash_encode_coords(table, x[..., 0], x[..., 1], x[..., 2], cfg)


# -- the point form with the position gradient (the sphere field's ``ad``) ------

def hash_encode_grad_plain(table: torch.Tensor, x: torch.Tensor,
                           cfg: HashGridConfig):
    """Points x [N, 3] in [0, 1] -> (feats [N, L*F], dfeats = d feats / d x
    [N, 3, L*F]), level-major; each feature and derivative sums its 8
    corners' table value x weight in JAX's order."""
    smooth = _smooth(cfg)
    feats, dfeats = [], []
    for lvl in range(cfg.n_levels):
        for f in range(cfg.n_features):
            acc, dacc = None, [None] * 3
            for idx, w, dws in _level_corners(
                    x[:, 0], x[:, 1], x[:, 2], cfg.level_res(lvl),
                    cfg.table_size, smooth, grad=True):
                v = table[lvl, f][idx]
                acc = v * w if acc is None else acc + v * w
                dacc = [v * d if s_ is None else s_ + v * d
                        for s_, d in zip(dacc, dws)]
            feats.append(acc)
            dfeats.append(torch.stack(dacc, -1))
    return torch.stack(feats, -1), torch.stack(dfeats, -1)


def hash_encode_grad_grad_plain(table_shape, x: torch.Tensor,
                                cfg: HashGridConfig, g_feats: torch.Tensor,
                                g_dfeats: torch.Tensor) -> torch.Tensor:
    """Table gradient [L, F, T] float32 of ``hash_encode_grad`` from the
    cotangents of both outputs: per corner and feature ((w * gf + dwx * gx)
    + dwy * gy) + dwz * gz, scatter-added in float32."""
    smooth = _smooth(cfg)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=x.device)
    for lvl in range(cfg.n_levels):
        for idx, w, dws in _level_corners(
                x[:, 0], x[:, 1], x[:, 2], cfg.level_res(lvl),
                cfg.table_size, smooth, grad=True):
            for f in range(cfg.n_features):
                col = lvl * cfg.n_features + f
                c = w * g_feats[:, col]
                for a in range(3):
                    c = c + dws[a] * g_dfeats[:, a, col]
                gt[lvl, f].scatter_add_(0, idx, c)
    return gt


def _check_grad_args(cfg: HashGridConfig, table_shape, x: torch.Tensor):
    if not _smooth(cfg):
        raise ValueError("the hash_encode_grad kernels are built for "
                         "smoothstep interpolation (the sphere field's) only")
    if tuple(table_shape) != (cfg.n_levels, 2, cfg.table_size):
        raise ValueError("hash_encode_grad kernel takes a [L, 2, T] table (2 "
                         f"features), got {tuple(table_shape)}")
    cuda.check(x, "x", torch.float32, (None, 3))
    if x.shape[0] * cfg.n_levels >= 2 ** 31:
        raise ValueError("too many points: the kernel indexes (point, level) "
                         "in int32")


def level_table(cfg, device) -> torch.Tensor:
    """[L, 3] int32 ``level_lookup`` rows (res, lookup size, hashed) of a
    brick or hash grid on ``device``, for the kernels that locate points at
    every level; made once per grid."""
    return plan_tensor(tuple(cfg.level_lookup(l) for l in range(cfg.n_levels)),
                       device)


def hash_encode_grad_cuda(table: torch.Tensor, x: torch.Tensor,
                          cfg: HashGridConfig):
    _check_grad_args(cfg, table.shape, x)
    dev, n, width = x.device, x.shape[0], cfg.out_dim
    table = table.contiguous()
    cuda.check(table, "table", torch.float32, None, dev)
    feats = torch.empty((n, width), dtype=torch.float32, device=dev)
    dfeats = torch.empty((n, 3, width), dtype=torch.float32, device=dev)
    _ENCODE_GRAD.launch(x.data_ptr(), n, table.data_ptr(), cfg.table_size,
                        level_table(cfg, dev).data_ptr(),
                        cfg.n_levels, feats.data_ptr(), dfeats.data_ptr())
    return feats, dfeats


def hash_encode_grad_grad_cuda(table_shape, x: torch.Tensor,
                               cfg: HashGridConfig, g_feats: torch.Tensor,
                               g_dfeats: torch.Tensor) -> torch.Tensor:
    _check_grad_args(cfg, table_shape, x)
    dev, n, width = x.device, x.shape[0], cfg.out_dim
    # the kernel reads float2
    g_feats, g_dfeats = (g if g.data_ptr() % 8 == 0 else g.clone()
                         for g in (g_feats.contiguous(), g_dfeats.contiguous()))
    cuda.check(g_feats, "g_feats", torch.float32, (n, width), dev)
    cuda.check(g_dfeats, "g_dfeats", torch.float32, (n, 3, width), dev)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=dev)
    _ENCODE_GRAD_BWD.launch(x.data_ptr(), n, cfg.table_size,
                            level_table(cfg, dev).data_ptr(), cfg.n_levels,
                            g_feats.data_ptr(), g_dfeats.data_ptr(),
                            gt.data_ptr())
    return gt


_ENCODE_GRAD = cuda.register(cuda.CudaKernel(
    "hash_encode_grad", "hash_encode_grad.cu", "hash_encode_grad_fwd_launch",
    [cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P]))
_ENCODE_GRAD_BWD = cuda.register(cuda.CudaKernel(
    "hash_encode_grad_bwd", "hash_encode_grad.cu",
    "hash_encode_grad_bwd_launch",
    [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P, cuda.P]))


class HashEncodeGrad(torch.autograd.Function):
    """(feats, dfeats) of ``hash_encode_grad`` with the table gradient of
    both (first order; the points get none). CUDA tensors launch the
    kernels (smoothstep only), CPU tensors take the plain versions (linear
    or smoothstep)."""

    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.save_for_backward(x)
        ctx.cfg, ctx.table_shape = cfg, tuple(table.shape)
        if x.is_cuda:
            return hash_encode_grad_cuda(table, x, cfg)
        if x.device.type != "cpu":
            raise ValueError(f"hash_encode_grad: unsupported device {x.device}")
        return hash_encode_grad_plain(table, x, cfg)

    @staticmethod
    def backward(ctx, g_feats, g_dfeats):
        (x,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        fn = (hash_encode_grad_grad_cuda if x.is_cuda
              else hash_encode_grad_grad_plain)
        return fn(ctx.table_shape, x, ctx.cfg, g_feats, g_dfeats), None, None


def hash_encode_grad(table: torch.Tensor, x: torch.Tensor,
                     cfg: HashGridConfig):
    """Positions x [..., 3] in [0, 1]^3 -> (feats [..., L*F], d feats / d x
    [..., 3, L*F]), differentiable in the table (the features' and the
    derivatives' cotangents both reach it). The derivatives are computed
    forward, so the positions get no gradient: coordinates that require
    one are refused."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("hash_encode_grad gives the table gradient only "
                         "(d feats / d x comes as its second output, not "
                         "through autograd); detach the coordinates")
    shape = x.shape[:-1]
    feats, dfeats = HashEncodeGrad.apply(
        table, x.reshape(-1, 3).contiguous(), cfg)
    return (feats.reshape(*shape, cfg.out_dim),
            dfeats.reshape(*shape, 3, cfg.out_dim))
