"""Brick-packed multiresolution grid: config, indexing and the plain encode.

Counterpart of ``perf_tpu/kernels/brickgrid.py:41-265, 313-448``. A level's corners
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
kernels (``csrc/brick_encode.cu``) for CUDA tensors, the plain versions
here for CPU tensors. Its forward kernel writes the lerped,
level-concatenated features [N, S, L*F] itself; its backward takes the
coarse points' cotangents (``hashgrid.lerp_levels_transpose``) and sums,
per warp of 32 consecutive points, the runs of points in one voxel, adding
each run's 8 corners with float4 atomics (the source says why). With run
caps (``run_caps``: ``TrainConfig.dedup_runs``) the encode is the run-dedup
form of ``brick_encode_ray_dedup`` (K12): on a level whose cap is below its
point count a point reads the row of the first point of its brick run,
the run ids clipped at the cap less 1 (``run_ids``, shared with the
snapshot composite), and its table gradient sums each run's bf16
contributions and rounds the sum to bf16 again; the ``brick_encode_dedup``
kernels (``csrc/brick_encode.cu``) for CUDA tensors. The
sphere distance field encodes all levels at once with the in-cell
derivatives of the features (``brick_encode_stacked_grad``): the
``brick_encode_grad`` kernels (``csrc/brick_encode_grad.cu``), forward and
backward, for CUDA tensors.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from . import cuda
from .hashgrid import (coarse_coords, kernel_plan, level_plan, level_table,
                       lerp_levels, lerp_levels_transpose, plan_tensor,
                       ray_kernel_plan)

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
    # 'linear' (the NGP field) or 'smoothstep' (the sphere field; only
    # brick_encode_stacked_grad reads it, and takes only smoothstep)
    interpolation: str = "linear"
    # the fused field_eval and occ_prune kernels take this grid
    fused_field: ClassVar[bool] = True

    @classmethod
    def sphere_field(cls, fine_res: int = 2048, n_levels: int = 16,
                     log2_bricks: int = 13, base_res: int = 16):
        """The sphere distance field's grid: the level ladder from
        ``base_res`` to ``fine_res``, smoothstep interpolation, 2^13 rows."""
        scale = float(np.exp(np.log(fine_res / base_res) / (n_levels - 1)))
        return cls(n_levels=n_levels, n_features=2, log2_bricks=log2_bricks,
                   base_res=base_res, per_level_scale=scale,
                   interpolation="smoothstep")

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

    @property
    def table_shape(self) -> tuple:
        return (self.n_levels, self.n_bricks, self.n_features * 64)

    def level_lookup(self, level: int) -> tuple:
        """(res, bricks per axis, hashed): the level's columns of the
        kernels' level plan."""
        return (self.level_res(level), self.level_bricks(level),
                int(self.level_hashed(level)))

    def init_table(self, generator: torch.Generator, device=None):
        """[L, R, 64 * F] float32, Uniform(-1e-4, 1e-4)."""
        table = torch.rand(self.table_shape, generator=generator) * 2e-4 - 1e-4
        return table.to(device)

    def encode_coords(self, table, x, y, z) -> torch.Tensor:
        """Point form, coords [...] in [0, 1] -> [..., L*F]: the plain
        encode (CUDA points go through the fused kernels instead)."""
        return brick_encode(table, torch.stack([x, y, z], -1), self)

    encode_coords_plain = encode_coords

    def encode_ray(self, table, nx, ny, nz, strides: tuple,
                   run_caps: tuple | None = None) -> torch.Tensor:
        return brick_encode_ray(table, nx, ny, nz, self, strides, run_caps)


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


def _cells(x, y, z, res: int, nb: int, rows: int):
    """Each point's brick row ([...] int64), the first of its 8 corners in
    the row (the corner (lx, ly, lz)) and their weights (wx * wy) * wz in
    the kernel's (ox, oy, oz) order ([..., 8] float32)."""
    (bx, lx, fx), (by, ly, fy), (bz, lz, fz) = (
        axis_split(a, res) for a in (x, y, z))
    wx, wy, wz = (torch.stack([1.0 - f, f], dim=-1) for f in (fx, fy, fz))
    w = (wx[..., :, None, None] * wy[..., None, :, None]) * wz[..., None, None, :]
    return (brick_index(bx, by, bz, nb, rows), (lx * 4 + ly) * 4 + lz,
            w.reshape(w.shape[:-3] + (8,)))


def _corner_index(row, cell) -> torch.Tensor:
    """Flat indices [..., 8] into a level's [rows * 64] corners of the 8
    corners of ``cell`` in brick row ``row``."""
    return ((row * 64 + cell)[..., None]
            + torch.tensor(_CORNER_OFFSETS, device=row.device))


def encode_level(table: torch.Tensor, lvl: int, x, y, z,
                 cfg: BrickGridConfig, run_cap: int = 0) -> torch.Tensor:
    """One level at coords [...] in [0, 1] -> [..., F] float32 (the
    forward of ``corner_interp_lowp``): the 8 interpolation corners of each
    point's bf16 row, weighted and summed. JAX sums all 64 * F lanes of the
    row, 56 * F of them weighted 0. With ``run_cap`` (coords [N, P]
    t-ordered along P) each point reads its run's row instead of its own
    (``encode_brick_level_dedup``; ``run_rows``) at its own cell and
    fractions."""
    corners = table[lvl].to(torch.bfloat16).reshape(-1, cfg.n_features)
    row, cell, w = _cells(x, y, z, cfg.level_res(lvl), cfg.level_bricks(lvl),
                          table.shape[1])
    if run_cap:
        row = run_rows(row, run_cap)
    return (corners[_corner_index(row, cell)].float() * w[..., None]).sum(
        dim=-2)


def run_ids(rows: torch.Tensor, k: int) -> tuple:
    """Run dedup of points t-ordered along dim 1 (``encode_brick_level_dedup``
    and the dedup branch of ``_composite_snapshot``): rows [N, P] -> (rid
    [N, P], the count of row changes before each point clipped at k - 1;
    rep [N, k], candidate j's row, the row of point #{s : rid_s < j}
    clipped at the last point)."""
    change = (rows[:, 1:] != rows[:, :-1]).to(torch.int64)
    rid = torch.cat([change.new_zeros((rows.shape[0], 1)),
                     torch.cumsum(change, dim=1)], dim=1)
    rid = torch.clamp(rid, max=k - 1)
    cand = torch.arange(k, device=rows.device).expand(rows.shape[0], k)
    first = torch.searchsorted(rid, cand.contiguous())
    rep = torch.gather(rows, 1, torch.clamp(first, max=rows.shape[1] - 1))
    return rid, rep


def run_rows(rows: torch.Tensor, k: int) -> torch.Tensor:
    """The row each point reads with k run candidates, rep[rid], [N, P]: its
    own row while its run id is below k - 1, else the row of run k - 1."""
    rid, rep = run_ids(rows, k)
    return torch.gather(rep, 1, rid)


def dedup_caps(strides: tuple, n_samples: int, run_caps) -> tuple | None:
    """The run caps of one ray-form call of ``n_samples`` samples
    (``brick_encode_ray_dedup``): a level takes the dedup encode where its
    cap ``run_caps[l]`` (0 past the tuple's end) is not 0 and is below its
    point count, and gets 0 (the standard encode) elsewhere. None where no
    level takes it."""
    if not run_caps:
        return None
    caps = []
    for lvl, k in enumerate(strides):
        kr = run_caps[lvl] if lvl < len(run_caps) else 0
        npts = n_samples if k == 1 else n_samples // k + 1
        caps.append(kr if kr and kr < npts else 0)
    return tuple(caps) if any(caps) else None


def brick_encode(table: torch.Tensor, x: torch.Tensor,
                 cfg: BrickGridConfig) -> torch.Tensor:
    """Flat encode: x [..., 3] in [0, 1] -> [..., L*F] float32."""
    return torch.cat([encode_level(table, lvl, x[..., 0], x[..., 1],
                                   x[..., 2], cfg)
                      for lvl in range(cfg.n_levels)], dim=-1)


# -- the training encode: ray-structured, per-level strides, with gradient ---

def brick_points_plain(table: torch.Tensor, nx, ny, nz,
                       cfg: BrickGridConfig, strides: tuple,
                       caps: tuple | None = None) -> torch.Tensor:
    """Features [points, F] of every level's points, level after level;
    ``caps`` (``dedup_caps``) reads the dedup levels' run rows."""
    return torch.cat([
        encode_level(table, lvl, *(coarse_coords(a, k) for a in (nx, ny, nz)),
                     cfg, caps[lvl] if caps else 0).reshape(-1, cfg.n_features)
        for lvl, k in enumerate(strides)])


def brick_points_grad_plain(table_shape, nx, ny, nz, cfg: BrickGridConfig,
                            strides: tuple, grad: torch.Tensor,
                            caps: tuple | None = None):
    """Table gradient [L, R, 64*F] float32 from the points' cotangents
    [points, F] (``_ci_bwd``): each corner's w * g rounded to bf16, then
    scatter-added in float32. A level with a cap in ``caps`` takes
    ``_cid_bwd``'s rule: the rounded contributions of each (ray, run)
    summed in float32, the sum rounded to bf16 again, then added to the
    run's row. On the CPU a run is summed in its points' order, the
    kernel's; ``index_add_`` on a GPU sums it in any order, and where the
    second rounding meets a tie the entry moves by one bf16 ulp of the
    run's sum."""
    n, s = nx.shape
    nf = cfg.n_features
    plan, _ = level_plan(cfg, strides, n, s)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=grad.device)
    for lvl, (res, nb, _, k, npts, first) in enumerate(plan):
        xs, ys, zs = (coarse_coords(a, k) for a in (nx, ny, nz))
        g = grad[first:first + n * npts].reshape(n, npts, 1, nf)
        row, cell, w = _cells(xs, ys, zs, res, nb, table_shape[1])
        contrib = (w[..., None] * g).to(torch.bfloat16).float()
        kr = caps[lvl] if caps else 0
        if not kr:
            gt[lvl].view(-1, nf).index_add_(
                0, _corner_index(row, cell).reshape(-1),
                contrib.reshape(-1, nf))
            continue
        rid, rep = run_ids(row, kr)
        slot = torch.arange(n, device=rid.device)[:, None] * kr + rid
        idx = _corner_index(slot, cell)
        runs = torch.zeros((n * kr * 64, nf), dtype=torch.float32,
                           device=grad.device)
        runs.index_add_(0, idx.reshape(-1), contrib.reshape(-1, nf))
        dst = (rep * 64)[..., None] + torch.arange(64, device=rep.device)
        gt[lvl].view(-1, nf).index_add_(0, dst.reshape(-1),
                                        runs.to(torch.bfloat16).float())
    return gt


def _check_table(cfg: BrickGridConfig, table_shape):
    if tuple(table_shape) != (cfg.n_levels, cfg.n_bricks, 128):
        raise ValueError("brick_encode kernel takes a [L, rows, 128] table "
                         f"(2 features), got {tuple(table_shape)}")


def _check_coords(nx, ny, nz):
    for name, a in (("nx", nx), ("ny", ny), ("nz", nz)):
        cuda.check(a, name, torch.float32, tuple(nx.shape), nx.device)


def _check_caps(cfg: BrickGridConfig, caps: tuple):
    if len(caps) != cfg.n_levels or min(caps) < 0:
        raise ValueError(f"run caps {caps}: one cap >= 0 a level "
                         f"({cfg.n_levels} levels)")


def brick_encode_ray_plain(table: torch.Tensor, nx, ny, nz,
                           cfg: BrickGridConfig, strides: tuple,
                           caps: tuple | None = None) -> torch.Tensor:
    """The plain ray form: coords [N, S] -> [N, S, L*F], every level's
    coarse points encoded, lerped back to the S samples and concatenated
    (JAX's ``brick_encode_ray``; with ``caps``, ``brick_encode_ray_dedup``)."""
    n, s = nx.shape
    plan, _ = level_plan(cfg, strides, n, s)
    return lerp_levels(brick_points_plain(table, nx, ny, nz, cfg, strides,
                                          caps), plan, n, s)


def _forward_args(table: torch.Tensor, nx, ny, nz, cfg: BrickGridConfig,
                  strides: tuple) -> tuple:
    """(level plan, coarse points a ray, bf16 table, output [N, S, L*F]) of
    a forward launch, checked."""
    _check_coords(nx, ny, nz)
    _check_table(cfg, table.shape)
    levels, per_ray = ray_kernel_plan(cfg, strides, nx)
    tbf = table.to(torch.bfloat16).contiguous()
    cuda.check(tbf, "table", torch.bfloat16,
               (cfg.n_levels, cfg.n_bricks, 128), nx.device)
    n, s = nx.shape
    out = torch.empty((n, s, cfg.out_dim), dtype=torch.float32,
                      device=nx.device)
    return levels, per_ray, tbf, out


def brick_encode_ray_cuda(table: torch.Tensor, nx, ny, nz,
                          cfg: BrickGridConfig,
                          strides: tuple) -> torch.Tensor:
    levels, per_ray, tbf, out = _forward_args(table, nx, ny, nz, cfg, strides)
    n, s = nx.shape
    _ENCODE.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), n, s, per_ray,
                   tbf.data_ptr(), cfg.n_bricks, levels.data_ptr(),
                   cfg.n_levels, out.data_ptr())
    return out


def brick_encode_ray_dedup_cuda(table: torch.Tensor, nx, ny, nz,
                                cfg: BrickGridConfig, strides: tuple,
                                caps: tuple) -> torch.Tensor:
    """The run-dedup forward (``caps`` from ``dedup_caps``; a level of cap
    0 is encoded the standard way in the same launch)."""
    _check_caps(cfg, caps)
    levels, per_ray, tbf, out = _forward_args(table, nx, ny, nz, cfg, strides)
    n, s = nx.shape
    _ENCODE_DEDUP.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), n, s,
                         per_ray, tbf.data_ptr(), cfg.n_bricks,
                         levels.data_ptr(),
                         plan_tensor(tuple(caps), nx.device).data_ptr(),
                         cfg.n_levels, out.data_ptr())
    return out


def _backward_args(table_shape, nx, ny, nz, cfg: BrickGridConfig,
                   strides: tuple, grad: torch.Tensor) -> tuple:
    """(level plan, the points' cotangents [points, 2] 8-byte aligned, the
    zeroed table gradient) of a backward launch, checked."""
    _check_table(cfg, table_shape)
    levels, total = kernel_plan(cfg, strides, nx)
    _check_coords(nx, ny, nz)
    if nx.numel() >= 2 ** 31:
        raise ValueError(f"{nx.numel()} samples: the backward indexes "
                         "samples in int32")
    grad = grad.contiguous()
    if grad.data_ptr() % 8:           # the kernel reads a point's pair as float2
        grad = grad.clone()
    cuda.check(grad, "grad", torch.float32, (total, 2), nx.device)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=nx.device)
    return levels, total, grad, gt


def brick_points_grad_cuda(table_shape, nx, ny, nz, cfg: BrickGridConfig,
                           strides: tuple, grad: torch.Tensor):
    levels, total, grad, gt = _backward_args(table_shape, nx, ny, nz, cfg,
                                             strides, grad)
    _ENCODE_BWD.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(),
                       nx.shape[1], cfg.n_bricks, levels.data_ptr(),
                       cfg.n_levels, total, grad.data_ptr(), gt.data_ptr())
    return gt


def brick_points_dedup_grad_cuda(table_shape, nx, ny, nz,
                                 cfg: BrickGridConfig, strides: tuple,
                                 grad: torch.Tensor, caps: tuple):
    """The run-dedup backward of every level of the call (cap 0: the
    standard rule)."""
    _check_caps(cfg, caps)
    levels, _, grad, gt = _backward_args(table_shape, nx, ny, nz, cfg,
                                         strides, grad)
    n, s = nx.shape
    _ENCODE_DEDUP_BWD.launch(nx.data_ptr(), ny.data_ptr(), nz.data_ptr(), n, s,
                             cfg.n_bricks, levels.data_ptr(),
                             plan_tensor(tuple(caps), nx.device).data_ptr(),
                             cfg.n_levels, grad.data_ptr(), gt.data_ptr())
    return gt


def _register():
    args = [cuda.P, cuda.P, cuda.P, cuda.I32]
    fwd = cuda.register(cuda.CudaKernel(
        "brick_encode", "brick_encode.cu", "brick_encode_fwd_launch",
        args + [cuda.I32, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.I32,
                cuda.P]))
    bwd = cuda.register(cuda.CudaKernel(
        "brick_encode_bwd", "brick_encode.cu", "brick_encode_bwd_launch",
        args + [cuda.I32, cuda.P, cuda.I32, cuda.I64, cuda.P, cuda.P]))
    dedup = cuda.register(cuda.CudaKernel(
        "brick_encode_dedup", "brick_encode.cu",
        "brick_encode_dedup_fwd_launch",
        args + [cuda.I32, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P,
                cuda.I32, cuda.P]))
    dedup_bwd = cuda.register(cuda.CudaKernel(
        "brick_encode_dedup_bwd", "brick_encode.cu",
        "brick_encode_dedup_bwd_launch",
        args + [cuda.I32, cuda.I32, cuda.P, cuda.P, cuda.I32, cuda.P,
                cuda.P]))
    return fwd, bwd, dedup, dedup_bwd


_ENCODE, _ENCODE_BWD, _ENCODE_DEDUP, _ENCODE_DEDUP_BWD = _register()


class BrickEncode(torch.autograd.Function):
    """Features [N, S, L*F] of ray-structured coordinates [N, S] with the
    table gradient (``brick_encode_ray`` with ``corner_interp_lowp``'s
    VJP; with ``caps``, ``brick_encode_ray_dedup`` with
    ``corner_interp_dedup``'s); the coordinates get no gradient. CUDA
    tensors launch the kernels (``brick_encode`` / ``brick_encode_bwd``,
    or with caps ``brick_encode_dedup`` / ``brick_encode_dedup_bwd``), CPU
    tensors take the plain versions; the backward forms the coarse points'
    cotangents (``lerp_levels_transpose``) and scatters them."""

    @staticmethod
    def forward(ctx, table, nx, ny, nz, cfg, strides, caps=None):
        ctx.save_for_backward(nx, ny, nz)
        ctx.cfg, ctx.strides, ctx.caps = cfg, strides, caps
        ctx.table_shape = table.shape
        if nx.is_cuda:
            if caps:
                return brick_encode_ray_dedup_cuda(table, nx, ny, nz, cfg,
                                                   strides, caps)
            return brick_encode_ray_cuda(table, nx, ny, nz, cfg, strides)
        if nx.device.type != "cpu":
            raise ValueError(f"brick_encode: unsupported device {nx.device}")
        return brick_encode_ray_plain(table, nx, ny, nz, cfg, strides, caps)

    @staticmethod
    def backward(ctx, grad):
        nx, ny, nz = ctx.saved_tensors
        n, s = nx.shape
        cfg, strides, caps = ctx.cfg, ctx.strides, ctx.caps
        plan, total = level_plan(cfg, strides, n, s)
        g = lerp_levels_transpose(grad, plan, n, s, total)
        if not grad.is_cuda:
            gt = brick_points_grad_plain(ctx.table_shape, nx, ny, nz, cfg,
                                         strides, g, caps)
        elif caps:
            gt = brick_points_dedup_grad_cuda(ctx.table_shape, nx, ny, nz,
                                              cfg, strides, g, caps)
        else:
            gt = brick_points_grad_cuda(ctx.table_shape, nx, ny, nz, cfg,
                                        strides, g)
        return gt, None, None, None, None, None, None


def brick_encode_ray(table: torch.Tensor, nx, ny, nz, cfg: BrickGridConfig,
                     strides: tuple,
                     run_caps: tuple | None = None) -> torch.Tensor:
    """Ray-structured encode: normalised coords [N, S] -> [N, S, L*F]. Level
    l is evaluated at its strided points and lerped back to all S samples
    (``brick_encode_ray``). ``run_caps`` (samples t-ordered along S, as the
    march gives them) switches the levels ``dedup_caps`` picks to the
    run-dedup encode (``brick_encode_ray_dedup``); it gives the table
    gradient only, so coordinates that require a gradient are refused
    there."""
    strides = tuple(strides)
    caps = dedup_caps(strides, nx.shape[1], run_caps)
    if caps and torch.is_grad_enabled() and any(
            a.requires_grad for a in (nx, ny, nz)):
        raise ValueError("the run-dedup encode gives the table gradient "
                         "only; detach the coordinates")
    nx, ny, nz = (a.contiguous() for a in (nx, ny, nz))
    return BrickEncode.apply(table, nx, ny, nz, cfg, strides, caps)


# -- the stacked encode with derivatives (the sphere field) ------------------

def _check_smoothstep(cfg: BrickGridConfig):
    if cfg.interpolation != "smoothstep":
        raise ValueError("the encode with derivatives takes only smoothstep "
                         f"interpolation (the sphere field's), got "
                         f"{cfg.interpolation!r}")


def _grad_corners(x: torch.Tensor, cfg: BrickGridConfig, rows: int):
    """Every level at points x [N, 3] at once: (flat corner index into the
    [L * rows * 64] corners, [L, N, 8]; weights [4, L, N, 8]: the trilinear
    weight and the three derivative weights, each (a * b) * c; chains [3,
    L, N]: d fraction / d x), in ``brick_encode_stacked_grad``'s operation
    order."""
    _check_smoothstep(cfg)
    dev = x.device
    lv = range(cfg.n_levels)
    res = torch.tensor([float(cfg.level_res(l)) for l in lv],
                       device=dev)[:, None]
    nb = torch.tensor([cfg.level_bricks(l) for l in lv], device=dev)[:, None]
    hashed = torch.tensor([cfg.level_hashed(l) for l in lv], device=dev)
    parts = []
    for a in range(3):
        xa = x[None, :, a]
        pos = torch.clamp(xa, 0.0, 1.0) * res
        c0f = torch.minimum(torch.clamp(torch.floor(pos), min=0.0), res - 1)
        fr = pos - c0f
        dfr = res * ((xa > 0.0) & (xa < 1.0)) * 6.0 * fr * (1.0 - fr)
        fr = fr * fr * (3.0 - 2.0 * fr)
        c0 = c0f.to(torch.int64)
        b = torch.div(c0, BRICK, rounding_mode="floor")
        parts.append((b, c0 - b * BRICK, fr, dfr))
    (bx, lx, fx, cx), (by, ly, fy, cy), (bz, lz, fz, cz) = parts
    dense = bx * (nb * nb) + by * nb + bz
    hsh = (((bx * PRIMES[0]) & _U32) ^ ((by * PRIMES[1]) & _U32)
           ^ ((bz * PRIMES[2]) & _U32)) & (rows - 1)
    row = torch.where(hashed[:, None], hsh, dense)
    level0 = torch.arange(cfg.n_levels, device=dev)[:, None] * rows
    first = (row + level0) * 64 + (lx * 4 + ly) * 4 + lz
    idx = first[..., None] + torch.tensor(_CORNER_OFFSETS, device=dev)
    one = torch.ones_like(fx)
    (wx, dx), (wy, dy), (wz, dz) = (
        (torch.stack([1.0 - f, f], -1), torch.stack([-one, one], -1))
        for f in (fx, fy, fz))

    def prod(ax, ay, az):
        w = ((ax[..., :, None, None] * ay[..., None, :, None])
             * az[..., None, None, :])
        return w.reshape(*w.shape[:-3], 8)

    w = torch.stack([prod(wx, wy, wz), prod(dx, wy, wz), prod(wx, dy, wz),
                     prod(wx, wy, dz)])
    return idx, w, torch.stack([cx, cy, cz])


def brick_encode_grad_plain(table: torch.Tensor, x: torch.Tensor,
                            cfg: BrickGridConfig):
    """x [N, 3] in [0, 1] -> (feats [N, L*F], dfeats [N, 3, L*F]) from the
    bf16 table (``corner_interp_grad_lowp`` forward and the chain of
    ``brick_encode_stacked_grad``), level-major."""
    nf, n = cfg.n_features, x.shape[0]
    corners = table.to(torch.bfloat16).reshape(-1, nf)
    idx, w, chain = _grad_corners(x, cfg, table.shape[1])
    v = corners[idx].float()                              # [L, N, 8, F]
    red = (v[None] * w[..., None]).sum(dim=-2)            # [4, L, N, F]
    feats = red[0].permute(1, 0, 2).reshape(n, cfg.out_dim)
    dfeats = (red[1:] * chain[..., None]).permute(2, 0, 1, 3)
    return feats, dfeats.reshape(n, 3, cfg.out_dim)


def brick_encode_grad_grad_plain(table_shape, x: torch.Tensor,
                                 cfg: BrickGridConfig, g_feats: torch.Tensor,
                                 g_dfeats: torch.Tensor) -> torch.Tensor:
    """Table gradient [L, R, 64*F] float32 (``_cig_bwd``): per corner the
    feature cotangent and the three chained derivative cotangents combined
    in float32, rounded to bf16 once, scatter-added in float32."""
    nf, n, nl = cfg.n_features, x.shape[0], cfg.n_levels
    idx, w, chain = _grad_corners(x, cfg, table_shape[1])
    gf = g_feats.reshape(n, nl, nf).permute(1, 0, 2)              # [L, N, F]
    gd = g_dfeats.reshape(n, 3, nl, nf).permute(1, 2, 0, 3)       # [3, L, N, F]
    gs = [gf] + [gd[a] * chain[a][..., None] for a in range(3)]
    cot = w[0][..., None] * gs[0][..., None, :]
    for k in (1, 2, 3):
        cot = cot + w[k][..., None] * gs[k][..., None, :]
    gt = torch.zeros(table_shape, dtype=torch.float32, device=x.device)
    gt.view(-1, nf).index_add_(0, idx.reshape(-1),
                               cot.to(torch.bfloat16).float().reshape(-1, nf))
    return gt


def _check_grad_args(table_shape, x: torch.Tensor, cfg: BrickGridConfig):
    _check_smoothstep(cfg)
    if tuple(table_shape) != (cfg.n_levels, cfg.n_bricks, 128):
        raise ValueError("brick_encode_grad kernel takes a [L, rows, 128] "
                         f"table (2 features), got {tuple(table_shape)}")
    cuda.check(x, "x", torch.float32, (None, 3))
    if x.shape[0] * cfg.n_levels * 6 >= 2 ** 62:
        raise ValueError("too many points")


def brick_encode_grad_cuda(table: torch.Tensor, x: torch.Tensor,
                           cfg: BrickGridConfig):
    _check_grad_args(table.shape, x, cfg)
    dev, n, width = x.device, x.shape[0], cfg.out_dim
    tbf = table.to(torch.bfloat16).contiguous()
    cuda.check(tbf, "table", torch.bfloat16, None, dev)
    feats = torch.empty((n, width), dtype=torch.float32, device=dev)
    dfeats = torch.empty((n, 3, width), dtype=torch.float32, device=dev)
    _ENCODE_GRAD.launch(x.data_ptr(), n, tbf.data_ptr(), cfg.n_bricks,
                        level_table(cfg, dev).data_ptr(), cfg.n_levels,
                        feats.data_ptr(), dfeats.data_ptr())
    return feats, dfeats


def brick_encode_grad_grad_cuda(table_shape, x: torch.Tensor,
                                cfg: BrickGridConfig, g_feats: torch.Tensor,
                                g_dfeats: torch.Tensor) -> torch.Tensor:
    _check_grad_args(table_shape, x, cfg)
    dev, n, width = x.device, x.shape[0], cfg.out_dim
    g_feats, g_dfeats = g_feats.contiguous(), g_dfeats.contiguous()
    cuda.check(g_feats, "g_feats", torch.float32, (n, width), dev)
    cuda.check(g_dfeats, "g_dfeats", torch.float32, (n, 3, width), dev)
    gt = torch.zeros(table_shape, dtype=torch.float32, device=dev)
    _ENCODE_GRAD_BWD.launch(x.data_ptr(), n, cfg.n_bricks,
                            level_table(cfg, dev).data_ptr(), cfg.n_levels,
                            g_feats.data_ptr(), g_dfeats.data_ptr(),
                            gt.data_ptr())
    return gt


_ENCODE_GRAD = cuda.register(cuda.CudaKernel(
    "brick_encode_grad", "brick_encode_grad.cu",
    "brick_encode_grad_fwd_launch",
    [cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P]))
_ENCODE_GRAD_BWD = cuda.register(cuda.CudaKernel(
    "brick_encode_grad_bwd", "brick_encode_grad.cu",
    "brick_encode_grad_bwd_launch",
    [cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I32, cuda.P, cuda.P, cuda.P]))


class BrickEncodeGrad(torch.autograd.Function):
    """(feats, dfeats) of ``brick_encode_stacked_grad`` with the table
    gradient of both (first order; the points get no gradient)."""

    @staticmethod
    def forward(ctx, table, x, cfg):
        ctx.save_for_backward(x)
        ctx.cfg, ctx.table_shape = cfg, tuple(table.shape)
        if x.is_cuda:
            return brick_encode_grad_cuda(table, x, cfg)
        if x.device.type != "cpu":
            raise ValueError(f"brick_encode_grad: unsupported device {x.device}")
        return brick_encode_grad_plain(table, x, cfg)

    @staticmethod
    def backward(ctx, g_feats, g_dfeats):
        (x,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        fn = (brick_encode_grad_grad_cuda if x.is_cuda
              else brick_encode_grad_grad_plain)
        return fn(ctx.table_shape, x, ctx.cfg, g_feats, g_dfeats), None, None


def brick_encode_stacked_grad(table: torch.Tensor, x: torch.Tensor,
                              cfg: BrickGridConfig):
    """x [..., 3] in [0, 1] -> (feats [..., L*F], dfeats / dx [..., 3,
    L*F]), differentiable in the table."""
    shape = x.shape[:-1]
    feats, dfeats = BrickEncodeGrad.apply(
        table, x.detach().reshape(-1, 3).contiguous(), cfg)
    return (feats.reshape(*shape, cfg.out_dim),
            dfeats.reshape(*shape, 3, cfg.out_dim))
