"""Brick-packed multiresolution grid: config, indexing and the plain encode.

Counterpart of ``perf_tpu/kernels/brickgrid.py:41-265``. A level's corners
are packed into overlapping 4x4x4-corner bricks on a stride-3 grid; one
row of a level's table holds a whole brick, feature-interleaved
(lane = ((cx*4 + cy)*4 + cz)*F + f). Any voxel's 8 interpolation corners lie
in one row. Rows are dense when a level's bricks fit the table, else a
uint32 prime hash of the brick coordinates.

This module holds the plain PyTorch version of the forward encode (the
table is read as bf16, as ``corner_interp_lowp`` reads it). On the serving
path the encode runs fused with the MLPs inside the ``field_eval`` CUDA
kernel (``fields/ngp.py``); the functions here are its reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
BRICK = 3          # voxels per brick edge
BLANE = 4          # corners per brick edge (overlap 1)
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


def lane_axes(width: int, nf: int, device=None):
    """Lane index -> (corner-x, corner-y, corner-z, feature)."""
    lanes = torch.arange(width, dtype=torch.int64, device=device)
    return (lanes // (16 * nf), (lanes // (4 * nf)) % 4,
            (lanes // nf) % 4, lanes % nf)


def _axis_sel(a, loc, frac):
    """Per-lane weight on one axis: 1-frac at loc, frac at loc+1, else 0."""
    loc = loc[..., None]
    frac = frac[..., None]
    return (a == loc) * (1.0 - frac) + (a == loc + 1) * frac


def interp_from_rows(row_vals: torch.Tensor, locs, fracs, nf: int) -> tuple:
    """row_vals [..., 64*F] -> tuple of F feature tensors [...]: factored
    trilinear lane weights, multiply, reduce (``_interp_from_rows``)."""
    width = row_vals.shape[-1]
    ax, ay, az, af = lane_axes(width, nf, row_vals.device)
    w_lane = (_axis_sel(ax, locs[0], fracs[0])
              * _axis_sel(ay, locs[1], fracs[1])
              * _axis_sel(az, locs[2], fracs[2]))
    vals = row_vals.float() * w_lane
    return tuple(torch.sum(vals * (af == f), dim=-1) for f in range(nf))


def encode_brick_level(table_l: torch.Tensor, level_res: int, nb: int,
                       x, y, z, n_features: int = 2) -> list:
    """One level: table_l [rows, 64*F] (read as bf16); coords [...] in
    [0, 1] -> F tensors shaped like x."""
    bx, lx, fx = axis_split(x, level_res)
    by, ly, fy = axis_split(y, level_res)
    bz, lz, fz = axis_split(z, level_res)
    rows = brick_index(bx, by, bz, nb, table_l.shape[0])
    vals = table_l.to(torch.bfloat16)[rows]
    return list(interp_from_rows(vals, (lx, ly, lz), (fx, fy, fz),
                                 n_features))


def brick_encode(table: torch.Tensor, x: torch.Tensor,
                 cfg: BrickGridConfig) -> torch.Tensor:
    """Flat encode: x [..., 3] in [0, 1] -> [..., L*F] float32."""
    outs = []
    for lvl in range(cfg.n_levels):
        outs.extend(encode_brick_level(
            table[lvl], cfg.level_res(lvl), cfg.level_bricks(lvl),
            x[..., 0], x[..., 1], x[..., 2], cfg.n_features))
    return torch.stack(outs, dim=-1)
