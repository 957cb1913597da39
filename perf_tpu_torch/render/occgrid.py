"""Dense binary occupancy grid over the [-1, 1]^3 AABB.

Counterpart of ``perf_tpu/render/occgrid.py:28-59``, in plain PyTorch: the
serving path only reads a grid (from the checkpoint); building one from
surface points is used by the tests and the smoke run. The kernel for it
comes with the training slice.
"""

from __future__ import annotations

import numpy as np
import torch


def world_to_voxel(x: torch.Tensor, res: int) -> torch.Tensor:
    """[-1, 1] world coords -> integer voxel coords (clip to +-0.999)."""
    return ((torch.clamp(x, -0.999, 0.999) * 0.5 + 0.5) * res).to(torch.int64)


def voxel_to_flat(v: torch.Tensor, res: int) -> torch.Tensor:
    return v[..., 0] * (res * res) + v[..., 1] * res + v[..., 2]


def occ_grid_from_points(pts: torch.Tensor, res: int = 256,
                         dilation: int = 1) -> torch.Tensor:
    """Binary occupancy [res^3] uint8 from surface points [N, 3]: each
    point's voxel and, with ``dilation=1``, its 26 one-voxel-shifted
    neighbours (points shifted by +-1/res in world space, then quantized)."""
    shift = dilation / res
    n_off = 2 * dilation + 1
    offsets = torch.from_numpy(
        np.stack(np.meshgrid(*([np.linspace(-shift, shift, n_off)] * 3),
                             indexing="ij"), -1).reshape(-1, 3)
        .astype(np.float32)).to(pts.device)
    grid = torch.zeros((res ** 3,), dtype=torch.uint8, device=pts.device)
    for k in range(offsets.shape[0]):
        flat = voxel_to_flat(world_to_voxel(pts + offsets[k], res), res)
        grid[flat] = 1
    return grid
