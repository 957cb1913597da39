"""Dense binary occupancy grid over the [-1, 1]^3 AABB.

Counterpart of ``perf_tpu/render/occgrid.py:28-59``. ``occ_grid_from_points``
builds the supervision pool's grid (``SupInfoPool.gen_occ_grid``): the
``occ_grid`` CUDA kernel (``kernels/csrc/occ_grid.cu``) for CUDA tensors,
``occ_grid_from_points_plain`` for CPU tensors; the two are bitwise equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import cuda


def world_to_voxel(x: torch.Tensor, res: int) -> torch.Tensor:
    """[-1, 1] world coords -> integer voxel coords (clip to +-0.999)."""
    return ((torch.clamp(x, -0.999, 0.999) * 0.5 + 0.5) * res).to(torch.int64)


def voxel_to_flat(v: torch.Tensor, res: int) -> torch.Tensor:
    return v[..., 0] * (res * res) + v[..., 1] * res + v[..., 2]


def dilation_offsets(res: int, dilation: int, device=None) -> torch.Tensor:
    """The (2*dilation+1)^3 world-space shifts [K, 3] float32, as JAX builds
    them (float64 linspace, then float32)."""
    shift = dilation / res
    n_off = 2 * dilation + 1
    return torch.from_numpy(
        np.stack(np.meshgrid(*([np.linspace(-shift, shift, n_off)] * 3),
                             indexing="ij"), -1).reshape(-1, 3)
        .astype(np.float32)).to(device)


def occ_grid_from_points_plain(pts: torch.Tensor, res: int = 256,
                               dilation: int = 1) -> torch.Tensor:
    offsets = dilation_offsets(res, dilation, pts.device)
    grid = torch.zeros((res ** 3,), dtype=torch.uint8, device=pts.device)
    for k in range(offsets.shape[0]):
        flat = voxel_to_flat(world_to_voxel(pts + offsets[k], res), res)
        grid[flat] = 1
    return grid


_OCC = cuda.register(cuda.CudaKernel(
    "occ_grid", "occ_grid.cu", "occ_grid_launch",
    [cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.I32, cuda.P],
    extra_flags=("-fmad=false",)))


def occ_grid_from_points_cuda(pts: torch.Tensor, res: int = 256,
                              dilation: int = 1) -> torch.Tensor:
    cuda.check(pts, "pts", torch.float32, (None, 3))
    offsets = dilation_offsets(res, dilation, pts.device)
    grid = torch.zeros((res ** 3,), dtype=torch.uint8, device=pts.device)
    _OCC.launch(pts.data_ptr(), pts.shape[0], offsets.data_ptr(),
                offsets.shape[0], res, grid.data_ptr())
    return grid


def occ_grid_from_points(pts: torch.Tensor, res: int = 256,
                         dilation: int = 1) -> torch.Tensor:
    """Binary occupancy [res^3] uint8 from surface points [N, 3]: each
    point's voxel and, with ``dilation=1``, its 26 one-voxel-shifted
    neighbours (points shifted by +-1/res in world space, then quantised).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if pts.is_cuda:
        return occ_grid_from_points_cuda(pts, res, dilation)
    if pts.device.type != "cpu":
        raise ValueError(f"occ_grid_from_points: unsupported {pts.device}")
    return occ_grid_from_points_plain(pts, res, dilation)
