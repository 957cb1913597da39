"""Spherical / equirectangular camera math (serving subset).

Counterpart of ``perf_tpu/core/camera.py:79-201`` with the same
conventions: world z-up; image coords (row_frac, col_frac) in [0, 1] at
pixel centres; pano coords (beta, alpha) with the top row at +pi/2 and the
leftmost column at +pi; perspective cameras OpenCV style (x right, y down,
z forward). All functions take explicit ``device`` / ``dtype`` where they
create tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .rays import Rays


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def apply_rot(pts: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate points [..., 3] by one 3x3 matrix, in full float32."""
    return torch.einsum("ij,...j->...i", rot, pts)


def img_coord_from_hw(h: int, w: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Pixel-centre image coords [h, w, 2] = (row_frac, col_frac)."""
    i = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    j = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    ii, jj = torch.meshgrid(i, j, indexing="ij")
    return torch.stack([ii, jj], dim=-1)


def img_to_pano_coord(coords: torch.Tensor) -> torch.Tensor:
    """(row, col) in [0, 1] -> (beta, alpha)."""
    y, x = coords[..., 0], coords[..., 1]
    return torch.stack([-(y - 0.5) * math.pi, -(x - 0.5) * 2.0 * math.pi],
                       dim=-1)


def pano_coord_to_direction(coords: torch.Tensor) -> torch.Tensor:
    beta, alpha = coords[..., 0], coords[..., 1]
    cb = torch.cos(beta)
    return torch.stack([torch.cos(alpha) * cb, torch.sin(alpha) * cb,
                        torch.sin(beta)], dim=-1)


def img_coord_to_pano_direction(coords: torch.Tensor) -> torch.Tensor:
    return pano_coord_to_direction(img_to_pano_coord(coords))


def cam_rays_cam_space(height: int, width: int = -1,
                       fovy: float = float(np.deg2rad(90.0)),
                       aspect_ratio: float = 1.0, device=None) -> torch.Tensor:
    """Unit direction grid [h, w, 3] of a pinhole camera; the pixel grid
    spans [-tan(fovy/2), tan(fovy/2)] with inclusive endpoints, z forward."""
    if width < 0:
        width = int(np.round(height * aspect_ratio))
    else:
        aspect_ratio = width / height
    span_y = float(np.tan(fovy * 0.5))
    span_x = span_y * aspect_ratio
    y = torch.linspace(-span_y, span_y, height, device=device)
    x = torch.linspace(-span_x, span_x, width, device=device)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    xyz = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1)
    return normalize(xyz)


def gen_pano_rays(pose: torch.Tensor, height: int = 512,
                  width: int = 1024) -> Rays:
    """Equirectangular rays [h, w] for a pano camera at ``pose`` (4x4 c2w),
    on ``pose``'s device."""
    dirs = img_coord_to_pano_direction(
        img_coord_from_hw(height, width, device=pose.device))
    rays_d = apply_rot(dirs, pose[:3, :3])
    rays_o = pose[:3, 3].expand(rays_d.shape).contiguous()
    return Rays(rays_o, rays_d)


def gen_pers_rays(pose: torch.Tensor, fov: float, res: int) -> Rays:
    """Perspective rays [res, res] for a pinhole camera at ``pose``."""
    dirs = cam_rays_cam_space(height=res, width=res, fovy=fov,
                              device=pose.device)
    rays_d = apply_rot(dirs, pose[:3, :3])
    rays_o = pose[:3, 3].expand(rays_d.shape).contiguous()
    return Rays(rays_o, rays_d)
