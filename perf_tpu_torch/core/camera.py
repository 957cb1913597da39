"""Spherical / equirectangular camera math.

Counterpart of ``perf_tpu/core/camera.py:60-201`` with the same
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


def look_at(to_vec: torch.Tensor, up_vec: torch.Tensor | None = None):
    """c2w rotations [..., 3, 3] whose +z axis is ``to_vec``; columns
    (right, down, forward), default up +z."""
    to_vec = normalize(to_vec)
    if up_vec is None:
        up_vec = torch.tensor([0.0, 0.0, 1.0], dtype=to_vec.dtype,
                              device=to_vec.device).expand(to_vec.shape)
    down_vec = -up_vec
    ri_vec = normalize(torch.linalg.cross(down_vec, to_vec))
    down_vec = torch.linalg.cross(to_vec, ri_vec)
    return torch.stack([ri_vec, down_vec, to_vec], dim=-1)


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


def pano_to_img_coord(coords: torch.Tensor) -> torch.Tensor:
    """(beta, alpha) -> (row, col) in [0, 1]."""
    beta, alpha = coords[..., 0], coords[..., 1]
    return torch.stack([-beta / math.pi + 0.5,
                        -alpha / (2.0 * math.pi) + 0.5], dim=-1)


def direction_to_pano_coord(dirs: torch.Tensor) -> torch.Tensor:
    dirs = normalize(dirs)
    beta = torch.arcsin(torch.clamp(dirs[..., 2], -1.0, 1.0))
    alpha = torch.atan2(dirs[..., 1], dirs[..., 0])
    return torch.stack([beta, alpha], dim=-1)


def direction_to_img_coord(dirs: torch.Tensor) -> torch.Tensor:
    return pano_to_img_coord(direction_to_pano_coord(dirs))


def direction_to_pers_img_coord(dirs: torch.Tensor, to_vec, down_vec,
                                right_vec, eps: float = 1e-5):
    """World directions [..., 3] projected into a tangent-plane camera
    (``to_vec`` to the plane centre, half-extent ``down_vec`` /
    ``right_vec`` in the plane): image coords [..., 2] (row, col) in
    [0, 1] and a float mask [..., 1], 1 inside the view frustum."""
    dirs = normalize(dirs)
    to_len = torch.linalg.norm(to_vec, dim=-1, keepdim=True)
    to_u = to_vec / to_len
    down_u = down_vec / to_len
    right_u = right_vec / to_len
    down_len2 = torch.sum(down_u * down_u, dim=-1, keepdim=True)
    right_len2 = torch.sum(right_u * right_u, dim=-1, keepdim=True)
    proj = torch.sum(dirs * to_u, dim=-1, keepdim=True)
    mask = proj > eps
    dirs = dirs / torch.clamp(proj, min=eps)
    i = torch.sum((dirs - to_u) * down_u, dim=-1, keepdim=True) / down_len2
    j = torch.sum((dirs - to_u) * right_u, dim=-1, keepdim=True) / right_len2
    mask = (mask & (torch.abs(i) <= 1.0) & (torch.abs(j) <= 1.0)).to(
        dirs.dtype)
    return (torch.cat([i, j], dim=-1) + 1.0) * 0.5, mask


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
