"""Synthetic scenes: the analytic cube room and seeded random fields.

Counterpart of ``perf_tpu/utils/synthetic.py:18-61`` (the cube room: walls
of a cube of half-extent ``room`` around the origin, with a smooth
procedural texture), plus the seeded scene that the tests and
``chip_smoke.py`` serve when no trained checkpoint exists: NumPy-drawn
field parameters in the JAX layout and the cube room's occupancy grid.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import gen_pano_rays
from ..fields.ngp import NGPFieldConfig
from ..render.occgrid import occ_grid_from_points


def cube_room_hit(o: torch.Tensor, d: torch.Tensor, room: float = 0.8):
    """Distance and inward normal of the first cube-wall hit (o inside)."""
    eps = 1e-9
    safe_d = torch.where(torch.abs(d) < eps, torch.full_like(d, eps), d)
    t_axis = (torch.sign(safe_d) * room - o) / safe_d
    t, axis = torch.min(t_axis, dim=-1, keepdim=True)
    sign = torch.gather(torch.sign(safe_d), -1, axis)
    normal = -sign * torch.eye(3, device=d.device)[axis[..., 0]]
    return t, normal


def cube_room_color(pts: torch.Tensor) -> torch.Tensor:
    """Smooth procedural wall texture in [0, 1]."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    return torch.stack([0.5 + 0.5 * torch.sin(6.0 * x + 2.0 * y),
                        0.5 + 0.5 * torch.sin(5.0 * y + 3.0 * z),
                        0.5 + 0.5 * torch.sin(4.0 * z + 7.0 * x)], dim=-1)


def render_cube_room_pano(pose: torch.Tensor, height: int, width: int,
                          room: float = 0.8) -> dict:
    """Ground-truth RGB-D-N pano of the cube room from ``pose``."""
    rays = gen_pano_rays(pose, height, width)
    t, normal = cube_room_hit(rays.o, rays.d, room)
    pts = rays.o + rays.d * t
    return {"rgb": cube_room_color(pts), "distance": t, "normal": normal}


def cube_room_occ_grid(occ_res: int, height: int, width: int,
                       room: float = 0.8, device="cpu") -> torch.Tensor:
    """Occupancy [occ_res^3] uint8 of the cube room's walls as seen from
    the origin by an [height, width] pano (1-voxel dilated, as the pool's
    grid)."""
    pano = render_cube_room_pano(torch.eye(4, device=device), height, width,
                                 room)
    rays = gen_pano_rays(torch.eye(4, device=device), height, width)
    pts = (rays.o + rays.d * pano["distance"]).reshape(-1, 3)
    return occ_grid_from_points(pts, occ_res, dilation=1)


def random_field_params(seed: int, field_cfg: NGPFieldConfig,
                        table_scale: float = 0.5,
                        density_gain: float = 6.0) -> dict:
    """A field drawn with NumPy from ``seed``, in the JAX package's tree
    and layout (``{"geo"|"app": {"table", "mlp": {"w": [...]}}}``).

    Tables are Uniform(-table_scale, table_scale), far above the training
    init's 1e-4, so frames carry structure. MLPs are He-init; the density
    head's last layer is made non-negative and scaled by ``density_gain``
    so the random field is mostly opaque near the occupied shell."""
    rng = np.random.default_rng(seed)
    g = field_cfg.grid

    def head(dout: int, hidden: int) -> dict:
        table = rng.uniform(-table_scale, table_scale, g.table_shape)
        dims = [g.out_dim] + [field_cfg.n_neurons] * hidden + [dout]
        ws = [(rng.standard_normal((a, b)) * math.sqrt(2.0 / a))
              .astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
        return {"table": table.astype(np.float32), "mlp": {"w": ws}}

    params = {"geo": head(1, field_cfg.geo_hidden),
              "app": head(3, field_cfg.app_hidden)}
    w = params["geo"]["mlp"]["w"]
    w[-1] = (np.abs(w[-1]) * density_gain).astype(np.float32)
    return params

