"""Supervision pool: registered RGB-D(-N) panoramas -> flat ray supervision.

Counterpart of ``perf_tpu/train/sup_pool.py:56-248, 306-326``
(``build_pano_sup_info``; ``SupInfoPool`` with ``register_sup_info`` and its
finiteness gate, ``device_arrays``, ``gen_occ_grid``, ``state_dict`` /
``load_state_dict``). Per registered pano the supervision pixels are those
with mask AND distance > 1e-5 AND no depth edge AND, with normals,
normal . (-view dir) > 0.15; each becomes one ray with its colour, distance
and normal. The concatenated arrays live on the host as NumPy (appends are
rare) and are uploaded per episode, padded to a power-of-two capacity with
the valid count beside them. The state dict has the JAX package's layout,
so either package restores the other's pool.

The anchor cycle's projection cores (``sup_pool.py:110-304``) test
candidate surface points against every registered pano at once: each
pano's masked distance map is resampled along the candidate's direction
in that pano's frame (one batched ``bilinear_sample`` over all panos) and
compared with the candidate's own distance there; the visibility mask
(some pano already sees the point) and the geo-check (not every pano sees
it behind its own surface) then take the reference's ellipse openings.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import (apply_rot, bilinear_sample, binary_open_close,
                    direction_to_img_coord, img_coord_from_hw,
                    img_coord_to_pano_direction)
from ..core.morphology import edge_keep_mask
from ..render.occgrid import occ_grid_from_points


@dataclasses.dataclass
class PanoSupInfo:
    """One registered pano's full maps and flat filtered supervision."""

    pose: np.ndarray          # [4, 4]
    height: int
    width: int
    color_map: np.ndarray     # [H, W, 3]
    distance_map: np.ndarray  # [H, W, 1]
    normal_map: np.ndarray    # [H, W, 3]
    mask: np.ndarray          # [H, W, 1] bool, the filtered supervision mask
    mask_raw: np.ndarray      # [H, W, 1] bool, input mask & distance > 0
    sup_rays_o: np.ndarray    # [M, 3]
    sup_rays_d: np.ndarray    # [M, 3]
    sup_colors: np.ndarray    # [M, 3]
    sup_distances: np.ndarray  # [M, 1]
    sup_normals: np.ndarray   # [M, 3]


def build_pano_sup_info(pose, mask, color_map, distance_map,
                        normal_map=None) -> PanoSupInfo:
    """Filter and flatten one pano (NumPy in and out; the filters run on
    CPU tensors)."""
    pose = np.asarray(pose, np.float32)
    color_map = np.asarray(color_map, np.float32)
    h, w, _ = color_map.shape
    if distance_map is None:
        distance_map = np.ones((h, w, 1), np.float32)
    distance_map = np.asarray(distance_map, np.float32).reshape(h, w, -1)[..., :1]
    if mask is None:
        m = np.ones((h, w, 1), bool)
    else:
        m = np.asarray(mask, np.float32).reshape(h, w, -1)[..., :1] > 0.5

    has_normal = normal_map is not None
    if normal_map is None:
        normal_map = np.zeros((h, w, 3), np.float32)
    normal_map = np.asarray(normal_map, np.float32)

    m = m & (distance_map > 1e-5)
    mask_raw = m.copy()
    m = m & edge_keep_mask(torch.tensor(distance_map), 0.01).numpy()

    pano_dirs = img_coord_to_pano_direction(img_coord_from_hw(h, w)).numpy()
    if has_normal:
        normal_cos = np.clip((-pano_dirs * normal_map).sum(-1, keepdims=True),
                             0.0, 1.0)
        m = m & (normal_cos > 0.15)

    dirs = apply_rot(torch.from_numpy(pano_dirs),
                     torch.from_numpy(pose[:3, :3])).numpy()
    sel = m[..., 0]
    return PanoSupInfo(
        pose=pose, height=h, width=w,
        color_map=color_map, distance_map=distance_map,
        normal_map=normal_map, mask=m, mask_raw=mask_raw,
        sup_rays_o=np.broadcast_to(pose[:3, 3], dirs.shape)[sel],
        sup_rays_d=dirs[sel],
        sup_colors=color_map[sel],
        sup_distances=distance_map[sel],
        sup_normals=normal_map[sel],
    )


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pano_proj_depths(pts: torch.Tensor, poses: torch.Tensor,
                      dmaps: torch.Tensor):
    """pts [H, W, 3] world points, poses [P, 4, 4], masked distance maps
    [P, H', W', 1] -> (proj_d, new_d), each [P, H, W, 1]: each pano's stored
    surface distance along the candidate's direction, and the candidate's
    own distance from that pano."""
    rel = pts[None] - poses[:, None, None, :3, 3]
    local = torch.einsum("pji,phwj->phwi", poses[:, :3, :3], rel)
    new_d = torch.linalg.norm(local, dim=-1, keepdim=True)
    coords = direction_to_img_coord(local / new_d)
    return bilinear_sample(dmaps, coords, padding="border"), new_d


def _visibility_mask_core(pts, poses, dmaps) -> torch.Tensor:
    """1 where any registered pano already sees the candidate surface (a
    padded pano's -1 map never does), then the 5 / 9 opening."""
    proj_d, new_d = _pano_proj_depths(pts, poses, dmaps)
    visible = (new_d < proj_d + 1.0 / 256.0).to(torch.float32)
    mask = torch.amax(visible, dim=0)
    return binary_open_close((mask[..., 0] > 0.5).to(torch.float32),
                             small=5, large=9)


def _geo_check_core(pts, poses, dmaps) -> torch.Tensor:
    """1 OK / 0 conflict: a candidate conflicts when every registered pano
    sees it behind its own surface (a padded pano's -1 map is always OK),
    then the 3 / 9 opening."""
    proj_d, new_d = _pano_proj_depths(pts, poses, dmaps)
    ok = (proj_d < new_d).to(torch.float32)
    mask = torch.amin(ok, dim=0)
    return binary_open_close((mask[..., 0] > 0.5).to(torch.float32),
                             small=3, large=9)


class SupInfoPool:
    """Growing pool of registered panos and their concatenated supervision."""

    def __init__(self):
        self.sup_infos: list[PanoSupInfo] = []
        self._cat: dict | None = None
        self._device_maps = None   # (n, device, poses, dmaps)

    def register_sup_info(self, pose, mask, rgb, distance, normal=None):
        # a non-finite map means an upstream numerical blow-up; registering
        # it would poison every later episode, so refuse it loudly
        for name, arr in (("rgb", rgb), ("distance", distance),
                          ("normal", normal)):
            if arr is not None and not np.isfinite(np.asarray(arr)).all():
                raise FloatingPointError(
                    f"register_sup_info: non-finite values in '{name}' map "
                    f"for pano {len(self.sup_infos)}; refusing to register "
                    "corrupted supervision")
        info = build_pano_sup_info(pose, mask, rgb, distance, normal)
        self.sup_infos.append(info)
        arrays = {"rays_o": info.sup_rays_o, "rays_d": info.sup_rays_d,
                  "colors": info.sup_colors, "distances": info.sup_distances,
                  "normals": info.sup_normals}
        if self._cat is None:
            self._cat = {k: v.copy() for k, v in arrays.items()}
        else:
            self._cat = {k: np.concatenate([self._cat[k], arrays[k]], 0)
                         for k in self._cat}
        self._device_maps = None

    @property
    def n_valid(self) -> int:
        return 0 if self._cat is None else self._cat["rays_o"].shape[0]

    def device_arrays(self, device, capacity: int | None = None) -> dict:
        """Arrays padded to ``capacity`` (default: the next power of two)
        on ``device``, and ``n_valid`` as a Python int."""
        n = self.n_valid
        cap = capacity or _next_pow2(max(n, 1))
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} valid rays")
        out = {}
        for k, v in self._cat.items():
            pad = np.zeros((cap - n,) + v.shape[1:], v.dtype)
            out[k] = torch.from_numpy(np.concatenate([v, pad], 0)).to(device)
        out["n_valid"] = n
        return out

    def gen_occ_grid(self, res: int = 256, dilation: int = 1,
                     device="cpu") -> torch.Tensor:
        """Binary occupancy [res^3] uint8 on ``device`` from every
        back-projected supervision point."""
        pts = (self._cat["rays_o"] + self._cat["rays_d"]
               * self._cat["distances"])
        return occ_grid_from_points(torch.from_numpy(pts).to(device), res,
                                    dilation)

    def device_pano_maps(self, device):
        """(poses [P, 4, 4], masked distance maps [P, H, W, 1]) on
        ``device``, P padded to the next power of two with identity poses
        and -1 maps (neutral in both cores); cached until the next
        registration. Raises when the panos' resolutions differ."""
        device = torch.device(device)
        if len({i.distance_map.shape for i in self.sup_infos}) != 1:
            raise ValueError("registered panos of different resolutions")
        n = len(self.sup_infos)
        if self._device_maps is None or self._device_maps[:2] != (n, device):
            cap = _next_pow2(n)
            dmaps = np.full((cap,) + self.sup_infos[0].distance_map.shape,
                            -1.0, np.float32)
            poses = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
            for i, info in enumerate(self.sup_infos):
                dmaps[i] = info.distance_map * info.mask
                poses[i] = info.pose
            self._device_maps = (n, device, torch.from_numpy(poses).to(device),
                                 torch.from_numpy(dmaps).to(device))
        return self._device_maps[2:]

    def geo_check(self, rays, distances: torch.Tensor) -> torch.Tensor:
        """Cross-pano conflict mask [H, W]: 1 OK, 0 conflict."""
        d = distances.reshape(rays.o.shape[:-1])[..., None]
        pts = rays.o + rays.d * d
        return _geo_check_core(pts, *self.device_pano_maps(pts.device))

    def state_dict(self) -> dict:
        out = {"n_sup_infos": len(self.sup_infos)}
        for i, info in enumerate(self.sup_infos):
            out[f"sup_info_{i}"] = {
                "pose": info.pose, "color_map": info.color_map,
                "distance_map": info.distance_map,
                "normal_map": info.normal_map,
                "mask_input": info.mask_raw.astype(np.float32),
                "has_normal": np.any(info.normal_map != 0),
            }
        return out

    def load_state_dict(self, state: dict):
        if self.sup_infos:
            raise ValueError("load_state_dict needs a fresh pool")
        for i in range(int(state["n_sup_infos"])):
            s = state[f"sup_info_{i}"]
            normal = s["normal_map"] if bool(s["has_normal"]) else None
            self.register_sup_info(
                pose=s["pose"], mask=s["mask_input"], rgb=s["color_map"],
                distance=s["distance_map"], normal=normal)
