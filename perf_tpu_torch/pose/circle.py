"""CirclePoseSampler: anchor viewpoints on concentric traverse loops.

Counterpart of ``perf_tpu/pose/circle.py`` (and of the reference's
``circle_pose_sampler.py:44-118``): extract the
horizontal free-space radius profile from the reference distance map's
equator band, hole-fill + min-filter + Gaussian-smooth it, then place
``n_anchors_per_ratio`` anchors on each concentric loop (ratios of the free
radius), alternating z between test_z_min/max; poses are identity-rotation
translations. Pure NumPy/SciPy — cold path, runs once.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import minimum_filter1d, gaussian_filter1d

import torch

from ..core import (img_coord_from_hw, img_coord_to_pano_direction,
                    img_to_pano_coord)


def _resample_uniformly(pts: np.ndarray) -> np.ndarray:
    """Resample a closed polyline to arc-length-uniform spacing
    (reference ``circle_pose_sampler.py:13-22``)."""
    n = len(pts)
    t = np.linspace(0.0, 1.0, n, endpoint=False)
    t_hi = np.linspace(0.0, 1.0, n * 128, endpoint=False)
    dense = np.stack([np.interp(t_hi, t, pts[:, i]) for i in range(pts.shape[1])], -1)
    cat = np.concatenate([dense, dense[:1]], axis=0)
    seg = np.linalg.norm(cat[1:] - cat[:-1], axis=-1)
    cum = np.cumsum(seg)
    cum = cum / cum[-1]
    idx = np.searchsorted(cum, np.linspace(0.0, 1.0 - 1.0 / n, n))
    return dense[np.clip(idx, 0, len(dense) - 1)]


def _trajectory_normals(pts: np.ndarray) -> np.ndarray:
    """Smoothed inward-facing normals of a closed trajectory
    (reference ``circle_pose_sampler.py:26-41``)."""
    n = len(pts)
    sigma = float(n) / 32.0 * 2.0 + 1.0
    ext = np.concatenate([pts, pts[:1]], axis=0)
    right = ext[1:] - ext[:-1]
    right /= np.linalg.norm(right, axis=-1, keepdims=True)
    up = np.zeros_like(right)
    up[:, 2] = 1.0
    to = np.cross(up, right)
    to /= np.linalg.norm(to, axis=-1, keepdims=True)
    for i in range(3):
        to[:, i] = gaussian_filter1d(to[:, i], sigma=sigma, mode="wrap")
    to /= np.linalg.norm(to, axis=-1, keepdims=True)
    return -to


class PoseSampler:
    n_poses: int = 0

    def sample_pose(self, idx: int) -> np.ndarray:
        raise NotImplementedError


class CirclePoseSampler(PoseSampler):
    def __init__(self, distance_map, traverse_ratios=(0.2, 0.4, 0.6),
                 n_anchors_per_ratio=(8, 8, 8), test_z_min_max=(0.0, 0.0)):
        distance_map = np.asarray(distance_map).squeeze()
        height, width = distance_map.shape
        pano_coords = img_to_pano_coord(img_coord_from_hw(height, width)).numpy()

        # horizontal free radius per column from the equator band (+-10 rows)
        plane_dis = distance_map * np.cos(pano_coords[:, :, 0])
        hh = height // 2
        band = plane_dis[hh - 10: hh + 10].copy()
        band[band < 1e-5] = 1e9
        profile = band.min(axis=0)

        # hole-fill from neighbors (both sweeps, reference :63-69)
        for i in range(1, width):
            if profile[i] > 1e8:
                profile[i] = profile[i - 1]
        for i in range(1, width):
            if profile[width - i - 1] > 1e8:
                profile[width - i - 1] = profile[width - i]

        pool_size = (width // 16) // 2 * 2 + 1
        filtered = minimum_filter1d(profile, size=pool_size, mode="wrap")
        smooth_sigma = (width // 8) // 2 * 2 + 1
        smoothed = gaussian_filter1d(filtered, sigma=smooth_sigma, mode="wrap")
        blur_sigma = (width // 64) // 2 * 2 + 1
        filtered = gaussian_filter1d(filtered, sigma=blur_sigma, mode="wrap")

        circle_coords = np.stack([np.full(width, 0.5),
                                  (np.arange(width) + 0.5) / width], -1)
        circle_pts = img_coord_to_pano_direction(
            torch.from_numpy(circle_coords.astype(np.float32))).numpy()

        anchors = []
        z_min, z_max = test_z_min_max
        for i, ratio in enumerate(traverse_ratios):
            loop = _resample_uniformly(circle_pts * (filtered * ratio)[:, None])
            n = n_anchors_per_ratio[i]
            if n == 0:      # a loop without anchors (the JAX package divides
                continue    # by zero here)
            bias = 0.0 if i % 2 == 0 else 0.5 / n
            a_idx = np.linspace(0.5 / n, 1.0 - 0.5 / n, n) + bias
            a_idx = np.clip((a_idx * width).astype(np.int64), 0, width - 1)
            pts = loop[a_idx].copy()
            for j in range(len(pts)):
                pts[j, 2] = z_min if (i + j) % 2 == 0 else z_max
            anchors.append(pts)

        self.anchor_pts = np.concatenate(
            anchors + [np.zeros((0, 3))], axis=0).astype(np.float32)
        self.traverse_pts = _resample_uniformly(
            circle_pts * (smoothed * 0.3)[:, None]).astype(np.float32)
        self.traverse_normals = _trajectory_normals(self.traverse_pts)
        self.free_radius_profile = filtered

        self.n_anchors = len(self.anchor_pts)
        self.n_poses = self.n_anchors

    def sample_pose(self, idx: int) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = self.anchor_pts[idx]
        return pose
