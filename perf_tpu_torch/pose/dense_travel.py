"""DenseTravelPoseSampler: a smooth video trajectory through the anchors.

Counterpart of ``perf_tpu/pose/dense_travel.py`` (and of the reference's
``dense_travel_pose_sampler.py:51-116``): order the anchors into a short
tour (simulated annealing in the package's C++, ``native/tour.cpp``),
piecewise-linearly interpolate ~n_dense x 50 points proportional to segment
length, resample uniformly, Gaussian-smooth positions (sigma 20) and look
directions (sigma 30), and build look-at rotations with optional sideways
bias.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter1d

from ..core import look_at
from ..native import solve_tour
from .circle import PoseSampler, _resample_uniformly


class DenseTravelPoseSampler(PoseSampler):
    def __init__(self, sparse_pose_sampler: PoseSampler, n_dense_poses: int,
                 dir_bias_ratio: float = -1.0, anneal_steps: int = 10000,
                 seed: int = 0):
        sparse = np.stack([sparse_pose_sampler.sample_pose(i)
                           for i in range(sparse_pose_sampler.n_poses)])
        positions = sparse[:, :3, 3]
        if len(positions) < 2:
            # degenerate single-anchor case: orbit a small circle around it
            ang = np.linspace(0, 2 * np.pi, max(n_dense_poses, 8),
                              endpoint=False)
            ring = np.stack([np.cos(ang), np.sin(ang),
                             np.zeros_like(ang)], -1) * 0.05
            positions = positions.reshape(1, 3) + ring.astype(np.float32)
        order = solve_tour(positions, n_steps=anneal_steps, seed=seed)
        pts_sparse = positions[order]

        # segment-length-proportional dense interpolation
        big_n = n_dense_poses * 50
        shifts = pts_sparse[1:] - pts_sparse[:-1]
        seg_lens = np.linalg.norm(shifts, axis=-1)
        seg_n = np.round(big_n * seg_lens / max(seg_lens.sum(), 1e-9)).astype(np.int64)
        pts = []
        for i, cur_n in enumerate(seg_n):
            if cur_n <= 0:
                continue
            t = np.linspace(0.5 / cur_n, 1.0 - 0.5 / cur_n, cur_n)[:, None]
            pts.append(pts_sparse[i] * (1 - t) + pts_sparse[i + 1] * t)
        pts = np.concatenate(pts, axis=0)
        pts = _resample_uniformly(pts)[::50]

        for i in range(3):
            pts[:, i] = gaussian_filter1d(pts[:, i], sigma=20)
        pts = pts.astype(np.float32)

        to_vecs = np.empty_like(pts)
        to_vecs[:-1] = pts[1:] - pts[:-1]
        to_vecs[-1] = to_vecs[-2]
        for i in range(3):
            to_vecs[:, i] = gaussian_filter1d(to_vecs[:, i], sigma=30)
        to_vecs /= np.linalg.norm(to_vecs, axis=-1, keepdims=True)

        up = np.zeros_like(to_vecs)
        up[:, 2] = 1.0
        left = np.cross(up, to_vecs)
        left /= np.linalg.norm(left, axis=-1, keepdims=True)
        to_vecs = to_vecs + dir_bias_ratio * left
        to_vecs /= np.linalg.norm(to_vecs, axis=-1, keepdims=True)

        poses = np.tile(np.eye(4, dtype=np.float32), (len(pts), 1, 1))
        poses[:, :3, 3] = pts
        poses[:, :3, :3] = look_at(torch.from_numpy(to_vecs)).numpy()
        self.sample_poses = poses
        self.n_poses = len(poses)

    def sample_pose(self, idx: int) -> np.ndarray:
        return self.sample_poses[idx]
