"""Fake prior backends: exact depth and normals of the analytic cube room.

Counterpart of ``perf_tpu/priors/fake.py:24-96``: what a perfect monocular
network would return for the cube room (half-extent ``room``) seen along
the views' directions, optionally corrupted with NumPy-drawn noise or
per-view scale so the fusion has work to do. They keep the whole pipeline
runnable without model checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.synthetic import cube_room_hit
from .interface import DepthPredictor, NormalPredictor


def _origin(dirs: torch.Tensor, origin) -> torch.Tensor:
    if origin is None:
        return torch.zeros_like(dirs)
    return torch.as_tensor(origin, dtype=dirs.dtype,
                           device=dirs.device).expand(dirs.shape)


class FakeCubeRoomDepthPredictor(DepthPredictor):
    """Distance along each view direction to the cube room's walls (the
    caller mean-normalises each view and multiplies by the z-to-distance
    ratio, so the per-view scale is arbitrary)."""

    def __init__(self, room: float = 0.8, noise: float = 0.0,
                 scale_jitter: float = 0.0, seed: int = 0):
        self.room = room
        self.noise = noise
        self.scale_jitter = scale_jitter
        self._rng = np.random.default_rng(seed)

    def predict_depth(self, imgs, intri=None, dirs=None, origin=None):
        if dirs is None:
            raise ValueError("the fake depth predictor needs view dirs")
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        t, _ = cube_room_hit(_origin(dirs, origin), d, self.room)
        t = torch.clamp(t, min=1e-4)
        if self.scale_jitter:
            s = self._rng.uniform(1.0 - self.scale_jitter,
                                  1.0 + self.scale_jitter,
                                  (dirs.shape[0], 1, 1, 1)).astype(np.float32)
            t = t * torch.from_numpy(s).to(t.device)
        if self.noise:
            z = self._rng.normal(size=tuple(t.shape)).astype(np.float32)
            t = t * (1.0 + self.noise * torch.from_numpy(z).to(t.device))
        return torch.clamp(t, min=1e-4)


class FakeCubeRoomNormalPredictor(NormalPredictor):
    """The cube room's inward normals in camera space, mapped to [0, 1]
    (callers do * 2 - 1, normalise, then rotate by the view's c2w)."""

    def __init__(self, room: float = 0.8, noise: float = 0.0, seed: int = 0):
        self.room = room
        self.noise = noise
        self._rng = np.random.default_rng(seed)

    def predict_normal(self, imgs, dirs=None, origin=None, c2w=None):
        if dirs is None or c2w is None:
            raise ValueError("the fake normal predictor needs view dirs "
                             "and c2w")
        d = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        _, n_world = cube_room_hit(_origin(dirs, origin), d, self.room)
        c2w = torch.as_tensor(c2w, device=dirs.device)
        out = torch.einsum("vij,vhwi->vhwj", c2w, n_world) * 0.5 + 0.5
        if self.noise:
            n_cam = out * 2.0 - 1.0
            z = self._rng.normal(size=tuple(n_cam.shape)).astype(np.float32)
            n_cam = n_cam + self.noise * torch.from_numpy(z).to(out.device)
            n_cam = n_cam / torch.linalg.norm(n_cam, dim=-1, keepdim=True)
            out = n_cam * 0.5 + 0.5
        return out
