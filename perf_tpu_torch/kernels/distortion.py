"""Mip-NeRF 360 distortion loss on dense masked samples, per ray.

Counterpart of ``perf_tpu/kernels/distortion.py:18-39``: the O(S)
prefix-sum form. On the training path it runs fused into the
``shade_composite`` kernel (``render/renderer.py``); this is its plain
version.
"""

from __future__ import annotations

import torch


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, dim=-1) - x


def distortion_per_ray(weights: torch.Tensor, mids: torch.Tensor,
                       intervals, valid: torch.Tensor) -> torch.Tensor:
    """weights / mids / valid [N, S]; intervals [N, S] or a scalar -> [N]."""
    w = weights * valid
    wm = w * mids
    w_cum = _exclusive_cumsum(w)
    wm_cum = _exclusive_cumsum(wm)
    loss_bi = 2.0 * torch.sum(w * (mids * w_cum - wm_cum), dim=-1)
    loss_uni = (1.0 / 3.0) * torch.sum(intervals * w * w, dim=-1)
    return loss_bi + loss_uni
