"""LR schedule and the smooth-L1 loss.

Counterpart of ``perf_tpu/train/schedule.py:10-37``. ``lr_at`` runs on the
host (a Python float per step, no device work); ``smooth_l1`` on tensors.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Trapezoid + cosine schedule: linear ramp init_lr -> peak_lr over the
    first ``peak_at`` fraction, then cosine decay to ``peak_lr * lr_alpha``."""

    init_lr: float = 0.0
    peak_lr: float = 1e-2
    peak_at: float = 0.2
    lr_alpha: float = 1e-2


def lr_at(progress: float, cfg: OptimConfig) -> float:
    """LR at training progress in [0, 1]."""
    if progress < cfg.peak_at:
        ramp = progress / cfg.peak_at
        return cfg.peak_lr * ramp + cfg.init_lr * (1.0 - ramp)
    local = (progress - cfg.peak_at) / (1.0 - cfg.peak_at)
    factor = ((math.cos(local * math.pi) + 1.0) * 0.5 * (1.0 - cfg.lr_alpha)
              + cfg.lr_alpha)
    return cfg.peak_lr * factor


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    """``torch.nn.functional.smooth_l1_loss(beta=...)`` with mean reduction,
    written as the JAX package writes it (``where`` of the two branches)."""
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta,
                                  d - 0.5 * beta))
