"""Ray container (counterpart of ``perf_tpu/core/rays.py``)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Rays:
    """A bundle of rays. Leading dims are free; last dim of o/d is 3."""

    o: torch.Tensor  # [..., 3] origins
    d: torch.Tensor  # [..., 3] directions (unit-norm by convention)
