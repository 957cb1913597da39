"""Per-level ray subsampling shared by the grid encoders.

Counterpart of ``perf_tpu/kernels/hashgrid.py:142-177`` (``level_strides``,
``_lerp_upsample``); the hash-grid encoder itself is not ported yet.
"""

from __future__ import annotations

import torch


def level_strides(cfg, step: float, n_samples: int) -> tuple:
    """Per-level power-of-two strides along the ray: level l is sampled
    every ~half of its voxel (2 / res_l) and lerped back to the full
    ladder, capped at 16 and at half the sample count, and halved until it
    divides ``n_samples``."""
    strides = []
    for lvl in range(cfg.n_levels):
        voxel = 2.0 / cfg.level_res(lvl)
        k = max(1, int(voxel / (2.0 * step)))
        k = 1 << (k.bit_length() - 1)
        cap = max(1, n_samples // 2)
        cap = 1 << (cap.bit_length() - 1)
        k = min(k, 16, cap)
        while n_samples % k:
            k //= 2
        strides.append(k)
    return tuple(strides)


def lerp_upsample(coarse: torch.Tensor, stride: int, n: int) -> torch.Tensor:
    """[N, P+1, ...] values at every ``stride``-th sample plus the last ->
    [N, n, ...] by linear interpolation (``_lerp_upsample``)."""
    if stride == 1:
        return coarse[:, :n]
    p = n // stride
    left = coarse[:, :p].unsqueeze(2)
    right = coarse[:, 1:p + 1].unsqueeze(2)
    w = torch.arange(stride, dtype=coarse.dtype, device=coarse.device) / stride
    w = w.reshape((1, 1, stride) + (1,) * (coarse.dim() - 2))
    full = left * (1.0 - w) + right * w
    return full.reshape((coarse.shape[0], p * stride) + coarse.shape[2:])
