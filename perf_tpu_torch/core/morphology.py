"""Flat image morphology and the 3x3 Laplacian, on tensors.

Counterpart of ``perf_tpu/core/morphology.py:18-127``: shifted-slice
erosion and dilation with out-of-image neighbours that never win, the
kornia-normalised Laplacian (kernel / 16, reflect border),
``edge_keep_mask``, the supervision pool's depth-discontinuity filter, and
the ellipse-kernel opening of the visibility and conflict masks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BIG = 1e9


def ellipse_kernel(size: int) -> np.ndarray:
    """Binary ellipse structuring element (cv2 ``MORPH_ELLIPSE``)."""
    r = size // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    k = np.zeros((size, size), dtype=np.float32)
    for i in range(size):
        dy = i - r
        if abs(dy) <= r:
            dx = (int(round(r * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
                  if r > 0 else 0)
        else:
            dx = -1
        if dx >= 0:
            k[i, r - dx: r + dx + 1] = 1.0
    return k


def _morph(img: torch.Tensor, se: np.ndarray, is_dilation: bool):
    """[H, W] or [H, W, C] -> same shape."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    kh, kw = se.shape
    cy, cx = kh // 2, kw // 2
    pad_val = -_BIG if is_dilation else _BIG
    # F.pad pads the last dims first: (C), W, H
    padded = F.pad(img, (0, 0, cx, kw - 1 - cx, cy, kh - 1 - cy),
                   value=pad_val)
    h, w = img.shape[0], img.shape[1]
    acc = None
    for dy, dx in np.argwhere(se > 0):
        sl = padded[dy:dy + h, dx:dx + w]
        if acc is None:
            acc = sl
        elif is_dilation:
            acc = torch.maximum(acc, sl)
        else:
            acc = torch.minimum(acc, sl)
    out = acc if acc is not None else img
    return out[..., 0] if squeeze else out


def dilation(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return _morph(img, se, is_dilation=True)


def erosion(img: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    return _morph(img, se, is_dilation=False)


def laplacian3(img: torch.Tensor) -> torch.Tensor:
    """Normalised 3x3 Laplacian, reflect border: [H, W] or [H, W, 1]."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., 0]
    padded = F.pad(img[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    h, w = img.shape
    acc = -8.0 * img
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            acc = acc + padded[dy:dy + h, dx:dx + w]
    out = acc / 16.0
    return out[..., None] if squeeze else out


def edge_keep_mask(val: torch.Tensor, threshold: float = 0.01) -> torch.Tensor:
    """Bool mask [H, W, 1] of non-edge pixels of a scalar map: |Laplacian|
    below ``threshold``, then a 3x3 opening (erosion, then dilation)."""
    if val.dim() == 2:
        val = val[..., None]
    lap = laplacian3(val[..., 0])
    keep = (torch.abs(lap) < threshold).to(torch.float32)
    se = np.ones((3, 3), dtype=np.float32)
    keep = dilation(erosion(keep, se), se)
    return (keep > 0.5)[..., None]


def binary_open_close(mask: torch.Tensor, small: int, large: int,
                      dilate_first: bool = True) -> torch.Tensor:
    """Dilate with a ``small`` ellipse then erode with a ``large`` one (or
    the reverse): mask [H, W] in {0, 1} -> float [H, W]."""
    m = mask.to(torch.float32)
    if dilate_first:
        return erosion(dilation(m, ellipse_kernel(small)),
                       ellipse_kernel(large))
    return dilation(erosion(m, ellipse_kernel(large)), ellipse_kernel(small))
