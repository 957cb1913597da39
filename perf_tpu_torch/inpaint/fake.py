"""Fake inpainter: a multiscale normalised-convolution hole fill.

Counterpart of ``perf_tpu/inpaint/fake.py:18-84``: stands in for LaMa and
Stable Diffusion without checkpoints. Known content is averaged down a
pyramid, pushed back up into the holes, then relaxed by a few normalised
3x3 box passes; known pixels pass through exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .interface import Inpainter


def _avg3(x: torch.Tensor) -> torch.Tensor:
    """3x3 box filter on [H, W, C], zero padding, summed in row-major tap
    order."""
    h, w = x.shape[0], x.shape[1]
    p = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            s = p[dy:dy + h, dx:dx + w]
            acc = s if acc is None else acc + s
    return acc / 9.0


def _down2(x: torch.Tensor) -> torch.Tensor:
    h, w, c = x.shape
    return x[:h // 2 * 2, :w // 2 * 2].reshape(h // 2, 2, w // 2, 2,
                                                c).mean(dim=(1, 3))


def _up2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x.repeat_interleave(2, 0).repeat_interleave(2, 1)[:h, :w]


def normalized_fill(img: torch.Tensor, known: torch.Tensor,
                    n_levels: int = 5, smooth_iters: int = 4) -> torch.Tensor:
    """Pull-push fill of ``img`` [H, W, C] where ``known`` [H, W, 1] is 0."""
    imgs = [img * known]
    ws = [known]
    for _ in range(n_levels):
        if min(imgs[-1].shape[0], imgs[-1].shape[1]) < 4:
            break
        imgs.append(_down2(imgs[-1]))
        ws.append(_down2(ws[-1]))
    cur = imgs[-1] / torch.clamp(ws[-1], min=1e-6)
    for lvl in range(len(imgs) - 2, -1, -1):
        hi, wi = imgs[lvl].shape[0], imgs[lvl].shape[1]
        up = _up2(cur, hi, wi)
        filled = imgs[lvl] + up * (1.0 - ws[lvl])
        wl = ws[lvl] + (1.0 - ws[lvl])
        cur = filled / torch.clamp(wl, min=1e-6)
    out = img * known + cur * (1.0 - known)
    for _ in range(smooth_iters):
        out = img * known + _avg3(out) * (1.0 - known)
    return torch.clamp(out, 0.0, 1.0)


class FakeInpainter(Inpainter):
    def __init__(self, n_levels: int = 6, smooth_iters: int = 4):
        self.n_levels = n_levels
        self.smooth_iters = smooth_iters

    def inpaint(self, img, mask):
        h, w = img.shape[0], img.shape[1]
        known = 1.0 - mask.reshape(h, w, -1)[..., :1].to(torch.float32)
        return normalized_fill(img, known, self.n_levels, self.smooth_iters)

    def inpaint_rgbd(self, img, distance, mask):
        out = self.inpaint(img, mask)
        d3 = distance.reshape(img.shape[0], img.shape[1], 1).repeat(1, 1, 3)
        return out, self.inpaint(d3, mask)[..., :1]
