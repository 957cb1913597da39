"""Bilinear image resampling, the ``F.grid_sample`` replacement.

Counterpart of ``perf_tpu/core/resample.py:28-80`` (``bilinear_sample``,
``pano_sample``): images are channels-last [H, W, C] float32, sampled at
image coords (row_frac, col_frac) in [0, 1] with pixel centres at
(i + 0.5) / H (``align_corners=False``). Padding modes:

- ``border``: clamp to the edge pixel;
- ``wrap_x``: wrap in longitude, clamp in latitude (equirectangular panos);
- ``zeros``: the taps clamp as ``border``, then the whole sample is zeroed
  when its centre lies outside [0, H-1] x [0, W-1] (not ``grid_sample``'s
  per-tap zeros).

A leading batch of images is one call (JAX's ``vmap`` of the sampler):
img [B, H, W, C] with coords [B, ..., 2]. The image gets a gradient (the
distillation trains its local bias maps through the sampler); the coords
get none (no caller differentiates them). CUDA tensors launch the
``bilinear`` kernels (``kernels/csrc/bilinear.cu``), forward and backward;
CPU tensors take the plain version under autograd. The kernels index
inside an image in int32 and take the image from the grid: an image of
2^31 elements or more, a batch entry of 2^31 / max(C, 2) samples or more
and more than 65535 images are refused.
"""

from __future__ import annotations

import torch

from ..kernels import cuda

MODES = {"border": 0, "wrap_x": 1, "zeros": 2}


def bilinear_sample_plain(img: torch.Tensor, coords: torch.Tensor,
                          padding: str) -> torch.Tensor:
    """img [B, H, W, C], coords [B, M, 2] -> [B, M, C], in JAX's operation
    order; differentiable in ``img`` by autograd."""
    b, h, w, c = img.shape
    py = coords[..., 0] * h - 0.5
    px = coords[..., 1] * w - 0.5
    y0f, x0f = torch.floor(py), torch.floor(px)
    wy, wx = (py - y0f)[..., None], (px - x0f)[..., None]
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    y1, x1 = y0 + 1, x0 + 1
    y0c, y1c = torch.clamp(y0, 0, h - 1), torch.clamp(y1, 0, h - 1)
    if padding == "wrap_x":
        x0c, x1c = torch.remainder(x0, w), torch.remainder(x1, w)
    else:
        x0c, x1c = torch.clamp(x0, 0, w - 1), torch.clamp(x1, 0, w - 1)
    flat = img.reshape(b, h * w, c)

    def tap(iy, ix):
        idx = (iy * w + ix)[..., None].expand(-1, -1, c)
        return torch.gather(flat, 1, idx)

    out = (tap(y0c, x0c) * (1 - wy) * (1 - wx) + tap(y0c, x1c) * (1 - wy) * wx
           + tap(y1c, x0c) * wy * (1 - wx) + tap(y1c, x1c) * wy * wx)
    if padding == "zeros":
        inside = (py >= 0) & (py <= h - 1) & (px >= 0) & (px <= w - 1)
        out = out * inside[..., None]
    return out


_FWD = cuda.register(cuda.CudaKernel(
    "bilinear_sample", "bilinear.cu", "bilinear_fwd_launch",
    [cuda.P, cuda.I32, cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.I64,
     cuda.I32, cuda.P]))
_BWD = cuda.register(cuda.CudaKernel(
    "bilinear_sample_bwd", "bilinear.cu", "bilinear_bwd_launch",
    [cuda.P, cuda.I32, cuda.I32, cuda.I32, cuda.I32, cuda.P, cuda.I64,
     cuda.I32, cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P]))
# the backward's routes (csrc/bilinear.cu): one block an image sorting each
# 256 samples' products by pixel, for at most this many samples an image
# (the distillation's 256 a view); fixed-point sums for more
BWD_ROUTES = ("fixed_point", "sorted")
SORTED_MAX_SAMPLES = 1024


def _check_sizes(b, h, w, c, m):
    """The kernels index inside an image and a batch entry in int32 and take
    the image from the grid's second axis."""
    if h * w * c >= 2 ** 31:
        raise ValueError(f"bilinear kernel indexes an image in int32: "
                         f"{h} x {w} x {c} elements")
    if m * max(c, 2) >= 2 ** 31:
        raise ValueError(f"bilinear kernel indexes samples in int32: {m}")
    if b > 65535:
        raise ValueError(f"bilinear kernel takes at most 65535 images, got {b}")


def _aligned(t):
    """``t`` 8-byte aligned, as the kernels read coords (float2) and C = 2
    taps (float2): a copy where its storage offset is odd."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _check(img, coords):
    b, h, w, c = img.shape
    cuda.check(img, "img", torch.float32)
    cuda.check(coords, "coords", torch.float32, (b, None, 2), img.device)
    _check_sizes(b, h, w, c, coords.shape[1])


def bilinear_sample_cuda(img: torch.Tensor, coords: torch.Tensor,
                         padding: str) -> torch.Tensor:
    """Kernel forward: img [B, H, W, C], coords [B, M, 2] -> [B, M, C]."""
    _check(img, coords)
    img, coords = _aligned(img), _aligned(coords)
    b, h, w, c = img.shape
    m = coords.shape[1]
    out = torch.empty((b, m, c), dtype=torch.float32, device=img.device)
    _FWD.launch(img.data_ptr(), b, h, w, c, coords.data_ptr(), m,
                MODES[padding], out.data_ptr())
    return out


def bilinear_sample_grad_cuda(img_shape, coords: torch.Tensor, padding: str,
                              grad: torch.Tensor,
                              route: str | None = None) -> torch.Tensor:
    """Kernel backward: the image gradient [B, H, W, C] from the samples'
    cotangents [B, M, C], each pixel's products summed in an order that
    does not change (the same bits from launch to launch): ``sorted`` for
    at most SORTED_MAX_SAMPLES samples an image, else ``fixed_point``
    (``route`` forces one)."""
    b, h, w, c = img_shape
    m = coords.shape[1]
    cuda.check(coords, "coords", torch.float32, (b, m, 2))
    grad = grad.contiguous()
    cuda.check(grad, "grad", torch.float32, (b, m, c), coords.device)
    _check_sizes(b, h, w, c, m)
    if route is None:
        route = "sorted" if m <= SORTED_MAX_SAMPLES else "fixed_point"
    coords = _aligned(coords)
    dev = coords.device
    g_img = torch.empty(img_shape, dtype=torch.float32, device=dev)
    if route == "fixed_point":
        # its scratch: the fixed-point sums and the non-finite products'
        # float sums (it clears the pixels the taps reach), the cotangents'
        # largest magnitude
        acc = torch.empty(img_shape, dtype=torch.int64, device=dev)
        special = torch.empty(img_shape, dtype=torch.float32, device=dev)
        gmax = torch.empty(1, dtype=torch.int32, device=dev)
        scratch = (acc.data_ptr(), special.data_ptr(), gmax.data_ptr())
    else:
        scratch = (None, None, None)
    _BWD.launch(grad.data_ptr(), b, h, w, c, coords.data_ptr(), m,
                MODES[padding], BWD_ROUTES.index(route), *scratch,
                g_img.data_ptr())
    return g_img


class _Bilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, coords, padding):
        ctx.save_for_backward(coords)
        ctx.img_shape, ctx.padding = tuple(img.shape), padding
        return bilinear_sample_cuda(img, coords, padding)

    @staticmethod
    def backward(ctx, grad):
        (coords,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None
        return (bilinear_sample_grad_cuda(ctx.img_shape, coords, ctx.padding,
                                          grad), None, None)


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    padding: str = "border") -> torch.Tensor:
    """Sample img [H, W, C] at coords [..., 2] -> [..., C], or a batch img
    [B, H, W, C] at coords [B, ..., 2] -> [B, ..., C]."""
    if padding not in MODES:
        raise ValueError(f"unknown padding mode {padding!r}")
    single = img.dim() == 3
    if single:
        img, coords = img[None], coords[None]
    if img.dim() != 4 or coords.shape[0] != img.shape[0]:
        raise ValueError(f"img {tuple(img.shape)} / coords "
                         f"{tuple(coords.shape)}: need [B, H, W, C] and "
                         "[B, ..., 2]")
    pre = coords.shape[:-1]
    flat = coords.detach().reshape(coords.shape[0], -1, 2).contiguous()
    if img.is_cuda:
        out = _Bilinear.apply(img.contiguous(), flat, padding)
    elif img.device.type == "cpu":
        out = bilinear_sample_plain(img, flat, padding)
    else:
        raise ValueError(f"bilinear_sample: unsupported device {img.device}")
    out = out.reshape(*pre, img.shape[-1])
    return out[0] if single else out


def pano_sample(pano: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample an equirectangular pano with longitude wrapping."""
    return bilinear_sample(pano, coords, padding="wrap_x")
