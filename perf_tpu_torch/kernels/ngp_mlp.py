"""The NGP MLP (K2) with its epilogue, forward and backward, as CUDA kernels.

``csrc/ngp_mlp.cu`` replaces ``perf_tpu/fields/mlp.py``'s
``ngp_mlp_apply_channels`` and ``ngp_mlp_apply`` with the output activation
and AABB select of ``perf_tpu/fields/ngp.py`` (``fields/mlp.py``'s
``NGPHead``: the density head, the colour head, the proposal fields'
density) and their autodiff. ``ngp_head`` is the entry point: CUDA tensors
launch the kernels (``NGPMlp`` when a gradient is wanted, the forward alone
otherwise, which saves nothing), CPU tensors take the plain versions
(``fields/mlp.py`` ``ngp_head_plain`` and the hand-written
``ngp_head_bwd_plain``); anything else raises. Each kernel call checks
shapes, dtypes and devices and raises on what the kernel does not take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda
from ..fields.mlp import (APP_HEAD, GEO_HEAD, PROP_HEAD, NGPHead,
                          ngp_head_bwd_plain, ngp_head_plain)

HIDDEN = 64
# the kernels' head index, widest input and the backward's tile of points a
# block (csrc/ngp_mlp.cu: the bf16 heads' tensor-core tiles of 16 points a
# warp, the float32 proposal head's point a thread)
KERNEL_HEADS = {GEO_HEAD: (0, 32, 64), APP_HEAD: (1, 32, 64),
                PROP_HEAD: (2, 16, 128)}

_FWD = cuda.register(cuda.CudaKernel(
    "ngp_mlp", "ngp_mlp.cu", "ngp_mlp_fwd_launch",
    [cuda.I32, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.P, cuda.P,
     cuda.P, cuda.P]))
_BWD = cuda.register(cuda.CudaKernel(
    "ngp_mlp_bwd", "ngp_mlp.cu", "ngp_mlp_bwd_launch",
    [cuda.I32, cuda.P, cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.P,
     cuda.P, cuda.P, cuda.P, cuda.P, cuda.I32, cuda.P]))


def _check_args(ws, x: torch.Tensor, sel: torch.Tensor,
                head: NGPHead) -> tuple:
    """(kernel head index, din) after checking the kernel takes them."""
    if head not in KERNEL_HEADS:
        raise ValueError(f"ngp_mlp kernel: no instance for {head}")
    index, max_in, _ = KERNEL_HEADS[head]
    dev = x.device
    cuda.check(x, "x", torch.float32, (None, None))
    m, din = x.shape
    if not 1 <= din <= max_in:
        raise ValueError(f"ngp_mlp kernel ({head.name}): input width {din}, "
                         f"takes 1 to {max_in}")
    cuda.check(sel, "sel", torch.bool, (m,), dev)
    if len(ws) != head.hidden + 1:
        raise ValueError(f"ngp_mlp kernel ({head.name}): {len(ws)} layers, "
                         f"takes {head.hidden + 1}")
    shapes = ([(din, HIDDEN)] + [(HIDDEN, HIDDEN)] * (head.hidden - 1)
              + [(HIDDEN, head.channels)])
    for i, (w, shape) in enumerate(zip(ws, shapes)):
        cuda.check(w, f"W{i}", torch.float32, shape, dev)
    return index, din


def _layer_ptrs(ws) -> tuple:
    """W0, W1 (the colour head's second hidden layer, else 0), WL."""
    return (ws[0].data_ptr(), ws[1].data_ptr() if len(ws) == 3 else 0,
            ws[-1].data_ptr())


def ngp_mlp_fwd_cuda(ws, x: torch.Tensor, sel: torch.Tensor, head: NGPHead,
                     save_raw: bool) -> tuple:
    """(the activated channels [C, M], the raw outputs [C, M] or None) of
    the head at x [M, din] inside sel [M]."""
    index, din = _check_args(ws, x, sel, head)
    m = x.shape[0]
    out = torch.empty((head.channels, m), dtype=torch.float32,
                      device=x.device)
    raw = torch.empty_like(out) if save_raw else None
    _FWD.launch(index, x.data_ptr(), sel.data_ptr(), m, din, *_layer_ptrs(ws),
                out.data_ptr(), raw.data_ptr() if save_raw else 0)
    return out, raw


@functools.lru_cache(maxsize=1)
def _occupancy_fn():
    fn = _FWD.library().ngp_mlp_occupancy
    fn.argtypes, fn.restype = [cuda.I32, cuda.I32, cuda.P], cuda.I32
    return fn


def _occupancy(head: NGPHead, backward: bool) -> tuple:
    """(blocks a SM, dynamic shared memory a block) of the head's kernel on
    the current device (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    occ = (ctypes.c_int * 2)()
    err = _occupancy_fn()(KERNEL_HEADS[head][0], int(backward), occ)
    if err != 0 or occ[0] < 1:
        raise RuntimeError(f"ngp_mlp_occupancy ({head.name}): cudaError "
                           f"{err}, {occ[0]} blocks a SM")
    return occ[0], occ[1]


@functools.lru_cache(maxsize=16)
def _bwd_grid_cap(head: NGPHead, index: int) -> int:
    with torch.cuda.device(index):
        per_sm = _occupancy(head, backward=True)[0]
    return per_sm * torch.cuda.get_device_properties(index).multi_processor_count


def bwd_blocks(head: NGPHead, m: int, device: torch.device) -> int:
    """The backward's grid at m points: a block a tile of points, at most
    as many blocks as the card holds at once."""
    tiles = -(-m // KERNEL_HEADS[head][2])
    return max(1, min(tiles, _bwd_grid_cap(head, device.index or 0)))


def ngp_mlp_bwd_cuda(ws, x: torch.Tensor, sel: torch.Tensor,
                     raw: torch.Tensor, g: torch.Tensor, head: NGPHead,
                     need_dx: bool = True) -> tuple:
    """(dx [M, din] or None, the weights' gradients) from the activated
    channels' cotangent g [C, M]: the backward kernel on a grid that
    depends on M and the card only, then the sum of its blocks' partials
    in block order (one launch of the entry point)."""
    index, din = _check_args(ws, x, sel, head)
    m = x.shape[0]
    for name, t in (("raw", raw), ("g", g)):
        cuda.check(t, name, torch.float32, (head.channels, m), x.device)
    sizes = ([din * HIDDEN] + [HIDDEN * HIDDEN] * (head.hidden - 1)
             + [HIDDEN * head.channels])
    blocks = bwd_blocks(head, m, x.device)
    part = torch.empty((blocks, sum(sizes)), dtype=torch.float32,
                       device=x.device)
    grad = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x) if need_dx else None
    _BWD.launch(index, x.data_ptr(), sel.data_ptr(), raw.data_ptr(),
                g.data_ptr(), m, din, *_layer_ptrs(ws),
                dx.data_ptr() if need_dx else 0, part.data_ptr(), blocks,
                grad.data_ptr())
    grads = [v.view(w.shape) for v, w in zip(grad.split(sizes), ws)]
    return dx, grads


class NGPMlp(torch.autograd.Function):
    """The head's activated channels [C, M] with the gradients of x and of
    every weight. CUDA tensors launch the kernels, CPU tensors take the
    plain forward and the hand-written plain backward; the forward saves
    the raw outputs [C, M] and recomputes the hidden layers backward."""

    @staticmethod
    def forward(ctx, x, sel, head, *ws):
        if x.is_cuda:
            out, raw = ngp_mlp_fwd_cuda(ws, x, sel, head, save_raw=True)
        else:
            out, raw = ngp_head_plain(list(ws), x, sel, head)
        ctx.head = head
        ctx.save_for_backward(x, sel, raw, *ws)
        return out

    @staticmethod
    def backward(ctx, g):
        x, sel, raw, *ws = ctx.saved_tensors
        need_dx = ctx.needs_input_grad[0]
        fn = ngp_mlp_bwd_cuda if g.is_cuda else ngp_head_bwd_plain
        dx, grads = fn(ws, x, sel, raw, g.contiguous(), ctx.head, need_dx)
        return (dx, None, None, *grads)


def ngp_head(ws, x: torch.Tensor, sel: torch.Tensor,
             head: NGPHead) -> torch.Tensor:
    """The head's activated channels [C, M] at inputs x [M, din] inside sel
    [M] (bool), differentiable in x and the weights ``ws``."""
    if not (x.is_cuda or x.device.type == "cpu"):
        raise ValueError(f"ngp_mlp: unsupported device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(w.requires_grad for w in ws)):
        return NGPMlp.apply(x.contiguous(), sel.contiguous(), head, *ws)
    if x.is_cuda:
        return ngp_mlp_fwd_cuda(ws, x.contiguous(), sel.contiguous(), head,
                                save_raw=False)[0]
    return ngp_head_plain(list(ws), x, sel, head)[0]
