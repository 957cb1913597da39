"""The NGP MLP: bias-free ReLU layers, ``[din, dout]`` weights.

Counterpart of ``perf_tpu/fields/mlp.py:31-85`` (the NGP half). Params are
a dict ``{"w": [W0, W1, ...]}`` of float32 tensors laid out ``[din, dout]``,
so a ``perf_tpu`` param tree loads as it is.
"""

from __future__ import annotations

import math

import torch


def ngp_mlp_init(generator: torch.Generator, dim_in: int, dim_out: int,
                 n_neurons: int = 64, n_hidden: int = 1,
                 device=None) -> dict:
    """He init: dim_in -> (n_neurons,) * n_hidden -> dim_out."""
    dims = [dim_in] + [n_neurons] * n_hidden + [dim_out]
    ws = []
    for a, b in zip(dims[:-1], dims[1:]):
        w = torch.randn((a, b), generator=generator) * math.sqrt(2.0 / a)
        ws.append(w.to(device))
    return {"w": ws}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return float32 (exact bf16 values)."""
    return x.to(torch.bfloat16).float()


def ngp_mlp_apply_channels(params: dict, x: torch.Tensor,
                           out_activation=None) -> tuple:
    """Per-output-channel forward with JAX's rounding points: input and
    every ReLU output rounded to bf16, bf16 x bf16 products accumulated in
    float32 (a float32 matmul of bf16-valued operands), last layer float32
    with float32 weights. Returns a tuple of [...] tensors."""
    ws = params["w"]
    h = _bf16(x)
    for w in ws[:-1]:
        h = _bf16(torch.relu(h @ _bf16(w)))
    w_last = ws[-1]
    outs = []
    for c in range(w_last.shape[1]):
        o = torch.sum(h * w_last[:, c], dim=-1)
        if out_activation is not None:
            o = out_activation(o)
        outs.append(o)
    return tuple(outs)
