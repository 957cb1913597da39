"""The NGP MLP (bias-free ReLU layers) and the sphere field's VanillaMLP.

Counterpart of ``perf_tpu/fields/mlp.py:31-160``: ``ngp_mlp_apply`` in
float32 (the proposal fields'), ``ngp_mlp_apply_channels`` with JAX's bf16
rounding points (the NGP heads'). Params are dicts of
float32 tensors laid out ``[din, dout]`` (``{"w": [...]}`` for the NGP
MLP, ``{"w": [...], "b": [...]}`` for the VanillaMLP, ``{"v": [...], "g":
[...], "b": [...]}`` for the weight-normed VanillaMLP of the geometry
refiner), so a ``perf_tpu`` param tree loads as it is.
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


def ngp_mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 forward, ReLU between layers (``ngp_mlp_apply``: no bf16
    rounding; the proposal fields' MLP)."""
    ws = params["w"]
    h = x
    for w in ws[:-1]:
        h = torch.relu(h @ w)
    return h @ ws[-1]


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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def vanilla_mlp_init(generator: torch.Generator, dim_in: int, dim_out: int,
                     n_neurons: int, n_hidden_layers: int,
                     sphere_init_radius: float = 0.5, weight_norm: bool = False,
                     device=None) -> dict:
    """A sphere-initialised VanillaMLP (the sphere field's; the JAX
    package's other init is unused here): the first layer connects only the
    first 3 inputs (the raw direction), the last starts at bias -radius
    with near-constant positive weights, so the negated output is ~ radius
    - |x| at init. With ``weight_norm`` the weights are reparametrised as
    w = g * v / ||v||_col with v the drawn weights and g = ||v||_col."""
    dims = [dim_in] + [n_neurons] * n_hidden_layers + [dim_out]
    ws, bs = [], []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        if i == len(dims) - 2:
            w = (torch.full((a, b), math.sqrt(math.pi) / math.sqrt(a))
                 + torch.randn((a, b), generator=generator) * 1e-4)
            bias = torch.full((b,), -sphere_init_radius)
        else:
            w = (torch.randn((a, b), generator=generator)
                 * (math.sqrt(2.0) / math.sqrt(b)))
            if i == 0:
                w[3:] = 0.0
            bias = torch.zeros((b,))
        ws.append(w.to(device))
        bs.append(bias.to(device))
    if weight_norm:
        return {"v": ws, "g": [torch.linalg.norm(w, dim=0) for w in ws],
                "b": bs}
    return {"w": ws, "b": bs}


def vanilla_weights(params: dict) -> tuple:
    """(weights, biases); weight-normed weights materialised as
    g * v / (||v||_col + 1e-12)."""
    if "v" in params:
        return ([g * v / (torch.linalg.norm(v, dim=0) + 1e-12)
                 for v, g in zip(params["v"], params["g"])], params["b"])
    return params["w"], params["b"]


def vanilla_mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Forward of the sphere-initialised VanillaMLP, softplus(100 z) / 100
    between layers; returns the NEGATED network output (the sphere init
    depends on it)."""
    ws, bs = vanilla_weights(params)
    h = x
    for w, b in zip(ws[:-1], bs[:-1]):
        h = softplus(100.0 * (h @ w + b)) / 100.0
    return -(h @ ws[-1] + bs[-1])
