"""The NGP MLP (bias-free ReLU layers) and the sphere field's VanillaMLP.

Counterpart of ``perf_tpu/fields/mlp.py:31-160``: ``ngp_mlp_apply`` in
float32 (the proposal fields'), ``ngp_mlp_apply_channels`` with JAX's bf16
rounding points (the NGP heads'). Params are dicts of
float32 tensors laid out ``[din, dout]`` (``{"w": [...]}`` for the NGP
MLP, ``{"w": [...], "b": [...]}`` for the VanillaMLP, ``{"v": [...], "g":
[...], "b": [...]}`` for the weight-normed VanillaMLP of the geometry
refiner), so a ``perf_tpu`` param tree loads as it is.

The NGP heads (``NGPHead``: an MLP with its output activation and AABB
select, as ``perf_tpu/fields/ngp.py`` applies them) have a plain forward
(``ngp_head_plain``) and a plain backward written out by hand
(``ngp_head_bwd_plain``): the math of the CUDA kernels in
``kernels/ngp_mlp.py``, with the cotangents rounded to bf16 where both
packages' autodiff rounds them.
"""

from __future__ import annotations

import dataclasses
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


class TruncExp(torch.autograd.Function):
    """exp with the forward input clamped to <= 80 and the gradient taken
    at the input clamped to <= 15 (torch-ngp's trick)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=80.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=15.0))


trunc_exp = TruncExp.apply


@dataclasses.dataclass(frozen=True)
class NGPHead:
    """One NGP MLP with its epilogue. ``hidden`` ReLU layers of 64 neurons
    and ``channels`` outputs; ``bf16``: JAX's rounding points
    (``ngp_mlp_apply_channels``), else float32 throughout
    (``ngp_mlp_apply``). ``epilogue``: "trunc_exp" is where(sel,
    trunc_exp(raw), 0), "sigmoid" is sigmoid(raw) * sel, "trunc_exp_m1" is
    where(sel, trunc_exp(raw - 1), 0)."""
    name: str
    hidden: int
    channels: int
    bf16: bool
    epilogue: str


# the density head, the colour head (perf_tpu/fields/ngp.py:134-200) and the
# proposal fields' density (:252-261)
GEO_HEAD = NGPHead("geo", 1, 1, True, "trunc_exp")
APP_HEAD = NGPHead("app", 2, 3, True, "sigmoid")
PROP_HEAD = NGPHead("prop", 1, 1, False, "trunc_exp_m1")


def head_epilogue(raw: torch.Tensor, sel: torch.Tensor,
                  head: NGPHead) -> torch.Tensor:
    """The activated channels [C, M] of raw [C, M] and sel [M] (bool)."""
    if head.epilogue == "sigmoid":
        return torch.sigmoid(raw) * sel.float()
    z = raw - 1.0 if head.epilogue == "trunc_exp_m1" else raw
    return torch.where(sel, trunc_exp(z), torch.zeros_like(z))


def head_epilogue_grad(raw: torch.Tensor, sel: torch.Tensor, g: torch.Tensor,
                       head: NGPHead) -> torch.Tensor:
    """d raw [C, M] from the activated channels' cotangent g [C, M]: the
    where's transpose, then ``trunc_exp``'s derivative taken at the input
    clamped to 15, or the sigmoid's y (1 - y) in JAX's order."""
    if head.epilogue == "sigmoid":
        y = torch.sigmoid(raw)
        return (g * sel.float()) * (y * (1.0 - y))
    z = raw - 1.0 if head.epilogue == "trunc_exp_m1" else raw
    return (torch.where(sel, g, torch.zeros_like(g))
            * torch.exp(torch.clamp(z, max=15.0)))


def ngp_head_plain(ws: list, x: torch.Tensor, sel: torch.Tensor,
                   head: NGPHead) -> tuple:
    """The head at inputs x [M, din] inside sel [M]: (the activated channels
    [C, M], the MLP's raw output [C, M])."""
    if head.bf16:
        raw = torch.stack(ngp_mlp_apply_channels({"w": ws}, x))
    else:
        raw = ngp_mlp_apply({"w": ws}, x).T.contiguous()
    return head_epilogue(raw, sel, head), raw


def ngp_head_bwd_plain(ws: list, x: torch.Tensor, sel: torch.Tensor,
                       raw: torch.Tensor, g: torch.Tensor, head: NGPHead,
                       need_dx: bool = True) -> tuple:
    """The head's backward written out: (dx [M, din] or None, the weights'
    gradients) from the activated channels' cotangent g [C, M]. The hidden
    layers are recomputed from x, rounded where the forward rounds; every
    cotangent that reaches a bf16 value is rounded to bf16 (both packages'
    autodiff transposes the cast), so dx and the bf16 layers' weight
    gradients are bf16-valued, each rounded once after its float32 sum;
    the last layer's gradient is float32."""
    rnd = _bf16 if head.bf16 else (lambda t: t)
    h = rnd(x)
    acts, pres = [h], []
    for w in ws[:-1]:
        pre = h @ rnd(w)
        pres.append(pre)
        h = rnd(torch.relu(pre))
        acts.append(h)
    d = head_epilogue_grad(raw, sel, g, head).T            # [M, C]
    w_last = ws[-1]
    grads = [None] * len(ws)
    grads[-1] = acts[-1].T @ d
    # the channels' cotangents of the last hidden layer, summed in channel
    # order
    d_h = d[:, :1] * w_last[:, 0]
    for c in range(1, w_last.shape[1]):
        d_h = d_h + d[:, c:c + 1] * w_last[:, c]
    for i in reversed(range(len(ws) - 1)):
        d_pre = torch.where(pres[i] > 0, rnd(d_h), torch.zeros_like(d_h))
        grads[i] = rnd(acts[i].T @ d_pre)
        if i or need_dx:
            d_h = d_pre @ rnd(ws[i]).T
    return (rnd(d_h) if need_dx else None), grads


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
