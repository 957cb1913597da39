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


def ngp_head_bwd_terms(ws: list, x: torch.Tensor, sel: torch.Tensor,
                       raw: torch.Tensor, g: torch.Tensor, head: NGPHead,
                       need_dx: bool = True) -> tuple:
    """The plain backward's terms: (each layer's input [M, din or 64],
    rounded where the forward rounds; each hidden layer's pre-activation
    cotangent [M, 64], masked by its ReLU and rounded where both packages'
    autodiff rounds; the raw outputs' cotangent [M, C]; the input's
    cotangent [M, din] before its rounding, or None). The hidden layers are
    recomputed from x."""
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
    # the channels' cotangents of the last hidden layer, summed in channel
    # order
    d_h = d[:, :1] * w_last[:, 0]
    for c in range(1, w_last.shape[1]):
        d_h = d_h + d[:, c:c + 1] * w_last[:, c]
    d_pres = [None] * len(pres)
    for i in reversed(range(len(pres))):
        d_pres[i] = torch.where(pres[i] > 0, rnd(d_h), torch.zeros_like(d_h))
        if i or need_dx:
            d_h = d_pres[i] @ rnd(ws[i]).T
    return acts, d_pres, d, (d_h if need_dx else None)


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
    acts, d_pres, d, d_x = ngp_head_bwd_terms(ws, x, sel, raw, g, head,
                                              need_dx)
    grads = [rnd(a.T @ dp) for a, dp in zip(acts, d_pres)]
    grads.append(acts[-1].T @ d)
    return (rnd(d_x) if need_dx else None), grads


def bf16_grad_sums_f64(ws: list, x: torch.Tensor, sel: torch.Tensor,
                       raw: torch.Tensor, g: torch.Tensor,
                       head: NGPHead) -> list:
    """A bf16 head's rounded gradients [dx [M, din], dW0, (dW1)] from the
    plain backward's float32 terms (its bf16 hidden values and bf16
    cotangents, each product exact in float32), summed in float64: the
    yardstick for two float32 sums of the same terms in other orders.
    Where the terms cancel, a float32 sum of the 131,072 terms of the
    colour head's step can land several bf16 ulps off it, and two float32
    sums in other orders more than one ulp apart."""
    acts, d_pres, _, _ = ngp_head_bwd_terms(ws, x, sel, raw, g, head,
                                            need_dx=False)
    pairs = [(a.double(), d.double()) for a, d in zip(acts, d_pres)]
    return ([pairs[0][1] @ _bf16(ws[0]).double().T]
            + [a.T @ d for a, d in pairs])


# How far two float32 sums of the same k <= 64 bf16 x bf16 products (each
# exact in float32) may lie apart, relative to the sum of the terms'
# magnitudes: any order of the plain version's sums lies within (k - 1)
# 2^-24 <= 2^-18 of the exact sum; the tensor cores' k16 sums, their 16
# products aligned to the largest and truncated (each by less than 2^-23
# of the largest), and the rounded adds of up to 4 of them, within 1.25
# 2^-19; together 1.63 2^-18, under this.
SUM_ORDER_REL = 2.0 ** -17
# How far two float32 evaluations of exp or of the sigmoid (another
# library's) may lie apart, relative.
EPILOGUE_REL = 2.0 ** -20


def bf16_ulp_f64(v: torch.Tensor) -> torch.Tensor:
    """The bf16 ulp at |v| (float64): 2^(e - 7) for |v| in [2^e, 2^(e+1)),
    2^-133 (bf16's smallest subnormal) at 0 and below 2^-126."""
    _, e = torch.frexp(v)
    e = torch.where(v == 0, torch.full_like(e, -125), e)
    return torch.ldexp(torch.ones_like(v), (e - 8).clamp_min(-133))


def bf16_round_f64(v: torch.Tensor) -> torch.Tensor:
    """Float64 values rounded to bf16 (to nearest, ties to even) exactly,
    with no float32 step between."""
    ulp = bf16_ulp_f64(v)
    return torch.round(v / ulp) * ulp


def _bf16_ends(v: torch.Tensor, reach: torch.Tensor) -> tuple:
    """The bf16 roundings of the ends of [v - reach, v + reach] (float64):
    rounding is monotone, so every value there rounds between them."""
    v = v.double()
    return bf16_round_f64(v - reach), bf16_round_f64(v + reach)


def _epilogue_reach(raw: torch.Tensor, sel: torch.Tensor, g: torch.Tensor,
                    head: NGPHead) -> torch.Tensor:
    """How far another float32 evaluation of ``head_epilogue_grad`` may lie
    from this one, [C, M] float64: exp within EPILOGUE_REL relative; the
    sigmoid's y within EPILOGUE_REL y, so y (1 - y) within EPILOGUE_REL y
    plus its own rounding."""
    if head.epilogue == "sigmoid":
        y = torch.sigmoid(raw).double()
        return ((g.double() * sel.double()).abs()
                * (EPILOGUE_REL * y + 2.0 ** -22 * y * (1.0 - y)))
    return EPILOGUE_REL * head_epilogue_grad(raw, sel, g, head).double().abs()


def bf16_head_reach(ws: list, x: torch.Tensor, sel: torch.Tensor,
                    raw: torch.Tensor, g: torch.Tensor, head: NGPHead) -> dict:
    """How far a bf16 head's backward with its float32 sums in another order
    may lie from ``ngp_head_bwd_plain``'s, carried through the layers from
    the plain version's own values: every sum of products within
    SUM_ORDER_REL of the sum of its terms' magnitudes (plus what the moves
    of its inputs upstream carry), the epilogue's derivative within
    ``_epilogue_reach``. A hidden output or cotangent moves only as far as
    the bf16 roundings of its reach's ends lie apart (a tie rounded the
    other way), a ReLU decides the other way only where its plain
    pre-activation lies within its reach of zero, and then the unit's
    cotangent moves by at most its own magnitude. Returns {"dx": the bound
    on |dx - plain dx| [M, din] (the span of dx's rounding), "terms": for
    each bf16 weight gradient, the bound on how far the exact sum of the
    other version's terms lies from that of the plain version's, "last":
    the same for the last layer [64, C], "tie_free": the points [M] (bool)
    whose every hidden output and cotangent rounds as the plain version's
    and whose every ReLU decides as its, so that only dx's own rounding
    and the sums' order remain}. All float64."""
    rnd, f64 = _bf16, torch.float64
    h = rnd(x)
    acts, moves, pres, flips = [h], [torch.zeros_like(h, dtype=f64)], [], []
    for w in ws[:-1]:
        wa = rnd(w).abs().double()
        pre = h @ rnd(w)
        reach = (SUM_ORDER_REL * ((h.abs().double() + moves[-1]) @ wa)
                 + moves[-1] @ wa)
        p64 = pre.double()
        lo, hi = (bf16_round_f64(torch.relu(p64 - reach)),
                  bf16_round_f64(torch.relu(p64 + reach)))
        pres.append(pre)
        flips.append((p64 - reach <= 0) & (p64 + reach > 0))
        h = rnd(torch.relu(pre))
        acts.append(h)
        moves.append(hi - lo)
    d = head_epilogue_grad(raw, sel, g, head).T
    d_move = _epilogue_reach(raw, sel, g, head).T
    w_last = ws[-1]
    wla = w_last.abs().double()
    d_h = d[:, :1] * w_last[:, 0]
    for c in range(1, w_last.shape[1]):
        d_h = d_h + d[:, c:c + 1] * w_last[:, c]
    # the channel sum's own roundings, where an input moved
    reach = (d_move @ wla.T * (1.0 + 2.0 ** -20)
             + 2.0 ** -21 * (d.abs().double() @ wla.T)
             * (d_move > 0).any(dim=1, keepdim=True))
    terms = [None] * len(pres)
    tie_free = torch.ones_like(sel)
    for i in reversed(range(len(pres))):
        lo, hi = _bf16_ends(d_h, reach)
        on = pres[i] > 0
        d_pre = torch.where(on, rnd(d_h), torch.zeros_like(d_h)).double()
        dd = torch.where(flips[i], torch.maximum(lo.abs(), hi.abs()),
                         torch.where(on, hi - lo, torch.zeros_like(lo)))
        terms[i] = (moves[i].T @ (d_pre.abs() + dd)
                    + acts[i].abs().double().T @ dd)
        tie_free &= (dd == 0).all(dim=1) & (moves[i + 1] == 0).all(dim=1)
        wa = rnd(ws[i]).abs().double()
        reach = SUM_ORDER_REL * ((d_pre.abs() + dd) @ wa.T) + dd @ wa.T
        d_h = d_pre.float() @ rnd(ws[i]).T
    lo, hi = _bf16_ends(d_h, reach)
    d64 = d.abs().double()
    last = moves[-1].T @ (d64 + d_move) + acts[-1].abs().double().T @ d_move
    return {"dx": hi - lo, "terms": terms, "last": last,
            "tie_free": tie_free}


def bf16_grads_within(got: list, want: list, sums: list, reach: dict,
                      last_rel: float = 1e-5) -> dict:
    """A bf16 head's backward ``got`` [dx, dW0, (dW1), dWL] against the
    plain version's ``want`` on the same inputs, with the float64 sums of
    the plain version's terms ``sums`` (``bf16_grad_sums_f64``) and its
    ``bf16_head_reach``: dx, each entry within one bf16 ulp or within the
    span its reach gives; a bf16 weight gradient, each entry within one
    bf16 ulp, or no farther from its float64 sum than the plain version is
    plus one ulp plus how far the other version's terms' exact sum may lie
    (their reach); the last layer within ``last_rel`` relative norm plus
    its terms' reach. Where no tie reaches (``reach["tie_free"]`` covers
    every point with a cotangent), the terms' reach is 0 and these are the
    plain rules: one ulp, the float64 sum; the last layer's reach keeps the
    epilogue's moves there (about 1e-3 of its norm at 2^20 points, too
    wide to see a 64-point tile left out). Returns {"ok": each
    check's verdict, "max_ulps": the largest move in bf16 ulps, "past_ulp":
    entries past one ulp, "past_reach": entries past their bound}."""
    ok, max_ulps, past_ulp, past_reach = {}, {}, {}, {}
    names = ["dx"] + [f"dW{i}" for i in range(len(got) - 2)]
    for i, name in enumerate(names):
        a, b = got[i].double(), want[i].double()
        ulp = bf16_ulp_f64(torch.maximum(a.abs(), b.abs()))
        off = (a - b).abs()
        if i == 0:
            bad = off > torch.maximum(ulp, reach["dx"])
        else:
            e = sums[i]
            ulp = bf16_ulp_f64(torch.maximum(ulp, e.abs()))
            bad = (off > ulp) & ((a - e).abs() > (b - e).abs() + ulp
                                 + reach["terms"][i - 1])
        ok[name] = bool(torch.equal(a, a.to(torch.bfloat16).double())
                        and not bad.any())
        max_ulps[name] = (off / ulp).max().item() if off.numel() else 0.0
        past_ulp[name] = int((off > ulp).sum())
        past_reach[name] = int(bad.sum())
    a, b = got[-1].double(), want[-1].double()
    ok["last"] = bool((a - b).norm() <= last_rel * b.norm()
                      + reach["last"].norm())
    return {"ok": ok, "max_ulps": max_ulps, "past_ulp": past_ulp,
            "past_reach": past_reach,
            "last_rel": ((a - b).norm() / b.norm()).item() if b.norm() > 0
            else a.abs().max().item()}


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
