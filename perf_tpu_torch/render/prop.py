"""The proposal-network estimator (K11): nerfacc's PropNetEstimator.

Counterpart of ``perf_tpu/render/prop.py``: ``PropRenderConfig``, the
inverse-CDF resampling (``sample_from_weights``), the weights of a density
along a ray (``weights_from_density``, the last proposal sample's sigma
set to 1e10), the cascade render ``render_rays_prop`` and the PDF-matching
``prop_loss``. The published PeRF declares this path but ships it broken;
the JAX package is the reference.

Each of the three functions has a plain version here and a CUDA route
(``kernels/csrc/prop.cu``): CUDA tensors launch the kernel, CPU tensors
take the plain version, and a failed build or launch raises. The two that
train (weights and loss) are ``torch.autograd.Function``s whose backward is
a kernel too. Both routes follow JAX's float32 arithmetic on the CPU:

- prefix sums in XLA's CPU order (``xla_cumsum``: blocks of 16 in
  sequence, then the block totals);
- the transmittance prefix as the inclusive prefix minus tau, so the 1e10
  sigma's tau (~1.5e8, ulp 16) rounds the prefix before the last bin to a
  multiple of 16 as JAX does;
- ``jnp.searchsorted``'s binary search (``searchsorted_left``);
- the resampling's eps 1e-5, CDF normalisation and 1e-10 floor.

The randomness enters as explicit draws (``prop_draws``): the level-0
jitter [N, 1], one stratified u [N, 1] per proposal level, the background
colour [N, 3] and the background distance noise [N, 1]. Eval takes none:
linspace u, no jitter, the configured background (black in the scene's
eval) and distance + ``eval_bg_distance`` * (1 - opacity).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fields.ngp import (NGPFieldConfig, query_density_field,
                          query_density_ray, query_rgb_ray)
from ..kernels import cuda

BLOCK = 16             # XLA's CPU cumsum block
MAX_BINS = 256         # the kernels' bins (and output samples) per ray
LAST_SIGMA = 1e10      # the last proposal sample's density (prop.py:102)


@dataclasses.dataclass(frozen=True)
class PropRenderConfig:
    near: float = 1e-2
    far: float = 2.0
    n_samples: int = 64
    n_samples_per_prop: tuple = (128, 64)
    bg_color: str = "rand_noise"
    eval_bg_distance: float = 5.0


# -- JAX's arithmetic -------------------------------------------------------

def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    acc, outs = x[..., 0], [x[..., 0]]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sums along the last axis in the order of
    ``jnp.cumsum`` on the CPU (XLA's reduce-window rewrite): the axis in
    blocks of 16, each scanned in sequence, each offset by the sequential
    sum of the block totals before it (recursively past 16 blocks)."""
    n = x.shape[-1]
    if n <= BLOCK:
        return _seq_cumsum(x)
    nb = -(-n // BLOCK)
    pad = torch.nn.functional.pad(x, (0, nb * BLOCK - n))
    inner = _seq_cumsum(pad.reshape(*x.shape[:-1], nb, BLOCK))
    totals = xla_cumsum(inner[..., -1])
    pre = torch.cat([torch.zeros_like(totals[..., :1]), totals[..., :-1]], -1)
    out = (pre[..., None] + inner).reshape(*x.shape[:-1], nb * BLOCK)
    return out[..., :n]


def searchsorted_left(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row-wise ``jnp.searchsorted(a, q)`` (side left, method scan): a fixed
    ceil(log2(len + 1)) halvings of [0, len), going left where q <=
    a[mid]; the first i with q <= a[i] for sorted rows. a [N, L], q [N, K]
    -> int64 [N, K]."""
    length = a.shape[-1]
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, length, dtype=torch.int64, device=q.device)
    for _ in range(int(np.ceil(np.log2(length + 1)))):
        mid = (lo + hi) // 2
        left = q <= torch.gather(a, -1, mid.clamp(max=length - 1))
        lo, hi = torch.where(left, lo, mid), torch.where(left, mid, hi)
    return hi


def linspace_f32(start: float, stop: float, num: int, device=None):
    """``jnp.linspace(start, stop, num)`` in float32: start * (1 - s) + stop
    * s with s = i / (num - 1), the last entry exactly ``stop``."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    out = (torch.tensor(start, dtype=torch.float32) * (1 - s)
           + torch.tensor(stop, dtype=torch.float32) * s)
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def stratified_u(draw: torch.Tensor, n_new: int) -> torch.Tensor:
    """u [N, n_new + 1] = i / (n_new + 1) + draw / (n_new + 1), one uniform
    draw [N, 1] per ray."""
    i = torch.arange(n_new + 1, dtype=torch.float32, device=draw.device)
    return (i / (n_new + 1))[None] + draw / (n_new + 1)


def linspace_u(n_rays: int, n_new: int, device=None) -> torch.Tensor:
    return linspace_f32(0.0, 1.0, n_new + 1, device).expand(n_rays, n_new + 1)


def _override_last(sigma: torch.Tensor) -> torch.Tensor:
    return torch.cat([sigma[:, :-1], torch.full_like(sigma[:, -1:],
                                                     LAST_SIGMA)], dim=1)


# -- plain versions ---------------------------------------------------------

def sample_from_weights_plain(edges: torch.Tensor, weights: torch.Tensor,
                              u: torch.Tensor):
    """Inverse-CDF resampling: edges [N, M+1], weights [N, M], u [N, n+1]
    -> (new edges [N, n+1], searched indices [N, n+1] int64, clipped to
    [1, M])."""
    cdf = xla_cumsum(weights + 1e-5)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=1)
    cdf = cdf / cdf[:, -1:]
    idx = searchsorted_left(cdf, u).clamp(1, cdf.shape[1] - 1)
    c_lo, c_hi = torch.gather(cdf, 1, idx - 1), torch.gather(cdf, 1, idx)
    t_lo, t_hi = torch.gather(edges, 1, idx - 1), torch.gather(edges, 1, idx)
    frac = torch.clamp((u - c_lo) / torch.clamp(c_hi - c_lo, min=1e-10),
                       0.0, 1.0)
    return t_lo + frac * (t_hi - t_lo), idx


def _tau(sigma, edges, override_last: bool):
    if override_last:
        sigma = _override_last(sigma)
    dt = edges[:, 1:] - edges[:, :-1]
    return sigma * dt, dt


def weights_from_density_plain(sigma: torch.Tensor, edges: torch.Tensor,
                               override_last: bool = False) -> torch.Tensor:
    """w = T (1 - e^-tau), tau = sigma dt, T = exp(-(C - tau)) with C the
    inclusive prefix of tau; ``override_last``: the last sigma is 1e10."""
    tau, _ = _tau(sigma, edges, override_last)
    trans = torch.exp(-(xla_cumsum(tau) - tau))
    return trans * (1.0 - torch.exp(-tau))


def weights_from_density_bwd_plain(sigma: torch.Tensor, edges: torch.Tensor,
                                   g: torch.Tensor,
                                   override_last: bool = False):
    """d sigma [N, M] from dw, as JAX's autodiff: dX = -((g alpha) T), R the
    suffix sums of dX, dtau = (g T) e^-tau + (R - dX), dsigma = dtau dt; 0
    for an overridden last sigma."""
    tau, dt = _tau(sigma, edges, override_last)
    trans = torch.exp(-(xla_cumsum(tau) - tau))
    e = torch.exp(-tau)
    dx = -((g * (1.0 - e)) * trans)
    suffix = xla_cumsum(dx.flip(-1)).flip(-1)
    dsigma = ((g * trans) * e + (suffix - dx)) * dt
    if override_last:
        dsigma = torch.cat([dsigma[:, :-1], torch.zeros_like(dsigma[:, -1:])],
                           dim=1)
    return dsigma


def _interval_excess(te, wp, tf, wf):
    """(w - bound, bound's CDF rows lo and hi) of each final interval."""
    m = wp.shape[1]
    cdf = torch.cat([torch.zeros_like(wp[:, :1]), xla_cumsum(wp)], dim=1)
    lo = (searchsorted_left(te, tf[:, :-1]) - 1).clamp(0, m)
    hi = searchsorted_left(te, tf[:, 1:]).clamp(0, m)
    bound = torch.gather(cdf, 1, hi) - torch.gather(cdf, 1, lo)
    return wf - bound, lo, hi


def prop_loss_plain(te: torch.Tensor, wp: torch.Tensor, tf: torch.Tensor,
                    wf: torch.Tensor) -> torch.Tensor:
    """One proposal level: per-ray sum [N] of clip(w - bound, 0)^2 / (w +
    1e-7) over the final intervals; bound is the proposal mass over the
    bins that the interval overlaps."""
    x = torch.clamp(_interval_excess(te, wp, tf, wf)[0], min=0.0)
    return _seq_sum(x * x / (wf + 1e-7))


def prop_loss_bwd_plain(te, wp, tf, wf, g: torch.Tensor) -> torch.Tensor:
    """d proposal weights [N, M] from the per-ray sums' cotangent g [N]."""
    d, lo, hi = _interval_excess(te, wp, tf, wf)
    gx = (g[:, None] / (wf + 1e-7)) * (2.0 * torch.clamp(d, min=0.0))
    db = torch.where(d > 0, -gx, torch.where(d == 0, -(0.5 * gx),
                                             torch.zeros_like(gx)))
    dcdf = torch.zeros((wp.shape[0], wp.shape[1] + 1), dtype=wp.dtype,
                       device=wp.device)
    dcdf.scatter_add_(1, hi, db)
    dcdf.scatter_add_(1, lo, -db)
    return xla_cumsum(dcdf[:, 1:].flip(-1)).flip(-1)


# -- kernels ----------------------------------------------------------------

def _kernel(name: str, symbol: str, args: list) -> cuda.CudaKernel:
    return cuda.register(cuda.CudaKernel(name, "prop.cu", symbol, args,
                                         extra_flags=("-fmad=false",)))


_P, _I = cuda.P, cuda.I32
_RESAMPLE = _kernel("prop_resample", "prop_resample_launch",
                    [_P, _P, _P, _I, _I, _I, _P, _P])
_WEIGHTS = _kernel("prop_weights", "prop_weights_launch",
                   [_P, _P, _I, _I, _I, _P])
_WEIGHTS_BWD = _kernel("prop_weights_bwd", "prop_weights_bwd_launch",
                       [_P, _P, _P, _I, _I, _I, _P])
_LOSS = _kernel("prop_loss", "prop_loss_launch",
                [_P, _P, _P, _P, _I, _I, _I, _P])
_LOSS_BWD = _kernel("prop_loss_bwd", "prop_loss_bwd_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _P])


def _check_bins(n_rays: int, m: int, what: str):
    if not 0 < m <= MAX_BINS or n_rays <= 0:
        raise ValueError(f"{what}: the prop kernels take 1..{MAX_BINS} bins "
                         f"and at least one ray, got {n_rays} x {m}")


def _rows(*pairs):
    """Check each (tensor, name, shape) as a contiguous float32 CUDA tensor
    on the first one's device."""
    dev = pairs[0][0].device
    for t, name, shape in pairs:
        cuda.check(t, name, torch.float32, shape, dev)


def sample_from_weights_cuda(edges, weights, u, return_idx: bool = False):
    n, m = weights.shape
    _check_bins(n, m, "prop_resample")
    k = u.shape[1]
    if k > MAX_BINS + 1:
        raise ValueError(f"prop_resample: at most {MAX_BINS + 1} new edges")
    _rows((edges, "edges", (n, m + 1)), (weights, "weights", (n, m)),
          (u, "u", (n, k)))
    out = torch.empty((n, k), dtype=torch.float32, device=edges.device)
    idx = (torch.empty((n, k), dtype=torch.int32, device=edges.device)
           if return_idx else None)
    _RESAMPLE.launch(edges.data_ptr(), weights.data_ptr(), u.data_ptr(), n, m,
                     k, out.data_ptr(), idx.data_ptr() if return_idx else None)
    return (out, idx) if return_idx else out


def weights_from_density_cuda(sigma, edges, override_last: bool = False):
    n, m = sigma.shape
    _check_bins(n, m, "prop_weights")
    _rows((sigma, "sigma", (n, m)), (edges, "edges", (n, m + 1)))
    w = torch.empty_like(sigma)
    _WEIGHTS.launch(sigma.data_ptr(), edges.data_ptr(), n, m,
                    int(override_last), w.data_ptr())
    return w


def weights_from_density_bwd_cuda(sigma, edges, g, override_last: bool = False):
    n, m = sigma.shape
    _check_bins(n, m, "prop_weights_bwd")
    _rows((sigma, "sigma", (n, m)), (edges, "edges", (n, m + 1)),
          (g, "g", (n, m)))
    dsigma = torch.empty_like(sigma)
    _WEIGHTS_BWD.launch(sigma.data_ptr(), edges.data_ptr(), g.data_ptr(), n,
                        m, int(override_last), dsigma.data_ptr())
    return dsigma


def _loss_args(te, wp, tf, wf):
    n, m = wp.shape
    k = wf.shape[1]
    _check_bins(n, m, "prop_loss")
    if not 0 < k <= MAX_BINS:
        raise ValueError(f"prop_loss: 1..{MAX_BINS} final intervals, got {k}")
    _rows((te, "te", (n, m + 1)), (wp, "wp", (n, m)), (tf, "tf", (n, k + 1)),
          (wf, "wf", (n, k)))
    return n, m, k


def prop_loss_cuda(te, wp, tf, wf):
    n, m, k = _loss_args(te, wp, tf, wf)
    out = torch.empty((n,), dtype=torch.float32, device=wp.device)
    _LOSS.launch(te.data_ptr(), wp.data_ptr(), tf.data_ptr(), wf.data_ptr(),
                 n, m, k, out.data_ptr())
    return out


def prop_loss_bwd_cuda(te, wp, tf, wf, g):
    n, m, k = _loss_args(te, wp, tf, wf)
    cuda.check(g, "g", torch.float32, (n,), wp.device)
    dwp = torch.empty_like(wp)
    _LOSS_BWD.launch(te.data_ptr(), wp.data_ptr(), tf.data_ptr(),
                     wf.data_ptr(), g.data_ptr(), n, m, k, dwp.data_ptr())
    return dwp


def _route(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); anything else raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


# -- the routes, with gradients ---------------------------------------------

def sample_from_weights(edges: torch.Tensor, weights: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """New edges [N, n+1] without gradient (JAX stops it)."""
    edges, weights, u = (t.detach().contiguous() for t in (edges, weights, u))
    if _route(edges, "prop_resample"):
        return sample_from_weights_cuda(edges, weights, u)
    return sample_from_weights_plain(edges, weights, u)[0]


class PropWeights(torch.autograd.Function):
    """w of ``weights_from_density`` with d sigma; the edges get none (level
    0's carry no parameter, later levels' are stop-gradient)."""

    @staticmethod
    def forward(ctx, sigma, edges, override_last):
        ctx.save_for_backward(sigma, edges)
        ctx.override_last = override_last
        if _route(sigma, "prop_weights"):
            return weights_from_density_cuda(sigma, edges, override_last)
        return weights_from_density_plain(sigma, edges, override_last)

    @staticmethod
    def backward(ctx, g):
        sigma, edges = ctx.saved_tensors
        fn = (weights_from_density_bwd_cuda if g.is_cuda
              else weights_from_density_bwd_plain)
        return fn(sigma, edges, g.contiguous(), ctx.override_last), None, None


def weights_from_density(sigma: torch.Tensor, edges: torch.Tensor,
                         override_last: bool = False) -> torch.Tensor:
    return PropWeights.apply(sigma.contiguous(), edges.detach().contiguous(),
                             bool(override_last))


class PropLoss(torch.autograd.Function):
    """Per-ray sums of one proposal level's loss with d proposal weights;
    the final weights and all edges are stop-gradient."""

    @staticmethod
    def forward(ctx, te, wp, tf, wf):
        ctx.save_for_backward(te, wp, tf, wf)
        if _route(wp, "prop_loss"):
            return prop_loss_cuda(te, wp, tf, wf)
        return prop_loss_plain(te, wp, tf, wf)

    @staticmethod
    def backward(ctx, g):
        te, wp, tf, wf = ctx.saved_tensors
        fn = prop_loss_bwd_cuda if g.is_cuda else prop_loss_bwd_plain
        return None, fn(te, wp, tf, wf, g.contiguous()), None, None


def prop_loss(final_edges: torch.Tensor, final_weights: torch.Tensor,
              prop_aux: list) -> torch.Tensor:
    """The PDF-matching loss summed over the proposal levels, each level
    the mean over rays and final intervals (mip-NeRF 360 eq. 13)."""
    tf = final_edges.detach().contiguous()
    wf = final_weights.detach().contiguous()
    loss = torch.zeros((), dtype=torch.float32, device=wf.device)
    for level in prop_aux:
        per_ray = PropLoss.apply(level["edges"].detach().contiguous(),
                                 level["weights"].contiguous(), tf, wf)
        loss = loss + per_ray.sum() / wf.numel()
    return loss


# -- the cascade render -----------------------------------------------------

def prop_draws(generator: torch.Generator, n: int, cfg: PropRenderConfig,
               device) -> dict:
    """A training render's uniform draws from ``generator``."""
    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=device)
    return {"jitter": uniform(n, 1),
            "u": [uniform(n, 1) for _ in cfg.n_samples_per_prop],
            "bg": uniform(n, 3), "noise": uniform(n, 1)}


def _points(rays_o, rays_d, edges):
    mids = 0.5 * (edges[:, 1:] + edges[:, :-1])
    return mids, [rays_o[:, a:a + 1] + rays_d[:, a:a + 1] * mids
                  for a in range(3)]


def render_rays_prop(params: dict, prop_params: list,
                     field_cfg: NGPFieldConfig, prop_cfgs: list,
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     cfg: PropRenderConfig, train: bool,
                     draws: dict | None = None,
                     need_rgb: bool = True) -> dict:
    """Uniform (jittered) edges over [near, far], then per proposal field:
    densities at the mid-points, weights with the last sigma at 1e10,
    resampling to the next level's count; then the final field (its
    grid's encode kernels, stride 1) composited with the background.
    ``draws`` (``prop_draws``) only when ``train``. Returns rgb, distance,
    opacity, weights, t_edges and prop_aux (each level's edges and
    weights) as JAX's ``render_rays_prop``; without ``need_rgb`` the colour
    head is not evaluated and rgb is left out (the geometry phase's loss
    does not read it)."""
    n = rays_o.shape[0]
    dev = rays_o.device
    n0 = cfg.n_samples_per_prop[0]
    edges = linspace_f32(cfg.near, cfg.far, n0 + 1, dev).expand(n, n0 + 1)
    if train:
        step = float(np.float32((cfg.far - cfg.near) / n0))
        edges = edges + draws["jitter"] * step
    aux = []
    counts = list(cfg.n_samples_per_prop[1:]) + [cfg.n_samples]
    for level, (pp, pc) in enumerate(zip(prop_params, prop_cfgs)):
        _, (px, py, pz) = _points(rays_o, rays_d, edges)
        sigma = query_density_field(pp, torch.stack([px, py, pz], -1),
                                    pc)[..., 0]
        w = weights_from_density(sigma, edges, override_last=True)
        aux.append({"edges": edges, "weights": w})
        u = (stratified_u(draws["u"][level], counts[level]) if train
             else linspace_u(n, counts[level], dev))
        edges = sample_from_weights(edges, w, u)

    mids, (px, py, pz) = _points(rays_o, rays_d, edges)
    point_form = (1,) * field_cfg.grid.n_levels
    sigma = query_density_ray(params["geo"], px, py, pz, field_cfg,
                              point_form)
    weights = weights_from_density(sigma, edges)
    opacity = torch.sum(weights, -1, keepdim=True)
    distance = torch.sum(weights * mids, -1, keepdim=True)
    rest = 1.0 - opacity
    if train:
        distance = distance + draws["noise"] * rest
    else:
        distance = distance + cfg.eval_bg_distance * rest
    out = {"distance": distance, "opacity": opacity, "weights": weights,
           "t_edges": edges, "prop_aux": aux}
    if not need_rgb:
        return out
    r, g, b = query_rgb_ray(params["app"], px, py, pz, field_cfg, point_form)
    colors = torch.stack([torch.sum(weights * c, -1) for c in (r, g, b)], -1)
    if cfg.bg_color == "rand_noise" and train:
        bg = draws["bg"]
    elif cfg.bg_color == "white":
        bg = torch.ones((n, 3), device=dev)
    else:
        bg = torch.zeros((n, 3), device=dev)
    return {**out, "rgb": colors + bg * rest}
