"""The occupancy march and the training composite.

Counterpart of ``perf_tpu/render/renderer.py``: ``RenderConfig``,
``coarse_occ_grid``, ``_probe_points``, ``count_occupied_windows``,
``_select_segments``, ``_fine_windows_from_segments``,
``_windows_to_samples``, ``march_windows`` / ``march_rays`` (eval and
stratified), ``shade_rays`` with ``train=True``, ``render_rays``,
``render_rays_bucketed``, ``beam_dilation`` and ``frame_march_plan``. The
march probes a 4x-pooled, dilated coarse grid once per segment of
``segment_windows`` windows, keeps the first ``max_segments`` occupied
segments, then probes the fine grid at every window of those and keeps the
first ``max_windows`` occupied windows in t order. ``render_image`` is the
eval form of the field path at a fixed budget (``adaptive_eval=False``),
which the mid-episode previews use; every other eval frame goes through
the baked snapshot (``render/snapshot.py``).

Kernels for CUDA tensors, plain versions for CPU tensors:
``march_windows`` and ``count_occupied_windows``
(``kernels/csrc/march_windows.cu``), ``shade_composite``
(``kernels/csrc/shade_composite.cu``, the composite and the distortion loss
with their gradient). The plain march follows the JAX code operation for
operation (float32 throughout, ``top_k`` with its tie order), so window
indices agree exactly, in the invalid slots too.

Randomness comes in as tensors: the march jitter [N, 1] and, per ray, the
background colour draw [N, 3] and the distance-noise draw [N, 1] (uniforms
in [0, 1)), so a test can hand both packages the same draws.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels import cuda
from ..kernels.distortion import distortion_per_ray
from ..kernels.hashgrid import level_strides


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The JAX ``RenderConfig`` without the knobs of unported paths
    (``remat``, ``adaptive_eval``) and of the flat march (``hier_march``:
    the march is always hierarchical)."""
    near: float = 0.0
    far: float = 1.5
    step: float = 5e-4
    max_samples: int = 256
    occ_res: int = 256
    # shell dilation of the pool's occupancy grid (occ_grid_from_points)
    occ_dilation: int = 1
    bg_color: str = "rand_noise"      # 'rand_noise' | 'white' | 'black'
    eval_bg_distance: float = 5.0
    march_coarse: int = 8
    level_subsampling: bool = True
    segment_windows: int = 4
    # rgb of a train step / an eval render only at the top-K weight windows
    # (0 = every sample)
    train_rgb_windows: int = 4
    eval_rgb_windows: int = 4
    sample_stride: int = 1
    eval_chunk: int = 32768   # rays per eval-render chunk (render_image)
    # per-level brick-run caps of the run-dedup encode (brick grids; the
    # training steps' config carries the episode's probed caps,
    # TrainConfig.dedup_runs; shade_rays_eval reads none, as JAX's eval);
    # None = the standard encode
    run_caps: tuple | None = None

    @property
    def n_march(self) -> int:
        m = int(math.ceil((self.far - self.near) / self.step))
        c = self.march_coarse
        return ((m + c - 1) // c) * c

    @property
    def n_windows(self) -> int:
        return self.n_march // self.march_coarse

    @property
    def samples_per_window(self) -> int:
        if self.march_coarse % self.sample_stride:
            raise ValueError("sample_stride must divide march_coarse")
        return self.march_coarse // self.sample_stride

    @property
    def max_windows(self) -> int:
        if self.max_samples % self.samples_per_window:
            raise ValueError("samples_per_window must divide max_samples")
        return self.max_samples // self.samples_per_window

    @property
    def n_segments(self) -> int:
        return (self.n_windows + self.segment_windows - 1) // self.segment_windows

    @property
    def max_segments(self) -> int:
        return min(self.n_segments,
                   self.max_windows // self.segment_windows + 2)


def top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: descending, and among equal values
    the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def coarse_occ_grid(occ_grid: torch.Tensor, res: int,
                    dilate: int = 1) -> torch.Tensor:
    """4x max-pooled, (2*dilate+1)^3-dilated occupancy, flat uint8."""
    g = occ_grid.reshape(1, 1, res, res, res).float()
    coarse = F.max_pool3d(g, 4, 4)
    k = 2 * dilate + 1
    dilated = F.max_pool3d(coarse, k, 1, padding=dilate)
    return dilated.reshape(-1).to(torch.uint8)


def probe_points(occ_grid: torch.Tensor, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, t: torch.Tensor, res: int):
    """Occupancy at ray points: t [N, P] -> int32 [N, P]."""
    def axis_voxel(a):
        w = rays_o[:, a:a + 1] + rays_d[:, a:a + 1] * t
        return ((torch.clamp(w, -0.999, 0.999) * 0.5 + 0.5) * res).to(
            torch.int64)
    flat = axis_voxel(0) * (res * res) + axis_voxel(1) * res + axis_voxel(2)
    return occ_grid[flat].to(torch.int32)


def count_occupied_windows_plain(occ_grid, rays_o, rays_d,
                                 cfg: RenderConfig) -> torch.Tensor:
    c = cfg.march_coarse
    wsteps = torch.arange(cfg.n_windows, dtype=torch.float32,
                          device=rays_o.device)
    counts = torch.zeros((rays_o.shape[0],), dtype=torch.int32,
                         device=rays_o.device)
    for jit_off in (0.0, 0.999):
        t = cfg.near + ((wsteps[None, :] * c + 0.5 * c + jit_off)
                        * cfg.step).expand(rays_o.shape[0], -1)
        occ = probe_points(occ_grid, rays_o, rays_d, t, cfg.occ_res)
        occ = occ * (t < cfg.far)
        counts = torch.maximum(counts, occ.sum(dim=1, dtype=torch.int32))
    return counts


_COUNT = cuda.register(cuda.CudaKernel(
    "count_windows", "march_windows.cu", "count_windows_launch",
    [cuda.P, cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.P, cuda.F32, cuda.F32,
     cuda.F32, cuda.I32, cuda.I32],
    extra_flags=("-fmad=false",)))


def count_occupied_windows_cuda(occ_grid, rays_o, rays_d,
                                cfg: RenderConfig) -> torch.Tensor:
    n = rays_o.shape[0]
    dev = rays_o.device
    cuda.check(rays_o, "rays_o", torch.float32, (n, 3))
    cuda.check(rays_d, "rays_d", torch.float32, (n, 3), dev)
    cuda.check(occ_grid, "occ_grid", torch.uint8, (cfg.occ_res ** 3,), dev)
    counts = torch.empty((n,), dtype=torch.int32, device=dev)
    _COUNT.launch(rays_o.data_ptr(), rays_d.data_ptr(), n,
                  occ_grid.data_ptr(), cfg.occ_res, counts.data_ptr(),
                  float(cfg.near), float(cfg.far), float(cfg.step),
                  cfg.march_coarse, cfg.n_windows)
    return counts


def count_occupied_windows(occ_grid, rays_o, rays_d, cfg: RenderConfig):
    """Per-ray count of occupied windows over the full flat ladder, probed
    at both jitter extremes (0 and 0.999): the bound that sizes the
    per-episode sample budget. The kernel's count entry for CUDA tensors,
    the plain version for CPU tensors."""
    if rays_o.is_cuda:
        return count_occupied_windows_cuda(occ_grid, rays_o, rays_d, cfg)
    if rays_o.device.type != "cpu":
        raise ValueError(f"count_occupied_windows: unsupported {rays_o.device}")
    return count_occupied_windows_plain(occ_grid, rays_o, rays_d, cfg)


def select_segments(coarse: torch.Tensor, rays_o, rays_d,
                    cfg: RenderConfig, jitter=None):
    """Coarse stage: (sidx int32 [N, max_segments], svalid bool)."""
    n = rays_o.shape[0]
    nseg, sw, c = cfg.n_segments, cfg.segment_windows, cfg.march_coarse
    segs = torch.arange(nseg, dtype=torch.float32, device=rays_o.device)
    t_seg = (segs[None, :] * sw + 0.5 * sw) * c
    if jitter is not None:
        t_seg = t_seg + jitter
    t_seg = (cfg.near + t_seg * cfg.step).expand(n, -1)
    seg_occ = (probe_points(coarse, rays_o, rays_d, t_seg, cfg.occ_res // 4)
               * (t_seg < cfg.far))
    skeys = seg_occ * (nseg - torch.arange(nseg, dtype=torch.int32,
                                           device=rays_o.device))[None, :]
    svals, sidx = top_k(skeys, cfg.max_segments)
    return sidx.to(torch.int32), svals > 0


def fine_windows_from_segments(occ_grid, rays_o, rays_d, sidx, svalid,
                               cfg: RenderConfig, jitter=None):
    """Fine stage: probe the windows of the selected segments, keep the
    first ``max_windows`` occupied ones in t order."""
    n = rays_o.shape[0]
    c, sw = cfg.march_coarse, cfg.segment_windows
    j = torch.arange(sw, dtype=torch.int32, device=rays_o.device)
    widx_cand = (sidx[:, :, None] * sw + j[None, None, :]).reshape(n, -1)
    t_w = widx_cand.float() * c + 0.5 * c
    if jitter is not None:
        t_w = t_w + jitter
    t_w = cfg.near + t_w * cfg.step
    occ_w = (probe_points(occ_grid, rays_o, rays_d, t_w, cfg.occ_res)
             * (t_w < cfg.far))
    occ_w = occ_w * svalid[:, :, None].to(torch.int32).expand(
        -1, -1, sw).reshape(n, -1)
    keys = occ_w * (cfg.n_windows - widx_cand)
    vals, pos = top_k(keys, min(cfg.max_windows, keys.shape[1]))
    wvalid = (vals > 0).float()
    widx = torch.gather(widx_cand, 1, pos)
    return widx.to(torch.int32), wvalid


def windows_to_samples(widx, wvalid, cfg: RenderConfig, jitter=None):
    """Expand selected windows into per-sample (t_mid, valid); ``jitter``
    [N, 1] shifts every sample of a ray by jitter * sample_stride steps."""
    n = widx.shape[0]
    st, spw = cfg.sample_stride, cfg.samples_per_window
    fine = (torch.arange(spw, dtype=torch.float32, device=widx.device)
            + 0.5) * st
    t = (widx.float() * cfg.march_coarse)[:, :, None] + fine[None, None, :]
    if jitter is not None:
        t = t + jitter[:, :, None] * st
    t_mid = (cfg.near + t * cfg.step).reshape(n, -1)
    valid = wvalid[:, :, None].expand(-1, -1, spw).reshape(n, -1)
    return t_mid, valid * (t_mid < cfg.far)


def march_windows_plain(occ_grid, rays_o, rays_d, cfg: RenderConfig,
                        coarse=None, segments=None, jitter=None):
    """-> (widx, wvalid, counts, sidx, svalid). ``segments`` = (sidx,
    svalid) skips the coarse stage (planned chunks); else ``coarse`` is the
    pooled, dilated coarse grid. ``jitter`` [N, 1] is the stratified form."""
    if segments is None:
        sidx, svalid = select_segments(coarse, rays_o, rays_d, cfg, jitter)
    else:
        sidx, svalid = segments
    widx, wvalid = fine_windows_from_segments(occ_grid, rays_o, rays_d,
                                              sidx, svalid, cfg, jitter)
    counts = wvalid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return widx, wvalid, counts, sidx, svalid


def _register_march():
    """The eval and stratified forms: one C entry point, counted apart."""
    args = [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.P,
            cuda.I32, cuda.P, cuda.P, cuda.I32, cuda.P, cuda.P, cuda.I32,
            cuda.P, cuda.P, cuda.I32, cuda.P, cuda.F32, cuda.F32, cuda.F32,
            cuda.I32, cuda.I32, cuda.I32, cuda.I32]
    return tuple(cuda.register(cuda.CudaKernel(
        name, "march_windows.cu", "march_windows_launch", args,
        extra_flags=("-fmad=false",)))
        for name in ("march_windows", "march_windows_stratified"))


_MARCH, _MARCH_STRATIFIED = _register_march()


def march_windows_cuda(occ_grid, rays_o, rays_d, cfg: RenderConfig,
                       coarse=None, segments=None, jitter=None):
    dev = rays_o.device
    n = rays_o.shape[0]
    res, cres = cfg.occ_res, cfg.occ_res // 4
    cuda.check(rays_o, "rays_o", torch.float32, (n, 3))
    cuda.check(rays_d, "rays_d", torch.float32, (n, 3), dev)
    cuda.check(occ_grid, "occ_grid", torch.uint8, (res ** 3,), dev)
    jit_ptr = None
    if jitter is not None:
        jitter = jitter.reshape(n).contiguous()
        cuda.check(jitter, "jitter", torch.float32, (n,), dev)
        jit_ptr = jitter.data_ptr()
    i32 = dict(dtype=torch.int32, device=dev)
    if segments is None:
        cuda.check(coarse, "coarse", torch.uint8, (cres ** 3,), dev)
        s_sel = cfg.max_segments
        sidx = torch.empty((n, s_sel), **i32)
        svalid = torch.empty((n, s_sel), dtype=torch.bool, device=dev)
        s_in, sidx_in, svalid_in = 0, None, None
        coarse_ptr = coarse.data_ptr()
    else:
        sidx, svalid = segments
        s_sel = sidx.shape[1]
        cuda.check(sidx, "sidx", torch.int32, (n, s_sel), dev)
        cuda.check(svalid, "svalid", torch.bool, (n, s_sel), dev)
        s_in, sidx_in, svalid_in = s_sel, sidx.data_ptr(), svalid.data_ptr()
        coarse_ptr = None
    k = min(cfg.max_windows, s_sel * cfg.segment_windows)
    widx = torch.empty((n, k), **i32)
    wvalid = torch.empty((n, k), dtype=torch.float32, device=dev)
    counts = torch.empty((n,), **i32)
    (_MARCH if jitter is None else _MARCH_STRATIFIED).launch(
        rays_o.data_ptr(), rays_d.data_ptr(), jit_ptr, n, occ_grid.data_ptr(),
        res, coarse_ptr, cres, sidx_in, svalid_in, s_in,
        sidx.data_ptr() if segments is None else None,
        svalid.data_ptr() if segments is None else None, s_sel,
        widx.data_ptr(), wvalid.data_ptr(), k, counts.data_ptr(),
        float(cfg.near), float(cfg.far), float(cfg.step), cfg.march_coarse,
        cfg.segment_windows, cfg.n_segments, cfg.n_windows)
    return widx, wvalid, counts, sidx, svalid


def march_windows(occ_grid, rays_o, rays_d, cfg: RenderConfig, coarse=None,
                  segments=None, jitter=None):
    """Window selection for rays [N, 3] -> (widx int32 [N, K], wvalid f32
    [N, K], counts int32 [N], sidx int32 [N, S], svalid bool [N, S]).
    ``jitter`` [N, 1] in [0, 1) is the stratified (training) form, None the
    eval form. The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if cfg.occ_res % 4:
        raise ValueError(f"occ_res {cfg.occ_res}: the hierarchical march "
                         "needs a multiple of 4 (the flat march is not ported)")
    if rays_o.is_cuda:
        return march_windows_cuda(occ_grid, rays_o, rays_d, cfg, coarse,
                                  segments, jitter)
    if rays_o.device.type != "cpu":
        raise ValueError(f"march_windows: unsupported device {rays_o.device}")
    return march_windows_plain(occ_grid, rays_o, rays_d, cfg, coarse,
                               segments, jitter)


def march_rays(occ_grid, rays_o, rays_d, cfg: RenderConfig, jitter=None,
               coarse=None):
    """-> (t_mid [N, S] ascending, valid [N, S]); stratified with
    ``jitter`` [N, 1]."""
    if coarse is None:
        coarse = coarse_occ_grid(occ_grid, cfg.occ_res)
    widx, wvalid = march_windows(occ_grid, rays_o, rays_d, cfg, coarse,
                                 jitter=jitter)[:2]
    return windows_to_samples(widx, wvalid, cfg, jitter)


# -- the training composite ------------------------------------------------------

def shade_composite_plain(sigma, t_mid, valid, delta: float):
    """-> (weights, opacity [N, 1], distance [N, 1], dist_loss [N]): the
    compositing of ``shade_rays`` (renderer.py:384-390) and
    ``distortion_per_ray``, differentiable by autograd."""
    tau = sigma * delta
    trans = torch.exp(-(torch.cumsum(tau, dim=-1) - tau))
    alpha = 1.0 - torch.exp(-tau)
    weights = trans * alpha
    opacity = torch.sum(weights, dim=-1, keepdim=True)
    distance = torch.sum(weights * t_mid, dim=-1, keepdim=True)
    dist_loss = distortion_per_ray(weights, t_mid, delta, valid)
    return weights, opacity, distance, dist_loss


_SHADE = cuda.register(cuda.CudaKernel(
    "shade_composite", "shade_composite.cu", "shade_composite_fwd_launch",
    [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.I32,
     cuda.F32, cuda.P, cuda.P, cuda.P, cuda.P]))
_SHADE_BWD = cuda.register(cuda.CudaKernel(
    "shade_composite_bwd", "shade_composite.cu", "shade_composite_bwd_launch",
    [cuda.P, cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.I32, cuda.I32,
     cuda.F32, cuda.P, cuda.P, cuda.P, cuda.P]))
# the longest row the backward takes: its shared memory holds three carries
# a chunk of 256 samples for each of a block's 4 rays, within 48 KB
SHADE_MAX_SAMPLES = 1 << 18


def composite_lanes(s: int) -> tuple:
    """(G, R) of the ``shade_composite`` kernels for rows of s samples: a
    ray is a group of G lanes (8, 16 or 32) and a lane a run of R <= 8
    consecutive samples; a row longer than G R runs in chunks of G R. G
    grows with s (8 up to 64 samples, 16 up to 128, else 32); R is
    ceil(s / G), rounded up to a multiple of 4 where s is one, so that a
    lane loads its run 16 bytes at a time and the tail's lanes idle. On an
    H100 fewer, longer runs beat more lanes at every measured shape (the
    group scans' shuffles cost the same whatever R is, and the 1,024-ray
    high bucket too runs faster on 16 lanes than on 32; PERF.md §6)."""
    g = 8 if s <= 64 else 16 if s <= 128 else 32
    r = min(8, -(-s // g))
    if s % 4 == 0:
        r = min(8, -(-r // 4) * 4)
    return g, r


def _lane_plan(s: int, *tensors) -> tuple:
    """(G, R, vec) of a launch: ``composite_lanes``'s plan, with 16-byte
    loads where R and s are multiples of 4 and every row aligned."""
    g, r = composite_lanes(s)
    if s > SHADE_MAX_SAMPLES:
        raise ValueError(f"shade_composite: rows of {s} samples, at most "
                         f"{SHADE_MAX_SAMPLES}")
    vec = r % 4 == 0 and s % 4 == 0 and all(t.data_ptr() % 16 == 0
                                            for t in tensors)
    return g, r, int(vec)


def _check_samples(*named):
    ref = named[0][1]
    for name, t in named:
        cuda.check(t, name, torch.float32, tuple(ref.shape), ref.device)


def shade_composite_cuda(sigma, t_mid, valid, delta: float):
    """Kernel forward -> (weights, opacity [N, 1], distance [N, 1],
    dist_loss [N])."""
    _check_samples(("sigma", sigma), ("t_mid", t_mid), ("valid", valid))
    n, s = sigma.shape
    f32 = dict(dtype=torch.float32, device=sigma.device)
    weights = torch.empty((n, s), **f32)
    opacity, distance = torch.empty((n, 1), **f32), torch.empty((n, 1), **f32)
    dist_loss = torch.empty((n,), **f32)
    g, r, vec = _lane_plan(s, sigma, t_mid, valid, weights)
    _SHADE.launch(sigma.data_ptr(), t_mid.data_ptr(), valid.data_ptr(), n, s,
                  g, r, vec, float(delta), weights.data_ptr(),
                  opacity.data_ptr(), distance.data_ptr(), dist_loss.data_ptr())
    return weights, opacity, distance, dist_loss


def shade_composite_grad_cuda(sigma, t_mid, valid, delta: float, g_op, g_dist,
                              g_dl):
    """Kernel backward: dsigma [N, S] from the cotangents of opacity,
    distance and dist_loss; recomputes the forward from sigma."""
    _check_samples(("sigma", sigma), ("t_mid", t_mid), ("valid", valid))
    n, s = sigma.shape
    grads = [g.reshape(n).contiguous() for g in (g_op, g_dist, g_dl)]
    for name, g in zip(("g_opacity", "g_distance", "g_dist_loss"), grads):
        cuda.check(g, name, torch.float32, (n,), sigma.device)
    g_sigma = torch.empty((n, s), dtype=torch.float32, device=sigma.device)
    g, r, vec = _lane_plan(s, sigma, t_mid, valid, g_sigma)
    _SHADE_BWD.launch(sigma.data_ptr(), t_mid.data_ptr(), valid.data_ptr(), n,
                      s, g, r, vec, float(delta), grads[0].data_ptr(),
                      grads[1].data_ptr(), grads[2].data_ptr(),
                      g_sigma.data_ptr())
    return g_sigma


class _ShadeComposite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, t_mid, valid, delta):
        weights, opacity, distance, dist_loss = shade_composite_cuda(
            sigma, t_mid, valid, delta)
        ctx.mark_non_differentiable(weights)
        ctx.save_for_backward(sigma, t_mid, valid)
        ctx.delta = delta
        return weights, opacity, distance, dist_loss

    @staticmethod
    def backward(ctx, _g_weights, g_op, g_dist, g_dl):
        sigma, t_mid, valid = ctx.saved_tensors
        g_sigma = shade_composite_grad_cuda(sigma, t_mid, valid, ctx.delta,
                                            g_op, g_dist, g_dl)
        return g_sigma, None, None, None


def shade_composite(sigma, t_mid, valid, delta: float):
    """Training composite of masked densities sigma [N, S] at t_mid with
    valid [N, S]: (weights [N, S] (no gradient), opacity [N, 1], distance
    [N, 1], dist_loss [N]), differentiable in sigma. The ``shade_composite``
    kernels for CUDA tensors, the plain version for CPU tensors."""
    if sigma.is_cuda:
        return _ShadeComposite.apply(sigma.contiguous(), t_mid.contiguous(),
                                     valid.contiguous(), float(delta))
    if sigma.device.type != "cpu":
        raise ValueError(f"shade_composite: unsupported {sigma.device}")
    weights, opacity, distance, dist_loss = shade_composite_plain(
        sigma, t_mid, valid, delta)
    return weights.detach(), opacity, distance, dist_loss


def _strides(field_cfg, cfg: RenderConfig, n_samples: int) -> tuple:
    if cfg.level_subsampling:
        return level_strides(field_cfg.grid, cfg.step, n_samples)
    return (1,) * field_cfg.grid.n_levels


def shade_rays(params: dict, field_cfg, rays_o, rays_d, t_mid, valid,
               cfg: RenderConfig, bg, noise_u, stop_geo_grad: bool = False,
               stop_app_grad: bool = False, need_rgb: bool = True) -> dict:
    """Training shade of pre-marched samples (``shade_rays`` with
    ``train=True``): density at every sample, the composite and distortion
    loss, colour from the top ``train_rgb_windows`` weight windows with
    detached weights, the random colour background over the detached
    transparency, and the distance noise through a relu over the
    non-detached one. ``bg`` [N, 3] and ``noise_u`` [N, 1] are uniform
    draws in [0, 1)."""
    from ..fields.ngp import query_density_ray, query_rgb_ray
    px, py, pz = (rays_o[:, a:a + 1] + rays_d[:, a:a + 1] * t_mid
                  for a in range(3))
    n, s = t_mid.shape
    no_grad = torch.no_grad if stop_geo_grad else contextlib.nullcontext
    with no_grad():
        sigma = query_density_ray(params["geo"], px, py, pz, field_cfg,
                                  _strides(field_cfg, cfg, s),
                                  cfg.run_caps)
    # where-select, not multiply: a saturated density at a padding sample
    # must give 0, never inf * 0 = NaN
    sigma = torch.where(valid > 0.0, sigma, torch.zeros_like(sigma))
    weights, opacity, distance, dist_loss = shade_composite(
        sigma, t_mid, valid, cfg.step * cfg.sample_stride)

    if need_rgb:
        kw, c = cfg.train_rgb_windows, cfg.samples_per_window
        no_grad = torch.no_grad if stop_app_grad else contextlib.nullcontext
        if kw and kw * c < s:
            wwin = weights.reshape(n, -1, c).sum(dim=-1)
            widx = torch.sort(top_k(wwin, kw)[1], dim=1).values
            sidx = (widx[:, :, None] * c + torch.arange(
                c, device=widx.device)[None, None, :]).reshape(n, kw * c)
            pk = [torch.gather(p, 1, sidx) for p in (px, py, pz)]
            with no_grad():
                r, g, b = query_rgb_ray(params["app"], *pk, field_cfg,
                                        _strides(field_cfg, cfg, kw * c),
                                        cfg.run_caps)
            w_det = torch.gather(weights, 1, sidx)
        else:
            with no_grad():
                r, g, b = query_rgb_ray(params["app"], px, py, pz, field_cfg,
                                        _strides(field_cfg, cfg, s),
                                        cfg.run_caps)
            w_det = weights
        colors = torch.stack([torch.sum(w_det * r, dim=-1),
                              torch.sum(w_det * g, dim=-1),
                              torch.sum(w_det * b, dim=-1)], dim=-1)
    else:
        colors = torch.zeros((n, 3), dtype=torch.float32, device=t_mid.device)
    if cfg.bg_color == "rand_noise":
        bg_c = bg
    elif cfg.bg_color == "white":
        bg_c = torch.ones_like(colors)
    else:
        bg_c = torch.zeros_like(colors)
    noise = noise_u * 2.0 - 1.0
    distance = torch.relu(distance + noise * (1.0 - opacity))
    colors = colors + bg_c * (1.0 - opacity).detach()
    return {"rgb": colors, "distance": distance, "opacity": opacity,
            "weights": weights, "t_mid": t_mid, "valid": valid,
            "dist_loss": dist_loss}


def render_rays(params: dict, field_cfg, occ_grid, rays_o, rays_d,
                cfg: RenderConfig, draws: dict, coarse=None, **flags) -> dict:
    """Stratified march + training shade of a flat batch [N, 3]
    (``render_rays`` with ``train=True``). ``draws``: ``jitter`` [N, 1],
    ``bg`` [N, 3], ``noise`` [N, 1] uniforms."""
    t_mid, valid = march_rays(occ_grid, rays_o, rays_d, cfg,
                              draws["jitter"], coarse)
    return shade_rays(params, field_cfg, rays_o, rays_d, t_mid, valid, cfg,
                      draws["bg"], draws["noise"], **flags)


def render_rays_bucketed(params: dict, field_cfg, occ_grid, rays_o, rays_d,
                         cfg: RenderConfig, s_low: int, n_high: int,
                         draws: dict, coarse=None, **flags) -> dict:
    """Two-budget training batch (``render_rays_bucketed``): march, sort
    the rays by occupied-window count (stable), shade the ``n - n_high``
    lowest at ``s_low`` samples and the rest at the full budget, restore
    ray order. ``draws`` as ``render_rays``, with ``bg`` and ``noise`` in
    sorted (bucket) order: the low bucket's rows first."""
    n = rays_o.shape[0]
    spw = cfg.samples_per_window
    if s_low % spw or not 0 < n_high < n:
        raise ValueError(f"bad bucket plan s_low={s_low} n_high={n_high}")
    if coarse is None:
        coarse = coarse_occ_grid(occ_grid, cfg.occ_res)
    jitter = draws["jitter"]
    widx, wvalid, counts = march_windows(occ_grid, rays_o, rays_d, cfg,
                                         coarse, jitter=jitter)[:3]
    order = torch.argsort(counts, stable=True)
    inv = torch.argsort(order, stable=True)
    o_s, d_s = rays_o[order], rays_d[order]
    widx_s, wvalid_s, jit_s = widx[order], wvalid[order], jitter[order]
    n_low = n - n_high

    def bucket(sl, w_budget):
        t_b, v_b = windows_to_samples(widx_s[sl, :w_budget],
                                      wvalid_s[sl, :w_budget], cfg, jit_s[sl])
        return shade_rays(params, field_cfg, o_s[sl], d_s[sl], t_b, v_b, cfg,
                          draws["bg"][sl], draws["noise"][sl], **flags)

    out_lo = bucket(slice(0, n_low), s_low // spw)
    out_hi = bucket(slice(n_low, n), widx.shape[1])
    return {k: torch.cat([out_lo[k], out_hi[k]])[inv]
            for k in ("rgb", "distance", "opacity", "dist_loss")}


def beam_dilation(rays_d: torch.Tensor, cfg: RenderConfig) -> int:
    """Extra coarse-grid dilation (voxels) so one block-centre probe ray
    covers every ray of its 4x4 pixel block out to ``cfg.far``: far times
    the largest chord between a block's mean direction and its members,
    over the coarse voxel. float64, on the rays' device."""
    d = rays_d.to(torch.float64)
    h4, w4 = d.shape[0] // 4 * 4, d.shape[1] // 4 * 4
    blocks = d[:h4, :w4].reshape(h4 // 4, 4, w4 // 4, 4, 3)
    db = blocks.mean(dim=(1, 3))
    db = db / torch.linalg.norm(db, dim=-1, keepdim=True)
    cosmin = float(torch.min(torch.sum(blocks * db[:, None, :, None, :],
                                       dim=-1)))
    chord = math.sqrt(max(0.0, 2.0 - 2.0 * cosmin))
    voxel = 8.0 / cfg.occ_res
    return int(math.ceil(cfg.far * chord / voxel))


def block_mean_dirs(d_img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] -> unit mean direction of each 4x4 block, [H/4 * W/4, 3].
    Sums each window in row-major order from 0, then divides by 16 and by
    the norm, which is the order of the JAX reduce_window."""
    h, w = d_img.shape[:2]
    blocks = d_img.reshape(h // 4, 4, w // 4, 4, 3)
    acc = torch.zeros((h // 4, w // 4, 3), dtype=d_img.dtype,
                      device=d_img.device)
    for i in range(4):
        for j in range(4):
            acc = acc + blocks[:, i, :, j]
    db = acc / 16.0
    norm = torch.sqrt(db[..., 0] * db[..., 0] + db[..., 1] * db[..., 1]
                      + db[..., 2] * db[..., 2])
    return (db / norm[..., None]).reshape(-1, 3)


def frame_march_plan(occ_grid, o_img, d_img, cfg: RenderConfig, dilate: int,
                     march=march_windows):
    """Beam march plan for an [H, W] ray frame (eval only): the coarse
    segment selection runs once per 4x4 block on the block's mean direction
    against a ``1 + dilate``-dilated coarse grid; the same pass yields each
    pixel's occupied-window bound (3x3 block max).

    Returns (sidx [nblocks, S], svalid [nblocks, S], counts [H, W])."""
    h, w = o_img.shape[:2]
    ob = o_img[::4, ::4].reshape(-1, 3).contiguous()
    db = block_mean_dirs(d_img).contiguous()
    coarse = coarse_occ_grid(occ_grid, cfg.occ_res, dilate=1 + dilate)
    _, _, counts, sidx, svalid = march(occ_grid, ob, db, cfg, coarse)
    counts = counts.reshape(1, 1, h // 4, w // 4).float()
    counts = F.max_pool2d(counts, 3, 1, padding=1)[0, 0].to(torch.int32)
    counts = counts.repeat_interleave(4, 0).repeat_interleave(4, 1)
    return sidx, svalid, counts


# -- the eval form of the field path -------------------------------------------

def shade_rays_eval(params: dict, field_cfg, rays_o, rays_d, t_mid, valid,
                    cfg: RenderConfig, need_rgb: bool = True) -> dict:
    """Eval shade of pre-marched samples (``shade_rays`` with
    ``train=False``): the composite, colour from the top
    ``eval_rgb_windows`` weight windows, and the eval background (0.5 grey,
    distance ``eval_bg_distance``) over the transparency. No gradient."""
    from ..fields.ngp import query_density_ray, query_rgb_ray
    px, py, pz = (rays_o[:, a:a + 1] + rays_d[:, a:a + 1] * t_mid
                  for a in range(3))
    n, s = t_mid.shape
    with torch.no_grad():
        sigma = query_density_ray(params["geo"], px, py, pz, field_cfg,
                                  _strides(field_cfg, cfg, s))
        sigma = torch.where(valid > 0.0, sigma, torch.zeros_like(sigma))
        weights, opacity, distance, _ = shade_composite(
            sigma, t_mid, valid, cfg.step * cfg.sample_stride)
        if need_rgb:
            kw, c = cfg.eval_rgb_windows, cfg.samples_per_window
            if kw and kw * c < s:
                wwin = weights.reshape(n, -1, c).sum(dim=-1)
                widx = torch.sort(top_k(wwin, kw)[1], dim=1).values
                sidx = (widx[:, :, None] * c + torch.arange(
                    c, device=widx.device)[None, None, :]).reshape(n, kw * c)
                pk = [torch.gather(p, 1, sidx) for p in (px, py, pz)]
                r, g, b = query_rgb_ray(params["app"], *pk, field_cfg,
                                        _strides(field_cfg, cfg, kw * c))
                w_c = torch.gather(weights, 1, sidx)
            else:
                r, g, b = query_rgb_ray(params["app"], px, py, pz, field_cfg,
                                        _strides(field_cfg, cfg, s))
                w_c = weights
            colors = torch.stack([torch.sum(w_c * r, dim=-1),
                                  torch.sum(w_c * g, dim=-1),
                                  torch.sum(w_c * b, dim=-1)], dim=-1)
        else:
            colors = torch.zeros((n, 3), dtype=torch.float32,
                                 device=t_mid.device)
        rest = 1.0 - opacity
        return {"rgb": colors + 0.5 * rest,
                "distance": distance + cfg.eval_bg_distance * rest,
                "opacity": opacity}


def render_image(params: dict, field_cfg, occ_grid, rays, cfg: RenderConfig,
                 query_keys=("rgb", "distance"),
                 chunk: int | None = None) -> dict:
    """Eval render of a ray grid ``rays`` [..., 3] through the field (the
    JAX ``render_image`` with ``adaptive_eval=False``): the eval march and
    shade in chunks of ``chunk`` rays (default ``cfg.eval_chunk``) at
    ``cfg.max_samples``."""
    chunk = chunk or cfg.eval_chunk
    pre = rays.o.shape[:-1]
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    coarse = coarse_occ_grid(occ_grid, cfg.occ_res)
    outs = []
    for s0 in range(0, o.shape[0], chunk):
        oc, dc = o[s0:s0 + chunk].contiguous(), d[s0:s0 + chunk].contiguous()
        t_mid, valid = march_rays(occ_grid, oc, dc, cfg, coarse=coarse)
        outs.append(shade_rays_eval(params, field_cfg, oc, dc, t_mid, valid,
                                    cfg, need_rgb="rgb" in query_keys))
    return {q: torch.cat([c[q] for c in outs]).reshape(*pre, -1)
            for q in query_keys}
