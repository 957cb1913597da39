"""The eval march: occupancy-culled, hierarchical, non-stratified.

Counterpart of the eval half of ``perf_tpu/render/renderer.py``
(``RenderConfig``, ``coarse_occ_grid``, ``_probe_points``,
``count_occupied_windows``, ``_select_segments``,
``_fine_windows_from_segments``, ``_windows_to_samples``, ``march_windows``
/ ``march_rays`` with ``stratified=False``, ``beam_dilation`` and
``frame_march_plan``). The march probes a 4x-pooled, dilated coarse grid
once per segment of ``segment_windows`` windows, keeps the first
``max_segments`` occupied segments, then probes the fine grid at every
window of those and keeps the first ``max_windows`` occupied windows in t
order.

``march_windows`` is the CUDA kernel (``kernels/csrc/march_windows.cu``) for
CUDA tensors and ``march_windows_plain`` for CPU tensors. The plain version
follows the JAX code operation for operation (float32 throughout, the same
``top_k`` compaction), so window indices agree exactly.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels import cuda


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """The eval fields of the JAX ``RenderConfig``; the training-only ones
    (``bg_color``, ``occ_dilation``, ``eval_chunk``) come with the training
    slice. Eval frames always take per-chunk adaptive sample budgets."""
    near: float = 0.0
    far: float = 1.5
    step: float = 5e-4
    max_samples: int = 256
    occ_res: int = 256
    eval_bg_distance: float = 5.0
    march_coarse: int = 8
    segment_windows: int = 4
    sample_stride: int = 1

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


def count_occupied_windows(occ_grid, rays_o, rays_d, cfg: RenderConfig):
    """Per-ray count of occupied windows over the full flat ladder, probed
    at both jitter extremes (the adaptive-budget bound of unplanned
    frames)."""
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


def select_segments(coarse: torch.Tensor, rays_o, rays_d,
                    cfg: RenderConfig):
    """Coarse stage: (sidx int32 [N, max_segments], svalid bool)."""
    n = rays_o.shape[0]
    nseg, sw, c = cfg.n_segments, cfg.segment_windows, cfg.march_coarse
    segs = torch.arange(nseg, dtype=torch.float32, device=rays_o.device)
    t_seg = (cfg.near + ((segs[None, :] * sw + 0.5 * sw) * c) * cfg.step
             ).expand(n, -1)
    seg_occ = (probe_points(coarse, rays_o, rays_d, t_seg, cfg.occ_res // 4)
               * (t_seg < cfg.far))
    skeys = seg_occ * (nseg - torch.arange(nseg, dtype=torch.int32,
                                           device=rays_o.device))[None, :]
    svals, sidx = torch.topk(skeys, cfg.max_segments, dim=1)
    return sidx.to(torch.int32), svals > 0


def fine_windows_from_segments(occ_grid, rays_o, rays_d, sidx, svalid,
                               cfg: RenderConfig):
    """Fine stage: probe the windows of the selected segments, keep the
    first ``max_windows`` occupied ones in t order."""
    n = rays_o.shape[0]
    c, sw = cfg.march_coarse, cfg.segment_windows
    j = torch.arange(sw, dtype=torch.int32, device=rays_o.device)
    widx_cand = (sidx[:, :, None] * sw + j[None, None, :]).reshape(n, -1)
    t_w = cfg.near + (widx_cand.float() * c + 0.5 * c) * cfg.step
    occ_w = (probe_points(occ_grid, rays_o, rays_d, t_w, cfg.occ_res)
             * (t_w < cfg.far))
    occ_w = occ_w * svalid[:, :, None].to(torch.int32).expand(
        -1, -1, sw).reshape(n, -1)
    keys = occ_w * (cfg.n_windows - widx_cand)
    vals, pos = torch.topk(keys, min(cfg.max_windows, keys.shape[1]), dim=1)
    wvalid = (vals > 0).float()
    widx = torch.gather(widx_cand, 1, pos)
    return widx.to(torch.int32), wvalid


def windows_to_samples(widx, wvalid, cfg: RenderConfig):
    """Expand selected windows into per-sample (t_mid, valid)."""
    n = widx.shape[0]
    st, spw = cfg.sample_stride, cfg.samples_per_window
    fine = (torch.arange(spw, dtype=torch.float32, device=widx.device)
            + 0.5) * st
    t_mid = (cfg.near + ((widx.float() * cfg.march_coarse)[:, :, None]
                         + fine[None, None, :]) * cfg.step).reshape(n, -1)
    valid = wvalid[:, :, None].expand(-1, -1, spw).reshape(n, -1)
    return t_mid, valid * (t_mid < cfg.far)


def march_windows_plain(occ_grid, rays_o, rays_d, cfg: RenderConfig,
                        coarse=None, segments=None):
    """-> (widx, wvalid, counts, sidx, svalid). ``segments`` = (sidx,
    svalid) skips the coarse stage (planned chunks); else ``coarse`` is the
    pooled, dilated coarse grid."""
    if segments is None:
        sidx, svalid = select_segments(coarse, rays_o, rays_d, cfg)
    else:
        sidx, svalid = segments
    widx, wvalid = fine_windows_from_segments(occ_grid, rays_o, rays_d,
                                              sidx, svalid, cfg)
    counts = wvalid.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return widx, wvalid, counts, sidx, svalid


_MARCH = cuda.register(cuda.CudaKernel(
    "march_windows", "march_windows.cu", "march_windows_launch",
    [cuda.P, cuda.P, cuda.I64, cuda.P, cuda.I32, cuda.P, cuda.I32, cuda.P,
     cuda.P, cuda.I32, cuda.P, cuda.P, cuda.I32, cuda.P, cuda.P, cuda.I32,
     cuda.P, cuda.F32, cuda.F32, cuda.F32, cuda.I32, cuda.I32, cuda.I32,
     cuda.I32],
    extra_flags=("-fmad=false",)))


def march_windows_cuda(occ_grid, rays_o, rays_d, cfg: RenderConfig,
                       coarse=None, segments=None):
    dev = rays_o.device
    n = rays_o.shape[0]
    res, cres = cfg.occ_res, cfg.occ_res // 4
    if res % 4:
        raise ValueError(f"occ_res {res} must be a multiple of 4")
    cuda.check(rays_o, "rays_o", torch.float32, (n, 3))
    cuda.check(rays_d, "rays_d", torch.float32, (n, 3), dev)
    cuda.check(occ_grid, "occ_grid", torch.uint8, (res ** 3,), dev)
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
    _MARCH.launch(
        rays_o.data_ptr(), rays_d.data_ptr(), n, occ_grid.data_ptr(), res,
        coarse_ptr, cres, sidx_in, svalid_in, s_in,
        sidx.data_ptr() if segments is None else None,
        svalid.data_ptr() if segments is None else None, s_sel,
        widx.data_ptr(), wvalid.data_ptr(), k, counts.data_ptr(),
        float(cfg.near), float(cfg.far), float(cfg.step), cfg.march_coarse,
        cfg.segment_windows, cfg.n_segments, cfg.n_windows)
    return widx, wvalid, counts, sidx, svalid


def march_windows(occ_grid, rays_o, rays_d, cfg: RenderConfig, coarse=None,
                  segments=None):
    """Window selection for rays [N, 3] -> (widx int32 [N, K], wvalid f32
    [N, K], counts int32 [N], sidx int32 [N, S], svalid bool [N, S]).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if rays_o.is_cuda:
        return march_windows_cuda(occ_grid, rays_o, rays_d, cfg, coarse,
                                  segments)
    if rays_o.device.type != "cpu":
        raise ValueError(f"march_windows: unsupported device {rays_o.device}")
    return march_windows_plain(occ_grid, rays_o, rays_d, cfg, coarse,
                               segments)


def march_rays(occ_grid, rays_o, rays_d, cfg: RenderConfig):
    """Non-stratified march -> (t_mid [N, S] ascending, valid [N, S])."""
    coarse = coarse_occ_grid(occ_grid, cfg.occ_res)
    widx, wvalid = march_windows(occ_grid, rays_o, rays_d, cfg, coarse)[:2]
    return windows_to_samples(widx, wvalid, cfg)


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
