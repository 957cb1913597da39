"""Baked snapshot: bake the field once into a dense brick table, then
render every eval frame from it with one row read per sample.

Counterpart of ``perf_tpu/render/snapshot.py`` (``SnapshotConfig``, the
device bake ``:142-203``, ``snapshot_render_cfg``, ``_composite_snapshot``,
``_snapshot_chunk`` / ``_snapshot_chunk_planned`` and the chunked
``render_snapshot_image`` with per-chunk adaptive budgets). Rows of the
[nb^3, 256] bf16 table hold (sigma, r, g, b) of a brick's 4^3 corners,
lane = ((cx*4 + cy)*4 + cz)*4 + f, bricks overlapping by one corner.

With ``dedup_ratio`` a chunk whose budget S exceeds its K =
``dedup_k_for(ratio, S)`` run candidates composites with run dedup (K12,
JAX's dedup branch of ``_composite_snapshot``): a sample reads the row of
the first sample of its brick run, the run ids (row changes along all S
slots of the ray, padding slots included) clipped at K - 1
(``brickgrid.run_ids``).

Kernels (CUDA tensors): the bake runs ``field_eval`` (``fields/ngp.py``)
and ``bake_scatter_pack``; a frame runs ``march_windows``
(``render/renderer.py``) and ``snapshot_composite`` (with K < S its dedup
instance, ``snapshot_composite_dedup``). CPU tensors take the plain
versions. Not ported: ``frame_dispatch`` and ``bake_host`` (both off in
production).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..fields.ngp import NGPFieldConfig, field_eval
from ..kernels import cuda
from ..kernels.brickgrid import BRICK, axis_split, run_rows
from .renderer import (
    RenderConfig, beam_dilation, coarse_occ_grid, count_occupied_windows,
    frame_march_plan, march_windows, march_windows_plain, windows_to_samples,
)

SNAP_F = 4   # lanes per corner: sigma, r, g, b


@dataclasses.dataclass(frozen=True)
class SnapshotConfig:
    res: int = 384
    # march-step multiplier; None -> largest divisor of the march window
    # that keeps the sample spacing <= about one bake voxel
    sample_stride: int | None = None
    # snapshot march window (fine steps); None -> RenderConfig.march_coarse
    march_coarse: int | None = None
    bake_chunk: int = 1 << 21   # field evaluations per bake launch
    # run dedup in the composite: K = dedup_k_for(ratio, S) run candidates
    # a ray; 0.0 = off (a ray with more runs than K reads the row of run
    # K - 1 past it: an approximation, off in production)
    dedup_ratio: float = 0.0

    @property
    def n_bricks(self) -> int:
        return self.res // BRICK + 1

    def resolve_stride(self, render_cfg: RenderConfig) -> int:
        mc = self.march_coarse or render_cfg.march_coarse
        if self.sample_stride is not None:
            return self.sample_stride
        voxel = 2.0 / self.res
        want = max(1, int(round(voxel / render_cfg.step)))
        stride = 1
        for d in range(1, mc + 1):
            if mc % d == 0 and d <= want:
                stride = d
        return stride


def snapshot_render_cfg(render_cfg: RenderConfig,
                        cfg: SnapshotConfig) -> RenderConfig:
    """March config for the snapshot: the field path's ladder and occupancy,
    sparser in-window sampling, optionally its own window size."""
    if cfg.march_coarse:
        render_cfg = dataclasses.replace(render_cfg,
                                         march_coarse=cfg.march_coarse)
    stride = cfg.resolve_stride(render_cfg)
    if render_cfg.march_coarse % stride:
        raise ValueError(f"stride {stride} must divide the march window")
    # eval sample cap at the snapshot stride (JAX's default, which no
    # config overrides)
    max_samples = max(render_cfg.march_coarse // stride, 256 // stride)
    return dataclasses.replace(render_cfg, sample_stride=stride,
                               max_samples=max_samples)


def dedup_k_for(ratio: float, samples: int) -> int:
    """The composite's run candidates at a chunk budget of ``samples``
    (``_dedup_k_for``): ceil(ratio * samples) rounded up to a multiple of
    8, at least 8; 0 with ratio 0."""
    if not ratio:
        return 0
    return int(max(8, -(-ratio * samples // 8) * 8))


# -- bake ----------------------------------------------------------------------

def bake_corners(occ_grid: torch.Tensor, occ_res: int,
                 res: int) -> torch.Tensor:
    """Flat indices (ascending, int64) into the (res+1)^3 corner grid of the
    corners whose 1-dilated occupancy voxel is set."""
    g = occ_grid.reshape(1, 1, occ_res, occ_res, occ_res).float()
    g = F.max_pool3d(g, 3, 1, padding=1)[0, 0].to(torch.uint8)
    corner01 = torch.arange(res + 1, dtype=torch.float32,
                            device=occ_grid.device) / res
    vox = torch.clamp((corner01 * occ_res).to(torch.int64), 0, occ_res - 1)
    m = g[vox][:, vox][:, :, vox]
    return torch.nonzero(m.reshape(-1)).squeeze(1)


def corner_points(idx: torch.Tensor, res: int,
                  field_cfg: NGPFieldConfig) -> torch.Tensor:
    """Flat corner indices -> world points [N, 3] float32 (as the JAX bake:
    aabb_min + float32(span / res) * i)."""
    rp1 = res + 1
    i = idx // (rp1 * rp1)
    rem = idx % (rp1 * rp1)
    ijk = torch.stack([i, rem // rp1, rem % rp1], dim=-1).float()
    scale = (field_cfg.aabb_max - field_cfg.aabb_min) / res
    return field_cfg.aabb_min + scale * ijk


def bake_scatter_pack_plain(table: torch.Tensor, idx: torch.Tensor,
                            vals: torch.Tensor, res: int):
    """Write corners' (sigma, r, g, b) as bf16 into every packed brick row
    that holds them (up to 2 bricks per axis), in place."""
    rp1, nb = res + 1, res // BRICK + 1
    c = (idx // (rp1 * rp1), (idx // rp1) % rp1, idx % rp1)
    v = vals.to(torch.bfloat16)
    # per axis: (brick, local corner, mask) for the primary brick and the
    # previous brick that shares the corner on its last face
    opts = [((a // 3, a % 3, torch.ones_like(a, dtype=torch.bool)),
             (a // 3 - 1, torch.full_like(a, 3), (a % 3 == 0) & (a > 0)))
            for a in c]
    flat = table.view(-1, SNAP_F)
    for bx, lx, mx in opts[0]:
        for by, ly, my in opts[1]:
            for bz, lz, mz in opts[2]:
                m = mx & my & mz
                row = (bx * nb + by) * nb + bz
                corner = (lx * 4 + ly) * 4 + lz
                flat[(row * 64 + corner)[m]] = v[m]
    return table


_SCATTER = cuda.register(cuda.CudaKernel(
    "bake_scatter_pack", "bake_scatter_pack.cu", "bake_scatter_pack_launch",
    [cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.I32, cuda.P]))


def bake_scatter_pack(table: torch.Tensor, idx: torch.Tensor,
                      vals: torch.Tensor, res: int):
    """In-place scatter of evaluated corners into the packed table [nb^3,
    256] bf16: the CUDA kernel for CUDA tensors, plain for CPU tensors."""
    if not table.is_cuda:
        if table.device.type != "cpu":
            raise ValueError(f"bake_scatter_pack: unsupported {table.device}")
        return bake_scatter_pack_plain(table, idx, vals, res)
    nb = res // BRICK + 1
    n = idx.shape[0]
    cuda.check(table, "table", torch.bfloat16, (nb ** 3, 64 * SNAP_F))
    cuda.check(idx, "idx", torch.int64, (n,), table.device)
    cuda.check(vals, "vals", torch.float32, (n, SNAP_F), table.device)
    if vals.data_ptr() % 16:
        raise ValueError("vals: the kernel reads float4, needs 16-byte "
                         "alignment")
    _SCATTER.launch(idx.data_ptr(), vals.data_ptr(), n, res, nb,
                    table.data_ptr())
    return table


def bake_snapshot(params: dict, field_cfg: NGPFieldConfig,
                  occ_grid: torch.Tensor, occ_res: int,
                  cfg: SnapshotConfig) -> torch.Tensor:
    """Evaluate (sigma, rgb) at the occupied corners of the bake grid and
    pack them: -> [nb^3, 256] bf16 on the grid's device. Corners that are
    not occupied stay 0."""
    idx = bake_corners(occ_grid, occ_res, cfg.res)
    table = torch.zeros((cfg.n_bricks ** 3, 64 * SNAP_F),
                        dtype=torch.bfloat16, device=occ_grid.device)
    for start in range(0, idx.shape[0], cfg.bake_chunk):
        ic = idx[start:start + cfg.bake_chunk]
        vals = field_eval(params, corner_points(ic, cfg.res, field_cfg),
                          field_cfg)
        bake_scatter_pack(table, ic, vals, cfg.res)
    return table


# -- composite -------------------------------------------------------------------

def _sample_coords(rays_o, rays_d, t_mid, field_cfg: NGPFieldConfig):
    """Normalised sample coordinates, each [N, S] (the composite's)."""
    span = field_cfg.aabb_max - field_cfg.aabb_min
    return tuple((rays_o[:, a:a + 1] + rays_d[:, a:a + 1] * t_mid
                  - field_cfg.aabb_min) / span for a in range(3))


def snapshot_rows(rays_o, rays_d, t_mid, field_cfg: NGPFieldConfig,
                  res: int) -> torch.Tensor:
    """The dense bake table's brick row of every sample slot [N, S], valid
    or not: what the composite's run dedup numbers runs of."""
    nb = res // BRICK + 1
    b = [axis_split(a, res)[0]
         for a in _sample_coords(rays_o, rays_d, t_mid, field_cfg)]
    return b[0] * (nb * nb) + b[1] * nb + b[2]


def composite_snapshot_plain(table, rays_o, rays_d, widx, wvalid,
                             field_cfg: NGPFieldConfig, cfg: RenderConfig,
                             res: int, dedup_k: int = 0) -> dict:
    """Windows -> samples -> one table row per sample -> interpolated
    (sigma, r, g, b) -> eval composite. Returns rgb [N, 3], distance
    [N, 1], opacity [N, 1]. Reads only the 8 corners of each sample's row
    (4 features each), so memory stays [N, S, 4]. With 0 < ``dedup_k`` <
    S each sample reads its run's row (``run_rows`` over all S slots)."""
    t_mid, valid = windows_to_samples(widx, wvalid, cfg)
    nx, ny, nz = _sample_coords(rays_o, rays_d, t_mid, field_cfg)
    sel = ((nx > 0.0) & (nx < 1.0) & (ny > 0.0) & (ny < 1.0)
           & (nz > 0.0) & (nz < 1.0)).float()
    bx, lx, fx = axis_split(nx, res)
    by, ly, fy = axis_split(ny, res)
    bz, lz, fz = axis_split(nz, res)
    nb = res // BRICK + 1
    rows = bx * (nb * nb) + by * nb + bz
    if dedup_k and dedup_k < t_mid.shape[1]:
        rows = run_rows(rows, dedup_k)
    base = rows * 64
    corners = table.view(-1, SNAP_F)
    vals = torch.zeros(t_mid.shape + (SNAP_F,), dtype=torch.float32,
                       device=t_mid.device)
    for ox in (0, 1):
        wx = fx if ox else 1.0 - fx
        for oy in (0, 1):
            wxy = wx * (fy if oy else 1.0 - fy)
            for oz in (0, 1):
                w = wxy * (fz if oz else 1.0 - fz)
                corner = ((lx + ox) * 4 + (ly + oy)) * 4 + (lz + oz)
                vals = vals + corners[base + corner].float() * w[..., None]
    sig, r, g, b = vals.unbind(-1)
    sig = torch.clamp(sig, min=0.0) * valid * sel
    tau = sig * (cfg.step * cfg.sample_stride)
    trans = torch.exp(-(torch.cumsum(tau, dim=-1) - tau))
    weights = trans * (1.0 - torch.exp(-tau))
    opacity = weights.sum(dim=-1, keepdim=True)
    distance = (weights * t_mid).sum(dim=-1, keepdim=True)
    colors = torch.stack([(weights * torch.clamp(v, 0.0, 1.0)).sum(dim=-1)
                          for v in (r, g, b)], dim=-1)
    rest = 1.0 - opacity
    return {"rgb": colors + 0.5 * rest,
            "distance": distance + cfg.eval_bg_distance * rest,
            "opacity": opacity}


_COMPOSITE_ARGS = [
    cuda.P, cuda.P, cuda.I64, cuda.P, cuda.P, cuda.I32, cuda.P, cuda.I32,
    cuda.I32, cuda.F32, cuda.F32, cuda.F32, cuda.I32, cuda.I32, cuda.I32,
    cuda.F32, cuda.F32, cuda.F32, cuda.F32]
_COMPOSITE = cuda.register(cuda.CudaKernel(
    "snapshot_composite", "snapshot_composite.cu",
    "snapshot_composite_launch",
    _COMPOSITE_ARGS + [cuda.P, cuda.P, cuda.P], extra_flags=("-fmad=false",)))
_COMPOSITE_DEDUP = cuda.register(cuda.CudaKernel(
    "snapshot_composite_dedup", "snapshot_composite.cu",
    "snapshot_composite_dedup_launch",
    _COMPOSITE_ARGS + [cuda.I32, cuda.P, cuda.P, cuda.P],
    extra_flags=("-fmad=false",)))


def composite_snapshot_cuda(table, rays_o, rays_d, widx, wvalid,
                            field_cfg: NGPFieldConfig, cfg: RenderConfig,
                            res: int, dedup_k: int = 0) -> dict:
    """The ``snapshot_composite`` kernel, or with 0 < ``dedup_k`` < S its
    dedup instance ``snapshot_composite_dedup``."""
    n, k = widx.shape
    nb = res // BRICK + 1
    dev = rays_o.device
    cuda.check(rays_o, "rays_o", torch.float32, (n, 3))
    cuda.check(rays_d, "rays_d", torch.float32, (n, 3), dev)
    cuda.check(widx, "widx", torch.int32, (n, k), dev)
    cuda.check(wvalid, "wvalid", torch.float32, (n, k), dev)
    cuda.check(table, "table", torch.bfloat16, (nb ** 3, 64 * SNAP_F), dev)
    if dedup_k < 0:
        raise ValueError(f"dedup_k={dedup_k}")
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    distance = torch.empty((n, 1), dtype=torch.float32, device=dev)
    opacity = torch.empty((n, 1), dtype=torch.float32, device=dev)
    args = (rays_o.data_ptr(), rays_d.data_ptr(), n, widx.data_ptr(),
            wvalid.data_ptr(), k, table.data_ptr(), res, nb, float(cfg.near),
            float(cfg.far), float(cfg.step), cfg.march_coarse,
            cfg.sample_stride, cfg.samples_per_window,
            float(cfg.step * cfg.sample_stride), float(field_cfg.aabb_min),
            float(field_cfg.aabb_max - field_cfg.aabb_min),
            float(cfg.eval_bg_distance))
    outs = (rgb.data_ptr(), distance.data_ptr(), opacity.data_ptr())
    if dedup_k and dedup_k < k * cfg.samples_per_window:
        _COMPOSITE_DEDUP.launch(*args, dedup_k, *outs)
    else:
        _COMPOSITE.launch(*args, *outs)
    return {"rgb": rgb, "distance": distance, "opacity": opacity}


def composite_snapshot(table, rays_o, rays_d, widx, wvalid,
                       field_cfg: NGPFieldConfig, cfg: RenderConfig,
                       res: int, dedup_k: int = 0) -> dict:
    """Snapshot composite of marched windows: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; ``dedup_k`` run candidates
    (0: off; it acts where it is below the S samples of a ray)."""
    if rays_o.is_cuda:
        return composite_snapshot_cuda(table, rays_o, rays_d, widx, wvalid,
                                       field_cfg, cfg, res, dedup_k)
    if rays_o.device.type != "cpu":
        raise ValueError(f"composite_snapshot: unsupported {rays_o.device}")
    return composite_snapshot_plain(table, rays_o, rays_d, widx, wvalid,
                                    field_cfg, cfg, res, dedup_k)


# -- frames ----------------------------------------------------------------------

def chunk_budgets(counts: torch.Tensor, chunk: int, slack: int,
                  cfg: RenderConfig) -> list:
    """Per-chunk sample budget: (max occupied windows + slack) samples,
    rounded up to a power of two, at least 4 windows, at most the cap."""
    per_chunk = counts.reshape(-1, chunk).amax(dim=1).tolist()
    spw = cfg.samples_per_window
    budgets = []
    for w_need in per_chunk:
        s_need = (int(w_need) + slack) * spw
        b = max(4 * spw, 1 << (s_need - 1).bit_length())
        budgets.append(min(cfg.max_samples, b))
    return budgets


def render_snapshot_image(table: torch.Tensor, field_cfg: NGPFieldConfig,
                          occ_grid: torch.Tensor, rays,
                          render_cfg: RenderConfig, snap_cfg: SnapshotConfig,
                          query_keys=("rgb", "distance"), chunk: int = 32768,
                          plain: bool = False) -> dict:
    """Chunked snapshot render of a ray grid (``Rays`` [..., 3]).

    [H, W] frames with H, W divisible by 4 use the beam plan
    (``frame_march_plan``) unless the beam is wider than 3 coarse voxels;
    other ray sets march per ray. Each chunk composites at its own budget
    S with K = ``dedup_k_for(snap_cfg.dedup_ratio, S)`` run candidates.
    ``plain=True`` runs the plain versions of the march and the composite
    on any device (a measurement baseline); the default dispatches on the
    tensors' device."""
    march = march_windows_plain if plain else march_windows
    composite = composite_snapshot_plain if plain else composite_snapshot
    cfg = snapshot_render_cfg(render_cfg, snap_cfg)
    pre_shape = rays.o.shape[:-1]
    o = rays.o.reshape(-1, 3)
    d = rays.d.reshape(-1, 3)
    n = o.shape[0]
    n_pad = (-n) % chunk
    if n_pad:
        o = torch.cat([o, torch.zeros((n_pad, 3), dtype=o.dtype,
                                      device=o.device)])
        d = torch.cat([d, torch.ones((n_pad, 3), dtype=d.dtype,
                                     device=d.device)])
    o, d = o.contiguous(), d.contiguous()

    use_plan = (len(pre_shape) == 2 and pre_shape[0] % 4 == 0
                and pre_shape[1] % 4 == 0)
    if use_plan:
        dil = beam_dilation(rays.d, cfg)
        use_plan = dil <= 3     # wider beams: the plan admits too much
    if use_plan:
        sidx_b, svalid_b, counts = frame_march_plan(
            occ_grid, rays.o, rays.d, cfg, dil, march=march)
        h4, w4 = pre_shape[0] // 4, pre_shape[1] // 4

        def expand(x):
            s = x.shape[1]
            x = x.reshape(h4, w4, s).repeat_interleave(4, 0)
            x = x.repeat_interleave(4, 1).reshape(-1, s)
            if n_pad:
                x = torch.cat([x, torch.zeros((n_pad, s), dtype=x.dtype,
                                              device=x.device)])
            return x.contiguous()

        sidx_px, svalid_px = expand(sidx_b), expand(svalid_b)
        counts = counts.reshape(-1)
        if n_pad:
            counts = torch.cat([counts, counts.new_zeros((n_pad,))])
        slack = 2
    else:
        coarse = coarse_occ_grid(occ_grid, cfg.occ_res)
        counts = count_occupied_windows(occ_grid, o, d, cfg)
        slack = 1
    budgets = chunk_budgets(counts, chunk, slack, cfg)

    outs = []
    for ci, start in enumerate(range(0, n + n_pad, chunk)):
        cfg_c = dataclasses.replace(cfg, max_samples=budgets[ci])
        sl = slice(start, start + chunk)
        if use_plan:
            widx, wvalid = march(occ_grid, o[sl], d[sl], cfg_c,
                                 segments=(sidx_px[sl], svalid_px[sl]))[:2]
        else:
            widx, wvalid = march(occ_grid, o[sl], d[sl], cfg_c,
                                 coarse=coarse)[:2]
        outs.append(composite(table, o[sl], d[sl], widx, wvalid, field_cfg,
                              cfg_c, snap_cfg.res,
                              dedup_k_for(snap_cfg.dedup_ratio, budgets[ci])))
    ret = {}
    for q in query_keys:
        cat = torch.cat([c[q] for c in outs])[:n]
        ret[q] = cat.reshape(*pre_shape, cat.shape[-1])
    return ret
