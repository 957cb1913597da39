"""NeRFScene: the per-episode training state machine, the baked snapshot.

Counterpart of ``perf_tpu/train/scene.py`` (``TrainConfig``, ``__init__``,
``_sample_batch``, ``select_sample_budget``, ``_get_phase_fn``, the geo and
app steps, ``_run_phase``, ``fit``, ``bake_snapshot``, ``render_snapshot``,
``state_dict`` / ``load_state_dict``). One ``fit(pool)`` episode:

1. the occupancy grid from the pool's back-projected points (the
   ``occ_grid`` kernel), fixed for the episode;
2. a fresh geometry head;
3. the per-episode sample budget and bucket plan, from the occupied-window
   counts of 16,384 pool rays (the one host read-back of the episode), and
   with ``dedup_runs`` on a brick field the run caps of the dedup encode
   (``probe_run_caps``: the same rays marched at the budget);
4. the geometry phase: depth smooth-L1 (beta 1e-2) plus the ramped
   distortion loss, appearance frozen;
5. the appearance phase: colour smooth-L1 (beta 5e-2), geometry frozen;

each step a guarded Adam step on a fresh per-phase Adam, with the
trapezoid + cosine LR. A step reads nothing back to the host: the losses
of a phase stay on the device until the phase ends. The random draws of a
step (batch indices, march jitter, backgrounds, distance noise) come from
a ``torch.Generator`` on the scene's device.

From the second episode on, with ``occ_field_prune``, the pool's grid is
first pruned with the previous episode's fitted field (``field_prune_occ``:
the ``occ_prune`` kernel on the card). With ``vis_freq``, a 128x256 pano
preview of the in-flight parameters is rendered through the field every
``vis_freq`` steps (``render_image``) into ``vis_dir``.

The state dict has the JAX package's keys and layout, so a checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..convert import (field_params_from_jax, occ_grid_from_jax,
                       params_to_numpy)
from ..core import Rays, gen_pano_rays
from ..core.optim import GuardedAdam
from ..fields import NGPFieldConfig, init_ngp_params, reset_geo
from ..fields.ngp import query_density_coords, query_density_ray
from ..kernels import cuda
from ..kernels.brickgrid import BRICK, BrickGridConfig, level_table
from ..kernels.hashgrid import coarse_coords, level_strides
from ..render import RenderConfig
from ..render.renderer import (coarse_occ_grid, count_occupied_windows,
                               march_rays, render_image, render_rays,
                               render_rays_bucketed)
from ..render.snapshot import (SnapshotConfig, bake_snapshot,
                               render_snapshot_image)
from ..utils.io import write_image
from ..utils.metrics import MetricsWriter, phase_timer
from .schedule import OptimConfig, lr_at, smooth_l1
from .sup_pool import _visibility_mask_core

PRUNE_CHUNK = 1 << 21      # voxels per prune chunk; one jitter table for all
PRUNE_TAU = 1e-2           # nerfacc's occupancy threshold on density * 5e-3
RUN_CAP_SLACK = 8          # runs a probed cap adds over the worst probe ray


def pano_visibility_from_distance(sup_pool, rays: Rays,
                                  distance: torch.Tensor) -> torch.Tensor:
    """[H, W] mask: 1 where some registered pano already sees the rendered
    surface, 0 where it is new content, after the 5 / 9 opening."""
    pts = rays.o + rays.d * distance
    return _visibility_mask_core(pts, *sup_pool.device_pano_maps(pts.device))


def _prune_points(v: torch.Tensor, res: int) -> torch.Tensor:
    """Voxel centres [n, 3] of flat voxel indices v, in JAX's operations."""
    ijk = torch.stack([v // (res * res), (v // res) % res, v % res], -1)
    return ((ijk.to(torch.float32) + 0.5) / res - 0.5) * 2.0


def _prune_by_queries(geo: dict, field_cfg: NGPFieldConfig,
                      occ: torch.Tensor, prev: torch.Tensor, res: int,
                      jitter: torch.Tensor, plain: bool) -> torch.Tensor:
    """The pruned grid (``_field_prune_occ``): a voxel of ``occ`` is kept iff
    the max density over its centre and the jittered points (``jitter``
    [n_jitter, chunk, 3] uniforms, voxel v reads row v mod chunk) passes
    ``density * 5e-3 > PRUNE_TAU``, or it is absent from ``prev``. Voxels with
    ``occ == 0`` or ``prev == 0`` keep ``occ`` without a field query; the
    others' densities are geometry-head queries (``plain``: through the
    grid's plain encode)."""
    out = occ.clone()
    v = torch.nonzero((occ != 0) & (prev != 0))[:, 0]
    if v.numel() == 0:
        return out
    chunk = jitter.shape[1]
    base = _prune_points(v, res)
    jit = jitter[:, v % chunk]
    dens = None
    for j in range(-1, jitter.shape[0]):
        pts = base if j < 0 else base + (jit[j] - 0.5) * (2.0 / res)
        d = query_density_coords(geo, pts[:, 0], pts[:, 1], pts[:, 2],
                                 field_cfg, plain)
        dens = d if dens is None else torch.maximum(dens, d)
    out[v] = torch.where((dens * 5e-3) > PRUNE_TAU, occ[v],
                         torch.zeros_like(occ[v]))
    return out


def field_prune_occ_plain(geo: dict, field_cfg: NGPFieldConfig,
                          occ: torch.Tensor, prev: torch.Tensor, res: int,
                          jitter: torch.Tensor) -> torch.Tensor:
    """``_prune_by_queries`` through the plain encodes."""
    return _prune_by_queries(geo, field_cfg, occ, prev, res, jitter,
                             plain=True)


_PRUNE = cuda.register(cuda.CudaKernel(
    "occ_prune", "occ_prune.cu", "occ_prune_launch",
    [cuda.P, cuda.P, cuda.I64, cuda.I32, cuda.P, cuda.I32, cuda.I64,
     cuda.F32, cuda.P, cuda.I32, cuda.P, cuda.P, cuda.I32, cuda.F32,
     cuda.F32, cuda.F32, cuda.P]))


def field_prune_occ_cuda(geo: dict, field_cfg: NGPFieldConfig,
                         occ: torch.Tensor, prev: torch.Tensor, res: int,
                         jitter: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``field_prune_occ_plain`` (brick grids)."""
    g = field_cfg.grid
    if not g.fused_field:
        raise ValueError("occ_prune kernel takes a brick grid")
    if (g.n_features != 2 or g.n_levels > 16 or field_cfg.n_neurons != 64
            or field_cfg.geo_hidden != 1):
        raise ValueError("occ_prune kernel takes 2 features, <= 16 levels "
                         f"and a 64-neuron one-layer geometry head: {field_cfg}")
    dev = occ.device
    cuda.check(occ, "occ", torch.uint8, (res ** 3,))
    cuda.check(prev, "prev", torch.uint8, (res ** 3,), dev)
    cuda.check(jitter, "jitter", torch.float32, (None, None, 3), dev)
    table = geo["table"].to(torch.bfloat16).contiguous()
    cuda.check(table, "table", torch.bfloat16,
               (g.n_levels, g.n_bricks, 128), dev)
    w = geo["mlp"]["w"]
    weights = torch.cat([w[0].to(torch.bfloat16).float().reshape(-1),
                         w[1].float().reshape(-1)]).contiguous()
    out = torch.empty_like(occ)
    _PRUNE.launch(occ.data_ptr(), prev.data_ptr(), res ** 3, res,
                  jitter.data_ptr(), jitter.shape[0], jitter.shape[1],
                  float(np.float32(2.0 / res)), table.data_ptr(), g.n_bricks,
                  weights.data_ptr(), level_table(g, dev).data_ptr(),
                  g.n_levels, float(field_cfg.aabb_min),
                  float(field_cfg.aabb_max - field_cfg.aabb_min), PRUNE_TAU,
                  out.data_ptr())
    return out


def field_prune_occ(geo: dict, field_cfg: NGPFieldConfig, occ, prev,
                    res: int, jitter) -> torch.Tensor:
    """CUDA tensors: the ``occ_prune`` kernel (brick grid), or the shell's
    density queries through the ``hash_encode`` kernel and the geometry
    head (hash grid, as JAX's prune queries ``query_density`` whatever the
    grid); CPU tensors: the plain version."""
    if occ.is_cuda:
        if field_cfg.grid.fused_field:
            return field_prune_occ_cuda(geo, field_cfg, occ, prev, res,
                                        jitter)
        return _prune_by_queries(geo, field_cfg, occ, prev, res, jitter,
                                 plain=False)
    if occ.device.type != "cpu":
        raise ValueError(f"field_prune_occ: unsupported device {occ.device}")
    return field_prune_occ_plain(geo, field_cfg, occ, prev, res, jitter)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    raw_phase_iter_geo: int = 3000
    raw_phase_iter_app: int = 1500
    pixel_loss_batch_size: int = 8192
    color_loss_weight: float = 1.0
    depth_loss_weight: float = 1.0
    distortion_loss_weight: float = 0.1
    density_loss_weight: float = 0.0
    geo_optimizer: OptimConfig = OptimConfig()
    app_optimizer: OptimConfig = OptimConfig()
    # the proposal fields' schedule (the prop estimator only)
    prop_optimizer: OptimConfig = OptimConfig(
        init_lr=1e-4, peak_lr=1e-3, peak_at=0.1, lr_alpha=0.1)
    # two-budget batches (render_rays_bucketed), planned per episode
    bucket_train: bool = True
    # in-window sample strides of the two phases (the march ladder is
    # unchanged; engaged only where they divide the window and the budget)
    app_sample_stride: int = 2
    geo_sample_stride: int = 2
    # the run-dedup encode (K12) on the training steps of a brick field:
    # per-level caps probed each episode (NeRFScene.probe_run_caps); a hash
    # field gets none and the proposal estimator reads none, as in JAX
    dedup_runs: bool = False
    # prune the pool shell with the previous episode's field, from the
    # second episode on
    occ_field_prune: bool = False
    # a field-path pano preview every vis_freq steps (0 = off)
    vis_freq: int = 0


def leaves(head: dict) -> list:
    """A head's or proposal field's tensors: table, then MLP weights."""
    return [head["table"]] + list(head["mlp"]["w"])


class NeRFScene:
    """Owns field params, the occupancy grid, the training state and the
    bake, on one device."""

    def __init__(self, field_cfg: NGPFieldConfig, render_cfg: RenderConfig,
                 generator: torch.Generator, device: torch.device,
                 snap_cfg: SnapshotConfig | None = None,
                 train_cfg: TrainConfig | None = None,
                 writer: MetricsWriter | None = None):
        self.field_cfg = field_cfg
        self.render_cfg = render_cfg
        self.train_cfg = train_cfg or TrainConfig()
        self.device = torch.device(device)
        self.writer = writer or MetricsWriter(None)
        # host generator: parameter init; device generator: step draws
        self.generator = generator
        self.params = init_ngp_params(generator, field_cfg, self.device)
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        self.draw_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.occ_grid = torch.zeros((render_cfg.occ_res ** 3,),
                                    dtype=torch.uint8, device=self.device)
        self.global_iter_geo = 0
        self.global_iter_app = 0
        self.sample_budget: int | None = None
        self.bucket_plan: tuple | None = None
        # the episode's run caps (TrainConfig.dedup_runs; probe_run_caps)
        self.run_caps: tuple | None = None
        # baked table (render/snapshot.py); stale whenever the field changes
        self.snapshot: torch.Tensor | None = None
        self.snap_cfg = snap_cfg or SnapshotConfig()
        # the grid the previous episode trained through (occ_field_prune)
        self._prev_occ: torch.Tensor | None = None
        # where the vis_freq previews go (PNG); None writes none
        self.vis_dir: str | None = None
        # voxel counts of the last prune (occ_field_prune)
        self.last_prune: dict | None = None

    # -- sampling and budgets ------------------------------------------------

    def _uniform(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.draw_gen, device=self.device)

    def _sample_batch(self, arrs: dict, u: torch.Tensor):
        """Batch rows floor(u * n_valid) of the padded pool arrays."""
        n = arrs["n_valid"]
        idx = torch.clamp((u * n).to(torch.int32), max=n - 1).long()
        return (arrs["rays_o"][idx], arrs["rays_d"][idx], arrs["colors"][idx],
                arrs["distances"][idx])

    def select_sample_budget(self, arrs: dict, probe_rays: int = 16384,
                             jitter: torch.Tensor | None = None) -> int:
        """Smallest safe ``max_samples`` for the episode's occupancy grid
        and the two-budget bucket plan: the occupied-window counts of a
        uniform subsample of the pool over the full ladder, +1 window of
        slack, rounded up to a multiple of 16 samples. With ``dedup_runs``
        it also sets ``run_caps`` (``probe_run_caps`` on the same rays,
        ``jitter`` passed on)."""
        rc, tc = self.render_cfg, self.train_cfg
        n_valid = arrs["n_valid"]
        n = min(probe_rays, n_valid)
        idx = torch.from_numpy(np.linspace(0, n_valid - 1, n).astype(
            np.int64)).to(self.device)
        o = arrs["rays_o"][idx].contiguous()
        d = arrs["rays_d"][idx].contiguous()
        counts = count_occupied_windows(self.occ_grid, o, d, rc).cpu().numpy()
        mc = rc.march_coarse
        worst = int(counts.max()) + 1
        budget = max(4 * mc, -(-worst * mc // 16) * 16)
        budget = min(rc.max_samples, budget)

        self.bucket_plan = None
        if tc.bucket_train:
            batch = tc.pixel_loss_batch_size
            w_low = int(np.percentile(counts, 98.0)) + 1
            s_low = max(4 * mc, -(-w_low * mc // 16) * 16)
            n_high = max(64, batch // 8)
            frac_high = float(np.mean(counts > s_low // mc))
            if s_low < budget and n_high < batch \
                    and frac_high * batch * 8.0 <= n_high:
                self.bucket_plan = (s_low, n_high)

        self.run_caps = None
        if tc.dedup_runs:
            self.run_caps = self.probe_run_caps(o, d, budget, jitter)
        return budget

    def probe_run_caps(self, o: torch.Tensor, d: torch.Tensor, budget: int,
                       jitter: torch.Tensor | None = None) -> tuple | None:
        """Per-level run caps of the dedup encode (``_probe_run_caps``):
        one stratified march of the probe rays at the episode budget
        (``jitter`` [n, 1], one draw from the scene's generator unless
        given); levels whose stride at the budget exceeds 2 get 0, the
        others the worst per-ray count of brick-id changes (unhashed ids,
        ``res // 3 + 1`` bricks an axis) + 1 + RUN_CAP_SLACK, kept only where
        it is below the level's point count. None for a hash grid, or
        where every cap is 0."""
        grid = self.field_cfg.grid
        if not isinstance(grid, BrickGridConfig):
            return None
        rc = dataclasses.replace(self.render_cfg, max_samples=budget)
        if jitter is None:
            jitter = self._uniform(o.shape[0], 1)
        t_mid, _ = march_rays(self.occ_grid, o, d, rc, jitter)
        pts = o[:, None, :] + d[:, None, :] * t_mid[:, :, None]
        fc = self.field_cfg
        x01 = torch.clamp((pts - fc.aabb_min) / (fc.aabb_max - fc.aabb_min),
                          0.0, 1.0)
        strides = level_strides(grid, rc.step, budget)
        caps = []
        for lvl, k in enumerate(strides):
            if k > 2:
                caps.append(0)
                continue
            xs = coarse_coords(x01, k)
            res = grid.level_res(lvl)
            c0 = torch.div(torch.clamp(torch.floor(xs * res), 0, res - 1)
                           .to(torch.int64), BRICK, rounding_mode="floor")
            nbk = res // BRICK + 1
            r = c0[..., 0] * nbk * nbk + c0[..., 1] * nbk + c0[..., 2]
            worst = int(((r[:, 1:] != r[:, :-1]).sum(1) + 1).max())
            cap = worst + RUN_CAP_SLACK
            caps.append(cap if cap < xs.shape[1] else 0)
        return tuple(caps) if any(caps) else None

    def phase_render_cfg(self, phase: str):
        """(RenderConfig, bucket plan or None) of a phase: the episode
        budget and run caps, and the phase's sample stride where it divides
        the window and the budget (``_get_phase_fn``)."""
        tc = self.train_cfg
        budget = self.sample_budget or self.render_cfg.max_samples
        plan = self.bucket_plan if tc.bucket_train else None
        caps = self.run_caps if tc.dedup_runs else None
        rc = dataclasses.replace(self.render_cfg, max_samples=budget,
                                 run_caps=caps)
        stride = tc.app_sample_stride if phase == "app" else tc.geo_sample_stride
        if (stride > 1 and rc.march_coarse % stride == 0
                and budget % (2 * stride) == 0):
            rc = dataclasses.replace(rc, sample_stride=stride,
                                     max_samples=budget // stride)
            if plan:
                plan = (max(4 * rc.samples_per_window, plan[0] // stride),
                        plan[1])
        return rc, plan

    # -- steps -----------------------------------------------------------------

    def _render(self, geo, app, rc, plan, coarse, o, d, **flags):
        b = o.shape[0]
        draws = {"jitter": self._uniform(b, 1), "bg": self._uniform(b, 3),
                 "noise": self._uniform(b, 1)}
        params = {"geo": geo, "app": app}
        if plan:
            return render_rays_bucketed(params, self.field_cfg, self.occ_grid,
                                        o, d, rc, plan[0], plan[1], draws,
                                        coarse, **flags)
        return render_rays(params, self.field_cfg, self.occ_grid, o, d, rc,
                           draws, coarse, **flags)

    def _geo_loss(self, geo, app, rc, plan, coarse, arrs, i: int):
        tc = self.train_cfg
        o, d, _, gt_dist = self._sample_batch(
            arrs, self._uniform(tc.pixel_loss_batch_size))
        out = self._render(geo, app, rc, plan, coarse, o, d,
                           stop_app_grad=True, need_rgb=False)
        depth_l = smooth_l1(out["distance"], gt_dist, beta=1e-2)
        dist_l = torch.mean(out["dist_loss"])
        # the distortion ramp counts app-phase iterations (reference quirk)
        ratio = min(i / tc.raw_phase_iter_app * 2.0, 1.0)
        loss = (depth_l * tc.depth_loss_weight
                + dist_l * tc.distortion_loss_weight * ratio)
        if tc.density_loss_weight > 1e-7:
            pts = (self._uniform(8192, 3) * 2 - 1) * 0.99
            dens = query_density_ray(geo, pts[:, :1], pts[:, 1:2], pts[:, 2:],
                                     self.field_cfg,
                                     (1,) * self.field_cfg.grid.n_levels)
            loss = loss + tc.density_loss_weight * torch.mean(dens)
        return loss, (depth_l, dist_l)

    def _app_loss(self, app, geo, rc, plan, coarse, arrs, i: int):
        tc = self.train_cfg
        o, d, gt_col, _ = self._sample_batch(
            arrs, self._uniform(tc.pixel_loss_batch_size))
        out = self._render(geo, app, rc, plan, coarse, o, d,
                           stop_geo_grad=True)
        color_l = smooth_l1(out["rgb"], gt_col, beta=5e-2)
        return color_l * tc.color_loss_weight, (color_l,)

    def phase_steps(self, phase: str, arrs: dict, n_iters: int):
        """The state of one phase (its render config and bucket plan, the
        episode's coarse grid, the trained leaves and a fresh Adam) with a
        ``step(i)`` that runs step i of ``n_iters``."""
        return _PhaseSteps(self, phase, arrs, n_iters)

    def _run_phase(self, phase: str, arrs: dict, n_iters: int) -> np.ndarray:
        """``n_iters`` guarded Adam steps of one phase. Returns the losses
        [n_iters, 5] (geo: loss, depth, distortion, lr, finite) or [n_iters,
        4] (app: loss, colour, lr, finite), read back once at the end."""
        rows, lrs = [], []
        vis = self.train_cfg.vis_freq
        base = self.global_iter_geo if phase == "geo" else self.global_iter_app
        with self.phase_steps(phase, arrs, n_iters) as steps:
            for i in range(n_iters):
                row, lr = steps.step(i)
                rows.append(row)
                lrs.append(lr)
                if vis and (base + i + 1) % vis == 0:
                    self._write_vis(phase, base + i + 1, steps.train,
                                    steps.frozen)
        vals = torch.stack(rows).cpu().numpy()
        losses = np.concatenate([vals[:, :-1],
                                 np.asarray(lrs, np.float32)[:, None],
                                 vals[:, -1:]], axis=1)

        skipped = int((losses[:, -1] == 0.0).sum())
        step0 = self.global_iter_geo if phase == "geo" else self.global_iter_app
        if skipped:
            print(f"[perf_tpu_torch] WARNING: {phase} phase skipped {skipped} "
                  f"non-finite-grad step(s) of {n_iters}", flush=True)
            self.writer.add_scalars(
                {f"others/skipped_steps_{phase}": float(skipped)}, step0)
        every = max(n_iters // 30, 1)
        for j in range(0, n_iters, every):
            if phase == "geo":
                scalars = {"nerf_loss/depth_loss": losses[j, 1],
                           "nerf_loss/dist_loss": losses[j, 2],
                           "others/lr_geo": losses[j, 3]}
            else:
                scalars = {"nerf_loss/color_loss": losses[j, 1],
                           "others/lr_app": losses[j, 2]}
            self.writer.add_scalars(scalars, step0 + j)
        if phase == "geo":
            self.global_iter_geo += n_iters
        else:
            self.global_iter_app += n_iters
        return losses

    def _write_vis(self, phase: str, global_iter: int, train_params: dict,
                   frozen: dict):
        """Mid-episode preview: a 128x256 identity-pose pano of the
        in-flight parameters through the field at the fixed render config,
        written to ``vis_dir``."""
        params = ({"geo": train_params, "app": frozen} if phase == "geo"
                  else {"geo": frozen, "app": train_params})
        rays = gen_pano_rays(torch.eye(4, device=self.device), 128, 256)
        out = render_image(params, self.field_cfg, self.occ_grid, rays,
                           self.render_cfg, query_keys=("rgb", "distance"))
        if self.vis_dir:
            os.makedirs(self.vis_dir, exist_ok=True)
            write_image(os.path.join(self.vis_dir,
                                     f"{phase}_{global_iter:06d}.png"),
                        torch.clamp(out["rgb"], 0.0, 1.0).cpu().numpy())

    def _field_prune_occ(self, occ: torch.Tensor,
                         prev: torch.Tensor) -> torch.Tensor:
        """Prune ``occ`` with the current (pre-reset) geometry head and a
        jitter table [2, min(2^21, res^3), 3] drawn here."""
        res = self.render_cfg.occ_res
        jitter = self._uniform(2, min(PRUNE_CHUNK, res ** 3), 3)
        return field_prune_occ(self.params["geo"], self.field_cfg, occ, prev,
                               res, jitter)

    # -- public API ------------------------------------------------------------

    def fit(self, sup_pool) -> dict:
        """One training episode over the current pool."""
        tc, rc = self.train_cfg, self.render_cfg
        occ = sup_pool.gen_occ_grid(rc.occ_res, rc.occ_dilation, self.device)
        if tc.occ_field_prune and self._prev_occ is not None \
                and self.global_iter_geo > 0:
            # with the field fitted last episode: before reset_geo below
            with phase_timer(self.writer, "fit_prune", self.global_iter_geo):
                n_before = int(occ.sum())
                n_shell = int(((occ != 0) & (self._prev_occ != 0)).sum())
                occ = self._field_prune_occ(occ, self._prev_occ)
                n_after = int(occ.sum())
            # the shell (in both grids) is what the field decides on
            self.last_prune = {"voxels": n_before, "shell": n_shell,
                               "shell_kept": n_after - (n_before - n_shell)}
            self.writer.add_scalars(
                {f"prune/{k}": v for k, v in self.last_prune.items()},
                self.global_iter_geo)
        self._prev_occ = occ
        self.occ_grid = occ
        self.params = reset_geo(self.params, self.generator, self.field_cfg,
                                self.device)
        arrs = sup_pool.device_arrays(self.device)
        self.sample_budget = self.select_sample_budget(arrs)
        self.snapshot = None
        plan = self.bucket_plan or (0, 0)
        self.writer.add_scalars(
            {"budget/max_samples": self.sample_budget,
             "budget/bucket_s_low": plan[0],
             "budget/bucket_n_high": plan[1]}, self.global_iter_geo)
        n_rays = tc.pixel_loss_batch_size
        with phase_timer(self.writer, "fit_geo", self.global_iter_geo,
                         tc.raw_phase_iter_geo * n_rays, "rays"):
            geo_losses = self._run_phase("geo", arrs, tc.raw_phase_iter_geo)
        with phase_timer(self.writer, "fit_app", self.global_iter_app,
                         tc.raw_phase_iter_app * n_rays, "rays"):
            app_losses = self._run_phase("app", arrs, tc.raw_phase_iter_app)
        self.writer.flush()
        return {"geo_losses": geo_losses, "app_losses": app_losses}

    def bake_snapshot(self):
        """Bake the current field into the dense snapshot table."""
        self.snapshot = bake_snapshot(self.params, self.field_cfg,
                                      self.occ_grid, self.render_cfg.occ_res,
                                      self.snap_cfg)
        return self.snapshot

    def render_snapshot(self, rays: Rays, query_keys=("rgb", "distance"),
                        chunk: int = 32768, plain: bool = False):
        """Eval render through the baked snapshot (bakes on first use)."""
        if self.snapshot is None:
            self.bake_snapshot()
        return render_snapshot_image(self.snapshot, self.field_cfg,
                                     self.occ_grid, rays, self.render_cfg,
                                     self.snap_cfg, query_keys=query_keys,
                                     chunk=chunk, plain=plain)

    def state_dict(self) -> dict:
        return {
            "params": params_to_numpy(self.params),
            "occ_grid": self.occ_grid.cpu().numpy(),
            "global_iter_geo": self.global_iter_geo,
            "global_iter_app": self.global_iter_app,
            "sample_budget": self.sample_budget or 0,
        }

    def load_state_dict(self, state: dict):
        self.params = field_params_from_jax(state["params"], self.field_cfg,
                                            self.device)
        self.occ_grid = occ_grid_from_jax(state["occ_grid"], self.device)
        self.snapshot = None   # loaded field -> any existing bake is stale
        self.global_iter_geo = int(state["global_iter_geo"])
        self.global_iter_app = int(state["global_iter_app"])
        self.sample_budget = int(state.get("sample_budget", 0)) or None


class _PhaseSteps:
    """One training phase: see ``NeRFScene.phase_steps``. Used as a context
    manager, so the trained leaves stop requiring gradients afterwards."""

    def __init__(self, scene: NeRFScene, phase: str, arrs: dict,
                 n_iters: int):
        tc = scene.train_cfg
        self.scene, self.arrs, self.n_iters = scene, arrs, n_iters
        self.rc, self.plan = scene.phase_render_cfg(phase)
        self.coarse = coarse_occ_grid(scene.occ_grid, self.rc.occ_res)
        train_key, frozen_key = (("geo", "app") if phase == "geo"
                                 else ("app", "geo"))
        self.train = scene.params[train_key]
        self.frozen = scene.params[frozen_key]
        self.loss_fn = scene._geo_loss if phase == "geo" else scene._app_loss
        self.ocfg = tc.geo_optimizer if phase == "geo" else tc.app_optimizer
        self.leaves = leaves(self.train)
        for t in self.leaves:
            t.requires_grad_(True)
        self.opt = GuardedAdam(self.leaves)

    def step(self, i: int):
        """Step i: -> (device row [loss, *aux, finite], lr)."""
        loss, aux = self.loss_fn(self.train, self.frozen, self.rc, self.plan,
                                 self.coarse, self.arrs, i)
        grads = torch.autograd.grad(loss, self.leaves)
        lr = lr_at(i / self.n_iters, self.ocfg)
        with torch.no_grad():
            finite = self.opt.step(self.leaves, grads, lr)
        return torch.stack([loss.detach(), *(a.detach() for a in aux),
                            finite.float()]), lr

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for t in self.leaves:
            t.requires_grad_(False)
        return False
