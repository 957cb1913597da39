"""PropNeRFScene: the proposal-estimator training path.

Counterpart of ``perf_tpu/train/prop_scene.py``: two 5-level hash density
fields (max_res 128 and 256, 2^17 rows) drive importance resampling
(``render/prop.py``) in place of the occupancy grid. One ``fit(pool)``
episode resets the geometry head and keeps the proposal fields; each
phase starts fresh Adam states:

1. geometry + proposals: depth smooth-L1 (beta 1e-2) * depth_loss_weight
   plus ``prop_loss``, the geometry head on Adam (b2 0.999, eps 1e-8), the
   proposal fields on ``PropAdam`` (L2 decay 1e-6 added to the gradient,
   then Adam with b2 0.99, eps 1e-15) under ``prop_optimizer``'s schedule;
   one finiteness verdict over both gradient sets commits or skips both, as
   JAX's single ``guarded_step``;
2. appearance on frozen geometry and proposals: colour smooth-L1 (beta
   5e-2).

A step is a function of (params, proposal params, configs, batch, draws):
``geo_prop_step`` and ``app_step``; the scene calls them with the fixed
cascade ``PROP_FIELD_CFGS``, its draws (``step_draws``) from a
``torch.Generator`` on its device and its geometry reset (``fresh_geo``)
from the host generator. The losses of a phase stay on the device until
it ends: rows [loss, depth, prop, lr, finite] (geometry) and [loss,
colour, lr, finite] (appearance), JAX's columns with the port's finite
flag last, as ``NeRFScene``'s.

Eval renders in chunks of 8192 rays, the last chunk padded with the last
ray, through mid-point (linspace) resampling onto black. There is no
occupancy grid and no snapshot: ``bake_snapshot`` returns None and
``render_snapshot`` is ``render``. ``snapshot`` is always None, so the
server's ``/info`` answers ``snapshot_baked: false`` (JAX's scene has no
such attribute and its ``/info`` raises on a prop scene). The occupancy
path's knobs (``bucket_train``, the strides, ``occ_field_prune``,
``vis_freq``) are ignored, as in JAX. The state dict has JAX's keys
(``prop_params`` under ``p{i}``), so either package loads the other's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import (field_params_from_jax, params_to_numpy,
                       prop_params_from_jax)
from ..core import Rays
from ..core.optim import GuardedAdam, all_finite
from ..fields import (NGPFieldConfig, NGPDensityFieldConfig,
                      init_density_field, init_ngp_params, reset_geo)
from ..render.prop import (PropRenderConfig, prop_draws, prop_loss,
                           render_rays_prop)
from ..utils.metrics import MetricsWriter, phase_timer
from .scene import TrainConfig, leaves, pano_visibility_from_distance
from .schedule import lr_at, smooth_l1

# the reference's fixed proposal cascade (nerf.py:44-57)
PROP_FIELD_CFGS = (NGPDensityFieldConfig(max_res=128),
                   NGPDensityFieldConfig(max_res=256))
EVAL_CHUNK = 8192


def prop_leaves(props: list) -> list:
    return [t for p in props for t in leaves(p)]


def pool_batch(arrs: dict, u: torch.Tensor) -> tuple:
    """Batch rows floor(u * n_valid) of the padded pool arrays, one uniform
    u per ray: (o, d, colours, distances)."""
    n = arrs["n_valid"]
    idx = torch.clamp((u * n).to(torch.int32), max=n - 1).long()
    return (arrs["rays_o"][idx], arrs["rays_d"][idx], arrs["colors"][idx],
            arrs["distances"][idx])


class PropAdam:
    """The proposal fields' optimizer: optax ``chain(add_decayed_weights(
    1e-6), scale_by_adam(0.9, 0.99, eps=1e-15))``, the decay added to the
    gradient before Adam (L2, not AdamW), on ``GuardedAdam``."""

    def __init__(self, params: list):
        self.adam = GuardedAdam(params, b1=0.9, b2=0.99, eps=1e-15)

    def step(self, params: list, grads: list, lr: float,
             finite: torch.Tensor) -> torch.Tensor:
        return self.adam.step(params, [g + 1e-6 * p
                                       for p, g in zip(params, grads)],
                              lr, finite)


def geo_prop_loss(geo: dict, props: list, app: dict, field_cfg, prop_cfgs,
                  cfg: PropRenderConfig, o, d, gt_dist, draws: dict,
                  depth_loss_weight: float):
    """(loss, depth loss, proposal loss) of the geometry + proposal phase
    (the colour head is not evaluated: no term reads it)."""
    out = render_rays_prop({"geo": geo, "app": app}, props, field_cfg,
                           prop_cfgs, o, d, cfg, True, draws, need_rgb=False)
    depth_l = smooth_l1(out["distance"], gt_dist, beta=1e-2)
    p_l = prop_loss(out["t_edges"], out["weights"], out["prop_aux"])
    return depth_l * depth_loss_weight + p_l, depth_l, p_l


def app_loss(app: dict, geo: dict, props: list, field_cfg, prop_cfgs,
             cfg: PropRenderConfig, o, d, gt_col, draws: dict,
             color_loss_weight: float):
    """(loss, colour loss) of the appearance phase."""
    out = render_rays_prop({"geo": geo, "app": app}, props, field_cfg,
                           prop_cfgs, o, d, cfg, True, draws)
    color_l = smooth_l1(out["rgb"], gt_col, beta=5e-2)
    return color_l * color_loss_weight, color_l


def geo_prop_step(geo: dict, props: list, app: dict, opt_geo: GuardedAdam,
                  opt_prop: PropAdam, field_cfg, prop_cfgs,
                  cfg: PropRenderConfig, tc: TrainConfig, batch: tuple,
                  draws: dict, progress: float):
    """One guarded step of the geometry + proposal phase, in place on the
    leaves of ``geo`` and ``props`` (which must require gradients). batch:
    (o, d, gt distance). -> (device row [loss, depth, prop, finite], lr)."""
    o, d, gt_dist = batch
    g_leaves, p_leaves = leaves(geo), prop_leaves(props)
    loss, depth_l, p_l = geo_prop_loss(geo, props, app, field_cfg, prop_cfgs,
                                       cfg, o, d, gt_dist, draws,
                                       tc.depth_loss_weight)
    grads = torch.autograd.grad(loss, g_leaves + p_leaves)
    finite = all_finite(grads)
    lr_g = lr_at(progress, tc.geo_optimizer)
    with torch.no_grad():
        opt_geo.step(g_leaves, grads[:len(g_leaves)], lr_g, finite)
        opt_prop.step(p_leaves, grads[len(g_leaves):],
                      lr_at(progress, tc.prop_optimizer), finite)
    return torch.stack([loss.detach(), depth_l.detach(), p_l.detach(),
                        finite.float()]), lr_g


def app_step(app: dict, geo: dict, props: list, opt: GuardedAdam,
             field_cfg, prop_cfgs, cfg: PropRenderConfig, tc: TrainConfig,
             batch: tuple, draws: dict, progress: float):
    """One guarded step of the appearance phase, in place on ``app``'s
    leaves. batch: (o, d, gt colour). -> (device row [loss, colour,
    finite], lr)."""
    o, d, gt_col = batch
    a_leaves = leaves(app)
    loss, color_l = app_loss(app, geo, props, field_cfg, prop_cfgs, cfg, o, d,
                             gt_col, draws, tc.color_loss_weight)
    grads = torch.autograd.grad(loss, a_leaves)
    lr = lr_at(progress, tc.app_optimizer)
    with torch.no_grad():
        finite = opt.step(a_leaves, grads, lr)
    return torch.stack([loss.detach(), color_l.detach(), finite.float()]), lr


class PropNeRFScene:
    """fit / render through the proposal cascade, with the surface the
    runner and the server use (``fit``, ``render_snapshot``,
    ``bake_snapshot``, ``state_dict``, ``load_state_dict``, ``vis_dir``,
    ``snapshot``, ``device``)."""

    def __init__(self, field_cfg: NGPFieldConfig, prop_cfg: PropRenderConfig,
                 train_cfg: TrainConfig, generator: torch.Generator,
                 device: torch.device, writer: MetricsWriter | None = None):
        self.field_cfg = field_cfg
        self.prop_cfg = prop_cfg
        self.train_cfg = train_cfg
        self.device = torch.device(device)
        self.writer = writer or MetricsWriter(None)
        self.generator = generator
        self.params = init_ngp_params(generator, field_cfg, self.device)
        self.prop_params = [init_density_field(generator, c, self.device)
                            for c in PROP_FIELD_CFGS]
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
        self.draw_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.global_iter_geo = 0
        self.global_iter_app = 0
        # no occupancy grid to bake: the server's /info reads this
        self.snapshot = None
        # the runner sets it; the prop path writes no previews (as JAX)
        self.vis_dir: str | None = None

    def step_draws(self) -> tuple:
        """A training step's draws: (batch uniforms [B], the render's
        ``prop_draws``), from the scene's device generator."""
        b = self.train_cfg.pixel_loss_batch_size
        u = torch.rand((b,), generator=self.draw_gen, device=self.device)
        return u, prop_draws(self.draw_gen, b, self.prop_cfg, self.device)

    def fresh_geo(self) -> dict:
        """The episode's new geometry head (``reset_geo``)."""
        return reset_geo(self.params, self.generator, self.field_cfg,
                         self.device)["geo"]

    def phase_steps(self, phase: str, arrs: dict, n_iters: int):
        """One phase's state (trained leaves, fresh Adam states) with a
        ``step(i)`` that runs step i of ``n_iters``; a context manager."""
        return _PropPhaseSteps(self, phase, arrs, n_iters)

    def _run_phase(self, phase: str, arrs: dict, n_iters: int) -> np.ndarray:
        rows, lrs = [], []
        with self.phase_steps(phase, arrs, n_iters) as steps:
            for i in range(n_iters):
                row, lr = steps.step(i)
                rows.append(row)
                lrs.append(lr)
        vals = torch.stack(rows).cpu().numpy()
        losses = np.concatenate([vals[:, :-1],
                                 np.asarray(lrs, np.float32)[:, None],
                                 vals[:, -1:]], axis=1)
        skipped = int((losses[:, -1] == 0.0).sum())
        if skipped:
            print(f"[perf_tpu_torch] WARNING: {phase} phase skipped {skipped} "
                  f"non-finite-grad step(s) of {n_iters}", flush=True)
        return losses

    def fit(self, sup_pool) -> dict:
        """One episode: a fresh geometry head, the geometry + proposal
        phase, the appearance phase."""
        tc = self.train_cfg
        self.params = {**self.params, "geo": self.fresh_geo()}
        arrs = sup_pool.device_arrays(self.device)
        n_rays = tc.pixel_loss_batch_size
        with phase_timer(self.writer, "fit_geo_prop", self.global_iter_geo,
                         tc.raw_phase_iter_geo * n_rays, "rays"):
            geo_losses = self._run_phase("geo", arrs, tc.raw_phase_iter_geo)
        self.global_iter_geo += tc.raw_phase_iter_geo
        with phase_timer(self.writer, "fit_app_prop", self.global_iter_app,
                         tc.raw_phase_iter_app * n_rays, "rays"):
            app_losses = self._run_phase("app", arrs, tc.raw_phase_iter_app)
        self.global_iter_app += tc.raw_phase_iter_app
        self.writer.flush()
        return {"geo_losses": geo_losses, "app_losses": app_losses}

    @torch.no_grad()
    def render(self, rays: Rays, query_keys=("rgb",),
               chunk: int | None = None) -> dict:
        """Chunked eval render through the cascade (``EVAL_CHUNK`` rays a
        chunk by default): mid-point resampling, a black background,
        distance filled with ``eval_bg_distance``."""
        keys = tuple(query_keys)
        chunk = chunk or EVAL_CHUNK
        o = rays.o.reshape(-1, 3)
        d = rays.d.reshape(-1, 3)
        n = o.shape[0]
        n_pad = (-n) % chunk
        o = torch.cat([o, o[-1:].expand(n_pad, 3)]).contiguous()
        d = torch.cat([d, d[-1:].expand(n_pad, 3)]).contiguous()
        cfg = dataclasses.replace(self.prop_cfg, bg_color="black")
        outs = {k: [] for k in keys}
        for s in range(0, o.shape[0], chunk):
            res = render_rays_prop(self.params, self.prop_params,
                                   self.field_cfg, PROP_FIELD_CFGS,
                                   o[s:s + chunk], d[s:s + chunk], cfg,
                                   train=False)
            for k in keys:
                outs[k].append(res[k])
        shape = rays.o.shape[:-1]
        return {k: torch.cat(outs[k])[:n].reshape(*shape, -1) for k in keys}

    def bake_snapshot(self):
        """No occupancy grid to bake."""
        return None

    def render_snapshot(self, rays: Rays, query_keys=("rgb", "distance"),
                        chunk: int | None = None) -> dict:
        return self.render(rays, query_keys=query_keys, chunk=chunk)

    def get_pano_visibility_mask(self, sup_pool, rays: Rays) -> torch.Tensor:
        distance = self.render(rays, query_keys=("distance",))["distance"]
        return pano_visibility_from_distance(sup_pool, rays, distance)

    def state_dict(self) -> dict:
        return {"params": params_to_numpy(self.params),
                "prop_params": {f"p{i}": params_to_numpy(p)
                                for i, p in enumerate(self.prop_params)},
                "global_iter_geo": self.global_iter_geo,
                "global_iter_app": self.global_iter_app}

    def load_state_dict(self, state: dict):
        self.params = field_params_from_jax(state["params"], self.field_cfg,
                                            self.device)
        self.prop_params = prop_params_from_jax(state["prop_params"],
                                                PROP_FIELD_CFGS, self.device)
        self.global_iter_geo = int(state["global_iter_geo"])
        self.global_iter_app = int(state["global_iter_app"])


class _PropPhaseSteps:
    """One phase of ``PropNeRFScene``: see ``phase_steps``. The trained
    leaves stop requiring gradients when the phase ends."""

    def __init__(self, scene: PropNeRFScene, phase: str, arrs: dict,
                 n_iters: int):
        self.scene, self.phase, self.arrs = scene, phase, arrs
        self.n_iters = n_iters
        params = scene.params
        if phase == "geo":
            self.train, self.frozen = params["geo"], params["app"]
            self.leaves = leaves(params["geo"]) + prop_leaves(
                scene.prop_params)
            self.opts = (GuardedAdam(leaves(params["geo"])),
                         PropAdam(prop_leaves(scene.prop_params)))
        else:
            self.train, self.frozen = params["app"], params["geo"]
            self.leaves = leaves(params["app"])
            self.opts = (GuardedAdam(self.leaves),)
        for t in self.leaves:
            t.requires_grad_(True)

    def step(self, i: int):
        """Step i: -> (device row [loss, *aux, finite], lr)."""
        s = self.scene
        u, draws = s.step_draws()
        o, d, col, dist = pool_batch(self.arrs, u)
        progress = i / self.n_iters
        if self.phase == "geo":
            return geo_prop_step(s.params["geo"], s.prop_params,
                                 s.params["app"], *self.opts, s.field_cfg,
                                 PROP_FIELD_CFGS, s.prop_cfg, s.train_cfg,
                                 (o, d, dist), draws, progress)
        return app_step(s.params["app"], s.params["geo"], s.prop_params,
                        self.opts[0], s.field_cfg, PROP_FIELD_CFGS, s.prop_cfg,
                        s.train_cfg, (o, d, col), draws, progress)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for t in self.leaves:
            t.requires_grad_(False)
        return False
