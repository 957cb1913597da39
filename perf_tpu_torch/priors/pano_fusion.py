"""Pano fusion predictors: per-pixel map optimisation, no neural field.

Counterpart of ``perf_tpu/priors/pano_fusion.py:38-263`` (the reference's
``pano_fusion_inv_predictor.py`` and ``pano_fusion_normal_predictor.py``):
optimise a pano parameter map, per-view scales (distance) and per-view
bias maps so that every tangent view's monocular prediction, resampled
onto the pano, agrees with it, weighted by cos(latitude). Two phases
(global, then with the bias maps), ``iters`` steps in all, a cosine
learning rate, Adam with the non-finite guard. They serve the non-Wild
dataset path (``Dataset.get_ref_distance`` / ``get_ref_normal``).

Every view-to-pano resample goes through ``bilinear_sample`` (the
``bilinear`` kernels on the card; the bias maps and scales train through
its backward). ``scan_chunk`` is read and has no effect (the port steps
one at a time), but must divide ``iters / 2``, as JAX asserts; the normal
predictor's per-phase progress keeps JAX's chunked float32 arithmetic.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import (GuardedAdam, bilinear_sample, direction_to_img_coord,
                    direction_to_pers_img_coord, img_coord_from_hw,
                    img_coord_to_pano_direction, img_to_pano_coord,
                    pano_sample, tangent_c2w, tangent_cameras)
from ..device import get_device
from ..fields.mlp import softplus
from ..train.schedule import smooth_l1
from .interface import DepthPredictor, NormalPredictor


def _view_geometry(gen_res: int, device, ratio: float = 1.0):
    """(dirs [V, r, r, 3], ratios [V, r, r, 1], to, down, right [V, 3],
    c2w [V, 3, 3]) of the 20 tangent views, on ``device``."""
    dirs, ratios, tos, downs, rights = tangent_cameras(gen_res, ratio)
    c2w, _, _ = tangent_c2w(tos, downs, rights)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (dirs, ratios, tos, downs, rights, c2w))


def _pano_projection(pano_hw, tos, downs, rights):
    """Each pano pixel's image coords in every view, clipped to [0, 1]
    [V, H, W, 2], and whether it lands inside the view [V, H, W, 1]."""
    h, w = pano_hw
    pano_dirs = img_coord_to_pano_direction(img_coord_from_hw(
        h, w, device=tos.device))
    coords, masks = direction_to_pers_img_coord(
        pano_dirs[None], tos[:, None, None], downs[:, None, None],
        rights[:, None, None])
    return torch.clamp(coords, 0.0, 1.0), masks


def _distortion_weights(h: int, w: int, device) -> torch.Tensor:
    """cos(latitude) of every pano pixel [H, W]."""
    return torch.cos(img_to_pano_coord(img_coord_from_hw(
        h, w, device=device))[..., 0])


def _weighted_smooth_l1(err, beta: float, weights) -> torch.Tensor:
    d = torch.abs(err)
    sl1 = torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return torch.sum(sl1 * weights) / torch.sum(weights)


def _tv(bias, beta: float) -> torch.Tensor:
    return (smooth_l1(bias[:, 1:], bias[:, :-1], beta=beta)
            + smooth_l1(bias[:, :, 1:], bias[:, :, :-1], beta=beta))


def _cosine_lr(init_lr: float, lr_alpha: float, progress) -> float:
    """init_lr * ((cos(progress * pi) + 1) * (1 - alpha) + alpha) in
    float32, JAX's arithmetic."""
    return float(np.float32(init_lr) * (
        (np.cos(np.float32(progress) * np.float32(math.pi)) + np.float32(1.0))
        * np.float32(1.0 - lr_alpha) + np.float32(lr_alpha)))


@dataclasses.dataclass(frozen=True)
class PanoFusionConfig:
    gen_res: int = 384
    iters: int = 1000
    scan_chunk: int = 50

    def __post_init__(self):
        if self.scan_chunk < 1 or (self.iters // 2) % self.scan_chunk:
            raise ValueError(f"pano fusion scan_chunk={self.scan_chunk} must "
                             f"divide iters / 2 = {self.iters // 2} (JAX "
                             "asserts it)")


def _fit(params: dict, loss_fn, cfg: PanoFusionConfig, progress_of,
         init_lr: float, lr_alpha: float):
    """Both phases: the bias maps' gradient is zeroed in the first (Adam
    still counts the step for them, as optax's one state does); each step
    is guarded."""
    leaves = list(params.values())
    for t in leaves:
        t.requires_grad_(True)
    adam = GuardedAdam(leaves)
    half = cfg.iters // 2
    for phase_i, all_phase in enumerate((False, True)):
        for k in range(half):
            grads = list(torch.autograd.grad(loss_fn(params, all_phase),
                                             leaves))
            if not all_phase:
                grads[list(params).index("bias")] = torch.zeros_like(
                    params["bias"])
            lr = _cosine_lr(init_lr, lr_alpha, progress_of(phase_i, k))
            with torch.no_grad():
                adam.step(leaves, grads, lr)
    for t in leaves:
        t.requires_grad_(False)


class PanoFusionInvPredictor:
    """Distance fusion (the reference's ``inpaint_distance``,
    ``pano_fusion_inv_predictor.py:34-162``), on the card unless ``device``
    says otherwise."""

    def __init__(self, depth_predictor: DepthPredictor,
                 cfg: PanoFusionConfig = PanoFusionConfig(),
                 device="cuda"):
        self.depth = depth_predictor
        self.cfg = cfg
        self.device = get_device(str(device))

    def __call__(self, img, ref_distance, mask):
        return self.inpaint_distance(img, ref_distance, mask)

    def problem(self, img, ref_distance, mask):
        """The fit of ``inpaint_distance``: (initial params, loss_fn(params,
        all_phase), readout(params) -> distance [H, W])."""
        cfg, dev = self.cfg, self.device
        img = torch.as_tensor(img, dtype=torch.float32).to(dev)
        h, w = img.shape[0], img.shape[1]
        ref_distance = torch.as_tensor(ref_distance, dtype=torch.float32).to(
            dev).reshape(h, w)
        mask = torch.as_tensor(mask).to(dev).reshape(h, w).to(torch.float32)

        dirs, ratios, tos, downs, rights, _ = _view_geometry(cfg.gen_res, dev)
        n_views = dirs.shape[0]
        views = pano_sample(img, direction_to_img_coord(dirs))
        pred = torch.clamp(self.depth.predict_depth(views, dirs=dirs), min=0.0)
        pred = pred / (torch.mean(pred, dim=(1, 2, 3), keepdim=True) + 1e-5)
        pred = pred[..., 0]
        proj_coords, proj_masks = _pano_projection((h, w), tos, downs, rights)
        weights = proj_masks * _distortion_weights(h, w, dev)[None, ..., None]
        flat_coords = proj_coords.reshape(n_views, h * w, 2).contiguous()

        params = {"scale": torch.zeros((n_views,), device=dev),
                  "bias": torch.zeros((n_views, cfg.gen_res, cfg.gen_res),
                                      device=dev),
                  "pano": torch.zeros((h, w), device=dev)}

        def pano_distance(p):
            pano_d = softplus(p["pano"]) + 1e-3
            return pano_d * mask + ref_distance * (1.0 - mask)

        def loss_fn(p, all_phase: bool):
            pano_d = pano_distance(p)
            scales = softplus(p["scale"])
            bias = p["bias"] if all_phase else torch.zeros_like(p["bias"])
            pd = torch.clamp((pred + bias) * ratios[..., 0]
                             * scales[:, None, None], min=1e-5)
            proj = bilinear_sample(pd[..., None].contiguous(), flat_coords,
                                   "border").reshape(n_views, h, w, 1)
            err = (proj - pano_d[None, ..., None]) * proj_masks
            align = _weighted_smooth_l1(err, 1e-1, weights)
            reg = (torch.mean(scales) - 1.0) ** 2
            return align + _tv(p["bias"], 1e-1) * 5.0 + reg * 1e-2

        return params, loss_fn, pano_distance

    def inpaint_distance(self, img, ref_distance, mask):
        """img [H, W, 3], ref_distance and mask (1 = free) [H, W] ->
        (distance [H, W], None)."""
        cfg = self.cfg
        params, loss_fn, readout = self.problem(img, ref_distance, mask)
        half = cfg.iters // 2
        _fit(params, loss_fn, cfg,
             lambda phase_i, k: np.float32(phase_i * half + k)
             / np.float32(cfg.iters), 1e-1, 1e-2)
        with torch.no_grad():
            return readout(params), None


class PanoFusionNormalPredictor:
    """Normal fusion (the reference's ``inpaint_normal``,
    ``pano_fusion_normal_predictor.py:29-183``), on the card unless
    ``device`` says otherwise; the pano normal map starts at the inward
    view direction."""

    def __init__(self, normal_predictor: NormalPredictor,
                 cfg: PanoFusionConfig = PanoFusionConfig(),
                 device="cuda"):
        self.normal = normal_predictor
        self.cfg = cfg
        self.device = get_device(str(device))

    def problem(self, img, ref_normal, mask):
        """The fit of ``inpaint_normal``: (initial params, loss_fn(params,
        all_phase), readout(params) -> normal [H, W, 3])."""
        cfg, dev = self.cfg, self.device
        img = torch.as_tensor(img, dtype=torch.float32).to(dev)
        h, w = img.shape[0], img.shape[1]
        ref_normal = torch.as_tensor(ref_normal, dtype=torch.float32).to(
            dev).reshape(h, w, 3)
        mask = torch.as_tensor(mask).to(dev).reshape(h, w, 1).to(
            torch.float32)

        dirs, _, tos, downs, rights, c2w = _view_geometry(cfg.gen_res, dev)
        n_views = dirs.shape[0]
        views = pano_sample(img, direction_to_img_coord(dirs))
        pred = self.normal.predict_normal(views, dirs=dirs, c2w=c2w)
        pred = pred * 2.0 - 1.0
        pred = pred / torch.linalg.norm(pred, dim=-1, keepdim=True)
        pred = torch.einsum("vij,vhwj->vhwi", c2w, pred)
        proj_coords, proj_masks = _pano_projection((h, w), tos, downs, rights)
        weights = proj_masks * _distortion_weights(h, w, dev)[None, ..., None]
        flat_coords = proj_coords.reshape(n_views, h * w, 2).contiguous()

        params = {"bias": torch.zeros((n_views, cfg.gen_res, cfg.gen_res, 3),
                                      device=dev),
                  "pano": -img_coord_to_pano_direction(img_coord_from_hw(
                      h, w, device=dev))}

        def loss_fn(p, all_phase: bool):
            pano_n = p["pano"] * mask + ref_normal * (1.0 - mask)
            pano_norm = torch.linalg.norm(pano_n, dim=-1, keepdim=True)
            pano_n = pano_n / pano_norm
            bias = p["bias"] if all_phase else torch.zeros_like(p["bias"])
            pn = pred + bias
            pn_norm = torch.linalg.norm(pn, dim=-1, keepdim=True)
            pn = pn / pn_norm
            proj = bilinear_sample(pn.contiguous(), flat_coords,
                                   "border").reshape(n_views, h, w, 3)
            err = (proj - pano_n[None]) * proj_masks
            align = _weighted_smooth_l1(err, 0.5, weights)
            reg = (torch.mean((pano_norm - 1.0) ** 2)
                   + torch.mean((pn_norm - 1.0) ** 2))
            return align + _tv(p["bias"], 0.5) * 1.0 + reg * 1e-2

        def readout(p):
            return p["pano"] * mask + ref_normal * (1.0 - mask)

        return params, loss_fn, readout

    def inpaint_normal(self, img, ref_normal, mask):
        """img [H, W, 3], ref_normal [H, W, 3], mask (1 = free) [H, W] ->
        normal [H, W, 3] (not renormalised, as JAX returns it)."""
        cfg = self.cfg
        params, loss_fn, readout = self.problem(img, ref_normal, mask)
        # the cosine restarts in each phase; JAX's progress is p0 + j * (2 /
        # iters) per scan chunk, in float32
        step = np.float32(2.0 / cfg.iters)
        _fit(params, loss_fn, cfg,
             lambda _, k: (np.float32(k // cfg.scan_chunk * cfg.scan_chunk
                                      * 2.0 / cfg.iters)
                           + np.float32(k % cfg.scan_chunk) * step),
             2e-1, 5e-3)
        with torch.no_grad():
            return readout(params)
