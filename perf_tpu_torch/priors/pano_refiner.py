"""PanoGeoRefiner: distil a distance and normal map into a sphere distance
field and read the smoothed maps back.

Counterpart of ``perf_tpu/priors/pano_refiner.py:34-165`` (the reference's
``pano_geo_refiner.py:60-153``): ``n_iters`` steps of ``batch_size`` random
directions, a smooth-L1 distance loss (beta 1e-2) against the map's
bilinear sample plus the tangent-projection normal loss (beta 0.5, weight
``normal_loss_weight``), Adam with a half-cosine learning rate and the
non-finite guard. The default field is JAX's flagship: brick + analytic,
fine_res 4096, weight-normed MLP, raw output; hash + ``ad`` or ``fd`` is
the reference-parity variant. ``scan_chunk`` is read and has no effect
(the port steps one at a time), but must divide ``n_iters``, as JAX
asserts.

Randomness comes from a ``draws`` object (``TorchDraws`` by default):
``sphere_init(cfg, device)``, ``directions(batch)`` -> (the step's
direction draw [B, 3] before normalising, the normal loss's tangent draw
[B, 3]), both standard normal, and ``normal(shape)`` once for the
readback's normals. A test can hand in JAX's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import GuardedAdam, bilinear_sample, direction_to_img_coord
from ..device import get_device
from ..fields.sphere_field import (SphereFieldConfig,
                                   sphere_field_distance_and_grad)
from ..train.schedule import smooth_l1
from ..utils.metrics import phase_timer
from .pano_joint import (TorchDraws, _sp_leaves, field_readback,
                         normal_projection_errors)


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    n_iters: int = 5000
    batch_size: int = 32768
    init_lr: float = 1e-2
    lr_alpha: float = 1e-2
    normal_loss_weight: float = 5e-2
    scan_chunk: int = 1
    field: SphereFieldConfig = SphereFieldConfig(
        fine_res=4096, weight_norm=True, output="raw", encoding="brick",
        grad_mode="analytic")

    def __post_init__(self):
        if self.scan_chunk < 1 or self.n_iters % self.scan_chunk:
            raise ValueError(f"refiner scan_chunk={self.scan_chunk} must "
                             f"divide n_iters={self.n_iters} (JAX asserts "
                             "it)")


class PanoGeoRefiner:
    """Runs on the card unless ``device`` says otherwise."""

    def __init__(self, cfg: RefinerConfig = RefinerConfig(), seed: int = 0,
                 writer=None, device="cuda", draws=None):
        self.cfg = cfg
        self.writer = writer
        self.device = get_device(str(device))
        self.draws = draws or TorchDraws(seed, self.device)

    def step_loss(self, params: dict, distances, normals, dirs, ortho):
        """The distillation loss at unit directions ``dirs`` [B, 3] with
        the normal loss's tangent draw ``ortho`` [B, 3]."""
        cfg = self.cfg
        coords = direction_to_img_coord(dirs)
        ref_d = bilinear_sample(distances, coords)[..., 0]
        ref_n = bilinear_sample(normals, coords)
        pd, pg = sphere_field_distance_and_grad(params, dirs, cfg.field)
        d_loss = smooth_l1(ref_d, pd, beta=1e-2)
        errors = normal_projection_errors(dirs, pg, ref_n, ortho)
        n_loss = smooth_l1(errors, torch.zeros_like(errors), beta=0.5)
        return d_loss + n_loss * cfg.normal_loss_weight

    def distill_step(self, params: dict, leaves: list, adam: GuardedAdam,
                     distances, normals, i: int):
        """Step ``i`` of the distillation: the loss at the step's draws, its
        gradients to ``leaves`` (``_sp_leaves(params)``) and the guarded
        Adam update at the half-cosine learning rate (float32, JAX's
        arithmetic). -> (loss, gradients)."""
        cfg = self.cfg
        dirs, ortho = self.draws.directions(cfg.batch_size)
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
        loss = self.step_loss(params, distances, normals, dirs, ortho)
        grads = torch.autograd.grad(loss, leaves)
        progress = np.float32(i) / np.float32(cfg.n_iters)
        lr = np.float32(cfg.init_lr) * (
            (np.cos(progress * np.float32(math.pi)) * np.float32(0.5)
             + np.float32(0.5)) * np.float32(1.0 - cfg.lr_alpha)
            + np.float32(cfg.lr_alpha))
        with torch.no_grad():
            adam.step(leaves, list(grads), float(lr))
        return loss.detach(), grads

    def refine(self, distances, normals):
        """distances [H, W(, 1)], normals [H, W, 3] -> (distance [H, W, 1],
        normal [H, W, 3]) on the refiner's device."""
        cfg, dev = self.cfg, self.device
        distances = torch.as_tensor(distances, dtype=torch.float32).to(dev)
        h, w = distances.shape[0], distances.shape[1]
        distances = distances.reshape(h, w, -1)[..., :1].contiguous()
        normals = torch.as_tensor(normals, dtype=torch.float32).to(
            dev).reshape(h, w, 3).contiguous()

        params = self.draws.sphere_init(cfg.field, dev)
        leaves = _sp_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        adam = GuardedAdam(leaves)
        with phase_timer(self.writer, "refiner_distill", n_items=cfg.n_iters,
                         item_name="iters"):
            for i in range(cfg.n_iters):
                self.distill_step(params, leaves, adam, distances, normals, i)
            float(leaves[0].detach().reshape(-1)[0])
        with phase_timer(self.writer, "refiner_readback", n_items=h * w,
                         item_name="px"):
            dist, normal = field_readback(params, cfg.field, h, w, dev,
                                          self.draws)
            float(dist[0, 0, 0])
        return dist, normal
