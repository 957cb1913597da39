"""PanoJointPredictor: the geometry engine of the bootstrap and of every anchor.

Counterpart of ``perf_tpu/priors/pano_joint.py:93-353``: fuse per-view
monocular depth and normal priors into one spherical distance field by
distillation, then read back full-resolution pano distance and normals.

1. Views: the 20 icosahedral tangent views at each of ``ratios`` (a random
   yaw per ratio from a NumPy generator seeded like JAX's), cut out of the
   pano in one batched resample.
2. Priors: one batched call of each backend over all views.
3. Distillation, two phases of ``iters_per_phase`` steps: smooth-L1
   distance loss against the scaled (and, in the second phase, locally
   biased) prior, the normal-consistency terms through the field's
   direction gradients, the scale regulariser, TV on the local
   bias maps (second phase), and a progress-ramped anchor to the known
   reference distance where ``mask`` is 0. Three Adam groups (global
   scale, the sphere field, the local bias maps, the last only in the
   second phase), a cosine ratio on all learning rates, and the guard: a
   step with any non-finite gradient changes nothing.
4. Readback: distance and its direction gradient at every pixel in chunks
   of 2^16 directions, normals from the gradients.

Every view resample and the anchor lookups go through ``bilinear_sample``
(the ``bilinear`` kernels on the card; the local bias maps train through
its backward). The field is JAX's flagship default, brick + ``analytic``
(the ``brick_encode_grad`` kernels), or what ``field`` selects: hash +
``ad`` (the published PeRF's field; the ``hash_encode_grad`` kernels) or
``fd`` (seven point encodes a step). ``scan_chunk`` is read and has no
effect (the port steps one at a time), but must divide
``iters_per_phase``, as JAX asserts.

Randomness comes from a ``draws`` object: ``sphere_init(cfg, device)``,
``step(n_views, batch)`` -> (coords [V, B, 2] uniform, ortho [V, B, 3]
standard normal) and ``normal(shape)``. ``TorchDraws``
draws them from torch generators; a test can hand in JAX's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import (bilinear_sample, direction_to_img_coord, GuardedAdam,
                    img_coord_from_hw, img_coord_to_pano_direction,
                    pano_sample, tangent_c2w, tangent_cameras)
from ..core.optim import all_finite
from ..fields.mlp import softplus
from ..fields.sphere_field import (SphereFieldConfig, grads_to_normal,
                                   init_sphere_field,
                                   sphere_field_distance_and_grad)
from ..train.schedule import smooth_l1
from ..utils.metrics import phase_timer
from .interface import DepthPredictor, NormalPredictor


def smooth_l1_none(pred, target, beta: float):
    d = torch.abs(pred - target)
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def normal_projection_errors(dirs, grads, ref_normals, ortho_a):
    """Two random tangent vectors (from the normal draw ``ortho_a``),
    tilted by the distance gradient, must both be orthogonal to the
    reference normal: -> [..., 2]."""
    ortho_b = torch.linalg.cross(dirs, ortho_a)
    ortho_b = ortho_b / torch.linalg.norm(ortho_b, dim=-1, keepdim=True)
    ortho_a = torch.linalg.cross(ortho_b, dirs)
    ortho_a = ortho_a / torch.linalg.norm(ortho_a, dim=-1, keepdim=True)
    val_a = torch.sum(grads * ortho_a, -1, keepdim=True) * dirs + ortho_a
    val_a = val_a / torch.linalg.norm(val_a, dim=-1, keepdim=True)
    val_b = torch.sum(grads * ortho_b, -1, keepdim=True) * dirs + ortho_b
    val_b = val_b / torch.linalg.norm(val_b, dim=-1, keepdim=True)
    err_a = torch.sum(val_a * ref_normals, -1, keepdim=True)
    err_b = torch.sum(val_b * ref_normals, -1, keepdim=True)
    return torch.cat([err_a, err_b], -1)


@dataclasses.dataclass(frozen=True)
class JointPredictorConfig:
    gen_res: int = 384
    ratios: tuple = (1.1, 1.4, 1.7)
    local_batch: int = 256
    iters_per_phase: int = 1500
    init_lr: float = 1e-1        # global (scale) group
    init_lr_sp: float = 1e-2     # sphere field
    init_lr_local: float = 1e-1  # local bias maps
    lr_alpha: float = 1e-2
    normal_bias_res: int = 128
    scan_chunk: int = 1
    # JAX's flagship: the brick encoding with analytic first-order
    # gradients; the reference-parity hash + 'ad' field is selected with
    # priors.joint.field.{encoding,grad_mode}
    field: SphereFieldConfig = SphereFieldConfig(
        fine_res=2048, encoding="brick", grad_mode="analytic")

    def __post_init__(self):
        if self.scan_chunk < 1 or self.iters_per_phase % self.scan_chunk:
            raise ValueError(f"priors.joint.scan_chunk={self.scan_chunk} must "
                             "divide iters_per_phase="
                             f"{self.iters_per_phase} (JAX asserts it)")


class TorchDraws:
    """The distillation's random draws from torch generators: a host one
    for the field's init, one on the device for the per-step draws."""

    def __init__(self, seed: int, device):
        self.host = torch.Generator().manual_seed(seed)
        self.dev = torch.Generator(device=device).manual_seed(seed + 1)
        self.device = torch.device(device)

    def sphere_init(self, cfg: SphereFieldConfig, device) -> dict:
        return init_sphere_field(self.host, cfg, device)

    def step(self, n_views: int, batch: int):
        coords = torch.rand((n_views, batch, 2), generator=self.dev,
                            device=self.device)
        ortho = torch.randn((n_views, batch, 3), generator=self.dev,
                            device=self.device)
        return coords, ortho

    def directions(self, batch: int):
        """The geometry refiner's per-step draws: directions before
        normalising and the tangent draw, [batch, 3] each."""
        return self.normal((batch, 3)), self.normal((batch, 3))

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.dev, device=self.device)


def _sp_leaves(sp: dict) -> list:
    """The sphere field's tensors: the table, then the MLP's weights (or
    weight-norm directions and gains) and biases."""
    keys = ("v", "g", "b") if "v" in sp["mlp"] else ("w", "b")
    return [sp["table"], *(t for k in keys for t in sp["mlp"][k])]


def field_readback(sp: dict, cfg: SphereFieldConfig, h: int, w: int, device,
                   draws):
    """Distance [h, w, 1] and normals [h, w, 3] of a sphere field at every
    pixel, in chunks of 2^16 directions (each direction's result is its
    own, so the last chunk is not padded as JAX pads it); the normals'
    tangent basis from ``draws.normal``."""
    pano_dirs = img_coord_to_pano_direction(img_coord_from_hw(
        h, w, device=device))
    flat = pano_dirs.reshape(-1, 3)
    chunk = 1 << 16
    dists, grads = [], []
    with torch.no_grad():
        for s in range(0, flat.shape[0], chunk):
            dd, gg = sphere_field_distance_and_grad(sp, flat[s:s + chunk], cfg)
            dists.append(dd)
            grads.append(gg)
    dist = torch.cat(dists).reshape(h, w, 1)
    grad = torch.cat(grads).reshape(h, w, 3)
    normal = grads_to_normal(pano_dirs, grad, draws.normal((h, w, 3)))
    return dist, normal


class PanoJointPredictor:
    def __init__(self, depth_predictor: DepthPredictor,
                 normal_predictor: NormalPredictor,
                 cfg: JointPredictorConfig = JointPredictorConfig(),
                 seed: int = 0, writer=None, device="cpu", draws=None):
        self.depth = depth_predictor
        self.normal = normal_predictor
        self.cfg = cfg
        self.writer = writer
        self.device = torch.device(device)
        self._np_rng = np.random.default_rng(seed)
        self.draws = draws or TorchDraws(seed, self.device)

    # -- view generation -----------------------------------------------------

    def _make_views(self, img: torch.Tensor):
        cfg = self.cfg
        parts = []
        for ratio in cfg.ratios:
            yaw = float(self._np_rng.uniform(0.0, 2 * np.pi))
            parts.append(tangent_cameras(cfg.gen_res, ratio, yaw=yaw))
        dirs, pers_ratios, tos, downs, rights = (
            np.concatenate([p[k] for p in parts]) for k in range(5))
        c2w, _, _ = tangent_c2w(tos, downs, rights)
        dev = self.device
        dirs = torch.from_numpy(dirs).to(dev)
        views = pano_sample(img, direction_to_img_coord(dirs))
        return (dirs, torch.from_numpy(pers_ratios).to(dev),
                torch.from_numpy(c2w).to(dev), views)

    # -- main ------------------------------------------------------------------

    def __call__(self, img, ref_distance, mask,
                 reg_loss_weight: float = 1e-1,
                 normal_loss_weight: float = 1e-2,
                 normal_tv_loss_weight: float = 1e-2):
        """img [H, W, 3]; ref_distance [H, W(, 1)]; mask [H, W(, 1)] (1 =
        unknown, predicted freely; 0 = anchored to ref_distance). Returns
        (distance [H, W, 1], normal [H, W, 3]) on the predictor's device."""
        cfg, dev = self.cfg, self.device
        img = torch.as_tensor(img, dtype=torch.float32).to(dev)
        h, w = img.shape[0], img.shape[1]
        ref_distance = torch.as_tensor(ref_distance, dtype=torch.float32).to(
            dev).reshape(h, w, -1)[..., :1]
        mask = torch.as_tensor(mask).to(dev).reshape(h, w, -1)[..., :1].to(
            torch.float32)

        dirs, pers_ratios, c2w, views = self._make_views(img)
        n_views = views.shape[0]
        with phase_timer(self.writer, "joint_priors", n_items=n_views,
                         item_name="views"):
            pred_depth = self.depth.predict_depth(views, dirs=dirs)
            pred_depth = torch.clamp(pred_depth, min=0.0)
            pred_depth = pred_depth / (torch.mean(pred_depth, dim=(1, 2, 3),
                                                  keepdim=True) + 1e-5)
            pred_dist = (pred_depth * pers_ratios)[..., 0]
            pred_n = self.normal.predict_normal(views, dirs=dirs, c2w=c2w)
            pred_n = pred_n * 2.0 - 1.0
            pred_n = pred_n / torch.linalg.norm(pred_n, dim=-1, keepdim=True)
            pred_n = torch.einsum("vij,vhwj->vhwi", c2w, pred_n)
            float(pred_n[0, 0, 0].sum())

        params = {
            "scale": torch.zeros((n_views,), device=dev),
            "bias_ld": torch.zeros((n_views, cfg.gen_res, cfg.gen_res),
                                   device=dev),
            "bias_ln": torch.zeros((n_views, cfg.normal_bias_res,
                                    cfg.normal_bias_res, 3), device=dev),
            "sp": self.draws.sphere_init(cfg.field, dev),
        }
        # the views' fixed data in one image stack (one resample per step):
        # direction (3), prior distance (1), prior normal (3)
        data = {"views": torch.cat([dirs, pred_dist[..., None], pred_n],
                                   dim=-1).contiguous(),
                "ref": torch.cat([ref_distance, mask], dim=-1).contiguous()}
        wts = [float(np.float32(v)) for v in (reg_loss_weight,
                                              normal_loss_weight,
                                              normal_tv_loss_weight)]
        distill = _Distill(self, params, data, wts)
        losses = []
        n_iters = cfg.iters_per_phase
        for phase_i, hybrid in enumerate((False, True)):
            with phase_timer(self.writer, f"joint_distill_p{phase_i + 1}",
                             n_items=n_iters, item_name="iters"):
                for c in range(n_iters):
                    losses.append(distill.step(phase_i * n_iters + c, hybrid))
                float(losses[-1])
        self.last_losses = torch.stack(losses).cpu().numpy()

        with phase_timer(self.writer, "joint_readback", n_items=h * w,
                         item_name="px"):
            dist, normal = field_readback(params["sp"], cfg.field, h, w, dev,
                                          self.draws)
            float(dist[0, 0, 0])
        return dist, normal

class _Distill:
    """The distillation's parameters, Adam groups and one step."""

    def __init__(self, pred: PanoJointPredictor, params: dict, data: dict,
                 wts: list):
        self.pred, self.cfg = pred, pred.cfg
        self.params, self.data, self.wts = params, data, wts
        self.groups = {"global": [params["scale"]],
                       "sp": _sp_leaves(params["sp"]),
                       "local": [params["bias_ld"], params["bias_ln"]]}
        self.leaves = [t for g in self.groups.values() for t in g]
        for t in self.leaves:
            t.requires_grad_(True)
        self.adam = {k: GuardedAdam(v) for k, v in self.groups.items()}

    def loss(self, i: int, hybrid: bool, coords, ortho):
        cfg, p, data, wts = self.cfg, self.params, self.data, self.wts
        n_views, b = coords.shape[0], coords.shape[1]
        progress = float(np.float32(i) / np.float32(2.0 * cfg.iters_per_phase))
        cur = bilinear_sample(data["views"], coords, "border")
        cur_dirs = cur[..., :3]
        cur_dirs = cur_dirs / torch.linalg.norm(cur_dirs, dim=-1, keepdim=True)
        cur_dist, cur_norm = cur[..., 3], cur[..., 4:]
        d_bias = bilinear_sample(p["bias_ld"][..., None], coords,
                                 "border")[..., 0]
        n_bias = bilinear_sample(p["bias_ln"], coords, "border")

        ref_d = cur_dist * softplus(p["scale"])[:, None] + d_bias
        ref_nrm = cur_norm + n_bias
        ref_nrm = ref_nrm / torch.linalg.norm(ref_nrm, dim=-1, keepdim=True)

        flat_dirs = cur_dirs.reshape(-1, 3)
        pd, pg = sphere_field_distance_and_grad(p["sp"], flat_dirs, cfg.field)
        pd = pd.reshape(n_views, b)
        pg = pg.reshape(n_views, b, 3)

        distance_loss = smooth_l1(ref_d, pd, beta=0.5)
        errors = normal_projection_errors(cur_dirs, pg, ref_nrm, ortho)
        normal_loss = smooth_l1(errors, torch.zeros_like(errors), beta=0.5)
        reg_loss = (torch.mean(softplus(p["scale"])) - 1.0) ** 2
        if hybrid:
            ld, ln = p["bias_ld"], p["bias_ln"]
            tv_d = (smooth_l1(ld[:, 1:], ld[:, :-1], beta=1e-2)
                    + smooth_l1(ld[:, :, 1:], ld[:, :, :-1], beta=1e-2))
            tv_n = (smooth_l1(ln[:, 1:], ln[:, :-1], beta=1e-2)
                    + smooth_l1(ln[:, :, 1:], ln[:, :, :-1], beta=1e-2))
        else:
            tv_d = tv_n = 0.0
        ref = bilinear_sample(data["ref"], direction_to_img_coord(flat_dirs),
                              "border")
        ref_loss = torch.mean(smooth_l1_none(ref[:, 0], pd.reshape(-1),
                                             beta=1e-2) * (ref[:, 1] < 0.5))
        loss = (ref_loss * 20.0 * progress + distance_loss
                + reg_loss * wts[0] + normal_loss * wts[1] + tv_d * 1.0
                + tv_n * wts[2])
        return loss, (distance_loss, normal_loss)

    def grads(self, i: int, hybrid: bool, draws=None):
        """(loss, aux, gradients in ``self.leaves`` order) of step i."""
        cfg = self.cfg
        coords, ortho = (draws or self.pred.draws.step(
            len(self.params["scale"]), cfg.local_batch))
        loss, aux = self.loss(i, hybrid, coords, ortho)
        return loss, aux, torch.autograd.grad(loss, self.leaves)

    def step(self, i: int, hybrid: bool, draws=None) -> torch.Tensor:
        """One guarded step at global iteration i (with the step's
        ``draws`` (coords, ortho) when given); returns the loss."""
        cfg = self.cfg
        loss, _, grads = self.grads(i, hybrid, draws)
        progress = np.float32(i) / np.float32(2.0 * cfg.iters_per_phase)
        ratio = ((np.cos(progress * np.float32(math.pi)) + np.float32(1.0))
                 * np.float32(1.0 - cfg.lr_alpha) + np.float32(cfg.lr_alpha))
        lrs = {"global": cfg.init_lr, "sp": cfg.init_lr_sp,
               "local": cfg.init_lr_local}
        with torch.no_grad():
            finite = all_finite(grads)
            start = 0
            for name, leaves in self.groups.items():
                g = grads[start:start + len(leaves)]
                start += len(leaves)
                if name == "local" and not hybrid:
                    continue
                lr = float(np.float32(np.float32(lrs[name]) * ratio))
                self.adam[name].step(leaves, list(g), lr, finite)
        return loss.detach()
