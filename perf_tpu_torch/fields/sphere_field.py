"""Sphere distance field: distance to the surface as a function of direction.

Counterpart of ``perf_tpu/fields/sphere_field.py:25-172`` on the joint
predictor's path: the brick encoding (smoothstep, ``BrickGridConfig.
sphere_field``) of direction * 0.49 + 0.49 feeds a sphere-initialised
VanillaMLP, and the distance's gradient with respect to the direction is
analytic (``grad_mode="analytic"``): the encode returns the features and
their derivatives in one pass (the ``brick_encode_grad`` kernels), and the
three directional derivatives of the MLP are propagated forward by hand,
t' = sigmoid(100 z) * (t W) per hidden layer (JAX's ``jax.jvp``), so an
outer loss on distance and gradient needs only first-order autograd. The
hash encoding, the ``fd`` / ``ad`` gradient modes and the refiner's raw
output head are not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.brickgrid import BrickGridConfig, brick_encode_stacked_grad
from .mlp import softplus, vanilla_mlp_init


@dataclasses.dataclass(frozen=True)
class SphereFieldConfig:
    n_levels: int = 16
    log2_table_size: int = 19
    base_res: int = 16
    fine_res: int = 2048
    n_neurons: int = 64
    n_hidden_layers: int = 2
    weight_norm: bool = False
    encoding: str = "brick"
    grad_mode: str = "analytic"

    def __post_init__(self):
        if self.encoding != "brick" or self.grad_mode != "analytic":
            raise ValueError(
                f"sphere field encoding={self.encoding!r} grad_mode="
                f"{self.grad_mode!r}: only brick + analytic is ported")
        if self.weight_norm:
            raise ValueError("sphere field weight_norm is not ported")

    @property
    def grid(self) -> BrickGridConfig:
        return BrickGridConfig.sphere_field(
            fine_res=self.fine_res, n_levels=self.n_levels,
            log2_bricks=self.log2_table_size - 6, base_res=self.base_res)


def init_sphere_field(generator: torch.Generator, cfg: SphereFieldConfig,
                      device=None) -> dict:
    """Uniform(-1e-4, 1e-4) brick table and a sphere-initialised MLP."""
    g = cfg.grid
    table = torch.rand((g.n_levels, g.n_bricks, g.n_features * 64),
                       generator=generator) * 2e-4 - 1e-4
    return {"table": table.to(device),
            "mlp": vanilla_mlp_init(generator, cfg.n_levels * 2 + 3, 1,
                                    cfg.n_neurons, cfg.n_hidden_layers,
                                    device=device)}


def _jvp_softplus(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """d softplus(x) / dx given out = softplus(x): exp(x - out), the form of
    JAX's logaddexp jvp."""
    return torch.exp(x - out)


def sphere_field_distance_and_grad(params: dict, dirs: torch.Tensor,
                                   cfg: SphereFieldConfig):
    """(distance [...], d distance / d direction [..., 3]) at unit
    directions [..., 3]."""
    shape = dirs.shape[:-1]
    d = dirs.reshape(-1, 3)
    feats, dfeats = brick_encode_stacked_grad(params["table"], d * 0.49 + 0.49,
                                              cfg.grid)
    ws, bs = params["mlp"]["w"], params["mlp"]["b"]
    h = torch.cat([d, feats], dim=-1)
    # the three tangents: e_a on the raw direction, 0.49 * dfeats[:, a] on
    # the features (d scaled / d direction = 0.49)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    t = torch.cat([eye[:, None, :].expand(3, d.shape[0], 3),
                   dfeats.permute(1, 0, 2) * 0.49], dim=-1)      # [3, N, in]
    for w, b in zip(ws[:-1], bs[:-1]):
        z = 100.0 * (h @ w + b)
        sp = softplus(z)
        t = (_jvp_softplus(z, sp) * (100.0 * (t @ w))) / 100.0
        h = sp / 100.0
    # the joint predictor's head: softplus(out + 1) of the negated output
    out = -(h @ ws[-1] + bs[-1])[..., 0] + 1.0
    dist = softplus(out)
    t_out = -(t @ ws[-1])[..., 0] * _jvp_softplus(out, dist)      # [3, N]
    return dist.reshape(shape), t_out.t().reshape(*shape, 3)


def grads_to_normal(dirs: torch.Tensor, grads: torch.Tensor,
                    ortho_a: torch.Tensor) -> torch.Tensor:
    """Surface normals from the distance field's direction gradients: a
    tangent basis around each direction from the standard-normal draw
    ``ortho_a`` (shape of ``dirs``), each basis vector tilted by the
    directional derivative, their cross product, flipped to face inward."""
    ortho_b = torch.linalg.cross(dirs, ortho_a)
    ortho_b = ortho_b / torch.linalg.norm(ortho_b, dim=-1, keepdim=True)
    ortho_a = torch.linalg.cross(ortho_b, dirs)
    ortho_a = ortho_a / torch.linalg.norm(ortho_a, dim=-1, keepdim=True)
    val_a = torch.sum(grads * ortho_a, -1, keepdim=True) * dirs + ortho_a
    val_a = val_a / torch.linalg.norm(val_a, dim=-1, keepdim=True)
    val_b = torch.sum(grads * ortho_b, -1, keepdim=True) * dirs + ortho_b
    val_b = val_b / torch.linalg.norm(val_b, dim=-1, keepdim=True)
    normals = torch.linalg.cross(val_a, val_b)
    normals = normals / torch.linalg.norm(normals, dim=-1, keepdim=True)
    inside = torch.sum(normals * dirs, -1, keepdim=True) < 0.0
    return torch.where(inside, normals, -normals)
