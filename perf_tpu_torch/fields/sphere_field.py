"""Sphere distance field: distance to the surface as a function of direction.

Counterpart of ``perf_tpu/fields/sphere_field.py:25-172``: an encoding of
direction * 0.49 + 0.49 feeds a sphere-initialised VanillaMLP (optionally
weight-normed); the ``joint`` head returns softplus(out + 1), the ``raw``
head the output itself. Two encodings:

- ``hash`` (the reference's tcnn Smoothstep HashGrid, JAX's default):
  ``HashGridConfig.sphere_field``, through the ``hash_encode`` kernels;
- ``brick``: ``BrickGridConfig.sphere_field``, through the
  ``brick_encode_grad`` kernels.

and three modes for the distance's gradient with respect to the direction:

- ``ad`` (hash only, JAX's default): JAX takes ``jax.vjp`` of the distance,
  which an outer training loss differentiates again (second order). The
  port computes the same gradient forward: ``hash_encode_grad`` returns the
  features and their derivatives in one pass, and the three directional
  derivatives of the MLP are propagated by hand (``_head_with_jvp``). This
  is forward mode for JAX's reverse mode: the same function, with float
  sums in another order; an outer loss then needs only first-order
  autograd (the table gradient of features and derivatives, the MLP's
  through the jvp), no double backward;
- ``analytic`` (brick only): the same forward propagation on the brick
  encode's derivatives;
- ``fd``: central differences with eps = 1 / ``fine_res``: the distance at
  the direction and at the six displaced ones, all seven in one encode
  (``HashEncode`` on the hash grid, the brick encode's features on the
  brick grid), first order under an outer loss.

JAX asserts against analytic on the hash grid; ad on the brick grid would
need a second-order brick encode, which neither package has. Both are
refused when the config is made.
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.brickgrid import BrickGridConfig, brick_encode_stacked_grad
from ..kernels.hashgrid import (HashGridConfig, hash_encode, hash_encode_grad,
                                init_hash_table)
from .mlp import softplus, vanilla_mlp_apply, vanilla_mlp_init, vanilla_weights

ENCODINGS = ("hash", "brick")
GRAD_MODES = ("ad", "fd", "analytic")
OUTPUTS = ("joint", "raw")


@dataclasses.dataclass(frozen=True)
class SphereFieldConfig:
    n_levels: int = 16
    log2_table_size: int = 19
    base_res: int = 16
    fine_res: int = 2048
    n_neurons: int = 64
    n_hidden_layers: int = 2
    weight_norm: bool = False
    # 'joint': softplus(out + 1) (the joint predictor); 'raw': the output
    # itself (the geometry refiner)
    output: str = "joint"
    encoding: str = "hash"
    grad_mode: str = "ad"

    def __post_init__(self):
        for name, value, allowed in (("encoding", self.encoding, ENCODINGS),
                                     ("grad_mode", self.grad_mode, GRAD_MODES),
                                     ("output", self.output, OUTPUTS)):
            if value not in allowed:
                raise ValueError(f"sphere field {name}={value!r}: one of "
                                 f"{allowed}")
        if self.grad_mode == "analytic" and self.encoding != "brick":
            raise ValueError("sphere field grad_mode='analytic' needs "
                             "encoding='brick' (as JAX asserts)")
        if self.grad_mode == "ad" and self.encoding != "hash":
            raise ValueError("sphere field grad_mode='ad' needs "
                             "encoding='hash': the brick encode is "
                             "differentiable once (use fd or analytic)")

    @property
    def grid(self):
        if self.encoding == "brick":
            return BrickGridConfig.sphere_field(
                fine_res=self.fine_res, n_levels=self.n_levels,
                log2_bricks=self.log2_table_size - 6, base_res=self.base_res)
        return HashGridConfig.sphere_field(
            fine_res=self.fine_res, n_levels=self.n_levels,
            log2_table_size=self.log2_table_size, base_res=self.base_res)


def init_sphere_field(generator: torch.Generator, cfg: SphereFieldConfig,
                      device=None) -> dict:
    """Uniform(-1e-4, 1e-4) table (brick [L, rows, 128] or hash [L, 2, T])
    and a sphere-initialised MLP."""
    g = cfg.grid
    if cfg.encoding == "brick":
        table = (torch.rand((g.n_levels, g.n_bricks, g.n_features * 64),
                            generator=generator) * 2e-4 - 1e-4).to(device)
    else:
        table = init_hash_table(generator, g, device)
    return {"table": table,
            "mlp": vanilla_mlp_init(generator, cfg.n_levels * 2 + 3, 1,
                                    cfg.n_neurons, cfg.n_hidden_layers,
                                    weight_norm=cfg.weight_norm,
                                    device=device)}


def sphere_field_distance(params: dict, dirs: torch.Tensor,
                          cfg: SphereFieldConfig) -> torch.Tensor:
    """Distance at unit directions [..., 3] -> [...]."""
    shape = dirs.shape[:-1]
    d = dirs.reshape(-1, 3)
    if cfg.encoding == "brick":
        feats = brick_encode_stacked_grad(params["table"], d * 0.49 + 0.49,
                                          cfg.grid)[0]
    else:
        feats = hash_encode(params["table"], d * 0.49 + 0.49, cfg.grid)
    out = vanilla_mlp_apply(params["mlp"], torch.cat([d, feats], -1))[..., 0]
    if cfg.output == "joint":
        out = softplus(out + 1.0)
    return out.reshape(shape)


def _jvp_softplus(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """d softplus(x) / dx given out = softplus(x): exp(x - out), the form of
    JAX's logaddexp jvp."""
    return torch.exp(x - out)


def _head_with_jvp(mlp: dict, d: torch.Tensor, feats: torch.Tensor,
                   dfeats: torch.Tensor, cfg: SphereFieldConfig):
    """(distance [N], its derivative along each axis [3, N]) of the MLP head
    at input (d, feats): the tangent of axis a is e_a on the raw direction
    and 0.49 * dfeats[:, a] on the features (d scaled / d direction =
    0.49), carried through each hidden layer as t' = softplus'(100 z) *
    (t W) (JAX's ``jax.jvp``)."""
    ws, bs = vanilla_weights(mlp)
    h = torch.cat([d, feats], dim=-1)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    t = torch.cat([eye[:, None, :].expand(3, d.shape[0], 3),
                   dfeats.permute(1, 0, 2) * 0.49], dim=-1)      # [3, N, in]
    for w, b in zip(ws[:-1], bs[:-1]):
        z = 100.0 * (h @ w + b)
        sp = softplus(z)
        t = (_jvp_softplus(z, sp) * (100.0 * (t @ w))) / 100.0
        h = sp / 100.0
    # the VanillaMLP's output is negated
    out = -(h @ ws[-1] + bs[-1])[..., 0]
    t_out = -(t @ ws[-1])[..., 0]                                # [3, N]
    if cfg.output == "joint":
        out = out + 1.0
        dist = softplus(out)
        return dist, t_out * _jvp_softplus(out, dist)
    return out, t_out


def sphere_field_distance_and_grad(params: dict, dirs: torch.Tensor,
                                   cfg: SphereFieldConfig):
    """(distance [...], d distance / d direction [..., 3]) at unit
    directions [..., 3]."""
    shape = dirs.shape[:-1]
    if cfg.grad_mode == "fd":
        eps = 1.0 / cfg.fine_res
        d = dirs.reshape(-1, 3)
        e = torch.zeros((3, 3), dtype=d.dtype, device=d.device)
        e[range(3), range(3)] = eps
        # the direction and, per axis, +eps and -eps: one encode of 7 N
        shifted = torch.stack([d] + [d + s * e[a] for a in range(3)
                                     for s in (1.0, -1.0)])
        dist = sphere_field_distance(params, shifted, cfg)
        gs = [(dist[1 + 2 * a] - dist[2 + 2 * a]) / (2.0 * eps)
              for a in range(3)]
        return dist[0].reshape(shape), torch.stack(gs, -1).reshape(*shape, 3)
    d = dirs.reshape(-1, 3)
    if cfg.grad_mode == "analytic":
        feats, dfeats = brick_encode_stacked_grad(params["table"],
                                                  d * 0.49 + 0.49, cfg.grid)
    else:
        feats, dfeats = hash_encode_grad(params["table"], d * 0.49 + 0.49,
                                         cfg.grid)
    dist, t_out = _head_with_jvp(params["mlp"], d, feats, dfeats, cfg)
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
