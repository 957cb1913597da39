"""The NGP radiance field on the brick grid or the hash grid.

Counterpart of ``perf_tpu/fields/ngp.py:39-200``: two independent heads,
each a grid encode into a bias-free MLP. ``geo`` is in -> 64 -> 1 with
``trunc_exp``; ``app`` is in -> 64 -> 64 -> 3 with a sigmoid. The AABB
[-1, 1]^3 maps to [0, 1]; outside it the density is selected to 0
(``where``, never ``inf * 0``) and the colour multiplied by 0. The grid is
a ``BrickGridConfig`` or a ``HashGridConfig`` (the default, the
reference-parity layout); each owns its table's init and its encodes
(``init_table``, ``encode_coords``, ``encode_coords_plain``,
``encode_ray``).

Every head query (``query_density_ray`` / ``query_rgb_ray`` on the training
path, ``query_density_coords`` / ``query_rgb_coords`` at points,
``query_density_field``) takes the grid's encode kernels and then the NGP
MLP kernels with their epilogue (``kernels/ngp_mlp.py``, K2 forward and
backward) on CUDA tensors, and the plain versions on CPU tensors: the
composition of ``ngp_mlp_apply_channels`` / ``ngp_mlp_apply`` with
``TruncExp``, the sigmoid and the select under autograd; ``plain=True``
sends the encode and the MLP to their plain versions on any device.

Serving evaluates both heads at points through ``field_eval``: for a brick
grid the fused CUDA kernel (``kernels/csrc/field_eval.cu``), for a hash
grid the ``hash_encode`` kernel of each head followed by its MLP kernel;
``field_eval_plain`` for CPU tensors.

The proposal estimator's density fields (``NGPDensityFieldConfig``,
``init_density_field``, ``query_density_field``;
``perf_tpu/fields/ngp.py:225-261``) are a small hash grid's point encode
(the ``hash_encode`` kernel on the card) into a float32 10 -> 64 -> 1 MLP
with ``trunc_exp(raw - 1)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import cuda, ngp_mlp
from ..kernels.brickgrid import BrickGridConfig, level_table
from ..kernels.hashgrid import HashGridConfig, hash_encode, init_hash_table
from .mlp import (APP_HEAD, GEO_HEAD, PROP_HEAD, ngp_mlp_apply,
                  ngp_mlp_apply_channels, ngp_mlp_init, trunc_exp)


@dataclasses.dataclass(frozen=True)
class NGPFieldConfig:
    aabb_min: float = -1.0
    aabb_max: float = 1.0
    grid: HashGridConfig | BrickGridConfig = HashGridConfig()
    n_neurons: int = 64
    geo_hidden: int = 1
    app_hidden: int = 2


def _init_head(generator: torch.Generator, cfg: NGPFieldConfig, dout: int,
               hidden: int, device) -> dict:
    """Uniform(-1e-4, 1e-4) table and a He-init MLP, as ``perf_tpu``."""
    return {"table": cfg.grid.init_table(generator, device),
            "mlp": ngp_mlp_init(generator, cfg.grid.out_dim, dout,
                                cfg.n_neurons, hidden, device)}


def init_geo_params(generator, cfg: NGPFieldConfig, device=None) -> dict:
    return _init_head(generator, cfg, 1, cfg.geo_hidden, device)


def init_app_params(generator, cfg: NGPFieldConfig, device=None) -> dict:
    return _init_head(generator, cfg, 3, cfg.app_hidden, device)


def init_ngp_params(generator: torch.Generator, cfg: NGPFieldConfig,
                    device=None) -> dict:
    return {"geo": init_geo_params(generator, cfg, device),
            "app": init_app_params(generator, cfg, device)}


def reset_geo(params: dict, generator: torch.Generator,
              cfg: NGPFieldConfig, device=None) -> dict:
    """A fresh geometry head, appearance untouched (``reset_geo``)."""
    return {**params, "geo": init_geo_params(generator, cfg, device)}


def normalize_coords(cfg: NGPFieldConfig, x, y, z):
    span = cfg.aabb_max - cfg.aabb_min
    nx = (x - cfg.aabb_min) / span
    ny = (y - cfg.aabb_min) / span
    nz = (z - cfg.aabb_min) / span
    sel = ((nx > 0.0) & (nx < 1.0) & (ny > 0.0) & (ny < 1.0)
           & (nz > 0.0) & (nz < 1.0))
    return nx, ny, nz, sel


def _encode_coords(cfg: NGPFieldConfig, plain: bool):
    return cfg.grid.encode_coords_plain if plain else cfg.grid.encode_coords


def _mlp_kernel(feats: torch.Tensor, plain: bool) -> bool:
    """Whether the head's MLP takes its kernel: CUDA features unless
    ``plain``; CPU features take the plain version, others raise."""
    if feats.is_cuda:
        return not plain
    if feats.device.type != "cpu":
        raise ValueError(f"NGP field: unsupported device {feats.device}")
    return False


def _head_kernel(params: dict, feats: torch.Tensor, sel: torch.Tensor,
                 head) -> tuple:
    """The head's activated channels through the K2 kernels, each shaped
    as ``sel``."""
    out = ngp_mlp.ngp_head(params["mlp"]["w"],
                           feats.reshape(-1, feats.shape[-1]),
                           sel.reshape(-1), head)
    return tuple(o.view(sel.shape) for o in out)


def _density(geo_params: dict, feats, sel, plain: bool = False):
    if _mlp_kernel(feats, plain):
        return _head_kernel(geo_params, feats, sel, GEO_HEAD)[0]
    (raw,) = ngp_mlp_apply_channels(geo_params["mlp"], feats)
    return torch.where(sel, trunc_exp(raw), torch.zeros_like(raw))


def _rgb(app_params: dict, feats, sel, plain: bool = False):
    if _mlp_kernel(feats, plain):
        return _head_kernel(app_params, feats, sel, APP_HEAD)
    r, g, b = ngp_mlp_apply_channels(app_params["mlp"], feats,
                                     out_activation=torch.sigmoid)
    s = sel.float()
    return r * s, g * s, b * s


def query_density_coords(geo_params: dict, x, y, z, cfg: NGPFieldConfig,
                         plain: bool = False) -> torch.Tensor:
    """Density at world coords given as three same-shape tensors
    (``plain``: through the grid's plain encode and the plain MLP)."""
    nx, ny, nz, sel = normalize_coords(cfg, x, y, z)
    feats = _encode_coords(cfg, plain)(geo_params["table"], nx, ny, nz)
    return _density(geo_params, feats, sel, plain)


def query_rgb_coords(app_params: dict, x, y, z, cfg: NGPFieldConfig,
                     plain: bool = False):
    """RGB at world coords -> tuple (r, g, b)."""
    nx, ny, nz, sel = normalize_coords(cfg, x, y, z)
    feats = _encode_coords(cfg, plain)(app_params["table"], nx, ny, nz)
    return _rgb(app_params, feats, sel, plain)


def query_density_ray(geo_params: dict, x, y, z, cfg: NGPFieldConfig,
                      strides: tuple,
                      run_caps: tuple | None = None) -> torch.Tensor:
    """Density at ray-structured world coords [N, S] with per-level strides,
    differentiable in the head's table and MLP. ``run_caps`` switches a
    brick grid's encode to the run-dedup form (samples t-ordered along S,
    as the march gives them); a hash grid ignores them, as in JAX."""
    nx, ny, nz, sel = normalize_coords(cfg, x, y, z)
    feats = cfg.grid.encode_ray(geo_params["table"], nx, ny, nz, strides,
                                run_caps)
    return _density(geo_params, feats, sel)


def query_rgb_ray(app_params: dict, x, y, z, cfg: NGPFieldConfig,
                  strides: tuple, run_caps: tuple | None = None):
    """RGB at ray-structured world coords [N, S] -> (r, g, b)."""
    nx, ny, nz, sel = normalize_coords(cfg, x, y, z)
    feats = cfg.grid.encode_ray(app_params["table"], nx, ny, nz, strides,
                                run_caps)
    return _rgb(app_params, feats, sel)


def _eval_heads(params: dict, xyz: torch.Tensor, cfg: NGPFieldConfig,
                plain: bool) -> torch.Tensor:
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    sig = query_density_coords(params["geo"], x, y, z, cfg, plain)
    r, g, b = query_rgb_coords(params["app"], x, y, z, cfg, plain)
    return torch.stack([sig, r, g, b], dim=-1)


def field_eval_plain(params: dict, xyz: torch.Tensor,
                     cfg: NGPFieldConfig) -> torch.Tensor:
    """xyz [N, 3] world coords -> [N, 4] float32 (sigma, r, g, b)."""
    return _eval_heads(params, xyz, cfg, plain=True)


_FIELD_EVAL = cuda.register(cuda.CudaKernel(
    "field_eval", "field_eval.cu", "field_eval_launch",
    [cuda.P, cuda.I64, cuda.P, cuda.P, cuda.P, cuda.P, cuda.I32, cuda.I32,
     cuda.F32, cuda.F32, cuda.P]))


def pack_field_weights(params: dict) -> torch.Tensor:
    """The kernel's float32 weight buffer: geo W0, geo W1, app W0, app W1,
    app W2, flattened row-major; the bf16 layers pre-rounded to bf16."""
    def bf(w):
        return w.to(torch.bfloat16).float().reshape(-1)
    gw, aw = params["geo"]["mlp"]["w"], params["app"]["mlp"]["w"]
    return torch.cat([bf(gw[0]), gw[1].float().reshape(-1), bf(aw[0]),
                      bf(aw[1]), aw[2].float().reshape(-1)]).contiguous()


def field_eval_cuda(params: dict, xyz: torch.Tensor,
                    cfg: NGPFieldConfig) -> torch.Tensor:
    g = cfg.grid
    if not g.fused_field:
        raise ValueError("field_eval kernel takes a brick grid; a hash grid "
                         "goes through field_eval")
    if (g.n_features != 2 or g.n_levels > 16 or cfg.n_neurons != 64
            or cfg.geo_hidden != 1 or cfg.app_hidden != 2):
        raise ValueError("field_eval kernel takes 2 features, <= 16 levels, "
                         "64 neurons, geo 1 / app 2 hidden layers; got "
                         f"{cfg}")
    dev = xyz.device
    cuda.check(xyz, "xyz", torch.float32, (None, 3))
    tables = []
    for head in ("geo", "app"):
        t = params[head]["table"]
        if t.device != dev or tuple(t.shape) != (g.n_levels, g.n_bricks, 128):
            raise ValueError(f"{head} table: {tuple(t.shape)} on {t.device}")
        tables.append(t.to(torch.bfloat16).contiguous())
    weights = pack_field_weights(params)
    if weights.device != dev:
        raise ValueError(f"MLP weights on {weights.device}, points on {dev}")
    levels = level_table(g, dev)
    out = torch.empty((xyz.shape[0], 4), dtype=torch.float32, device=dev)
    _FIELD_EVAL.launch(
        xyz.data_ptr(), xyz.shape[0], tables[0].data_ptr(),
        tables[1].data_ptr(), weights.data_ptr(), levels.data_ptr(),
        g.n_levels, g.n_bricks, float(cfg.aabb_min),
        float(cfg.aabb_max - cfg.aabb_min), out.data_ptr())
    return out


def field_eval(params: dict, xyz: torch.Tensor,
               cfg: NGPFieldConfig) -> torch.Tensor:
    """(sigma, r, g, b) [N, 4] at world points [N, 3]. CUDA tensors: the
    fused ``field_eval`` kernel (brick grid), or each head's ``hash_encode``
    kernel and its MLP kernel (hash grid); CPU tensors: the plain
    version."""
    if xyz.is_cuda:
        if cfg.grid.fused_field:
            return field_eval_cuda(params, xyz, cfg)
        return _eval_heads(params, xyz, cfg, plain=False)
    if xyz.device.type != "cpu":
        raise ValueError(f"field_eval: unsupported device {xyz.device}")
    return field_eval_plain(params, xyz, cfg)


# -- the proposal density field (the prop estimator's) ---------------------

@dataclasses.dataclass(frozen=True)
class NGPDensityFieldConfig:
    aabb_min: float = -1.0
    aabb_max: float = 1.0
    base_res: int = 16
    max_res: int = 128
    n_levels: int = 5
    log2_table_size: int = 17
    n_neurons: int = 64

    @property
    def grid(self) -> HashGridConfig:
        """The linear hash grid from ``base_res`` to ``max_res``, its growth
        solved in float64 as the JAX package does."""
        scale = float(np.exp((np.log(self.max_res) - np.log(self.base_res))
                             / (self.n_levels - 1)))
        return HashGridConfig(n_levels=self.n_levels, n_features=2,
                              log2_table_size=self.log2_table_size,
                              base_res=self.base_res, per_level_scale=scale)


def init_density_field(generator: torch.Generator,
                       cfg: NGPDensityFieldConfig, device=None) -> dict:
    """Uniform(-1e-4, 1e-4) table, He-init L*F -> 64 -> 1 MLP."""
    return {"table": init_hash_table(generator, cfg.grid, device),
            "mlp": ngp_mlp_init(generator, cfg.grid.out_dim, 1,
                                cfg.n_neurons, 1, device)}


def query_density_field(params: dict, x: torch.Tensor,
                        cfg: NGPDensityFieldConfig) -> torch.Tensor:
    """Proposal density at world positions x [..., 3] -> [..., 1]:
    ``trunc_exp(raw - 1)`` inside the open AABB, 0 outside. The encode is
    differentiable in the table only (the positions are detached)."""
    shape = x.shape[:-1]
    x01 = (x.reshape(-1, 3) - cfg.aabb_min) / (cfg.aabb_max - cfg.aabb_min)
    sel = ((x01 > 0.0) & (x01 < 1.0)).all(dim=-1)
    feats = hash_encode(params["table"], x01.detach(), cfg.grid)
    if _mlp_kernel(feats, False):
        density = _head_kernel(params, feats, sel, PROP_HEAD)[0]
    else:
        raw = ngp_mlp_apply(params["mlp"], feats)
        density = torch.where(sel[:, None], trunc_exp(raw - 1.0),
                              torch.zeros_like(raw))
    return density.reshape(*shape, 1)
