"""Carry ``perf_tpu`` state into the port.

``NeRFScene.state_dict()`` of the JAX package holds its parameter tree as
NumPy arrays (``{"geo": {"table", "mlp": {"w": [...]}}, "app": ...}``,
weights ``[din, dout]``) and the occupancy grid as a flat uint8 array. A
table is the brick grid's [L, R, 64 * F] or the hash grid's [L, F, T]
(feature-major). A ``PropNeRFScene`` adds its proposal fields, a list of
hash-grid trees (``prop_params``; ``p{i}`` keys in its state dict). The
port keeps the same trees and layouts, so converting is a copy into
tensors on the chosen device, and back.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cpu"):
    """Nested dict / list / tuple of arrays -> same nesting of float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    # a copy: the caller's arrays may be read-only (views of JAX arrays)
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(device)


def field_params_from_jax(tree, field_cfg, device="cpu") -> dict:
    """An NGP field's ``{"geo", "app"}`` tree -> tensors on ``device``,
    refused unless each head's table has the shape of ``field_cfg``'s grid
    (a brick checkpoint does not load into a hash field, nor back)."""
    want = tuple(field_cfg.grid.table_shape)
    for head in ("geo", "app"):
        got = tuple(np.shape(tree[head]["table"]))
        if got != want:
            raise ValueError(f"{head} table {got} does not match the field's "
                             f"grid {type(field_cfg.grid).__name__} {want}")
    return params_from_jax(tree, device)


def prop_params_from_jax(tree, prop_cfgs, device="cpu") -> list:
    """The proposal fields of a ``PropNeRFScene``: JAX's list of
    ``{"table", "mlp": {"w": [...]}}`` trees, or a state dict's ``{"p0",
    "p1", ...}`` -> a list of the same trees as float32 tensors on
    ``device``, refused unless each table has its config's grid shape."""
    if isinstance(tree, dict):
        tree = [tree[f"p{i}"] for i in range(len(tree))]
    if len(tree) != len(prop_cfgs):
        raise ValueError(f"{len(tree)} proposal fields, expected "
                         f"{len(prop_cfgs)}")
    for i, (p, cfg) in enumerate(zip(tree, prop_cfgs)):
        got, want = tuple(np.shape(p["table"])), cfg.grid.table_shape
        if got != want:
            raise ValueError(f"proposal field {i}: table {got}, expected "
                             f"{want}")
    return [params_from_jax(p, device) for p in tree]


def occ_grid_from_jax(grid, device="cpu") -> torch.Tensor:
    """Flat [res^3] occupancy -> uint8 tensor on ``device``."""
    arr = np.array(grid, dtype=np.uint8).reshape(-1)
    return torch.from_numpy(arr).to(device)


def params_to_numpy(tree):
    """Inverse of ``params_from_jax``: tensors -> NumPy arrays."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def sphere_field_from_jax(tree, device="cpu") -> dict:
    """A ``perf_tpu`` sphere field (``{"table", "mlp"}``: a brick table [L,
    R, 128] or a hash table [L, 2, T], float32 as JAX keeps it; an MLP of
    ``{"w", "b"}`` or, weight-normed, ``{"v", "g", "b"}``, weights ``[din,
    dout]``) -> the same tree of float32 tensors."""
    mlp = {k: params_from_jax(list(v), device) for k, v in tree["mlp"].items()}
    if set(mlp) not in ({"w", "b"}, {"v", "g", "b"}):
        raise ValueError(f"sphere field MLP keys {sorted(mlp)}: expected w, b "
                         "or v, g, b")
    return {"table": params_from_jax(tree["table"], device), "mlp": mlp}
