"""NeRFScene, serving subset: the field, its occupancy grid and the baked
snapshot.

Counterpart of ``perf_tpu/train/scene.py`` (``__init__``, ``state_dict`` /
``load_state_dict``, ``bake_snapshot``, ``render_snapshot``). The state
dict has the JAX package's keys and layout, so a ``perf_tpu`` run
checkpoint loads here unchanged. ``fit`` comes with the training slice.
"""

from __future__ import annotations

import torch

from ..convert import occ_grid_from_jax, params_from_jax, params_to_numpy
from ..core import Rays
from ..fields import NGPFieldConfig, init_ngp_params
from ..render import RenderConfig
from ..render.snapshot import (SnapshotConfig, bake_snapshot,
                               render_snapshot_image)


class NeRFScene:
    """Owns field params, the occupancy grid and the bake, on one device."""

    def __init__(self, field_cfg: NGPFieldConfig, render_cfg: RenderConfig,
                 generator: torch.Generator, device: torch.device,
                 snap_cfg: SnapshotConfig | None = None):
        self.field_cfg = field_cfg
        self.render_cfg = render_cfg
        self.device = torch.device(device)
        self.params = init_ngp_params(generator, field_cfg, self.device)
        self.occ_grid = torch.zeros((render_cfg.occ_res ** 3,),
                                    dtype=torch.uint8, device=self.device)
        self.global_iter_geo = 0
        self.global_iter_app = 0
        self.sample_budget: int | None = None
        # baked table (render/snapshot.py); stale whenever the field changes
        self.snapshot: torch.Tensor | None = None
        self.snap_cfg = snap_cfg or SnapshotConfig()

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
        self.params = params_from_jax(state["params"], self.device)
        self.occ_grid = occ_grid_from_jax(state["occ_grid"], self.device)
        self.snapshot = None   # loaded field -> any existing bake is stale
        self.global_iter_geo = int(state["global_iter_geo"])
        self.global_iter_app = int(state["global_iter_app"])
        self.sample_budget = int(state.get("sample_budget", 0)) or None
