"""The raw-fit half of ``mode=train``.

Counterpart of ``perf_tpu/app/runner.py:84-125`` (``_train_config``) and of
``CoreRunner.__init__`` plus ``train()`` up to the first checkpoint
(``runner.py:128-285, 328-343, 514-520``): load the pano and its cached
geometry, register it in the supervision pool, run ``scene.fit(pool)``,
render the input pose through the baked snapshot, and write ``1.png``,
``1_distance.png``, ``distance_vis.png``, ``normal_vis.png``,
``ts_log/metrics.jsonl`` and ``checkpoints/ckpt.npz`` (``scene``,
``sup_pool``, ``phase``, in the JAX runner's layout, so the JAX runner
resumes from it). The anchor cycle is not ported: a config with anchors is
refused.
"""

from __future__ import annotations

import os
import warnings
from os.path import join as pjoin

import numpy as np
import torch

from ..core import gen_pano_rays
from ..data import WildDataset
from ..train import (NeRFScene, OptimConfig, SupInfoPool, TrainConfig,
                     load_checkpoint, save_checkpoint)
from ..utils.io import colorize_single_channel_image, write_image
from ..utils.metrics import MetricsWriter


def train_config(tc) -> TrainConfig:
    """TrainConfig from ``scene.train_conf`` with the JAX runner's keys and
    defaults; keys of unported paths that are switched on raise."""
    parity_only = {"vis_video_freq": 25000, "ignore_near": True,
                   "cross_depth_check": True}
    for key, default in parity_only.items():
        if key in tc and tc[key] != default:
            warnings.warn(f"config key '{key}'={tc[key]!r} has no effect "
                          "(the reference declares it and never reads it)",
                          stacklevel=2)
    if tc.get("dedup_runs", False):
        raise ValueError("train_conf.dedup_runs is not ported")

    def optim(oc):
        return OptimConfig(init_lr=oc["init_lr"], peak_lr=oc["peak_lr"],
                           peak_at=oc["peak_at"], lr_alpha=oc["lr_alpha"])
    return TrainConfig(
        raw_phase_iter_geo=tc["raw_phase_iter_geo"],
        raw_phase_iter_app=tc["raw_phase_iter_app"],
        pixel_loss_batch_size=tc["pixel_loss_batch_size"],
        color_loss_weight=tc.get("color_loss_weight", 1.0),
        depth_loss_weight=tc.get("depth_loss_weight", 1.0),
        distortion_loss_weight=tc.get("distortion_loss_weight", 0.1),
        density_loss_weight=tc.get("density_loss_weight", 0.0),
        geo_optimizer=optim(tc["geo_optimizer"]),
        app_optimizer=optim(tc["app_optimizer"]),
        bucket_train=tc.get("bucket_train", True),
        app_sample_stride=tc.get("app_sample_stride", 2),
        geo_sample_stride=tc.get("geo_sample_stride", 1),
        occ_field_prune=tc.get("occ_field_prune", False),
        vis_freq=tc.get("vis_freq", 0),
    )


class TrainRunner:
    """Dataset, scene and pool of a ``mode=train`` run on one device."""

    def __init__(self, conf, device: torch.device):
        from ..__main__ import exp_dir_of, scene_configs
        self.conf = conf
        self.device = torch.device(device)
        n_anchors = sum(int(n) for n in
                        conf["pose_sampler"]["n_anchors_per_ratio"])
        if n_anchors:
            raise ValueError(
                f"{n_anchors} anchors: the anchor cycle is not ported; run "
                "the raw fit with pose_sampler.n_anchors_per_ratio=[0,0,0]")
        self.dataset = WildDataset(conf["dataset"])
        self.exp_dir = exp_dir_of(conf)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.writer = MetricsWriter(pjoin(self.exp_dir, "ts_log"))
        field_cfg, render_cfg, snap_cfg = scene_configs(conf)
        gen = torch.Generator().manual_seed(int(conf.get("seed", 0)))
        self.scene = NeRFScene(field_cfg, render_cfg, gen, self.device,
                               snap_cfg,
                               train_config(conf["scene"]["train_conf"]),
                               self.writer)
        ref_d = self.dataset.ref_distance
        write_image(pjoin(self.exp_dir, "distance_vis.png"),
                    colorize_single_channel_image(
                        (float(np.min(ref_d)) + 1e-6) / (ref_d + 1e-6)))
        write_image(pjoin(self.exp_dir, "normal_vis.png"),
                    self.dataset.ref_normal * 0.5 + 0.5)
        self.sup_pool = SupInfoPool()
        self.sup_pool.register_sup_info(
            pose=np.eye(4, dtype=np.float32),
            mask=np.ones((self.dataset.height, self.dataset.width)),
            rgb=self.dataset.image, distance=self.dataset.ref_distance,
            normal=self.dataset.ref_normal)
        self.phase = -1
        self.losses = None
        ckpt = pjoin(self.exp_dir, "checkpoints", "ckpt.npz")
        if conf.get("is_continue", False) and os.path.exists(ckpt):
            state = load_checkpoint(ckpt)
            self.scene.load_state_dict(state["scene"])
            self.phase = int(state["phase"])
            pool = SupInfoPool()
            pool.load_state_dict(state["sup_pool"])
            self.sup_pool = pool

    def train(self):
        """The raw fit and its artefacts, unless a resumed run has them."""
        try:
            if self.phase >= 0:
                return
            self.losses = self.scene.fit(self.sup_pool)
            rays = gen_pano_rays(torch.eye(4, device=self.device), 512, 1024)
            out = self.scene.render_snapshot(rays,
                                             query_keys=("rgb", "distance"))
            write_image(pjoin(self.exp_dir, "1.png"),
                        out["rgb"].cpu().numpy())
            dist = out["distance"].cpu().numpy()
            write_image(pjoin(self.exp_dir, "1_distance.png"),
                        colorize_single_channel_image(
                            (float(dist.min()) / dist).squeeze()))
            self.phase += 1
            self.save_checkpoint()
        finally:
            self.writer.close()

    def save_checkpoint(self):
        save_checkpoint(pjoin(self.exp_dir, "checkpoints", "ckpt.npz"), {
            "scene": self.scene.state_dict(),
            "sup_pool": self.sup_pool.state_dict(),
            "phase": self.phase,
        })
