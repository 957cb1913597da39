"""``mode=train`` and ``mode=render_dense``: the progressive pipeline.

Counterpart of ``perf_tpu/app/runner.py`` (``build_prior_backends``,
``build_inpainter``, ``_train_config``, ``CoreRunner``) on the hermetic
backends: the cube-room fake priors and the fake fill inpainter (or
``stable_diffusion`` falling back to it, as the JAX runner does without
checkpoints). One run:

1. the dataset: the pano and its geometry, bootstrapped by the joint
   predictor when no cache sits beside the image;
2. the raw fit of the input pano, its render through the snapshot
   (``1.png``, ``1_distance.png``), a checkpoint (phase 0);
3. every anchor of the ``CirclePoseSampler``: render the anchor pano
   through the snapshot, the visibility mask against the pool, inpaint the
   hidden part (20-view fusion), predict its geometry (joint predictor),
   geo-check it against the pool, register the result, re-fit; a
   checkpoint after each (phase = anchors done), with the artefacts under
   ``inpaint_vis/NNNN/`` and the phase timers in ``ts_log``;
4. ``render_dense``: the dense traverse through the anchors, baked once
   and rendered through the snapshot, frames as PNGs and, where ``imageio``
   or ``cv2`` can write one, ``video.mp4``.

With ``scene.estimator_type=prop`` the scene is a ``PropNeRFScene``: the
same steps, its renders through the proposal cascade (it has no
snapshot to bake), as JAX's runner does.

Checkpoints hold ``scene``, ``sup_pool`` and ``phase`` in the JAX runner's
layout, so either package resumes the other's run at any phase
(``is_continue=true``). Images are PNG (the port has no JPEG encoder: the
JAX runner's ``*.jpg`` artefacts are ``*.png`` here). Not ported:
``PERF_TPU_DEADLINE_TS``, the ``record/`` copies, the ``dpt`` prior and the
diffusion / LaMa inpainters.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from os.path import join as pjoin

import numpy as np
import torch

from ..core import gen_pano_rays, gen_pers_rays
from ..data import WildDataset
from ..inpaint import FakeInpainter, PanoPersFusionInpainter
from ..pose import CirclePoseSampler, DenseTravelPoseSampler
from ..priors import (FakeCubeRoomDepthPredictor, FakeCubeRoomNormalPredictor,
                      JointPredictorConfig, PanoJointPredictor)
from ..train import (OptimConfig, SupInfoPool, TrainConfig, load_checkpoint,
                     save_checkpoint)
from ..train.scene import pano_visibility_from_distance
from ..utils.io import colorize_single_channel_image, write_image, write_video
from ..utils.metrics import MetricsWriter, phase_timer


def train_config(tc) -> TrainConfig:
    """TrainConfig from ``scene.train_conf`` with the JAX runner's keys and
    defaults; ``scan_chunk`` other than 1 (JAX's k steps per dispatch, not
    ported) raises. ``dedup_runs`` probes run caps for a brick field's
    training steps; on a hash field it gives no caps and the proposal
    estimator reads none, as in JAX (neither raises)."""
    parity_only = {"vis_video_freq": 25000, "ignore_near": True,
                   "cross_depth_check": True}
    for key, default in parity_only.items():
        if key in tc and tc[key] != default:
            warnings.warn(f"config key '{key}'={tc[key]!r} has no effect "
                          "(the reference declares it and never reads it)",
                          stacklevel=2)
    if tc.get("scan_chunk", 1) != 1:
        raise ValueError(f"train_conf.scan_chunk={tc['scan_chunk']!r}: only 1 "
                         "is ported (the port runs one step per dispatch)")

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
        **({"prop_optimizer": optim(tc["prop_optimizer"])}
           if "prop_optimizer" in tc else {}),
        bucket_train=tc.get("bucket_train", True),
        app_sample_stride=tc.get("app_sample_stride", 2),
        geo_sample_stride=tc.get("geo_sample_stride", 1),
        dedup_runs=tc.get("dedup_runs", False),
        occ_field_prune=tc.get("occ_field_prune", False),
        vis_freq=tc.get("vis_freq", 0),
    )


def joint_config(conf) -> JointPredictorConfig:
    """The joint predictor's config from ``priors.joint``, as the JAX
    runner's ``_joint_cfg``: ``priors.joint.field.*`` replace keys of the
    joint default field (brick + analytic), so ``encoding=hash`` alone is
    hash + analytic, which is refused; ``encoding=hash grad_mode=ad`` is
    the published PeRF's field. ``scan_chunk`` is read and has no effect
    (the port steps one at a time) but must divide ``iters_per_phase``."""
    over = conf.get_path("priors.joint", {}) or {}
    kw = {k: over[k] for k in
          ("gen_res", "local_batch", "iters_per_phase", "scan_chunk")
          if k in over}
    if "ratios" in over:
        kw["ratios"] = tuple(over["ratios"])
    cfg = JointPredictorConfig(**kw)
    fld = over.get("field", {}) or {}
    fkw = {k: fld[k] for k in ("n_levels", "log2_table_size", "fine_res",
                               "encoding", "grad_mode") if k in fld}
    if fkw:
        cfg = dataclasses.replace(cfg, field=dataclasses.replace(cfg.field,
                                                                 **fkw))
    return cfg


def build_prior_backends(conf):
    backend = conf.get_path("priors.backend", "fake")
    if backend != "fake":
        raise ValueError(f"priors.backend={backend!r}: only the fake priors "
                         "are ported")
    room = conf.get_path("priors.fake_room", 0.8)
    return (FakeCubeRoomDepthPredictor(room=room),
            FakeCubeRoomNormalPredictor(room=room))


def build_inpainter(conf):
    kind = conf.get_path("pers_inpainter_type", "stable_diffusion")
    gen_res = conf.get_path("inpaint.gen_res", 512)
    if kind == "fake":
        return PanoPersFusionInpainter(FakeInpainter(), gen_res=gen_res)
    if kind == "stable_diffusion":
        if not conf.get_path("inpaint.allow_fake_fallback", True):
            raise ValueError("the stable_diffusion inpainter is not ported "
                             "and inpaint.allow_fake_fallback is false")
        print(f"[perf_tpu_torch] inpainter '{kind}' unavailable (not "
              "ported); falling back to the fake fill backend", flush=True)
        return PanoPersFusionInpainter(FakeInpainter(), gen_res=gen_res)
    raise ValueError(f"unknown pers_inpainter_type {kind!r}")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class CoreRunner:
    """Dataset, scene, pose sampler, pool, predictor and inpainter of a
    ``mode=train`` or ``mode=render_dense`` run on one device."""

    def __init__(self, conf, device: torch.device):
        from ..__main__ import exp_dir_of, make_scene
        self.conf = conf
        self.device = torch.device(device)
        seed = int(conf.get("seed", 0))
        tcfg = train_config(conf["scene"]["train_conf"])
        depth, normal = build_prior_backends(conf)
        self.geo_predictor = PanoJointPredictor(depth, normal,
                                                joint_config(conf), seed=seed,
                                                device=self.device)
        t0 = time.perf_counter()
        self.dataset = WildDataset(conf["dataset"], self.geo_predictor)
        # the image read and, without a cache, the geometry bootstrap
        self.dataset_s = time.perf_counter() - t0
        self.exp_dir = exp_dir_of(conf)
        os.makedirs(self.exp_dir, exist_ok=True)
        self.writer = MetricsWriter(pjoin(self.exp_dir, "ts_log"))
        self.geo_predictor.writer = self.writer
        gen = torch.Generator().manual_seed(seed)
        self.scene = make_scene(conf, gen, self.device, tcfg, self.writer)
        self.scene.vis_dir = pjoin(self.exp_dir, "fit_vis")
        ref_d = self.dataset.ref_distance
        write_image(pjoin(self.exp_dir, "distance_vis.png"),
                    colorize_single_channel_image(
                        (float(np.min(ref_d)) + 1e-6) / (ref_d + 1e-6)))
        write_image(pjoin(self.exp_dir, "normal_vis.png"),
                    self.dataset.ref_normal * 0.5 + 0.5)
        ps = conf["pose_sampler"]
        self.pose_sampler = CirclePoseSampler(
            ref_d, traverse_ratios=tuple(ps["traverse_ratios"]),
            n_anchors_per_ratio=tuple(ps["n_anchors_per_ratio"]))
        self.sup_pool = SupInfoPool()
        self.sup_pool.register_sup_info(
            pose=np.eye(4, dtype=np.float32),
            mask=np.ones((self.dataset.height, self.dataset.width)),
            rgb=self.dataset.image, distance=self.dataset.ref_distance,
            normal=self.dataset.ref_normal)
        self.inpainter = build_inpainter(conf)
        self.phase = -1
        self.losses = None
        self.frame_ms: list = []
        ckpt = pjoin(self.exp_dir, "checkpoints", "ckpt.npz")
        if conf.get("is_continue", False):
            if os.path.exists(ckpt):
                state = load_checkpoint(ckpt)
                self.scene.load_state_dict(state["scene"])
                self.phase = int(state["phase"])
                pool = SupInfoPool()
                pool.load_state_dict(state["sup_pool"])
                self.sup_pool = pool
            else:
                print(f"[perf_tpu_torch] is_continue=true but no checkpoint "
                      f"at {ckpt}; starting fresh", flush=True)

    def execute(self, mode: str):
        try:
            if mode == "train":
                self.train()
            elif mode == "render_dense":
                self.frame_ms = self.render_dense()
            else:
                raise ValueError(f"unknown mode {mode!r}")
        finally:
            self.writer.close()

    # -- training ------------------------------------------------------------

    def train(self):
        """The raw fit, then every anchor not yet done."""
        h, w = self.dataset.height, self.dataset.width
        if self.phase < 0:
            self.losses = self.scene.fit(self.sup_pool)
            out = self.scene.render_snapshot(
                gen_pano_rays(torch.eye(4, device=self.device), 512, 1024),
                query_keys=("rgb", "distance"))
            write_image(pjoin(self.exp_dir, "1.png"), _np(out["rgb"]))
            dist = _np(out["distance"])
            write_image(pjoin(self.exp_dir, "1_distance.png"),
                        colorize_single_channel_image(
                            (float(dist.min()) / dist).squeeze()))
            self.phase += 1
            self.save_checkpoint()
        for anchor_idx in range(self.pose_sampler.n_anchors):
            if anchor_idx < self.phase:
                continue
            t0 = time.perf_counter()
            self.run_anchor(anchor_idx, h, w)
            self.phase += 1
            self.save_checkpoint()
            dt = time.perf_counter() - t0
            self.writer.add_scalar("time/anchor_total_sec", dt, anchor_idx)
            self.writer.flush()
            print(f"[perf_tpu_torch] anchor {anchor_idx}: {dt:.1f} s",
                  flush=True)

    def anchor_views(self, anchor_idx: int, h: int, w: int):
        """(pose, rays, rendered rgb and distance, visibility mask) of an
        anchor: the render through the snapshot and the mask share it."""
        pose = torch.from_numpy(self.pose_sampler.sample_pose(anchor_idx)).to(
            self.device)
        rays = gen_pano_rays(pose, h, w)
        with phase_timer(self.writer, "anchor_render", anchor_idx):
            out = self.scene.render_snapshot(rays,
                                             query_keys=("rgb", "distance"))
            float(out["distance"].max())
        with phase_timer(self.writer, "anchor_visibility", anchor_idx):
            visi = pano_visibility_from_distance(self.sup_pool, rays,
                                                 out["distance"])
            float(visi.min())
        return pose, rays, out["rgb"], out["distance"], visi

    def register_anchor(self, anchor_idx: int, rays, colors, distances,
                        visi, h: int, w: int):
        """Inpaint, geometry and geo-check where the anchor sees new content,
        then the mask algebra: -> (colors, distances [H, W, 1], normals or
        None, sup_mask [H, W])."""
        inpaint_mask = 1.0 - visi
        normals = None
        if float(visi.min()) <= 0.5:
            colors, distances, normals = self.inpaint_new_panorama(
                0, anchor_idx, colors, distances, inpaint_mask)
            with phase_timer(self.writer, "anchor_geo_check", anchor_idx):
                conflict = 1.0 - self.sup_pool.geo_check(rays, distances)
                inpaint_mask = inpaint_mask * conflict
                float(inpaint_mask.min())
        distances = distances.reshape(h, w, 1)
        # never supervise content that came out too close
        inpaint_mask = torch.maximum(
            inpaint_mask, (distances[..., 0] < 0.1).to(torch.float32))
        inpaint_mask = torch.minimum(inpaint_mask, 1.0 - visi)
        vis_dir = pjoin(self.exp_dir, "inpaint_vis", f"{anchor_idx:04d}")
        write_image(pjoin(vis_dir, "final_mask.png"), _np(inpaint_mask))
        write_image(pjoin(vis_dir, "final_masked.png"),
                    _np(colors * (1.0 - inpaint_mask)[..., None]))
        sup_mask = 1.0 - visi
        sup_mask = sup_mask - torch.minimum(sup_mask, inpaint_mask)
        return colors, distances, normals, sup_mask

    def run_anchor(self, anchor_idx: int, h: int, w: int):
        pose, rays, colors, distances, visi = self.anchor_views(anchor_idx,
                                                                h, w)
        colors, distances, normals, sup_mask = self.register_anchor(
            anchor_idx, rays, colors, distances, visi, h, w)
        self.sup_pool.register_sup_info(
            pose=_np(pose), mask=_np(sup_mask), rgb=_np(colors),
            distance=_np(distances),
            normal=_np(normals) if normals is not None else None)
        with phase_timer(self.writer, "anchor_refit", anchor_idx):
            self.scene.fit(self.sup_pool)

    def inpaint_new_panorama(self, sub_i: int, anchor_idx: int, colors,
                             distances, mask):
        h, w = colors.shape[0], colors.shape[1]
        distances = distances.reshape(h, w, 1)
        mask = mask.reshape(h, w)
        vis_dir = pjoin(self.exp_dir, "inpaint_vis", f"{anchor_idx:04d}")
        write_image(pjoin(vis_dir, f"uninpainted_{sub_i}.png"), _np(colors))
        write_image(pjoin(vis_dir, f"mask_{sub_i}.png"), _np(mask))
        write_image(pjoin(vis_dir, f"masked_{sub_i}.png"),
                    _np(colors * (1.0 - mask)[..., None]))
        if self.conf.get("rgbd_inpaint", False):
            inpainted, new_dist = self.inpainter.inpaint_rgbd(colors,
                                                              distances, mask)
            write_image(pjoin(vis_dir, f"inpainted_{sub_i}.png"),
                        _np(inpainted))
            return inpainted, new_dist, None
        with phase_timer(self.writer, "anchor_inpaint", anchor_idx):
            inpainted = self.inpainter.inpaint(colors, mask)
            float(inpainted[0, 0, 0])
        write_image(pjoin(vis_dir, f"inpainted_{sub_i}.png"), _np(inpainted))
        with phase_timer(self.writer, "anchor_geometry", anchor_idx):
            new_dist, new_normal = self.geo_predictor(
                inpainted, distances, mask, reg_loss_weight=0.0,
                normal_loss_weight=5e-2, normal_tv_loss_weight=5e-2)
        write_image(pjoin(vis_dir, f"aligned_disparity_{sub_i}.png"),
                    colorize_single_channel_image(
                        float(new_dist.min()) / _np(new_dist)))
        write_image(pjoin(vis_dir, f"aligned_normals_{sub_i}.png"),
                    np.clip(_np(new_normal) * 0.5 + 0.5, 0, 1))
        return inpainted, new_dist, new_normal

    # -- dense render --------------------------------------------------------

    def render_dense(self) -> list:
        """The traverse video's frames through the snapshot; returns each
        frame's synchronised render time in ms."""
        conf = self.conf
        n_poses = conf.get_path("render_dense.n_poses", 180)
        cam_type = conf.get_path("render_dense.cam_type", "pano")
        rh = conf.get_path("render_dense.height", 512)
        rw = conf.get_path("render_dense.width", 1024)
        if not conf.get_path("render_dense.snapshot", True):
            raise ValueError("render_dense.snapshot=false (the field-path "
                             "frames) is not ported")
        dense = DenseTravelPoseSampler(self.pose_sampler,
                                       n_dense_poses=n_poses)
        out_dir = pjoin(self.exp_dir, "dense_images_new_" + cam_type)
        os.makedirs(out_dir, exist_ok=True)
        self.scene.bake_snapshot()
        frames, frame_ms = [], []
        for i in range(dense.n_poses):
            pose = dense.sample_pose(i).copy()
            t0 = time.perf_counter()
            if cam_type == "pano":
                pose[:3, :3] = np.eye(3)
                rays = gen_pano_rays(torch.from_numpy(pose).to(self.device),
                                     rh, rw)
            else:
                rays = gen_pers_rays(torch.from_numpy(pose).to(self.device),
                                     fov=float(np.deg2rad(75.0)), res=rh)
            out = self.scene.render_snapshot(rays,
                                             query_keys=("rgb", "distance"))
            rgb = np.clip(_np(out["rgb"]), 0.0, 1.0)
            dist = _np(out["distance"])
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            frames.append((rgb * 255).astype(np.uint8))
            write_image(pjoin(out_dir, f"image_{i}.png"), rgb)
            write_image(pjoin(out_dir, f"distance_{i}.png"),
                        colorize_single_channel_image(1.0 / dist))
        if not write_video(pjoin(out_dir, "video.mp4"), frames, fps=30):
            print(f"[perf_tpu_torch] no video encoder is installed (imageio "
                  f"or cv2): {len(frames)} frames left as PNGs in {out_dir}",
                  flush=True)
        return frame_ms

    # -- checkpointing -------------------------------------------------------

    def save_checkpoint(self):
        save_checkpoint(pjoin(self.exp_dir, "checkpoints", "ckpt.npz"), {
            "scene": self.scene.state_dict(),
            "sup_pool": self.sup_pool.state_dict(),
            "phase": self.phase,
        })
