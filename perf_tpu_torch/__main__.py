"""CLI: ``python -m perf_tpu_torch --config-name nerf [--device cuda]
device.base_exp_dir=... dataset.image_path=... mode=train|render_dense|serve``

Reads the shared ``configs/`` with ``perf_tpu``'s dotted overrides,
resolves the experiment directory as ``perf_tpu/app/runner.py:141-145``
does (``<base_exp_dir>/<dataset_class_name>_<case_name>/<exp_name>``,
``case_name`` being the image's parent directory) and builds the field,
render and snapshot configs as ``runner.py:175-249`` does.

- ``mode=train``: the geometry bootstrap (when no cache sits beside the
  image), the raw fit and every anchor cycle (``app/runner.py``), with a
  checkpoint after each phase; ``is_continue=true`` resumes at the phase
  the checkpoint reached.
- ``mode=render_dense`` (with ``is_continue=true``): the dense traverse
  frames through the snapshot.
- ``mode=serve`` (with ``is_continue=true``): loads
  ``checkpoints/ckpt.npz`` and serves it over HTTP.

``scene.field`` chooses the grid as the JAX runner does: ``kind: brick``
the brick grid; another kind with keys (``kind: hash``) a hash grid of
those keys (``log2_table_size`` 18 by default); no keys the default NGP
field (the hash grid). ``scene.estimator_type`` chooses the scene as
``runner.py:218-226`` does: ``occ`` (the default) the occupancy-grid
``NeRFScene``, ``prop`` the proposal cascade's ``PropNeRFScene`` (its
render config takes only ``renderer_conf.bg_color``); any other raises.
The device defaults to ``cuda``; ``--device cpu`` runs the plain versions.
"""

from __future__ import annotations

import argparse
import os
from os.path import join as pjoin
from pathlib import Path

import torch

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def exp_dir_of(conf) -> str:
    image_path = str(conf["dataset"]["image_path"])
    case_name = image_path.split("/")[-2] if "/" in image_path else "wp"
    return pjoin(conf["device"]["base_exp_dir"],
                 f"{conf['dataset_class_name']}_{case_name}",
                 conf["exp_name"])


ESTIMATORS = ("occ", "prop")


def estimator_type(conf) -> str:
    est = conf["scene"].get("estimator_type", "occ")
    if est not in ESTIMATORS:
        raise ValueError(f"scene.estimator_type={est!r}: expected one of "
                         f"{ESTIMATORS}")
    return est


def make_scene(conf, generator: torch.Generator, device: torch.device,
               train_cfg=None, writer=None):
    """The scene of ``scene.estimator_type``: a ``NeRFScene`` (occ) or a
    ``PropNeRFScene`` (prop), freshly initialised from ``generator``."""
    from .render.prop import PropRenderConfig
    from .train import NeRFScene, PropNeRFScene, TrainConfig
    field_cfg, render_cfg, snap_cfg = scene_configs(conf)
    if estimator_type(conf) == "prop":
        rc = conf.get_path("scene.renderer_conf", {}) or {}
        return PropNeRFScene(
            field_cfg, PropRenderConfig(bg_color=rc.get("bg_color",
                                                        "rand_noise")),
            train_cfg or TrainConfig(), generator, device, writer)
    return NeRFScene(field_cfg, render_cfg, generator, device, snap_cfg,
                     train_cfg, writer)


def scene_configs(conf):
    """(NGPFieldConfig, RenderConfig, SnapshotConfig) from a loaded config,
    with the JAX runner's keys and defaults."""
    from .fields import NGPFieldConfig
    from .kernels import BrickGridConfig, HashGridConfig
    from .render import RenderConfig, SnapshotConfig
    estimator_type(conf)
    fc = conf.get_path("scene.field", {}) or {}
    rc = conf.get_path("scene.renderer_conf", {}) or {}
    kind = fc.get("kind", "hash")
    # the snapshot takes its sample cap from snapshot_render_cfg, not
    # scene.max_samples
    render_cfg = RenderConfig(
        bg_color=rc.get("bg_color", "rand_noise"),
        max_samples=conf.get_path("scene.max_samples", 256),
        step=conf.get_path("scene.march_step", 5e-4),
        occ_res=conf.get_path("scene.occ_res", 256),
        occ_dilation=conf.get_path("scene.occ_dilation", 1),
        eval_chunk=rc.get("eval_chunk", 8192 if kind == "brick" else 32768))
    # the JAX runner's three branches: the brick grid; any other kind with
    # keys, a hash grid of those keys; no keys, the default (hash) field
    if kind == "brick":
        field_cfg = NGPFieldConfig(grid=BrickGridConfig(
            n_levels=fc.get("n_levels", 16),
            n_features=fc.get("n_features", 2),
            log2_bricks=fc.get("log2_bricks", 12),
            base_res=fc.get("base_res", 16),
            per_level_scale=fc.get("per_level_scale", 1.4472692012786865)))
    elif fc:
        field_cfg = NGPFieldConfig(grid=HashGridConfig(
            n_levels=fc.get("n_levels", 16),
            n_features=fc.get("n_features", 2),
            log2_table_size=fc.get("log2_table_size", 18),
            base_res=fc.get("base_res", 16),
            per_level_scale=fc.get("per_level_scale", 1.4472692012786865)))
    else:
        field_cfg = NGPFieldConfig()
    sd = SnapshotConfig()
    for key, off in (("frame_dispatch", False), ("bake_host", False)):
        if conf.get_path(f"snapshot.{key}", off) != off:
            raise ValueError(f"snapshot.{key} is not ported (must be {off})")
    # dedup_ratio acts on every snapshot render of an occupancy-grid scene
    # (brick or hash field); a prop scene has no snapshot, so there it is
    # read and has nothing to act on, as in JAX
    snap_cfg = SnapshotConfig(
        res=int(conf.get_path("snapshot.res", sd.res)),
        sample_stride=conf.get_path("snapshot.sample_stride",
                                    sd.sample_stride),
        march_coarse=conf.get_path("snapshot.march_coarse", sd.march_coarse),
        dedup_ratio=float(conf.get_path("snapshot.dedup_ratio",
                                        sd.dedup_ratio)))
    return field_cfg, render_cfg, snap_cfg


def build_scene(conf, device: torch.device):
    """The scene of the run: the checkpoint's when ``is_continue`` and it
    exists, else a freshly initialised field (as the JAX runner)."""
    from .train import load_checkpoint
    gen = torch.Generator().manual_seed(int(conf.get("seed", 0)))
    scene = make_scene(conf, gen, device)
    ckpt = pjoin(exp_dir_of(conf), "checkpoints", "ckpt.npz")
    if conf.get("is_continue", False) and os.path.exists(ckpt):
        scene.load_state_dict(load_checkpoint(ckpt)["scene"])
    else:
        print(f"[perf_tpu_torch] no checkpoint loaded ({ckpt}); serving a "
              "freshly initialised field", flush=True)
    return scene


def main(argv=None, block: bool = True):
    ap = argparse.ArgumentParser(prog="python -m perf_tpu_torch")
    ap.add_argument("--config-name", default="nerf")
    ap.add_argument("--config-path", default=str(CONFIG_DIR))
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    ap.add_argument("overrides", nargs="*",
                    help="dotted overrides, e.g. mode=serve is_continue=true")
    args = ap.parse_args(argv)

    from .config import load_config
    from .device import get_device
    conf = load_config(args.config_path, args.config_name, args.overrides)
    mode = str(conf.get("mode", "train"))
    if mode not in ("train", "render_dense", "serve"):
        raise ValueError(f"mode={mode!r}: only mode=train, render_dense and "
                         "serve are ported")
    device = get_device(args.device)
    if mode != "serve":
        from .app.runner import CoreRunner
        runner = CoreRunner(conf, device)
        runner.execute(mode)
        return runner
    scene = build_scene(conf, device)
    from .app.serve import serve_scene
    return serve_scene(scene, conf, block=block)


if __name__ == "__main__":
    main()
