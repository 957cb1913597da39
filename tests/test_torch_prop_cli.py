"""The port's CLI with ``scene.estimator_type=prop`` on a 64x32 cube room:
``mode=train`` (the raw fit and one anchor), a checkpoint that JAX's
``PropNeRFScene`` loads and renders as the port does (eval distance within
1e-5 for 95% of the rays, 1e-4 for all), then
``mode=render_dense`` and ``mode=serve`` from it; any other estimator
raises. The port runs on the CPU (``--device cpu``).

Two cuts for the CPU: the prop scene's eval chunk is 512 rays here
(8192 on the card), and the raw fit's 512x1024 preview (``1.png``) is
rendered at 16x32: the cascade's eval costs ~1 ms a ray on one core.
"""

import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.core import gen_pano_rays as j_pano_rays
from perf_tpu.fields import NGPFieldConfig as JField
from perf_tpu.kernels import HashGridConfig as JHash
from perf_tpu.render.prop import PropRenderConfig as JPropRender
from perf_tpu.train import PropNeRFScene as JScene
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.train import load_checkpoint as j_load
from perf_tpu.utils import render_cube_room_pano

from perf_tpu_torch.__main__ import main
from perf_tpu_torch.app import runner as runner_mod
from perf_tpu_torch.core import gen_pano_rays
from perf_tpu_torch.train import OptimConfig, PropNeRFScene
from perf_tpu_torch.train import prop_scene as PS
from perf_tpu_torch.utils.io import decode_png, png_bytes, read_image

# a 2-level final hash field (res 8 and 32, level 1 hashed into 1024 rows)
GRID = dict(n_levels=2, log2_table_size=10, base_res=8, per_level_scale=4.0)
OVERRIDES = [
    "scene.estimator_type=prop",
    "scene.field.kind=hash", "scene.field.n_levels=2",
    "scene.field.log2_table_size=10", "scene.field.base_res=8",
    "scene.field.per_level_scale=4.0",
    "scene.train_conf.raw_phase_iter_geo=4",
    "scene.train_conf.raw_phase_iter_app=2",
    "scene.train_conf.pixel_loss_batch_size=64",
    "pers_inpainter_type=fake", "priors.backend=fake",
    "priors.joint.gen_res=24", "priors.joint.ratios=[1.1]",
    "priors.joint.local_batch=64", "priors.joint.iters_per_phase=10",
    "priors.joint.scan_chunk=10", "priors.joint.field.n_levels=6",
    "priors.joint.field.log2_table_size=12",
    "priors.joint.field.fine_res=128", "inpaint.gen_res=24",
    "pose_sampler.traverse_ratios=[0.3]",
    "pose_sampler.n_anchors_per_ratio=[1]",
    "render_dense.n_poses=2", "render_dense.height=16",
    "render_dense.width=32",
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def cpu_cuts(monkeypatch):
    monkeypatch.setattr(PS, "EVAL_CHUNK", 512)
    real = runner_mod.gen_pano_rays

    def small_preview(pose, h, w):
        return real(pose, *((16, 32) if (h, w) == (512, 1024) else (h, w)))
    monkeypatch.setattr(runner_mod, "gen_pano_rays", small_preview)


def _room(case_dir):
    case_dir.mkdir()
    pano = render_cube_room_pano(jnp.eye(4), 32, 64)
    rgb = np.round(np.clip(np.asarray(pano["rgb"]), 0, 1) * 255).astype(
        np.uint8)
    (case_dir / "image.png").write_bytes(png_bytes(rgb))
    np.save(case_dir / "image_ref_distance.npy", np.asarray(pano["distance"]))
    np.save(case_dir / "image_ref_normal.npy", np.asarray(pano["normal"]))
    return case_dir / "image.png"


def test_cli_prop_run_jax_loads_renders_alike_dense_and_serves(tmp_path,
                                                               cpu_cuts):
    image = _room(tmp_path / "room")
    common = ["--device", "cpu", "--config-name", "nerf",
              f"dataset.image_path={image}", "dataset.image_resize=[64,32]",
              f"device.base_exp_dir={tmp_path / 'exp'}", *OVERRIDES]
    run = main(common + ["mode=train"])
    assert isinstance(run.scene, PropNeRFScene) and run.phase == 1
    assert (run.scene.global_iter_geo, run.scene.global_iter_app) == (8, 4)
    assert run.scene.snapshot is None
    # the proposal schedule from configs/nerf.yaml
    assert run.scene.train_cfg.prop_optimizer == OptimConfig(
        init_lr=1e-4, peak_lr=1e-3, peak_at=0.1, lr_alpha=0.1)
    for name in ("1.png", "checkpoints/ckpt.npz",
                 "inpaint_vis/0000/inpainted_0.png"):
        assert os.path.exists(os.path.join(run.exp_dir, name)), name
    with open(os.path.join(run.exp_dir, "ts_log", "metrics.jsonl")) as f:
        log = f.read()
    for tag in ("fit_geo_prop", "fit_app_prop", "anchor_refit"):
        assert f'"time/{tag}_sec"' in log, tag
    assert len(run.sup_pool.sup_infos) == 2

    # JAX's scene loads the checkpoint and renders the same eval distance
    state = j_load(os.path.join(run.exp_dir, "checkpoints", "ckpt.npz"))
    assert int(state["phase"]) == 1
    js = JScene(JField(grid=JHash(**GRID)), JPropRender(), JTrain(),
                jax.random.PRNGKey(0))
    js.load_state_dict(state["scene"])
    assert (js.global_iter_geo, js.global_iter_app) == (8, 4)
    np.testing.assert_array_equal(np.asarray(js.prop_params[1]["table"]),
                                  run.scene.prop_params[1]["table"].numpy())
    with jax.disable_jit():
        ref = js.render(j_pano_rays(jnp.eye(4), 8, 16),
                        query_keys=("distance",), chunk=128)["distance"]
    got = run.scene.render(gen_pano_rays(torch.eye(4), 8, 16),
                           query_keys=("distance",), chunk=128)["distance"]
    # the resampling turns exp ulps into edge moves (test_torch_prop) and
    # the eval fill 5 (1 - opacity) multiplies an opacity change by 5
    err = np.abs(got.numpy() - np.asarray(ref))
    assert err.max() <= 1e-4 and (err > 1e-5).mean() <= 0.05, err.max()

    dense = main(common + ["mode=render_dense", "is_continue=true"])
    assert dense.phase == 1 and len(dense.frame_ms) == 2
    frame = read_image(os.path.join(dense.exp_dir, "dense_images_new_pano",
                                    "image_0.png"))
    assert frame.shape == (16, 32, 3) and np.isfinite(frame).all()

    httpd = main(common + ["mode=serve", "is_continue=true", "serve.port=0",
                           "serve.height=16", "serve.width=32"], block=False)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(base + "/render?cam=pano",
                                    timeout=120) as r:
            img = decode_png(r.read())
        want = httpd.scene_server.render(np.eye(4, dtype=np.float32), "pano",
                                         "rgb")
        assert np.array_equal(img, want) and img.std() > 0
        with urllib.request.urlopen(base + "/info", timeout=60) as r:
            info = json.loads(r.read())
        assert info["snapshot_baked"] is False and info["n_rendered"] >= 3
    finally:
        httpd.shutdown()
        httpd.server_close()

    with pytest.raises(ValueError, match="estimator_type='nerfacc'"):
        main(common + ["mode=train", "scene.estimator_type=nerfacc"])
