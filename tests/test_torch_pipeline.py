"""Port vs ``perf_tpu``: the anchor cycle as a whole, and the port's CLI.

- Registration: both packages resume the same raw-fit checkpoint and run
  anchor 0 of their own runner (render -> visibility -> inpaint ->
  geometry -> geo-check -> mask algebra -> register), the joint
  predictor with JAX's draws; the registered pano must agree.
- The CLI: ``python -m perf_tpu_torch --device cpu`` with the overrides of
  ``tests/test_pipeline_e2e.py`` (without ``snapshot.frame_dispatch`` and
  ``scene.train_conf.scan_chunk``, which the port refuses, and with a
  6-level sphere field for the joint predictor) bootstraps the
  geometry, fits, runs one anchor, then renders the dense traverse; the
  checkpoint (phase 1, two panos) loads in JAX.

CPU tensors throughout: every kernel wrapper takes its plain version.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.app.runner import CoreRunner as JRunner
from perf_tpu.config import load_config as j_load_config
from perf_tpu.render.renderer import RenderConfig as JRender
from perf_tpu.train import NeRFScene as JScene, SupInfoPool as JPool
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.train import load_checkpoint as j_load
from perf_tpu.utils import render_cube_room_pano

from perf_tpu_torch.__main__ import main
from perf_tpu_torch.app.runner import CoreRunner
from perf_tpu_torch.config import load_config
from perf_tpu_torch.utils.io import png_bytes, read_image

from test_torch_joint import JaxDraws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = [
    "pers_inpainter_type=fake",
    "priors.backend=fake",
    "priors.joint.gen_res=24",
    "priors.joint.ratios=[1.1]",
    "priors.joint.local_batch=64",
    # 20 + 20 distillation steps (the JAX test runs 50 + 50) keep the file
    # within a minute on one core
    "priors.joint.iters_per_phase=20",
    # divides the 20 and the registration test's 10 steps per phase (JAX
    # asserts it, and so does the port)
    "priors.joint.scan_chunk=10",
    "priors.joint.field.n_levels=6",
    "priors.joint.field.log2_table_size=12",
    "priors.joint.field.fine_res=128",
    "inpaint.gen_res=24",
    "pose_sampler.traverse_ratios=[0.3]",
    "pose_sampler.n_anchors_per_ratio=[1]",
    "scene.max_samples=64",
    "scene.march_step=0.008",
    "scene.occ_res=48",
    "scene.field.n_levels=6",
    "scene.field.log2_bricks=9",
    "scene.field.base_res=4",
    "scene.field.per_level_scale=2.0",
    # 30 + 30 steps per episode (the JAX test runs 50 + 50), for time
    "scene.train_conf.raw_phase_iter_geo=30",
    "scene.train_conf.raw_phase_iter_app=30",
    "scene.train_conf.pixel_loss_batch_size=256",
    "render_dense.n_poses=12",
    "render_dense.height=32",
    "render_dense.width=64",
    "snapshot.res=96",
]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _write_room(case_dir, with_cache: bool):
    case_dir.mkdir()
    pano = render_cube_room_pano(jnp.eye(4), 32, 64)
    rgb = np.round(np.clip(np.asarray(pano["rgb"]), 0, 1) * 255).astype(
        np.uint8)
    (case_dir / "image.png").write_bytes(png_bytes(rgb))
    if with_cache:
        np.save(case_dir / "image_ref_distance.npy",
                np.asarray(pano["distance"]))
        np.save(case_dir / "image_ref_normal.npy", np.asarray(pano["normal"]))
    return case_dir / "image.png"


def _args(image, exp, extra):
    return [f"dataset.image_path={image}", "dataset.image_resize=[64, 32]",
            f"device.base_exp_dir={exp}", *OVERRIDES, *extra]


def _exp(base, case):
    return os.path.join(str(base), f"WildDataset_{case}", "nerf_experiment")


def test_anchor_registration_matches_jax(tmp_path, monkeypatch):
    """Anchor 0 from the same raw-fit checkpoint through both runners:
    JAX's ``CoreRunner.train`` and the port's run their own visibility,
    inpainting, geo-check, mask algebra and registration. The anchor
    render and the geometry are the port's in both (JAX's snapshot and
    distillation compiles take minutes on one core); each is held
    against JAX on its own (``test_torch_serve``, ``test_torch_joint``),
    here the port computes them with JAX's draws."""
    image = _write_room(tmp_path / "reg_room", with_cache=True)
    extra = ["priors.joint.iters_per_phase=10",
             "scene.train_conf.raw_phase_iter_geo=20",
             "scene.train_conf.raw_phase_iter_app=20"]
    raw = tmp_path / "raw"
    main(["--device", "cpu", "--config-name", "nerf",
          *_args(image, raw, extra + ["mode=train",
                                      "pose_sampler.n_anchors_per_ratio=[0]"])])
    for name in ("jax", "port"):
        shutil.copytree(raw, tmp_path / name)
    resume = extra + ["mode=train", "is_continue=true"]
    configs = os.path.join(REPO, "configs")

    conf = load_config(configs, "nerf", _args(image, tmp_path / "port",
                                              resume))
    run = CoreRunner(conf, torch.device("cpu"))
    jrun = JRunner(j_load_config(configs, "nerf",
                                 _args(image, tmp_path / "jax", resume)))
    assert run.phase == jrun.phase == 0
    # the same anchor: the circle's arc-length resampling can move a pick
    # to the neighbouring point (test_torch_anchor)
    run.pose_sampler.anchor_pts = jrun.pose_sampler.anchor_pts
    run.geo_predictor.draws = JaxDraws(0, jrun.geo_predictor.cfg.field)
    renders, geometry = [], []
    render = run.scene.render_snapshot
    predict = run.geo_predictor.__call__

    def port_render(rays, query_keys):
        renders.append(render(rays, query_keys=query_keys))
        return renders[-1]

    def port_predict(*args, **kw):
        geometry.append(predict(*args, **kw))
        return geometry[-1]

    monkeypatch.setattr(run.scene, "render_snapshot", port_render)
    monkeypatch.setattr(run, "geo_predictor", port_predict)
    for r in (run, jrun):
        monkeypatch.setattr(r.scene, "fit", lambda pool: None)
    run.execute("train")

    monkeypatch.setattr(jrun.scene, "render_snapshot", lambda rays, query_keys: {
        k: jnp.asarray(v.numpy()) for k, v in renders[0].items()})

    def jax_inputs_predict(img, dist, mask, **kw):
        # JAX's inpainting must have produced the port's input to geometry
        assert np.abs(np.asarray(img) - inpainted[0]).max() < 1e-4
        return tuple(jnp.asarray(t.numpy()) for t in geometry[0])

    inpainted = [run.sup_pool.sup_infos[1].color_map]
    monkeypatch.setattr(jrun, "geo_predictor", jax_inputs_predict)
    jrun.train()

    assert run.phase == jrun.phase == 1
    (ji,), (pi,) = jrun.sup_pool.sup_infos[1:], run.sup_pool.sup_infos[1:]
    np.testing.assert_array_equal(pi.pose, ji.pose)
    # the inpainted colours: 20 sequential view fills, float32 rounding
    np.testing.assert_allclose(pi.color_map, ji.color_map, atol=1e-4)
    np.testing.assert_array_equal(pi.distance_map, ji.distance_map)
    np.testing.assert_array_equal(pi.normal_map, ji.normal_map)
    # the registered supervision mask (visibility, geo-check, openings and
    # the mask algebra): equal
    np.testing.assert_array_equal(pi.mask_raw, ji.mask_raw)
    np.testing.assert_array_equal(pi.mask, ji.mask)
    assert 0 < pi.mask_raw.sum() < pi.mask_raw.size


def test_cli_trains_an_anchor_and_renders_the_traverse(tmp_path):
    image = _write_room(tmp_path / "cozy_room", with_cache=False)
    exp_base = tmp_path / "exp"
    run = main(["--device", "cpu", "--config-name", "nerf",
                *_args(image, exp_base, ["mode=train"])])
    exp = _exp(exp_base, "cozy_room")
    assert run.phase == 1
    for name in ("1.png", "1_distance.png", "distance_vis.png",
                 "normal_vis.png", "ts_log/metrics.jsonl",
                 "checkpoints/ckpt.npz"):
        assert os.path.exists(os.path.join(exp, name)), name
    vis = os.path.join(exp, "inpaint_vis", "0000")
    for name in ("final_mask.png", "final_masked.png", "uninpainted_0.png",
                 "mask_0.png", "masked_0.png", "inpainted_0.png",
                 "aligned_disparity_0.png", "aligned_normals_0.png"):
        assert os.path.exists(os.path.join(vis, name)), name
    # the bootstrapped geometry, cached beside the image
    for name in ("image_ref_distance.npy", "image_ref_normal.npy",
                 "image_ref_geometry.ply"):
        assert (tmp_path / "cozy_room" / name).exists(), name
    img = read_image(os.path.join(exp, "1.png"))
    assert np.isfinite(img).all() and img.std() > 0.02
    with open(os.path.join(exp, "ts_log", "metrics.jsonl")) as f:
        log = f.read()
    for tag in ("anchor_render", "anchor_visibility", "anchor_inpaint",
                "anchor_geometry", "anchor_geo_check", "anchor_refit",
                "anchor_total", "joint_distill_p1", "fit_prune"):
        assert f'"time/{tag}_sec"' in log, tag
    assert run.scene.last_prune["shell"] > 0

    # JAX loads the checkpoint: phase 1, the input pano and the anchor's
    state = j_load(os.path.join(exp, "checkpoints", "ckpt.npz"))
    assert int(state["phase"]) == 1
    pool = JPool()
    pool.load_state_dict(state["sup_pool"])
    assert len(pool.sup_infos) == 2 and pool.n_valid == run.sup_pool.n_valid
    js = JScene(_jax_field(run), JRender(step=0.008, occ_res=48,
                                         max_samples=64),
                JTrain(), jax.random.PRNGKey(0))
    js.load_state_dict(state["scene"])
    assert js.global_iter_geo == run.scene.global_iter_geo == 60

    # resume: nothing left to train; then the dense traverse
    again = main(["--device", "cpu", "--config-name", "nerf",
                  *_args(image, exp_base, ["mode=train", "is_continue=true"])])
    assert again.phase == 1 and again.losses is None
    dense = main(["--device", "cpu", "--config-name", "nerf",
                  *_args(image, exp_base, ["mode=render_dense",
                                           "is_continue=true"])])
    assert dense.phase == 1
    out = os.path.join(exp, "dense_images_new_pano")
    frames = [f for f in os.listdir(out) if f.startswith("image_")]
    assert len(frames) >= 10
    frame = read_image(os.path.join(out, frames[0]))
    assert frame.shape == (32, 64, 3) and np.isfinite(frame).all()
    with pytest.raises(ValueError, match="snapshot=false"):
        main(["--device", "cpu", "--config-name", "nerf",
              *_args(image, exp_base, ["mode=render_dense", "is_continue=true",
                                       "render_dense.snapshot=false"])])


def _jax_field(run):
    from perf_tpu.fields.ngp import NGPFieldConfig as JField
    from perf_tpu.kernels.brickgrid import BrickGridConfig as JGrid
    g = run.scene.field_cfg.grid
    return JField(grid=JGrid(n_levels=g.n_levels, log2_bricks=g.log2_bricks,
                             base_res=g.base_res,
                             per_level_scale=g.per_level_scale))
