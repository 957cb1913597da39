"""Port vs ``perf_tpu``: the hash-grid NGP field (``scene.field.kind:
hash``) through the slice: the golden fit, and the CLI's ``mode=train``
whose checkpoint JAX's NeRFScene loads and renders alike, then
``mode=serve`` from it. The port runs on CPU
tensors, where every kernel wrapper takes its plain version.
"""

import dataclasses
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perf_tpu.core as JC
from perf_tpu.render import renderer as J
from perf_tpu.train import NeRFScene as JScene
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.train import load_checkpoint as j_load
from perf_tpu.utils import render_cube_room_pano

import perf_tpu_torch.core as TC
from perf_tpu_torch.__main__ import main
from perf_tpu_torch.fields import NGPFieldConfig
from perf_tpu_torch.kernels import HashGridConfig
from perf_tpu_torch.render.renderer import render_image
from perf_tpu_torch.train import NeRFScene, TrainConfig
from perf_tpu_torch.utils.io import decode_png, png_bytes

from test_torch_common import HASH_CLI, cube_room_pools, hash_fields

JFIELD, TFIELD = hash_fields()


@pytest.fixture(autouse=True)
def one_thread():
    """The port's many small CPU ops on one thread: beside JAX's thread pool
    (and other test workers) torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def room():
    """The 32x64 cube room's maps and its port pool."""
    maps, _, tp = cube_room_pools()
    return maps, tp


def test_tiny_hash_fit_meets_the_golden_bars(room):
    """The port's episode on the hash field of tests/test_train.py's golden
    fit (8 levels, 2^14 rows, base 4, growth 1.8) on the 32x64 cube room,
    rendered through the snapshot at the input pose: depth error < 0.05,
    PSNR > 30 dB (test_train.py:112-136). Cut to 60 + 120 steps of 256
    rays, as the brick golden fit of test_torch_train.py."""
    maps, tp = room
    from perf_tpu_torch.render import RenderConfig, SnapshotConfig
    fc = NGPFieldConfig(grid=HashGridConfig(
        n_levels=8, n_features=2, log2_table_size=14, base_res=4,
        per_level_scale=1.8))
    scene = NeRFScene(fc, RenderConfig(step=4e-3, max_samples=128,
                                       occ_res=64),
                      torch.Generator().manual_seed(0), "cpu",
                      SnapshotConfig(res=96, sample_stride=2),
                      train_cfg=TrainConfig(raw_phase_iter_geo=60,
                                            raw_phase_iter_app=120,
                                            pixel_loss_batch_size=256))
    losses = scene.fit(tp)
    geo, app = losses["geo_losses"], losses["app_losses"]
    assert (geo[:, -1] == 1).all() and (app[:, -1] == 1).all()
    assert geo[-10:, 1].mean() < geo[:10, 1].mean() * 0.5
    assert app[-10:, 1].mean() < app[:10, 1].mean()
    out = scene.render_snapshot(TC.gen_pano_rays(torch.eye(4), 32, 64))
    mask = tp.sup_infos[0].mask[..., 0]
    depth_err = np.abs(out["distance"].numpy()[..., 0]
                       - maps["distance"][..., 0])[mask].mean()
    assert depth_err < 0.05, depth_err
    mse = np.mean((out["rgb"].numpy()[mask] - maps["rgb"][mask]) ** 2)
    assert -10 * np.log10(mse) > 30.0, mse


def test_cli_hash_run_jax_loads_renders_alike_and_serves(tmp_path):
    """``mode=train`` with ``scene.field.kind=hash`` on a 64x32 pano: a
    checkpoint that JAX's NeRFScene loads and renders (field path) as the
    port does; then ``mode=serve`` from it answers a request that equals a
    direct render."""
    pano = render_cube_room_pano(jnp.eye(4), 32, 64)
    room_dir = tmp_path / "room"
    room_dir.mkdir()
    rgb = np.round(np.clip(np.asarray(pano["rgb"]), 0, 1) * 255).astype(
        np.uint8)
    (room_dir / "image.png").write_bytes(png_bytes(rgb))
    np.save(room_dir / "image_ref_distance.npy", np.asarray(pano["distance"]))
    np.save(room_dir / "image_ref_normal.npy", np.asarray(pano["normal"]))
    common = ["--device", "cpu", "--config-name", "nerf",
              f"dataset.image_path={room_dir / 'image.png'}",
              "dataset.image_resize=[64,32]",
              f"device.base_exp_dir={tmp_path / 'exp'}", *HASH_CLI,
              "scene.occ_res=64", "scene.march_step=0.004",
              "scene.max_samples=64", "snapshot.res=24"]
    runner = main(common + [
        "mode=train", "pose_sampler.n_anchors_per_ratio=[0,0,0]",
        "scene.train_conf.raw_phase_iter_geo=6",
        "scene.train_conf.raw_phase_iter_app=4",
        "scene.train_conf.pixel_loss_batch_size=256"])
    assert runner.scene.field_cfg == TFIELD
    ckpt = os.path.join(runner.exp_dir, "checkpoints", "ckpt.npz")
    state = j_load(ckpt)
    js = JScene(JFIELD, J.RenderConfig(step=4e-3, occ_res=64, max_samples=64),
                JTrain(), jax.random.PRNGKey(0))
    js.load_state_dict(state["scene"])
    assert (js.global_iter_geo, js.global_iter_app) == (6, 4)
    np.testing.assert_array_equal(np.asarray(js.params["app"]["table"]),
                                  runner.scene.params["app"]["table"].numpy())
    rc = dataclasses.replace(js.render_cfg, adaptive_eval=False)
    ref = J.render_image(js.params, JFIELD, js.occ_grid,
                         JC.gen_pano_rays(jnp.eye(4), 16, 32),
                         jax.random.PRNGKey(0), rc, chunk=512)
    out = render_image(runner.scene.params, TFIELD, runner.scene.occ_grid,
                       TC.gen_pano_rays(torch.eye(4), 16, 32),
                       runner.scene.render_cfg, chunk=512)
    # bf16 ties in the MLPs and float32 composite order (Queue 3)
    for q in ("rgb", "distance"):
        err = np.abs(out[q].numpy() - np.asarray(ref[q]))
        assert (err > 1e-4).mean() < 0.02 and err.max() < 5e-2, q

    httpd = main(common + ["mode=serve", "is_continue=true", "serve.port=0",
                           "serve.height=32", "serve.width=64"], block=False)
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/render?cam=pano"
        with urllib.request.urlopen(url, timeout=120) as r:
            img = decode_png(r.read())
        want = httpd.scene_server.render(np.eye(4, dtype=np.float32), "pano",
                                         "rgb")
        assert np.array_equal(img, want) and img.std() > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
