"""The whole serving slice, port vs ``perf_tpu``: a JAX ``NeRFScene`` with a
seeded field and the cube room's occupancy is saved as a run checkpoint;
the port loads it, bakes, renders and serves over HTTP and through its CLI.
Also: the port's PNG and JET against OpenCV, and that importing the port
never imports JAX."""

import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.app.serve import _pose_from_query as j_pose_from_query
from perf_tpu.core import gen_pano_rays as j_pano, gen_pers_rays as j_pers
from perf_tpu.train import NeRFScene as JScene, TrainConfig, save_checkpoint
from perf_tpu.utils.io import colorize_single_channel_image as j_colorize

from perf_tpu_torch.app.serve import (SceneServer, _pose_from_query,
                                      make_http_server)
from perf_tpu_torch.core import Rays, gen_pano_rays, gen_pers_rays
from perf_tpu_torch.render import render_snapshot_image
from perf_tpu_torch.train import NeRFScene, load_checkpoint
from perf_tpu_torch.utils.io import (colorize_single_channel_image,
                                     decode_png, png_bytes)

from test_torch_common import configs, cube_room_occ, params_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOV = float(np.deg2rad(75.0))
CHUNK = 1024
# dotted overrides that give configs/nerf.yaml the tiny scene's shapes
TINY_OVERRIDES = [
    "scene.occ_res=64", "scene.march_step=0.004", "scene.field.n_levels=4",
    "scene.field.log2_bricks=8", "scene.field.base_res=8",
    "scene.field.per_level_scale=2.0", "snapshot.res=48",
    "snapshot.sample_stride=4", "snapshot.march_coarse=null",
    "serve.height=32", "serve.width=64", "serve.port=0"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX scene -> run checkpoint; JAX's reference renders."""
    (jf, jr, js), _ = configs()
    scene = JScene(jf, jr, TrainConfig(), jax.random.PRNGKey(0))
    state = scene.state_dict()
    state["params"], state["occ_grid"] = params_np(0), cube_room_occ()
    scene.load_state_dict(state)
    scene.snap_cfg = js
    root = tmp_path_factory.mktemp("serve")
    image_path = str(root / "room" / "image.png")     # case_name "room"
    exp_dir = root / "exp" / "WildDataset_room" / "nerf_experiment"
    ckpt = str(exp_dir / "checkpoints" / "ckpt.npz")
    save_checkpoint(ckpt, {"scene": scene.state_dict(), "phase": 0})
    ref = {}
    for cam, rays in (("pano", j_pano(jnp.eye(4), 32, 64)),
                      ("pers", j_pers(jnp.eye(4), FOV, 32))):
        out = scene.render_snapshot(rays, chunk=CHUNK)
        ref[cam] = {k: np.asarray(v) for k, v in out.items()}
        ref[cam]["rays"] = (np.array(rays.o), np.array(rays.d))
    return {"ckpt": ckpt, "base": str(root / "exp"),
            "image_path": image_path, "ref": ref,
            "table": np.array(scene.snapshot.astype(jnp.float32))}


@pytest.fixture(scope="module")
def port_scene(run):
    _, (tf, tr, ts) = configs()
    scene = NeRFScene(tf, tr, torch.Generator().manual_seed(0), "cpu", ts)
    scene.load_state_dict(load_checkpoint(run["ckpt"])["scene"])
    return scene


def test_port_renders_the_jax_checkpoint_like_jax(run, port_scene):
    eye = torch.eye(4)
    jax_table = torch.from_numpy(run["table"]).to(torch.bfloat16)
    for cam, rays in (("pano", gen_pano_rays(eye, 32, 64)),
                      ("pers", gen_pers_rays(eye, FOV, 32))):
        ref = run["ref"][cam]
        # JAX's own table and rays: only float32 sums (interpolation, the
        # transmittance scan) run in another order, ~1e-6 of rgb <= 1 and
        # of distance <= 5, which exp carries up to ~1e-4 at an opaque step
        same = render_snapshot_image(
            jax_table, port_scene.field_cfg, port_scene.occ_grid,
            Rays(*(torch.from_numpy(a) for a in ref["rays"])),
            port_scene.render_cfg, port_scene.snap_cfg, chunk=CHUNK)
        np.testing.assert_allclose(same["rgb"].numpy(), ref["rgb"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(same["distance"].numpy(), ref["distance"],
                                   rtol=0, atol=5e-4)

        # the port's own bake and rays, from the checkpoint
        out = port_scene.render_snapshot(rays, chunk=CHUNK)
        rgb, dist = out["rgb"].numpy(), out["distance"].numpy()
        assert rgb.shape == ref["rgb"].shape and np.isfinite(rgb).all()
        assert rgb.std() > 0.02                        # not a flat frame
        # the tables differ at bf16 rounding ties of the MLP's hidden units
        # (test_torch_snapshot: ~0.02% of entries, up to ~3%); pixels whose
        # samples read such a corner move (measured: 0.6% of pano values
        # by more than 1e-4, at most 6e-3), the rest agree to ~1e-6
        for got, want in ((rgb, ref["rgb"]), (dist, ref["distance"])):
            err = np.abs(got - want)
            assert (err > 1e-4).mean() < 0.02 and err.max() < 0.02
            assert err.mean() < 2e-5


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_http_server_answers_and_png_equals_direct_render(port_scene):
    srv = SceneServer(port_scene, height=32, width=64)
    srv.warmup()
    httpd = make_http_server(srv, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        code, ctype, body = _get(base + "/health")
        health = json.loads(body)
        assert code == 200 and ctype == "application/json"
        assert health["status"] == "ok" and health["snapshot_baked"]

        code, ctype, body = _get(base + "/render")
        assert code == 200 and ctype == "image/png"
        direct = port_scene.render_snapshot(gen_pano_rays(torch.eye(4), 32, 64),
                                            query_keys=("rgb",))["rgb"]
        want = (np.clip(direct.numpy(), 0, 1) * 255).astype(np.uint8)
        assert np.array_equal(decode_png(body), want)

        code, _, body = _get(base + "/render?px=0.2&py=0.1&yaw=0.5&pitch=-0.2"
                                    "&cam=pers")
        img = decode_png(body)
        assert code == 200 and img.shape == (32, 32, 3) and img.std() > 1.0
        code, _, body = _get(base + "/render?q=distance")
        assert code == 200 and decode_png(body).shape == (32, 64, 3)
        for bad in ("/render?cam=nope", "/render?q=depth"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base + bad)
            assert e.value.code == 400 and "error" in json.loads(e.value.read())
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_cli_serves_the_checkpoint(run):
    cmd = [sys.executable, "-m", "perf_tpu_torch", "--device", "cpu",
           "--config-name", "nerf", f"device.base_exp_dir={run['base']}",
           f"dataset.image_path={run['image_path']}", "mode=serve",
           "is_continue=true", *TINY_OVERRIDES]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(300, proc.kill)   # a hung server fails, late
    watchdog.start()
    try:
        line = ""
        for line in proc.stdout:
            if line.startswith("serving on "):
                break
        assert line.startswith("serving on "), line
        url = line.split()[2]
        code, ctype, body = _get(url + "/render?cam=pano")
        assert code == 200 and ctype == "image/png"
        ref = np.clip(run["ref"]["pano"]["rgb"], 0, 1) * 255
        # the checkpoint's scene: within a grey level of JAX's frame
        assert np.abs(decode_png(body).astype(np.float64) - ref).mean() < 1.0
    finally:
        watchdog.cancel()
        proc.terminate()
        proc.wait(timeout=30)


def test_nerf_yaml_gives_the_production_scene_configs():
    from perf_tpu_torch.__main__ import CONFIG_DIR, scene_configs
    from perf_tpu_torch.config import load_config
    from perf_tpu_torch.render import snapshot_render_cfg
    field, render, snap = scene_configs(load_config(str(CONFIG_DIR), "nerf"))
    g = field.grid
    assert (g.n_levels, g.log2_bricks, g.n_features, field.n_neurons) == \
        (16, 12, 2, 64)
    # levels 0-2 dense, 3-15 hashed into 2^12 rows
    assert [g.level_hashed(l) for l in range(16)] == [False] * 3 + [True] * 13
    assert (render.occ_res, render.step) == (256, 5e-4)
    assert (snap.res, snap.sample_stride, snap.march_coarse,
            snap.bake_chunk) == (384, 12, 12, 1 << 21)
    cfg = snapshot_render_cfg(render, snap)
    assert (cfg.max_samples, cfg.max_windows, cfg.max_segments,
            cfg.n_segments, cfg.n_windows) == (21, 21, 7, 63, 250)


def test_png_and_jet_match_opencv():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (9, 13, 3), dtype=np.uint8)
    data = png_bytes(img)
    assert np.array_equal(
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1],
        img)
    assert np.array_equal(decode_png(data), img)
    dist = rng.uniform(0.3, 5.0, (16, 32, 1)).astype(np.float32)
    dist[0, 0] = 0.3
    dist[0, 1] = 5.0
    assert np.array_equal(colorize_single_channel_image(1.0 / dist),
                          j_colorize(1.0 / dist))
    ramp = np.arange(256, dtype=np.float32).reshape(16, 16)  # every entry
    assert np.array_equal(colorize_single_channel_image(ramp),
                          j_colorize(ramp))


def test_pose_from_query_matches_jax():
    q = {"px": ["0.2"], "py": ["-0.1"], "pz": ["0.05"], "yaw": ["0.7"],
         "pitch": ["-0.3"]}
    assert np.array_equal(_pose_from_query(q), j_pose_from_query(q))


def test_importing_the_port_never_imports_jax():
    code = ("import sys, perf_tpu_torch.__main__, perf_tpu_torch.app.serve, "
            "perf_tpu_torch.utils, perf_tpu_torch.render, "
            "perf_tpu_torch.train, perf_tpu_torch.convert, "
            "perf_tpu_torch.config, perf_tpu_torch.device; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'perf_tpu.', 'flax', 'optax')) "
            "or m == 'perf_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
