"""Port vs ``perf_tpu``: the snapshot composite's run dedup (K12,
``SnapshotConfig.dedup_ratio``), and the CLI's knobs of K12.

The composite with K run candidates against JAX's ``_composite_snapshot``
with ``dedup_k`` on the same table and windows (K that clips rays
included), a chunked frame at ratio 0.9 against the standard frame, and
``scene_configs`` / ``train_config`` accepting ``snapshot.dedup_ratio`` and
``train_conf.dedup_runs`` while refusing ``frame_dispatch`` and
``bake_host``. The port runs on CPU tensors (the plain versions).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.render import renderer as J
from perf_tpu.render.snapshot import (_composite_snapshot, _dedup_k_for,
                                      bake_snapshot as j_bake,
                                      snapshot_render_cfg as j_snap_cfg)

from perf_tpu_torch.config import load_config
from perf_tpu_torch.core import gen_pano_rays
from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.render.renderer import beam_dilation, frame_march_plan
from perf_tpu_torch.render.snapshot import (
    SnapshotConfig, bake_snapshot, chunk_budgets, composite_snapshot,
    dedup_k_for, render_snapshot_image, snapshot_render_cfg, snapshot_rows)
from perf_tpu_torch.render.renderer import windows_to_samples

from test_torch_common import configs, cube_room_occ, params_np, random_rays

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


@pytest.fixture(scope="module")
def baked():
    (jf, _, js), _ = configs()
    p, occ = params_np(0), cube_room_occ()
    tab = j_bake(jax.tree_util.tree_map(jnp.asarray, p), jf,
                 jnp.asarray(occ), 64, js)
    return np.array(tab.astype(jnp.float32)), occ, p


def test_dedup_k_matches_jax():
    for ratio in (0.0, 0.05, 0.25, 0.5, 0.9, 1.0):
        for samples in (8, 16, 24, 64, 100, 128, 256):
            assert dedup_k_for(ratio, samples) == _dedup_k_for(ratio, samples)


def test_dedup_composite_matches_jax(baked):
    """K = 1 and 3 clip rays (at K = 1 the outputs differ from the standard
    composite's), K covering every run equals the standard composite
    bitwise, K >= S is the standard composite; each against JAX's at the
    standard composite's bars (tests/test_torch_snapshot.py)."""
    tab, occ, _ = baked
    (jf, jr, js), (tf, tr, ts) = configs()
    jc, tc = j_snap_cfg(jr, js), snapshot_render_cfg(tr, ts)
    o, d = random_rays(2000, seed=4)
    widx, wv, jit = J.march_windows(jnp.asarray(occ), jnp.asarray(o),
                                    jnp.asarray(d), jax.random.PRNGKey(0), jc,
                                    False)
    t_mid, valid = J._windows_to_samples(widx, wv, jit, jc)
    s = t_mid.shape[1]
    table_t = torch.from_numpy(tab).to(torch.bfloat16)
    args = (table_t, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(np.array(widx)).int(),
            torch.from_numpy(np.array(wv)), tf, tc, ts.res)
    t_t, _ = windows_to_samples(args[3], args[4], tc)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_mid))
    rows = snapshot_rows(args[1], args[2], t_t, tf, ts.res)
    runs = ((rows[:, 1:] != rows[:, :-1]).sum(1) + 1)
    cover = int(runs.max())
    assert cover < s
    std = composite_snapshot(*args)
    for k in (1, 3, cover, s):
        ref = _composite_snapshot(jnp.asarray(tab).astype(jnp.bfloat16),
                                  jnp.asarray(o), jnp.asarray(d), t_mid,
                                  valid, jf, jc, ts.res,
                                  ("rgb", "distance", "opacity"), k)
        got = composite_snapshot(*args, dedup_k=k)
        assert float(np.asarray(ref["opacity"]).mean()) > 0.3
        for key, tol in (("rgb", 1e-5), ("opacity", 1e-5),
                         ("distance", 5e-5)):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(ref[key]), rtol=0,
                                       atol=tol, err_msg=f"{key} K={k}")
        if k < cover:
            assert int((runs > k).sum()) > 0
            if k == 1:    # (at K = 3 the clipped slots may all be padding)
                assert not torch.equal(got["opacity"], std["opacity"])
        else:
            assert all(torch.equal(got[key], std[key]) for key in got)


def test_frame_at_ratio_09_matches_the_standard_frame(baked):
    """A 64x128 pano frame from an off-centre pose (grazing rays: some
    chunks get a 128-sample budget, so K = 120 < S there) at ratio 0.9,
    against the same frame without dedup at the bars of
    tests/test_snapshot.py:222."""
    _, occ, p = baked
    tf, tr = configs()[1][:2]
    snap = SnapshotConfig(res=48, sample_stride=1)
    cfg = snapshot_render_cfg(tr, snap)
    table = bake_snapshot(params_from_jax(p), tf, torch.from_numpy(occ), 64,
                          snap)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.5, 0.3, -0.2])
    rays = gen_pano_rays(pose, 64, 128)
    chunk = 1024
    counts = frame_march_plan(torch.from_numpy(occ), rays.o, rays.d, cfg,
                              beam_dilation(rays.d, cfg))[2]
    budgets = chunk_budgets(counts.reshape(-1), chunk, 2, cfg)
    assert any(dedup_k_for(0.9, b) < b for b in budgets), budgets
    args = (table, tf, torch.from_numpy(occ), rays, tr)
    ref = render_snapshot_image(*args, snap, chunk=chunk)
    out = render_snapshot_image(*args, dataclasses.replace(snap,
                                                           dedup_ratio=0.9),
                                chunk=chunk)
    assert out["rgb"].shape == ref["rgb"].shape == (64, 128, 3)
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(out["distance"].numpy(),
                               ref["distance"].numpy(), atol=1e-3)


def test_cli_reads_the_dedup_knobs_and_refuses_the_rest():
    """``snapshot.dedup_ratio`` and ``scene.train_conf.dedup_runs`` are read
    as the JAX runner reads them, on the brick and the hash field and with
    the proposal estimator (which has no snapshot and reads no caps: they
    act on nothing there, and nothing raises); ``frame_dispatch`` and
    ``bake_host`` are still refused."""
    from perf_tpu_torch.__main__ import make_scene, scene_configs
    from perf_tpu_torch.app.runner import train_config
    from perf_tpu_torch.train import NeRFScene, PropNeRFScene
    on = ["snapshot.dedup_ratio=0.5", "scene.train_conf.dedup_runs=true"]
    for extra, kind in (([], NeRFScene), (["scene.field.kind=hash"], NeRFScene),
                        (["scene.estimator_type=prop"], PropNeRFScene)):
        conf = load_config(CONFIGS, "nerf", on + extra)
        snap = scene_configs(conf)[2]
        tc = train_config(conf["scene"]["train_conf"])
        assert snap.dedup_ratio == 0.5 and tc.dedup_runs
        scene = make_scene(conf, torch.Generator().manual_seed(0), "cpu", tc)
        assert isinstance(scene, kind)
    assert scene_configs(load_config(CONFIGS, "nerf", []))[2].dedup_ratio \
        == 0.0
    assert not train_config(load_config(CONFIGS, "nerf", [])["scene"][
        "train_conf"]).dedup_runs
    for key, val in (("frame_dispatch", "true"), ("bake_host", "true")):
        conf = load_config(CONFIGS, "nerf", [f"snapshot.{key}={val}"])
        with pytest.raises(ValueError, match=f"snapshot.{key} is not ported"):
            scene_configs(conf)
