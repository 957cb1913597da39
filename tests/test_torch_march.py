"""Port vs ``perf_tpu``: the eval march. Window and segment indices are
integers and must be exactly equal wherever they are valid (padding slots
carry weight 0 and may hold any index); counts are exactly equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.core import gen_pano_rays as j_pano, gen_pers_rays as j_pers
from perf_tpu.render import renderer as J
from perf_tpu.render.snapshot import snapshot_render_cfg as j_snap_cfg

from perf_tpu_torch.render import renderer as T
from perf_tpu_torch.render.snapshot import snapshot_render_cfg

from test_torch_common import configs, cube_room_occ, random_rays


def _cfg_pairs():
    (_, jr, js), (_, tr, ts) = configs()
    # the test's own snapshot march, and production's shape (12-step
    # windows sampled once each)
    yield j_snap_cfg(jr, js), snapshot_render_cfg(tr, ts)
    kw = dict(step=4e-3, occ_res=64, march_coarse=12, sample_stride=12,
              max_samples=21)
    yield J.RenderConfig(**kw), T.RenderConfig(**kw)


@pytest.fixture(scope="module")
def occ():
    g = cube_room_occ()
    return jnp.asarray(g), torch.from_numpy(g)


def _valid_eq(idx_j, valid_j, idx_t, valid_t):
    valid_j = np.asarray(valid_j) > 0
    assert np.array_equal(valid_j, valid_t.numpy() > 0)
    assert np.array_equal(np.where(valid_j, np.asarray(idx_j), -1),
                          np.where(valid_j, idx_t.numpy(), -1))


@pytest.mark.parametrize("which", [0, 1])
def test_march_windows_per_ray_equals_jax(occ, which):
    jc, tc = list(_cfg_pairs())[which]
    o, d = random_rays(3000, seed=which)
    coarse = T.coarse_occ_grid(occ[1], tc.occ_res)
    assert np.array_equal(coarse.numpy(),
                          np.asarray(J.coarse_occ_grid(occ[0], jc.occ_res)))
    widx_j, wv_j, _ = J.march_windows(occ[0], jnp.asarray(o), jnp.asarray(d),
                                      jax.random.PRNGKey(0), jc, False)
    widx, wv, counts, sidx, sv = T.march_windows(
        occ[1], torch.from_numpy(o), torch.from_numpy(d), tc, coarse=coarse)
    assert widx.shape == widx_j.shape and float(wv.sum()) > 0
    _valid_eq(widx_j, wv_j, widx, wv)
    assert np.array_equal(counts.numpy(), np.asarray(wv_j).sum(1))
    # the selected segments too
    sidx_j, sv_j = J._select_segments(occ[0], jnp.asarray(o), jnp.asarray(d),
                                      jnp.zeros((3000, 1)), jc)
    _valid_eq(sidx_j, sv_j, sidx, sv)
    # samples of the non-stratified march_rays
    t_j, v_j = J.march_rays(occ[0], jnp.asarray(o), jnp.asarray(d),
                            jax.random.PRNGKey(0), jc, False)
    t_t, v_t = T.march_rays(occ[1], torch.from_numpy(o), torch.from_numpy(d),
                            tc)
    _valid_eq(t_j, v_j, t_t, v_t)
    # adaptive-budget bound of unplanned frames
    assert np.array_equal(
        T.count_occupied_windows(occ[1], torch.from_numpy(o),
                                 torch.from_numpy(d), tc).numpy(),
        np.asarray(J.count_occupied_windows(occ[0], jnp.asarray(o),
                                            jnp.asarray(d), jc)))


@pytest.mark.parametrize("cam", ["pano", "pers"])
def test_frame_march_plan_and_planned_chunk_equal_jax(occ, cam):
    jc, tc = next(_cfg_pairs())
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.1, -0.05, 0.02)
    rays = (j_pano(jnp.asarray(pose), 32, 64) if cam == "pano"
            else j_pers(jnp.asarray(pose), 1.3, 32))
    o_img, d_img = np.array(rays.o), np.array(rays.d)
    dil = J.beam_dilation(d_img, jc)
    assert T.beam_dilation(torch.from_numpy(d_img), tc) == dil
    s_j, sv_j, c_j = J.frame_march_plan(occ[0], jnp.asarray(o_img),
                                        jnp.asarray(d_img), jc, dil)
    s_t, sv_t, c_t = T.frame_march_plan(occ[1], torch.from_numpy(o_img),
                                        torch.from_numpy(d_img), tc, dil)
    _valid_eq(s_j, sv_j, s_t, sv_t)
    assert np.array_equal(c_t.numpy(), np.asarray(c_j))
    assert int(c_t.max()) > 0

    # a planned chunk's fine stage: per-pixel segments from the plan, with
    # a chunk budget smaller than the cap
    h, w = o_img.shape[:2]
    s_px = np.repeat(np.repeat(np.asarray(s_j).reshape(h // 4, w // 4, -1),
                               4, 0), 4, 1).reshape(h * w, -1)
    sv_px = np.repeat(np.repeat(np.asarray(sv_j).reshape(h // 4, w // 4, -1),
                                4, 0), 4, 1).reshape(h * w, -1)
    o, d = o_img.reshape(-1, 3), d_img.reshape(-1, 3)
    for budget in (tc.max_samples, 16):
        jcc = dataclasses.replace(jc, max_samples=budget)
        tcc = dataclasses.replace(tc, max_samples=budget)
        wj, wvj = J._fine_windows_from_segments(
            occ[0], jnp.asarray(o), jnp.asarray(d), jnp.asarray(s_px),
            jnp.asarray(sv_px), jnp.zeros((h * w, 1)), jcc)
        wt, wvt, cnt, _, _ = T.march_windows(
            occ[1], torch.from_numpy(o), torch.from_numpy(d), tcc,
            segments=(torch.from_numpy(s_px).int(),
                      torch.from_numpy(sv_px)))
        assert wt.shape == wj.shape
        _valid_eq(wj, wvj, wt, wvt)
