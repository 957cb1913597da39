"""Port vs ``perf_tpu``: the snapshot bake (occupied corners, scatter +
pack) and the snapshot composite, on the same carried params, occupancy,
table and windows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.render import renderer as J
from perf_tpu.render.snapshot import (_brick_pack_dense, _composite_snapshot,
                                      bake_snapshot as j_bake,
                                      snapshot_render_cfg as j_snap_cfg)

from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.render.snapshot import (
    bake_corners, bake_scatter_pack, bake_snapshot, composite_snapshot,
    snapshot_render_cfg)

from test_torch_common import (assert_close_up_to_bf16_ties, configs,
                               cube_room_occ, params_np, random_rays)


@pytest.fixture(scope="module")
def baked():
    (jf, _, js), (tf, _, ts) = configs()
    p, occ = params_np(0), cube_room_occ()
    tab_j = j_bake(jax.tree_util.tree_map(jnp.asarray, p), jf,
                   jnp.asarray(occ), 64, js)
    tab_t = bake_snapshot(params_from_jax(p), tf, torch.from_numpy(occ), 64,
                          ts)
    return np.array(tab_j.astype(jnp.float32)), tab_t, occ


def test_bake_corners_and_table_match_jax(baked):
    tab_j, tab_t, occ = baked
    ts = configs()[1][2]
    # occupied corner set: the JAX bake's dilated-occupancy corner mask
    g = jax.lax.reduce_window(jnp.asarray(occ).reshape(64, 64, 64),
                              np.uint8(0), jax.lax.max, (3, 3, 3),
                              (1, 1, 1), "SAME")
    vox = np.clip((np.arange(ts.res + 1, dtype=np.float32) / ts.res
                   * 64).astype(np.int32), 0, 63)
    m = np.asarray(g)[np.ix_(vox, vox, vox)].reshape(-1)
    idx = bake_corners(torch.from_numpy(occ), 64, ts.res).numpy()
    assert np.array_equal(idx, np.nonzero(m)[0])            # exactly
    tab_t = tab_t.float().numpy()
    assert tab_t.shape == tab_j.shape
    assert np.array_equal(tab_t != 0, tab_j != 0)           # same support
    # bf16 of float32 field values that agree to ~1e-6: within one bf16 ulp
    # (2^-7 relative), except at bf16 rounding ties of MLP hidden units
    # (measured: 0.024% of entries, up to 2.3% relative)
    assert_close_up_to_bf16_ties(tab_t, tab_j, 2.0 ** -7, 1e-3, 0.03)


def test_scatter_pack_equals_jax_dense_pack():
    ts = configs()[1][2]
    rp1 = ts.res + 1
    rng = np.random.default_rng(3)
    idx = np.sort(rng.choice(rp1 ** 3, 5000, replace=False))
    vals = rng.standard_normal((5000, 4)).astype(np.float32)
    vol = np.zeros((rp1 ** 3, 4), np.float32)
    vol[idx] = vals
    ref = _brick_pack_dense(jnp.asarray(vol.reshape(rp1, rp1, rp1, 4)).astype(
        jnp.bfloat16), ts.n_bricks)
    table = torch.zeros((ts.n_bricks ** 3, 256), dtype=torch.bfloat16)
    bake_scatter_pack(table, torch.from_numpy(idx), torch.from_numpy(vals),
                      ts.res)
    # bf16 of the same float32 values, same lanes: bitwise
    assert np.array_equal(table.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)))


def test_composite_matches_jax(baked):
    tab_j, _, occ = baked
    (jf, jr, js), (tf, tr, ts) = configs()
    jc, tc = j_snap_cfg(jr, js), snapshot_render_cfg(tr, ts)
    o, d = random_rays(2000, seed=4)
    widx, wv, jit = J.march_windows(jnp.asarray(occ), jnp.asarray(o),
                                    jnp.asarray(d), jax.random.PRNGKey(0), jc,
                                    False)
    t_mid, valid = J._windows_to_samples(widx, wv, jit, jc)
    ref = _composite_snapshot(jnp.asarray(tab_j).astype(jnp.bfloat16),
                              jnp.asarray(o), jnp.asarray(d), t_mid, valid,
                              jf, jc, ts.res, ("rgb", "distance", "opacity"))
    got = composite_snapshot(torch.from_numpy(tab_j).to(torch.bfloat16),
                             torch.from_numpy(o), torch.from_numpy(d),
                             torch.from_numpy(np.array(widx)).int(),
                             torch.from_numpy(np.array(wv)), tf, tc, ts.res)
    assert float(np.asarray(ref["opacity"]).mean()) > 0.3
    # same table, samples and rows; float32 interpolation sums and the
    # transmittance scan in another order: ~1e-6 of values up to ~1.5 / 5
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["opacity"].numpy(),
                               np.asarray(ref["opacity"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["distance"].numpy(),
                               np.asarray(ref["distance"]), rtol=0, atol=5e-5)
