"""The contract of ``tests/test_prop_scene.py:43`` on the port's
``PropNeRFScene``, at that test's sizes: a 32x64 cube room, a 6-level 2^12
hash field, 64 -> 32 -> 32 samples, 120 + 60 steps of 512 rays, the fixed
5-level proposal cascade.

The scene starts from JAX's ``PropNeRFScene(PRNGKey(0))`` as that test
builds it: its initial parameters, its geometry reset and its step draws
(batch indices, jitter, per-level u, background, noise), fed through the
scene's ``fresh_geo`` / ``step_draws``, so the port retraces JAX's fit.
The eval-distance bar is seed-fragile in both packages (JAX's own scene
misses it at some initial keys, the port's at some torch seeds), so the
port's own draws are not held to it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.fields import NGPFieldConfig as JField
from perf_tpu.fields import reset_geo as j_reset_geo
from perf_tpu.kernels import HashGridConfig as JHash
from perf_tpu.render.prop import PropRenderConfig as JPropRender
from perf_tpu.train import PropNeRFScene as JScene
from perf_tpu.train import TrainConfig as JTrain
from perf_tpu.utils import render_cube_room_pano

from perf_tpu_torch.convert import params_from_jax, prop_params_from_jax
from perf_tpu_torch.core import gen_pano_rays
from perf_tpu_torch.fields import NGPFieldConfig
from perf_tpu_torch.kernels import HashGridConfig
from perf_tpu_torch.render.prop import PropRenderConfig
from perf_tpu_torch.train import PropNeRFScene, SupInfoPool, TrainConfig
from perf_tpu_torch.train.prop_scene import PROP_FIELD_CFGS

from test_torch_prop import jax_draws

H, W = 32, 64
GRID = dict(n_levels=6, log2_table_size=12, base_res=4, per_level_scale=2.0)
SAMPLES = dict(n_samples=32, n_samples_per_prop=(64, 32))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class JaxDrawnScene(PropNeRFScene):
    """The port's scene with JAX's initial parameters, geometry resets and
    step draws, taken from ``jscene``'s key as its ``fit`` takes them."""

    def __init__(self, jscene: JScene, *args):
        super().__init__(*args)
        self.jscene = jscene
        self.params = params_from_jax(_np_tree(jscene.params))
        self.prop_params = prop_params_from_jax(
            [_np_tree(p) for p in jscene.prop_params], PROP_FIELD_CFGS)
        self.key = None

    def fresh_geo(self) -> dict:
        js = self.jscene
        geo = j_reset_geo(js.params, js._next_key(), js.field_cfg)["geo"]
        self.key = js._next_key()         # fit's loop key, as JAX's fit
        return params_from_jax(_np_tree(geo))

    def step_draws(self) -> tuple:
        b = self.train_cfg.pixel_loss_batch_size
        self.key, k_idx, k_render = jax.random.split(self.key, 3)
        u = torch.from_numpy(np.array(jax.random.uniform(k_idx, (b,))))
        return u, jax_draws(k_render, b, 2)


def test_prop_fit_converges_renders_and_round_trips():
    """The depth loss of the last 10 geometry steps below 0.7 x the first
    10, the colour loss falling, no step skipped; a finite, non-flat eval
    render with distance MAE < 0.15; visibility from the same pose > 0.8;
    the state round-trips into a scene of another seed (equal renders)."""
    pano = render_cube_room_pano(jnp.eye(4), H, W)
    pool = SupInfoPool()
    pool.register_sup_info(pose=np.eye(4, dtype=np.float32),
                           mask=np.ones((H, W)), rgb=np.asarray(pano["rgb"]),
                           distance=np.asarray(pano["distance"]),
                           normal=np.asarray(pano["normal"]))
    fc = NGPFieldConfig(grid=HashGridConfig(**GRID))
    tc = TrainConfig(raw_phase_iter_geo=120, raw_phase_iter_app=60,
                     pixel_loss_batch_size=512)
    jscene = JScene(JField(grid=JHash(**GRID)), JPropRender(**SAMPLES),
                    JTrain(raw_phase_iter_geo=120, raw_phase_iter_app=60,
                           pixel_loss_batch_size=512),
                    jax.random.PRNGKey(0))
    sc = JaxDrawnScene(jscene, fc, PropRenderConfig(**SAMPLES), tc,
                       torch.Generator().manual_seed(0), "cpu")
    out = sc.fit(pool)
    gl, al = out["geo_losses"], out["app_losses"]
    assert gl.shape == (120, 5) and al.shape == (60, 4)
    assert (gl[:, -1] == 1).all() and (al[:, -1] == 1).all()
    assert gl[-10:, 1].mean() < gl[:10, 1].mean() * 0.7, \
        (gl[:10, 1].mean(), gl[-10:, 1].mean())
    assert al[-10:, 1].mean() < al[:10, 1].mean()
    assert (sc.global_iter_geo, sc.global_iter_app) == (120, 60)

    rays = gen_pano_rays(torch.eye(4), H, W)
    res = sc.render(rays, query_keys=("rgb", "distance"), chunk=1024)
    rgb, dist = res["rgb"].numpy(), res["distance"].numpy()
    assert rgb.shape == (H, W, 3) and dist.shape == (H, W, 1)
    assert np.isfinite(rgb).all() and np.isfinite(dist).all()
    assert rgb.std() > 0.02
    mae = np.abs(dist - np.asarray(pano["distance"])).mean()
    assert mae < 0.15, mae
    mask = sc.get_pano_visibility_mask(pool, rays)
    assert float(mask.float().mean()) > 0.8
    assert sc.bake_snapshot() is None and sc.snapshot is None

    # the round trip, on a quarter of the rays (eval time)
    sd = sc.state_dict()
    assert sorted(sd["prop_params"]) == ["p0", "p1"]
    back = PropNeRFScene(fc, PropRenderConfig(**SAMPLES), tc,
                         torch.Generator().manual_seed(1), "cpu")
    back.load_state_dict(sd)
    part = type(rays)(o=rays.o[::4], d=rays.d[::4])
    d2 = back.render(part, query_keys=("distance",), chunk=512)["distance"]
    np.testing.assert_allclose(d2.numpy(), dist[::4], atol=1e-5)
