"""Port vs ``perf_tpu``: one training step of each phase on the hash-grid
NGP field (``scene.field.kind: hash``), through the two-budget render,
against ``jax.value_and_grad`` with JAX's own draws (march jitter,
backgrounds, distance noise). The port runs on CPU tensors, where
``HashEncode`` takes its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.render import renderer as J
from perf_tpu.train.schedule import smooth_l1 as j_smooth_l1

from perf_tpu_torch.convert import field_params_from_jax, occ_grid_from_jax
from perf_tpu_torch.render import renderer as T
from perf_tpu_torch.train.schedule import smooth_l1
from perf_tpu_torch.utils import random_field_params

from test_torch_common import cube_room_pools, hash_fields

# res 4 (dense) and 10 (hashed) in 1024 rows: XLA's CPU compile of a step
# grows with the levels' gathers and scatters (30 s a phase at 3 levels)
STEP_GRID = dict(n_levels=2, n_features=2, log2_table_size=10, base_res=4,
                 per_level_scale=2.5)
# 8-step windows sampled at stride 2, a 32-sample budget
TRAIN_RENDER = dict(step=4e-3, occ_res=64, march_coarse=8, max_samples=32,
                    sample_stride=2)


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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.fixture(scope="module")
def room():
    """The JAX pool of the 32x64 cube room: its occupancy grid (res 64,
    dilation 1) and arrays."""
    _, jp, _ = cube_room_pools()
    return jp, jp.gen_occ_grid(64, 1), jp.device_arrays()


@pytest.mark.parametrize("phase", ["geo", "app"])
def test_bucketed_train_step_matches_jax(room, phase):
    """One step of the geo / app loss through the two-budget render on the
    hash field, with JAX's own draws: loss and gradients (the tolerances of
    test_torch_train.py's brick step)."""
    jp, occ_j, arrs = room
    jfield, tfield = hash_fields(**STEP_GRID)
    pt = random_field_params(3, tfield, table_scale=0.2, density_gain=6.0)
    pj = jax.tree_util.tree_map(jnp.asarray, pt)
    jc = J.RenderConfig(**TRAIN_RENDER, remat=False)
    tc = T.RenderConfig(**TRAIN_RENDER)
    sel = np.random.default_rng(6).integers(0, jp.n_valid, 512)
    o, d = arrs["rays_o"][sel], arrs["rays_d"][sel]
    gt_d, gt_c = arrs["distances"][sel], arrs["colors"][sel]
    s_low, n_high = 16, 64
    key = jax.random.PRNGKey(11)
    frozen_key = "app" if phase == "geo" else "geo"
    flags = (dict(stop_app_grad=True, need_rgb=False) if phase == "geo"
             else dict(stop_geo_grad=True))

    def j_loss(train):
        params = {phase: train, frozen_key: pj[frozen_key]}
        out = J.render_rays_bucketed(params, jfield, occ_j, o, d, key, jc,
                                     s_low, n_high, train=True, **flags)
        if phase == "geo":
            return (j_smooth_l1(out["distance"], gt_d, 1e-2)
                    + 0.1 * 0.5 * jnp.mean(out["dist_loss"]))
        return j_smooth_l1(out["rgb"], gt_c, 5e-2)

    loss_j, grads_j = jax.jit(jax.value_and_grad(j_loss))(pj[phase])
    k_march, k_lo, k_hi = jax.random.split(key, 3)
    bgs, noises = [], []
    for kb, nb in ((k_lo, 512 - n_high), (k_hi, n_high)):
        kc, kd = jax.random.split(kb)
        bgs.append(np.asarray(jax.random.uniform(kc, (nb, 3))))
        noises.append(np.asarray(jax.random.uniform(kd, (nb, 1))))
    draws = {"jitter": _t(jax.random.uniform(k_march, (512, 1))),
             "bg": _t(np.concatenate(bgs)),
             "noise": _t(np.concatenate(noises))}
    params = field_params_from_jax(pt, tfield)
    leaves = [params[phase]["table"]] + params[phase]["mlp"]["w"]
    for t in leaves:
        t.requires_grad_(True)
    out = T.render_rays_bucketed(params, tfield, occ_grid_from_jax(occ_j),
                                 _t(o), _t(d), tc, s_low, n_high, draws,
                                 **flags)
    if phase == "geo":
        loss = (smooth_l1(out["distance"], _t(gt_d), 1e-2)
                + 0.1 * 0.5 * out["dist_loss"].mean())
    else:
        loss = smooth_l1(out["rgb"], _t(gt_c), 5e-2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    refs = [grads_j["table"]] + list(grads_j["mlp"]["w"])
    for g, r in zip(grads, refs):
        assert float(np.abs(np.asarray(r)).max()) > 0
        # float32 sums in another order flip bf16 rounding ties of the MLP
        assert _rel(g.numpy(), r) < 1e-3


