"""Port vs ``perf_tpu``: one bucketed geometry step of the training loss
with run caps engaged (K12, the run-dedup encode), against
``jax.value_and_grad`` on JAX's own draws; the appearance step (both heads
and the colour head's window gather) is in
``tests/test_torch_dedup_app_step.py`` (JAX's compile of each step takes
~20 s on one core). The port runs on CPU tensors, where every wrapper takes
its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.render import renderer as J
from perf_tpu.train.schedule import smooth_l1 as j_smooth_l1

from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.kernels.brickgrid import dedup_caps
from perf_tpu_torch.render import renderer as T
from perf_tpu_torch.train import smooth_l1
from perf_tpu_torch.utils import random_field_params

from test_torch_common import configs
from test_torch_dedup import _rel, room  # noqa: F401

# the training render config of test_torch_train.py: 8-step windows at
# stride 2 (4 samples a window), 32 samples (16 in the low bucket)
TRAIN_RENDER = dict(step=4e-3, occ_res=64, march_coarse=8, max_samples=32,
                    sample_stride=2)


@pytest.fixture(scope="module")
def field():
    """The 4-level field of test_torch_common in both trees, scaled so that
    the rays' opacity spreads over 0.15-0.8."""
    (jf, _, _), (tf, _, _) = configs()
    p = random_field_params(3, tf, table_scale=0.2, density_gain=6.0)
    return jf, tf, jax.tree_util.tree_map(jnp.asarray, p), p


# caps below the point count of every level at the steps' 32 samples
# (strides 16, 8, 4, 2: 3, 5, 9 and 17 points a ray) and of three levels at
# the low bucket's and the window gather's 16
STEP_CAPS = (2, 3, 4, 6)


def check_dedup_step(room, field, phase: str):
    """One step of the scene's geometry / appearance loss through the
    two-budget render with run caps (the colour head's window gather too),
    with JAX's own draws: loss and gradients (test_torch_train.py's bars)."""
    jp, _, occ_j = room
    jf, tf, pj, pt = field
    arrs = jp.device_arrays()
    jc = J.RenderConfig(**TRAIN_RENDER, remat=False, run_caps=STEP_CAPS)
    tc = T.RenderConfig(**TRAIN_RENDER, run_caps=STEP_CAPS)
    for samples in (32, 16):
        strides = T._strides(tf, tc, samples)
        assert dedup_caps(strides, samples, STEP_CAPS) is not None
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
        out = J.render_rays_bucketed(params, jf, occ_j, o, d, key, jc, s_low,
                                     n_high, train=True, **flags)
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
    draws = {"jitter": torch.from_numpy(np.array(
                 jax.random.uniform(k_march, (512, 1)))),
             "bg": torch.from_numpy(np.concatenate(bgs)),
             "noise": torch.from_numpy(np.concatenate(noises))}
    params = params_from_jax(pt)
    leaves = [params[phase]["table"]] + params[phase]["mlp"]["w"]
    for t in leaves:
        t.requires_grad_(True)
    out = T.render_rays_bucketed(params, tf, torch.from_numpy(np.array(occ_j)),
                                 torch.from_numpy(np.asarray(o)),
                                 torch.from_numpy(np.asarray(d)), tc, s_low,
                                 n_high, draws, **flags)
    if phase == "geo":
        loss = (smooth_l1(out["distance"], torch.from_numpy(np.asarray(gt_d)),
                          1e-2) + 0.1 * 0.5 * out["dist_loss"].mean())
    else:
        loss = smooth_l1(out["rgb"], torch.from_numpy(np.asarray(gt_c)), 5e-2)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    refs = [grads_j["table"]] + list(grads_j["mlp"]["w"])
    for g, r in zip(grads, refs):
        assert float(np.abs(np.asarray(r)).max()) > 0
        # bf16 ties of the MLP's float32 sums (ROADMAP Queue 3), as in
        # test_torch_train.py
        assert _rel(g.numpy(), r) < 1e-3


def test_bucketed_dedup_geo_step_matches_jax(room, field):
    check_dedup_step(room, field, "geo")
