"""Port vs ``perf_tpu``: the pano fusion predictors of the non-Wild path.

For ``PanoFusionInvPredictor`` (distance) and ``PanoFusionNormalPredictor``
(normals): the loss and the gradient of every parameter map (per-view
scales, per-view bias maps, the pano map) in each phase against
``jax.value_and_grad`` of JAX's loss, at the start and at seeded random
parameters; then the whole predictor, two steps of each phase (Adam, the
zeroed bias gradient of the first phase, each predictor's learning-rate
schedule, the guard), against JAX's predictor. The same views and fake
priors in both packages, a reference map with a known left half (mask 0).
CPU tensors: the ``bilinear`` wrappers take their plain versions. A 16x32
room, 24-pixel views.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.core import direction_to_img_coord as j_dir_to_img
from perf_tpu.core import bilinear_sample as j_bilinear
from perf_tpu.core import pano_sample as j_pano_sample
from perf_tpu.priors import (FakeCubeRoomDepthPredictor as JFakeDepth,
                             FakeCubeRoomNormalPredictor as JFakeNormal)
from perf_tpu.priors.pano_fusion import (
    PanoFusionConfig as JFusionCfg, PanoFusionInvPredictor as JInv,
    PanoFusionNormalPredictor as JNormal, _distortion_weights as j_dw,
    _pano_projection as j_proj, _view_geometry as j_views)
from perf_tpu.train.schedule import smooth_l1 as j_smooth_l1

from perf_tpu_torch.priors import (FakeCubeRoomDepthPredictor,
                                   FakeCubeRoomNormalPredictor,
                                   PanoFusionConfig, PanoFusionInvPredictor,
                                   PanoFusionNormalPredictor)
from perf_tpu_torch.utils import render_cube_room_pano

from test_torch_anchor import _rel, _t, one_thread  # noqa: F401

H, W = 16, 32
GEN = 24


@pytest.fixture(scope="module")
def scene():
    """The room's rgb, a reference distance and normal map, and a mask
    that frees the right half (the left half is known), as numpy."""
    pano = render_cube_room_pano(torch.eye(4), H, W)
    mask = np.ones((H, W), np.float32)
    mask[:, :W // 2] = 0.0
    return {"rgb": pano["rgb"].numpy(),
            "distance": pano["distance"].numpy().reshape(H, W) * 1.1,
            "normal": pano["normal"].numpy(), "mask": mask}


def _sl1_mean(err, beta, weights):
    d = jnp.abs(err)
    sl1 = jnp.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)
    return jnp.sum(sl1 * weights) / jnp.sum(weights)


def _tv(bias, beta):
    return (j_smooth_l1(bias[:, 1:], bias[:, :-1], beta=beta)
            + j_smooth_l1(bias[:, :, 1:], bias[:, :, :-1], beta=beta))


def _jax_inv_loss(img, ref_distance, mask):
    """JAX's distance-fusion loss (``perf_tpu/priors/pano_fusion.py:120-140``),
    stated here because the package keeps it inside its step closure."""
    dirs, ratios, tos, downs, rights, _ = j_views(GEN)
    views = j_pano_sample(jnp.asarray(img), j_dir_to_img(dirs))
    pred = jnp.clip(JFakeDepth(scale_jitter=0.2).predict_depth(
        views, dirs=dirs), 0.0, None)
    pred = (pred / (jnp.mean(pred, axis=(1, 2, 3), keepdims=True)
                    + 1e-5))[..., 0]
    coords, masks = j_proj((H, W), tos, downs, rights)
    weights = masks * j_dw(H, W)[None, ..., None]
    sample_view = jax.vmap(lambda im, c: j_bilinear(im, c, "border"))

    def loss_fn(p, all_phase):
        pano_d = jax.nn.softplus(p["pano"]) + 1e-3
        pano_d = pano_d * mask + ref_distance * (1.0 - mask)
        scales = jax.nn.softplus(p["scale"])
        bias = p["bias"] if all_phase else jnp.zeros_like(p["bias"])
        pd = jnp.clip((pred + bias) * ratios[..., 0] * scales[:, None, None],
                      1e-5, None)
        proj = sample_view(pd[..., None], coords)
        err = (proj - pano_d[None, ..., None]) * masks
        reg = (jnp.mean(scales) - 1.0) ** 2
        return (_sl1_mean(err, 1e-1, weights) + _tv(p["bias"], 1e-1) * 5.0
                + reg * 1e-2)
    return loss_fn


def _jax_normal_loss(img, ref_normal, mask):
    """JAX's normal-fusion loss (``perf_tpu/priors/pano_fusion.py:215-235``)."""
    dirs, _, tos, downs, rights, c2w = j_views(GEN)
    views = j_pano_sample(jnp.asarray(img), j_dir_to_img(dirs))
    pred = JFakeNormal().predict_normal(views, dirs=dirs, c2w=c2w) * 2.0 - 1.0
    pred = pred / jnp.linalg.norm(pred, axis=-1, keepdims=True)
    pred = jnp.einsum("vij,vhwj->vhwi", c2w, pred)
    coords, masks = j_proj((H, W), tos, downs, rights)
    weights = masks * j_dw(H, W)[None, ..., None]
    sample_view = jax.vmap(lambda im, c: j_bilinear(im, c, "border"))
    mask = mask[..., None]

    def loss_fn(p, all_phase):
        pano_n = p["pano"] * mask + ref_normal * (1.0 - mask)
        pano_norm = jnp.linalg.norm(pano_n, axis=-1, keepdims=True)
        pano_n = pano_n / pano_norm
        bias = p["bias"] if all_phase else jnp.zeros_like(p["bias"])
        pn = pred + bias
        pn_norm = jnp.linalg.norm(pn, axis=-1, keepdims=True)
        pn = pn / pn_norm
        proj = sample_view(pn, coords)
        err = (proj - pano_n[None]) * masks
        reg = (jnp.mean((pano_norm - 1.0) ** 2)
               + jnp.mean((pn_norm - 1.0) ** 2))
        return (_sl1_mean(err, 0.5, weights) + _tv(p["bias"], 0.5) * 1.0
                + reg * 1e-2)
    return loss_fn


def _check_phases(problem, jax_loss, perturb):
    """The loss and every gradient of both phases: the first at the initial
    parameters, the second at ``perturb(initial)`` (seeded, so that the
    bias maps and scales are not at their start)."""
    params, loss_fn, _ = problem
    rng = np.random.default_rng(3)
    for all_phase in (False, True):
        if all_phase:
            params = {k: _t(v) for k, v in perturb(
                {k: v.numpy() for k, v in params.items()}, rng).items()}
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in params.values()]
        p = dict(zip(params, leaves))
        loss = loss_fn(p, all_phase)
        grads = torch.autograd.grad(loss, leaves)
        jp = {k: jnp.asarray(v.detach().numpy()) for k, v in params.items()}
        l_ref, g_ref = jax.value_and_grad(jax_loss)(jp, all_phase)
        # float32 sums in another order through the sampler and the means
        assert abs(float(loss) - float(l_ref)) <= 1e-5 * abs(float(l_ref))
        for name, g in zip(params, grads):
            assert _rel(g.numpy(), g_ref[name]) < 1e-4, (
                all_phase, name, _rel(g.numpy(), g_ref[name]))


def test_inv_predictor_phases_match_jax(scene):
    pred = PanoFusionInvPredictor(FakeCubeRoomDepthPredictor(scale_jitter=0.2),
                                  PanoFusionConfig(gen_res=GEN, iters=4,
                                                   scan_chunk=1), device="cpu")
    problem = pred.problem(scene["rgb"], scene["distance"], scene["mask"])

    def perturb(p, rng):
        return {"scale": rng.uniform(-0.3, 0.3, p["scale"].shape),
                "bias": rng.normal(0, 0.05, p["bias"].shape),
                "pano": rng.normal(0, 0.3, p["pano"].shape)}
    _check_phases(problem, _jax_inv_loss(scene["rgb"], scene["distance"],
                                         scene["mask"]), perturb)


def test_normal_predictor_phases_match_jax(scene):
    pred = PanoFusionNormalPredictor(FakeCubeRoomNormalPredictor(),
                                     PanoFusionConfig(gen_res=GEN, iters=4,
                                                      scan_chunk=1),
                                     device="cpu")
    problem = pred.problem(scene["rgb"], scene["normal"], scene["mask"])

    def perturb(p, rng):
        return {"bias": rng.normal(0, 0.05, p["bias"].shape),
                "pano": p["pano"] + rng.normal(0, 0.1, p["pano"].shape)}
    _check_phases(problem, _jax_normal_loss(scene["rgb"], scene["normal"],
                                            scene["mask"]), perturb)


def test_predictors_match_jax(scene):
    """Both predictors whole, two steps of each phase (``iters`` 4, one step
    a chunk in JAX), against JAX's."""
    cfg = dict(gen_res=GEN, iters=4, scan_chunk=1)
    args = (scene["rgb"], scene["distance"], scene["mask"])
    jdist, _ = JInv(JFakeDepth(scale_jitter=0.2),
                    JFusionCfg(**cfg)).inpaint_distance(*args)
    dist, none = PanoFusionInvPredictor(
        FakeCubeRoomDepthPredictor(scale_jitter=0.2), PanoFusionConfig(**cfg),
        device="cpu").inpaint_distance(*args)
    assert none is None and dist.shape == (H, W)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5,
                               atol=1e-6)
    args = (scene["rgb"], scene["normal"], scene["mask"])
    jnormal = JNormal(JFakeNormal(), JFusionCfg(**cfg)).inpaint_normal(*args)
    normal = PanoFusionNormalPredictor(
        FakeCubeRoomNormalPredictor(), PanoFusionConfig(**cfg),
        device="cpu").inpaint_normal(*args)
    assert normal.shape == (H, W, 3)
    # unit-scale components moved by Adam at 0.2: gradients that differ in
    # their last float32 bits move them by a few 1e-6
    np.testing.assert_allclose(normal.numpy(), np.asarray(jnormal),
                               rtol=1e-5, atol=1e-5)
