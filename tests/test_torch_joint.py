"""Port vs ``perf_tpu``: the joint predictor's distillation.

One distillation step of each phase with JAX's own draws (the field's
init, the per-step coords and tangent draws) against
``jax.value_and_grad`` of JAX's loss, the port's three-group Adam update
against optax, and the golden bar of ``tests/test_sphere_analytic.py``
through the port. CPU tensors: the ``bilinear`` and ``brick_encode_grad``
wrappers take their plain versions. A 6-level sphere field, 24-32 pixel
views, 32x64 panos.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import perf_tpu.core as JC
from perf_tpu.fields.sphere_field import (
    SphereFieldConfig as JSphere, init_sphere_field as j_init_sphere,
    sphere_field_distance_and_grad as j_sphere_dg)
from perf_tpu.priors import (FakeCubeRoomDepthPredictor as JFakeDepth,
                             FakeCubeRoomNormalPredictor as JFakeNormal,
                             JointPredictorConfig as JJointCfg,
                             PanoJointPredictor as JJoint)
from perf_tpu.priors.pano_joint import (
    normal_projection_errors as j_npe, smooth_l1_none as j_sl1_none)
from perf_tpu.train.schedule import smooth_l1 as j_smooth_l1
from perf_tpu.utils import render_cube_room_pano as j_room

from perf_tpu_torch.convert import sphere_field_from_jax
from perf_tpu_torch.fields import SphereFieldConfig
from perf_tpu_torch.priors import (FakeCubeRoomDepthPredictor,
                                   FakeCubeRoomNormalPredictor,
                                   JointPredictorConfig, PanoJointPredictor)
from perf_tpu_torch.priors.pano_joint import _Distill

from test_torch_anchor import H, SPHERE, W, _rel, _t, one_thread, room  # noqa: F401

# -- the distillation -------------------------------------------------------------

class JaxDraws:
    """The draws of a JAX ``PanoJointPredictor`` built with ``seed``, in its
    order: the field's init key, then the distillation key (three-way
    split per step), then the readback's normal key."""

    def __init__(self, seed: int, jcfg):
        self.key, self.jcfg = jax.random.PRNGKey(seed), jcfg
        self.jax_sp = None

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def sphere_init(self, cfg, device):
        self.jax_sp = j_init_sphere(self._next(), self.jcfg)
        self.step_key = self._next()
        return sphere_field_from_jax(self.jax_sp, device)

    def step(self, n_views, batch):
        self.step_key, kc, ko = jax.random.split(self.step_key, 3)
        return (_t(jax.random.uniform(kc, (n_views, batch, 2))),
                _t(jax.random.normal(ko, (n_views, batch, 3))))

    def normal(self, shape):
        return _t(jax.random.normal(self._next(), shape))


JOINT = dict(gen_res=24, ratios=(1.1,), local_batch=32, iters_per_phase=4,
             normal_bias_res=16)


def _jax_loss_fn(cfg, data, wts):
    """JAX's distillation loss (``perf_tpu/priors/pano_joint.py:258-327``),
    stated here because the package keeps it inside its step closure. The
    phase is a traced 0 / 1 factor on the TV terms (one compile for both
    phases; 0 * tv adds exact zeros to the loss and its gradient)."""
    sample_view = jax.vmap(lambda im, c: JC.bilinear_sample(im, c, "border"))

    def loss_fn(p, coords, k_ortho, progress, hybrid):
        cur_dirs = sample_view(data["dirs"], coords)
        cur_dirs = cur_dirs / jnp.linalg.norm(cur_dirs, axis=-1, keepdims=True)
        cur_dist = sample_view(data["pred_dist"][..., None], coords)[..., 0]
        cur_norm = sample_view(data["pred_n"], coords)
        d_bias = sample_view(p["bias_ld"][..., None], coords)[..., 0]
        n_bias = sample_view(p["bias_ln"], coords)
        ref_d = cur_dist * jax.nn.softplus(p["scale"])[:, None] + d_bias
        ref_nrm = cur_norm + n_bias
        ref_nrm = ref_nrm / jnp.linalg.norm(ref_nrm, axis=-1, keepdims=True)
        flat_dirs = cur_dirs.reshape(-1, 3)
        pd, pg = j_sphere_dg(p["sp"], flat_dirs, cfg.field)
        pd = pd.reshape(coords.shape[0], cfg.local_batch)
        pg = pg.reshape(coords.shape[0], cfg.local_batch, 3)
        distance_loss = j_smooth_l1(ref_d, pd, beta=0.5)
        errors = j_npe(cur_dirs, pg, ref_nrm, k_ortho)
        normal_loss = j_smooth_l1(errors, jnp.zeros_like(errors), beta=0.5)
        reg_loss = (jnp.mean(jax.nn.softplus(p["scale"])) - 1.0) ** 2
        ld, ln = p["bias_ld"], p["bias_ln"]
        tv_d = (j_smooth_l1(ld[:, 1:], ld[:, :-1], beta=1e-2)
                + j_smooth_l1(ld[:, :, 1:], ld[:, :, :-1], beta=1e-2)) * hybrid
        tv_n = (j_smooth_l1(ln[:, 1:], ln[:, :-1], beta=1e-2)
                + j_smooth_l1(ln[:, :, 1:], ln[:, :, :-1], beta=1e-2)) * hybrid
        pano_coords = JC.direction_to_img_coord(flat_dirs)
        s_ref = JC.bilinear_sample(data["ref_distance"], pano_coords)[..., 0]
        s_mask = JC.bilinear_sample(data["mask"], pano_coords)[..., 0]
        ref_loss = jnp.mean(j_sl1_none(s_ref, pd.reshape(-1), beta=1e-2)
                            * (s_mask < 0.5))
        return (ref_loss * 20.0 * progress + distance_loss + reg_loss * wts[0]
                + normal_loss * wts[1] + tv_d * 1.0 + tv_n * wts[2])
    return loss_fn


def check_distill_steps(jfield, field, room, jit: bool = True):
    """One step of each phase with JAX's draws on the sphere field ``jfield``
    (JAX) / ``field`` (port): the loss and the gradients of all three
    groups against jax.value_and_grad of JAX's loss; then the port's update
    of the three Adam groups against optax's. The same set-up in both
    packages: JAX's views, priors and initial parameters (with JAX's
    draws), a reference distance with a known half (mask 0 on the left).
    ``jit=False`` runs JAX's loss eagerly (cheaper than an XLA compile of a
    second-order loss for two calls)."""
    jcfg = JJointCfg(**JOINT, field=jfield)
    cfg = JointPredictorConfig(**JOINT, field=field)
    jpred = JJoint(JFakeDepth(), JFakeNormal(), jcfg, seed=3)
    draws = JaxDraws(3, jcfg.field)
    pred = PanoJointPredictor(FakeCubeRoomDepthPredictor(),
                              FakeCubeRoomNormalPredictor(), cfg, seed=3,
                              draws=draws)
    mask = np.ones((H, W, 1), np.float32)
    mask[:, :W // 2] = 0.0
    img = room["rgb"]
    ref_d = room["distance"] * 1.1
    jdirs, jratios, jc2w, jviews = jpred._make_views(jnp.asarray(img))
    dirs, ratios, c2w, views = pred._make_views(_t(img))
    np.testing.assert_array_equal(dirs.numpy(), jdirs)
    np.testing.assert_allclose(views.numpy(), jviews, atol=2e-6)
    # the priors (test_torch_anchor holds them against JAX's), the same
    # arrays handed to both losses
    pd = FakeCubeRoomDepthPredictor().predict_depth(views, dirs=dirs)
    pd = pd / (torch.mean(pd, dim=(1, 2, 3), keepdim=True) + 1e-5)
    pdist = (pd * ratios)[..., 0].numpy()
    pn = FakeCubeRoomNormalPredictor().predict_normal(
        views, dirs=dirs, c2w=c2w) * 2 - 1
    pn = pn / torch.linalg.norm(pn, dim=-1, keepdim=True)
    pn = torch.einsum("vij,vhwj->vhwi", c2w, pn).numpy()
    jdata = {"dirs": jdirs, "pred_dist": pdist, "pred_n": pn,
             "ref_distance": jnp.asarray(ref_d), "mask": jnp.asarray(mask)}
    n_views = jdirs.shape[0]
    rng = np.random.default_rng(7)
    sp0 = draws.sphere_init(cfg.field, "cpu")
    jparams = {"scale": jnp.asarray(rng.uniform(-0.3, 0.3, n_views),
                                    jnp.float32),
               "bias_ld": jnp.asarray(rng.normal(0, 0.02, (n_views, 24, 24)),
                                      jnp.float32),
               "bias_ln": jnp.asarray(rng.normal(0, 0.02, (n_views, 16, 16, 3)),
                                      jnp.float32),
               "sp": draws.jax_sp}
    params = {"scale": _t(jparams["scale"]), "bias_ld": _t(jparams["bias_ld"]),
              "bias_ln": _t(jparams["bias_ln"]), "sp": sp0}
    data = {"views": torch.cat([_t(jdirs), _t(pdist)[..., None], _t(pn)],
                               -1).contiguous(),
            "ref": torch.cat([_t(ref_d), _t(mask)], -1).contiguous()}
    wts = [float(np.float32(v)) for v in (0.0, 5e-2, 5e-2)]
    d = _Distill(pred, params, data, wts)
    adam = optax.scale_by_adam(eps=1e-8)
    adam_update = jax.jit(adam.update)
    ostate = {k: adam.init([jnp.asarray(t.detach().numpy()) for t in v])
              for k, v in d.groups.items()}
    key = draws.step_key
    value_and_grad = jax.value_and_grad(_jax_loss_fn(
        jcfg, jdata, jnp.asarray(wts, jnp.float32)))
    if jit:
        value_and_grad = jax.jit(value_and_grad)
    mlp_keys = ("v", "g", "b") if "v" in sp0["mlp"] else ("w", "b")
    n_mlp = sum(len(sp0["mlp"][k]) for k in mlp_keys)
    names = (["scale", "table"]
             + [f"{k}{i}" for k in mlp_keys for i in range(len(sp0["mlp"][k]))]
             + ["bias_ld", "bias_ln"])
    for i, hybrid in ((1, False), (cfg.iters_per_phase + 1, True)):
        key, kc, ko = jax.random.split(key, 3)
        coords = jax.random.uniform(kc, (n_views, cfg.local_batch, 2))
        step_draws = (_t(coords), _t(jax.random.normal(
            ko, (n_views, cfg.local_batch, 3))))
        progress = jnp.float32(i) / (2.0 * cfg.iters_per_phase)
        l_ref, g_ref = value_and_grad(jparams, coords, ko, progress,
                                      jnp.float32(hybrid))
        loss, _, grads = d.grads(i, hybrid, step_draws)
        loss = loss.detach()
        # float32 sums in another order through the field and the samplers
        assert abs(float(loss) - float(l_ref)) <= 1e-5 * abs(float(l_ref))
        j_leaves = ([g_ref["scale"], g_ref["sp"]["table"],
                     *(g for k in mlp_keys for g in g_ref["sp"]["mlp"][k]),
                     g_ref["bias_ld"], g_ref["bias_ln"]])
        assert len(grads) == len(j_leaves) == len(names)
        for name, a, b in zip(names, grads, j_leaves):
            # relative norm per parameter; bf16-rounded table rows flip at
            # ties when the float32 cotangents differ by an ulp (bound 1e-3)
            assert _rel(a.numpy(), b) < 1e-3, (hybrid, name, _rel(a, b))
        # the port's step (three Adam groups, the local one only in the
        # second phase, the cosine ratio) against optax's scale_by_adam with
        # JAX's learning-rate arithmetic, on the port's own gradients
        before = [t.detach().clone() for t in d.leaves]
        d.step(i, hybrid, step_draws)
        ratio = ((jnp.cos(progress * jnp.pi) + 1.0) * (1.0 - cfg.lr_alpha)
                 + cfg.lr_alpha)
        k = 0
        for name, n_leaves, lr in (("global", 1, cfg.init_lr),
                                   ("sp", 1 + n_mlp, cfg.init_lr_sp),
                                   ("local", 2, cfg.init_lr_local)):
            g = [jnp.asarray(x.numpy()) for x in grads[k:k + n_leaves]]
            old = before[k:k + n_leaves]
            if name == "local" and not hybrid:
                new = old
            else:
                up, ostate[name] = adam_update(g, ostate[name])
                new = [jnp.asarray(o.numpy()) - lr * ratio * u
                       for o, u in zip(old, up)]
            for a, b in zip(d.leaves[k:k + n_leaves], new):
                # an ulp or two: XLA fuses the update's float32 arithmetic
                np.testing.assert_allclose(a.detach().numpy(), b, rtol=2e-6,
                                           atol=1e-7, err_msg=name)
            k += n_leaves
        jparams = {"scale": jnp.asarray(params["scale"].detach().numpy()),
                   "bias_ld": jnp.asarray(params["bias_ld"].detach().numpy()),
                   "bias_ln": jnp.asarray(params["bias_ln"].detach().numpy()),
                   "sp": jax.tree_util.tree_map(
                       lambda t: jnp.asarray(t.detach().numpy()),
                       params["sp"])}


def test_distill_step_of_each_phase_matches_jax(room):
    """One step of each phase with JAX's draws on the flagship field
    (brick + analytic) against jax.value_and_grad; the three Adam groups
    against optax."""
    check_distill_steps(
        JSphere(**SPHERE, encoding="brick", grad_mode="analytic"),
        SphereFieldConfig(**SPHERE, encoding="brick", grad_mode="analytic"),
        room)


def test_joint_predictor_recovers_the_room(room):
    """``test_sphere_analytic.py``'s golden bar through the port: 200 + 200
    distillation steps from the fake priors, median relative distance
    error < 0.15, unit normals."""
    cfg = JointPredictorConfig(gen_res=32, ratios=(1.1,), local_batch=64,
                               iters_per_phase=200, normal_bias_res=16,
                               field=SphereFieldConfig(
                                   **SPHERE, encoding="brick",
                                   grad_mode="analytic"))
    pred = PanoJointPredictor(FakeCubeRoomDepthPredictor(),
                              FakeCubeRoomNormalPredictor(), cfg)
    dist, normal = pred(_t(room["rgb"]), torch.ones(H, W, 1),
                        torch.ones(H, W))
    gt = room["distance"]
    dn = dist.numpy()
    rel = np.abs(dn / dn.mean() - gt / gt.mean()) / (gt / gt.mean())
    assert np.median(rel) < 0.15, np.median(rel)
    np.testing.assert_allclose(np.linalg.norm(normal.numpy(), axis=-1), 1.0,
                               atol=1e-4)


