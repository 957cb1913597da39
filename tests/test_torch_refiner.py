"""Port vs ``perf_tpu``: the geometry refiner (``PanoGeoRefiner``), step
by step.

With JAX's own draws (the field's init, each step's directions and tangent
draw, the readback's normal draw) in the three field variants the JAX
package runs (the reference-parity hash + ``ad``, the brick + ``fd`` of
``tests/test_priors.py:124``, the flagship brick + analytic): two steps'
loss and gradients against ``jax.value_and_grad`` of JAX's loss, the port's
guarded Adam update at the half-cosine learning rate against optax, and
the readback (distance and normals) of the field those steps made against
JAX's readback arithmetic (``check_refiner_steps``; the hash + ``ad``
variant in ``test_torch_refiner_hash.py``). ``test_torch_refiner_collapse.py``
holds the whole ``refine`` to JAX's. CPU tensors: the ``bilinear``, hash and brick
encode wrappers take their plain versions. A 16x32 room, 2-3 levels, 256
directions a step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perf_tpu.core import bilinear_sample as j_bilinear
from perf_tpu.core import direction_to_img_coord as j_dir_to_img
from perf_tpu.core import img_coord_from_hw as j_img_coord_from_hw
from perf_tpu.core import img_coord_to_pano_direction as j_pano_dir
from perf_tpu.fields.sphere_field import (
    SphereFieldConfig as JSphere, grads_to_normal as j_grads_to_normal,
    init_sphere_field as j_init_sphere,
    sphere_field_distance_and_grad as j_sphere_dg)
from perf_tpu.priors.pano_joint import normal_projection_errors as j_npe
from perf_tpu.priors.pano_refiner import RefinerConfig as JRefinerCfg
from perf_tpu.train.schedule import smooth_l1 as j_smooth_l1

from perf_tpu_torch.convert import sphere_field_from_jax
from perf_tpu_torch.core import GuardedAdam
from perf_tpu_torch.fields import SphereFieldConfig
from perf_tpu_torch.priors import PanoGeoRefiner, RefinerConfig
from perf_tpu_torch.priors.pano_joint import _sp_leaves, field_readback
from perf_tpu_torch.utils import render_cube_room_pano

from test_torch_anchor import _rel, _t, one_thread  # noqa: F401

H, W = 16, 32
BATCH = 256

# the variants of JAX's tests/test_priors.py:107-135 and the refiner's own
# default, cut to 2-4 levels (XLA's compile of the second-order hash step
# grows with every level); res 16 / 32 (/ 64): level 0 dense, the rest
# hashed for the hash grid
VARIANTS = {
    "hash_ad": dict(n_levels=2, log2_table_size=12, fine_res=32,
                    encoding="hash", grad_mode="ad"),
    "brick_fd": dict(n_levels=3, log2_table_size=12, fine_res=64,
                     encoding="brick", grad_mode="fd"),
    "brick_analytic": dict(n_levels=3, log2_table_size=12, fine_res=64,
                           encoding="brick", grad_mode="analytic"),
}


class JaxRefinerDraws:
    """The draws of a JAX ``PanoGeoRefiner`` built with ``seed``, in its
    order: the field's init key, the distillation key (three-way split per
    step: directions, tangent draw), then the readback's normal key."""

    def __init__(self, seed: int, jcfg: JSphere):
        self.key, self.jcfg = jax.random.PRNGKey(seed), jcfg

    def _next(self):
        self.key, k = jax.random.split(self.key)
        return k

    def sphere_init(self, cfg, device):
        self.jax_sp = j_init_sphere(self._next(), self.jcfg)
        self.step_key = self._next()
        return sphere_field_from_jax(self.jax_sp, device)

    def directions(self, batch):
        self.step_key, kd, ko = jax.random.split(self.step_key, 3)
        self.last = (jax.random.normal(kd, (batch, 3)), ko)
        return _t(self.last[0]), _t(jax.random.normal(ko, (batch, 3)))

    def normal(self, shape):
        self.normal_key = self._next()
        return _t(jax.random.normal(self.normal_key, shape))


def _configs(variant: str, n_iters: int):
    kw = dict(VARIANTS[variant], weight_norm=True, output="raw")
    run = dict(n_iters=n_iters, batch_size=BATCH, scan_chunk=1)
    return (JRefinerCfg(**run, field=JSphere(**kw)),
            RefinerConfig(**run, field=SphereFieldConfig(**kw)))


@pytest.fixture(scope="module")
def maps():
    """The cube room's distance [H, W, 1] and normal maps, as numpy (the
    port's; test_torch_anchor holds them against JAX's)."""
    pano = render_cube_room_pano(torch.eye(4), H, W)
    return (pano["distance"].numpy().reshape(H, W, 1),
            pano["normal"].numpy())


def _jax_loss_fn(jcfg, distances, normals):
    """JAX's refiner loss (``perf_tpu/priors/pano_refiner.py:79-84``),
    stated here because the package keeps it inside its step closure."""

    def loss_fn(p, dirs, k_ortho):
        coords = j_dir_to_img(dirs)
        ref_d = j_bilinear(distances, coords)[..., 0]
        ref_n = j_bilinear(normals, coords)
        pd, pg = j_sphere_dg(p, dirs, jcfg.field)
        d_loss = j_smooth_l1(ref_d, pd, beta=1e-2)
        errors = j_npe(dirs, pg, ref_n, k_ortho)
        n_loss = j_smooth_l1(errors, jnp.zeros_like(errors), beta=0.5)
        return d_loss + n_loss * jcfg.normal_loss_weight
    return loss_fn


@functools.partial(jax.jit, static_argnums=0)
def _jax_readback(jcfg, params, key):
    """JAX's readback arithmetic (``perf_tpu/priors/pano_refiner.py:147-165``,
    one chunk) at every pixel of the H x W pano."""
    pano_dirs = j_pano_dir(j_img_coord_from_hw(H, W))
    dist, grad = j_sphere_dg(params, pano_dirs.reshape(-1, 3), jcfg.field)
    return dist, j_grads_to_normal(pano_dirs, grad.reshape(H, W, 3), key)


def _jax_leaves(sp: dict) -> list:
    return [sp["table"], *(t for k in ("v", "g", "b") for t in sp["mlp"][k])]


def check_refiner_steps(variant: str, maps):
    """Two distillation steps with JAX's draws: the loss and the gradient of
    every field tensor (the table, the weight-norm directions, gains and
    biases) against jax.value_and_grad of JAX's loss (second order in the
    hash + ad variant); then the port's guarded Adam step against optax's
    scale_by_adam at JAX's learning rate, on the port's own gradients; last
    the readback of the field the steps made against JAX's arithmetic
    (``perf_tpu/priors/pano_refiner.py:147-165``) with JAX's tangent
    draw."""
    jcfg, cfg = _configs(variant, n_iters=8)
    draws = JaxRefinerDraws(11, jcfg.field)
    ref = PanoGeoRefiner(cfg, device="cpu", draws=draws)
    dist_t, norm_t = _t(maps[0]), _t(maps[1])
    params = draws.sphere_init(cfg.field, "cpu")
    leaves = _sp_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    adam = GuardedAdam(leaves)
    jadam = optax.scale_by_adam(eps=1e-8)
    ostate = jadam.init([jnp.asarray(t.detach().numpy()) for t in leaves])
    value_and_grad = jax.jit(jax.value_and_grad(_jax_loss_fn(
        jcfg, jnp.asarray(maps[0]), jnp.asarray(maps[1]))))
    jparams = draws.jax_sp
    for i in range(2):
        before = [t.detach().clone() for t in leaves]
        loss, grads = ref.distill_step(params, leaves, adam, dist_t, norm_t,
                                       i)
        jdirs, k_ortho = draws.last
        jdirs = jdirs / jnp.linalg.norm(jdirs, axis=-1, keepdims=True)
        l_ref, g_ref = value_and_grad(jparams, jdirs, k_ortho)
        # float32 sums in another order through the field and the sampler
        assert abs(float(loss) - float(l_ref)) <= 1e-5 * abs(float(l_ref))
        j_leaves = _jax_leaves(g_ref)
        assert len(grads) == len(j_leaves)
        for k, (a, b) in enumerate(zip(grads, j_leaves)):
            # the table's gradient is exactly 0 at step 0 in both packages
            # (the first layer starts at 0 on the encoding's inputs)
            assert _rel(a.numpy(), b) < 1e-3, (i, k, _rel(a.numpy(), b))
        lr = np.float32(cfg.init_lr) * (
            (np.cos(np.float32(i) / np.float32(cfg.n_iters)
                    * np.float32(np.pi)) * 0.5 + 0.5) * (1.0 - cfg.lr_alpha)
            + cfg.lr_alpha)
        up, ostate = jadam.update([jnp.asarray(g.numpy()) for g in grads],
                                  ostate)
        for k, (t, old, u) in enumerate(zip(leaves, before, up)):
            # an ulp or two: XLA fuses the update's float32 arithmetic
            np.testing.assert_allclose(
                t.detach().numpy(), np.asarray(old.numpy() - lr * u),
                rtol=2e-6, atol=1e-7, err_msg=str((i, k)))
        # copies: a jnp array may share the numpy buffer of a tensor that
        # the next step updates in place
        jparams = jax.tree_util.tree_map(
            lambda t: jnp.array(t.detach().numpy(), copy=True), params)
    dist, normal = field_readback(params, cfg.field, H, W, "cpu", draws)
    jdist, jnormal = _jax_readback(jcfg, jparams, draws.normal_key)
    np.testing.assert_allclose(dist.numpy(),
                               np.asarray(jdist).reshape(H, W, 1),
                               rtol=1e-5, atol=1e-6)
    # normals from the direction gradient (fd: a difference quotient at
    # eps = 1 / fine_res, which scales the distance's rounding by fine_res)
    np.testing.assert_allclose(normal.numpy(), np.asarray(jnormal), atol=1e-4)


@pytest.mark.parametrize("variant", ["brick_fd", "brick_analytic"])
def test_refiner_steps_match_jax(variant, maps):
    """The brick variants; ``test_torch_refiner_hash.py`` runs hash + ad
    (its second-order XLA compile is a file's budget on its own)."""
    check_refiner_steps(variant, maps)
