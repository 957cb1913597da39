"""Port vs ``perf_tpu``: the proposal estimator's training (``PropNeRFScene``).

One geometry + proposal step and one appearance step against
``jax.value_and_grad`` of JAX's own loss (``render_rays_prop``,
``prop_loss``, ``smooth_l1``) with JAX's draws (batch indices, jitter,
per-level u, background, noise) on small configs (2-level proposal fields,
a 2-level hash field: XLA's CPU compile of a step grows with the hash
levels; one jitted forward with a VJP per phase), each step's Adam updates
against optax's chains. The port runs on CPU tensors (the plain versions).
The contract of ``tests/test_prop_scene.py:43`` is in
``test_torch_prop_fit.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from perf_tpu.fields.ngp import NGPDensityFieldConfig as JDensity
from perf_tpu.render import prop as JP
from perf_tpu.train.schedule import lr_at as j_lr_at
from perf_tpu.train.schedule import smooth_l1 as j_smooth_l1

from perf_tpu_torch.convert import params_from_jax, prop_params_from_jax
from perf_tpu_torch.core import GuardedAdam
from perf_tpu_torch.fields import NGPDensityFieldConfig
from perf_tpu_torch.render.prop import PropRenderConfig
from perf_tpu_torch.train import TrainConfig
from perf_tpu_torch.train import prop_scene as PS
from perf_tpu_torch.utils import random_field_params

from test_torch_common import cube_room_pools, hash_fields
from test_torch_prop import SMALL, jax_draws, random_density_field

# res 4 (dense) and 10 (hashed) in 1024 rows
STEP_GRID = dict(n_levels=2, n_features=2, log2_table_size=10, base_res=4,
                 per_level_scale=2.5)
SAMPLES = dict(n_samples=32, n_samples_per_prop=(64, 32))
PROGRESS = 0.3


@pytest.fixture(autouse=True)
def one_thread():
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
def setup():
    """The JAX pool of the 32x64 cube room, a 2-level hash field, two
    2-level proposal fields, a batch drawn as JAX's _sample_batch draws it,
    and the render key."""
    _, jp, _ = cube_room_pools()
    arrs = jp.device_arrays()
    jfield, tfield = hash_fields(**STEP_GRID)
    params = random_field_params(3, tfield, table_scale=0.2, density_gain=6.0)
    pcfgs = [NGPDensityFieldConfig(**SMALL)] * 2
    props = [random_density_field(s, c) for s, c in zip((5, 6), pcfgs)]
    key = jax.random.PRNGKey(21)
    k_idx, k_render = jax.random.split(key)
    b = 128
    u = jax.random.uniform(k_idx, (b,))
    idx = np.asarray(jnp.minimum((u * arrs["n_valid"]).astype(jnp.int32),
                                 arrs["n_valid"] - 1))
    t_arrs = {k: (_t(v) if k != "n_valid" else int(v))
              for k, v in arrs.items()}
    batch = PS.pool_batch(t_arrs, _t(u))
    np.testing.assert_array_equal(batch[0].numpy(),
                                  np.asarray(arrs["rays_o"])[idx])
    jbatch = [np.asarray(arrs[k])[idx] for k in ("rays_o", "rays_d", "colors",
                                                 "distances")]
    return dict(jfield=jfield, tfield=tfield, params=params, pcfgs=pcfgs,
                props=props, key=k_render, batch=batch, jbatch=jbatch, b=b)


def _port_state(s):
    p = params_from_jax(s["params"])
    props = prop_params_from_jax(s["props"], s["pcfgs"])
    return p, props


@pytest.fixture(scope="module")
def jax_steps(setup):
    """JAX's loss, aux and gradients of both phases, as prop_scene.py's
    geo_step and app_step write them, at the same parameters and draws:
    one forward and one VJP per phase, in one jitted function."""
    s = setup
    jcfg = JP.PropRenderConfig(**SAMPLES)
    jpcfgs = [JDensity(**SMALL)] * 2
    o, d, col, dist = (jnp.asarray(a) for a in s["jbatch"])
    p = jax.tree_util.tree_map(jnp.asarray, s["params"])
    props = jax.tree_util.tree_map(jnp.asarray, s["props"])

    def losses(geo, pr, app):
        out = JP.render_rays_prop({"geo": geo, "app": app}, pr, s["jfield"],
                                  jpcfgs, o, d, s["key"], jcfg, train=True)
        depth_l = j_smooth_l1(out["distance"], dist, beta=1e-2)
        p_l = JP.prop_loss(out["t_edges"], out["weights"], out["prop_aux"])
        color_l = j_smooth_l1(out["rgb"], col, beta=5e-2)
        return depth_l * 1.0 + p_l, color_l * 1.0, depth_l, p_l, color_l

    @jax.jit
    def both(geo, pr, app):
        vals, vjp = jax.vjp(losses, geo, pr, app)
        one, zero = jnp.ones((), jnp.float32), jnp.zeros((), jnp.float32)
        g_geo, g_prop, _ = vjp((one, zero, zero, zero, zero))
        _, _, g_app = vjp((zero, one, zero, zero, zero))
        return vals, g_geo, g_prop, g_app
    vals, g_geo, g_prop, g_app = both(p["geo"], props, p["app"])
    geo_loss, app_loss, depth_l, p_l, color_l = (float(v) for v in vals)
    return {"geo": (geo_loss, (depth_l, p_l), (g_geo, g_prop)),
            "app": (app_loss, (color_l,), (g_app,))}


def _jleaves(head) -> list:
    """A head's leaves in the port's order (table, then MLP weights)."""
    return [np.asarray(head["table"])] + [np.asarray(w)
                                          for w in head["mlp"]["w"]]


def _optax_new(tx, params, grads, lr):
    """params - lr * the first update of ``tx`` from a fresh state."""
    upd, _ = tx.update(grads, tx.init(params), params)
    return jax.tree_util.tree_map(lambda q, u: np.asarray(q - lr * u),
                                  params, upd)


def test_geo_prop_step_matches_jax(setup, jax_steps):
    """The geometry + proposal step: loss, depth and proposal loss within
    1e-5 relative of JAX's, the gradients of the geometry head and both
    proposal fields each < 1e-3 relative norm (the tolerances of
    test_torch_hash_train.py); then ``geo_prop_step`` commits optax's
    scale_by_adam on the geometry and chain(add_decayed_weights(1e-6),
    scale_by_adam(0.9, 0.99, eps 1e-15)) on the proposals, on the port's
    gradients, within 2e-6 relative + 1e-7 absolute, at the schedules'
    learning rates."""
    s = setup
    loss, (depth_l, p_l), (g_geo, g_prop) = jax_steps["geo"]
    p, props = _port_state(s)
    o, d, _, dist = s["batch"]
    draws = jax_draws(s["key"], s["b"], 2)
    cfg = PropRenderConfig(**SAMPLES)
    leaves = PS.leaves(p["geo"]) + PS.prop_leaves(props)
    for t in leaves:
        t.requires_grad_(True)
    t_loss, t_depth, t_prop = PS.geo_prop_loss(
        p["geo"], props, p["app"], s["tfield"], s["pcfgs"], cfg, o, d, dist,
        draws, 1.0)
    for got, want in ((t_loss, loss), (t_depth, depth_l), (t_prop, p_l)):
        assert abs(got.item() - want) <= 1e-5 * abs(want), (got, want)
    assert p_l > 0
    grads = torch.autograd.grad(t_loss, leaves)
    want_grads = _jleaves(g_geo) + [g for gp in g_prop for g in _jleaves(gp)]
    for got, want in zip(grads, want_grads):
        assert _rel(got, want) < 1e-3

    # the step itself, from fresh optimizer states, on the same draws
    tc = TrainConfig()
    ng = len(PS.leaves(p["geo"]))
    before = [t.detach().clone() for t in leaves]
    row, lr = PS.geo_prop_step(p["geo"], props, p["app"],
                               GuardedAdam(leaves[:ng]),
                               PS.PropAdam(leaves[ng:]), s["tfield"],
                               s["pcfgs"], cfg, tc, (o, d, dist), draws,
                               PROGRESS)
    assert row[-1].item() == 1.0 and abs(row[0].item() - loss) <= 1e-5 * loss
    lr_g = float(j_lr_at(jnp.float32(PROGRESS), tc.geo_optimizer))
    lr_p = float(j_lr_at(jnp.float32(PROGRESS), tc.prop_optimizer))
    assert abs(lr - lr_g) <= 1e-7 * lr_g
    j_before = [jnp.asarray(t.numpy()) for t in before]
    j_grads = [jnp.asarray(g.numpy()) for g in grads]
    want = (_optax_new(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                       j_before[:ng], j_grads[:ng], lr_g)
            + _optax_new(optax.chain(optax.add_decayed_weights(1e-6),
                                     optax.scale_by_adam(b1=0.9, b2=0.99,
                                                         eps=1e-15)),
                         j_before[ng:], j_grads[ng:], lr_p))
    for t, b, w in zip(leaves, before, want):
        got_upd = (t.detach().numpy() - b.numpy()).astype(np.float64)
        want_upd = w.astype(np.float64) - b.numpy()
        np.testing.assert_allclose(got_upd, want_upd, rtol=2e-6, atol=1e-7)


def test_app_step_matches_jax(setup, jax_steps):
    """The appearance step on frozen geometry and proposals: loss within
    1e-5 relative, the appearance gradients < 1e-3 relative norm; the
    committed step is optax's scale_by_adam on the port's gradients within
    2e-6 relative + 1e-7 absolute."""
    s = setup
    loss, (color_l,), (g_app,) = jax_steps["app"]
    p, props = _port_state(s)
    o, d, col, _ = s["batch"]
    draws = jax_draws(s["key"], s["b"], 2)
    cfg = PropRenderConfig(**SAMPLES)
    leaves = PS.leaves(p["app"])
    for t in leaves:
        t.requires_grad_(True)
    t_loss, t_col = PS.app_loss(p["app"], p["geo"], props, s["tfield"],
                                s["pcfgs"], cfg, o, d, col, draws, 1.0)
    assert abs(t_loss.item() - loss) <= 1e-5 * loss
    assert abs(t_col.item() - color_l) <= 1e-5 * color_l
    grads = torch.autograd.grad(t_loss, leaves)
    for got, want in zip(grads, _jleaves(g_app)):
        assert _rel(got, want) < 1e-3
    tc = TrainConfig()
    before = [t.detach().clone() for t in leaves]
    row, lr = PS.app_step(p["app"], p["geo"], props, GuardedAdam(leaves),
                          s["tfield"], s["pcfgs"], cfg, tc, (o, d, col),
                          draws, PROGRESS)
    assert row[-1].item() == 1.0
    want = _optax_new(optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8),
                      [jnp.asarray(t.numpy()) for t in before],
                      [jnp.asarray(g.numpy()) for g in grads], lr)
    for t, b, w in zip(leaves, before, want):
        np.testing.assert_allclose(
            (t.detach().numpy() - b.numpy()).astype(np.float64),
            w.astype(np.float64) - b.numpy(), rtol=2e-6, atol=1e-7)
