"""Port vs ``perf_tpu``: the proposal estimator's modules (K11).

The proposal density field, the inverse-CDF resampling, the weights of a
density along a ray (with the last-sample override and its float32
cancellation), the PDF-matching loss with its gradient, and the cascade
render in training (JAX's draws) and eval on a small hash field and a small
brick field. Inputs are drawn with NumPy from a seed and handed to both
packages; JAX runs on the CPU, the port on CPU tensors (the plain
versions). Both packages compute prefix sums in XLA's CPU order, so the
CDFs are equal bitwise; ``exp`` differs by an ulp between XLA and torch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.fields.ngp import NGPDensityFieldConfig as JDensity
from perf_tpu.fields.ngp import NGPFieldConfig as JField
from perf_tpu.fields.ngp import query_density_field as j_density
from perf_tpu.kernels.brickgrid import BrickGridConfig as JGrid
from perf_tpu.render import prop as JP

from perf_tpu_torch.convert import params_from_jax, prop_params_from_jax
from perf_tpu_torch.fields import (NGPDensityFieldConfig, NGPFieldConfig,
                                   query_density_field)
from perf_tpu_torch.kernels import BrickGridConfig
from perf_tpu_torch.render import prop as TP
from perf_tpu_torch.utils import random_field_params

from test_torch_common import hash_fields, random_rays

# 2-level proposal fields (res 8 and 32; level 1 hashed into 1024 rows)
SMALL = dict(base_res=8, max_res=32, n_levels=2, log2_table_size=10)

def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def random_density_field(seed: int, cfg) -> dict:
    """A proposal field with tables far above the training init, so the
    densities vary along a ray; He-init MLP, last layer made positive."""
    rng = np.random.default_rng(seed)
    dims = [cfg.grid.out_dim, cfg.n_neurons, 1]
    ws = [(rng.standard_normal((a, b)) * np.sqrt(2.0 / a)).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    ws[-1] = np.abs(ws[-1]) * 2.0
    return {"table": rng.uniform(-1, 1, cfg.grid.table_shape).astype(
        np.float32), "mlp": {"w": ws}}


def jax_draws(key, n: int, n_levels: int) -> dict:
    """The uniforms JAX's render_rays_prop draws from ``key``, as the
    port's explicit draws."""
    k_strat, k_res, k_bg = jax.random.split(key, 3)
    us = []
    for _ in range(n_levels):
        k_res, k = jax.random.split(k_res)
        us.append(_t(jax.random.uniform(k, (n, 1))))
    return {"jitter": _t(jax.random.uniform(k_strat, (n, 1))), "u": us,
            "bg": _t(jax.random.uniform(k_bg, (n, 3))),
            "noise": _t(jax.random.uniform(jax.random.fold_in(k_bg, 1),
                                           (n, 1)))}


def _ray_weights(seed: int, n: int, m: int):
    """Sorted edges [n, m+1] over [0.01, 2] and peaked weights [n, m]."""
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.01, 2.0, (n, m + 1)), 1).astype(np.float32)
    w = (rng.random((n, m)) ** 6 * rng.uniform(0, 1, (n, 1))).astype(
        np.float32)
    return edges, w


def jax_indices(weights, u):
    """JAX's searched indices of _sample_from_weights (its own lines)."""
    w = jnp.asarray(weights) + 1e-5
    cdf = jnp.concatenate([jnp.zeros_like(w[:, :1]), jnp.cumsum(w, -1)], -1)
    cdf = cdf / cdf[:, -1:]
    idx = jnp.clip(jax.vmap(jnp.searchsorted)(cdf, jnp.asarray(u)), 1,
                   cdf.shape[1] - 1)
    return np.asarray(idx), np.asarray(cdf)


def near_ties(cdf, u, ulps: int = 2) -> int:
    """How many u lie within ``ulps`` float32 ulps of some CDF entry."""
    gap = np.abs(cdf[:, None, :] - u[:, :, None])
    return int((gap <= ulps * np.spacing(np.abs(u[:, :, None]) + 1e-30)
                ).any(-1).sum())


@pytest.mark.parametrize("max_res", [128, 256])
def test_density_field_matches_jax(max_res):
    """The production proposal fields (5 levels, 2^17 rows) on converted
    parameters: <= 1e-6 relative (float32 MLP sums in another order,
    exp ulps)."""
    jcfg = JDensity(max_res=max_res)
    cfg = NGPDensityFieldConfig(max_res=max_res)
    assert cfg.grid.per_level_scale == jcfg.grid.per_level_scale
    p = random_density_field(max_res, cfg)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1.1, 1.1, (64, 16, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: j_density(p, x, jcfg))(p, x))
    got = query_density_field(params_from_jax(p), _t(x), cfg).numpy()
    assert got.shape == ref.shape == (64, 16, 1)
    assert (ref == 0).any() and (ref > 0).mean() > 0.5
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("stratified", [True, False])
def test_sample_from_weights_matches_jax(stratified):
    """On JAX's u: the searched indices equal JAX's (flips at near-ties are
    counted and reported; the CDFs are equal bitwise, so none is allowed),
    the new edges within 1e-6 (they are equal bitwise)."""
    n, m, k = 257, 128, 64
    edges, w = _ray_weights(0, n, m)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(JP._sample_from_weights(key, jnp.asarray(edges),
                                             jnp.asarray(w), k, stratified))
    if stratified:
        u = TP.stratified_u(_t(jax.random.uniform(key, (n, 1))), k)
    else:
        u = TP.linspace_u(n, k)
    got, idx = TP.sample_from_weights_plain(_t(edges), _t(w), u)
    j_idx, j_cdf = jax_indices(w, u.numpy())
    flips = int((idx.numpy() != j_idx).sum())
    print(f"resampling: {flips} index flips, "
          f"{near_ties(j_cdf, u.numpy())} u within 2 ulps of a CDF entry")
    assert flips == 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    assert (np.diff(got.numpy(), axis=1) >= 0).all()


@pytest.mark.parametrize("override", [True, False])
def test_weights_match_jax_and_the_last_bin_cancellation(override):
    """w against JAX within 1e-6 relative + 2e-7 absolute (an ulp of exp
    near 1 moves 1 - exp(-tau) by 6e-8). The prefix before the
    last bin is put at 0.5, 3, 10, 12 and 40 by the first bin alone: with
    the override, tau there is 1e10 * 1.99/128 ~ 1.55e8 (ulp 16), so JAX's
    ``cumsum(tau) - tau`` rounds the prefix to a multiple of 16 and the last
    weight is exp(-0) = 1, exp(-16) or exp(-32); the port shows JAX's
    rounded last weight, not the true exclusive scan's exp(-prefix)."""
    prefixes = np.array([0.5, 3.0, 10.0, 12.0, 40.0], np.float32)
    n, m = len(prefixes), 128
    edges = np.broadcast_to(np.asarray(jnp.linspace(0.01, 2.0, m + 1)),
                            (n, m + 1)).copy()
    dt = edges[:, 1:] - edges[:, :-1]
    sigma = np.zeros((n, m), np.float32)
    sigma[:, 0] = prefixes / dt[:, 0]
    sigma[:, -1] = 3.0
    js = jnp.asarray(sigma)
    if override:
        js = js.at[:, -1].set(1e10)
    ref = np.asarray(JP._weights_from_density(js, jnp.asarray(edges)))
    got = TP.weights_from_density_plain(_t(sigma), _t(edges), override)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=2e-7)
    tau = sigma * dt
    true_prefix = np.cumsum(tau.astype(np.float64), -1) - tau
    if override:
        # one float32 rounding of prefix + tau (ulp 16), then minus tau:
        # 0.5 and 3 -> 0, 10 and 12 -> 16, 40 (a tie) -> 32 here
        big = np.float32(1e10) * dt[:, -1]
        rounded = (prefixes + big).astype(np.float32) - big
        np.testing.assert_array_equal(rounded[:4], [0.0, 0.0, 16.0, 16.0])
        assert rounded[4] % 16 == 0 and abs(rounded[4] - 40) <= 8
        np.testing.assert_allclose(got[:, -1].numpy(), np.exp(-rounded),
                                   rtol=1e-6)
        true_last = np.exp(-true_prefix[:, -1])
        off = np.abs(got[:, -1].numpy() - true_last)
        assert (off > 1e-3 * true_last).all()
    else:
        true_last = np.exp(-true_prefix[:, -1]) * (1 - np.exp(-tau[:, -1]))
        np.testing.assert_allclose(got[:, -1].numpy(), true_last, rtol=1e-4)


@pytest.mark.parametrize("override", [True, False])
def test_weights_gradient_matches_jax_vjp(override):
    """w as in the test above; d sigma against jax.vjp within 1e-5 relative
    norm; 0 for an overridden last sigma."""
    n, m = 129, 64
    edges, _ = _ray_weights(1, n, m)
    rng = np.random.default_rng(2)
    sigma = (rng.random((n, m)) ** 4 * rng.uniform(0, 60, (n, 1))).astype(
        np.float32)
    g = rng.standard_normal((n, m)).astype(np.float32)

    def f(s):
        if override:
            s = s.at[:, -1].set(1e10)
        return JP._weights_from_density(s, jnp.asarray(edges))
    ref, vjp = jax.vjp(f, jnp.asarray(sigma))
    s = _t(sigma).requires_grad_(True)
    w = TP.weights_from_density(s, _t(edges), override)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(ref), rtol=1e-6,
                               atol=2e-7)
    (ds,) = torch.autograd.grad(w, [s], _t(g))
    assert _rel(ds, vjp(jnp.asarray(g))[0]) <= 1e-5
    if override:
        assert (ds[:, -1] == 0).all()


def test_prop_loss_and_its_gradient_match_jax():
    """Two proposal levels against JAX's prop_loss: the loss within 1e-5
    relative, d proposal weights against jax.vjp within 1e-5 relative norm
    per level; the final weights and edges get none."""
    n = 257
    levels = [_ray_weights(s, n, m) for s, m in ((3, 128), (4, 64))]
    tf, wf = _ray_weights(5, n, 64)
    wf = wf * 2.0                         # some excess over the bounds

    def jloss(wps):
        return JP.prop_loss(jnp.asarray(tf), jnp.asarray(wf),
                            [{"edges": jnp.asarray(e), "weights": wp}
                             for (e, _), wp in zip(levels, wps)])
    ref, vjp = jax.vjp(jloss, [jnp.asarray(w) for _, w in levels])
    wps = [_t(w).requires_grad_(True) for _, w in levels]
    tf_t = _t(tf).requires_grad_(True)
    loss = TP.prop_loss(tf_t, _t(wf), [{"edges": _t(e), "weights": wp}
                                       for (e, _), wp in zip(levels, wps)])
    assert float(ref) > 0
    assert abs(loss.item() - float(ref)) <= 1e-5 * float(ref)
    *grads, g_tf = torch.autograd.grad(loss, wps + [tf_t], allow_unused=True)
    for got, want in zip(grads, vjp(jnp.ones((), jnp.float32))[0]):
        assert _rel(got, want) <= 1e-5
    assert g_tf is None


def _flip_report(tag, port_aux, jax_aux, us):
    """Counts of searched-index flips between the packages per level (the
    weights differ by exp ulps, so a u within rounding of a CDF entry may
    pick the neighbouring bin); asserts each flip is at a near-tie."""
    for lvl, (pa, ja, u) in enumerate(zip(port_aux, jax_aux, us)):
        _, p_idx = TP.sample_from_weights_plain(pa["edges"], pa["weights"], u)
        j_idx, j_cdf = jax_indices(np.asarray(ja["weights"]), u.numpy())
        flips = p_idx.numpy() != j_idx
        if flips.any():
            r, k = np.nonzero(flips)
            gap = np.abs(j_cdf[r, p_idx.numpy()[r, k]] - u.numpy()[r, k])
            assert (gap <= 1e-6).all(), gap.max()
        print(f"{tag} level {lvl}: {int(flips.sum())} index flips")


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind", ["hash", "brick"])
def test_render_rays_prop_matches_jax(kind, train):
    """The cascade (64 -> 32 -> 32 samples, two 2-level proposal fields) on
    a 2-level hash or brick field, with JAX's draws in training; JAX runs
    eagerly (its compile of the whole cascade costs ~13 s a case). Held
    step by step: level 0's edges equal; the port's weights of each level
    on JAX's edges within 1e-5 absolute of JAX's (exp ulps, the float32
    MLP's sums); the port's resampling of JAX's edges and weights within
    1e-6 of JAX's next edges. End to end: rgb, distance and opacity within
    1e-4 (and bf16 ties of the final field's MLP, test_torch_common); the
    port's own resampled edges, and the weights on them, within 1e-3, since
    the resampling divides a CDF difference of an exp ulp (6e-8) by a bin's
    mass, ~1e-5 of the total in the emptiest bins."""
    if kind == "hash":
        jfield, field = hash_fields(n_levels=2, n_features=2,
                                    log2_table_size=10, base_res=8,
                                    per_level_scale=4.0)
    else:
        grid = dict(n_levels=2, log2_bricks=8, base_res=8, per_level_scale=4.0)
        jfield = JField(grid=JGrid(**grid))
        field = NGPFieldConfig(grid=BrickGridConfig(**grid))
    p = params_from_jax(random_field_params(3, field))
    jp = {h: jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), p[h])
          for h in ("geo", "app")}
    pcfgs = [NGPDensityFieldConfig(**SMALL), NGPDensityFieldConfig(**SMALL)]
    jpcfgs = [JDensity(**SMALL), JDensity(**SMALL)]
    props = [random_density_field(s, c) for s, c in zip((5, 6), pcfgs)]
    cfg = TP.PropRenderConfig(n_samples=32, n_samples_per_prop=(64, 32))
    jcfg = JP.PropRenderConfig(n_samples=32, n_samples_per_prop=(64, 32))
    n = 96
    o, d = random_rays(n, 4)
    key = jax.random.PRNGKey(11)
    with jax.disable_jit():
        ref = JP.render_rays_prop(jp, props, jfield, jpcfgs, o, d, key, jcfg,
                                  train)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    draws = jax_draws(key, n, 2) if train else None
    out = TP.render_rays_prop(p, prop_params_from_jax(props, pcfgs), field,
                              pcfgs, _t(o), _t(d), cfg, train, draws)
    us = ([TP.stratified_u(u, 32) for u in draws["u"]] if train
          else [TP.linspace_u(n, 32)] * 2)
    _flip_report(f"{kind} train={train}", out["prop_aux"], ref["prop_aux"],
                 us)
    np.testing.assert_array_equal(out["prop_aux"][0]["edges"].numpy(),
                                  ref["prop_aux"][0]["edges"])
    # each level's weights on JAX's edges, then the resampling of JAX's
    # edges and weights
    pp = prop_params_from_jax(props, pcfgs)
    nexts = [a["edges"] for a in ref["prop_aux"][1:]] + [ref["t_edges"]]
    for lvl, (ja, u, nxt) in enumerate(zip(ref["prop_aux"], us, nexts)):
        te = _t(ja["edges"])
        _, pts = TP._points(_t(o), _t(d), te)
        sigma = query_density_field(pp[lvl], torch.stack(pts, -1),
                                    pcfgs[lvl])[..., 0]
        w = TP.weights_from_density(sigma, te, override_last=True)
        np.testing.assert_allclose(w.numpy(), ja["weights"], atol=1e-5,
                                   rtol=0)
        step = TP.sample_from_weights_plain(te, _t(ja["weights"]), u)[0]
        np.testing.assert_allclose(step.numpy(), nxt, atol=1e-6, rtol=0)
    # end to end
    for pa, ja in zip(out["prop_aux"], ref["prop_aux"]):
        for k in ("edges", "weights"):
            np.testing.assert_allclose(pa[k].numpy(), ja[k], atol=1e-3,
                                       rtol=0)
    for k in ("t_edges", "weights"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-3, rtol=0)
    for k in ("rgb", "distance", "opacity"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert float(ref["opacity"].mean()) > 0.3
