"""Port vs ``perf_tpu``: the sphere field's reference-parity hash encoding.

The smoothstep hash encode and its table gradient, the encode's position
gradient (``hash_encode_grad``) against ``jax.jacfwd`` with its table
gradient against ``jax.vjp``, ``sphere_field_distance_and_grad`` in every
gradient mode, head and MLP variant on converted parameters, and the
configurations JAX asserts against (the distillation with hash + ``ad`` is
in ``test_torch_sphere_distill.py``). Inputs are drawn with NumPy from a seed (JAX's own draws where JAX
draws inside a function); the port runs on CPU tensors, where every kernel
wrapper takes its plain version. Grids are small: 3 levels from 16 to 64,
level 0 dense, the others hashed. JAX runs eagerly where a function is
called once (an XLA compile of each variant costs seconds on one core).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # noqa: F401

from perf_tpu.fields.sphere_field import (
    SphereFieldConfig as JSphere, init_sphere_field as j_init_sphere,
    sphere_field_distance_and_grad as j_sphere_dg)
from perf_tpu.kernels import hashgrid as JH

from perf_tpu_torch.convert import sphere_field_from_jax
from perf_tpu_torch.fields import (SphereFieldConfig,
                                   sphere_field_distance_and_grad)
from perf_tpu_torch.kernels import hashgrid as TH

from test_torch_anchor import _rel, _t, one_thread  # noqa: F401

# 3 levels (res 16, 32, 64): level 0's 17^3 corners fit the 8192 rows, 1
# and 2 are hashed
GRID = dict(fine_res=64, n_levels=3, log2_table_size=13)


def _points(n: int, seed: int) -> np.ndarray:
    """n points in [0, 1]^3; the first ones on the box's faces and corners
    and beyond them."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0.5, 0.0, 1.0], [-0.1, 1.2, 0.3],
             [1.0, 0.25, 0.0], [0.49, 0.98, 0.0]]
    return x


def _grids(interpolation: str = "smoothstep"):
    jg = dataclasses.replace(JH.HashGridConfig.sphere_field(**GRID),
                             interpolation=interpolation)
    tg = dataclasses.replace(TH.HashGridConfig.sphere_field(**GRID),
                             interpolation=interpolation)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    return jg, tg


def _table(grid, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (grid.n_levels, 2, grid.table_size)).astype(
        np.float32)


def test_smoothstep_encode_and_table_gradient_match_jax():
    jg, tg = _grids()
    table, x = _table(tg, 0), _points(300, 1)
    ref, vjp = jax.vjp(lambda t: JH.hash_encode(t, jnp.asarray(x), jg),
                       jnp.asarray(table))
    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    got = TH.hash_encode(tt, torch.from_numpy(x), tg)
    # the same corners, smoothstep weights, products and sums in JAX's order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.detach().numpy(),
                               JH.hash_encode_numpy(table, x, jg),
                               atol=1e-6, rtol=0)
    cot = np.random.default_rng(2).standard_normal(ref.shape).astype(
        np.float32)
    (g_ref,) = vjp(jnp.asarray(cot))
    got.backward(torch.from_numpy(cot))
    # the same float32 contributions, scatter-added in another order
    assert _rel(tt.grad.numpy(), g_ref) <= 1e-5


def _jax_encode_and_jacobian(grid):
    """x [N, 3] -> (feats [N, L*F], d feats / d x [N, 3, L*F]) by JAX's
    forward-mode autodiff of ``hash_encode``, as a function of the table."""
    def fn(table, x):
        feats = JH.hash_encode(table, x, grid)
        jac = jax.vmap(jax.jacfwd(
            lambda p: JH.hash_encode(table, p[None], grid)[0]))(x)
        return feats, jnp.transpose(jac, (0, 2, 1))
    return fn


@pytest.mark.parametrize("interpolation", ["smoothstep", "linear"])
def test_position_gradient_matches_jax_jacfwd(interpolation):
    """Boundary inputs included: the clip's derivative is 0.5 at 0 and 1
    (visible on the linear grid; smoothstep's weight is flat there)."""
    jg, tg = _grids(interpolation)
    table, x = _table(tg, 3), _points(300, 4)
    f_ref, d_ref = _jax_encode_and_jacobian(jg)(jnp.asarray(table),
                                               jnp.asarray(x))
    f, d = TH.hash_encode_grad(torch.from_numpy(table), torch.from_numpy(x),
                               tg)
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), atol=1e-6,
                               rtol=0)
    # forward mode in both; XLA may contract a product and a sum
    assert _rel(d.numpy(), d_ref) <= 1e-5
    assert _rel(d.numpy()[:6], d_ref[:6]) <= 1e-5
    if interpolation == "linear":
        # x = 0 on the first point's axes: half the inside derivative
        assert np.abs(d_ref[0]).max() > 0
    assert np.isfinite(d.numpy()).all()


def test_position_gradient_table_gradient_matches_jax_vjp():
    jg, tg = _grids()
    table, x = _table(tg, 5), _points(200, 6)
    (f_ref, d_ref), vjp = jax.vjp(
        lambda t: _jax_encode_and_jacobian(jg)(t, jnp.asarray(x)),
        jnp.asarray(table))
    rng = np.random.default_rng(7)
    gf = rng.standard_normal(f_ref.shape).astype(np.float32)
    gd = rng.standard_normal(d_ref.shape).astype(np.float32)
    (g_ref,) = vjp((jnp.asarray(gf), jnp.asarray(gd)))
    tt = torch.from_numpy(table.copy()).requires_grad_(True)
    f, d = TH.hash_encode_grad(tt, torch.from_numpy(x), tg)
    (g,) = torch.autograd.grad((f, d), tt, (torch.from_numpy(gf),
                                            torch.from_numpy(gd)))
    # the same float32 contributions, scatter-added in another order
    assert _rel(g.numpy(), g_ref) <= 1e-5


VARIANTS = [(mode, enc, out, wn)
            for mode, enc in (("ad", "hash"), ("fd", "hash"),
                              ("analytic", "brick"))
            for out in ("joint", "raw") for wn in (False, True)]


@pytest.mark.parametrize("mode,encoding,output,weight_norm", VARIANTS)
def test_sphere_field_distance_and_grad_match_jax(mode, encoding, output,
                                                  weight_norm):
    kw = dict(**GRID, output=output, weight_norm=weight_norm,
              encoding=encoding, grad_mode=mode)
    jcfg, cfg = JSphere(**kw), SphereFieldConfig(**kw)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(len(VARIANTS)), 4)
    params = j_init_sphere(k1, jcfg)
    # table magnitudes that move the distance (bf16-robust on the brick
    # grid), and first-layer weights on the features (the sphere init
    # zeroes them, which would hide the encoding from both outputs)
    params["table"] = 0.1 * jax.random.normal(k2, params["table"].shape)
    w0 = "v" if weight_norm else "w"
    params["mlp"][w0][0] = params["mlp"][w0][0].at[3:].set(
        0.5 * jax.random.normal(k4, params["mlp"][w0][0][3:].shape))
    dirs = np.asarray(jax.random.normal(k3, (256, 3)))
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    d_ref, g_ref = j_sphere_dg(params, jnp.asarray(dirs), jcfg)
    d, g = sphere_field_distance_and_grad(sphere_field_from_jax(params),
                                          _t(dirs), cfg)
    # the MLP's float32 products in another order
    assert _rel(d.detach().numpy(), d_ref) <= 1e-6
    np.testing.assert_allclose(d.detach().numpy(), d_ref, rtol=1e-5)
    # ad: forward mode against JAX's reverse mode; fd: a difference of
    # nearby distances over 2 / fine_res magnifies their float32 rounding
    assert _rel(g.detach().numpy(), g_ref) <= (1e-4 if mode == "fd" else 1e-5)


def test_sphere_field_refuses_what_jax_asserts_against():
    with pytest.raises(ValueError, match="analytic"):
        SphereFieldConfig(encoding="hash", grad_mode="analytic")
    with pytest.raises(ValueError, match="'ad' needs"):
        SphereFieldConfig(encoding="brick", grad_mode="ad")
    with pytest.raises(ValueError, match="output"):
        SphereFieldConfig(output="sdf")
    cfg = SphereFieldConfig()
    assert (cfg.encoding, cfg.grad_mode) == ("hash", "ad")
    assert cfg.grid == TH.HashGridConfig.sphere_field(fine_res=2048,
                                                      log2_table_size=19)
    assert (dataclasses.asdict(JSphere())
            == dataclasses.asdict(SphereFieldConfig()))
    jg = JSphere().grid
    assert dataclasses.asdict(jg) == dataclasses.asdict(cfg.grid)

