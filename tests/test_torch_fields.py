"""Port vs ``perf_tpu``: brick encode (also vs ``brick_encode_numpy``),
the two field heads on the same carried params, ``trunc_exp`` and the
``field_eval`` wrapper's CPU dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perf_tpu.fields.ngp import (query_density_coords as j_density,
                                 query_rgb_coords as j_rgb)
from perf_tpu.kernels.brickgrid import (brick_encode as j_encode,
                                        brick_encode_numpy)

from perf_tpu_torch.convert import params_from_jax
from perf_tpu_torch.fields import (field_eval, field_eval_plain,
                                   query_density_coords, query_rgb_coords,
                                   trunc_exp)
from perf_tpu_torch.kernels import brick_encode

from test_torch_common import (assert_close_up_to_bf16_ties, configs,
                               params_np)


@pytest.fixture(scope="module")
def carried():
    p = params_np(0)
    return (jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p))


def test_brick_encode_matches_jax_and_numpy(carried):
    (jf, _, _), (tf, _, _) = configs()
    assert any(tf.grid.level_hashed(l) for l in range(tf.grid.n_levels))
    p_j, p_t = carried
    x = np.random.default_rng(1).uniform(0, 1, (4096, 3)).astype(np.float32)
    got = brick_encode(p_t["geo"]["table"], torch.from_numpy(x), tf.grid)
    ref_j = np.asarray(j_encode(p_j["geo"]["table"], jnp.asarray(x), jf.grid))
    table_bf16 = torch.from_numpy(params_np(0)["geo"]["table"]).to(
        torch.bfloat16).float().numpy()
    ref_np = brick_encode_numpy(table_bf16, x, jf.grid)
    # same bf16 table values and weights; float32 sums of 8 products in
    # another order: a few float32 ulps of features up to ~0.5
    np.testing.assert_allclose(got.numpy(), ref_j, rtol=0, atol=2e-7)
    np.testing.assert_allclose(got.numpy(), ref_np, rtol=0, atol=2e-7)


def test_field_heads_match_jax_on_carried_params(carried):
    (jf, _, _), (tf, _, _) = configs()
    p_j, p_t = carried
    w = np.random.default_rng(2).uniform(-1.1, 1.1, (8192, 3)).astype(
        np.float32)
    jx = [jnp.asarray(w[:, i]) for i in range(3)]
    tx = [torch.from_numpy(w[:, i]) for i in range(3)]
    sig_j = np.asarray(j_density(p_j["geo"], *jx, jf))
    sig_t = query_density_coords(p_t["geo"], *tx, tf).numpy()
    assert (sig_j == 0).any() and (sig_j == 0).sum() == (sig_t == 0).sum()
    # float32 sums in another order move raw by ~1e-6, which exp carries as
    # relative error; rare bf16 rounding ties move sigma by up to ~3%
    assert_close_up_to_bf16_ties(sig_t, sig_j, 1e-5, 1e-3, 0.03)
    rgb_j = np.stack([np.asarray(v) for v in j_rgb(p_j["app"], *jx, jf)], -1)
    rgb_t = torch.stack(query_rgb_coords(p_t["app"], *tx, tf), -1).numpy()
    assert rgb_j.std() > 0.05
    assert_close_up_to_bf16_ties(rgb_t, rgb_j, 1e-5, 1e-3, 0.03)

    out = field_eval(p_t, torch.from_numpy(w), tf)    # CPU -> plain path
    np.testing.assert_array_equal(out.numpy(),
                                  field_eval_plain(p_t, torch.from_numpy(w),
                                                   tf).numpy())
    assert_close_up_to_bf16_ties(out[:, 0].numpy(), sig_t, 1e-5, 1e-3, 0.03)


def test_trunc_exp_clamps_forward_at_80_and_gradient_at_15():
    x = torch.tensor([0.0, 10.0, 20.0, 100.0], requires_grad=True)
    y = trunc_exp(x)
    assert torch.isfinite(y).all()
    assert y[3] == torch.exp(torch.tensor(80.0))
    y.sum().backward()
    np.testing.assert_allclose(
        x.grad.numpy(), np.exp(np.minimum([0.0, 10.0, 20.0, 100.0], 15.0)),
        rtol=1e-6)
